"""SWIM-style gossip — the control plane with no coordinator.

(Copy of ``omero_ms_pixel_buffer_tpu/cluster/gossip.py``.)

Every coordination primitive built in r16–r19 (leases, epochs,
brains, suspicion) hangs off one Redis: a coordinator outage freezes
membership, invalidation, and repair fleet-wide at once. This module
moves the control plane onto the surface the fleet already trusts —
the nonce-stamped v2 HMAC ``/internal/*`` peer surface — so "Redis
down" degrades the L2 cache and nothing else.

The protocol is push-pull anti-entropy over full state digests
(SWIM's dissemination half; the fleet is small enough that delta
encoding would be complexity without payoff):

- every ``interval-s`` this replica bumps its own heartbeat counter
  and POSTs its digest to ``fanout`` peers (rotating through the
  candidate list so coverage is deterministic, not luck); each
  target merges and replies with ITS digest, which is merged back —
  one exchange converges both sides pairwise, and rumors cross the
  fleet in O(log n) rounds;
- per-member state is ``{hb, draining, left}``: a higher heartbeat
  wins outright, an equal heartbeat ORs the flags (draining and
  tombstones must survive reordering), and a member whose heartbeat
  stops advancing for ``fail-after-s`` leaves the live view — the
  lease-TTL expiry, without the lease;
- a DIRECT exchange (the peer answered us, or it POSTed to us)
  refutes any tombstone and refreshes liveness regardless of
  counters — a restarted replica re-enters at heartbeat 0 and must
  not stay dead because its old incarnation's counter was higher;
- the digest piggybacks the EPOCH high-water map (invalidations
  keep propagating to replicas that missed the purge fan-out) and
  the fleet BRAINS (pressure, open breakers, serve quality,
  suspicion verdicts — keyed by the publisher's heartbeat so stale
  rumor never overwrites fresher), so everything the Redis exchange
  carried now rides the gossip round.

Redis, when still configured, is demoted to a JOIN-BOOTSTRAP HINT:
each round best-effort writes a sealed lease and scans for member
keys it has never heard of — a brand-new replica whose seed list
predates the current fleet finds one live member via Redis and
gossip does the rest. Every hint failure is silent; gossip is the
membership truth.

``GossipManager`` deliberately presents the same surface as
``MembershipManager`` (members/draining/interval_s/refresh_once/
mark_draining/release_lease/snapshot) so the cache plane's
coordination loop, drain protocol, and ring builder run unchanged on
either. All peer traffic rides ``PeerClient`` — breaker-guarded,
fault-injectable, deadline-bounded (tools/analyze resilience scope
covers this module via the shared client).
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from collections import deque
from typing import (
    Callable, Dict, FrozenSet, Optional, Sequence, Tuple,
)

from ..utils.metrics import REGISTRY
from .integrity import UNSIGNED_PAYLOADS
from .membership import MEMBER_PREFIX, MEMBERSHIP_EVENTS
from .security import seal, unseal

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.cluster")

GOSSIP_ROUNDS = REGISTRY.counter(
    "cluster_gossip_rounds_total",
    "Gossip activity by kind (round, exchange, exchange_error, "
    "receive, hint, hint_error)",
)

_MAX_ENTRIES = 256     # known-member bound: rumor cannot grow memory
_MAX_URL_LEN = 512
_EPOCH_LIMIT = 512     # epoch high-water entries per digest


class GossipManager:
    """Peer-to-peer membership + epoch + brain dissemination.

    Event-loop affine like MembershipManager: rounds run as part of
    the cache plane's coordination loop; ``receive`` runs on the
    serving loop (the ``/internal/gossip`` handler) — same loop, no
    locking needed. ``snapshot`` reads loop-written scalars."""

    def __init__(
        self,
        peers,
        self_url: str,
        seed: Sequence[str],
        interval_s: float = 1.0,
        fanout: int = 2,
        fail_after_s: float = 5.0,
        on_change: Optional[Callable] = None,
        link=None,
        secret: str = "",
        epochs=None,
        clock=time.monotonic,
    ):
        self.peers = peers
        self.self_url = self_url
        self.interval_s = max(float(interval_s), 0.05)
        self.fanout = max(1, int(fanout))
        self.fail_after_s = max(float(fail_after_s), self.interval_s)
        self.on_change = on_change
        self.link = link            # optional join-bootstrap hint
        self.secret = secret
        self.epochs = epochs
        self._clock = clock
        now = clock()
        # url -> {"hb": int, "draining": bool, "left": bool}
        self._entries: Dict[str, dict] = {
            url: {"hb": 0, "draining": False, "left": False}
            for url in set(seed) | {self_url}
        }
        # url -> monotonic instant its heartbeat last advanced (or it
        # was in direct contact); seeds start "heard" so the boot view
        # is never memberless, matching the lease bootstrap posture
        self._heard: Dict[str, float] = {
            url: now for url in self._entries
        }
        # url -> (publisher heartbeat, brain payload)
        self._brains: Dict[str, Tuple[int, dict]] = {}
        self._local_brain: Optional[dict] = None
        self._round = 0

        # the MembershipManager-compatible surface
        self.members: Tuple[str, ...] = tuple(
            sorted(set(seed) | {self_url})
        )
        self.draining: FrozenSet[str] = frozenset()
        self.lease_ttl_s = self.fail_after_s  # drain-timing analog
        self.seeded = True
        self.self_draining = False
        self.released = False
        self.refreshes = 0
        self.refresh_failures = 0
        self.last_refresh: Optional[float] = None
        self.events: deque = deque(maxlen=32)
        self.exchanges = 0
        self.exchange_failures = 0
        self.receives = 0
        self.hint_rounds = 0
        self.hint_failures = 0
        self.contacts_adopted = 0

    # -- digest build / merge -------------------------------------------

    def digest(self) -> dict:
        out: dict = {
            "v": 1,
            "from": self.self_url,
            "members": {
                url: {
                    "hb": e["hb"],
                    "draining": e["draining"],
                    "left": e["left"],
                }
                for url, e in self._entries.items()
            },
        }
        if self.epochs is not None:
            epochs = self.epochs.known_map(limit=_EPOCH_LIMIT)
            if epochs:
                out["epochs"] = {str(k): v for k, v in epochs.items()}
        brains: dict = {}
        if self._local_brain is not None and not self.released:
            brains[self.self_url] = [
                self._entries[self.self_url]["hb"], self._local_brain,
            ]
        for url, (hb, payload) in self._brains.items():
            entry = self._entries.get(url)
            if entry is None or entry["left"]:
                continue
            brains[url] = [hb, payload]
        if brains:
            out["brains"] = brains
        return out

    def digest_bytes(self) -> bytes:
        return json.dumps(
            self.digest(), separators=(",", ":")
        ).encode()

    def merge(self, remote: Optional[dict]) -> None:
        """Fold a remote digest into local state. Defensive by
        construction: the payload crossed the HMAC gate but a
        compromised or buggy peer must still be bounded — malformed
        fields are skipped, member count stays capped, and nothing
        here raises."""
        if not isinstance(remote, dict):
            return
        members = remote.get("members")
        if isinstance(members, dict):
            for url, e in members.items():
                if isinstance(e, dict):
                    self._merge_member(url, e)
        if self.epochs is not None:
            epochs = remote.get("epochs")
            if isinstance(epochs, dict):
                for img, ep in list(epochs.items())[:_EPOCH_LIMIT]:
                    try:
                        self.epochs.note(int(img), int(ep))
                    except (TypeError, ValueError):
                        continue
        brains = remote.get("brains")
        if isinstance(brains, dict):
            for url, item in brains.items():
                if url == self.self_url or url not in self._entries:
                    continue
                try:
                    hb, payload = int(item[0]), item[1]
                except (TypeError, ValueError, IndexError, KeyError):
                    continue
                if not isinstance(payload, dict):
                    continue
                cur = self._brains.get(url)
                if cur is None or hb >= cur[0]:
                    self._brains[url] = (hb, payload)

    def _merge_member(self, url, e: dict) -> None:
        if not isinstance(url, str) or not url or \
                len(url) > _MAX_URL_LEN:
            return
        try:
            rhb = int(e.get("hb", 0))
        except (TypeError, ValueError):
            return
        rdrain = bool(e.get("draining"))
        rleft = bool(e.get("left"))
        if url == self.self_url:
            # SWIM refutation: rumor that outpaces (or tombstones)
            # our own incarnation is answered by jumping past it —
            # never by adopting someone else's story about us. A
            # released replica does NOT refute: its tombstone is
            # the truth it published.
            if self.released:
                return
            me = self._entries[url]
            if rhb >= me["hb"]:
                me["hb"] = rhb + 1
            return
        local = self._entries.get(url)
        if local is None:
            if len(self._entries) >= _MAX_ENTRIES:
                return
            self._entries[url] = {
                "hb": rhb, "draining": rdrain, "left": rleft,
            }
            self._heard[url] = self._clock()
            return
        if rhb > local["hb"]:
            local["hb"] = rhb
            local["draining"] = rdrain
            local["left"] = rleft
            # an advancing heartbeat is evidence of life, however
            # many hops the rumor took
            if not rleft:
                self._heard[url] = self._clock()
        elif rhb == local["hb"]:
            local["draining"] = local["draining"] or rdrain
            local["left"] = local["left"] or rleft

    def _alive(self, url: str) -> None:
        """Direct contact with ``url``: refutes any tombstone and
        refreshes liveness regardless of heartbeat counters (a
        restarted member re-enters at hb 0)."""
        e = self._entries.get(url)
        if e is None:
            if len(self._entries) >= _MAX_ENTRIES:
                return
            e = self._entries[url] = {
                "hb": 0, "draining": False, "left": False,
            }
        e["left"] = False
        self._heard[url] = self._clock()

    def note_contact(self, url: str) -> None:
        """Gossip-native join hint (r22): adopt a member address
        learned from a verified internal contact's ``X-OMPB-Peer``
        header. One authenticated request in EITHER direction between
        a joiner and any live member now bootstraps membership — the
        joiner's first digest push teaches the receiver, and the
        receiver's reply digest teaches the joiner the rest of the
        fleet — so Redis is no longer on the join path at all. Same
        bounds as every other rumor source: capped table, capped URL
        length, self ignored."""
        if not isinstance(url, str) or not url or \
                url == self.self_url or len(url) > _MAX_URL_LEN:
            return
        known = url in self._entries
        self._alive(url)
        if not known and url in self._entries:
            self.contacts_adopted += 1
            GOSSIP_ROUNDS.inc(kind="contact_adopted")
        self._apply_view()

    # -- the inbound half (the /internal/gossip handler) ----------------

    def receive(self, remote: Optional[dict]) -> dict:
        """Merge a pushed digest and reply with ours — the pull half
        of push-pull. The sender itself is marked alive: it just
        proved it."""
        self.receives += 1
        GOSSIP_ROUNDS.inc(kind="receive")
        self.merge(remote)
        sender = (
            remote.get("from") if isinstance(remote, dict) else None
        )
        if isinstance(sender, str) and sender and \
                sender != self.self_url and len(sender) <= _MAX_URL_LEN:
            self._alive(sender)
        self._apply_view()
        return self.digest()

    # -- the outbound round (MembershipManager.refresh_once analog) -----

    def _candidates(self) -> list:
        return sorted(
            url for url, e in self._entries.items()
            if url != self.self_url and not e["left"]
        )

    def _pick_targets(self) -> list:
        """``fanout`` targets, rotating through the candidate list by
        round so every member is contacted on a fixed cadence —
        deterministic coverage instead of sampling luck. Dead members
        stay candidates (so a recovered one is re-probed) but cost
        only a breaker-guarded fast-fail each visit."""
        candidates = self._candidates()
        if not candidates:
            return []
        start = self._round % len(candidates)
        rotated = candidates[start:] + candidates[:start]
        return rotated[: self.fanout]

    async def refresh_once(self) -> bool:
        if self.released:
            return False
        self._round += 1
        me = self._entries[self.self_url]
        me["hb"] += 1
        me["draining"] = self.self_draining
        await self._hint_round()
        targets = self._pick_targets()
        payload = self.digest_bytes()
        ok = not targets
        for target in targets:
            reply = await self.peers.gossip(target, payload)
            if reply is None:
                self.exchange_failures += 1
                GOSSIP_ROUNDS.inc(kind="exchange_error")
                continue
            self.exchanges += 1
            GOSSIP_ROUNDS.inc(kind="exchange")
            ok = True
            self.merge(reply)
            self._alive(target)
        self._apply_view()
        self._gc()
        self.refreshes += 1
        GOSSIP_ROUNDS.inc(kind="round")
        if ok:
            self.seeded = False
            self.last_refresh = self._clock()
        else:
            self.refresh_failures += 1
        return ok

    async def _hint_round(self) -> None:
        """Best-effort Redis join-bootstrap hint: publish our sealed
        lease (so replicas that have never heard of us can find one
        live member) and adopt member keys we have never seen as
        gossip candidates — direct exchange then confirms or expires
        them. Every failure is silent: gossip is the truth."""
        if self.link is None:
            return
        try:
            fields = {
                "url": self.self_url, "wall": time.time(),
                "gossip": True,
            }
            if self.self_draining:
                fields["draining"] = True
            raw = seal(self.secret, json.dumps(
                fields, separators=(",", ":")
            ).encode())
            px = str(int(
                max(self.fail_after_s, self.interval_s * 3.0) * 1000
            )).encode()
            key = (MEMBER_PREFIX + self.self_url).encode()
            await self.link.command(b"SET", key, raw, b"PX", px)
            keys = await self.link.scan_keys(
                (MEMBER_PREFIX + "*").encode()
            )
            values = await self.link.command(b"MGET", *keys) \
                if keys else []
        except asyncio.CancelledError:
            raise
        except Exception:
            self.hint_failures += 1
            GOSSIP_ROUNDS.inc(kind="hint_error")
            return
        for k, value in zip(keys, values):
            url = k.decode("utf-8", "replace")[len(MEMBER_PREFIX):]
            if url in self._entries or not url or \
                    len(url) > _MAX_URL_LEN:
                continue
            if self.secret:
                if value is None:
                    continue
                if unseal(self.secret, value) is None:
                    UNSIGNED_PAYLOADS.inc(kind="lease")
                    continue
            if len(self._entries) < _MAX_ENTRIES:
                self._entries[url] = {
                    "hb": 0, "draining": False, "left": False,
                }
                self._heard[url] = self._clock()
        self.hint_rounds += 1
        GOSSIP_ROUNDS.inc(kind="hint")

    # -- view application ------------------------------------------------

    def _apply_view(self) -> None:
        now = self._clock()
        live = {self.self_url}
        draining = set()
        for url, e in self._entries.items():
            if url == self.self_url:
                continue
            if e["left"]:
                continue
            if now - self._heard.get(url, 0.0) > self.fail_after_s:
                continue
            live.add(url)
            if e["draining"]:
                draining.add(url)
        if self.self_draining:
            draining.add(self.self_url)
        self._apply(tuple(sorted(live)), frozenset(draining))

    def _apply(
        self, new: Tuple[str, ...],
        draining: FrozenSet[str] = frozenset(),
    ) -> None:
        if new == self.members and draining == self.draining:
            return
        old = set(self.members)
        added = sorted(set(new) - old)
        removed = sorted(old - set(new))
        newly_draining = sorted(draining - self.draining)
        self.members = new
        self.draining = draining
        now = time.time()
        for url in added:
            self.events.append({"event": "join", "url": url, "ts": now})
            MEMBERSHIP_EVENTS.inc(event="join")
            log.info("cluster member joined (gossip): %s", url)
        for url in removed:
            self.events.append({"event": "leave", "url": url, "ts": now})
            MEMBERSHIP_EVENTS.inc(event="leave")
            log.info("cluster member left (gossip): %s", url)
        for url in newly_draining:
            self.events.append({"event": "drain", "url": url, "ts": now})
            MEMBERSHIP_EVENTS.inc(event="drain")
            log.info("cluster member draining (gossip): %s", url)
        if self.on_change is not None:
            try:
                self.on_change(added, removed, new)
            except Exception:
                log.exception("membership on_change hook failed")

    def _gc(self) -> None:
        """Forget entries (and their brains) long past any chance of
        return — 20x the failure window — so churn cannot grow state
        without bound. The live view already excluded them."""
        now = self._clock()
        horizon = 20.0 * self.fail_after_s
        stale = [
            url for url in self._entries
            if url != self.self_url
            and now - self._heard.get(url, 0.0) > horizon
        ]
        for url in stale:
            del self._entries[url]
            self._heard.pop(url, None)
            self._brains.pop(url, None)

    # -- brain piggyback -------------------------------------------------

    def set_local_brain(self, payload: Optional[dict]) -> None:
        self._local_brain = payload

    def fleet_brains(self) -> Dict[str, dict]:
        """The freshest known brain per LIVE peer — the gossip-mode
        replacement for the Redis MGET collect. Brains whose
        publisher has fallen out of the live view are excluded the
        same way an expired Redis brain key would be."""
        live = set(self.members)
        return {
            url: payload
            for url, (_, payload) in self._brains.items()
            if url in live and url != self.self_url
        }

    # -- the planned-leave protocol (drain / release) --------------------

    async def mark_draining(self) -> bool:
        """Publish the draining marker NOW: bump, re-view locally,
        and push one immediate fanout round so peers stop routing new
        ring traffic here without waiting for their next exchange."""
        self.self_draining = True
        me = self._entries[self.self_url]
        me["hb"] += 1
        me["draining"] = True
        self._apply_view()
        targets = self._pick_targets()
        payload = self.digest_bytes()
        ok = not targets
        for target in targets:
            reply = await self.peers.gossip(target, payload)
            if reply is not None:
                ok = True
                self.merge(reply)
                self._alive(target)
        self._apply_view()
        if not ok:
            MEMBERSHIP_EVENTS.inc(event="drain_publish_error")
            log.warning("gossip drain push reached no peer; the "
                        "leave lands by heartbeat expiry")
        return ok

    async def release_lease(self) -> bool:
        """The final step: tombstone ourselves, push the tombstone to
        the fanout targets, drop the Redis hint lease. Terminal —
        no further rounds run. Peers that miss the push expire us by
        ``fail-after-s`` (the crash path, still correct)."""
        self.released = True
        me = self._entries[self.self_url]
        me["hb"] += 1
        me["left"] = True
        payload = self.digest_bytes()
        for target in self._pick_targets():
            await self.peers.gossip(target, payload)
        if self.link is not None:
            try:
                await self.link.command(
                    b"DEL", (MEMBER_PREFIX + self.self_url).encode()
                )
            except asyncio.CancelledError:
                raise
            except Exception:
                log.debug("gossip hint lease release failed",
                          exc_info=True)
        MEMBERSHIP_EVENTS.inc(event="released")
        return True

    async def run(self) -> None:
        """The gossip loop (the owner creates the task and cancels it
        at close) — MembershipManager.run's shape."""
        while True:
            await self.refresh_once()
            await asyncio.sleep(self.interval_s)

    def snapshot(self) -> dict:
        age = None
        if self.last_refresh is not None:
            age = round(self._clock() - self.last_refresh, 3)
        return {
            "mode": "gossip",
            "members": list(self.members),
            "draining": sorted(self.draining),
            "known": len(self._entries),
            "interval_s": self.interval_s,
            "fanout": self.fanout,
            "fail_after_s": self.fail_after_s,
            "seeded": self.seeded,
            "self_draining": self.self_draining,
            "released": self.released,
            "refreshes": self.refreshes,
            "refresh_failures": self.refresh_failures,
            "exchanges": self.exchanges,
            "exchange_failures": self.exchange_failures,
            "receives": self.receives,
            "hint_rounds": self.hint_rounds,
            "hint_failures": self.hint_failures,
            "contacts_adopted": self.contacts_adopted,
            "last_refresh_age_s": age,
            "events": list(self.events),
        }
