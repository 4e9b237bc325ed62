"""Dynamic membership — coordination-free replica leases.

(Copy of ``omero_ms_pixel_buffer_tpu/cluster/membership.py``.)

Each replica maintains one lease key in the shared Redis
(``ompb:cluster:member:<self-url>``), SET with a PX of
``cluster.lease-ttl-s`` and refreshed every ttl/3. Membership IS the
set of live leases: no coordinator, no consensus, no gossip protocol
— a replica that stops heartbeating (crash, partition, scale-down)
expires out of everyone's view within one TTL, and a fresh replica
appears within one refresh interval. ``cluster.members`` from the
config is only the BOOTSTRAP seed: the ring starts there so a replica
is never memberless, and the first successful scan replaces it with
the lease truth.

Since r18 the lease payload doubles as the PLANNED-LEAVE channel: a
draining replica re-publishes its lease with ``"draining": true``
(cluster/lifecycle.py), every scan MGETs the lease payloads, and
draining members are reported separately from live ones — peers keep
them in the member view (they are still up, still serving) but the
ring builder excludes them from OWNERSHIP, so new ring traffic stops
flowing at a replica that announced its exit. The final
``release_lease`` DELetes the key so the leave lands at the next scan
instead of one TTL later — a drain is observable in one heartbeat,
where a crash costs the full TTL.

Failure posture: every refresh failure (Redis down, breaker open,
fault) keeps the LAST KNOWN member set — a Redis outage freezes the
fleet topology rather than collapsing every ring to a singleton (which
would stampede every replica into rendering everything locally). The
freeze is symmetric: all replicas stop observing changes together, so
disagreement stays bounded.

Ring-disagreement cost is bounded by construction, not by the lease
protocol: two replicas with different member views merely disagree
about ownership, which costs at most one extra render per key per
disagreement window (the peer marker is terminal — never a loop — and
keys carry the full encode signature — never wrong bytes). The chaos
suite pins all three properties.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from collections import deque
from typing import Callable, FrozenSet, Optional, Sequence, Tuple

from ..utils.metrics import REGISTRY
from .integrity import UNSIGNED_PAYLOADS
from .security import seal, unseal

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.cluster")

MEMBER_PREFIX = "ompb:cluster:member:"

MEMBERSHIP_EVENTS = REGISTRY.counter(
    "cluster_membership_events_total",
    "Membership changes observed by this replica, by event",
)


class MembershipManager:
    """The lease heartbeat + scan loop. Event-loop affine (runs as one
    task on the serving loop); ``snapshot`` may be called from
    anywhere (reads of loop-written scalars)."""

    def __init__(
        self,
        link,
        self_url: str,
        seed: Sequence[str],
        lease_ttl_s: float,
        on_change: Optional[Callable] = None,
        clock=time.monotonic,
        secret: str = "",
    ):
        self.link = link
        self.self_url = self_url
        # r20: leases are sealed under the cluster secret — a
        # Redis-reachable attacker SETting a member key no longer
        # joins the ring (unsigned leases are skipped, counted)
        self.secret = secret
        self.lease_ttl_s = float(lease_ttl_s)
        self.interval_s = max(self.lease_ttl_s / 3.0, 0.05)
        self.on_change = on_change
        self._clock = clock
        self.members: Tuple[str, ...] = tuple(
            sorted(set(seed) | {self_url})
        )
        # members whose lease carries the draining marker: still in
        # the view (they serve until they leave) but never owners
        self.draining: FrozenSet[str] = frozenset()
        self.seeded = True  # still on the bootstrap list
        self.self_draining = False
        self.released = False
        self.refreshes = 0
        self.refresh_failures = 0
        self.last_refresh: Optional[float] = None
        self.events: deque = deque(maxlen=32)

    def _lease_key(self) -> bytes:
        return (MEMBER_PREFIX + self.self_url).encode()

    def _lease_payload(self) -> bytes:
        fields = {"url": self.self_url, "wall": time.time()}
        if self.self_draining:
            fields["draining"] = True
        raw = json.dumps(fields, separators=(",", ":")).encode()
        return seal(self.secret, raw)

    async def refresh_once(self) -> bool:
        """One heartbeat round: refresh this replica's lease, scan the
        live lease set (payloads included — draining markers live in
        them), apply any membership change. False (and the last-known
        set is kept) on any failure. A released membership (the drain
        protocol's final step) is terminal: no further lease writes,
        no further view changes from here."""
        if self.released:
            return False
        try:
            await self.link.command(
                b"SET", self._lease_key(), self._lease_payload(),
                b"PX", str(int(self.lease_ttl_s * 1000)).encode(),
            )
            keys = await self.link.scan_keys(
                (MEMBER_PREFIX + "*").encode()
            )
            values = await self.link.command(b"MGET", *keys) if keys \
                else []
        except asyncio.CancelledError:
            raise
        except Exception:
            self.refresh_failures += 1
            MEMBERSHIP_EVENTS.inc(event="refresh_error")
            log.debug("membership refresh failed; keeping last-known "
                      "member set", exc_info=True)
            return False
        live = set()
        draining = set()
        for key, value in zip(keys, values):
            url = key.decode("utf-8", "replace")[len(MEMBER_PREFIX):]
            if self.secret:
                # sealed-lease posture: a key whose value is missing
                # (expiry racing the MGET — it will reappear or stay
                # gone next scan) or unsealed/tampered (an attacker
                # who can merely reach Redis) grants NO membership
                if value is None:
                    continue
                payload = unseal(self.secret, value)
                if payload is None:
                    UNSIGNED_PAYLOADS.inc(kind="lease")
                    continue
                value = payload
            live.add(url)
            if value is not None:
                try:
                    if json.loads(value).get("draining"):
                        draining.add(url)
                except Exception:
                    pass  # a corrupt payload is a plain live lease
        live.add(self.self_url)  # our own SET may race the scan
        if self.self_draining:
            draining.add(self.self_url)
        self._apply(tuple(sorted(live)), frozenset(draining))
        self.refreshes += 1
        self.seeded = False
        self.last_refresh = self._clock()
        return True

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
            log.info("cluster member joined: %s", url)
        for url in removed:
            self.events.append({"event": "leave", "url": url, "ts": now})
            MEMBERSHIP_EVENTS.inc(event="leave")
            log.info("cluster member left: %s", url)
        for url in newly_draining:
            self.events.append({"event": "drain", "url": url, "ts": now})
            MEMBERSHIP_EVENTS.inc(event="drain")
            log.info("cluster member draining: %s", url)
        if self.on_change is not None:
            try:
                self.on_change(added, removed, new)
            except Exception:
                log.exception("membership on_change hook failed")

    # -- the planned-leave protocol (cluster/lifecycle.py) -------------

    async def mark_draining(self) -> bool:
        """Publish the draining marker NOW (one immediate lease
        re-SET; the heartbeat keeps refreshing it). The local view
        re-applies immediately so this replica's own ring rebuilds
        without waiting a round. False when the publish failed — the
        drain proceeds on the crash path (TTL expiry)."""
        self.self_draining = True
        self._apply(
            self.members, frozenset(self.draining | {self.self_url})
        )
        try:
            await self.link.command(
                b"SET", self._lease_key(), self._lease_payload(),
                b"PX", str(int(self.lease_ttl_s * 1000)).encode(),
            )
        except asyncio.CancelledError:
            raise
        except Exception:
            MEMBERSHIP_EVENTS.inc(event="drain_publish_error")
            log.warning("drain marker publish failed; peers will "
                        "observe the leave by lease expiry",
                        exc_info=True)
            return False
        return True

    async def release_lease(self) -> bool:
        """The drain protocol's final step: DELETE the lease and stop
        heartbeating for good. Peers observe the leave at their next
        scan instead of one TTL later. False when the DEL failed (the
        lease then expires by TTL — the crash path, still correct)."""
        self.released = True
        try:
            await self.link.command(b"DEL", self._lease_key())
        except asyncio.CancelledError:
            raise
        except Exception:
            MEMBERSHIP_EVENTS.inc(event="release_error")
            log.debug("lease release failed; expiring by TTL",
                      exc_info=True)
            return False
        MEMBERSHIP_EVENTS.inc(event="released")
        return True

    async def run(self) -> None:
        """The heartbeat loop (the owner creates the task and cancels
        it at close)."""
        while True:
            await self.refresh_once()
            await asyncio.sleep(self.interval_s)

    def snapshot(self) -> dict:
        age = None
        if self.last_refresh is not None:
            age = round(self._clock() - self.last_refresh, 3)
        return {
            "members": list(self.members),
            "draining": sorted(self.draining),
            "lease_ttl_s": self.lease_ttl_s,
            "seeded": self.seeded,
            "self_draining": self.self_draining,
            "released": self.released,
            "refreshes": self.refreshes,
            "refresh_failures": self.refresh_failures,
            "last_refresh_age_s": age,
            "events": list(self.events),
        }
