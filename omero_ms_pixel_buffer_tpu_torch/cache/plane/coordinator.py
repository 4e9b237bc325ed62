"""CachePlane — the cluster-facing coordinator over L2 + the peer ring.

(Copy of ``omero_ms_pixel_buffer_tpu/cache/plane/coordinator.py``.)

Sits between the process-local result cache and the render pipeline in
the serving path (``http/server.TileServer.serve``):

    RAM -> disk -> [plane: L2 -> peer(owner)] -> render

and owns the outbound half of cluster invalidation (epoch bump + L2
DELs + peer purge fan-out). Construction is pure wiring from the
validated ``cluster:`` config block; either half is optional — L2
alone shares results through Redis, the ring alone gives render-once
ownership without any external service.

Since r17 the plane also hosts the cluster coordination loop
(cluster/): lease-backed dynamic membership rebuilding the ring live,
epoch stamps that make invalidation win every race, next-owner
replication of the hot set with a join-time warm-up transfer,
owner-side hedging off the observed peer p99, and the fleet brain
exchange. Since r18 it owns the fleet-lifecycle mechanics too: the
graceful-drain steps (lease marker, full-RAM handoff to the
post-drain owners, lease release) the DrainCoordinator sequences,
the low-duty anti-entropy repair loop (digest exchange with one
rotating peer per round), and the quality-demotion sink (a quorum-
demoted replica leaves every ownership ring until its signals
recover). All of it degrades: a dead Redis freezes the membership
view, a dead peer skips its round, and the serving path never sees an
exception.

The whole object inherits the cache contract: no operation here may
fail a request. ``fetch`` returns misses on every failure path;
``publish`` and ``invalidate_image`` are fire-and-forget.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Optional, Tuple

from ...cluster import (
    AntiEntropyRepairer,
    CorruptionLedger,
    EpochRegistry,
    FleetBrains,
    GossipManager,
    HedgePolicy,
    HotSetReplicator,
    MembershipManager,
    RedisLink,
    body_matches,
    build_digest,
    decode_transfer,
    encode_transfer,
    image_id_of,
    parse_digest,
)
from ...cluster.integrity import INTEGRITY_FAILS
from ...cluster.repair import REPAIR_PULLED, REPAIR_ROUNDS
from ...cluster.replicate import REPLICATION
from ...obs.recorder import ambient_stage, current_record
from ...utils.metrics import REGISTRY
from ..result_cache import CachedTile
from .l2 import RedisL2Tier, encode_entry
from .peer import PEER_HEADER, PeerClient, filename_from_disposition
from .ring import HashRing

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.cache.plane")

PLANE_PURGES = REGISTRY.counter(
    "tile_cache_plane_purges_total",
    "Cluster invalidation fan-outs by target and outcome",
)
RING_VERSION = REGISTRY.gauge(
    "cluster_ring_version",
    "Monotonic ownership-ring rebuild count on this replica",
)


class CachePlane:
    def __init__(
        self,
        members: tuple = (),
        self_url: Optional[str] = None,
        virtual_nodes: int = 64,
        peer_timeout_s: float = 0.5,
        l2_uri: Optional[str] = None,
        l2_ttl_s: float = 3600.0,
        lease_ttl_s: float = 0.0,
        replication_factor: int = 1,
        transfer_max_entries: int = 128,
        hedge: Optional[HedgePolicy] = None,
        secret: Optional[str] = None,
        result_cache=None,
        scheduler=None,
        admission=None,
        repair_interval_s: float = 0.0,
        repair_max_keys: int = 64,
        quality=None,
        suspicion=None,
        gossip_interval_s: float = 0.0,
        gossip_fanout: int = 2,
        gossip_fail_after_s: float = 5.0,
        integrity_verify: bool = True,
    ):
        self.self_url = self_url
        self.secret = secret
        self.result_cache = result_cache
        # r20 byte integrity: every ingress of remote bytes (peer
        # fetch, replica push, handoff/warm-up/repair transfer, L2
        # read) re-hashes the body against the entry's strong ETag;
        # the ledger turns repeated mismatches into suspicion
        # verdicts (cluster/integrity.py)
        self.integrity_verify = bool(integrity_verify)
        self.corruption = CorruptionLedger()
        self.gossip_enabled = gossip_interval_s > 0 and bool(self_url)
        # the coordination link: the cluster's OWN connection to the
        # shared Redis (lease scans must not head-of-line-block a
        # serving-path L2 get) — built whenever the shared Redis
        # exists, since epoch bumps want it even with static
        # membership
        self.link: Optional[RedisLink] = None
        self.epochs: Optional[EpochRegistry] = None
        if l2_uri:
            self.link = RedisLink(l2_uri)
            self.epochs = EpochRegistry(self.link)
        elif self.gossip_enabled:
            # no Redis at all: epochs still exist — bumps advance the
            # local high-water mark and gossip disseminates it, so
            # invalidation keeps converging with no coordinator
            self.epochs = EpochRegistry(None)
        self.l2 = (
            RedisL2Tier(
                l2_uri, ttl_s=l2_ttl_s, epochs=self.epochs,
                verify_bodies=self.integrity_verify,
            )
            if l2_uri else None
        )
        self.ring: Optional[HashRing] = None
        self.peers: Optional[PeerClient] = None
        self.virtual_nodes = virtual_nodes
        self.ring_version = 0
        if self_url:
            # the client exists whenever this replica has an identity
            # — with dynamic membership the ring can appear AFTER
            # construction (a peer's lease shows up in a scan), and
            # every peer path must already have its client then
            self.peers = PeerClient(
                self_url, timeout_s=peer_timeout_s, secret=secret
            )
        if members and self_url:
            self.ring = HashRing(members, virtual_nodes)
        # fleet lifecycle state (r18): replicas the quality quorum
        # demoted (never owners until restored) and this replica's own
        # draining flag (set by the drain protocol; excludes self from
        # its own ring so final fills route to the post-drain owners)
        self.demoted: frozenset = frozenset()
        self.draining = False
        self.quality = quality
        self.suspicion = suspicion
        self.membership = None
        self.brains: Optional[FleetBrains] = None
        if self.gossip_enabled and self.peers is not None:
            # r20 decentralized mode: gossip IS membership; Redis
            # (when configured) is only the L2 cache and the join-
            # bootstrap hint the GossipManager consults best-effort
            self.membership = GossipManager(
                self.peers, self_url, members or (self_url,),
                interval_s=gossip_interval_s,
                fanout=gossip_fanout,
                fail_after_s=gossip_fail_after_s,
                on_change=self._on_membership_change,
                link=self.link, secret=secret or "",
                epochs=self.epochs,
            )
        elif lease_ttl_s > 0 and self.link is not None and self_url:
            self.membership = MembershipManager(
                self.link, self_url, members or (self_url,),
                lease_ttl_s, on_change=self._on_membership_change,
                secret=secret or "",
            )
        if self.membership is not None:
            self.brains = FleetBrains(
                self.link, self_url,
                scheduler=scheduler, admission=admission,
                quality=quality, suspicion=suspicion,
                peer_failures_source=(
                    self.peers.take_failures
                    if self.peers is not None else None
                ),
                on_demote=self._on_demote,
                secret=secret or "",
                corruption_source=self.corruption.counts,
            )
        self.replicator: Optional[HotSetReplicator] = None
        if replication_factor > 1 and self.peers is not None:
            self.replicator = HotSetReplicator(
                self_url,
                replication_factor=replication_factor,
                transfer_max_entries=transfer_max_entries,
            )
        # anti-entropy repair (cluster/repair.py): only meaningful
        # over replication — without a factor there is nothing the
        # contract says this replica should hold for anyone else
        self.repairer: Optional[AntiEntropyRepairer] = None
        if (
            repair_interval_s > 0
            and self.replicator is not None
            and self_url
        ):
            self.repairer = AntiEntropyRepairer(
                self_url,
                interval_s=repair_interval_s,
                max_keys=repair_max_keys,
            )
        # gated on the CLIENT, not the ring: with dynamic membership
        # the ring may only materialize after the first lease scan
        self.hedge = hedge if (
            hedge is not None and self.peers is not None
        ) else None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._tasks: set = set()
        self._warmed_up = False
        self._closed = False

    # -- lifecycle -----------------------------------------------------

    def start(self, loop: asyncio.AbstractEventLoop) -> None:
        """Capture the serving loop (invalidation listeners fire from
        resolver threads and need somewhere to schedule the fan-out)
        and start the coordination loop when membership is dynamic
        (plus the low-duty anti-entropy loop when repair is on)."""
        self._loop = loop
        if self.membership is not None:
            self._spawn(self._coord_loop())
        if self.repairer is not None:
            self._spawn(self._repair_loop())

    async def close(self) -> None:
        # the closed flag FIRST: `asyncio.wait_for` (< 3.12) can
        # SWALLOW a cancellation that races its inner future's
        # completion (bpo-42130) — on a loopback fleet the coord
        # exchanges complete in microseconds, so a cancel landing
        # mid-heartbeat has a real chance of being eaten, and a
        # cancel-only close would leave the loop heartbeating a
        # closed link forever. The background loops re-check the
        # flag every round, so even a swallowed cancel exits at the
        # next loop top; the bounded wait drains them without
        # letting a pathological case park shutdown.
        self._closed = True
        tasks = [t for t in self._tasks if not t.done()]
        for task in tasks:
            task.cancel()
        if tasks:
            await asyncio.wait(tasks, timeout=2.0)
        if self.l2 is not None:
            await self.l2.close()
        if self.link is not None:
            await self.link.close()

    def _spawn(self, coro) -> None:
        """Fire-and-forget on the serving loop, exceptions consumed
        (every coroutine here is already internally degrading — this
        guards only against 'Task exception was never retrieved')."""
        task = asyncio.get_running_loop().create_task(coro)
        self._tasks.add(task)

        def _done(t):
            self._tasks.discard(t)
            if not t.cancelled():
                t.exception()

        task.add_done_callback(_done)

    # -- cluster coordination loop -------------------------------------

    async def _coord_loop(self) -> None:
        """The heartbeat: membership round (lease refresh + scan, or
        a gossip push-pull fanout), brain exchange, and — once, after
        the first successful refresh — the join-time warm-up pull.
        One loop, one cadence; each round degrades independently.

        In gossip mode the brain payload is computed BEFORE the round
        (it piggybacks on the outbound digest) and the collected
        fleet map comes from the gossip state instead of a Redis
        MGET — so pressure, dead-dependency suspicion, and quality
        demotion all keep converging with Redis gone entirely."""
        membership = self.membership
        gossip_mode = isinstance(membership, GossipManager)
        first = True
        while not self._closed:
            if gossip_mode and self.brains is not None:
                membership.set_local_brain(
                    self.brains.local_payload()
                )
            ok = await membership.refresh_once()
            if self.brains is not None and not self._closed:
                if gossip_mode:
                    self.brains.apply_fleet(
                        membership.fleet_brains(),
                        membership.members,
                    )
                else:
                    await self.brains.publish_once(
                        membership.interval_s
                    )
                    await self.brains.collect_once(
                        membership.members
                    )
            if first and ok:
                first = False
                # spawned, not awaited: warm-up pulls each peer under
                # the full peer timeout — inline it would delay the
                # NEXT lease refresh past the TTL on a slow fleet and
                # flap the fresh joiner off every ring
                self._spawn(self._warm_up_once())
            await asyncio.sleep(membership.interval_s)

    def _on_membership_change(self, added, removed, members) -> None:
        self._rebuild_ring(members)

    def _on_demote(self, demoted: frozenset) -> None:
        """Quality-quorum sink (cluster/suspect via brains): demoted
        replicas stay in the member view (they serve on) but leave
        the ownership ring until the quorum dissolves."""
        if demoted == self.demoted:
            return
        self.demoted = demoted
        self._rebuild_ring()

    def _ring_eligible(self, members=None) -> tuple:
        """Who may OWN keys right now: the live member view minus
        draining replicas (planned leave announced), minus quality-
        demoted replicas, minus self while this replica drains."""
        eligible = set(
            members if members is not None else self.members_view()
        )
        if self.membership is not None:
            eligible -= set(self.membership.draining)
        eligible -= set(self.demoted)
        if self.draining and self.self_url in eligible:
            eligible.discard(self.self_url)
        return tuple(sorted(eligible))

    def _rebuild_ring(self, members=None) -> None:
        """Rebuild the ownership ring from the eligible view. The
        swap is a single reference assignment (readers mid-request
        keep the ring they started with — bounded-disagreement
        semantics cover the window). An EMPTY eligible view keeps the
        last ring: lifecycle filters must never collapse routing to
        nothing."""
        eligible = self._ring_eligible(members)
        try:
            self.ring = HashRing(eligible, self.virtual_nodes)
        except ValueError:
            return  # empty view: keep the last ring
        self.ring_version += 1
        RING_VERSION.set(self.ring_version)
        if self.replicator is not None:
            # new ring, new successors: let hot keys re-replicate
            self.replicator.ring_changed()
        if self.repairer is not None:
            # ownership moved: stale digest checksums must not skip
            # peers whose holdings-for-us just changed
            self.repairer.ring_changed()
        log.info(
            "ownership ring rebuilt (v%d): %d owners",
            self.ring_version, len(eligible),
        )

    async def _warm_up_once(self) -> None:
        """Join-time warm-up: a COLD replica (no manifest-warmed disk,
        empty RAM) pulls each live peer's hottest entries once so it
        serves warm within one transfer round. Any failure leaves it
        exactly as cold as it already was."""
        if (
            self.replicator is None
            or self.peers is None
            or self.result_cache is None
            or self._warmed_up
        ):
            return
        cache = self.result_cache
        try:
            cold = len(cache.memory) == 0 and (
                cache.disk is None or len(cache.disk) == 0
            )
        except Exception:
            cold = False
        if not cold:
            return
        self._warmed_up = True
        members = (
            self.membership.members if self.membership is not None
            else (self.ring.members if self.ring is not None else ())
        )
        pulled = 0
        for member in members:
            if member == self.self_url:
                continue
            body = await self.peers.pull_transfer(
                member, self.replicator.transfer_max_entries
            )
            if body is None:
                continue
            pulled += await self._absorb_transfer(
                body, source="transfer", member=member
            )
        if pulled:
            self.replicator.transfers_pulled += 1
            log.info("join warm-up: absorbed %d hot entries", pulled)

    def verify_entry_bytes(
        self, entry: CachedTile, source: str,
        member: Optional[str] = None,
    ) -> bool:
        """The single integrity gate every ingress of remote bytes
        passes: True when the body hashes to the entry's strong ETag
        (or verification is disabled). A failure counts by source,
        strikes the sending member in the corruption ledger (feeding
        the suspicion quorum), and the caller MUST discard the
        bytes."""
        if not self.integrity_verify:
            return True
        if body_matches(entry.etag, entry.body):
            return True
        INTEGRITY_FAILS.inc(source=source)
        self.corruption.note(member)
        log.warning(
            "integrity check failed on %s bytes from %s — discarded",
            source, member or "<unknown>",
        )
        return False

    async def _absorb_transfer(
        self, body: bytes, source: str = "transfer",
        member: Optional[str] = None,
    ) -> int:
        from .l2 import decode_entry_epoch

        cache = self.result_cache
        stored = 0
        for key, frame in decode_transfer(body):
            entry, epoch = decode_entry_epoch(frame)
            if entry is None:
                continue
            if not self.verify_entry_bytes(
                entry, source, member=member
            ):
                continue
            if self.epochs is not None and self.epochs.is_stale(
                key, epoch
            ):
                continue
            cache.put(key, entry, generation=cache.generation())
            stored += 1
        return stored

    # -- graceful drain (cluster/lifecycle.py owns the timeline) -------

    def drain_propagation_s(self) -> float:
        """How long the drain waits after announcing so peers observe
        the marker (one heartbeat interval, with margin) before the
        handoff lands at the post-drain owners."""
        if self.membership is not None:
            return self.membership.interval_s * 1.5
        return 0.05  # static membership: nothing to propagate

    async def begin_drain(self) -> bool:
        """Drain step 1: announce the planned leave. The local ring
        rebuilds WITHOUT self immediately (final fills and the
        handoff both route to the post-drain owners); the lease
        marker makes every peer do the same within one heartbeat."""
        self.draining = True
        announced = False
        if self.membership is not None:
            announced = await self.membership.mark_draining()
        self._rebuild_ring()
        return announced

    async def handoff_hot_set(
        self, deadline: float, clock=time.monotonic
    ) -> dict:
        """Drain step 2: the FULL RAM hot set — not just the TinyLFU-
        qualified slice replication already pushed — grouped by post-
        drain owner and POSTed as transfer-framed batches. Bounded by
        the transfer byte cap per target and the drain deadline
        overall (``deadline`` and ``clock`` share the drain
        coordinator's clock domain); a dead target costs its batch
        (those keys re-render once at the new owner), never the
        drain."""
        cache = self.result_cache
        stats = {"entries": 0, "targets": 0, "pushed": 0, "errors": 0}
        if (
            cache is None or self.peers is None or self.ring is None
            or not self.ring.members
        ):
            return stats
        try:
            items = cache.memory.items_snapshot()
        except Exception:
            return stats
        by_target: dict = {}
        for key, entry in items:
            target = self.ring.owner(key)
            if target == self.self_url:
                continue  # ring still thinks we own it: nowhere to go
            epoch = None
            if self.epochs is not None:
                image_id = image_id_of(key)
                if image_id is not None:
                    epoch = self.epochs.known(image_id)
            by_target.setdefault(target, []).append(
                (key, encode_entry(entry, epoch=epoch))
            )
        stats["entries"] = sum(len(v) for v in by_target.values())
        stats["targets"] = len(by_target)
        for target, entries in by_target.items():
            if clock() >= deadline:
                stats["errors"] += 1
                log.warning("drain handoff: deadline expired with "
                            "%s unpushed", target)
                continue
            payload = encode_transfer(entries)
            ok = await self.peers.push_handoff(target, payload)
            if ok:
                stats["pushed"] += len(entries)
                REPLICATION.inc(op="handoff", outcome="ok")
            else:
                stats["errors"] += 1
                REPLICATION.inc(op="handoff", outcome="error")
        return stats

    async def handoff_sessions(
        self, registry, deadline: float, clock=time.monotonic,
    ) -> dict:
        """Drain step 2b (session plane, r22): hand the live-channel
        subscription summary to ONE post-drain successor and tell
        every connected client where to reconnect. Identities never
        ride the wire — the summary is per-image channel counts; the
        client re-authenticates at the successor, which is what keeps
        the handoff a capacity hint rather than a credential move.
        Best-effort like the cache handoff: a dead successor just
        means clients reconnect through the balancer instead."""
        stats = {"channels": 0, "successor": "", "pushed": False}
        if registry is None:
            return stats
        successor = ""
        eligible = [
            m for m in self._ring_eligible() if m != self.self_url
        ]
        if eligible and self.peers is not None \
                and clock() < deadline:
            successor = eligible[0]
            summary = registry.begin_handoff(successor)
            stats["channels"] = summary.get("channels", 0)
            stats["successor"] = successor
            if stats["channels"]:
                stats["pushed"] = await self.peers.push_session_handoff(
                    successor,
                    json.dumps(summary).encode("utf-8"),
                )
        else:
            # no successor (last replica) or out of time: close the
            # channels with a bare reconnect frame — the balancer
            # decides where those clients land
            summary = registry.begin_handoff("")
            stats["channels"] = summary.get("channels", 0)
        return stats

    async def release_lease(self) -> bool:
        """Drain step 4: leave the fleet for good."""
        if self.membership is not None:
            return await self.membership.release_lease()
        return True

    async def absorb_handoff(
        self, body: bytes, member: Optional[str] = None,
    ) -> int:
        """Inbound half of the drain handoff: transfer-framed entries
        from a draining peer, admitted through the same epoch-checked
        AND hash-checked path as a join warm-up (a handoff can never
        resurrect purged bytes — or inject corrupt ones)."""
        stored = await self._absorb_transfer(
            body, source="handoff", member=member
        )
        if self.replicator is not None:
            self.replicator.received += stored
        REPLICATION.inc(op="handoff_recv", outcome="ok")
        return stored

    # -- anti-entropy repair (cluster/repair.py) -----------------------

    def digest_limit(self) -> int:
        if self.replicator is not None:
            return max(
                self.replicator.transfer_max_entries,
                self.repairer.max_keys if self.repairer else 0,
            )
        return self.repairer.max_keys if self.repairer else 64

    def digest_payload(self, limit: int) -> bytes:
        """The /internal/digest response: a compact (key, epoch)
        summary of this replica's WARM SET — the hottest RAM entries
        first, then the disk tier's manifest keys (r20) — what the
        replication contract says its successors should hold. Before
        the disk keys joined, anti-entropy only converged the RAM
        slice: an entry that spilled to disk was invisible to repair
        and its replica copies silently rotted away across churn."""
        cache = self.result_cache
        if cache is None or limit <= 0:
            return build_digest([])
        items = []
        for key in cache.warm_keys(limit):
            epoch = None
            if self.epochs is not None:
                image_id = image_id_of(key)
                if image_id is not None:
                    epoch = self.epochs.known(image_id)
            items.append((key, epoch))
        if self.repairer is not None:
            self.repairer.digests_served += 1
        return build_digest(items)

    async def pull_payload(self, keys: list) -> bytes:
        """The /internal/pull response: the requested entries (those
        present locally), transfer-framed and byte-bounded. The key
        count is bounded by the digest limit — a peer can never ask
        for more than a digest could have named."""
        cache = self.result_cache
        out = []
        if cache is not None:
            for key in list(keys)[: self.digest_limit()]:
                if not isinstance(key, str):
                    continue
                entry = await cache.get(key)
                if entry is None:
                    continue
                epoch = None
                if self.epochs is not None:
                    image_id = image_id_of(key)
                    if image_id is not None:
                        epoch = self.epochs.known(image_id)
                out.append((key, encode_entry(entry, epoch=epoch)))
        return encode_transfer(out)

    async def _repair_loop(self) -> None:
        """The low-duty anti-entropy cadence: one digest exchange
        with one rotating peer per interval. Every failure skips the
        round — repair never competes with serving and never fails
        anything."""
        rep = self.repairer
        while not self._closed:
            await asyncio.sleep(rep.interval_s)
            if self.draining or self._closed:
                continue  # a leaving replica repairs nothing
            try:
                await self.repair_round()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.debug("repair round failed", exc_info=True)

    async def repair_round(self) -> int:
        """One anti-entropy round; how many entries were pulled (the
        chaos suite drives this directly to pin convergence)."""
        rep = self.repairer
        if rep is None or self.peers is None or self.ring is None:
            return 0
        candidates = [
            m for m in self._ring_eligible() if m != self.self_url
        ]
        peer = rep.next_peer(candidates)
        if peer is None:
            return 0
        rep.rounds += 1
        body = await self.peers.get_digest(peer, self.digest_limit())
        if body is None:
            REPAIR_ROUNDS.inc(outcome="digest_error")
            return 0
        digest = parse_digest(body)
        if digest is None:
            REPAIR_ROUNDS.inc(outcome="corrupt")
            return 0
        if rep.unchanged(peer, digest["sum"]):
            rep.skipped_unchanged += 1
            rep.last_round_pulled = 0
            REPAIR_ROUNDS.inc(outcome="unchanged")
            return 0
        cache = self.result_cache
        factor = (
            self.replicator.replication_factor
            if self.replicator is not None else 1
        )
        wanted = rep.select_missing(
            peer, digest["entries"], self.ring, factor,
            has_local=(
                cache.contains_any_tier if cache is not None
                else lambda _k: True
            ),
            is_stale=(
                self.epochs.is_stale if self.epochs is not None
                else lambda _k, _e: False
            ),
        )
        if not wanted:
            rep.last_round_pulled = 0
            rep.note_synced(peer, digest["sum"])
            REPAIR_ROUNDS.inc(outcome="in_sync")
            return 0
        frames = await self.peers.pull_keys(peer, wanted)
        if frames is None:
            rep.pull_errors += 1
            REPAIR_ROUNDS.inc(outcome="pull_error")
            return 0
        stored = await self._absorb_transfer(
            frames, source="repair", member=peer
        )
        rep.pulled += stored
        rep.last_round_pulled = stored
        if stored:
            REPAIR_PULLED.inc(stored)
            log.info("anti-entropy: pulled %d entries from %s",
                     stored, peer)
        rep.note_synced(peer, digest["sum"])
        REPAIR_ROUNDS.inc(outcome="repaired")
        return stored

    # -- serving path --------------------------------------------------

    async def fetch(
        self,
        key: str,
        path_qs: str,
        session_cookie: Optional[str],
        peer_originated: bool,
    ) -> Tuple[
        Optional[CachedTile], Optional[str], Optional[int],
        Optional[asyncio.Task],
    ]:
        """The between-miss-and-render consult: L2 first (cheapest
        shared copy), then one bounded GET to the key's owner — unless
        this request already IS a peer hop (the ``X-OMPB-Peer`` loop
        guard makes forwarding terminal, and the requester consulted
        L2 microseconds ago, so re-checking here would spend a wasted
        Redis round trip inside the requester's peer-timeout window)
        or this replica owns the key (owners render; that's what
        ownership means).

        Returns ``(entry, provenance, epoch, pending_peer)``:

        - ``epoch`` is the image epoch observed in the SAME round trip
          as the L2 consult — the stamp the caller's eventual fill
          must carry (captured before the render, so a purge landing
          mid-flight outruns the fill by construction);
        - ``pending_peer`` is a still-running peer fetch task when the
          hedge policy fired (the owner ran past the observed p99):
          the caller races its local render against it and serves
          whichever finishes first. The caller OWNS the task —
          consume or cancel it."""
        if peer_originated:
            return None, None, None, None
        epoch = None
        if self.l2 is not None:
            with ambient_stage("l2"):
                entry, epoch = await self.l2.get_with_epoch(key)
            if entry is not None:
                return entry, "l2-hit", epoch, None
        if self.ring is not None:
            owner = self.ring.owner(key)
            if owner != self.self_url:
                # inject the requester's trace onto the hop so the
                # owner's flight record joins it (cross-replica
                # continuity); the owner's identity lands in the
                # requester's tags either way
                rec = current_record()
                trace_context = None
                if rec is not None:
                    trace_context = {
                        "trace_id": rec.trace_id,
                        "span_id": rec.span_id,
                    }
                    rec.tag("peer_owner", owner)
                    if self.ring_version:
                        rec.tag("ring_version", self.ring_version)
                delay = (
                    self.hedge.delay_s()
                    if self.hedge is not None else None
                )
                if delay is None:
                    with ambient_stage("peer"):
                        result = await self.peers.fetch(
                            owner, path_qs, session_cookie,
                            trace_context=trace_context,
                            epoch_hint=epoch,
                        )
                else:
                    task = asyncio.get_running_loop().create_task(
                        self._staged_peer_fetch(
                            owner, path_qs, session_cookie,
                            trace_context, epoch,
                        )
                    )
                    # the owner rides along so a late consumer (the
                    # hedge race in http/server) can attribute an
                    # integrity failure to it
                    task.ompb_owner = owner
                    done, pending = await asyncio.wait(
                        {task}, timeout=delay
                    )
                    if pending:
                        # the owner ran past the observed p99: hand
                        # the still-bounded fetch back so the caller
                        # starts the local render NOW
                        self.hedge.note("fired")
                        if rec is not None:
                            rec.tag("hedge", "fired")
                        return None, None, epoch, task
                    result = task.result()  # ompb-lint: disable=loop-block -- asyncio.Task already in asyncio.wait's done set: result() returns immediately, never blocks
                entry = self.entry_from_peer(result, owner)
                if entry is not None:
                    return entry, "peer-hit", epoch, None
        return None, None, epoch, None

    async def _staged_peer_fetch(
        self, owner, path_qs, session_cookie, trace_context, epoch
    ):
        """The hedged peer fetch, stamped MANUALLY instead of via
        ``ambient_stage``: a context manager would stamp on
        CancelledError too, and a hedge-cancelled fetch would record
        ~(delay + local render) — not the owner's true latency —
        poisoning the very histogram the hedge delay is computed
        from (each truncated sample drags the observed p99 toward
        the delay itself). Cancelled fetches record nothing."""
        rec = current_record()
        t0 = time.perf_counter()
        result = await self.peers.fetch(
            owner, path_qs, session_cookie,
            trace_context=trace_context, epoch_hint=epoch,
        )
        if rec is not None:
            rec.stamp("peer", time.perf_counter() - t0)
        return result

    @staticmethod
    def entry_from_peer_result(result) -> Optional[CachedTile]:
        """A ``CachedTile`` from a completed peer exchange, or None
        for any failure/non-200 (the caller renders locally). The
        declared ETag is carried verbatim — ``entry_from_peer`` is
        the integrity-checked wrapper serving paths must use."""
        if result is None or result[0] != 200:
            return None
        _status, headers, body = result
        etag = headers.get("etag")
        if etag is None:
            # never auto-compute a validator for remote bytes: a
            # CachedTile minted without one would hash ITSELF into
            # a matching ETag and sail through the integrity gate
            return None
        return CachedTile(
            body,
            etag=etag,
            filename=filename_from_disposition(
                headers.get("content-disposition", "")
            ),
        )

    def entry_from_peer(
        self, result, owner: Optional[str] = None
    ) -> Optional[CachedTile]:
        """The serving-path version: parse AND verify. A body that
        does not hash to the owner's declared ETag is discarded (the
        caller renders locally — wrong bytes are never served) and
        strikes the owner in the corruption ledger."""
        entry = self.entry_from_peer_result(result)
        if entry is None:
            return None
        if not self.verify_entry_bytes(entry, "peer", member=owner):
            return None
        return entry

    def publish(
        self, key: str, entry: CachedTile,
        epoch: Optional[int] = None,
    ) -> None:
        """Write-through to the shared tier after a local render
        completes (called from the single-flight fill hook, so once
        per flight no matter how many requests coalesced), stamped
        with the flight's pre-render epoch snapshot. Best-effort and
        never awaited by the response path. Hot fills also replicate
        to the ring successor(s)."""
        if self.l2 is not None:
            self._spawn(self.l2.put(key, entry, epoch=epoch))
        self._maybe_replicate(key, entry, epoch)

    def note_hit(self, key: str, entry: CachedTile) -> None:
        """Serving-path hit hook: replication qualifies on frequency,
        and most keys cross the hot bar on a HIT, not a fill. O(1)
        when it declines (a set probe + a sketch read)."""
        self._maybe_replicate(key, entry, None)

    def _maybe_replicate(
        self, key: str, entry: CachedTile, epoch: Optional[int]
    ) -> None:
        rep = self.replicator
        if rep is None or self.ring is None:
            return
        estimate = None
        cache = self.result_cache
        if cache is not None:
            admission = getattr(cache.memory, "admission", None)
            if admission is not None:
                estimate = admission.estimate(key)
        if not rep.qualifies(key, estimate):
            return
        targets = rep.targets(self.ring, key)
        if not targets:
            return
        rep.mark_pushed(key)
        if epoch is None and self.epochs is not None:
            image_id = image_id_of(key)
            if image_id is not None:
                epoch = self.epochs.known(image_id)
        frame = encode_entry(entry, epoch=epoch)
        self._spawn(self._push_replicas(key, frame, targets))

    async def _push_replicas(self, key, frame, targets) -> None:
        rep = self.replicator
        for member in targets:
            ok = await self.peers.push_replica(member, key, frame)
            if ok:
                rep.pushes += 1
                REPLICATION.inc(op="push", outcome="ok")
            else:
                rep.push_errors += 1
                REPLICATION.inc(op="push", outcome="error")

    def hot_transfer_payload(self, limit: int) -> bytes:
        """The outbound half of join warm-up: this replica's hottest
        RAM entries, framed for the wire (the /internal/transfer
        handler's body)."""
        cache = self.result_cache
        if cache is None or limit <= 0:
            return b""
        items = []
        for key, entry in cache.hot_entries(limit):
            epoch = None
            if self.epochs is not None:
                image_id = image_id_of(key)
                if image_id is not None:
                    epoch = self.epochs.known(image_id)
            items.append((key, encode_entry(entry, epoch=epoch)))
        if self.replicator is not None:
            self.replicator.transfers_served += 1
        REPLICATION.inc(op="transfer_serve", outcome="ok")
        return encode_transfer(items)

    def note_epoch(self, image_id: int, epoch: Optional[int]) -> None:
        """Inbound epoch knowledge (purge fan-outs carry the new epoch
        on the wire)."""
        if self.epochs is not None and epoch is not None:
            self.epochs.note(image_id, epoch)

    def replica_push_stale(
        self, key: str, epoch: Optional[int]
    ) -> bool:
        """Whether an inbound replica push predates this replica's
        epoch knowledge of its image (an in-flight push racing a purge
        fan-out must lose)."""
        if self.epochs is None:
            return False
        return self.epochs.is_stale(key, epoch)

    # -- invalidation --------------------------------------------------

    def invalidate_image(self, image_id: int) -> None:
        """Cluster half of an image purge: epoch bump FIRST (the bump
        is what makes the purge win every race — the DELs that follow
        are space reclamation), then L2 DELs + peer purge fan-out,
        scheduled on the serving loop (callable from any thread — the
        metadata resolver's refresh thread fires listeners). The
        caller's LOCAL purge has already happened synchronously;
        nothing here can delay or fail it."""
        loop = self._loop
        if loop is None or loop.is_closed():
            return
        try:
            asyncio.run_coroutine_threadsafe(
                self._invalidate_async(image_id), loop
            )
        except RuntimeError:
            pass  # loop shutting down: local purge already done

    async def _invalidate_async(self, image_id: int) -> None:
        epoch = None
        if self.epochs is not None:
            epoch = await self.epochs.bump(image_id)
        ops = []
        labels = []
        if self.l2 is not None:
            ops.append(self.l2.delete_image(image_id))
            labels.append("l2")
        if self.ring is not None:
            for member in self.members_view():
                if member == self.self_url:
                    continue
                ops.append(
                    self.peers.purge(member, image_id, epoch=epoch)
                )
                labels.append("peer")
        if not ops:
            return
        # each op is internally bounded (breaker + per-call timeout);
        # gather with return_exceptions so one dead peer cannot stop
        # the DELs — or surface anything to anyone
        results = await asyncio.gather(*ops, return_exceptions=True)
        for label, result in zip(labels, results):
            failed = isinstance(result, Exception) or result is False
            PLANE_PURGES.inc(
                target=label, outcome="error" if failed else "ok"
            )

    def gossip_receive(self, remote: dict) -> Optional[dict]:
        """Inbound half of a push-pull gossip exchange (the
        ``/internal/gossip`` handler): merge the sender's digest,
        reply with ours. None when this replica does not run gossip
        membership (the handler answers 503 — a mixed-mode fleet
        mid-migration degrades to the Redis plane)."""
        membership = self.membership
        if not isinstance(membership, GossipManager):
            return None
        return membership.receive(remote)

    def note_peer_contact(self, url: str) -> None:
        """Gossip-native join hint (r22): every authenticated peer
        request carries the sender's serving URL in the signed
        ``X-OMPB-Peer`` header, so ANY verified internal contact — in
        either direction — teaches this replica a member address
        without touching Redis. Only URL-shaped values from verified
        requests are adopted (the HTTP layer gates on signature);
        everything else is silently ignored — this is a hint, never
        an authority."""
        if not isinstance(url, str) or len(url) > 512:
            return
        if not (url.startswith("http://") or url.startswith("https://")):
            return
        if url == self.self_url:
            return
        membership = self.membership
        if membership is not None and hasattr(membership, "note_contact"):
            membership.note_contact(url)

    def members_view(self) -> tuple:
        """The live member list: the lease/gossip view when
        membership is dynamic, the ring's (bootstrap) list
        otherwise."""
        if self.membership is not None:
            return tuple(self.membership.members)
        if self.ring is not None:
            return tuple(self.ring.members)
        return ()

    # -- observability -------------------------------------------------

    def snapshot(self) -> dict:
        out: dict = {"self": self.self_url}
        if self.l2 is not None:
            out["l2"] = self.l2.snapshot()
        if self.ring is not None:
            out["ring"] = self.ring.snapshot()
            out["ring"]["version"] = self.ring_version
            out["peer_breakers"] = self.peers.snapshot()
        return out

    def cluster_snapshot(self) -> dict:
        """The /healthz ``cluster`` key: the coordination view."""
        out: dict = {
            "enabled": self.membership is not None
            or self.replicator is not None
            or self.hedge is not None,
            "self": self.self_url,
            "ring_version": self.ring_version,
            "authenticated": bool(self.secret),
            "draining": self.draining,
            "demoted": sorted(self.demoted),
            "gossip": self.gossip_enabled,
            "integrity": {
                "verify": self.integrity_verify,
                "ledger": self.corruption.snapshot(),
            },
        }
        if self.repairer is not None:
            out["repair"] = self.repairer.snapshot()
        if self.quality is not None:
            out["quality"] = self.quality.snapshot()
        if self.suspicion is not None and self.suspicion.enabled:
            out["suspicion"] = self.suspicion.snapshot()
        if self.link is not None:
            out["coord_link"] = self.link.snapshot()
        if self.membership is not None:
            out["membership"] = self.membership.snapshot()
        if self.epochs is not None:
            out["epochs"] = self.epochs.snapshot()
        if self.replicator is not None:
            out["replication"] = self.replicator.snapshot()
        if self.hedge is not None:
            out["hedge"] = self.hedge.snapshot()
        if self.brains is not None:
            out["brains"] = self.brains.snapshot()
        return out


__all__ = ["CachePlane", "PEER_HEADER"]
