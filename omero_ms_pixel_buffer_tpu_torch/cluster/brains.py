"""Fleet-shared brains — one scheduler's knowledge, everyone's.

(Copy of ``omero_ms_pixel_buffer_tpu/cluster/brains.py``.)

The SLO scheduler (r13) and the breaker board are per-process: each
replica re-discovers overload and dead dependencies alone, paying the
full failure budget per process. This module shares the verdicts
through the same Redis the leases live in, riding the membership
heartbeat cadence:

- **publish** — every heartbeat, this replica SETs
  ``ompb:cluster:brain:<self-url>`` (PX-bounded at 3x the interval so
  a dead replica's brain expires with its lease) with its scheduler
  pressure (queue occupancy vs capacity), full-resolution service-
  time EWMA, whether it is actively shedding, and the names of its
  OPEN breakers;
- **collect** — every heartbeat, MGET the live members' brains and
  derive the fleet facts below.

Since r18 the payload also carries SERVE QUALITY (request/error
counts since the last publish plus a rolling p99 — cluster/suspect)
and this replica's VERDICTS about its peers; a strict majority of bad
verdicts demotes a replica to non-owner (it keeps serving, the ring
stops routing at it) until its signals recover — the "heartbeats but
serves garbage" detector the lease protocol cannot be. Fleet facts:

  * **fleet pressure** — the mean of the peers' pressure readings,
    fed to the local scheduler. A replica with spare capacity under a
    saturated fleet is about to inherit spillover traffic; engaging
    the hybrid-resolution degrade check early (instead of waiting for
    its own queue to back up) keeps the fleet inside deadlines.
  * **dead dependencies** — a dependency whose breaker a majority of
    reporting peers hold OPEN marks the local breaker SUSPECT: the
    next local failure trips it immediately instead of burning the
    whole per-process failure budget re-learning what the fleet
    already knows. Gossip alone never opens a breaker — a local
    success clears the suspicion — so a wrong rumor costs nothing.

Every failure degrades to per-process behavior: a publish/collect
error skips the round and clears nothing.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence

from ..obs.sli import active_burn_rates
from ..resilience.breaker import BOARD
from ..utils.metrics import REGISTRY
from .integrity import UNSIGNED_PAYLOADS
from .security import seal, unseal

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.cluster")

BRAIN_PREFIX = "ompb:cluster:brain:"

FLEET_PRESSURE = REGISTRY.gauge(
    "cluster_fleet_pressure",
    "Mean peer scheduler pressure observed via the brain exchange",
)
BRAIN_ROUNDS = REGISTRY.counter(
    "cluster_brain_rounds_total",
    "Brain publish/collect rounds by op and outcome",
)


def brain_key(member: str) -> bytes:
    return (BRAIN_PREFIX + member).encode()


# latest-instance registry for the fleet burn-rate gauge — the same
# weak-ref idiom the per-process slo_burn_rate gauge uses (tests boot
# several apps per process; the gauge follows the live instance)
_ACTIVE_BRAINS: Optional["weakref.ref"] = None
_fleet_gauge_registered = False
_fleet_gauge_lock = threading.Lock()


def _fleet_burn_gauge_values():
    ref = _ACTIVE_BRAINS
    brains = ref() if ref is not None else None
    if brains is None:
        return {}
    values = {}
    for window, rates in brains.fleet_sli.items():
        for cls, rate in rates.items():
            values[(("priority", cls), ("window", window))] = rate
    return values


def _register_fleet_gauge() -> None:
    global _fleet_gauge_registered
    with _fleet_gauge_lock:
        if not _fleet_gauge_registered:
            REGISTRY.gauge_fn(
                "slo_burn_rate_fleet",
                "Fleet-wide worst-replica error-budget burn rate by "
                "class and window (brain exchange)",
                _fleet_burn_gauge_values,
            )
            _fleet_gauge_registered = True


class FleetBrains:
    def __init__(
        self,
        link,
        self_url: str,
        scheduler=None,
        admission=None,
        pressure_engage: float = 0.9,
        quality=None,
        suspicion=None,
        peer_failures_source=None,
        on_demote=None,
        secret: str = "",
        corruption_source=None,
    ):
        self.link = link
        self.self_url = self_url
        self.scheduler = scheduler
        self.admission = admission
        self.pressure_engage = pressure_engage
        # quality-based suspicion (cluster/suspect.py): the local
        # serve-quality tracker feeding the payload, the verdict +
        # quorum policy, the peer-client failure counters, and the
        # demotion sink (the cache plane's ring rebuild)
        self.quality = quality
        self.suspicion = suspicion
        self.peer_failures_source = peer_failures_source
        self.on_demote = on_demote
        # r20: brain values in Redis are sealed under the cluster
        # secret — reaching Redis must not be enough to steer
        # suspicion — and integrity strikes (corruption_source, the
        # CorruptionLedger's counts) join the verdict inputs
        self.secret = secret
        self.corruption_source = corruption_source
        self.fleet: Dict[str, dict] = {}
        self.fleet_pressure = 0.0
        self.suspected: List[str] = []
        self.my_verdicts: List[str] = []
        self.demoted: List[str] = []
        self.publish_errors = 0
        self.collect_errors = 0
        self._last_shed_total = 0
        # fleet-wide SLI burn rates (PR-16 residual, closed r22):
        # {window: {class: burn}} — the WORST reporting replica per
        # (window, class), self included. Max, not mean: a burn rate
        # is a page signal, and averaging a 14x burn against nine
        # idle replicas is how a page gets lost.
        self.fleet_sli: Dict[str, Dict[str, float]] = {}
        global _ACTIVE_BRAINS
        _ACTIVE_BRAINS = weakref.ref(self)
        _register_fleet_gauge()

    # -- local view ----------------------------------------------------

    def local_payload(self) -> dict:
        pressure = 0.0
        ewma_s = 0.0
        shedding = False
        sched = self.scheduler
        if sched is not None:
            if sched.queue_size > 0:
                pressure = sched._waiting_total / sched.queue_size
            ewma_s = sched._service_ewma
            # "actively shedding" = sheds SINCE the last publish, not
            # the lifetime counter (which reads true forever after
            # one transient overload)
            total = sum(sched.sheds)
            shedding = total > self._last_shed_total
            self._last_shed_total = total
        adm = self.admission
        if adm is not None and adm.max_inflight > 0:
            pressure = max(pressure, adm.inflight / adm.max_inflight)
        open_deps = [
            name
            for name, b in BOARD.snapshot().items()
            if b.get("state") == "open"
        ]
        payload = {
            "url": self.self_url,
            "wall": time.time(),
            "pressure": round(min(pressure, 4.0), 4),
            "ewma_s": round(ewma_s, 6),
            "shedding": shedding,
            "open": open_deps,
        }
        if self.quality is not None:
            # serve-quality window (requests/errors since last
            # publish, rolling p99) — the suspicion signal
            payload["q"] = self.quality.take_window()
        if self.suspicion is not None and self.suspicion.enabled:
            # verdicts computed at the LAST collect round (publish
            # precedes collect in the heartbeat — one round of lag,
            # which the quorum absorbs)
            payload["bad"] = list(self.my_verdicts)
        burn = active_burn_rates()
        if burn is not None:
            # per-class burn rates by window — the fleet aggregation
            # (apply_fleet) takes the max across reporting replicas
            payload["sli"] = burn
        return payload

    # -- the exchange ---------------------------------------------------

    async def publish_once(
        self, interval_s: float, payload: Optional[dict] = None,
    ) -> bool:
        if payload is None:
            payload = self.local_payload()
        raw = seal(self.secret, json.dumps(
            payload, separators=(",", ":")
        ).encode())
        ttl_ms = str(int(max(interval_s * 3.0, 1.0) * 1000)).encode()
        try:
            await self.link.command(
                b"SET", brain_key(self.self_url), raw,
                b"PX", ttl_ms,
            )
        except Exception:
            self.publish_errors += 1
            BRAIN_ROUNDS.inc(op="publish", outcome="error")
            log.debug("brain publish failed", exc_info=True)
            return False
        BRAIN_ROUNDS.inc(op="publish", outcome="ok")
        return True

    async def collect_once(self, members: Sequence[str]) -> bool:
        peers = [m for m in members if m != self.self_url]
        if not peers:
            self.fleet = {}
            self._apply(0.0, [])
            return True
        try:
            raw = await self.link.command(
                b"MGET", *[brain_key(m) for m in peers]
            )
        except Exception:
            self.collect_errors += 1
            BRAIN_ROUNDS.inc(op="collect", outcome="error")
            log.debug("brain collect failed", exc_info=True)
            # a fleet we cannot hear reads as CALM: stale pressure
            # must not keep the scheduler degrading (or breakers
            # suspect — or a peer DEMOTED) for the whole length of a
            # Redis outage — per-process behavior is the degradation
            # contract
            self._apply(0.0, [])
            return False
        fleet: Dict[str, dict] = {}
        for member, value in zip(peers, raw):
            if value is None:
                continue
            payload = unseal(self.secret, value)
            if payload is None:
                # an unsigned/tampered brain is a poisoning attempt,
                # not a peer — it steers nothing
                UNSIGNED_PAYLOADS.inc(kind="brain")
                continue
            try:
                fleet[member] = json.loads(payload)
            except Exception:
                continue  # a corrupt brain is an absent brain
        self.apply_fleet(fleet, members)
        BRAIN_ROUNDS.inc(op="collect", outcome="ok")
        return True

    def apply_fleet(
        self, fleet: Dict[str, dict], members: Sequence[str],
    ) -> None:
        """Derive and apply the fleet facts from a collected brain
        map — the shared back half of ``collect_once``, also fed
        directly by the gossip layer (cluster/gossip.py) so pressure,
        dead-dependency suspicion, and quality demotion keep working
        with Redis gone entirely."""
        self.fleet = fleet
        pressures = [
            float(b.get("pressure") or 0.0) for b in fleet.values()
        ]
        mean_pressure = (
            sum(pressures) / len(pressures) if pressures else 0.0
        )
        # a dependency is fleet-dead when a STRICT majority of
        # reporting peers hold its breaker open — one confused
        # replica in a 3+ fleet is not the fleet (with exactly one
        # reporting peer, that peer IS the fleet's voice, and
        # suspicion still needs a local failure to confirm)
        counts: Dict[str, int] = {}
        for brain in fleet.values():
            for dep in brain.get("open") or []:
                if isinstance(dep, str):
                    counts[dep] = counts.get(dep, 0) + 1
        need = len(fleet) // 2 + 1
        suspects = sorted(
            dep for dep, n in counts.items() if n >= need
        ) if fleet else []
        # fleet SLI aggregation: worst burn per (window, class)
        # across every reporting replica, self included — bounded by
        # the fixed window/class vocabulary so a malformed brain
        # cannot grow the map
        fleet_sli: Dict[str, Dict[str, float]] = {}
        sources = [b.get("sli") for b in fleet.values()]
        sources.append(active_burn_rates())
        for sli in sources:
            if not isinstance(sli, dict):
                continue
            for window in ("5m", "30m", "1h"):
                rates = sli.get(window)
                if not isinstance(rates, dict):
                    continue
                slot = fleet_sli.setdefault(window, {})
                for cls in ("interactive", "prefetch", "bulk"):
                    try:
                        rate = float(rates.get(cls, 0.0))
                    except (TypeError, ValueError):
                        continue
                    if rate > slot.get(cls, -1.0):
                        slot[cls] = rate
        self.fleet_sli = fleet_sli
        verdicts: List[str] = []
        demoted: List[str] = []
        if self.suspicion is not None and self.suspicion.enabled:
            failures = {}
            if self.peer_failures_source is not None:
                try:
                    failures = self.peer_failures_source() or {}
                except Exception:
                    failures = {}
            corruptions = {}
            if self.corruption_source is not None:
                try:
                    corruptions = self.corruption_source() or {}
                except Exception:
                    corruptions = {}
            verdicts = self.suspicion.verdicts(
                fleet, failures, corruptions
            )
            demoted = self.suspicion.demoted(
                fleet, verdicts, tuple(members)
            )
        self._apply(mean_pressure, suspects, verdicts, demoted)

    def _apply(
        self,
        mean_pressure: float,
        suspects: List[str],
        verdicts: Optional[List[str]] = None,
        demoted: Optional[List[str]] = None,
    ) -> None:
        self.fleet_pressure = mean_pressure
        FLEET_PRESSURE.set(mean_pressure)
        if self.scheduler is not None:
            self.scheduler.note_fleet_pressure(
                mean_pressure, engaged=(
                    mean_pressure >= self.pressure_engage
                ),
            )
        for dep in suspects:
            if dep not in self.suspected:
                log.info("fleet reports dependency open: %s", dep)
            BOARD.create(dep).suspect()
        for dep in self.suspected:
            if dep not in suspects:
                BOARD.create(dep).clear_suspect()
        self.suspected = suspects
        # quality demotions: recomputed from scratch every round (a
        # quorum that dissolves restores the replica next heartbeat;
        # a collect failure decays to no demotions at all)
        self.my_verdicts = list(verdicts or [])
        new_demoted = list(demoted or [])
        if new_demoted != self.demoted:
            for url in new_demoted:
                if url not in self.demoted:
                    from .suspect import DEMOTIONS

                    DEMOTIONS.inc()
                    log.warning(
                        "quality quorum demoted replica: %s", url
                    )
            for url in self.demoted:
                if url not in new_demoted:
                    log.info("replica restored to ring: %s", url)
            self.demoted = new_demoted
            if self.on_demote is not None:
                try:
                    self.on_demote(frozenset(new_demoted))
                except Exception:
                    log.exception("demotion hook failed")
        else:
            self.demoted = new_demoted

    def snapshot(self) -> dict:
        return {
            "fleet_pressure": round(self.fleet_pressure, 4),
            "fleet_sli": {
                w: dict(r) for w, r in self.fleet_sli.items()
            },
            "suspected_deps": list(self.suspected),
            "my_verdicts": list(self.my_verdicts),
            "demoted": list(self.demoted),
            "peers": {
                url: {
                    "pressure": b.get("pressure"),
                    "ewma_s": b.get("ewma_s"),
                    "shedding": b.get("shedding"),
                    "open": b.get("open"),
                }
                for url, b in sorted(self.fleet.items())
            },
            "publish_errors": self.publish_errors,
            "collect_errors": self.collect_errors,
        }
