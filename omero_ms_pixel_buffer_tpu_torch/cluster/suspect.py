"""Quality-based suspicion — "heartbeats but serves garbage" detection.

(Copy of ``omero_ms_pixel_buffer_tpu/cluster/suspect.py``.)

Lease-TTL membership (membership.py) only detects replicas that stop
TALKING. A replica whose disk died, whose device queue wedged, or
whose dependency set rotted keeps heartbeating perfectly while every
tile it serves is a 500 or a 30-second tail — and r17 kept routing
ring traffic at it until each peer's own breakers burned their full
failure budgets discovering it independently (the KNOWN_GAPS
"lease-only failure detection" item).

This module rides the existing fleet-brain exchange (brains.py) — no
new coordination service, no extra Redis traffic:

- **signals** — each replica publishes its own serve quality per
  heartbeat: request count, 5xx count, and the p99 over a rolling
  latency sample (``QualityTracker``, fed by the HTTP front for every
  serving request).
- **verdicts** — each collector judges every peer: BAD when the
  peer's self-reported error rate crosses ``suspect.error-rate``,
  its p99 exceeds ``suspect.p99-factor`` x the fleet median, or the
  collector's OWN peer-client failures against it crossed
  ``suspect.peer-failures`` this window (the replica too sick to
  even report rides the third clause). Verdicts are published in the
  next brain payload.
- **demotion** — a replica marked bad by a STRICT MAJORITY of
  reporters (peers' brains plus the local verdict) is demoted to
  NON-OWNER: every healthy replica rebuilds its ring without it, so
  it stops receiving peer fetches, replica pushes, and handoffs —
  but it keeps its lease, keeps serving whatever still reaches it
  (local hits cost nothing), and rejoins the ring the moment the
  quorum dissolves. Demotion is recomputed from scratch every
  collect round: there is no sticky state to leak, and a Redis
  outage (collect failure) decays to per-process behavior exactly
  like the pressure signal does.

A quorum of liars can demote a healthy replica — the cost is bounded
(it serves on, merely unrouted) and symmetric with what those liars
could already do by serving garbage themselves. One confused replica
in a 3+ fleet can demote nobody.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from ..utils.metrics import REGISTRY

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.cluster")

DEMOTIONS = REGISTRY.counter(
    "cluster_demotions_total",
    "Quality-based ring demotions observed by this replica",
)


class QualityTracker:
    """Per-replica serve-quality accounting: counters since the last
    brain publish plus a rolling latency sample for the p99. Fed from
    the HTTP front for every serving-path completion (door sheds and
    guard 403s included — a replica shedding everything is not
    healthy). Thread-safe; ``take_window`` is called once per
    heartbeat by the brain publisher."""

    _SAMPLE = 256

    def __init__(self, clock=time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self._requests = 0
        self._errors = 0
        self._latencies: List[float] = []
        self._pos = 0
        self.windows = 0

    def note(self, status: int, duration_s: float) -> None:
        with self._lock:
            self._requests += 1
            if status >= 500:
                self._errors += 1
            if len(self._latencies) < self._SAMPLE:
                self._latencies.append(duration_s)
            else:
                self._latencies[self._pos] = duration_s
                self._pos = (self._pos + 1) % self._SAMPLE

    def p99_ms(self) -> Optional[float]:
        with self._lock:
            if not self._latencies:
                return None
            ordered = sorted(self._latencies)
        idx = min(len(ordered) - 1, int(0.99 * len(ordered)))
        return round(ordered[idx] * 1000.0, 3)

    def take_window(self) -> dict:
        """The since-last-publish counters (reset on read) plus the
        rolling p99 — the brain payload's ``q`` field."""
        with self._lock:
            requests, errors = self._requests, self._errors
            self._requests = self._errors = 0
            self.windows += 1
        out = {"n": requests, "err": errors}
        p99 = self.p99_ms()
        if p99 is not None:
            out["p99_ms"] = p99
        return out

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "window_requests": self._requests,
                "window_errors": self._errors,
                "samples": len(self._latencies),
            }
        out["p99_ms"] = self.p99_ms()
        return out


class SuspicionPolicy:
    """The verdict + quorum math. Pure functions over the collected
    brain map — recomputed per round, no internal state beyond
    config."""

    def __init__(
        self,
        enabled: bool = False,
        error_rate: float = 0.5,
        p99_factor: float = 3.0,
        min_requests: int = 8,
        peer_failures: int = 3,
        corruption_after: int = 1,
    ):
        self.enabled = enabled
        self.error_rate = error_rate
        self.p99_factor = p99_factor
        self.min_requests = max(1, int(min_requests))
        self.peer_failures = max(1, int(peer_failures))
        # integrity strikes (cluster/integrity.py) needed before a
        # corruption verdict — wrong bytes are deliberate harm, so
        # the default is a single strike
        self.corruption_after = max(1, int(corruption_after))

    @staticmethod
    def _quality(brain: dict) -> Optional[dict]:
        q = brain.get("q")
        return q if isinstance(q, dict) else None

    def _fleet_median_p99(self, fleet: Dict[str, dict]) -> Optional[float]:
        p99s = []
        for brain in fleet.values():
            q = self._quality(brain)
            if q is None:
                continue
            p99 = q.get("p99_ms")
            if isinstance(p99, (int, float)) and q.get(
                "n", 0
            ) >= self.min_requests:
                p99s.append(float(p99))
        if not p99s:
            return None
        p99s.sort()
        return p99s[len(p99s) // 2]

    def verdicts(
        self,
        fleet: Dict[str, dict],
        peer_failures: Dict[str, int],
        corruptions: Optional[Dict[str, int]] = None,
    ) -> List[str]:
        """This collector's BAD list: peers whose self-reported
        quality breaches the thresholds, against whom this replica's
        own peer client failed ``peer_failures``+ times this window,
        or whose transferred bodies failed their content-hash check
        ``corruption_after``+ times inside the integrity ledger's
        freshness window (cluster/integrity.py — the "wrong-but-200"
        clause status codes cannot see). Sorted for stable
        payloads."""
        if not self.enabled:
            return []
        corruptions = corruptions or {}
        bad = set()
        median = self._fleet_median_p99(fleet)
        # union, not fleet alone: the replica too sick to even
        # publish a brain (expired key, failing publishes, wedged
        # process) is precisely the one the peer-failure clause
        # exists for — judging only reporting peers would give the
        # silent ones a pass
        for url in set(fleet) | set(peer_failures) | set(corruptions):
            brain = fleet.get(url)
            q = self._quality(brain) if brain is not None else None
            if q is not None and q.get("n", 0) >= self.min_requests:
                n = max(1, int(q.get("n", 0)))
                if int(q.get("err", 0)) / n >= self.error_rate:
                    bad.add(url)
                p99 = q.get("p99_ms")
                if (
                    median is not None
                    and median > 0
                    and isinstance(p99, (int, float))
                    and float(p99) >= self.p99_factor * median
                ):
                    bad.add(url)
            if peer_failures.get(url, 0) >= self.peer_failures:
                bad.add(url)
            if corruptions.get(url, 0) >= self.corruption_after:
                bad.add(url)
        return sorted(bad)

    def demoted(
        self,
        fleet: Dict[str, dict],
        my_verdicts: List[str],
        members: tuple,
    ) -> List[str]:
        """The quorum: replicas a strict majority of reporters (each
        collected peer brain plus this replica's own verdict list)
        currently mark bad. Bounded so demotion can never empty the
        ring — at most ``len(members) - 1`` replicas demote, worst-
        voted first."""
        if not self.enabled:
            return []
        votes: Dict[str, int] = {}
        for brain in fleet.values():
            for url in brain.get("bad") or []:
                if isinstance(url, str):
                    votes[url] = votes.get(url, 0) + 1
        for url in my_verdicts:
            votes[url] = votes.get(url, 0) + 1
        reporters = len(fleet) + 1
        need = reporters // 2 + 1
        demoted = sorted(
            (url for url, n in votes.items() if n >= need),
            key=lambda u: (-votes[u], u),
        )
        cap = max(0, len(members) - 1)
        return demoted[:cap]

    def snapshot(self) -> dict:
        return {
            "enabled": self.enabled,
            "error_rate": self.error_rate,
            "p99_factor": self.p99_factor,
            "min_requests": self.min_requests,
            "peer_failures": self.peer_failures,
            "corruption_after": self.corruption_after,
        }
