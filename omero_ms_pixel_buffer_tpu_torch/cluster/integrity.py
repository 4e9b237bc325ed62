"""End-to-end byte integrity for every transfer path.

(Copy of ``omero_ms_pixel_buffer_tpu/cluster/integrity.py``.)

Every cached entry carries a strong content ETag — a blake2b digest
of the exact bytes (``cache.result_cache.make_etag``) — and every L2
frame and peer response transports it alongside the body. Until r20
nothing ever CHECKED it in motion: a replica serving bit-flipped
bytes (bad RAM, a corrupted disk spool, a tampered Redis value)
returned wrong-but-200 responses that flowed straight to clients and
were invisible to quality suspicion, which only watches status codes
and latency (the KNOWN_GAPS "wrong-but-200" item).

``body_matches`` is the single check: recompute the digest over the
received bytes and compare to the entry's declared ETag. Callers
wire it at every ingress of remote bytes — peer fetches, replication
pushes, handoff/warm-up/repair transfers, and L2 reads. A mismatch
is handled the same way everywhere: the bytes are DISCARDED (the
caller falls back to a local render; wrong bytes are never served,
never cached, never re-replicated), the ``cluster_integrity_fail_
total{source=...}`` counter ticks, and — when the bytes came from an
identifiable member — the ``CorruptionLedger`` notes a strike
against that member. The ledger feeds ``SuspicionPolicy.verdicts``
as a corruption verdict, so a replica that keeps emitting bad bytes
is demoted by the same strict-majority quorum that handles slow or
erroring replicas: integrity failures become a first-class health
signal instead of a silent client-facing defect.

Strikes age out (``ttl_s``) rather than reset-on-read: demotion
needs the verdict to persist across brain rounds while the evidence
is fresh, and to dissolve on its own once the member stops serving
bad bytes — the same self-healing posture as quality suspicion.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from ..cache.result_cache import make_etag
from ..utils.metrics import REGISTRY

INTEGRITY_FAILS = REGISTRY.counter(
    "cluster_integrity_fail_total",
    "Transferred bodies that failed their content-hash check, by source",
)

UNSIGNED_PAYLOADS = REGISTRY.counter(
    "cluster_unsigned_payloads_total",
    "Coordination values read from Redis that were unsigned or tampered",
)


def body_matches(etag: Optional[str], body: bytes) -> bool:
    """True iff ``body`` hashes to the strong content ``etag`` the
    entry declared. A missing ETag is a FAILED check — an entry we
    cannot verify is treated like one that verified wrong, so a
    stripped header cannot bypass the gate."""
    if not etag:
        return False
    return make_etag(body) == etag


class CorruptionLedger:
    """Per-member integrity strikes with a freshness window.

    ``note(member)`` records one bad body from ``member``;
    ``counts()`` returns the members whose strikes are still inside
    ``ttl_s``. Strikes are NOT consumed by reading — suspicion
    re-derives verdicts every brain round and the verdict must hold
    for the quorum to converge — they simply expire once the member
    stops producing them. Bounded in member count (oldest-expiring
    evicted first) and thread-safe: notes arrive from the serving
    loop while brains read from the coordination loop.
    """

    def __init__(
        self,
        ttl_s: float = 30.0,
        max_members: int = 128,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.ttl_s = float(ttl_s)
        self.max_members = int(max_members)
        self._clock = clock
        self._lock = threading.Lock()
        # member -> (count, last_noted)
        self._strikes: Dict[str, tuple] = {}
        self.total = 0

    def note(self, member: Optional[str]) -> None:
        if not member:
            return
        now = self._clock()
        with self._lock:
            self.total += 1
            count, _ = self._strikes.get(member, (0, now))
            self._strikes[member] = (count + 1, now)
            if len(self._strikes) > self.max_members:
                oldest = min(
                    self._strikes, key=lambda m: self._strikes[m][1]
                )
                del self._strikes[oldest]

    def counts(self) -> Dict[str, int]:
        """Live strike counts per member; expired members are pruned
        as a side effect."""
        now = self._clock()
        with self._lock:
            dead = [
                m for m, (_, at) in self._strikes.items()
                if now - at > self.ttl_s
            ]
            for m in dead:
                del self._strikes[m]
            return {m: c for m, (c, _) in self._strikes.items()}

    def snapshot(self) -> dict:
        members = self.counts()
        with self._lock:
            total = self.total
        return {"total": total, "members": members}
