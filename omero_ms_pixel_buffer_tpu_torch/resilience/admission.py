"""The executing-slot counter (copy of ``omero_ms_pixel_buffer_tpu/
resilience/admission.py``): at most ``max_inflight`` requests execute at
once. Under the SLO scheduler a full counter means "wait in the queue",
not a shed; the scheduler counts its own sheds through ``count_shed`` so
that ``shed_total`` (and ``resilience_shed_total``) stays the one number.
``has_headroom`` gates the prefetcher's speculative work; ``try_acquire``
is the binary door gate of a front without the scheduler."""

from __future__ import annotations

import threading

from ..utils.metrics import REGISTRY

SHED = REGISTRY.counter(
    "resilience_shed_total",
    "Requests shed (503) by admission control",
)
INFLIGHT = REGISTRY.gauge(
    "resilience_inflight_requests",
    "Tile requests currently admitted and in flight",
)

# the JAX package's resilience.admission defaults
MAX_INFLIGHT = 256
RETRY_AFTER_S = 1.0


class AdmissionController:
    """Bounded in-flight gate; nothing here blocks."""

    def __init__(self, max_inflight: int = MAX_INFLIGHT, retry_after_s: float = RETRY_AFTER_S):
        self.max_inflight = max_inflight
        self.retry_after_s = retry_after_s
        self._inflight = 0
        self._shed = 0
        self._lock = threading.Lock()

    def try_acquire(self) -> bool:
        """Take a slot, or count a shed: the binary door gate's test
        (``slo.enabled: false``)."""
        if self.try_slot():
            return True
        self.count_shed()
        return False

    def try_slot(self) -> bool:
        """Take a slot if one is free (the scheduler's probe; a full gate
        is not a shed)."""
        with self._lock:
            if self._inflight >= self.max_inflight:
                return False
            self._inflight += 1
            INFLIGHT.set(self._inflight)
            return True

    def count_shed(self) -> None:
        with self._lock:
            self._shed += 1
            SHED.inc()

    def release(self) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            INFLIGHT.set(self._inflight)

    def has_headroom(self, fraction: float = 0.5) -> bool:
        """Whether real traffic uses less than ``fraction`` of the in-flight
        bound: the gate of the prefetcher, whose speculative work sheds
        long before a real request would."""
        with self._lock:
            return self._inflight < max(1, int(self.max_inflight * fraction))

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    @property
    def shed_total(self) -> int:
        with self._lock:
            return self._shed

    def snapshot(self) -> dict:
        with self._lock:
            return {"inflight": self._inflight, "max_inflight": self.max_inflight,
                    "shed_total": self._shed}
