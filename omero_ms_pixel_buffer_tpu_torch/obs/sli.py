"""SLO SLI layer: good/total counters and multi-window burn rates (copy of
``omero_ms_pixel_buffer_tpu/obs/sli.py``).

The scheduler (resilience/scheduler) *enforces* per-class treatment
under load; this module *measures* whether the treatment met the SLO:
every completed serving request counts as good or bad against the
interactive latency budget (``obs.slow-threshold-ms`` — the same
threshold the tail sampler keeps slow traces at, so a burn-rate spike
always has kept traces behind it), per priority class.

Burn rate is the standard SRE shape: the fraction of the error budget
being spent per unit time, with a fixed 99% objective —

    burn = bad_fraction / (1 - objective)

so burn 1.0 spends the budget exactly at the sustainable rate, 14x
means a 1h-window page, etc. Three windows (5m / 30m / 1h) from one
ring of coarse time buckets; gauges export as
``slo_burn_rate{priority,window}`` and /healthz carries the same
numbers next to the scheduler's shed/degrade counters.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Dict, Optional

from ..utils.metrics import REGISTRY

SLI_TOTAL = REGISTRY.counter(
    "slo_sli_requests_total",
    "Serving requests measured by the SLI layer, by class",
)
SLI_GOOD = REGISTRY.counter(
    "slo_sli_good_total",
    "Serving requests inside the latency budget (and not 5xx), "
    "by class",
)

_OBJECTIVE = 0.99  # fixed 99% objective; burn = bad_frac / 0.01
_BUCKET_S = 10.0  # time-bucket coarseness for the windows
WINDOWS = (("5m", 300.0), ("30m", 1800.0), ("1h", 3600.0))

# latest-instance registry for the process-wide burn-rate gauge (the
# tile_cache_bytes weak-ref precedent: tests boot several apps in one
# process; the gauge follows the most recent live SLI layer)
_ACTIVE: Optional["weakref.ref[SliLayer]"] = None
_gauge_registered = False
_gauge_lock = threading.Lock()


def _burn_gauge_values():
    ref = _ACTIVE
    sli = ref() if ref is not None else None
    if sli is None:
        return {}
    values = {}
    for window, rates in sli.burn_rates().items():
        for cls, rate in rates.items():
            values[(("priority", cls), ("window", window))] = rate
    return values


def _register_gauge() -> None:
    global _gauge_registered
    with _gauge_lock:
        if not _gauge_registered:
            REGISTRY.gauge_fn(
                "slo_burn_rate",
                "Error-budget burn rate (99% objective) by class and "
                "window",
                _burn_gauge_values,
            )
            _gauge_registered = True



def active_burn_rates() -> Optional[Dict[str, Dict[str, float]]]:
    """The live SLI layer's burn rates, or None when no layer exists
    (obs disabled). The cluster brain exchange reads this to ship burn
    rates fleet-wide, through the same latest-instance weak ref the
    process gauge follows."""
    ref = _ACTIVE
    sli = ref() if ref is not None else None
    return None if sli is None else sli.burn_rates()

class SliLayer:
    """Per-class good/total accounting over rolling time buckets."""

    def __init__(self, budget_s: float, clock=time.monotonic):
        self.budget_s = budget_s
        self._clock = clock
        # bucket ring: (bucket_index, {cls: [good, total]}); spans the
        # largest window plus one coarse bucket
        self._buckets: "deque[tuple]" = deque(
            maxlen=int(WINDOWS[-1][1] / _BUCKET_S) + 1
        )
        self._lock = threading.Lock()
        self.good = {"interactive": 0, "prefetch": 0, "bulk": 0}
        self.total = {"interactive": 0, "prefetch": 0, "bulk": 0}
        global _ACTIVE
        _ACTIVE = weakref.ref(self)
        _register_gauge()

    def record(
        self, priority: str, latency_s: float, error: bool = False
    ) -> None:
        """One completed serving request: good = served without a 5xx
        AND inside the latency budget — the SLI layer owns the budget
        test so no caller can apply a different one."""
        good = not error and latency_s < self.budget_s
        if priority not in self.total:
            priority = "interactive"
        SLI_TOTAL.inc(priority=priority)
        if good:
            SLI_GOOD.inc(priority=priority)
        idx = int(self._clock() / _BUCKET_S)
        with self._lock:
            self.total[priority] += 1
            if good:
                self.good[priority] += 1
            if not self._buckets or self._buckets[-1][0] != idx:
                self._buckets.append(
                    (idx, {c: [0, 0] for c in self.total})
                )
            cell = self._buckets[-1][1][priority]
            cell[1] += 1
            if good:
                cell[0] += 1

    def burn_rates(self) -> Dict[str, Dict[str, float]]:
        """{window: {class: burn}} over the rolling buckets. Classes
        with no traffic in a window report 0.0 (no data is not an
        incident)."""
        now_idx = int(self._clock() / _BUCKET_S)
        with self._lock:
            buckets = list(self._buckets)
        out: Dict[str, Dict[str, float]] = {}
        for name, span_s in WINDOWS:
            horizon = now_idx - int(span_s / _BUCKET_S)
            good = {c: 0 for c in self.total}
            total = {c: 0 for c in self.total}
            for idx, cells in buckets:
                if idx <= horizon:
                    continue
                for cls, (g, t) in cells.items():
                    good[cls] += g
                    total[cls] += t
            out[name] = {
                cls: (
                    round(
                        (1.0 - good[cls] / total[cls]) / (1.0 - _OBJECTIVE),
                        3,
                    )
                    if total[cls] else 0.0
                )
                for cls in total
            }
        return out

    def snapshot(self) -> dict:
        with self._lock:
            good = dict(self.good)
            total = dict(self.total)
        return {
            "budget_ms": round(self.budget_s * 1e3, 3),
            "objective": _OBJECTIVE,
            "good": good,
            "total": total,
            "burn_rates": self.burn_rates(),
        }
