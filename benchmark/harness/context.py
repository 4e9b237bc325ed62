"""What a per-layer metric reader (``metrics/<name>.py``, a function
``read(ctx)`` that returns a number or None) gets to read: the server's
``/healthz`` and ``/metrics`` just before and just after the measured
window, the device trace of the window, the requests sent in it, and
the table of peaks of the device it ran on."""

from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

_SAMPLE = re.compile(r"^([A-Za-z_:][A-Za-z0-9_:]*)(\{(.*)\})?\s+(\S+)")
_LABEL = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')
PEAKS = Path(__file__).resolve().parents[1] / "peaks.json"


def parse_prometheus(text: str) -> Dict[tuple, float]:
    """Prometheus text -> {(name, ((label, value), ...)): value}."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if not m:
            continue
        labels = tuple(sorted(_LABEL.findall(m.group(3) or "")))
        try:
            out[(m.group(1), labels)] = float(m.group(4))
        except ValueError:
            continue
    return out


def _get(view: dict, path: str):
    for key in path.split("."):
        if not isinstance(view, dict) or key not in view:
            return None
        view = view[key]
    return view


@dataclass
class Context:
    healthz_before: dict
    healthz_after: dict
    metrics_before: Dict[tuple, float]
    metrics_after: Dict[tuple, float]
    # the requests sent in the window: their specs, with "lane" (rows, row
    # bytes), "status", "bytes" (of the body), "latency_ms" (a failed one:
    # the longest wait) and "done_in_window"
    requests: List[dict]
    config: dict
    traffic: dict
    window_s: float = 0.0
    trace: Optional[object] = None  # harness.trace.Trace of the window
    device_kind: str = ""
    peaks: dict = field(default_factory=dict)

    def healthz_delta(self, path: str) -> Optional[float]:
        """After minus before of a number in ``/healthz`` (dotted path)."""
        a, b = _get(self.healthz_after, path), _get(self.healthz_before, path)
        if not isinstance(a, (int, float)):
            return None
        return a - (b if isinstance(b, (int, float)) else 0)

    def metric_delta(self, name: str, **labels) -> float:
        """After minus before of a ``/metrics`` sample, summed over the
        series whose labels include ``labels``."""
        want = set(labels.items())

        def total(samples):
            return sum(v for (n, ls), v in samples.items() if n == name and want <= set(ls))

        return total(self.metrics_after) - total(self.metrics_before)

    def peak(self, key: str) -> Optional[float]:
        """A published peak of this run's device (``peaks.json``)."""
        return self.peaks.get(self.device_kind, {}).get(key)


def percentile(values: List[float], q: float) -> Optional[float]:
    """The nearest-rank ``q`` quantile (0..1); None of an empty list."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def load_peaks() -> dict:
    with open(PEAKS) as f:
        return json.load(f)["devices"]
