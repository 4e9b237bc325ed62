"""The device's timeline from a ``torch.profiler`` Chrome trace: the
intervals in which a kernel, a copy or a memset ran on the card, their
union over the measured window, time by operation, and the idle gaps,
each labelled with what the server's host threads were doing in it."""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(s, e) for s, e in out]


class Trace:
    """Device operations of a trace clipped to the window ``[w0, w1]``
    (the trace's microseconds)."""

    def __init__(self, events: List[dict], w0: float, w1: float, samples=()):
        self.w0, self.w1 = w0, w1
        self.ops: List[Tuple[str, float, float]] = []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
                continue
            start, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
            start, end = max(start, w0), min(end, w1)
            if end > start:
                self.ops.append((e["name"], start, end))
        self.busy = union([(s, e) for _, s, e in self.ops])
        self.samples = sorted(samples)  # [(trace us, label)]

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def op_seconds(self, substring: str) -> float:
        """Summed time of the device operations whose name holds ``substring``."""
        return sum(e - s for n, s, e in self.ops if substring in n) / 1e6

    def top_ops(self, n: int = TOP) -> List[list]:
        total: Dict[str, float] = Counter()
        for name, s, e in self.ops:
            total[name] += (e - s) / 1e6
        return [[name, sec] for name, sec in total.most_common(n)]

    def gaps(self) -> List[Tuple[float, float]]:
        out, at = [], self.w0
        for s, e in self.busy:
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if self.w1 > at:
            out.append((at, self.w1))
        return out

    def label(self, start: float, end: float) -> str:
        """The host work sampled most often inside ``[start, end]``."""
        import bisect

        lo = bisect.bisect_left(self.samples, (start, ""))
        hi = bisect.bisect_right(self.samples, (end, "￿"))
        seen = Counter(label for _, label in self.samples[lo:hi])
        return seen.most_common(1)[0][0] if seen else "no host sample"

    def idle_gaps(self, n: int = TOP) -> List[list]:
        """The ``n`` longest gaps, longest first: [[label, seconds], ...]."""
        longest = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return [[self.label(s, e), (e - s) / 1e6] for s, e in longest]


def clock_offset(marks: Dict[str, list], events: List[dict]) -> Optional[float]:
    """Trace microseconds minus ``time.monotonic()`` microseconds, from the
    launcher's ``bench.open`` range (stamped on both clocks)."""
    for e in events:
        if e.get("ph") == "X" and e.get("name") == "bench.open":
            t0, t1 = marks["open"]
            return float(e["ts"]) - (t0 + t1) / 2 * 1e6
    return None
