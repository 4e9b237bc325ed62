"""Prometheus metrics: a self-contained registry and its text exposition
(copy of ``omero_ms_pixel_buffer_tpu/utils/metrics.py``).

Two exposition dialects from one registry (``exposition(openmetrics=)``;
``GET /metrics`` negotiates on ``Accept``):

- classic Prometheus text;
- OpenMetrics 1.0: counter families drop the ``_total`` suffix in their
  metadata lines (samples keep it), ``le`` labels are canonical floats,
  the body ends with ``# EOF``, and histogram ``_bucket`` samples may
  carry exemplars: ``... # {trace_id="..."} value ts``.

Exemplars pivot a metric to a trace: ``observe(v, exemplar=<trace id>)``
keeps the last exemplar per (labelset, bucket). They never appear in the
classic dialect.

One deliberate difference from the JAX package: a ``Histogram`` whose
buckets lack ``+Inf`` gets it appended, so an observation above the last
finite edge is counted in ``+Inf`` (the JAX histogram indexes past its
count list there: ``io_requests_per_tile`` ends at 32.0).
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict
from typing import Dict, Iterable, Optional, Tuple

_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0, float("inf"),
)


def _fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


def _om_family(name: str, kind: str) -> str:
    """OpenMetrics family name: counter metadata drops the ``_total``
    sample suffix (the spec's naming contract — samples keep it)."""
    if kind == "counter" and name.endswith("_total"):
        return name[: -len("_total")]
    return name


class Counter:
    kind = "counter"

    def __init__(self, name: str, help_: str):
        self.name, self.help = name, help_
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = defaultdict(float)
        self._lock = threading.Lock()

    def inc(self, value: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] += value

    def samples(self) -> Dict[Tuple[Tuple[str, str], ...], float]:
        """{sorted label pairs: value}, a copy (``/healthz`` views read
        their counts here)."""
        with self._lock:
            return dict(self._values)

    def collect(self, openmetrics: bool = False) -> Iterable[str]:
        family = (
            _om_family(self.name, self.kind) if openmetrics else self.name
        )
        yield f"# HELP {family} {self.help}"
        yield f"# TYPE {family} {self.kind}"
        with self._lock:
            items = list(self._values.items()) or [((), 0.0)]
        for labels, v in items:
            yield f"{self.name}{_fmt_labels(labels)} {v}"


class Gauge(Counter):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = value


class Histogram:
    def __init__(self, name: str, help_: str, buckets=_BUCKETS):
        self.name, self.help = name, help_
        buckets = tuple(buckets)
        if not buckets or buckets[-1] != float("inf"):
            buckets += (float("inf"),)  # the +Inf bucket counts the overflow
        self.buckets = buckets
        # per-bucket (NON-cumulative) counts, accumulated into the
        # Prometheus cumulative form at collect time — observe is one
        # bisect + one increment instead of a walk over every bucket
        # (the flight recorder observes several histograms per request)
        self._counts: Dict[Tuple[Tuple[str, str], ...], list] = {}
        self._sums: Dict[Tuple[Tuple[str, str], ...], float] = defaultdict(float)
        # (labelset, bucket index) -> (trace_id, value, epoch ts);
        # last writer wins, so memory is bounded by labelsets x buckets
        self._exemplars: Dict[Tuple[Tuple[Tuple[str, str], ...], int], tuple] = {}
        self._lock = threading.Lock()

    def observe(
        self, value: float, exemplar: Optional[str] = None, **labels
    ) -> None:
        key = tuple(sorted(labels.items()))
        # bisect_left(value) is the smallest bucket with value <= le
        # (ties land on the exact bucket); +Inf is always last
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * len(self.buckets)
            counts[i] += 1
            self._sums[key] += value
            if exemplar is not None:
                # the exemplar belongs to the bucket that "contains"
                # the observation
                self._exemplars[(key, i)] = (
                    exemplar, value, time.time()
                )

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Upper-bound estimate of the ``q`` quantile for one
        labelset: the smallest bucket upper edge at which the
        cumulative count reaches ``q x total``. None before any
        observation. An answer in the +Inf bucket resolves to the
        largest finite edge — the histogram cannot see past its
        buckets, and callers clamp anyway.
        Coarse by construction (bucket resolution), cheap by
        construction (one pass over ~14 buckets)."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                return None
            counts = list(counts)
        total = sum(counts)
        if total <= 0:
            return None
        target = q * total
        cum = 0
        for edge, count in zip(self.buckets, counts):
            cum += count
            if cum >= target and edge != float("inf"):
                return float(edge)
        finite = [b for b in self.buckets if b != float("inf")]
        return float(finite[-1]) if finite else None

    def attach_exemplar(
        self, value: float, exemplar: str, **labels
    ) -> None:
        """Annotate the bucket ``value`` landed in WITHOUT observing —
        for deferred exemplars (obs/recorder): the observation was
        recorded mid-request, the trace id only becomes citable once
        the tail sampler keeps the trace at completion."""
        key = tuple(sorted(labels.items()))
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            if key in self._counts:  # annotate only observed series
                self._exemplars[(key, i)] = (
                    exemplar, value, time.time()
                )

    def time(self, **labels):
        return _Timer(self, labels)

    def collect(self, openmetrics: bool = False) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} histogram"
        with self._lock:
            items = [(k, list(v)) for k, v in self._counts.items()]
            sums = dict(self._sums)
            exemplars = dict(self._exemplars) if openmetrics else {}
        for labels, counts in items:
            running = 0
            for i, (b, c) in enumerate(zip(self.buckets, counts)):
                running += c
                if openmetrics:
                    # OpenMetrics wants canonical float le values
                    le = "+Inf" if b == float("inf") else repr(float(b))
                else:
                    le = "+Inf" if b == float("inf") else repr(b)
                lab = labels + (("le", le),)
                line = f"{self.name}_bucket{_fmt_labels(lab)} {running}"
                ex = exemplars.get((labels, i))
                if ex is not None:
                    tid, v, ts = ex
                    line += (
                        f' # {{trace_id="{tid}"}} {v} {round(ts, 3)}'
                    )
                yield line
            yield f"{self.name}_count{_fmt_labels(labels)} {running}"
            yield f"{self.name}_sum{_fmt_labels(labels)} {sums[labels]}"


class GaugeFn:
    """Callback gauge: the value is computed at scrape time, so
    structures that mutate on the hot path (caches, queues) export
    exact state without paying a metric update per operation. ``fn``
    returns either a float or a dict mapping label tuples
    (``(("tier", "memory"),): value``) to floats; a failing callback
    skips the sample rather than breaking the whole exposition."""

    def __init__(self, name: str, help_: str, fn):
        self.name, self.help, self.fn = name, help_, fn

    def collect(self, openmetrics: bool = False) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} gauge"
        try:
            values = self.fn()
        except Exception:
            return
        if not isinstance(values, dict):
            values = {(): values}
        for labels, v in sorted(values.items()):
            yield f"{self.name}{_fmt_labels(tuple(labels))} {float(v)}"


class _Timer:
    def __init__(self, hist: Histogram, labels: dict):
        self.hist, self.labels = hist, labels

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.perf_counter() - self.t0, **self.labels)


class Registry:
    def __init__(self):
        self._metrics: list = []
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._register(Counter(name, help_))

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._register(Gauge(name, help_))

    def histogram(self, name: str, help_: str = "", **kw) -> Histogram:
        return self._register(Histogram(name, help_, **kw))

    def gauge_fn(self, name: str, help_: str, fn) -> GaugeFn:
        return self._register(GaugeFn(name, help_, fn))

    def register(self, collector):
        """Register any collector exposing ``collect() -> iterable of
        exposition lines`` (custom collectors, e.g. process metrics)."""
        return self._register(collector)

    def _register(self, metric):
        with self._lock:
            self._metrics.append(metric)
        return metric

    def exposition(self, openmetrics: bool = False) -> str:
        """The GET /metrics body: classic Prometheus text by default,
        OpenMetrics 1.0 (counter-family naming, float ``le``, bucket
        exemplars, ``# EOF`` terminator) when negotiated."""
        lines = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            if openmetrics:
                try:
                    lines.extend(m.collect(openmetrics=True))
                except TypeError:
                    # external collectors predating the dialect split
                    # (process metrics): exemplar-free lines are valid
                    # in both formats
                    lines.extend(m.collect())
            else:
                lines.extend(m.collect())
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"


# the process-wide registry
REGISTRY = Registry()
