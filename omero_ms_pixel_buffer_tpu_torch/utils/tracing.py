"""Tracing with the reference's span taxonomy (copy of
``omero_ms_pixel_buffer_tpu/utils/tracing.py``).

Replaces the Brave/Zipkin stack (PixelBufferMicroserviceVerticle.java:
169-200; omero-ms-core OmeroHttpTracingHandler/LogSpanReporter/
PrometheusSpanHandler): per-request root span tagged with the session
key, child spans naming every pipeline stage, trace context propagated
across the dispatch boundary inside the ctx JSON
(TileCtx/OmeroRequestCtx traceContext;
PixelBufferVerticle.java:101-104), finished spans feeding span-duration
metrics.

Span taxonomy kept verbatim from the reference so dashboards translate
1:1: ``handle_get_tile``, ``get_pixels``, ``get_pixel_buffer``,
``get_tile_direct``, ``create_metadata``, ``write_image``
(PixelBufferVerticle.java:101; TileRequestHandler.java:82,104-105,147,
180,203,226) — plus TPU-side additions ``batch_stage``,
``batch_device``, ``batch_encode``.

Resilience tags (resilience/, no reference analog):
``deadline.remaining_ms`` on ``handle_get_tile`` and ``tile_batch``
spans (the request budget as it crosses the dispatch boundary),
``http.status`` on failed front responses, and ``error`` carrying
``BreakerOpenError``/``DeadlineExceeded`` reprs when a dependency
breaker rejects or a budget expires mid-span.

Reporter model mirrors the reference's config gates: disabled -> noop
spans (zero per-request cost, no span metrics); enabled without sink
-> log reporter (LogSpanReporter analog). With tracing enabled, span
durations land in the ``span_duration_seconds`` histogram
(PrometheusSpanHandler analog). The flight recorder (obs/recorder)
owns ALWAYS-ON stage attribution, so disabling tracing does not blind
stage-latency metrics, and, with ``tail=True`` in
``configure``, materializes tail-sampled records into retroactive
spans through the (breaker-guarded, bounded) reporter below.
"""

from __future__ import annotations

import contextvars
import logging
import threading
import time
import uuid
from typing import Optional

from .metrics import REGISTRY

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.tracing")

SPAN_SECONDS = REGISTRY.histogram(
    "span_duration_seconds", "Duration of tracing spans by name"
)
SPANS_DROPPED = REGISTRY.counter(
    "tracing_spans_dropped_total",
    "Spans dropped by the Zipkin reporter (full queue, dead sink, "
    "open breaker), by reason",
)

_current_span: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "current_span", default=None
)


class Span:
    __slots__ = ("tracer", "name", "trace_id", "span_id", "parent_id",
                 "tags", "t0", "ts", "duration", "_token")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: Optional[str]):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = uuid.uuid4().hex[:16]
        self.parent_id = parent_id
        self.tags: dict = {}
        self.t0 = time.perf_counter()
        self.ts = time.time()  # epoch start, for exporters
        self.duration: Optional[float] = None
        self._token = None

    def tag(self, key: str, value) -> "Span":
        self.tags[key] = value
        return self

    def error(self, exc: BaseException) -> "Span":
        self.tags["error"] = repr(exc)
        return self

    def finish(self) -> None:
        self.duration = time.perf_counter() - self.t0
        self.tracer._report(self)

    # context-manager / scoped-span usage
    def __enter__(self) -> "Span":
        self._token = _current_span.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.error(exc)
        if self._token is not None:
            _current_span.reset(self._token)
        self.finish()


class ZipkinReporter:
    """AsyncReporter/OkHttpSender analog
    (PixelBufferMicroserviceVerticle.java:180-184): finished spans are
    queued and a background thread POSTs them to the Zipkin v2 JSON
    endpoint in batches. The queue is bounded; under backpressure spans
    are dropped (``tracing_spans_dropped_total``), never blocking the
    serving path. The sink is a network dependency like any other: the
    POST runs behind a ``tracing:zipkin`` breaker with a per-call
    timeout and the ``tracing.zipkin`` fault point — a dead or hung
    Zipkin costs dropped spans only, never a request (chaos-pinned)."""

    def __init__(self, url: str, service_name: str,
                 batch_size: int = 100, flush_interval_s: float = 1.0,
                 max_queue: int = 10_000, post_timeout_s: float = 5.0):
        import queue

        self.url = url
        self.service_name = service_name
        self.batch_size = batch_size
        self.flush_interval_s = flush_interval_s
        self.post_timeout_s = post_timeout_s
        self.dropped = 0
        self._queue: "queue.Queue[Optional[dict]]" = queue.Queue(max_queue)
        self._closed = False
        # lazy import: tracing is imported by low-level modules that
        # the resilience package itself depends on
        from ..resilience.breaker import for_dependency

        self._breaker = for_dependency("tracing:zipkin")
        self._thread = threading.Thread(
            target=self._run, name="zipkin-reporter", daemon=True
        )
        self._thread.start()

    def _drop(self, n: int, reason: str) -> None:
        self.dropped += n
        SPANS_DROPPED.inc(n, reason=reason)

    def report(self, span: "Span") -> None:
        if self._closed:
            return
        doc = {
            "traceId": span.trace_id,
            "id": span.span_id,
            "name": span.name,
            "timestamp": int(span.ts * 1e6),
            "duration": max(1, int((span.duration or 0.0) * 1e6)),
            "localEndpoint": {"serviceName": self.service_name},
            "tags": {k: str(v) for k, v in span.tags.items()},
        }
        if span.parent_id:
            doc["parentId"] = span.parent_id
        try:
            self._queue.put_nowait(doc)
        except Exception:
            self._drop(1, "queue_full")

    def _post(self, batch: list) -> None:
        import json
        import time as _time
        import urllib.request

        from ..resilience.breaker import BreakerOpenError
        from ..resilience.faultinject import INJECTOR

        try:
            self._breaker.allow()
        except BreakerOpenError:
            # sink known-dead: drop without burning a connect timeout
            # per batch (the breaker half-opens on its own schedule)
            self._drop(len(batch), "breaker_open")
            return
        req = urllib.request.Request(
            self.url, data=json.dumps(batch).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        t0 = _time.monotonic()
        try:
            INJECTOR.fire("tracing.zipkin")  # reporter thread, never a loop
            # deliberately single-attempt: spans are droppable telemetry,
            # and a retry would hold the bounded queue's drain hostage to
            # a sink that just proved slow
            urllib.request.urlopen(req, timeout=self.post_timeout_s).close()
        except Exception as e:  # sink down: drop batch, keep going
            self._breaker.record_failure()
            self._drop(len(batch), "post_failed")
            log.debug("zipkin export failed: %s", e)
        else:
            self._breaker.record_success(
                duration_s=_time.monotonic() - t0
            )

    def _run(self) -> None:
        import queue

        pending: list = []
        last_flush = time.monotonic()
        while True:
            try:
                item = self._queue.get(timeout=self.flush_interval_s)
                if item is None:  # close sentinel
                    break
                pending.append(item)
            except queue.Empty:
                pass
            # accumulate: POST on a full batch or a due interval, not
            # per span (the AsyncReporter batching contract)
            if pending and (
                len(pending) >= self.batch_size
                or time.monotonic() - last_flush >= self.flush_interval_s
            ):
                batch, pending = pending, []
                self._post(batch)
                last_flush = time.monotonic()
        if pending:  # final flush on close
            self._post(pending)

    def close(self) -> None:
        """stop() analog: flush and stop the sender
        (PixelBufferMicroserviceVerticle.java:298-308)."""
        if self._closed:
            return
        self._closed = True
        # a full queue must not swallow the shutdown sentinel: make
        # room by dropping the oldest spans
        for _ in range(8):
            try:
                self._queue.put_nowait(None)
                break
            except Exception:
                try:
                    self._queue.get_nowait()
                    self._drop(1, "shutdown")
                except Exception:
                    break
        self._thread.join(timeout=10)


class Tracer:
    """ALWAYS_SAMPLE tracer (reference: Tracing.newBuilder()...
    .sampler(ALWAYS_SAMPLE), PixelBufferMicroserviceVerticle.java:185-190)."""

    def __init__(self, enabled: bool = True, log_spans: bool = False,
                 service_name: str = "omero-ms-pixel-buffer-tpu"):
        self.enabled = enabled
        self.log_spans = log_spans
        self.service_name = service_name
        self.reporter: Optional[ZipkinReporter] = None
        self._lock = threading.Lock()

    def start_span(self, name: str, parent: Optional[Span] = None) -> Span:
        if not self.enabled:
            return _NOOP_SPAN  # disabled -> noop tracing (:196-198)
        if parent is None:
            parent = _current_span.get()
        if parent is not None:
            return Span(self, name, parent.trace_id, parent.span_id)
        return Span(self, name, uuid.uuid4().hex, None)

    def start_span_with_context(self, name: str, ctx: dict) -> Span:
        """Join a trace propagated across the dispatch boundary
        (extractor().extract(traceContext) analog,
        PixelBufferVerticle.java:101-104)."""
        if not self.enabled:
            return _NOOP_SPAN
        trace_id = ctx.get("traceId") or uuid.uuid4().hex
        span = Span(self, name, trace_id, ctx.get("spanId"))
        return span

    def _report(self, span: Span) -> None:
        if not self.enabled:
            return
        SPAN_SECONDS.observe(span.duration or 0.0, name=span.name)
        if self.reporter is not None:
            self.reporter.report(span)
        if self.log_spans:
            log.info(
                "span %s trace=%s id=%s parent=%s %.3fms tags=%s",
                span.name, span.trace_id, span.span_id, span.parent_id,
                (span.duration or 0) * 1e3, span.tags,
            )


class _NoopSpan:
    """Shared do-nothing span for disabled tracing: same surface as
    Span, zero per-request allocation."""

    __slots__ = ()
    trace_id = None
    span_id = None
    parent_id = None
    tags: dict = {}
    duration = None

    def tag(self, key, value):
        return self

    def error(self, exc):
        return self

    def finish(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass


_NOOP_SPAN = _NoopSpan()


# process default (reference: Tracing.currentTracer())
TRACER = Tracer()


def configure(
    enabled: bool, log_spans: bool, zipkin_url: Optional[str] = None,
    tail: bool = False,
) -> None:
    """Reference reporter selection (:169-200): zipkin-url -> HTTP
    sender; enabled without URL -> log reporter; disabled -> noop
    spans (no live per-request span objects — the reference's
    :196-198). ``tail=True`` (the flight recorder's mode) builds the
    reporter even with live tracing off: the recorder materializes
    KEPT records into retroactive spans through it, so the sink sees
    only the tail-sampled traffic instead of every request."""
    TRACER.enabled = enabled
    TRACER.log_spans = log_spans and zipkin_url is None
    if TRACER.reporter is not None:
        TRACER.reporter.close()
        TRACER.reporter = None
    if (enabled or tail) and zipkin_url:
        TRACER.reporter = ZipkinReporter(zipkin_url, TRACER.service_name)
