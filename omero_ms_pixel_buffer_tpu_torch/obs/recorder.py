"""Flight recorder: always-on per-request stage attribution (copy of
``omero_ms_pixel_buffer_tpu/obs/recorder.py``).

A fixed-slot record of monotonic stamps rides every serving request from
the HTTP door (``FlightRecord``), stamped at each stage it crosses (two
``perf_counter()`` reads and a float add per stage). At completion a
tail-based sampler decides keep or drop:

    kept always   -- HTTP 5xx (scheduler sheds and deadline 504s too),
                    degraded serves, anything slower than
                    ``slow-threshold-ms``, any lane that tripped a fault
                    point
    kept sampled  -- everything else at ``head-sample-rate``, decided
                    from the trace id (crc32), so the decision is the
                    same in every process that sees the trace

A kept record becomes one JSON wide event in a bounded ring served at
``/debug/requests``, and retroactive Zipkin spans (one ``http:<path>``
root and one ``stage:<name>`` child per touched stage) through
``utils/tracing.py``'s reporter when one is configured and live tracing
is off. Stage durations feed ``request_stage_seconds`` for every record,
kept or not, and the time no stage claimed feeds
``request_unclaimed_seconds``. A lane that passed the batcher also
carries ``ready_at``, the moment its answer existed on a worker thread;
the batcher observes the wait from there to the serving coroutine's
resumption as ``request_handoff_seconds``.

Profiler ranges: while a ``torch.profiler`` runs anywhere in the process
(torch's process-wide flag), every stage timer also enters
``record_function("ompb.<stage>@<trace id>")`` (``profiler_range``), so
a capture of the server lays the stages, the encode queue's laps and
waits and the device programs on the profiler's clock, sharing the
request's trace id; with no profiler the check costs one attribute read.
A profiler started with default settings records the ranges of its own
thread only; one started with ``profile_all_threads`` records every
thread's.

Threading: a record is stamped by one thread at a time (the serving loop,
the batch executor, the encode queue's threads), completed once; the ring
has its own lock.
"""

from __future__ import annotations

import contextlib
import contextvars
import random
import threading
import time
import zlib
from collections import deque
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _torch_profiler

from ..utils.metrics import REGISTRY

# Fixed stage slots, one float pair each (first-start offset, summed
# duration). Order is presentation order in the wide event; adding a
# stage means adding a slot here — records never grow per request.
STAGES = (
    "door",        # pre-auth overload-gate decision
    "auth",        # sessionid cookie -> OMERO session key lookup
    "cache_probe", # local RAM/disk result-cache probe + hit re-auth
    "l2",          # shared Redis L2 consult (cache plane)
    "peer",        # bounded owner peer-fetch hop (cache plane)
    "queue_wait",  # SLO scheduler queue wait before the grant
    "batch_wait",  # dispatch enqueue -> batch execution start
    "resolve",     # metadata resolve + pixel-buffer open
    "read",        # read-plane fetch + decode (incl. degraded reads)
    "render",      # render/analysis lane compute (device or host)
    "device",      # device encode queue: submit -> group resolution
    "encode",      # host encode + container framing
    "frame",       # HTTP response assembly
    "ingest",      # ingest plane: shard assembly + store commit
)
_STAGE_INDEX = {name: i for i, name in enumerate(STAGES)}
_N = len(STAGES)

REQUEST_STAGE_SECONDS = REGISTRY.histogram(
    "request_stage_seconds",
    "Per-request serving-stage durations from the flight recorder "
    "(always on, independent of http-tracing.enabled)",
)
HTTP_REQUEST_SECONDS = REGISTRY.histogram(
    "http_request_seconds",
    "End-to-end request latency at the HTTP door, by outcome",
)
REQUEST_UNCLAIMED_SECONDS = REGISTRY.histogram(
    "request_unclaimed_seconds",
    "Per-request wall time no flight-recorder stage claimed (total minus "
    "the stage sums, floored at 0), every record",
)
REQUEST_HANDOFF_SECONDS = REGISTRY.histogram(
    "request_handoff_seconds",
    "Time from a batched lane's answer existing on a worker thread to the "
    "serving coroutine resuming with it",
)
RECORDS_KEPT = REGISTRY.counter(
    "obs_records_kept_total",
    "Flight records kept by the tail sampler, by reason",
)
RECORDS_DROPPED = REGISTRY.counter(
    "obs_records_dropped_total",
    "Flight records dropped by the tail sampler (healthy + fast + "
    "not head-sampled)",
)

# Ambient record: set by the HTTP front for the request's task,
# carried into the batch executor via the batcher's copy_context(),
# and re-scoped onto the device queue's worker threads per group
# (record_scope in device_dispatch._run_stage / _tid_bound).
_current_record: contextvars.ContextVar[Optional["FlightRecord"]] = (
    contextvars.ContextVar("obs_record", default=None)
)


def current_record() -> Optional["FlightRecord"]:
    return _current_record.get()


@contextlib.contextmanager
def record_scope(rec: Optional["FlightRecord"]):
    """Make ``rec`` the ambient record (the batcher enters this before
    ``copy_context()`` so pipeline-depth exemplars and fault-point
    attribution reach the executor thread)."""
    token = _current_record.set(rec)
    try:
        yield rec
    finally:
        _current_record.reset(token)


def _new_trace_id() -> str:
    # uuid4 costs ~2 us per call; getrandbits is ~4x cheaper and trace
    # ids only need uniqueness, not unpredictability
    return f"{random.getrandbits(128):032x}"


def _new_span_id() -> str:
    return f"{random.getrandbits(64):016x}"


class FlightRecord:
    """One request's fixed-slot stamp record. Created at the door,
    stamped by whichever layer touches the request, completed exactly
    once by the recorder."""

    __slots__ = (
        "trace_id", "span_id", "parent_span_id", "path", "method",
        "t0", "ts", "starts", "durs", "tags", "faults", "status",
        "outcome", "total", "kept", "keep_reason", "enqueued_at",
        "ready_at", "peer_origin", "pending_exemplars", "_completed",
    )

    def __init__(
        self, path: str, method: str = "GET",
        trace_id: Optional[str] = None,
        parent_span_id: Optional[str] = None,
    ):
        self.trace_id = trace_id or _new_trace_id()
        self.span_id = _new_span_id()
        self.parent_span_id = parent_span_id
        self.path = path
        self.method = method
        self.t0 = time.perf_counter()
        self.ts = time.time()  # epoch anchor for exporters
        self.starts: List[float] = [-1.0] * _N
        self.durs: List[float] = [0.0] * _N
        self.tags: Dict[str, object] = {}
        self.faults: List[str] = []
        self.status: Optional[int] = None
        self.outcome: Optional[str] = None
        self.total: Optional[float] = None
        self.kept = False
        self.keep_reason: Optional[str] = None
        self.enqueued_at: Optional[float] = None
        # when the lane's answer existed on a worker thread (the batcher)
        self.ready_at: Optional[float] = None
        self.peer_origin: Optional[str] = None
        # deferred metric exemplars: (histogram, value, labels) noted
        # mid-request, installed at completion ONLY if kept — every
        # exposed exemplar must name a trace /debug can answer
        self.pending_exemplars: List[tuple] = []
        self._completed = False

    # -- stamping -------------------------------------------------------

    def stamp(
        self, stage: str, duration: float,
        start_offset: Optional[float] = None,
    ) -> None:
        """Add ``duration`` seconds to one stage slot. Re-stamping the
        same slot accumulates (a batched read touches ``read`` once per
        group); the first stamp pins the slot's start offset for span
        reconstruction."""
        i = _STAGE_INDEX[stage]
        if self.starts[i] < 0.0:
            self.starts[i] = (
                start_offset if start_offset is not None
                else time.perf_counter() - self.t0 - duration
            )
        self.durs[i] += duration

    def stage(self, stage: str) -> "_StageTimer":
        return _StageTimer(self, stage)

    def tag(self, key: str, value) -> "FlightRecord":
        # bounded: callers pass a fixed tag vocabulary, and a record lives
        # as long as its ring slot
        self.tags[key] = value
        return self

    def note_fault(self, point: str) -> None:
        """A fault point fired for this request (chaos/injection):
        recorded so a kept trace explains WHY the request was slow or
        failed."""
        if len(self.faults) < 16:  # bounded; chaos loops can fire a lot
            self.faults.append(point)

    # -- materialization ------------------------------------------------

    def touched(self) -> List[Tuple[str, float, float]]:
        """(stage, start_offset_s, duration_s) for every stamped slot,
        in pipeline order."""
        return [
            (STAGES[i], self.starts[i], self.durs[i])
            for i in range(_N)
            if self.durs[i] > 0.0 or self.starts[i] >= 0.0
        ]

    def wide_event(self) -> dict:
        """The canonical JSON wide event — one object holding the
        whole request's story (the /debug/requests payload)."""
        stages = {
            name: round(dur * 1e3, 3)
            for name, _, dur in self.touched()
        }
        attributed = sum(self.durs)
        total = self.total if self.total is not None else 0.0
        event = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "ts": round(self.ts, 6),
            "method": self.method,
            "path": self.path,
            "status": self.status,
            "outcome": self.outcome,
            "total_ms": round(total * 1e3, 3),
            "stages_ms": stages,
            # wall time no stage claimed: scheduling gaps, loop lag,
            # coalesced-follower waits — kept explicit so stage sums
            # are honest instead of silently re-normalized
            "unattributed_ms": round(max(0.0, total - attributed) * 1e3, 3),
            "kept_reason": self.keep_reason,
            "tags": dict(self.tags),
        }
        if self.faults:
            event["faults"] = list(self.faults)
        if self.parent_span_id:
            event["parent_span_id"] = self.parent_span_id
        if self.peer_origin:
            event["peer_origin"] = self.peer_origin
        return event


class _StageTimer:
    """Slots-based stage timer (a generator contextmanager costs ~3x
    as much, and the hot path enters several of these per request),
    with its profiler range while a profiler runs."""

    __slots__ = ("rec", "stage_name", "t0", "range")

    def __init__(self, rec: "FlightRecord", stage_name: str):
        self.rec = rec
        self.stage_name = stage_name

    def __enter__(self) -> "FlightRecord":
        self.range = None
        if _torch_profiler._is_profiler_enabled:
            self.range = profiler_range(self.stage_name, self.rec)
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self.rec

    def __exit__(self, *exc) -> None:
        self.rec.stamp(
            self.stage_name, time.perf_counter() - self.t0
        )
        if self.range is not None:
            self.range.__exit__(*exc)


_NO_RANGE = contextlib.nullcontext()


def _range_name(name: str, rec: Optional["FlightRecord"]) -> str:
    return f"ompb.{name}" if rec is None else f"ompb.{name}@{rec.trace_id}"


def profiler_range(name: str, rec: Optional["FlightRecord"] = None):
    """``torch.profiler.record_function("ompb.<name>@<trace id>")`` (no
    ``@`` part without a record) while a profiler runs in the process,
    else a shared no-op: the range lands on the profiler's clock, over
    the kernels it enqueues. The trace id is in the name because the
    profiler's Chrome export drops a range's ``args``."""
    if not _torch_profiler._is_profiler_enabled:
        return _NO_RANGE
    return torch.profiler.record_function(_range_name(name, rec))


def open_range(name: str, rec: Optional["FlightRecord"] = None):
    """A profiler range opened on this thread and closed, from any
    thread, by ``close_range`` of the returned handle (a wait that
    crosses threads); None with no profiler."""
    if not _torch_profiler._is_profiler_enabled:
        return None
    rf = torch.profiler.record_function(_range_name(name, rec))
    rf.__enter__()
    done = torch.futures.Future()
    rf._call_end_callbacks_on_future(done)
    return done


def close_range(handle) -> None:
    if handle is not None and not handle.done():
        handle.set_result(None)


class _RetroSpan:
    """Duck-typed span for retroactive export: carries exactly the
    attributes ``ZipkinReporter.report`` reads off a live Span."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "ts",
                 "duration", "tags")

    def __init__(self, trace_id, span_id, parent_id, name, ts,
                 duration, tags):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.ts = ts
        self.duration = duration
        self.tags = tags


class FlightRecorder:
    """Per-app recorder: mints records at the door, completes them
    with the tail-sampling decision, owns the bounded wide-event ring.
    One instance per ``TileServer`` (tests run several in one
    process); the metric families are process-wide."""

    def __init__(
        self,
        enabled: bool = True,
        slow_threshold_s: float = 0.3,
        head_sample_rate: float = 0.01,
        ring_size: int = 512,
        sli=None,
    ):
        self.enabled = enabled
        self.slow_threshold_s = slow_threshold_s
        self.head_sample_rate = head_sample_rate
        self.ring_size = max(1, int(ring_size))
        self.sli = sli
        self._ring: "deque[dict]" = deque(maxlen=self.ring_size)
        self._lock = threading.Lock()
        self._started = 0
        self._kept = 0
        self._dropped = 0

    # -- lifecycle ------------------------------------------------------

    def start(
        self, path: str, method: str = "GET",
        trace_id: Optional[str] = None,
        parent_span_id: Optional[str] = None,
    ) -> Optional[FlightRecord]:
        if not self.enabled:
            return None
        with self._lock:
            self._started += 1
        return FlightRecord(
            path, method, trace_id=trace_id,
            parent_span_id=parent_span_id,
        )

    def _keep_reason(self, rec: FlightRecord) -> Optional[str]:
        status = rec.status or 0
        if status >= 500:
            return "error"
        if rec.tags.get("degraded"):
            return "degraded"
        if rec.total is not None and rec.total >= self.slow_threshold_s:
            return "slow"
        if rec.faults:
            return "fault"
        if self.head_sample_rate >= 1.0:
            return "head"
        if self.head_sample_rate <= 0.0:
            return None
        # deterministic head sampling keyed on the trace id: every
        # process a trace touched makes the SAME decision. crc32, not
        # int(hex): total for ANY string, so an adopted foreign id
        # can never throw inside the completion path
        if (
            (zlib.crc32(rec.trace_id.encode()) & 0xFFFFFFFF)
            / float(1 << 32)
            < self.head_sample_rate
        ):
            return "head"
        return None

    def complete(self, rec: Optional[FlightRecord], status: int) -> bool:
        """Finish a record: stamp the total, feed the always-on stage
        histograms and the SLI layer, run the tail-sampling decision,
        and (when kept) append the wide event to the ring and emit
        retroactive spans. Returns whether the record was kept."""
        if rec is None or rec._completed:
            return False
        rec._completed = True
        rec.status = status
        rec.total = time.perf_counter() - rec.t0
        if rec.outcome is None:
            rec.outcome = _outcome_for(status, rec)
        # keep decision BEFORE the observes: an exemplar must point at
        # a trace the /debug ring can actually answer — dropped
        # records feed the histograms anonymously
        reason = self._keep_reason(rec)
        exemplar = rec.trace_id if reason is not None else None
        for name, _, dur in rec.touched():
            REQUEST_STAGE_SECONDS.observe(
                dur, stage=name, exemplar=exemplar
            )
        # the wide event's unattributed_ms, for every record
        REQUEST_UNCLAIMED_SECONDS.observe(
            max(0.0, rec.total - sum(rec.durs)), exemplar=exemplar
        )
        HTTP_REQUEST_SECONDS.observe(
            rec.total, outcome=rec.outcome, exemplar=exemplar
        )
        if self.sli is not None and (status < 400 or status >= 500):
            # 4xx never enters the SLI ratio: a scanner hammering
            # unauthenticated 403s (fast, "successful" refusals) must
            # not dilute the burn rate during a real latency incident
            # — client errors are not availability, either way
            self.sli.record(
                str(rec.tags.get("priority", "interactive")),
                rec.total,
                error=status >= 500,
            )
        if reason is None:
            rec.pending_exemplars.clear()
            RECORDS_DROPPED.inc()
            with self._lock:
                self._dropped += 1
            return False
        rec.kept = True
        rec.keep_reason = reason
        # deep-site exemplars (queue wait, io fetch, device stages)
        # were deferred at observe time — install them now that the
        # trace is known to be citable
        for hist, value, labels in rec.pending_exemplars:
            try:
                hist.attach_exemplar(value, rec.trace_id, **labels)
            except Exception:  # a metric must never fail a request
                pass
        rec.pending_exemplars.clear()
        RECORDS_KEPT.inc(reason=reason)
        event = rec.wide_event()
        with self._lock:
            self._kept += 1
            self._ring.append(event)
        self._emit_retro_spans(rec)
        return True

    # -- retroactive span export ---------------------------------------

    @staticmethod
    def _emit_retro_spans(rec: FlightRecord) -> None:
        """Materialize a kept record into real Zipkin spans through
        the existing reporter — only when live tracing is OFF (live
        tracing already exports its own spans; both at once would
        double-report every kept request)."""
        from ..utils.tracing import TRACER

        reporter = TRACER.reporter
        if reporter is None or TRACER.enabled:
            return
        root_tags = {"http.status": rec.status or 0,
                     "outcome": rec.outcome or ""}
        for k, v in rec.tags.items():
            root_tags[k] = v
        if rec.faults:
            root_tags["faults"] = ",".join(rec.faults)
        reporter.report(_RetroSpan(
            rec.trace_id, rec.span_id, rec.parent_span_id,
            f"http:{rec.path}", rec.ts, rec.total or 0.0, root_tags,
        ))
        for name, start, dur in rec.touched():
            reporter.report(_RetroSpan(
                rec.trace_id, _new_span_id(), rec.span_id,
                f"stage:{name}", rec.ts + max(0.0, start), dur, {},
            ))

    # -- the /debug surface --------------------------------------------

    def kept_count(self) -> int:
        """The kept counter alone — /debug/requests polls this; the
        full snapshot() walks the SLI windows, which a dashboard loop
        must not contend against the hot path for."""
        with self._lock:
            return self._kept

    def events(
        self, limit: Optional[int] = None,
        trace_id: Optional[str] = None,
    ) -> List[dict]:
        """Most-recent-first kept wide events; ``trace_id`` filters to
        one trace (a trace can appear once per completed request)."""
        with self._lock:
            events = list(self._ring)
        events.reverse()
        if trace_id is not None:
            events = [e for e in events if e["trace_id"] == trace_id]
        if limit is not None:
            events = events[: max(0, int(limit))]
        return events

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "enabled": self.enabled,
                "slow_threshold_ms": round(self.slow_threshold_s * 1e3, 3),
                "head_sample_rate": self.head_sample_rate,
                "ring_size": self.ring_size,
                "ring_occupancy": len(self._ring),
                "started": self._started,
                "kept": self._kept,
                "dropped": self._dropped,
            }
        if self.sli is not None:
            out["sli"] = self.sli.snapshot()
        return out


def _outcome_for(status: int, rec: FlightRecord) -> str:
    if status == 503:
        # only a scheduler/door decision is a SHED; a 503 without the
        # shed_at tag is a dependency that could not answer (session
        # store down, open breaker) — an operator triaging must not
        # read an outage as load-shedding working as designed
        return "shed" if rec.tags.get("shed_at") else "unavailable"
    if status == 504:
        return "timeout"
    if status >= 500:
        return "error"
    if rec.tags.get("degraded"):
        return "degraded"
    if status >= 400:
        return "client_error"
    return "ok"


# -- ambient stamping helpers (no-ops without a record) ----------------


def stage_of(ctx, name: str):
    """Stage timer against the record riding ``ctx`` (TileCtx.obs), or
    a no-op — the pipeline stamps per-lane without knowing whether the
    request came through the HTTP door."""
    rec = getattr(ctx, "obs", None)
    if rec is None:
        return contextlib.nullcontext()
    return rec.stage(name)


@contextlib.contextmanager
def stage_all(ctxs, name: str):
    """One timer, stamped onto every lane's record (batched stages:
    the group's wall time is attributed to each lane it served —
    stage sums are per-request attribution, not machine-time
    accounting, and the wide event says so via ``batched`` tags). Its
    profiler range names the first lane's trace."""
    span = _NO_RANGE
    if _torch_profiler._is_profiler_enabled:
        lead = next((c.obs for c in ctxs if getattr(c, "obs", None) is not None), None)
        span = profiler_range(name, lead)
    t0 = time.perf_counter()
    try:
        with span:
            yield
    finally:
        dur = time.perf_counter() - t0
        for ctx in ctxs:
            rec = getattr(ctx, "obs", None)
            if rec is not None:
                rec.stamp(name, dur)


def ambient_stage(name: str):
    """Stage timer against the AMBIENT record (contextvar), or a
    no-op — for layers that see neither the request nor the ctx (the
    cache plane's L2/peer consults run inside the request's task)."""
    rec = _current_record.get()
    if rec is None:
        return contextlib.nullcontext()
    return rec.stage(name)


def note_fault(point: str) -> None:
    """Fault-injection hook (resilience/faultinject): record the point
    on the ambient request, if any."""
    rec = _current_record.get()
    if rec is not None:
        rec.note_fault(point)


def defer_exemplar(hist, value: float, **labels) -> None:
    """Note a histogram exemplar candidate against the ambient record;
    it is installed at completion ONLY if the tail sampler keeps the
    trace (a dropped trace's id on a bucket would dead-end the
    metric -> trace pivot at a /debug 404). A late note — the device
    readback finishing after the HTTP response completed the record —
    attaches immediately when the record was kept, else vanishes."""
    rec = _current_record.get()
    if rec is None:
        return
    if rec._completed:
        if rec.kept:
            hist.attach_exemplar(value, rec.trace_id, **labels)
        return
    if len(rec.pending_exemplars) < 32:  # bounded per request
        rec.pending_exemplars.append((hist, value, labels))
