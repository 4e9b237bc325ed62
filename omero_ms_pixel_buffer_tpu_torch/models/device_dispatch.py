"""Streaming device-encode queue (counterpart of ``DeviceEncodeDispatcher``
in ``omero_ms_pixel_buffer_tpu/models/device_dispatch.py``, every device
deflate mode, on one device or over a serving mesh).

Callers get a Future per encode group at once. Submitted groups wait in
a FIFO backlog that the queue owns. One SUBMIT thread takes the head
group, stages its batch to the device and launches its first device
work; one READBACK thread waits on the group's event, finishes it,
pulls the streams and frames the PNGs:

- ``dynamic`` (two passes): the submit thread launches pass 1 (filter
  kernel + histogram); the readback thread pulls the (B, 286) counts,
  builds the Huffman tables on the host and launches pass 2 (emit +
  bit-pack kernel + framing), then waits on it.
- ``rle`` and ``stored`` (one pass): the submit thread launches the
  whole chain (filter kernel, tokens, bit-pack kernel, framing); the
  readback thread only waits on it.
- render groups (``submit_render``, always one pass): the submit thread
  launches the composite, the mask multiply, the filter kernel on the
  RGB8 scanlines and the stream build (``render/engine``); the readback
  thread frames RGB8 PNGs (bit depth 8, colour type 2). CUDA events
  around the composite give its device time per group.

Backlog merging (a deliberate difference from the JAX queue, which runs
each group alone): once it holds an in-flight slot, the submit thread
also takes every group directly behind the head that shares its merge
key (``submit`` groups on one device: lane shape and dtype, ``rows``,
``row_bytes``, ``bpp``, filter, deflate mode, ``staged``, bit depth and
colour type), stopping at the first that does not or that would pass
``merge_lanes`` lanes (the batcher's max batch, ``batching.max-batch``,
so a merged group is no larger than one batch could be). It waits for
nothing: a head with an empty backlog runs alone, as does one of
``merge_lanes`` lanes or more. The
members' batches are joined into one (``torch.cat`` on the side stream;
host batches on the host, then copied once), which runs as ONE device
group: one pass 1 or one-pass chain, one plan (each lane's own Huffman
tables; pow2 pad lanes dropped), one pass 2, one pull, one framing. So
every lane's stream is the bytes its own group would have produced. The
readback thread splits the framed PNGs back into each member's
``{lane: png}`` (members number their lanes within their own batches,
so each keeps its offset into the merged one) and resolves each
member's future. ``submit_render``/``submit_supertile`` groups (tables
per group) and mesh groups never merge. Why: a device group costs the
two threads about the same fixed host time whatever its lanes (the
Python enqueue of each pass's launches), so the lanes queued behind a
busy submit thread share that cost.

A semaphore bounds in-flight device groups to ``queue_depth``. All of a group's
device work runs on the queue's side CUDA stream and each pass ends with
a recorded event, so the threads wait on events, never on the whole
device. The bit packer is chosen once per queue (``packer``, default
``device_deflate.default_packer``).

Failure contract: any failure in a group resolves THAT group's future
with the exception (its lanes answer 500) and is counted in
``snapshot()["failed"]``; there is no host re-encode. A failure in a
merged device group fails every member's future, each counted. The
``device.encode-group`` fault point fires once per submitted group,
before it takes a slot (the head) or joins a merge.

With a serving mesh (``set_mesh_manager``, ``parallel/mesh.py``), a group
that is not staged runs wholly on the readback thread, inside
``MeshManager.dispatch``, as in the JAX package: its lanes padded to a
power of two and then to a multiple of the healthy width
(``_mesh_padded_lanes``), the sharded chain of ``parallel/sharding.py``
(``tiles``: the one-pass chain; ``dynamic``: pass 1, the host plan, pass
2; ``render``; ``supertile``: ``submit_supertile``, each slot compositing
its window of the bounding stack), then a wait for every slot. A failure
there probes the slots and retries once on the survivors. The queue
remembers the raw-tile group shapes it has sharded (``_seen_mesh``); when
the healthy width changes, a background thread launches each of them
once at the new width (``_warm_width``), as the JAX queue pre-compiles
them.

Telemetry for ``/metrics``, at the JAX package's boundaries:
``device_stage_seconds`` by stage (``h2d``: the submit thread's host to
device copy, enqueued; then from the launch of the group's last kernel on
the submit thread: ``compute`` to the readback thread's event wait for a
one-pass group, or for a dynamic group ``hist`` to the pass-1 counts on
the host and ``emit`` over the host plan and pass 2; ``d2h``: the stream
pull; ``frame``: the PNG framing), and ``device_queue_idle_seconds``, on
the device's clock: the gap from the end event of the group segment
recorded last on a device to the start event of the next (0 when they
overlapped), where a segment is a one-pass, render or mesh group's device
work, or one pass of a dynamic group. The submit and readback threads
carry the submitting request's flight record (``record_scope``), so the
stage observations' exemplars name its trace.

``snapshot()`` counts submitted groups (``groups``); device groups
completed (``completed``, with their ``lanes``); submitted groups that
rode in another's device group (``merged``, also
``device_encode_groups_merged_total``); and failed groups, so ``groups``
is ``completed + merged + failed`` once all are resolved. It keeps, per
completed device group, the host stages of ``STAGES``: the queue's three
waits (``submit_wait``, enqueue to the submit thread; ``slot_wait``, the
in-flight slot; ``readback_wait``, hand-off to the readback thread: a
merged group's are its head's, the longest, as the backlog is FIFO) and
the work laps on the two threads. Beside them, each
thread's work spans on two clocks (``threads``: wall and the thread's own
CPU, leaving out the slot wait, the event waits and the mesh's
synchronise; a CPU share under 100 % is time the thread waited to run),
and each group's device span from CUDA timing events (``device_ms_total``
by kind over ``device_groups``). Every lap, wait and device program
enqueue enters a profiler range while a profiler runs
(``obs.recorder.profiler_range``): ``ompb.queue.<stage>`` for the laps and
waits, ``ompb.queue.merge`` for a merge's join, ``ompb.prog.<program>``
for the device programs.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import logging
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.device_deflate import (
    build_dynamic_tables,
    dynamic_emit,
    fused_filter_deflate_batch,
    fused_filter_histogram_batch,
    resolve_packer,
    tables_from_numpy,
)
from ..obs.recorder import (
    close_range,
    current_record,
    defer_exemplar,
    open_range,
    profiler_range,
    record_scope,
)
from ..ops.png import frame_png
from ..parallel.sharding import (
    sharded_dynamic_emit,
    sharded_filter_deflate,
    sharded_filter_histogram,
    sharded_render_filter_deflate,
    sharded_supertile_carve_deflate,
)
from ..render.engine import fused_render_filter_deflate_batch, packed_rgb_tables
from ..render.supertile import plan_mesh_partition
from ..resilience.faultinject import INJECTOR
from ..utils.metrics import REGISTRY

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.device_dispatch")

# per-group stage timings (host wall clock, seconds): the wait for the
# submit thread, the wait for an in-flight slot, then H2D + the first
# launch on the submit thread; the wait for the readback thread; then on
# it, for a dynamic group the wait for pass 1 with the counts pull, the
# host Huffman plan and pass 2 launch + wait, for a one-pass group the
# wait for its chain (compute); for every group the stream pull and the
# PNG framing
STAGES = ("submit_wait", "slot_wait", "stage", "readback_wait", "pass1_wait", "plan",
          "pass2", "compute", "pull", "frame")
# the kinds of device span a group has (a dynamic group has two)
DEVICE_KINDS = ("tiles", "dynamic_pass1", "dynamic_pass2", "render", "mesh")
THREADS = ("submit", "readback")

DEVICE_STAGE_SECONDS = REGISTRY.histogram(
    "device_stage_seconds",
    "Device encode pipeline stage durations "
    "(stage=stage|h2d|compute|hist|emit|d2h|frame)",
)
DEVICE_QUEUE_IDLE_SECONDS = REGISTRY.histogram(
    "device_queue_idle_seconds",
    "Device-clock gap from the last encode group segment's end event on a "
    "device to the next segment's start event (0 when they overlapped)",
)
DEVICE_ENCODE_GROUPS_MERGED = REGISTRY.counter(
    "device_encode_groups_merged_total",
    "Encode groups that ran in another group's device group, merged from the "
    "submit backlog",
)


# how many distinct mesh group shapes the width-change warm-up replays
_WARM_SHAPES = 16


def _pow2_lanes(b: int) -> int:
    return 1 << max(b - 1, 0).bit_length()


def _mesh_padded_lanes(b: int, width: int) -> int:
    """A mesh group's lanes: a power of two, then up to a multiple of the
    healthy width (one rule for serving and the warm-up)."""
    return -(-_pow2_lanes(b) // width) * width


def _pad_lanes(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.shape[0] == n:
        return x
    pad = torch.zeros((n - x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def _mesh_streams(mesh) -> list:
    """The current stream (this thread's) of every CUDA slot device."""
    return [torch.cuda.current_stream(dev)
            for dev in {s.device for s in mesh.slots if s.device.type == "cuda"}]


def _gap_s(prev, start) -> Optional[float]:
    """Seconds on the device's clock from ``prev`` (an end event, or None)
    to ``start``; 0 when ``prev`` had not yet happened when ``start`` did."""
    if prev is None:
        return None
    if not prev.query():
        return 0.0
    return max(0.0, prev.elapsed_time(start)) / 1e3


class _ThreadClock:
    """One thread's work span on two clocks, wall (``perf_counter``) and
    the thread's own CPU (``thread_time``), the explicit waits inside it
    (``pause``/``resume``) left out of both."""

    __slots__ = ("wall", "cpu", "_w", "_c")

    def __init__(self):
        self.wall = self.cpu = 0.0
        self.resume()

    def resume(self) -> None:
        self._w, self._c = time.perf_counter(), time.thread_time()

    def pause(self) -> None:
        # the CPU reading first: its span lies inside the wall span
        self.cpu += time.thread_time() - self._c
        self.wall += time.perf_counter() - self._w


class _Lap:
    """One host lap of a group: its seconds into ``timing[name]`` and its
    profiler range."""

    __slots__ = ("timing", "name", "range", "t0", "t1")

    def __init__(self, timing: dict, name: str, rec):
        self.timing, self.name = timing, name
        self.range = profiler_range(f"queue.{name}", rec)

    def __enter__(self) -> "_Lap":
        self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()
        self.timing[self.name] = self.t1 - self.t0
        self.range.__exit__(*exc)


class _GroupClock:
    """What one group carries from its enqueue to its readback: its
    flight record, its host waits and the open wait's start and range."""

    __slots__ = ("rec", "waits", "_name", "_t0", "_range")

    def __init__(self, rec):
        self.rec = rec
        self.waits: Dict[str, float] = {}
        self._name = None

    def begin(self, name: str) -> None:
        self._name, self._t0 = name, time.perf_counter()
        self._range = open_range(f"queue.{name}", self.rec)

    def end(self) -> None:
        if self._name is not None:
            self.waits[self._name] = time.perf_counter() - self._t0
            close_range(self._range)
            self._name = None


class _Submitted:
    """One submitted group in the backlog: its future, its stage function
    and arguments, its framing (lanes, sizes, bit depth, colour type), its
    clock and its merge key (None: it never merges)."""

    __slots__ = ("fut", "stage_fn", "args", "frame", "clock", "key")

    def __init__(self, fut, stage_fn, args, frame, clock: _GroupClock, key):
        self.fut, self.stage_fn, self.args = fut, stage_fn, args
        self.frame, self.clock, self.key = frame, clock, key

    @property
    def lanes(self) -> int:
        return len(self.frame[0])


def _observe_stage(duration: float, stage: str) -> None:
    """The stage histogram, its exemplar deferred to the ambient record."""
    DEVICE_STAGE_SECONDS.observe(duration, stage=stage)
    defer_exemplar(DEVICE_STAGE_SECONDS, duration, stage=stage)


class DeviceEncodeDispatcher:
    """Submit encode groups into the persistent queue; collect
    per-group futures resolving to {lane_index: png_bytes}."""

    def __init__(self, device: torch.device, queue_depth: int = 2,
                 packer: Optional[str] = None, merge_lanes: int = 32):
        self.device = device
        self.queue_depth = max(1, int(queue_depth))
        # the most lanes a merge takes into one device group: the
        # batcher's max batch
        self.merge_lanes = max(1, int(merge_lanes))
        self.packer = resolve_packer(packer, device)
        self._stream = (
            torch.cuda.Stream(device) if device.type == "cuda" else None
        )
        # the submit thread's FIFO of submitted groups (``_Submitted``),
        # started with the first group
        self._backlog: collections.deque = collections.deque()
        self._backlog_cv = threading.Condition()
        self._submit_thread: Optional[threading.Thread] = None
        self._readback = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="devenc-readback"
        )
        self._slots = threading.Semaphore(self.queue_depth)
        self._closed = False
        self._pending_lock = threading.Lock()
        self._pending: set = set()
        # adaptive compressed-size guess per (w, h): lengths and stream
        # bytes come back in one pull
        self._dd_cap: Dict[Tuple[int, int], int] = {}
        self._stats_lock = threading.Lock()
        self._inflight = 0
        self._groups = 0
        self._lanes = 0
        self._failed = 0
        self._completed = 0
        self._merged = 0
        self._stage_s = dict.fromkeys(STAGES, 0.0)
        self._stage_n = dict.fromkeys(STAGES, 0)
        self._render_groups = 0
        self._composite_ms = 0.0  # device ms of render groups' composites
        self._composite_n = 0
        self._device_ms = dict.fromkeys(DEVICE_KINDS, 0.0)
        self._device_n = 0
        self._thread_s = {name: [0.0, 0.0] for name in THREADS}  # wall, CPU
        # the end event of the segment recorded last on each device, and
        # the lock that keeps that order the devices' own
        self._last_end: Dict[int, object] = {}
        self._ev_lock = threading.Lock()
        # the running thread's work clock (the waits pause it)
        self._tls = threading.local()
        # the serving mesh (None: one device), the raw-tile group shapes it
        # has served and the (width, shape) pairs warmed
        self.mesh_manager = None
        self._seen_mesh: Dict[tuple, None] = {}
        self._warmed: set = set()
        self._warm_lock = threading.Lock()
        self._warm_thread: Optional[threading.Thread] = None

    def set_mesh_manager(self, manager) -> None:
        """Serve every group that is not staged over ``manager``'s mesh,
        and warm the known shapes when its healthy width changes."""
        self.mesh_manager = manager
        manager.add_width_listener(self._on_mesh_width)

    def _on_mesh(self, staged: bool) -> bool:
        """Whether a group runs over the serving mesh: every group that is
        not staged, once a mesh is set."""
        return self.mesh_manager is not None and not staged

    # -- streams and events ----------------------------------------------

    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _open_segment(self, stream=None):
        """A timing event opening a group segment on ``stream`` (default:
        the side stream), with the end event recorded last on its device
        before it: (start, previous end). None on the CPU."""
        stream = stream or self._stream
        if stream is None:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        with self._ev_lock:
            ev.record(stream)
            return ev, self._last_end.get(stream.device_index)

    def _close_segment(self, stream=None):
        """A timing event closing a group segment on ``stream`` (default:
        the side stream); the threads wait on it. None on the CPU."""
        stream = stream or self._stream
        if stream is None:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        with self._ev_lock:
            ev.record(stream)
            self._last_end[stream.device_index] = ev
        return ev

    def _wait(self, ev) -> None:
        """Wait for ``ev``, outside this thread's work clock."""
        if ev is None:
            return
        clock = getattr(self._tls, "clock", None)
        if clock is not None:
            clock.pause()
        try:
            ev.synchronize()
        finally:
            if clock is not None:
                clock.resume()

    def _sync_mesh(self, mesh) -> None:
        """Close a segment on every slot's current stream (the readback
        thread's) and wait for them; the ends are left for the group's
        device span (``_tls.mesh_ends``)."""
        ends = [(s, self._close_segment(s)) for s in _mesh_streams(mesh)]
        for _, ev in ends:
            self._wait(ev)
        self._tls.mesh_ends = {s.device_index: ev for s, ev in ends}

    def _add_thread(self, name: str, clock: _ThreadClock) -> None:
        with self._stats_lock:
            acc = self._thread_s[name]
            acc[0] += clock.wall
            acc[1] += clock.cpu

    # -- lifecycle ---------------------------------------------------------

    def close(self, drain_timeout: float = 30.0) -> None:
        """Stop accepting groups, wait up to ``drain_timeout`` for the
        submitted ones, then release the threads. Idempotent."""
        with self._backlog_cv:
            self._closed = True  # the submit thread drains the backlog, then ends
            self._backlog_cv.notify_all()
        with self._pending_lock:
            pending = list(self._pending)
        _, not_done = concurrent.futures.wait(pending, timeout=drain_timeout)
        for fut in not_done:
            self._resolve_exc(fut, TimeoutError("device encode queue drain timed out"))
        self._readback.shutdown(wait=not not_done)

    def snapshot(self) -> dict:
        """/healthz view: the packer, groups submitted, device groups
        completed, lanes encoded, groups merged into another's device
        group, groups failed, in-flight count, per stage (``STAGES``)
        the completed device groups that ran it, their total milliseconds and the
        mean over them, render groups submitted, the device time of the
        completed render groups' composites (CUDA only), the submit and
        readback threads' work milliseconds on the wall and CPU clocks,
        the completed groups' device milliseconds by kind and their count
        (CUDA only) and, with a mesh, the group shapes it has served and
        the widths warmed. Two views differ by what ran between them."""
        mesh = None
        if self.mesh_manager is not None:
            with self._warm_lock:
                mesh = {"seen_shapes": len(self._seen_mesh),
                        "warmed": sorted({w for w, _ in self._warmed})}
        with self._stats_lock:
            ran = {k: n for k, n in self._stage_n.items() if n}
            return {
                "mesh": mesh,
                "packer": self.packer,
                "queue_depth": self.queue_depth,
                "inflight": self._inflight,
                "groups": self._groups,
                "completed": self._completed,
                "lanes": self._lanes,
                "merged": self._merged,
                "failed": self._failed,
                "stage_groups": ran,
                "stage_ms_total": {k: self._stage_s[k] * 1e3 for k in ran},
                "stage_ms_mean": {
                    k: round(self._stage_s[k] / n * 1e3, 3) for k, n in ran.items()
                } if self._completed > 0 else None,
                "render_groups": self._render_groups,
                "composite_groups": self._composite_n,
                "composite_device_ms_total": self._composite_ms,
                "threads": {name: {"wall_ms": w * 1e3, "cpu_ms": c * 1e3}
                            for name, (w, c) in self._thread_s.items()},
                "device_groups": self._device_n,
                "device_ms_total": dict(self._device_ms),
            }

    # -- submission --------------------------------------------------------

    def submit(
        self, tiles, rows: int, row_bytes: int, bpp: int, filter_mode: str,
        deflate_mode: str, lanes: Sequence[int], sizes: Sequence[Tuple[int, int]],
        bit_depth: int, color_type: int, staged: bool = False,
    ) -> "concurrent.futures.Future":
        """Enqueue one encode group. ``tiles`` is a host bit tensor
        (bucket route, copied to the device on the submit thread) or an
        already device-resident batch made on this queue's stream
        (plane route, ``staged=True``). All lanes share one real (w, h),
        described by ``rows``/``row_bytes``; ``deflate_mode`` is one of
        ``DEFLATE_MODES`` (the pipeline checks it; any other fails the
        group). Groups on one device (staged, or no mesh) merge with the
        groups of the same key queued behind them."""
        key = None
        if not self._on_mesh(staged):
            # everything the device group is launched and framed with but
            # the lanes themselves
            key = (tuple(tiles.shape[1:]), tiles.dtype, rows, row_bytes, bpp, filter_mode,
                   deflate_mode, staged, bit_depth, color_type)
        return self._enqueue(
            self._stage_group,
            (tiles, rows, row_bytes, bpp, filter_mode, deflate_mode, staged),
            (list(lanes), list(sizes), bit_depth, color_type), key)

    def submit_render(
        self, planes, index_tables, color_luts, rows: int, row_bytes: int,
        filter_mode: str, deflate_mode: str, lanes: Sequence[int],
        sizes: Sequence[Tuple[int, int]], mask=None, staged: bool = False,
    ) -> "concurrent.futures.Future":
        """Enqueue one render group (``render/engine``): ``planes`` is a
        host (B, C, H, W) bit tensor of unsigned channel pixels, copied to
        the device on the submit thread, or a device-resident batch made
        on this queue's stream (``staged=True``, plane-cache projection
        crops: no copy). ``mask`` is an optional (B, H, W) uint8 ROI
        batch, on the host unless ``staged``. The lanes share one real
        (w, h) (``rows`` x ``row_bytes`` of RGB8 scanlines);
        ``deflate_mode`` is ``rle`` or ``stored``."""
        with self._stats_lock:
            self._render_groups += 1
        return self._enqueue(
            self._stage_render_group,
            (planes, index_tables, color_luts, rows, row_bytes, filter_mode,
             deflate_mode, mask, staged),
            (list(lanes), list(sizes), 8, 2))

    def submit_supertile(
        self, stack: np.ndarray, index_tables, color_luts,
        rel_rects: Sequence[Tuple[int, int, int, int]], tile_w: int, tile_h: int,
        filter_mode: str, deflate_mode: str, lanes: Sequence[int],
    ) -> "concurrent.futures.Future":
        """Enqueue one mesh-fused super-tile group: ``stack`` the host
        (C, H, W) unsigned bounding stack, ``rel_rects`` its lanes' (x,
        y, w, h) rectangles in it, all of one (tile_w, tile_h) size.
        Composite, carve, filter and deflate run over the mesh, each slot
        on its window (planned inside the managed dispatch, so a retry on
        the survivors re-plans); resolves to {lane: png bytes}."""
        return self._enqueue(
            self._stage_supertile_group,
            (stack, index_tables, color_luts, list(rel_rects), tile_w, tile_h, filter_mode,
             deflate_mode, len(lanes)),
            (list(lanes), [(tile_w, tile_h)] * len(lanes), 8, 2))

    def _enqueue(self, stage_fn, args, frame, key=None) -> "concurrent.futures.Future":
        """Append ``stage_fn(*args)`` to the submit thread's backlog;
        ``frame`` is (lanes, sizes, bit depth, colour type) for the
        readback, ``key`` what a group behind it must share to join its
        device group (None: it runs alone). The caller's ambient flight
        record rides the group to both threads."""
        fut: "concurrent.futures.Future" = concurrent.futures.Future()
        item = _Submitted(fut, stage_fn, args, frame, _GroupClock(current_record()), key)
        with self._backlog_cv:  # so close() cannot end the submit thread before it
            if self._closed:
                raise RuntimeError("device encode queue is closed")
            with self._pending_lock:
                self._pending.add(fut)
            with self._stats_lock:
                self._groups += 1
            item.clock.begin("submit_wait")
            self._backlog.append(item)
            if self._submit_thread is None:
                self._submit_thread = threading.Thread(
                    target=self._submit_loop, name="devenc-submit", daemon=True)
                self._submit_thread.start()
            self._backlog_cv.notify()
        fut.add_done_callback(self._discard_pending)
        return fut

    def failed_group(self, exc: Exception) -> "concurrent.futures.Future":
        """A group that failed before it reached the queue (its batch
        could not be built or submitted): counted, future raising."""
        fut: "concurrent.futures.Future" = concurrent.futures.Future()
        self._fail(fut, exc)
        return fut

    def stream_context(self):
        """Context making the queue's side stream current: the pipeline
        builds staged (plane-cache) batches inside it."""
        return self._on_stream()

    def synchronize_stream(self) -> None:
        """Wait for everything queued on the side stream (before a host
        pull of a tensor made there)."""
        if self._stream is not None:
            self._stream.synchronize()

    def _discard_pending(self, fut) -> None:
        with self._pending_lock:
            self._pending.discard(fut)

    @staticmethod
    def _resolve_exc(fut, exc) -> None:
        try:
            fut.set_exception(exc)
        except concurrent.futures.InvalidStateError:
            pass  # close()'s drain deadline got there first

    def _fail(self, fut, exc) -> None:
        with self._stats_lock:
            self._failed += 1
        log.error("device encode group failed: %r", exc)
        self._resolve_exc(fut, exc)

    def _release_slot(self) -> None:
        with self._stats_lock:
            self._inflight -= 1
        self._slots.release()

    # -- the two threads ------------------------------------------------------

    def _submit_loop(self) -> None:
        """The submit thread: run the backlog's head group, and the groups
        merged into it, until the queue is closed and the backlog drained."""
        while True:
            with self._backlog_cv:
                while not self._backlog and not self._closed:
                    self._backlog_cv.wait()
                if not self._backlog:
                    return
                head = self._backlog.popleft()
            try:
                self._run_stage(head)
            except Exception:  # keep the thread: every later group needs it
                log.exception("device encode submit failed")

    def _run_stage(self, head: _Submitted) -> None:
        """Submit thread: take an in-flight slot, merge the compatible
        groups behind ``head``, stage + launch the first device work, hand
        the device group to the readback thread."""
        head.clock.end()  # submit_wait
        clock = self._tls.clock = _ThreadClock()
        try:
            handoff = self._stage_on_submit(head, clock)
        finally:
            self._tls.clock = None
            clock.pause()
            # counted before the hand-off: a snapshot taken once the
            # readback thread has resolved the futures holds this time
            self._add_thread("submit", clock)
        if handoff is None:
            return
        group, members = handoff[0], handoff[1]
        try:
            self._readback.submit(self._readback_scoped, *handoff)
        except RuntimeError as e:  # close() shut the readback thread down
            group.end()
            self._release_slot()
            for fut, _ in members:
                self._fail(fut, e)

    def _fire_fault(self, item: _Submitted) -> bool:
        """The ``device.encode-group`` fault point (tests), once per
        submitted group: False (the group failed) when it fires."""
        try:
            INJECTOR.fire("device.encode-group")
        except Exception as e:
            self._fail(item.fut, e)
            return False
        return True

    def _take_followers(self, head: _Submitted) -> list:
        """The groups directly behind ``head`` in the backlog that share
        its merge key, up to ``merge_lanes`` lanes with its own, in FIFO
        order; each fires the fault point before it joins."""
        if head.key is None:
            return []
        taken, lanes = [], head.lanes
        with self._backlog_cv:
            while (self._backlog and self._backlog[0].key == head.key
                   and lanes + self._backlog[0].lanes <= self.merge_lanes):
                taken.append(self._backlog.popleft())
                lanes += taken[-1].lanes
        for item in taken:
            item.clock.end()  # submit_wait
        return [item for item in taken if self._fire_fault(item)]

    def _stage_on_submit(self, head: _Submitted, clock: _ThreadClock):
        """The submit thread's work on one device group: the arguments of
        its hand-off to the readback thread, or None when it failed."""
        if not self._fire_fault(head):
            return None
        group = head.clock
        clock.pause()
        group.begin("slot_wait")
        self._slots.acquire()
        group.end()
        clock.resume()
        with self._stats_lock:
            self._inflight += 1
        members = [head]
        try:
            members += self._take_followers(head)
            with record_scope(group.rec):
                t0 = time.perf_counter()
                args = head.args
                if len(members) > 1:
                    with profiler_range("queue.merge", group.rec), self._on_stream():
                        # one batch of the members' lanes, in backlog order;
                        # a host batch is copied to the device by the stage
                        args = (torch.cat([m.args[0] for m in members]),) + args[1:]
                with profiler_range("queue.stage", group.rec):
                    launched, t_h2d = head.stage_fn(*args)
                t_dispatch = time.perf_counter()
                _observe_stage(t_h2d - t0, "h2d")
        except Exception as e:
            self._release_slot()
            for m in members:
                self._fail(m.fut, e)
            return None
        group.begin("readback_wait")
        return (group, [(m.fut, m.frame) for m in members], t_dispatch - t0, t_dispatch,
                launched)

    def _readback_scoped(self, group: _GroupClock, members, *args) -> None:
        """Readback thread: finish the device group under its head's
        flight record, free its slot and resolve each member's future
        with its own lanes (a failure resolves every one with the
        exception)."""
        group.end()  # readback_wait
        clock = self._tls.clock = _ThreadClock()
        outs = err = None
        try:
            with record_scope(group.rec):
                outs = self._readback_group(group, [frame for _, frame in members], *args)
        except Exception as e:
            err = e
        finally:
            self._tls.clock = None
            clock.pause()
            # counted before the futures resolve, as on the submit thread
            self._add_thread("readback", clock)
        self._release_slot()
        for i, (fut, _) in enumerate(members):
            if err is not None:
                self._fail(fut, err)
                continue
            try:
                fut.set_result(outs[i])
            except concurrent.futures.InvalidStateError:
                pass  # close()'s drain deadline got there first

    # -- the device work ---------------------------------------------------

    def _stage_group(self, tiles, rows, row_bytes, bpp, filter_mode, deflate_mode, staged):
        """Submit thread: H2D (bucket route), then on the side stream pass 1
        of a dynamic group or the whole chain of a one-pass group. Returns
        ((mode, device tensors, the event that ends them, None, (the
        segment's kind, its start from ``_open_segment``)), the time the
        first kernel's enqueue began). With a mesh, a group that is not staged
        leaves a ("mesh", (tag, lanes, run)) for the readback thread."""
        if self._on_mesh(staged):
            self._register_mesh_shape(tiles, rows, row_bytes, bpp, filter_mode, deflate_mode)
            run = self._mesh_tiles_run(tiles, rows, row_bytes, bpp, filter_mode, deflate_mode)
            tag = "dynamic" if deflate_mode == "dynamic" else "tiles"
            return (("mesh", (tag, tiles.shape[0], run), None, None, ("mesh", None)),
                    time.perf_counter())
        rec = current_record()
        with self._on_stream():
            start = self._open_segment()
            batch = tiles if staged else tiles.to(self.device, non_blocking=True)
            t_h2d = time.perf_counter()
            if deflate_mode == "dynamic":
                with profiler_range("prog.pass1", rec):
                    out = fused_filter_histogram_batch(
                        batch, rows, row_bytes, bpp, filter_mode=filter_mode,
                    )
            else:
                with profiler_range("prog.one_pass", rec):
                    out = fused_filter_deflate_batch(
                        batch, rows, row_bytes, bpp, filter_mode=filter_mode,
                        mode=deflate_mode, packer=self.packer,
                    )
            kind = "dynamic_pass1" if deflate_mode == "dynamic" else "tiles"
            return (deflate_mode, out, self._close_segment(), None, (kind, start)), t_h2d

    def _stage_render_group(self, planes, index_tables, color_luts, rows, row_bytes,
                            filter_mode, deflate_mode, mask, staged):
        """Submit thread: H2D of the planes and the mask (unless staged),
        then on the side stream the whole render chain. Returns ((mode,
        device tensors, the event that ends them, the composite's timing
        events or None, ("render", the segment's start)), the time the first
        kernel's enqueue began)."""
        if self._on_mesh(staged):
            run = self._mesh_render_run(planes, index_tables, color_luts, rows, row_bytes,
                                        filter_mode, deflate_mode, mask)
            return (("mesh", ("render", planes.shape[0], run), None, None, ("mesh", None)),
                    time.perf_counter())
        packed = packed_rgb_tables(index_tables, color_luts)
        with self._on_stream():
            start = self._open_segment()
            if staged:
                batch, mask_dev = planes, mask
            else:
                batch = planes.to(self.device, non_blocking=True)
                mask_dev = None if mask is None else mask.to(self.device, non_blocking=True)
            t_h2d = time.perf_counter()
            timing = None
            if self._stream is not None:
                timing = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            with profiler_range("prog.render_chain", current_record()):
                out = fused_render_filter_deflate_batch(
                    batch, index_tables, color_luts, rows, row_bytes,
                    filter_mode=filter_mode, mode=deflate_mode, packer=self.packer,
                    mask=mask_dev, packed=packed, composite_events=timing,
                )
            return (deflate_mode, out, self._close_segment(), timing, ("render", start)), t_h2d

    def _stage_supertile_group(self, stack, index_tables, color_luts, rel_rects, tile_w,
                               tile_h, filter_mode, deflate_mode, n_lanes):
        if self.mesh_manager is None:
            raise RuntimeError("submit_supertile needs a serving mesh")
        c, stack_h, stack_w = stack.shape

        def run(mesh):
            # planned inside the managed dispatch: a retry on the
            # survivors re-plans for their width
            origins, (sub_h, sub_w), coords, rows_map = plan_mesh_partition(
                rel_rects, stack_h, stack_w, mesh.size)
            sub = np.stack([stack[:, sy:sy + sub_h, sx:sx + sub_w] for sy, sx in origins])
            streams, lengths = sharded_supertile_carve_deflate(
                mesh, sub, index_tables, color_luts, coords, tile_h, tile_w,
                filter_mode=filter_mode, deflate_mode=deflate_mode, packer=self.packer)
            sel = torch.tensor(rows_map, dtype=torch.int64, device=streams.device)
            streams, lengths = streams.index_select(0, sel), lengths.index_select(0, sel)
            self._sync_mesh(mesh)
            return streams, lengths

        return (("mesh", ("supertile", n_lanes, run), None, None, ("mesh", None)),
                time.perf_counter())

    # -- mesh groups (readback thread, inside the managed dispatch) ---------

    def _mesh_tiles_run(self, tiles, rows, row_bytes, bpp, filter_mode, deflate_mode):
        """The sharded chain of one raw-tile group as ``run(mesh)``:
        (streams, lengths) of its real lanes, waited for."""
        b = tiles.shape[0]

        def run(mesh):
            batch = _pad_lanes(tiles, _mesh_padded_lanes(b, mesh.size))
            if deflate_mode == "dynamic":
                # the host plan between the two sharded passes, inside the
                # managed dispatch: a slot failing in either pass degrades
                # the mesh, and the retry re-runs both
                flat, counts, extras = sharded_filter_histogram(
                    mesh, batch, rows, row_bytes, bpp, filter_mode=filter_mode)
                tables = build_dynamic_tables(counts.cpu().numpy(), extras.cpu().numpy(),
                                              real=b)
                streams, lengths = sharded_dynamic_emit(mesh, flat, tables, packer=self.packer)
            else:
                streams, lengths = sharded_filter_deflate(
                    mesh, batch, rows, row_bytes, bpp, filter_mode=filter_mode,
                    deflate_mode=deflate_mode, packer=self.packer)
            self._sync_mesh(mesh)
            return streams[:b], lengths[:b]

        return run

    def _mesh_render_run(self, planes, index_tables, color_luts, rows, row_bytes, filter_mode,
                         deflate_mode, mask):
        """The sharded render chain of one group as ``run(mesh)``; the ROI
        mask is padded and sharded with its lanes."""
        b = planes.shape[0]

        def run(mesh):
            n = _mesh_padded_lanes(b, mesh.size)
            streams, lengths = sharded_render_filter_deflate(
                mesh, _pad_lanes(planes, n), index_tables, color_luts, rows, row_bytes,
                filter_mode=filter_mode, deflate_mode=deflate_mode, packer=self.packer,
                mask=None if mask is None else _pad_lanes(mask, n))
            self._sync_mesh(mesh)
            return streams[:b], lengths[:b]

        return run

    def _register_mesh_shape(self, tiles, rows, row_bytes, bpp, filter_mode,
                             deflate_mode) -> None:
        """Remember a raw-tile mesh group's shape for the width warm-up."""
        key = (tuple(tiles.shape[1:]), str(tiles.dtype), _pow2_lanes(tiles.shape[0]), rows,
               row_bytes, bpp, filter_mode, deflate_mode)
        with self._warm_lock:
            self._seen_mesh[key] = None
            while len(self._seen_mesh) > _WARM_SHAPES:
                self._seen_mesh.pop(next(iter(self._seen_mesh)))

    def _on_mesh_width(self, width: int) -> None:
        """The mesh manager's width listener: launch every known group
        shape once at the new width, on a background thread, before the
        first serving dispatch there."""
        with self._warm_lock:
            shapes = [k for k in self._seen_mesh if (width, k) not in self._warmed]
        with self._backlog_cv:
            closed = self._closed
        if not shapes or closed:
            return
        t = threading.Thread(target=self._warm_width, args=(width, shapes),
                             name="devenc-mesh-warm", daemon=True)
        t.start()
        self._warm_thread = t

    def _warm_width(self, width: int, shapes) -> None:
        for key in shapes:
            lane_shape, dtype, pow2_b, rows, row_bytes, bpp, filter_mode, deflate_mode = key
            try:
                mesh = self.mesh_manager.mesh()
                if mesh.size != width:
                    return  # the mesh moved again: a newer warm-up owns it
                zeros = torch.zeros((pow2_b,) + lane_shape, dtype=getattr(torch, dtype[6:]))
                self._mesh_tiles_run(zeros, rows, row_bytes, bpp, filter_mode,
                                     deflate_mode)(mesh)
                with self._warm_lock:
                    self._warmed.add((width, key))
                log.info("warmed mesh width %d for group shape %s", width, lane_shape)
            except Exception:
                log.exception("mesh warm-up failed for %s", key)

    def _readback_group(self, group: _GroupClock, frames, t_stage, t_dispatch, launched):
        """Readback thread: wait for the device group's work (for a dynamic
        group: pull the counts, plan the tables and run pass 2), then pull
        and frame each member's lanes (``frames``: its lanes, sizes, bit
        depth and colour type, in batch order); then read its device
        events and keep its stats. One ``{lane: png}`` a member."""
        mode, tensors, ev, composite, (kind, start) = launched
        rec = group.rec
        timing = dict(group.waits, stage=t_stage)
        segments = []  # (kind, (start, previous end), end) on the side stream
        if mode == "mesh":
            tag, real, run = tensors
            starts = {}

            def timed(mesh):
                # the attempt that succeeds leaves its starts and ends
                starts.clear()
                for s in _mesh_streams(mesh):
                    starts[s.device_index] = self._open_segment(s)
                self._tls.mesh_ends = {}
                return run(mesh)

            with _Lap(timing, "compute", rec) as lap:
                with profiler_range(f"prog.mesh_{tag}", rec):
                    streams, lengths = self.mesh_manager.dispatch(timed, real_lanes=real,
                                                                  tag=tag)
            _observe_stage(lap.t1 - t_dispatch, "compute")
            ends = self._tls.mesh_ends
            segments += [("mesh", starts[i], ends[i]) for i in starts.keys() & ends.keys()]
        elif mode == "dynamic":
            flat, counts, extras, real_b = tensors
            with _Lap(timing, "pass1_wait", rec) as lap:
                self._wait(ev)
                counts_np = counts.cpu().numpy()
                extras_np = extras.cpu().numpy()
            _observe_stage(lap.t1 - t_dispatch, "hist")
            if start is not None:
                segments.append((kind, start, ev))
            with _Lap(timing, "plan", rec):
                tables = build_dynamic_tables(counts_np, extras_np, real=real_b)
                with self._on_stream():
                    start2 = self._open_segment()
                    tables = tables_from_numpy(tables, flat.device)
            with _Lap(timing, "pass2", rec):
                with self._on_stream():
                    with profiler_range("prog.pass2", rec):
                        streams, lengths = dynamic_emit(flat, tables, packer=self.packer)
                    end2 = self._close_segment()
                self._wait(end2)
            if start2 is not None:
                segments.append(("dynamic_pass2", start2, end2))
            _observe_stage(timing["plan"] + timing["pass2"], "emit")
            streams, lengths = streams[:real_b], lengths[:real_b]
        else:
            streams, lengths = tensors
            with _Lap(timing, "compute", rec) as lap:
                self._wait(ev)
            _observe_stage(lap.t1 - t_dispatch, "compute")
            if start is not None:
                segments.append((kind, start, ev))
        with _Lap(timing, "pull", rec):
            streams_np, lengths_np = self._pull(streams, lengths, frames[0][1][0])
        _observe_stage(timing["pull"], "d2h")
        with _Lap(timing, "frame", rec):
            outs, offset = [], 0  # a member's lanes start at its offset
            for lanes, sizes, bit_depth, color_type in frames:
                outs.append({
                    lane: frame_png(
                        np.ascontiguousarray(
                            streams_np[offset + j, : int(lengths_np[offset + j])]).tobytes(),
                        sizes[j][0], sizes[j][1], bit_depth, color_type,
                    )
                    for j, lane in enumerate(lanes)
                })
                offset += len(lanes)
        _observe_stage(timing["frame"], "frame")
        composite_ms = composite[0].elapsed_time(composite[1]) if composite else None
        device_ms = self._read_segments(segments)
        with self._stats_lock:
            for k, v in timing.items():
                self._stage_s[k] += v
                self._stage_n[k] += 1
            if composite_ms is not None:
                self._composite_ms += composite_ms
                self._composite_n += 1
            if device_ms:
                for kind, ms in device_ms.items():
                    self._device_ms[kind] += ms
                self._device_n += 1
            self._lanes += offset
            self._completed += 1
            self._merged += len(frames) - 1
        if len(frames) > 1:
            DEVICE_ENCODE_GROUPS_MERGED.inc(len(frames) - 1)
        return outs

    @staticmethod
    def _read_segments(segments) -> Dict[str, float]:
        """Device milliseconds of a group's segments by kind (a mesh
        group's is its slowest device's), each segment's idle gap
        observed; every event has happened."""
        device_ms: Dict[str, float] = {}
        for kind, (start, prev), end in segments:
            ms = start.elapsed_time(end)
            device_ms[kind] = max(device_ms.get(kind, 0.0), ms) if kind == "mesh" else (
                device_ms.get(kind, 0.0) + ms)
            gap = _gap_s(prev, start)
            if gap is not None:
                DEVICE_QUEUE_IDLE_SECONDS.observe(gap)
        return device_ms

    def _pull(self, streams, lengths, size):
        """Pull lengths and the leading ``cap`` stream bytes (the adaptive
        pow2 guess per (w, h); one more pull when a lane overflows it)."""
        full_cap = streams.shape[1]
        with self._stats_lock:
            guess = min(
                self._dd_cap.get(size, 1 << max(full_cap // 4, 64).bit_length()),
                full_cap,
            )
        lengths_np = lengths.cpu().numpy()
        streams_np = streams[:, :guess].cpu().numpy()
        max_len = int(lengths_np.max()) if lengths_np.size else 0
        if max_len > guess:
            cap = min(full_cap, 1 << max(max_len - 1, 0).bit_length())
            streams_np = streams[:, :cap].cpu().numpy()
        with self._stats_lock:
            self._dd_cap[size] = min(
                full_cap, 1 << max(2 * max_len - 1, 0).bit_length()
            )
        return streams_np, lengths_np
