"""Streaming device-encode queue (counterpart of ``DeviceEncodeDispatcher``
in ``omero_ms_pixel_buffer_tpu/models/device_dispatch.py``, single
device, every device deflate mode).

Callers get a Future per encode group at once. One SUBMIT thread stages
each group's host batch to the device and launches its first device
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

A semaphore bounds in-flight groups to ``queue_depth``. All of a group's
device work runs on the queue's side CUDA stream and each pass ends with
a recorded event, so the threads wait on events, never on the whole
device. The bit packer is chosen once per queue (``packer``, default
``device_deflate.default_packer``).

Failure contract: any failure in a group resolves THAT group's future
with the exception (its lanes answer 500) and is counted in
``snapshot()["failed"]``; there is no host re-encode.
"""

from __future__ import annotations

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
from ..ops.png import frame_png
from ..render.engine import fused_render_filter_deflate_batch, packed_rgb_tables

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.device_dispatch")

# per-group stage timings (host wall clock, seconds): H2D + the first
# launch on the submit thread; then on the readback thread, for a dynamic
# group the wait for pass 1 with the counts pull, the host Huffman plan
# and pass 2 launch + wait, for a one-pass group the wait for its chain
# (compute); for every group the stream pull and the PNG framing
STAGES = ("stage", "pass1_wait", "plan", "pass2", "compute", "pull", "frame")


class DeviceEncodeDispatcher:
    """Submit encode groups into the persistent queue; collect
    per-group futures resolving to {lane_index: png_bytes}."""

    def __init__(self, device: torch.device, queue_depth: int = 2,
                 packer: Optional[str] = None):
        self.device = device
        self.queue_depth = max(1, int(queue_depth))
        self.packer = resolve_packer(packer, device)
        self._stream = (
            torch.cuda.Stream(device) if device.type == "cuda" else None
        )
        self._submit_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="devenc-submit"
        )
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
        self._stage_s = dict.fromkeys(STAGES, 0.0)
        self._stage_n = dict.fromkeys(STAGES, 0)
        self._render_groups = 0
        self._composite_ms = 0.0  # device ms of render groups' composites
        self._composite_n = 0

    # -- streams and events ----------------------------------------------

    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _mark(self):
        """Record an event on the side stream (None on the CPU)."""
        if self._stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self._stream)
        return ev

    @staticmethod
    def _wait(ev) -> None:
        if ev is not None:
            ev.synchronize()

    # -- lifecycle ---------------------------------------------------------

    def close(self, drain_timeout: float = 30.0) -> None:
        """Stop accepting groups, wait up to ``drain_timeout`` for the
        submitted ones, then release the threads. Idempotent."""
        self._closed = True
        self._submit_pool.shutdown(wait=False)
        with self._pending_lock:
            pending = list(self._pending)
        _, not_done = concurrent.futures.wait(pending, timeout=drain_timeout)
        for fut in not_done:
            self._resolve_exc(fut, TimeoutError("device encode queue drain timed out"))
        self._readback.shutdown(wait=not not_done)

    def snapshot(self) -> dict:
        """/healthz view: the packer, groups submitted and completed, lanes
        encoded, groups failed, in-flight count, per stage (``STAGES``)
        the completed groups that ran it, their total milliseconds and the
        mean over them, render groups submitted, and the device time of
        the completed render groups' composites (CUDA only). Two views
        differ by what ran between them."""
        with self._stats_lock:
            ran = {k: n for k, n in self._stage_n.items() if n}
            return {
                "packer": self.packer,
                "queue_depth": self.queue_depth,
                "inflight": self._inflight,
                "groups": self._groups,
                "completed": self._completed,
                "lanes": self._lanes,
                "failed": self._failed,
                "stage_groups": ran,
                "stage_ms_total": {k: self._stage_s[k] * 1e3 for k in ran},
                "stage_ms_mean": {
                    k: round(self._stage_s[k] / n * 1e3, 3) for k, n in ran.items()
                } if self._completed > 0 else None,
                "render_groups": self._render_groups,
                "composite_groups": self._composite_n,
                "composite_device_ms_total": self._composite_ms,
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
        group)."""
        return self._enqueue(
            self._stage_group,
            (tiles, rows, row_bytes, bpp, filter_mode, deflate_mode, staged),
            (list(lanes), list(sizes), bit_depth, color_type))

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

    def _enqueue(self, stage_fn, args, frame) -> "concurrent.futures.Future":
        """Queue ``stage_fn(*args)`` on the submit thread; ``frame`` is
        (lanes, sizes, bit depth, colour type) for the readback."""
        if self._closed:
            raise RuntimeError("device encode queue is closed")
        fut: "concurrent.futures.Future" = concurrent.futures.Future()
        with self._pending_lock:
            self._pending.add(fut)
        fut.add_done_callback(self._discard_pending)
        with self._stats_lock:
            self._groups += 1
        try:
            self._submit_pool.submit(self._run_stage, fut, stage_fn, args, frame)
        except RuntimeError as e:  # close() raced the check
            self._fail(fut, e)
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

    def _run_stage(self, fut, stage_fn, args, frame) -> None:
        """Submit thread: take an in-flight slot, stage + launch the first
        device work, chain the readback."""
        self._slots.acquire()
        with self._stats_lock:
            self._inflight += 1
        try:
            t0 = time.perf_counter()
            launched = stage_fn(*args)
            t_stage = time.perf_counter() - t0
            rfut = self._readback.submit(self._readback_group, t_stage, launched, *frame)
        except Exception as e:
            self._release_slot()
            self._fail(fut, e)
            return
        rfut.add_done_callback(lambda rf: self._finish_group(fut, rf))

    def _finish_group(self, fut, rfut) -> None:
        self._release_slot()
        exc = rfut.exception()
        if exc is not None:
            self._fail(fut, exc)
            return
        try:
            fut.set_result(rfut.result())
        except concurrent.futures.InvalidStateError:
            pass

    # -- the device work ---------------------------------------------------

    def _stage_group(self, tiles, rows, row_bytes, bpp, filter_mode, deflate_mode, staged):
        """Submit thread: H2D (bucket route), then on the side stream pass 1
        of a dynamic group or the whole chain of a one-pass group. Returns
        (mode, device tensors, the event that ends them, None)."""
        with self._on_stream():
            batch = tiles if staged else tiles.to(self.device, non_blocking=True)
            if deflate_mode == "dynamic":
                out = fused_filter_histogram_batch(
                    batch, rows, row_bytes, bpp, filter_mode=filter_mode,
                )
            else:
                out = fused_filter_deflate_batch(
                    batch, rows, row_bytes, bpp, filter_mode=filter_mode,
                    mode=deflate_mode, packer=self.packer,
                )
            return deflate_mode, out, self._mark(), None

    def _stage_render_group(self, planes, index_tables, color_luts, rows, row_bytes,
                            filter_mode, deflate_mode, mask, staged):
        """Submit thread: H2D of the planes and the mask (unless staged),
        then on the side stream the whole render chain. Returns (mode,
        device tensors, the event that ends them, the composite's timing
        events or None)."""
        packed = packed_rgb_tables(index_tables, color_luts)
        with self._on_stream():
            if staged:
                batch, mask_dev = planes, mask
            else:
                batch = planes.to(self.device, non_blocking=True)
                mask_dev = None if mask is None else mask.to(self.device, non_blocking=True)
            timing = None
            if self._stream is not None:
                timing = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            out = fused_render_filter_deflate_batch(
                batch, index_tables, color_luts, rows, row_bytes,
                filter_mode=filter_mode, mode=deflate_mode, packer=self.packer,
                mask=mask_dev, packed=packed, composite_events=timing,
            )
            return deflate_mode, out, self._mark(), timing

    def _readback_group(self, t_stage, launched, lanes, sizes, bit_depth, color_type):
        """Readback thread: wait for the group's device work (for a dynamic
        group: pull the counts, plan the tables and run pass 2), then pull
        and frame."""
        mode, tensors, ev, composite = launched
        t = [time.perf_counter()]

        def lap():
            t.append(time.perf_counter())
            return t[-1] - t[-2]

        self._wait(ev)
        timing = {"stage": t_stage}
        if mode == "dynamic":
            flat, counts, extras, real_b = tensors
            counts_np = counts.cpu().numpy()
            extras_np = extras.cpu().numpy()
            timing["pass1_wait"] = lap()
            tables = build_dynamic_tables(counts_np, extras_np, real=real_b)
            with self._on_stream():
                tables = tables_from_numpy(tables, flat.device)
                timing["plan"] = lap()
                streams, lengths = dynamic_emit(flat, tables, packer=self.packer)
                self._wait(self._mark())
            timing["pass2"] = lap()
            streams, lengths = streams[:real_b], lengths[:real_b]
        else:
            streams, lengths = tensors
            timing["compute"] = lap()
        streams_np, lengths_np = self._pull(streams, lengths, sizes[0])
        timing["pull"] = lap()
        out = {
            lane: frame_png(
                np.ascontiguousarray(streams_np[j, : int(lengths_np[j])]).tobytes(),
                sizes[j][0], sizes[j][1], bit_depth, color_type,
            )
            for j, lane in enumerate(lanes)
        }
        timing["frame"] = lap()
        composite_ms = composite[0].elapsed_time(composite[1]) if composite else None
        with self._stats_lock:
            for k, v in timing.items():
                self._stage_s[k] += v
                self._stage_n[k] += 1
            if composite_ms is not None:
                self._composite_ms += composite_ms
                self._composite_n += 1
            self._lanes += len(lanes)
            self._completed += 1
        return out

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
