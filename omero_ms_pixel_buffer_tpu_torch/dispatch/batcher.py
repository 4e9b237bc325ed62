"""Coalescing tile worker (counterpart of ``BatchingTileWorker`` in
``omero_ms_pixel_buffer_tpu/dispatch/batcher.py``).

Concurrent requests accumulate for up to 2 ms (or until 32 lanes) and
run as ONE ``TilePipeline.handle_batch`` call on an executor thread; up
to 2 x CPUs batches run at once. Lanes equal under ``TileCtx.lane_key``
execute once (the render and histogram signatures are part of that key,
so two renderings of one region never merge). With super-tiles enabled
(on by default, as in the JAX package), every batch of two or more lanes
goes through ``assign_supertiles`` first: adjacent render lanes get a
shared stamp, which the pipeline serves as one composite and per-lane
carves; a bucketing failure is logged and costs only the fusion. A batch of one ``/tile`` lane (after that dedupe) takes
the single-request path ``TilePipeline.handle`` (host read and encode), as
the JAX package's batcher does; a batch of one render or histogram lane
takes ``handle_batch``, as the JAX ``handle`` sends it there. Lanes whose
encode group is still in flight come back deferred and are delivered from
the encode queue's callback, so a batch's slot frees before its slowest
group.

The intake is a ``DeadlineQueue`` (``resilience/scheduler.py``): lanes
pop in (deadline, class) order, so a batch gathers the lanes due soonest.
Burst continuation (the JAX ``backend.batching.burst-continuation``, on by
default): when the lanes a window caught share a burst identity (image,
level, plane, format, render signature, the adapter's ``BurstHint`` grid
and session: ``_burst_key``) twice or more, or match the burst the
previous batch dispatched within ``BURST_WINDOW_MS``, the window extends
by up to ``BURST_WINDOW_MS`` (at most half the tightest lane's remaining
budget) so a zoom's stragglers join this batch; ``burst_continuations``
counts the extensions. Each batch's executor work runs with the latest
lane deadline ambient (``deadline_scope``), so store retries and the
fetch planner stop once no lane can use their result, and with its first
lane's flight record ambient (``record_scope``), so exemplars deep in the
pipeline and the encode queue name a trace. Each lane's record is stamped
``batch_wait`` (enqueue to batch execution) and tagged ``batch_size``,
and gets ``ready_at`` on the worker thread where its answer came to exist
(the executor's return; for a deferred lane, its group's resolution on
the readback thread); ``handle`` observes the time from there to its
resumption as ``request_handoff_seconds``, the answer's wait for the
serving loop.
Served tiles, batch sizes, deduplicated lanes, dispatched batches and
burst continuations go to ``/metrics`` under the JAX names.

The knobs default to the JAX ``backend.batching`` and ``supertile``
defaults (``MAX_BATCH``, ``COALESCE_WINDOW_MS``, ``BURST_WINDOW_MS``, 2 x
CPUs batches: the JAX ``worker_pool_size``); the config wiring passes the
YAML values. Given a ``SessionValidator`` (the config wiring always gives
one: the Glacier2 join, or the allow-list that accepts every key the
session store resolved), ``handle`` validates the lane's OMERO session
before it queues, as the JAX batcher does: a refusal is 403.

Failure codes: pipeline None -> 404 "Cannot find Image:<id>"; a typed
``TileError`` result (a failed encode group is a 500, a projection over
budget a 413) passes through; an expired deadline -> 504 (counted by the
stage that noticed it, ``resilience/deadline.py``); a full queue or a
crashed batch -> 500. A lane served from a coarser level answers with
``degraded`` in its reply headers.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextvars
import logging
import os
import threading
import time
from typing import List, Optional, Set, Tuple

from ..auth.validator import SessionValidator
from ..errors import (
    GatewayTimeoutError,
    InternalError,
    NotFoundError,
    PermissionDeniedError,
    TileError,
)
from ..models.tile_pipeline import DeferredTile, TilePipeline
from ..obs.recorder import REQUEST_HANDOFF_SECONDS, record_scope
from ..render.supertile import MAX_PIXELS, MIN_COVERAGE, MIN_LANES, assign_supertiles
from ..resilience.deadline import deadline_scope, note_exceeded
from ..resilience.scheduler import DeadlineQueue
from ..tile_ctx import TileCtx
from ..utils.metrics import REGISTRY

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.batcher")

# the JAX package's defaults (backend.batching): lanes per batch, the
# coalesce window, the burst-continuation window, the queue bound, and
# batches in flight (2 x CPUs, the reference's worker-pool size)
MAX_BATCH = 32
COALESCE_WINDOW_MS = 2.0
BURST_WINDOW_MS = 25.0
MAX_QUEUE = 4096
WORKERS = 2 * (os.cpu_count() or 1)

TILES_SERVED = REGISTRY.counter("tiles_served_total", "Tiles served by format")
BATCH_SIZE = REGISTRY.histogram(
    "tile_batch_size", "Lanes per coalesced batch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, float("inf")),
)
LANES_DEDUPED = REGISTRY.counter(
    "tile_batch_deduped_lanes_total",
    "Batch lanes that shared another identical lane's execution",
)
BATCHES_DISPATCHED = REGISTRY.counter(
    "tile_batches_dispatched_total",
    "Coalesced batches handed to the executor (device programs proxy)",
)
BURST_CONTINUATIONS = REGISTRY.counter(
    "tile_batch_burst_continuations_total",
    "Coalesce windows extended by burst-continuation affinity",
)


class BatchingTileWorker:
    """Coalesces concurrent get-tile requests into batched pipeline
    calls."""

    def __init__(self, pipeline: TilePipeline, supertile: bool = True,
                 session_validator: Optional[SessionValidator] = None,
                 max_batch: Optional[int] = None, coalesce_window_ms: Optional[float] = None,
                 workers: Optional[int] = None, burst_continuation: bool = True,
                 burst_window_ms: Optional[float] = None,
                 supertile_limits: Tuple[int, int, float] = (MAX_PIXELS, MIN_LANES,
                                                             MIN_COVERAGE)):
        self.pipeline = pipeline
        # None: no check here (a front that resolved the session itself)
        self.session_validator = session_validator
        # None takes the module default as it stands now
        self.max_batch = max(1, int(MAX_BATCH if max_batch is None else max_batch))
        self.coalesce_window_s = (COALESCE_WINDOW_MS if coalesce_window_ms is None
                                  else coalesce_window_ms) / 1000.0
        self.workers = max(1, int(WORKERS if workers is None else workers))
        self.burst_window_s = 0.0 if not burst_continuation else (
            BURST_WINDOW_MS if burst_window_ms is None else burst_window_ms) / 1000.0
        # adjacency bucketing of render lanes; False keeps every lane on
        # the independent path; the limits are (max pixels, min lanes,
        # min coverage), the JAX supertile: keys
        self.supertile = supertile
        self.supertile_limits = tuple(supertile_limits)
        # (burst key, loop time) of the last dispatched batch's dominant
        # burst: the carry across windows
        self._last_burst: Optional[Tuple[tuple, float]] = None
        self._queue = DeadlineQueue(maxsize=MAX_QUEUE)
        self._runner: Optional[asyncio.Task] = None
        self._inflight: Set[asyncio.Task] = set()
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.workers, thread_name_prefix="pixel-buffer-pool"
        )
        self._closed = False
        self.batches = 0
        self.lanes = 0
        self.lone = 0  # batches of one lane, served by ``pipeline.handle``
        self.stamped = 0  # lanes given a super-tile stamp
        self.burst_continuations = 0  # windows extended by a burst

    async def start(self) -> None:
        if self._runner is None:
            self._runner = asyncio.create_task(self._run())

    async def close(self) -> None:
        self._closed = True
        if self._runner is not None:
            self._runner.cancel()
            try:
                await self._runner
            except asyncio.CancelledError:
                if not self._runner.cancelled():
                    raise
            self._runner = None
        while not self._queue.empty():
            _, fut = self._queue.get_nowait()
            if not fut.done():
                fut.set_exception(InternalError("Service shutting down"))
        if self._inflight:
            await asyncio.gather(*self._inflight, return_exceptions=True)
        self._executor.shutdown(wait=False)

    def snapshot(self) -> dict:
        return {"batches": self.batches, "lanes": self.lanes, "lone": self.lone,
                "queued": self._queue.qsize(),
                "burst_continuations": self.burst_continuations}

    async def handle(self, ctx: TileCtx) -> Tuple[bytes, dict]:
        """Enqueue one request and await its lane's result: (body,
        {"filename", and "degraded" when the lane came from a coarser
        level})."""
        if (self.session_validator is not None
                and not await self.session_validator.validate(ctx.omero_session_key)):
            raise PermissionDeniedError()
        if ctx.expired:
            note_exceeded("admission")
            raise GatewayTimeoutError()
        if self._closed:
            raise InternalError("Service shutting down")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        rec = ctx.obs
        if rec is not None:
            rec.enqueued_at = time.perf_counter()  # batch_wait starts
        try:
            self._queue.put_nowait((ctx, fut))
        except asyncio.QueueFull:
            raise InternalError("Tile queue overflow") from None
        try:
            tile = await (fut if ctx.deadline is None
                          else asyncio.wait_for(fut, ctx.deadline.remaining()))
        except asyncio.TimeoutError:
            note_exceeded("bus")
            raise GatewayTimeoutError() from None
        if rec is not None and rec.ready_at is not None:
            REQUEST_HANDOFF_SECONDS.observe(time.perf_counter() - rec.ready_at)
        if tile is None:
            if ctx.expired:
                note_exceeded("pipeline")
                raise GatewayTimeoutError()
            raise NotFoundError(f"Cannot find Image:{ctx.image_id}")
        TILES_SERVED.inc(format=ctx.format or "raw")
        meta = {"filename": ctx.filename()}
        if ctx.degraded:
            # the lane's final state: the pipeline clears the flag when no
            # coarser level exists
            meta["degraded"] = str(ctx.degraded)
        return tile, meta

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        sem = asyncio.Semaphore(self.workers)
        while not self._closed:
            batch = [await self._queue.get()]
            try:
                await self._coalesce_and_dispatch(batch, loop, sem)
            except asyncio.CancelledError:
                for _, f in batch:
                    if not f.done():
                        f.set_exception(InternalError("Service shutting down"))
                raise

    async def _coalesce_and_dispatch(self, batch, loop, sem) -> None:
        """Grow ``batch`` in place until the window closes (extended once
        for a burst), then hand it to an executor task."""
        await self._gather(batch, loop, self.coalesce_window_s)
        ext = self._burst_extension(batch, loop)
        if ext is not None:
            self.burst_continuations += 1
            BURST_CONTINUATIONS.inc()
            await self._gather(batch, loop, ext)  # other lanes ride along
        live = []
        for c, f in batch:
            if f.done():
                continue  # the client gave up
            if c.expired:
                note_exceeded("dispatch")
                f.set_exception(GatewayTimeoutError())
                continue
            live.append((c, f))
        if not live:
            return
        await sem.acquire()
        task = asyncio.create_task(self._execute(live, loop))
        self._inflight.add(task)
        task.add_done_callback(lambda t: (self._inflight.discard(t), sem.release()))
        BATCHES_DISPATCHED.inc()
        dominant = self._dominant_burst(live)
        if dominant is not None:
            self._last_burst = (dominant[0], loop.time())

    async def _gather(self, batch, loop, seconds: float) -> None:
        """Append queued lanes to ``batch`` for up to ``seconds``, or until
        it holds ``max_batch``."""
        stop = loop.time() + seconds
        while len(batch) < self.max_batch:
            remaining = stop - loop.time()
            if remaining <= 0:
                break
            try:
                batch.append(await asyncio.wait_for(self._queue.get(), remaining))
            except asyncio.TimeoutError:
                break

    @staticmethod
    def _burst_key(ctx) -> Optional[tuple]:
        """A lane's burst identity; None for lanes that are not render
        lanes with a burst hint (they never extend a window)."""
        burst = ctx.burst
        if burst is None or ctx.render is None:
            return None
        return (ctx.image_id, ctx.resolution, ctx.z, ctx.t, ctx.format,
                ctx.render.signature(), (burst.tile_w, burst.tile_h), ctx.omero_session_key)

    @classmethod
    def _dominant_burst(cls, batch) -> Optional[Tuple[tuple, int]]:
        """The burst key most lanes of ``batch`` share, and how many."""
        counts: dict = {}
        for c, _ in batch:
            k = cls._burst_key(c)
            if k is not None:
                counts[k] = counts.get(k, 0) + 1
        if not counts:
            return None
        key = max(counts, key=counts.get)
        return key, counts[key]

    def _burst_extension(self, batch, loop) -> Optional[float]:
        """Seconds of extra coalescing the batch's burst earns, or None: a
        full batch, no burst key held by two lanes or carried from the last
        dispatch within the window, or a deadline bound that leaves
        nothing. The extension is the window, capped at half the tightest
        lane's remaining budget."""
        window = self.burst_window_s
        if window <= 0 or len(batch) >= self.max_batch:
            return None
        dominant = self._dominant_burst(batch)
        if dominant is None:
            return None
        key, n = dominant
        carried = (self._last_burst is not None and self._last_burst[0] == key
                   and loop.time() - self._last_burst[1] <= window)
        if n < 2 and not carried:
            return None
        extra = window
        remains = [c.deadline.remaining() for c, _ in batch if c.deadline is not None]
        if remains:
            extra = min(extra, max(0.0, min(remains)) * 0.5)
        return extra if extra > 0 else None

    async def _execute(self, batch: List[Tuple[TileCtx, asyncio.Future]], loop) -> None:
        BATCH_SIZE.observe(len(batch))
        t_exec = time.perf_counter()
        for c, _ in batch:
            rec = c.obs
            if rec is not None and rec.enqueued_at is not None:
                rec.stamp("batch_wait", t_exec - rec.enqueued_at)
                rec.tag("batch_size", len(batch))
        canonical: List[Tuple[TileCtx, asyncio.Future]] = []
        followers: dict = {}
        seen: dict = {}
        for c, f in batch:
            k = c.lane_key()
            if k in seen:
                followers.setdefault(seen[k], []).append((c, f))
                LANES_DEDUPED.inc()
            else:
                seen[k] = len(canonical)
                canonical.append((c, f))
        ctxs = [c for c, _ in canonical]
        self.batches += 1
        self.lanes += len(ctxs)
        if len(ctxs) >= 2 and self.supertile:
            try:
                max_pixels, min_lanes, min_coverage = self.supertile_limits
                self.stamped += assign_supertiles(ctxs, max_pixels=max_pixels,
                                                  min_lanes=min_lanes,
                                                  min_coverage=min_coverage)
            except Exception:
                log.exception("super-tile bucketing failed; lanes serve independently")
        if len(ctxs) == 1 and ctxs[0].render is None and ctxs[0].analysis is None:
            self.lone += 1
            work = lambda: [self.pipeline.handle(ctxs[0])]  # noqa: E731
        else:
            work = lambda: self.pipeline.handle_batch(ctxs, defer=True)  # noqa: E731
        # the latest lane budget is ambient for the executor work: store
        # retries stop once no lane can use the result (a lane without a
        # deadline leaves the batch unbounded)
        deadlines = [c.deadline for c in ctxs]
        batch_deadline = (max(deadlines, key=lambda d: d.expires_at)
                          if all(d is not None for d in deadlines) else None)
        lead_rec = next((c.obs for c in ctxs if c.obs is not None), None)
        with deadline_scope(batch_deadline), record_scope(lead_rec):
            run_ctx = contextvars.copy_context()
        recs = [c.obs for c, _ in batch if c.obs is not None]

        def run():
            out = run_ctx.run(work)
            t_ready = time.perf_counter()
            for rec in recs:
                rec.ready_at = t_ready
            return out

        try:
            results = await loop.run_in_executor(self._executor, run)
        except Exception:
            log.exception("batch execution failed")
            for _, f in batch:
                if not f.done():
                    f.set_exception(InternalError())
            return
        for i, ((ctx, f), result) in enumerate(zip(canonical, results)):
            lanes = [(ctx, f)] + followers.get(i, [])
            for lane_ctx, _ in lanes[1:]:
                lane_ctx.region = ctx.region  # resolved w/h for the filename
                lane_ctx.degraded = ctx.degraded
            if isinstance(result, DeferredTile):
                self._chain_deferred(loop, result, lanes)
                continue
            for _, lane_fut in lanes:
                if lane_fut.done():
                    continue
                if isinstance(result, TileError):
                    lane_fut.set_exception(result)
                else:
                    lane_fut.set_result(result)

    @staticmethod
    def _chain_deferred(loop, deferred: DeferredTile, lanes) -> None:
        """Deliver a deferred lane's answer to its lanes' futures on the
        loop. A group that resolves after the batch came back stamps
        ``ready_at`` on the readback thread; one already resolved keeps
        the batch's stamp (its callback runs here, on the loop)."""
        futs = [f for _, f in lanes]
        recs = [c.obs for c, _ in lanes if c.obs is not None]
        loop_thread = threading.get_ident()

        def on_done(cfut):
            if threading.get_ident() != loop_thread:
                t_ready = time.perf_counter()
                for rec in recs:
                    rec.ready_at = t_ready

            def deliver():
                exc = cfut.exception()
                for lane_fut in futs:
                    if lane_fut.done():
                        continue
                    if exc is not None:
                        lane_fut.set_exception(
                            exc if isinstance(exc, TileError) else InternalError()
                        )
                    else:
                        lane_fut.set_result(cfut.result())
            try:
                loop.call_soon_threadsafe(deliver)
            except RuntimeError:
                pass  # loop closed mid-shutdown
        deferred.future.add_done_callback(on_done)
