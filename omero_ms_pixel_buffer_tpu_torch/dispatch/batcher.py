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

Failure codes: pipeline None -> 404 "Cannot find Image:<id>"; a typed
``TileError`` result (a failed encode group is a 500, a projection over
budget a 413) passes through;
an expired deadline -> 504; a full queue or a crashed batch -> 500.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import os
from typing import List, Optional, Set, Tuple

from ..errors import GatewayTimeoutError, InternalError, NotFoundError, TileError
from ..models.tile_pipeline import DeferredTile, TilePipeline
from ..render.supertile import assign_supertiles
from ..tile_ctx import TileCtx

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.batcher")

# the JAX package's defaults (backend.batching): lanes per batch, the
# coalesce window, the queue bound, and batches in flight (2 x CPUs, the
# reference's worker-pool size)
MAX_BATCH = 32
COALESCE_WINDOW_S = 0.002
MAX_QUEUE = 4096
WORKERS = 2 * (os.cpu_count() or 1)


class BatchingTileWorker:
    """Coalesces concurrent get-tile requests into batched pipeline
    calls."""

    def __init__(self, pipeline: TilePipeline, supertile: bool = True):
        self.pipeline = pipeline
        # adjacency bucketing of render lanes; False keeps every lane on
        # the independent path
        self.supertile = supertile
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=MAX_QUEUE)
        self._runner: Optional[asyncio.Task] = None
        self._inflight: Set[asyncio.Task] = set()
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=WORKERS, thread_name_prefix="pixel-buffer-pool"
        )
        self._closed = False
        self.batches = 0
        self.lanes = 0
        self.lone = 0  # batches of one lane, served by ``pipeline.handle``
        self.stamped = 0  # lanes given a super-tile stamp

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
                "queued": self._queue.qsize()}

    async def handle(self, ctx: TileCtx) -> Tuple[bytes, dict]:
        """Enqueue one request and await its lane's result."""
        if ctx.expired:
            raise GatewayTimeoutError()
        if self._closed:
            raise InternalError("Service shutting down")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        try:
            self._queue.put_nowait((ctx, fut))
        except asyncio.QueueFull:
            raise InternalError("Tile queue overflow") from None
        left = ctx.remaining()
        try:
            tile = await (fut if left is None else asyncio.wait_for(fut, left))
        except asyncio.TimeoutError:
            raise GatewayTimeoutError() from None
        if tile is None:
            if ctx.expired:
                raise GatewayTimeoutError()
            raise NotFoundError(f"Cannot find Image:{ctx.image_id}")
        return tile, {"filename": ctx.filename()}

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        sem = asyncio.Semaphore(WORKERS)
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
        """Grow ``batch`` in place until the window closes, then hand it
        to an executor task."""
        stop = loop.time() + COALESCE_WINDOW_S
        while len(batch) < MAX_BATCH:
            remaining = stop - loop.time()
            if remaining <= 0:
                break
            try:
                batch.append(await asyncio.wait_for(self._queue.get(), remaining))
            except asyncio.TimeoutError:
                break
        live = []
        for c, f in batch:
            if f.done():
                continue  # the client gave up
            if c.expired:
                f.set_exception(GatewayTimeoutError())
                continue
            live.append((c, f))
        if not live:
            return
        await sem.acquire()
        task = asyncio.create_task(self._execute(live, loop))
        self._inflight.add(task)
        task.add_done_callback(lambda t: (self._inflight.discard(t), sem.release()))

    async def _execute(self, batch: List[Tuple[TileCtx, asyncio.Future]], loop) -> None:
        canonical: List[Tuple[TileCtx, asyncio.Future]] = []
        followers: dict = {}
        seen: dict = {}
        for c, f in batch:
            k = c.lane_key()
            if k in seen:
                followers.setdefault(seen[k], []).append((c, f))
            else:
                seen[k] = len(canonical)
                canonical.append((c, f))
        ctxs = [c for c, _ in canonical]
        self.batches += 1
        self.lanes += len(ctxs)
        if len(ctxs) >= 2 and self.supertile:
            try:
                self.stamped += assign_supertiles(ctxs)
            except Exception:
                log.exception("super-tile bucketing failed; lanes serve independently")
        if len(ctxs) == 1 and ctxs[0].render is None and ctxs[0].analysis is None:
            self.lone += 1
            work = lambda: [self.pipeline.handle(ctxs[0])]  # noqa: E731
        else:
            work = lambda: self.pipeline.handle_batch(ctxs, defer=True)  # noqa: E731
        try:
            results = await loop.run_in_executor(self._executor, work)
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
            if isinstance(result, DeferredTile):
                self._chain_deferred(loop, result, [lf for _, lf in lanes])
                continue
            for _, lane_fut in lanes:
                if lane_fut.done():
                    continue
                if isinstance(result, TileError):
                    lane_fut.set_exception(result)
                else:
                    lane_fut.set_result(result)

    @staticmethod
    def _chain_deferred(loop, deferred: DeferredTile, futs) -> None:
        def on_done(cfut):
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
