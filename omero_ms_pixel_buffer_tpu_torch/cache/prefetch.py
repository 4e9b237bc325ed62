"""Viewport prefetcher: predict the pan, warm the cache (counterpart of
``omero_ms_pixel_buffer_tpu/cache/prefetch.py``).

A viewer panning a slide requests tiles along a trajectory; the next
few tiles are highly predictable from the last two. This watcher
observes the per-session access stream and, when a stream shows
motion, enqueues the continuation tiles (plus the perpendicular
neighbors of the next step, and the next-zoom tile under the viewport
center) for background rendering through the SAME miss path real
requests use — so a warmed tile lands in the result cache with its
ETag, and the pipeline's own caches (decoded-block cache, device
plane cache) warm as a side effect.

Prefetch is strictly lower-class traffic:

- the queue is bounded and *drops* when full (never backpressures a
  real request);
- before issuing, the worker consults admission control's headroom —
  under load, prefetch is the FIRST thing shed (a real request sheds
  only at ``max_inflight``; prefetch already sheds at
  ``headroom_fraction`` of it);
- each prefetch carries a short deadline so a slow store can't park
  the worker;
- results nobody ever views just age out of probation (the SLRU's
  scan resistance keeps speculative tiles from displacing the real
  working set).

Failures are expected (predictions can fall off the image edge ->
404) and are counted, never logged as errors.
"""

from __future__ import annotations

import asyncio
import logging
import threading
from collections import OrderedDict
from typing import Awaitable, Callable, List, Optional, Tuple

from ..resilience.deadline import Deadline
from ..resilience.scheduler import PRIORITY_PREFETCH
from ..tile_ctx import RegionDef, TileCtx
from ..utils.metrics import REGISTRY

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.prefetch")

PREFETCH = REGISTRY.counter(
    "tile_prefetch_total", "Prefetch predictions by outcome"
)

# fetch(ctx, content_key) -> None; provided by the HTTP app (goes
# through the coalesced bus path and fills the result cache)
FetchFn = Callable[[TileCtx, str], Awaitable[None]]


class _Stream:
    """Last two accesses of one (session, plane) stream."""

    __slots__ = ("x", "y", "dx", "dy")

    def __init__(self, x: int, y: int):
        self.x, self.y = x, y
        self.dx, self.dy = 0, 0


class ViewportPrefetcher:
    def __init__(
        self,
        fetch: FetchFn,
        cache,
        admission,
        quality: str = "",
        queue_size: int = 256,
        headroom_fraction: float = 0.5,
        budget_s: float = 2.0,
        lookahead: int = 2,
        viewport_span: int = 1,
        max_streams: int = 1024,
        extent_fn=None,
        sweep_detector=None,
    ):
        self._fetch = fetch
        self._cache = cache
        self._admission = admission
        self._quality = quality
        self.headroom_fraction = headroom_fraction
        self.budget_s = budget_s
        self.lookahead = lookahead
        # whole-viewport speculation: predict the full band of tiles
        # the moving viewport is about to expose — ``span``
        # perpendicular tiles each side of the trajectory at every
        # lookahead step — instead of a single continuation line.
        # Speculative lanes carry the viewport's burst geometry, so
        # the batcher fuses them into the SAME super-tile path real
        # bursts take, at prefetch priority. 0 keeps the linear
        # prediction (continuation + the nearest perpendicular pair
        # at the first step only).
        self.viewport_span = max(0, int(viewport_span))
        self._queue: "asyncio.Queue[Tuple[TileCtx, str]]" = asyncio.Queue(
            maxsize=queue_size
        )
        self._streams: "OrderedDict[tuple, _Stream]" = OrderedDict()
        self._max_streams = max_streams
        # viewport-true speculation: the session plane reports the real
        # viewport rectangle of (session, image) over the live channel;
        # when present it supersedes the fixed-width span band. Written
        # on the serving loop, dropped from the resolver's refresh thread
        # on invalidation, so it shares _extents_lock; bounded by
        # max_streams
        self._viewports: "OrderedDict[tuple, dict]" = OrderedDict()
        self._worker: Optional[asyncio.Task] = None
        # close-in-progress latch, checked by _run between items: the
        # fetch path bounds its wait with wait_for(shield(...)), and a
        # cancel that lands in the same tick the flight completes is
        # swallowed by wait_for's completion race (bpo-42130) — the
        # worker would sail back into queue.get() and close() would
        # await it forever
        self._closing = False
        # extent_fn(image_id, resolution) -> (size_x, size_y) | None:
        # a NON-BLOCKING cache peek (PixelsService.peek_extent) that
        # lets predictions prune against the plane bounds at
        # prediction time — an off-image guess dies in arithmetic here
        # instead of costing the pipeline a resolve and a 404
        self._extent_fn = extent_fn
        self._extents: "OrderedDict[tuple, tuple]" = OrderedDict()
        # invalidation arrives from the resolver's refresh thread
        self._extents_lock = threading.Lock()
        # the scheduler's SweepDetector (resilience/scheduler), when
        # SLO scheduling is on: a session demoted to the bulk class is
        # a robot sweep — its perfectly-predictable trajectory would
        # flood the prefetch queue with work the scheduler is trying
        # to deprioritize, so its streams don't predict at all
        self._sweep_detector = sweep_detector
        self._stats = {
            "observed": 0, "enqueued": 0, "warmed": 0, "shed": 0,
            "already_cached": 0, "dropped_queue_full": 0, "failed": 0,
            "pruned_off_image": 0, "suppressed_sweep": 0,
            "viewport_true": 0,
        }

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        if self._worker is None:
            self._worker = asyncio.get_running_loop().create_task(
                self._run()
            )

    async def close(self) -> None:
        if self._worker is not None:
            self._closing = True
            self._worker.cancel()
            try:
                await self._worker
            except asyncio.CancelledError:
                if not self._worker.cancelled():
                    raise
            self._worker = None

    # -- the access stream ---------------------------------------------

    def observe(self, ctx: TileCtx) -> None:
        """Feed one real access; may enqueue predictions. Cheap and
        non-blocking — called inline on the serving path for hits and
        misses alike (panning is mostly hits)."""
        self._stats["observed"] += 1
        r = ctx.region
        if r.width <= 0 or r.height <= 0:
            return  # full-plane defaulting request: no grid to predict
        if self._sweep_detector is not None and (
            self._sweep_detector.is_sweep(ctx.omero_session_key)
        ):
            self._stats["suppressed_sweep"] += 1
            return  # robot sweep: never warm ahead of bulk traffic
        stream_key = (
            ctx.omero_session_key, ctx.image_id, ctx.z, ctx.c, ctx.t,
            ctx.resolution, ctx.format,
            # render streams are their own motion streams, and their
            # predictions must warm RENDER cache keys — a raw /tile
            # pan and a /render pan over the same plane never mix
            None if ctx.render is None else ctx.render.signature(),
        )
        stream = self._streams.get(stream_key)
        if stream is None:
            stream = _Stream(r.x, r.y)
            self._streams[stream_key] = stream
            while len(self._streams) > self._max_streams:
                self._streams.popitem(last=False)
            return  # one point is not a direction
        self._streams.move_to_end(stream_key)
        dx, dy = r.x - stream.x, r.y - stream.y
        stream.x, stream.y, stream.dx, stream.dy = r.x, r.y, dx, dy
        for region, resolution in self._predict(ctx, dx, dy):
            self._enqueue(ctx, region, resolution)

    # -- viewport-true geometry ----------------------------------------

    def note_viewport(self, session_key: str, image_id: int, rect: dict) -> bool:
        """Record a session's reported viewport rectangle (``{"x", "y",
        "w", "h"}`` in level pixels, optional ``"zoom"`` = resolution
        level). Later predictions for that (session, image) cover the
        rectangle's trajectory instead of the span band. False on a
        nonsense rectangle (the session plane answers it 400)."""
        try:
            x, y = int(rect["x"]), int(rect["y"])
            w, h = int(rect["w"]), int(rect["h"])
        except (KeyError, TypeError, ValueError):
            return False
        if w <= 0 or h <= 0 or x < 0 or y < 0:
            return False
        zoom = rect.get("zoom")
        if zoom is not None:
            try:
                zoom = int(zoom)
            except (TypeError, ValueError):
                return False
        entry = {"x": x, "y": y, "w": w, "h": h, "zoom": zoom}
        key = (session_key, image_id)
        with self._extents_lock:
            self._viewports[key] = entry
            self._viewports.move_to_end(key)
            while len(self._viewports) > self._max_streams:
                self._viewports.popitem(last=False)
        return True

    def _viewport_for(self, ctx: TileCtx) -> Optional[dict]:
        with self._extents_lock:
            rect = self._viewports.get((ctx.omero_session_key, ctx.image_id))
        if rect is None:
            return None
        # a rectangle reported at another level is another pixel space:
        # it supersedes the band only when the levels agree (or the
        # client did not say)
        if rect["zoom"] is not None and ctx.resolution is not None \
                and rect["zoom"] != ctx.resolution:
            return None
        return rect

    def _extent(self, image_id: int, resolution) -> Optional[tuple]:
        """Memoized plane extent per (image, level); None = unknown
        (no pruning — the pipeline stays the backstop)."""
        if self._extent_fn is None:
            return None
        key = (image_id, resolution)
        with self._extents_lock:
            hit = self._extents.get(key)
        if hit is None:
            hit = self._extent_fn(image_id, resolution)
            if hit is not None:
                with self._extents_lock:
                    self._extents[key] = hit
                    while len(self._extents) > self._max_streams:
                        self._extents.popitem(last=False)
        return hit

    def _predict(
        self, ctx: TileCtx, dx: int, dy: int
    ) -> List[Tuple[RegionDef, Optional[int]]]:
        """Whole-viewport speculation: the full perpendicular
        BAND of tiles at every lookahead step along the motion vector
        (the rectangle the viewport is about to expose — spatially
        adjacent by construction, so the batcher fuses the band into
        one super-tile), plus the next-zoom tile under the new
        center. A viewport the session plane reported
        (``note_viewport``) replaces the band with the tiles its rectangle
        exposes. ``viewport_span=0`` degrades to the linear
        continuation + nearest perpendicular neighbors. Off-image
        predictions are pruned HERE with bounds math (the extent
        resolves from the open-buffer cache the stream's first tile
        populated); without a known extent the pipeline's 404 stays
        the backstop."""
        r = ctx.region
        out: List[Tuple[RegionDef, Optional[int]]] = []

        def add(x: int, y: int, w: int, h: int, res) -> None:
            if x < 0 or y < 0:
                return
            extent = self._extent(ctx.image_id, res)
            if extent is not None and (
                x + w > extent[0] or y + h > extent[1]
            ):
                self._stats["pruned_off_image"] += 1
                PREFETCH.inc(outcome="pruned_off_image")
                return
            out.append((RegionDef(x, y, w, h), res))

        if dx or dy:
            rect = self._viewport_for(ctx)
            if rect is not None:
                # viewport-true: the tiles the reported rectangle exposes
                # as it slides along the motion vector, on the tile grid,
                # at every lookahead step, at most 64 a step (a
                # pathological rectangle cannot flood the queue)
                self._stats["viewport_true"] += 1
                for i in range(1, self.lookahead + 1):
                    vx, vy = rect["x"] + dx * i, rect["y"] + dy * i
                    col0 = max(0, vx) // r.width
                    col1 = max(0, vx + rect["w"] - 1) // r.width
                    row0 = max(0, vy) // r.height
                    row1 = max(0, vy + rect["h"] - 1) // r.height
                    budget = 64
                    for row in range(row0, row1 + 1):
                        for col in range(col0, col1 + 1):
                            if budget <= 0:
                                break
                            budget -= 1
                            add(col * r.width, row * r.height, r.width, r.height,
                                ctx.resolution)
                        if budget <= 0:
                            break
            else:
                span = self.viewport_span
                for i in range(1, self.lookahead + 1):
                    nx, ny = r.x + dx * i, r.y + dy * i
                    add(nx, ny, r.width, r.height, ctx.resolution)
                    # the perpendicular band at this step: the
                    # viewport is taller/wider than one tile, so the
                    # pan exposes a whole row/column, not a line of
                    # single tiles
                    offs = (
                        range(1, span + 1) if span
                        else ((1,) if i == 1 else ())
                    )
                    for k in offs:
                        if dx == 0:
                            add(nx - k * r.width, ny, r.width, r.height,
                                ctx.resolution)
                            add(nx + k * r.width, ny, r.width, r.height,
                                ctx.resolution)
                        else:
                            add(nx, ny - k * r.height, r.width, r.height,
                                ctx.resolution)
                            add(nx, ny + k * r.height, r.width, r.height,
                                ctx.resolution)
        if ctx.resolution is not None and ctx.resolution > 0:
            # zoom-in prediction: the finer level's tile under this
            # tile's center (OMERO levels halve per step), aligned to
            # the tile grid
            cx = (r.x + r.width // 2) * 2
            cy = (r.y + r.height // 2) * 2
            add((cx // r.width) * r.width, (cy // r.height) * r.height,
                r.width, r.height, ctx.resolution - 1)
        return out

    @staticmethod
    def _burst_hint(origin: TileCtx):
        """Synthesized grid geometry for native-grammar pans: the
        origin tile's own (w, h) IS the pan's grid pitch when the
        viewer requests grid-aligned tiles; off-grid predictions just
        fall back to the batcher's pairwise adjacency sweep."""
        from ..render.supertile import BurstHint

        r = origin.region
        if r.width > 0 and r.height > 0:
            return BurstHint(r.width, r.height)
        return None

    def _enqueue(
        self, origin: TileCtx, region: RegionDef, resolution
    ) -> None:
        ctx = TileCtx(
            image_id=origin.image_id, z=origin.z, c=origin.c,
            t=origin.t, region=region, resolution=resolution,
            format=origin.format,
            omero_session_key=origin.omero_session_key,
            render=origin.render,
            # speculative work is second-class end to end: the
            # batcher's deadline queue orders prefetch lanes behind
            # every interactive lane of the same flush
            priority=PRIORITY_PREFETCH,
            # speculative lanes share the origin's burst geometry (or
            # synthesize it from the tile grid), so a predicted band
            # fuses into the SAME super-tile path a real burst takes
            burst=origin.burst or self._burst_hint(origin),
        )
        key = ctx.cache_key(self._quality)
        if self._cache is not None and self._cache.contains(key):
            self._stats["already_cached"] += 1
            return
        try:
            self._queue.put_nowait((ctx, key))
            self._stats["enqueued"] += 1
        except asyncio.QueueFull:
            self._stats["dropped_queue_full"] += 1
            PREFETCH.inc(outcome="dropped_queue_full")

    def invalidate_image(self, image_id: int) -> None:
        """Metadata-change hook: drop memoized extents (a re-imported
        image can change size; a stale extent would mis-prune) and the
        image's reported viewports. Called from the resolver's refresh
        thread."""
        with self._extents_lock:
            for key in [k for k in self._extents if k[0] == image_id]:
                del self._extents[key]
            for key in [k for k in self._viewports if k[1] == image_id]:
                del self._viewports[key]

    # -- the low-priority worker ---------------------------------------

    async def _run(self) -> None:
        # the latch (not while True) so a cancel swallowed inside
        # _fetch's bounded wait still terminates the worker at the
        # top of the loop instead of re-entering queue.get()
        while not self._closing:
            ctx, key = await self._queue.get()
            if not self._admission.has_headroom(self.headroom_fraction):
                # the service is busy with real traffic: speculative
                # work is the first thing to go
                self._stats["shed"] += 1
                PREFETCH.inc(outcome="shed")
                continue
            if self._cache is not None and self._cache.contains(key):
                self._stats["already_cached"] += 1
                PREFETCH.inc(outcome="already_cached")
                continue
            ctx.deadline = Deadline.after(self.budget_s)
            try:
                await self._fetch(ctx, key)
                self._stats["warmed"] += 1
                PREFETCH.inc(outcome="warmed")
            except asyncio.CancelledError:
                raise
            except Exception:
                # expected: off-image predictions 404, busy pipelines
                # 503/504 — speculative work never logs above debug
                self._stats["failed"] += 1
                PREFETCH.inc(outcome="failed")
                log.debug("prefetch failed for %s", key, exc_info=True)

    # -- observability -------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "enabled": True,
            "queued": self._queue.qsize(),
            **self._stats,
        }
