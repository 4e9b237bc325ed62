"""The tile pipeline (counterpart of ``TilePipeline`` in
``omero_ms_pixel_buffer_tpu/models/tile_pipeline.py``; raw, PNG and TIFF
lanes on the device engine, PNG with device deflate in any of its modes).

    resolve (metadata, buffer, level, region) -> plane-cache staging ->
    batched host reads -> PNG lanes padded into shape buckets ->
    streaming encode queue -> PNG bytes

Bucket padding: PNG filters only look up and left, so zero padding on
the right and bottom leaves the real region's filtered bytes unchanged;
each (bucket, dtype) group encodes in one queue submission per real
(w, h). Lanes on a plane that is resident on the device skip the host
read: the plane route crops them on the device.

Two host routes give the JAX package's host bytes where it takes them:
``handle`` (a single request: the batcher's batch of one) reads and
encodes on the host with ``ops/png.encode_png`` (Python zlib), and a PNG
lane larger than every bucket goes to ``_host_png_lanes``: the native
engine's fused encode when ``runtime/native`` builds and loads, else
``encode_png``. The device path has no host encoder behind it: a failed
encode group answers 500 for its lanes. A ``tif`` lane is its host-read
tile framed by ``ops/tiff.encode_tiff`` (no pixel work, as in the JAX
package); other formats answer None (404).
"""

from __future__ import annotations

import concurrent.futures
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..errors import InternalError
from ..io.pixels_service import PixelsService
from ..ops.convert import bits_tensor, to_big_endian_bytes_np
from ..ops.crop import resolve_region
from ..ops.device_deflate import DEFLATE_MODES
from ..ops.png import (
    _PNG_DTYPES,
    PNG_FILTER,
    PNG_LEVEL,
    PNG_STRATEGY,
    PngEncodeError,
    encode_png,
)
from ..ops.tiff import TiffEncodeError, encode_tiff
from ..runtime.device import resolve_device
from ..runtime.native import get_engine
from ..tile_ctx import TileCtx
from .device_cache import DevicePlaneCache
from .device_dispatch import DeviceEncodeDispatcher

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.pipeline")

# allocation guard: a w/h=0 request on a huge plane must not materialize
# more than this (the JAX package's backend.max-tile-mb default)
MAX_TILE_BYTES = 256 << 20


class ResolvedTile:
    """A ctx bound to its image: metadata, buffer, level, region."""

    __slots__ = ("ctx", "meta", "buffer", "level", "x", "y", "w", "h")

    def __init__(self, ctx, meta, buffer, level, x, y, w, h):
        self.ctx, self.meta, self.buffer = ctx, meta, buffer
        self.level, self.x, self.y, self.w, self.h = level, x, y, w, h


class DeferredTile:
    """A lane whose encode group is still in flight when
    ``handle_batch(..., defer=True)`` returns; ``future`` resolves to
    the PNG bytes, or raises when the group failed."""

    __slots__ = ("future",)

    def __init__(self, future: "concurrent.futures.Future"):
        self.future = future


class TilePipeline:
    """Device engine: every PNG lane is Up-filtered and deflated on
    ``device`` (default ``cuda``; raises without a GPU) in
    ``device_deflate_mode`` (``dynamic``, the JAX package's default,
    ``rle`` or ``stored``: the YAML key ``backend.png.device-deflate-mode``)
    with the bit packer ``packer`` (default
    ``device_deflate.default_packer``). Only tests pass ``device="cpu"``,
    which runs the kernels' plain versions."""

    engine = "device"

    def __init__(
        self,
        pixels_service: PixelsService,
        buckets: Sequence[int] = (256, 512, 1024),
        queue_depth: int = 2,
        device="cuda",
        device_deflate_mode: str = "dynamic",
        packer: Optional[str] = None,
    ):
        if device_deflate_mode not in DEFLATE_MODES:
            raise ValueError(f"Unknown device deflate mode: {device_deflate_mode}")
        self.device_deflate_mode = device_deflate_mode
        self.device = resolve_device(device)
        self.pixels_service = pixels_service
        self.buckets = tuple(sorted(buckets))
        self.plane_cache = DevicePlaneCache(self.device)
        self.dispatcher = DeviceEncodeDispatcher(
            self.device, queue_depth=queue_depth, packer=packer)
        self.host_png_lanes = 0  # lanes larger than every bucket, host-encoded

    def close(self) -> None:
        self.dispatcher.close()

    def plane_cache_snapshot(self) -> dict:
        return self.plane_cache.snapshot()

    def device_queue_snapshot(self) -> dict:
        return {"deflate_mode": self.device_deflate_mode, **self.dispatcher.snapshot()}

    def encode_signature(self) -> str:
        """The 'quality' part of the result-cache key: the PNG encode
        policy the bytes depend on."""
        return f"{PNG_FILTER}.{PNG_LEVEL}.{PNG_STRATEGY}"

    # -- resolve / read ----------------------------------------------------

    def resolve(self, ctx: TileCtx) -> Optional[ResolvedTile]:
        """Metadata + buffer + region. None when the image is unknown;
        raises ValueError on invalid coordinates (-> 404)."""
        buffer = self.pixels_service.get_pixel_buffer(ctx.image_id)
        if buffer is None:
            log.debug("Cannot find Image:%s", ctx.image_id)
            return None
        level = 0
        if ctx.resolution is not None:
            if not 0 <= ctx.resolution < buffer.resolution_levels:
                raise ValueError(f"Resolution level {ctx.resolution} out of range")
            level = ctx.resolution
        size_x, size_y = buffer.level_size(level)
        x, y, w, h = resolve_region(ctx.region, size_x, size_y)
        if w * h * buffer.meta.bytes_per_pixel > MAX_TILE_BYTES:
            raise ValueError(f"Tile {w}x{h} exceeds max-tile-bytes ({MAX_TILE_BYTES})")
        # the resolved region flows back into the ctx (filename header)
        ctx.region.x, ctx.region.y = x, y
        ctx.region.width, ctx.region.height = w, h
        return ResolvedTile(ctx, buffer.meta, buffer, level, x, y, w, h)

    def _bucket(self, w: int, h: int) -> Optional[Tuple[int, int]]:
        """Smallest bucket covering (w, h); None when none does."""
        for b in self.buckets:
            if w <= b and h <= b:
                return (b, b)
        return None

    # -- single-request path ----------------------------------------------

    def handle(self, ctx: TileCtx) -> Optional[bytes]:
        """One request on the host: resolve, read, encode. Bytes, or None
        (-> 404) on any failure, as the JAX package's ``handle``."""
        try:
            rt = self.resolve(ctx)
            if rt is None:
                return None
            tile = rt.buffer.get_tile_at(rt.level, ctx.z, ctx.c, ctx.t, rt.x, rt.y, rt.w, rt.h)
            return self.encode(ctx, tile)
        except Exception:
            log.exception("Exception while retrieving tile")
            return None

    def encode(self, ctx: TileCtx, tile: np.ndarray) -> Optional[bytes]:
        """Host encode of one read tile: raw big-endian bytes, PNG
        (``encode_png``) or TIFF; None for an unknown format or pixel type."""
        fmt = ctx.format
        if fmt is None:
            return to_big_endian_bytes_np(tile).tobytes()
        if fmt == "png":
            try:
                return encode_png(tile, PNG_FILTER, PNG_LEVEL, PNG_STRATEGY)
            except PngEncodeError:
                log.error("PNG encode failed for %s", tile.dtype)
                return None
        if fmt == "tif":
            try:
                return encode_tiff(tile)
            except TiffEncodeError:
                return None
        log.error("Unknown output format: %s", fmt)
        return None

    # -- batched execution -------------------------------------------------

    def handle_batch(self, ctxs: Sequence[TileCtx], defer: bool = False
                     ) -> List[Optional[object]]:
        """Coalesced execution of many tile requests. Per lane the result
        is bytes, None (-> 404), an ``InternalError`` (-> 500: its
        encode group failed) or, with ``defer=True``, a ``DeferredTile``
        for lanes whose encode group is still in flight."""
        n = len(ctxs)
        results: List[Optional[object]] = [None] * n
        resolved: List[Optional[ResolvedTile]] = [None] * n
        for i, ctx in enumerate(ctxs):
            try:
                resolved[i] = self.resolve(ctx)
            except Exception:
                log.debug("resolve failed for lane %d", i, exc_info=True)

        plane_groups, plane_handles = self._stage_plane_lanes(ctxs, resolved)
        in_plane = {i for lanes in plane_groups.values() for i in lanes}

        # host reads, grouped per (image, level) for the batched reader
        tiles: List[Optional[np.ndarray]] = [None] * n
        by_image: Dict[Tuple[int, int], List[int]] = {}
        for i, rt in enumerate(resolved):
            if rt is not None and i not in in_plane:
                by_image.setdefault((rt.meta.image_id, rt.level), []).append(i)
        for (_, level), lanes in by_image.items():
            buf = resolved[lanes[0]].buffer
            coords = [(resolved[i].ctx.z, resolved[i].ctx.c, resolved[i].ctx.t,
                       resolved[i].x, resolved[i].y, resolved[i].w, resolved[i].h)
                      for i in lanes]
            try:
                for i, tile in zip(lanes, buf.read_tiles(coords, level=level)):
                    tiles[i] = tile
            except Exception:
                log.exception("batched read failed; lanes -> 404")

        png_groups: Dict[tuple, List[int]] = {}
        host_lanes: List[int] = []
        for i, (ctx, tile) in enumerate(zip(ctxs, tiles)):
            if tile is None:
                continue
            bucket = None
            if ctx.format == "png" and tile.dtype in _PNG_DTYPES and tile.ndim == 2:
                bucket = self._bucket(tile.shape[1], tile.shape[0])
                if bucket is None:
                    host_lanes.append(i)  # larger than every bucket
                    continue
            if bucket is not None:
                png_groups.setdefault((bucket, tile.dtype.str), []).append(i)
            else:
                results[i] = self.encode(ctx, tile)
        if host_lanes:
            self._host_png_lanes(host_lanes, tiles, ctxs, results)

        pending: List[Tuple[List[int], concurrent.futures.Future]] = []
        for ((bh, bw), dtype_str), lanes in png_groups.items():
            pending.extend(self._submit_bucket_groups(
                lanes, tiles, bh, bw, np.dtype(dtype_str)))
        for key, lanes in plane_groups.items():
            (_, _, _, _, _, bh, bw, dtype_str) = key
            pending.extend(self._submit_plane_groups(
                plane_handles[key], lanes, resolved, bh, bw, np.dtype(dtype_str)))

        if defer:
            for idxs, fut in pending:
                for i in idxs:
                    results[i] = DeferredTile(_lane_future(fut, i))
            return results
        for idxs, fut in pending:
            try:
                group = fut.result()
            except Exception:
                log.exception("device encode group failed; lanes -> 500")
                for i in idxs:
                    results[i] = InternalError("device encode group failed")
                continue
            for i in idxs:
                results[i] = group[i]
        return results

    def _host_png_lanes(self, lanes, tiles, ctxs, results) -> None:
        """PNG lanes larger than every bucket, on the host: one fused
        native call for all of them, or ``encode`` per lane without the
        native engine (and for a lane the engine failed)."""
        self.host_png_lanes += len(lanes)
        engine = get_engine()
        encoded = None
        if engine is not None:
            encoded = engine.png_encode_batch(
                [tiles[i] for i in lanes], filter_mode=PNG_FILTER, level=PNG_LEVEL,
                strategy=PNG_STRATEGY)
        if encoded is None:
            encoded = [None] * len(lanes)
        for i, png in zip(lanes, encoded):
            results[i] = png if png is not None else self.encode(ctxs[i], tiles[i])

    def _stage_plane_lanes(self, ctxs, resolved):
        """Group PNG lanes by device-resident plane, staging planes on
        their admission touch (one touch per plane per batch). A lane
        whose bucket would overrun the plane edge stays on the bucket
        route: the filter needs the region at the crop origin."""
        groups: Dict[tuple, List[int]] = {}
        handles: Dict[tuple, torch.Tensor] = {}
        planes: Dict[tuple, torch.Tensor] = {}
        attempted: set = set()
        for i, (ctx, rt) in enumerate(zip(ctxs, resolved)):
            if rt is None or ctx.format != "png" or rt.meta.dtype not in _PNG_DTYPES:
                continue
            bucket = self._bucket(rt.w, rt.h)
            if bucket is None:
                continue
            bw, bh = bucket
            size_x, size_y = rt.buffer.level_size(rt.level)
            if rt.x + bw > size_x or rt.y + bh > size_y:
                continue
            plane_key = (rt.meta.image_id, rt.level, ctx.z, ctx.c, ctx.t)
            if plane_key not in planes:
                if plane_key in attempted:
                    continue
                attempted.add(plane_key)
                try:
                    plane = self.plane_cache.get_plane(
                        rt.buffer, rt.level, ctx.z, ctx.c, ctx.t)
                except Exception:
                    log.exception("plane staging failed; host read")
                    plane = None
                if plane is None:
                    continue
                planes[plane_key] = plane
            key = plane_key + (bh, bw, rt.meta.dtype.str)
            handles[key] = planes[plane_key]
            groups.setdefault(key, []).append(i)
        return groups, handles

    def _submit_bucket_groups(self, lanes, tiles, bh, bw, dtype):
        """Host-read lanes -> zero-padded (bh, bw) bit batches, one queue
        submission per real (w, h)."""
        itemsize = dtype.itemsize
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i in lanes:
            t = tiles[i]
            groups.setdefault((t.shape[1], t.shape[0]), []).append(i)
        pending = []
        for (w, h), idxs in groups.items():
            batch = np.zeros((len(idxs), bh, bw), dtype=dtype)
            for j, i in enumerate(idxs):
                t = tiles[i]
                batch[j, : t.shape[0], : t.shape[1]] = t
            pending.append((idxs, self._submit(
                bits_tensor(batch), h, w, itemsize, idxs, staged=False)))
        return pending

    def _submit_plane_groups(self, plane, lanes, resolved, bh, bw, dtype):
        """Resident-plane lanes -> device crops on the queue's stream, one
        queue submission per real (w, h); the tiles never exist on the
        host."""
        itemsize = dtype.itemsize
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i in lanes:
            groups.setdefault((resolved[i].w, resolved[i].h), []).append(i)
        pending = []
        for (w, h), idxs in groups.items():
            coords = [(resolved[i].y, resolved[i].x) for i in idxs]
            try:
                with self.dispatcher.stream_context():
                    batch = self.plane_cache.crop_batch(plane, coords, bh, bw)
            except Exception as e:
                pending.append((idxs, self.dispatcher.failed_group(e)))
                continue
            pending.append((idxs, self._submit(batch, h, w, itemsize, idxs, staged=True)))
        return pending

    def _submit(self, batch, h, w, itemsize, idxs, staged):
        try:
            return self.dispatcher.submit(
                batch, h, 1 + w * itemsize, itemsize, PNG_FILTER,
                self.device_deflate_mode, idxs,
                [(w, h)] * len(idxs), itemsize * 8, 0, staged=staged,
            )
        except Exception as e:
            return self.dispatcher.failed_group(e)


def _lane_future(group_fut, lane) -> "concurrent.futures.Future":
    """A per-lane future fed by its group's future."""
    lf: "concurrent.futures.Future" = concurrent.futures.Future()

    def deliver(gf):
        exc = gf.exception()
        if exc is not None:
            lf.set_exception(InternalError("device encode group failed"))
        else:
            lf.set_result(gf.result()[lane])

    group_fut.add_done_callback(deliver)
    return lf
