"""The tile pipeline (counterpart of ``TilePipeline`` in
``omero_ms_pixel_buffer_tpu/models/tile_pipeline.py``; raw, PNG and TIFF
lanes on the device engine, PNG with device deflate in any of its modes,
and the whole-host engine).

The PNG encode policy (``png_filter``, ``png_level``, ``png_strategy``:
the YAML ``backend.png`` keys) reaches every PNG route and the cache key
(``encode_signature``). The device filter has the five fixed modes;
``adaptive`` lanes take the host PNG route by configuration, before any
submission, and render lanes filter ``up`` under it. ``engine="host"``
serves every lane without a device (below).

    resolve (metadata, buffer, level, region) -> plane-cache staging ->
    batched host reads -> PNG lanes padded into shape buckets ->
    streaming encode queue -> PNG bytes

Bucket padding: PNG filters only look up and left, so zero padding on
the right and bottom leaves the real region's filtered bytes unchanged;
each (bucket, dtype, samples) group encodes in one queue submission per
real (w, h). A page of three interleaved samples read without OME
channel factoring (a scanner's RGB TIFF) gives (h, w, 3) tiles: RGB
lanes, filtered at 3 (or 6) bytes a pixel and framed as colour type 2. Lanes on a plane that is resident on the device skip the host
read: the plane route crops them on the device.

With ``device_deflate=False`` (the JAX package's YAML key
``backend.png.device-deflate: false``) a PNG lane is filtered on the
device by the filter kernel and only the filtered scanlines come back:
the host deflates and frames them (``_finish_png_lanes``: the native
engine's ``png_assemble_batch``, else Python zlib).

Render lanes (``ctx.render`` set, ``/render``) read one plane per active
channel (times the z or t range of a projection; warm projection lanes
crop their planes from the plane cache and stay on the device), project,
and composite + filter + deflate (``rle``) on the device in one encode
queue group per (signature, table dtype, size, bucket, mask, residency).
JPEG lanes, lanes larger than every bucket and every render lane with
``device_deflate=False`` take the host mirror (``render_host``,
``zlib_rle_np``): routes, as in the JAX package, counted on ``/healthz``
(``render.host_lanes``). Float and 32-bit channels are quantized onto
the 16-bit bin space on the host (``_stage_stack``, float64) and render
through tables over it. A render lane that cannot render answers None
(404: so does a float render without an explicit window); a projection
stack over ``max_tile_bytes`` answers 413; a failed render group answers
500, with no host re-render.

Super-tiles (``render/supertile.py``): render lanes the batcher stamped
with one ``SuperTileGroup`` are served together (``_supertile_group``):
one plane gather over their bounding rectangle (resident planes cropped
by the plane cache and pulled to the host, as in the JAX package), one
composite and carve on the device (``composite_carve_torch`` on the
queue's stream). The carved lanes of every super-tile in the batch then
go through the filter and SP-packer kernels as one ``rle`` encode group
per (lane size, bucket), so fusion submits no more groups than the
independent lanes would. JPEG lanes and ``device_deflate=False``
take one host composite and host carves. A stamp that re-validates to
fewer than two lanes, an unrenderable spec, a bounding rectangle over
``max_tile_bytes`` or a failed gather returns the lanes to the
independent path (``supertile.fallback_lanes``); a failed fused group
answers 500, with no host re-render.

Histogram lanes (``ctx.analysis`` set, ``/histogram``) read one plane per
channel, map values to bins through host-built tables and reduce each
group of equal shapes in one ``histogram_batch`` on the device, then
build the canonical JSON body (``render/analysis.py``). A bad channel or
pixel type answers None (404), a region over ``max_tile_bytes`` 413, a
failed device reduction 500 (no host mirror behind it).

Two host routes give the JAX package's host bytes where it takes them:
``handle`` (a single request: the batcher's batch of one) reads and
encodes on the host with ``ops/png.encode_png`` (Python zlib), and a PNG
lane larger than every bucket goes to ``_host_png_lanes``: the native
engine's fused encode when ``runtime/native`` builds and loads, else
``encode_png``. The device path has no host encoder behind it: a failed
encode group answers 500 for its lanes. A ``tif`` lane is its host-read
tile framed by ``ops/tiff.encode_tiff`` (no pixel work, as in the JAX
package); other formats answer None (404). A read whose JPEG blocks'
device IDCT fails (``OMPB_JPEG_DEVICE_IDCT=1``) answers 500 for its lanes
(``DeviceIdctError``; the JAX package decodes on the host instead).
A lane whose store's circuit breaker is open (``StoreUnavailableError``,
at resolve or at any read: tile, render, super-tile and histogram reads)
answers 503 with the breaker's ``retry_after_s``, as in the JAX package;
another failed read (a corrupt chunk, a store error) answers 404 for
every lane of its batched read.

The serving mesh (``parallel/``): ``mesh`` is ``"auto"`` (a mesh over
the visible CUDA devices when there are more than one, built at the
first batch; never on the CPU), a ``Mesh`` the caller injects (the tests:
slots over ``cpu``; two slots may share one card), or None. With a mesh,
the encode queue carries a ``MeshManager`` and shards every group that
is not staged over it; the plane cache is skipped (its crops would keep
every lane on one device), as in the JAX package. A PNG lane larger than
every bucket (grey, filter ``up``) goes to the distributed plane lane:
its rows shard over the mesh with a one-row halo
(``distributed_filter_plane``) and the host deflates the filtered rows;
a failure there answers 500 (JAX: a host encode). With
``device_deflate=False`` the bucket lanes are filtered by
``sharded_batch_filter``. Super-tiles fuse on the mesh
(``submit_supertile``, each slot compositing its window) unless
``supertile_mesh`` is False, which serves their lanes independently;
histograms reduce with ``sharded_histogram_batch``.

The host engine (``engine="host"``, the JAX ``handle_batch`` with
``use_device`` false): PNG lanes take ``_host_png_lanes`` (one fused native
call, else ``encode`` per lane), render lanes the host mirror
(``render_png_host``, JPEG through ``encode_jpeg``), super-tiles one host
composite and host carves, histograms ``histogram_host`` (path ``host``
in ``analysis_histograms_total``); raw and TIFF lanes are as on the
device engine. No device object exists and no CUDA call is made.

Deadlines: ``resolve`` and every single-lane read check the lane's
``Deadline`` (else the ambient one); a spent budget leaves the lane None,
which the batcher answers 504.

Degraded lanes (``ctx.degraded`` = d, the scheduler's hybrid-resolution
fallback): ``resolve`` maps the flag to the pyramid level d below the
requested one, or clears it when no such level exists. A degraded lane
reads the covering region of that level and replicates its rows and
columns back to the requested size (``_degrade_plan_rect``: pure integer
maps from the two levels' extents, so a pixel's source does not depend
on the rectangle it is planned in). ``/tile`` lanes read one by one and
then take the same bucket route (filter kernel, SP packer) as any lane;
render lanes read their channel planes at the coarse level and upscale
before staging; a degraded super-tile gathers the coarse cover of its
bounding rectangle and upscales once, with the lanes of its modal level
(the others serve independently). Degraded lanes never crop from the
plane cache, so no full-resolution bytes are served under a degraded
key. Histogram lanes read full resolution, as in the JAX package.

Fault-injection points (``resilience/faultinject.py``, for tests):
``render.engine`` before each render encode group, ``render.supertile``
before a fused super-tile's device work, ``analysis.engine`` before each
device histogram group; a fault fails what it precedes (500), as the
failure of that work does.

Flight-record stages (``obs/recorder.py``, where the JAX pipeline stamps
them): ``resolve``, ``read`` (a lane's read, or a batched read on every
lane it serves), ``render`` (render and histogram lanes' staging),
``encode`` (host encodes) and ``device`` (an encode group, from its
submission to its future's resolution, on every lane of the group).
"""

from __future__ import annotations

import concurrent.futures
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..errors import InternalError, RequestTooLargeError, ServiceUnavailableError
from ..io.jpeg import DeviceIdctError
from ..io.pixels_service import PixelsService
from ..io.stores import StoreUnavailableError
from ..ops.convert import bits_tensor, to_big_endian_bytes_np
from ..ops.crop import resolve_region
from ..ops.device_deflate import DEFLATE_MODES
from ..ops.kernels.filter import filter_tiles
from ..parallel.mesh import MeshManager, make_mesh
from ..parallel.sharding import distributed_filter_plane, pad_batch, sharded_batch_filter
from ..ops.png import (
    _PNG_DTYPES,
    FILTER_CODES,
    PNG_FILTER,
    PNG_LEVEL,
    PNG_STRATEGY,
    PngEncodeError,
    assemble_png,
    encode_png,
)
from ..obs.recorder import stage_all, stage_of
from ..ops.tiff import TiffEncodeError, encode_tiff
from ..render import analysis as ranalysis
from ..render import engine as rengine
from ..render import supertile as stile
from ..render.luts import LutRegistry
from ..render.masks import MaskRasterCache, bucket_mask_batch
from ..render.projection import project_np, project_torch
from ..resilience.deadline import DeadlineExceeded, current_deadline
from ..resilience.faultinject import INJECTOR
from ..runtime.device import resolve_device
from ..runtime.native import get_engine
from ..tile_ctx import TileCtx
from .device_cache import DevicePlaneCache
from .device_dispatch import DeviceEncodeDispatcher

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.pipeline")

# allocation guard: a w/h=0 request on a huge plane must not materialize
# more than this (the JAX package's backend.max-tile-mb default)
MAX_TILE_BYTES = 256 << 20
# the engines: ``device`` (the card; the JAX ``jax``/``auto``/``device``/
# ``tpu``) and ``host`` (no device at all; the JAX ``host``)
ENGINES = ("device", "host")


class ResolvedTile:
    """A ctx bound to its image: metadata, buffer, level, region, and the
    coarser level a degraded lane reads (None: full resolution)."""

    __slots__ = ("ctx", "meta", "buffer", "level", "x", "y", "w", "h", "degrade_level")

    def __init__(self, ctx, meta, buffer, level, x, y, w, h, degrade_level=None):
        self.ctx, self.meta, self.buffer = ctx, meta, buffer
        self.level, self.x, self.y, self.w, self.h = level, x, y, w, h
        self.degrade_level = degrade_level


class RenderLane:
    """One staged render lane: the (C, H, W) channel stack (the unsigned
    view of the pixels), the spec and pixel type its tables are built for
    (a quantized float/32-bit lane's are the 16-bit bin space with the
    windows erased: the host quantization applied them), and the ROI mask
    raster, if any. ``device`` marks a stack that is already a device
    tensor (warm plane-cache projection crops, bits of an unsigned type):
    it is batched on the queue's stream and submitted ``staged``."""

    __slots__ = ("stack", "spec", "dtype", "mask", "device")

    def __init__(self, stack, spec, dtype, mask=None, device=False):
        self.stack, self.spec, self.dtype = stack, spec, dtype
        self.mask, self.device = mask, device


class DeferredTile:
    """A lane whose encode group is still in flight when
    ``handle_batch(..., defer=True)`` returns; ``future`` resolves to
    the PNG bytes, or raises when the group failed."""

    __slots__ = ("future",)

    def __init__(self, future: "concurrent.futures.Future"):
        self.future = future


class TilePipeline:
    """``engine="device"`` (the default): every PNG lane is filtered with
    ``png_filter`` and deflated on ``device`` (default ``cuda``; raises
    without a GPU) in ``device_deflate_mode`` (``dynamic``, the JAX
    package's default, ``rle`` or ``stored``: the YAML key
    ``backend.png.device-deflate-mode``) with the bit packer ``packer``
    (default ``device_deflate.default_packer``); with
    ``device_deflate=False`` it is filtered on the device and deflated on
    the host at ``png_level``/``png_strategy``. Filter ``adaptive`` has no
    device form: those PNG lanes take the host PNG route by configuration
    (``_host_png_lanes``, counted in ``host_png_lanes``), and render
    lanes filter with ``up`` (``render_filter_mode``).

    ``engine="host"`` (the JAX ``backend.engine: host``, or
    ``backend.batching.device-encode: false``) touches no device: no
    ``resolve_device``, encode queue, plane cache or mesh, and no CUDA
    call. PNG lanes take ``_host_png_lanes``, render lanes and super-tiles
    the host mirror, histograms ``histogram_host``; raw and TIFF lanes are
    the same on both engines. ``device`` is None there.

    ``lut_dir`` holds operator ``.lut`` files for render lanes;
    ``max_tile_bytes`` bounds a lane's pixels (a projection's whole
    stack). Only tests pass ``device="cpu"``, which runs the kernels'
    plain versions."""

    def __init__(
        self,
        pixels_service: PixelsService,
        buckets: Sequence[int] = (256, 512, 1024),
        queue_depth: int = 2,
        device="cuda",
        device_deflate_mode: str = "dynamic",
        packer: Optional[str] = None,
        device_deflate: bool = True,
        lut_dir: Optional[str] = None,
        max_tile_bytes: int = MAX_TILE_BYTES,
        supertile_mesh: bool = True,
        png_filter: str = PNG_FILTER,
        png_level: int = PNG_LEVEL,
        png_strategy: str = PNG_STRATEGY,
        engine: str = "device",
    ):
        if device_deflate_mode not in DEFLATE_MODES:
            raise ValueError(f"Unknown device deflate mode: {device_deflate_mode}")
        if engine not in ENGINES:
            raise ValueError(f"Unknown engine: {engine}")
        self.engine = engine
        self.device_deflate_mode = device_deflate_mode
        self.png_filter, self.png_level, self.png_strategy = png_filter, png_level, png_strategy
        # PNG lanes go to the device only on the device engine with a
        # filter the device has; render lanes take the device chain only
        # with device deflate on the device engine
        self._device_png = engine == "device" and png_filter in FILTER_CODES
        self._fused = engine == "device" and device_deflate
        self._render_filter = rengine.render_filter_mode(png_filter)
        self.pixels_service = pixels_service
        self.buckets = tuple(sorted(buckets))
        self.device: Optional[torch.device] = None
        self.plane_cache: Optional[DevicePlaneCache] = None
        self.dispatcher: Optional[DeviceEncodeDispatcher] = None
        if engine == "device":
            self.device = resolve_device(device)
            self.plane_cache = DevicePlaneCache(self.device)
            self.dispatcher = DeviceEncodeDispatcher(
                self.device, queue_depth=queue_depth, packer=packer)
        self.device_deflate = device_deflate
        self.max_tile_bytes = max_tile_bytes
        # PNG lanes encoded on the host (larger than every bucket, filter
        # ``adaptive``, or the host engine)
        self.host_png_lanes = 0
        self.host_deflate_lanes = 0  # device-filtered lanes deflated on the host
        # render state: the LUT registry (built on first use), the
        # per-(spec, dtype) table memo, the ROI raster cache, render lanes
        # on the host mirror, and host pulls of plane-cache projection
        # crops (a warm projection pan holds it at 0)
        self.lut_dir = lut_dir
        self._lut_registry: Optional[LutRegistry] = None
        self._render_tables: Dict[Tuple[str, str], tuple] = {}
        self._mask_cache = MaskRasterCache()
        self.render_host_lanes = 0
        self._proj_host_pulls = 0
        # histogram state: the value -> bin table memo; super-tile and
        # histogram counters (``_count``) and the composite+carve timing
        # events still in flight on the queue's stream
        self._hist_tables: Dict[tuple, np.ndarray] = {}
        self._stats_lock = threading.Lock()
        self._stats = dict.fromkeys(
            ("st_groups", "st_device_lanes", "st_host_lanes", "st_fallback_lanes",
             "st_host_pulls", "st_encode_groups", "st_timed_groups", "st_bytes",
             "hist_groups", "hist_lanes", "hist_failed_groups", "hist_timed_groups",
             "hist_bytes", "read_calls", "read_lanes", "batches", "rgb_device_lanes",
             "stage_reads"), 0)
        self._stats_ms = {"st": 0.0, "hist": 0.0, "read": 0.0, "batch": 0.0, "stage_read": 0.0}
        self._st_events: List[tuple] = []  # (start, end, bytes) per fused group
        self._epoch = 0  # invalidations seen: the open buffers' epoch token
        # the serving mesh: "auto", an injected Mesh, or None (always on
        # the host engine); its manager is built with it at the first batch
        self.mesh = "auto" if engine == "device" else None
        self.supertile_mesh = bool(supertile_mesh)
        self._mesh_lock = threading.Lock()
        self._mesh_manager: Optional[MeshManager] = None
        self.distributed_lanes = 0  # lanes of the distributed plane route

    def close(self) -> None:
        if self.dispatcher is not None:
            self.dispatcher.close()

    # -- the serving mesh ------------------------------------------------------

    def _get_mesh(self):
        """The serving mesh, built once: ``"auto"`` becomes a mesh over
        the visible CUDA devices when more than one is visible (else
        None); an injected mesh gets its ``MeshManager``, handed to the
        encode queue."""
        if self.engine == "host":
            return None
        with self._mesh_lock:
            if isinstance(self.mesh, str):
                self.mesh = None
                if self.device.type == "cuda" and torch.cuda.device_count() > 1:
                    self.mesh = make_mesh()
                    log.info("serving mesh: %s", self.mesh)
            if self.mesh is not None and self._mesh_manager is None:
                self._mesh_manager = MeshManager(self.mesh)
                self.dispatcher.set_mesh_manager(self._mesh_manager)
            return self.mesh

    def mesh_manager(self) -> Optional[MeshManager]:
        """The serving mesh's manager, once the first batch has built it.
        Lock-free: ``/healthz`` and the prober must not wait on a batch."""
        return self._mesh_manager  # ompb-lint: disable=lock-discipline -- atomic reference read; a health probe must never block behind the first batch

    @property
    def last_mesh_dispatch(self) -> Optional[dict]:
        """The mesh manager's ``last_dispatch`` (None without a mesh)."""
        mgr = self.mesh_manager()
        return None if mgr is None else mgr.last_dispatch

    def invalidate_image(self, image_id: int) -> None:
        """The invalidation hook of a changed ``pixels`` row: drop the
        image's ROI rasters; stamp a new epoch on its open buffer, so
        reads still holding it miss their next shard-index lookup (the
        JAX package's local epoch of a single node); drop the buffer (and
        its memoized shard indexes), its planes on the device and its
        decoded blocks, absent-chunk negatives included."""
        self._mask_cache.invalidate_image(image_id)
        with self._stats_lock:
            self._epoch += 1
            epoch = self._epoch
        self.pixels_service.note_epoch(image_id, epoch)
        ns = self.pixels_service.invalidate(image_id)
        if ns is None:
            return
        if self.plane_cache is not None:
            self.plane_cache.invalidate_ns(ns)
        self.pixels_service.block_cache.purge_ns(ns)

    def plane_cache_snapshot(self) -> Optional[dict]:
        """``/healthz`` ``plane_cache``; None on the host engine, which
        never builds one (the JAX shape)."""
        return None if self.plane_cache is None else self.plane_cache.snapshot()

    def device_queue_snapshot(self) -> Optional[dict]:
        """``/healthz`` ``queue``; None on the host engine."""
        if self.dispatcher is None:
            return None
        return {"deflate_mode": self.device_deflate_mode, **self.dispatcher.snapshot()}

    # -- render state ------------------------------------------------------

    @property
    def lut_registry(self) -> LutRegistry:
        """The LUT registry (built-ins and ``lut_dir``), built on first use."""
        if self._lut_registry is None:
            self._lut_registry = LutRegistry(self.lut_dir)
        return self._lut_registry

    def _render_tables_for(self, spec, dtype) -> tuple:
        """(index_tables, color_luts) for a (spec, pixel type), memoized."""
        return _memo(self._render_tables, (spec.signature(), np.dtype(dtype).str),
                     lambda: rengine.build_tables(spec, np.dtype(dtype), self.lut_registry))

    def render_snapshot(self) -> dict:
        """/healthz view of the rendering engine."""
        return {
            "specs_cached": len(self._render_tables),
            "luts": len(self._lut_registry) if self._lut_registry is not None else None,
            "lut_dir": self.lut_dir,
            "masks": self._mask_cache.snapshot(),
            "projection_host_pulls": self._proj_host_pulls,
            "host_lanes": self.render_host_lanes,
        }

    def _count(self, **deltas) -> None:
        with self._stats_lock:
            for k, v in deltas.items():
                self._stats[k] += v

    def supertile_snapshot(self) -> dict:
        """/healthz view of super-tile fusion: groups served fused, lanes
        fused on the device and on the host, lanes returned to the
        independent path, plane-cache crops the gathers pulled to the
        host (also in ``render.projection_host_pulls``), the encode groups
        submitted for the carved lanes, and for the
        completed device groups the composite + carve's device ms (CUDA
        events on the queue's stream) and the bytes it must move (the
        stack and the packed tables read once, the carved batch written
        once)."""
        with self._stats_lock:
            self._drain_st_events()
            st = self._stats
            return {
                "groups": st["st_groups"],
                "device_lanes": st["st_device_lanes"],
                "host_lanes": st["st_host_lanes"],
                "fallback_lanes": st["st_fallback_lanes"],
                "host_pulls": st["st_host_pulls"],
                "encode_groups": st["st_encode_groups"],
                "composite_carve_groups": st["st_timed_groups"],
                "composite_carve_device_ms_total": self._stats_ms["st"],
                "composite_carve_bytes_total": st["st_bytes"],
            }

    def _drain_st_events(self) -> None:
        """Fold the completed composite + carve timings into the totals
        (``_stats_lock`` held), so only groups in flight stay listed."""
        pending = []
        for ev0, ev1, nbytes in self._st_events:
            if ev1.query():
                self._stats_ms["st"] += ev0.elapsed_time(ev1)
                self._stats["st_timed_groups"] += 1
                self._stats["st_bytes"] += nbytes
            else:
                pending.append((ev0, ev1, nbytes))
        self._st_events = pending

    def analysis_snapshot(self) -> dict:
        """/healthz view of the histogram plane: cached bin tables, the
        groups and channel planes reduced on ``device``, failed groups,
        and for the timed (CUDA) groups the reductions' device ms and the
        bytes they must move (planes and tables read once, counts written
        once)."""
        with self._stats_lock:
            st = self._stats
            return {
                "hist_tables_cached": len(self._hist_tables),
                "device": str(self.device) if self.device is not None else "host",
                "device_groups": st["hist_groups"],
                "device_lanes": st["hist_lanes"],
                "failed_groups": st["hist_failed_groups"],
                "timed_groups": st["hist_timed_groups"],
                "device_ms_total": self._stats_ms["hist"],
                "device_bytes_total": st["hist_bytes"],
            }

    def read_snapshot(self) -> dict:
        """/healthz view of the host reads inside ``handle_batch`` (tile,
        render, histogram and super-tile reads, and the whole-plane reads
        that stage a plane into the plane cache, also counted apart as
        ``stage_reads``/``stage_ms_total``; host clock): calls, regions
        read, their milliseconds, and the ``handle_batch`` calls and
        milliseconds they sit in (reads are decodes: JPEG, LZW, inflate,
        LZ4), plus the RGB lanes sent to the device."""
        with self._stats_lock:
            st = self._stats
            return {"calls": st["read_calls"], "lanes": st["read_lanes"],
                    "ms_total": self._stats_ms["read"], "batches": st["batches"],
                    "batch_ms_total": self._stats_ms["batch"],
                    "stage_reads": st["stage_reads"],
                    "stage_ms_total": self._stats_ms["stage_read"],
                    "rgb_device_lanes": st["rgb_device_lanes"]}

    def _read(self, buf, coords, level, staging: bool = False):
        """``buf.read_tiles``, timed for ``read_snapshot`` (``staging``: a
        plane-cache staging read)."""
        return self._timed(lambda: buf.read_tiles(coords, level=level), len(coords), staging)

    def _timed(self, read, lanes: int, staging: bool = False):
        """Run one host read, counted and timed for ``read_snapshot``."""
        t0 = time.perf_counter()
        try:
            return read()
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            with self._stats_lock:
                self._stats["read_calls"] += 1
                self._stats["read_lanes"] += lanes
                self._stats_ms["read"] += ms
                if staging:
                    self._stats["stage_reads"] += 1
                    self._stats_ms["stage_read"] += ms

    def _stage_read(self, buf, coords, level):
        """The plane cache's whole-plane read, timed as a staging read."""
        return self._read(buf, coords, level, staging=True)

    def encode_signature(self) -> str:
        """The 'quality' part of the result-cache key: the PNG encode
        policy the bytes depend on, so a new policy gives new keys and
        ETags."""
        return f"{self.png_filter}.{self.png_level}.{self.png_strategy}"

    # -- resolve / read ----------------------------------------------------

    @staticmethod
    def _check_deadline(ctx: TileCtx, what: str) -> None:
        """Raise ``DeadlineExceeded`` once the lane's budget (else the
        ambient one) is spent."""
        deadline = ctx.deadline or current_deadline()
        if deadline is not None:
            deadline.check(what)

    def resolve(self, ctx: TileCtx) -> Optional[ResolvedTile]:
        """Metadata + buffer + region (+ the degraded lane's level). None
        when the image is unknown or the caller's session may not read it
        (a scoped metadata resolver); raises ValueError on invalid
        coordinates (-> 404), ``DeadlineExceeded`` past the budget."""
        self._check_deadline(ctx, "resolve")
        with stage_of(ctx, "resolve"):
            return self._resolve_inner(ctx)

    def _resolve_inner(self, ctx: TileCtx) -> Optional[ResolvedTile]:
        svc = self.pixels_service
        meta = svc.get_pixels(ctx.image_id, session_key=ctx.omero_session_key)
        if meta is None:
            log.debug("Cannot find Image:%s", ctx.image_id)
            return None
        # the key again at the buffer: the resolver's per-session cache
        # answers, and the ACL holds at every buffer open
        buffer = svc.get_pixel_buffer(
            ctx.image_id, session_key=ctx.omero_session_key if svc._resolver_scoped else None)
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
        # interleaved pages materialize w*h*samples before a channel is cut
        samples = getattr(buffer, "samples", 1)
        if (self.max_tile_bytes
                and w * h * samples * buffer.meta.bytes_per_pixel > self.max_tile_bytes):
            raise ValueError(f"Tile {w}x{h} exceeds max-tile-bytes ({self.max_tile_bytes})")
        # the resolved region flows back into the ctx (filename header)
        ctx.region.x, ctx.region.y = x, y
        ctx.region.width, ctx.region.height = w, h
        degrade_level = None
        if ctx.degraded:
            target = level + int(ctx.degraded)
            if 0 < target < buffer.resolution_levels:
                degrade_level = target
            else:
                ctx.degraded = 0  # no coarser level: full resolution, untagged
        return ResolvedTile(ctx, buffer.meta, buffer, level, x, y, w, h, degrade_level)

    def read(self, rt: ResolvedTile) -> np.ndarray:
        """One lane's host read (its coarse level upscaled when degraded)."""
        self._check_deadline(rt.ctx, "read")
        with stage_of(rt.ctx, "read"):
            if rt.degrade_level is not None:
                return self._read_degraded(rt)
            return rt.buffer.get_tile_at(rt.level, rt.ctx.z, rt.ctx.c, rt.ctx.t,
                                         rt.x, rt.y, rt.w, rt.h)

    # -- hybrid-resolution degradation --------------------------------------

    @staticmethod
    def _degrade_plan_rect(buffer, level, degrade_level, x, y, w, h):
        """The coarse read and upscale of a rectangle at ``level`` served
        from ``degrade_level``: (cx0, cy0, cw, ch) of the covering coarse
        region and the row and column index maps back to (h, w). Pure
        integer maps from the two levels' extents, so odd and
        non-power-of-two pyramids map right; each pixel's coarse index is
        absolute, so a fused rectangle's plan equals its lanes' plans."""
        sx0, sy0 = buffer.level_size(level)
        sx1, sy1 = buffer.level_size(degrade_level)
        cx0 = x * sx1 // sx0
        cy0 = y * sy1 // sy0
        cx1 = max(min(sx1, ((x + w) * sx1 + sx0 - 1) // sx0), cx0 + 1)
        cy1 = max(min(sy1, ((y + h) * sy1 + sy0 - 1) // sy0), cy0 + 1)
        xs = np.minimum((x + np.arange(w)) * sx1 // sx0, cx1 - 1) - cx0
        ys = np.minimum((y + np.arange(h)) * sy1 // sy0, cy1 - 1) - cy0
        return cx0, cy0, cx1 - cx0, cy1 - cy0, ys, xs

    @classmethod
    def _degrade_plan(cls, rt: ResolvedTile):
        return cls._degrade_plan_rect(rt.buffer, rt.level, rt.degrade_level,
                                      rt.x, rt.y, rt.w, rt.h)

    def _read_degraded(self, rt: ResolvedTile) -> np.ndarray:
        """The requested region from the coarser level: the coarse tile
        with its rows and columns replicated (a trailing samples axis
        rides along)."""
        cx0, cy0, cw, ch, ys, xs = self._degrade_plan(rt)
        coarse = rt.buffer.get_tile_at(rt.degrade_level, rt.ctx.z, rt.ctx.c, rt.ctx.t,
                                       cx0, cy0, cw, ch)
        return coarse[np.ix_(ys, xs)]

    def _bucket(self, w: int, h: int) -> Optional[Tuple[int, int]]:
        """Smallest bucket covering (w, h); None when none does."""
        for b in self.buckets:
            if w <= b and h <= b:
                return (b, b)
        return None

    # -- single-request path ----------------------------------------------

    def handle(self, ctx: TileCtx) -> Optional[bytes]:
        """One request on the host: resolve, read, encode. Bytes, or None
        (-> 404) on any failure, as the JAX package's ``handle`` (an
        ``InternalError``, -> 500, when the device IDCT failed; a
        ``ServiceUnavailableError``, -> 503, when the store's breaker is
        open). A render or histogram lane takes the batched machinery, as
        there."""
        if ctx.render is not None or ctx.analysis is not None:
            return self.handle_batch([ctx])[0]
        try:
            rt = self.resolve(ctx)
            if rt is None:
                return None
            return self.encode(ctx, self.read(rt))
        except DeadlineExceeded:
            log.debug("deadline exceeded for image %s", ctx.image_id)
            return None  # the batcher answers 504
        except DeviceIdctError:
            log.exception("device IDCT failed; lane -> 500")
            return InternalError("device IDCT failed")
        except StoreUnavailableError as e:
            log.warning("store unavailable: %s", e)
            return _lane_unavailable(e)
        except Exception:
            log.exception("Exception while retrieving tile")
            return None

    def encode(self, ctx: TileCtx, tile: np.ndarray) -> Optional[bytes]:
        """Host encode of one read tile: raw big-endian bytes, PNG
        (``encode_png``) or TIFF; None for an unknown format or pixel type."""
        with stage_of(ctx, "encode"):
            return self._encode_inner(ctx, tile)

    def _encode_inner(self, ctx: TileCtx, tile: np.ndarray) -> Optional[bytes]:
        fmt = ctx.format
        if fmt is None:
            return to_big_endian_bytes_np(tile).tobytes()
        if fmt == "png":
            try:
                return encode_png(tile, self.png_filter, self.png_level, self.png_strategy)
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
        is bytes, None (-> 404), a ``RequestTooLargeError`` (-> 413: a
        projection stack or histogram region over budget), an
        ``InternalError`` (-> 500: its encode group or device histogram
        failed) or, with ``defer=True``, a ``DeferredTile`` for lanes whose
        encode group is still in flight."""
        t0 = time.perf_counter()
        try:
            return self._handle_batch(ctxs, defer)
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            with self._stats_lock:
                self._stats["batches"] += 1
                self._stats_ms["batch"] += ms

    def _handle_batch(self, ctxs, defer):
        n = len(ctxs)
        results: List[Optional[object]] = [None] * n
        resolved: List[Optional[ResolvedTile]] = [None] * n
        for i, ctx in enumerate(ctxs):
            try:
                resolved[i] = self.resolve(ctx)
            except StoreUnavailableError as e:
                results[i] = _lane_unavailable(e)
            except Exception:
                log.debug("resolve failed for lane %d", i, exc_info=True)

        # render and histogram lanes read their channel planes on their
        # own paths; a histogram lane is never a render lane
        render_idx = [i for i, ctx in enumerate(ctxs)
                      if ctx.render is not None and ctx.analysis is None
                      and resolved[i] is not None]
        analysis_idx = [i for i, ctx in enumerate(ctxs)
                        if ctx.analysis is not None and resolved[i] is not None]
        own_path = set(render_idx) | set(analysis_idx)

        mesh = self._get_mesh()
        plane_groups, plane_handles = {}, {}
        if mesh is None and self._device_png:
            # with a mesh the sharded bucket route serves these lanes
            plane_groups, plane_handles = self._stage_plane_lanes(ctxs, resolved)
        in_plane = {i for lanes in plane_groups.values() for i in lanes}

        # host reads, grouped per (image, level) for the batched reader;
        # degraded lanes read their coarse level and upscale one by one
        tiles: List[Optional[np.ndarray]] = [None] * n
        by_image: Dict[Tuple[int, int], List[int]] = {}
        for i, rt in enumerate(resolved):
            if rt is None or i in in_plane or i in own_path:
                continue
            if rt.degrade_level is not None:
                tiles[i] = self._degraded_lane(i, rt, results)
                continue
            by_image.setdefault((rt.meta.image_id, rt.level), []).append(i)
        for (_, level), lanes in by_image.items():
            buf = resolved[lanes[0]].buffer
            coords = [(resolved[i].ctx.z, resolved[i].ctx.c, resolved[i].ctx.t,
                       resolved[i].x, resolved[i].y, resolved[i].w, resolved[i].h)
                      for i in lanes]
            try:
                with stage_all([ctxs[i] for i in lanes], "read"):
                    read = self._read(buf, coords, level)
                for i, tile in zip(lanes, read):
                    tiles[i] = tile
            except DeviceIdctError:
                _idct_failed(lanes, results)
            except StoreUnavailableError as e:
                _unavailable(lanes, results, e)
            except Exception:
                log.exception("batched read failed; lanes -> 404")

        # PNG lanes: grey (h, w) or interleaved RGB (h, w, 3) tiles
        png_groups: Dict[tuple, List[int]] = {}
        host_lanes: List[int] = []
        sp_lanes: List[int] = []
        for i, (ctx, tile) in enumerate(zip(ctxs, tiles)):
            if tile is None:
                continue
            bucket = None
            if ctx.format == "png" and _png_lane(tile):
                if self._device_png:
                    bucket = self._bucket(tile.shape[1], tile.shape[0])
                if bucket is None:
                    if (self._device_png and mesh is not None and tile.ndim == 2
                            and self.png_filter == "up"):
                        sp_lanes.append(i)  # rows sharded over the mesh
                    else:
                        # larger than every bucket, filter adaptive, or
                        # the host engine
                        host_lanes.append(i)
                    continue
            if bucket is not None:
                samples = 1 if tile.ndim == 2 else 3
                png_groups.setdefault((bucket, tile.dtype.str, samples), []).append(i)
            else:
                results[i] = self.encode(ctx, tile)
        if host_lanes:
            self._host_png_lanes(host_lanes, tiles, ctxs, results)
        for i in sp_lanes:
            try:
                with stage_all([ctxs[i]], "device"):
                    self._distributed_plane_lane(mesh, i, tiles[i], results)
            except Exception:
                log.exception("distributed plane lane failed; lane -> 500")
                results[i] = InternalError("distributed plane lane failed")

        pending: List[Tuple[List[int], concurrent.futures.Future]] = []
        for ((bh, bw), dtype_str, samples), lanes in png_groups.items():
            if self.device_deflate:
                pending.extend(self._submit_bucket_groups(
                    lanes, tiles, bh, bw, np.dtype(dtype_str), samples))
            else:
                self._host_deflate(lambda: self._device_png_lanes(
                    lanes, tiles, results, bh, bw, np.dtype(dtype_str), samples),
                    lanes, results)
        for key, lanes in plane_groups.items():
            (_, _, _, _, _, bh, bw, dtype_str) = key
            if self.device_deflate:
                pending.extend(self._submit_plane_groups(
                    plane_handles[key], lanes, resolved, bh, bw, np.dtype(dtype_str)))
            else:
                self._host_deflate(lambda: self._device_plane_png_lanes(
                    plane_handles[key], lanes, resolved, results, bh, bw,
                    np.dtype(dtype_str)), lanes, results)
        if render_idx:
            with stage_all([ctxs[i] for i in render_idx], "render"):
                render_pending = self._render_batch_lanes(render_idx, resolved, ctxs, results)
            for _, fut in render_pending:
                fut.add_done_callback(_count_render_group)
            pending.extend(render_pending)
        if analysis_idx:
            with stage_all([ctxs[i] for i in analysis_idx], "render"):
                self._analysis_batch_lanes(analysis_idx, resolved, ctxs, results)

        if defer:
            t_submit = time.perf_counter()
            for idxs, fut in pending:
                # stamped before the lanes resolve, so before any record
                # completes
                fut.add_done_callback(_stamp_device([ctxs[i] for i in idxs], t_submit))
                for i in idxs:
                    results[i] = DeferredTile(_lane_future(fut, i))
            return results
        for idxs, fut in pending:
            try:
                with stage_all([ctxs[i] for i in idxs], "device"):
                    group = fut.result()
            except Exception:
                log.exception("device encode group failed; lanes -> 500")
                for i in idxs:
                    results[i] = InternalError("device encode group failed")
                continue
            for i in idxs:
                results[i] = group[i]
        return results

    def _degraded_lane(self, i, rt, results) -> Optional[np.ndarray]:
        """One degraded lane's upscaled read; a failure writes the lane's
        marker (503 for an open breaker, 500 for a failed device IDCT) or
        leaves it None (404, or 504 past the deadline)."""
        try:
            return self._timed(lambda: self.read(rt), 1)
        except DeadlineExceeded:
            pass
        except DeviceIdctError:
            _idct_failed([i], results)
        except StoreUnavailableError as e:
            _unavailable([i], results, e)
        except Exception:
            log.exception("degraded read failed; lane -> 404")
        return None

    def _host_png_lanes(self, lanes, tiles, ctxs, results) -> None:
        """PNG lanes on the host (larger than every bucket, filter
        ``adaptive``, the host engine): one fused native call for all of
        them, or ``encode`` per lane without the native engine, for a
        filter it lacks (``average``, ``paeth``, ``adaptive``) and for a
        lane it failed."""
        self.host_png_lanes += len(lanes)
        engine = get_engine()
        encoded = None
        if engine is not None:
            with stage_all([ctxs[i] for i in lanes], "encode"):
                encoded = engine.png_encode_batch(
                    [tiles[i] for i in lanes], filter_mode=self.png_filter,
                    level=self.png_level, strategy=self.png_strategy)
        if encoded is None:
            encoded = [None] * len(lanes)
        for i, png in zip(lanes, encoded):
            results[i] = png if png is not None else self.encode(ctxs[i], tiles[i])

    def _stage_plane_lanes(self, ctxs, resolved):
        """Group PNG lanes by device-resident plane, staging planes on
        their admission touch (one touch per plane per batch). A lane
        whose bucket would overrun the plane edge stays on the bucket
        route: the filter needs the region at the crop origin; so does
        every lane of a multi-sample page (as in the JAX package)."""
        groups: Dict[tuple, List[int]] = {}
        handles: Dict[tuple, torch.Tensor] = {}
        planes: Dict[tuple, torch.Tensor] = {}
        attempted: set = set()
        for i, (ctx, rt) in enumerate(zip(ctxs, resolved)):
            if (rt is None or ctx.format != "png" or ctx.render is not None
                    or rt.degrade_level is not None
                    or rt.meta.dtype not in _PNG_DTYPES
                    or getattr(rt.buffer, "samples", 1) != 1):
                # a render lane's format is png too; a degraded lane reads
                # the coarse level (a full-resolution crop would serve
                # full-resolution bytes under its degraded key)
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
                        rt.buffer, rt.level, ctx.z, ctx.c, ctx.t, read=self._stage_read)
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

    def _submit_bucket_groups(self, lanes, tiles, bh, bw, dtype, samples=1):
        """Host-read lanes -> zero-padded (bh, bw[, samples]) bit batches,
        one queue submission per real (w, h)."""
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i in lanes:
            t = tiles[i]
            groups.setdefault((t.shape[1], t.shape[0]), []).append(i)
        pending = []
        if samples == 3:
            self._count(rgb_device_lanes=len(lanes))
        for (w, h), idxs in groups.items():
            batch = _pad_batch([tiles[i] for i in idxs], bh, bw, dtype, samples)
            pending.append((idxs, self._submit(
                bits_tensor(batch), h, w, dtype.itemsize, idxs, staged=False,
                samples=samples)))
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

    def _submit(self, batch, h, w, itemsize, idxs, staged, samples=1):
        bpp = samples * itemsize
        try:
            return self.dispatcher.submit(
                batch, h, 1 + w * bpp, bpp, self.png_filter,
                self.device_deflate_mode, idxs,
                [(w, h)] * len(idxs), itemsize * 8, 0 if samples == 1 else 2,
                staged=staged,
            )
        except Exception as e:
            return self.dispatcher.failed_group(e)

    # -- device filter, host deflate (device_deflate=False) ----------------

    def _host_deflate(self, run, lanes, results) -> None:
        """Run one device-filter group; a failure answers 500 for its
        lanes (no host re-encode)."""
        try:
            run()
        except Exception:
            log.exception("device filter group failed; lanes -> 500")
            for i in lanes:
                results[i] = InternalError("device filter group failed")

    def _device_png_lanes(self, lanes, tiles, results, bh, bw, dtype, samples=1) -> None:
        """Host-read lanes zero-padded into one bucket batch, copied to the
        device and filtered by the filter kernel (grey and RGB alike: the
        filter unit is samples*itemsize bytes); only the filtered
        scanlines come back, for the host deflate tail."""
        if samples == 3:
            self._count(rgb_device_lanes=len(lanes))
        batch = _pad_batch([tiles[i] for i in lanes], bh, bw, dtype, samples)
        mesh = self._get_mesh()
        if mesh is not None:
            padded, real = pad_batch(bits_tensor(batch), mesh.size)
            filtered = sharded_batch_filter(mesh, padded, samples * dtype.itemsize,
                                            self.png_filter)[:real]
        else:
            filtered = filter_tiles(bits_tensor(batch).to(self.device), self.png_filter)
        sizes = [(tiles[i].shape[1], tiles[i].shape[0]) for i in lanes]
        self._finish_png_lanes(filtered.cpu().numpy(), lanes, sizes, results, dtype.itemsize,
                               samples)

    def _device_plane_png_lanes(self, plane, lanes, resolved, results, bh, bw, dtype) -> None:
        """Crops of a resident plane filtered on the device; only the
        filtered scanlines come back, for the host deflate tail."""
        coords = [(resolved[i].y, resolved[i].x) for i in lanes]
        filtered = filter_tiles(self.plane_cache.crop_batch(plane, coords, bh, bw),
                                self.png_filter)
        sizes = [(resolved[i].w, resolved[i].h) for i in lanes]
        self._finish_png_lanes(filtered.cpu().numpy(), lanes, sizes, results, dtype.itemsize)

    def _distributed_plane_lane(self, mesh, i, tile, results) -> None:
        """One grey PNG lane larger than every bucket over the mesh: its
        rows padded below to a multiple of the width (the Up filter looks
        only up, so the pad never reaches them), sharded with a one-row
        halo, filtered by the filter kernel on every slot; the filtered
        rows come back once for the host deflate tail."""
        h, w = tile.shape
        pad = (-h) % mesh.size
        arr = np.pad(tile, ((0, pad), (0, 0))) if pad else tile
        filtered = distributed_filter_plane(mesh, bits_tensor(np.ascontiguousarray(arr)), "up")
        self.distributed_lanes += 1
        self._finish_png_lanes(filtered[:h].cpu().numpy()[None], [i], [(w, h)], results,
                               tile.dtype.itemsize)

    def _finish_png_lanes(self, filtered, lanes, sizes, results, itemsize, samples=1) -> None:
        """Deflate + frame filtered scanlines (B, bh, 1 + bw*bpp) on the
        host: the native engine's ``png_assemble_batch``, or Python zlib
        (``assemble_png``) without it and for a lane it failed. Each lane
        keeps its real rows and row bytes (filters never look right or
        down, so the padding cannot reach them); RGB lanes are colour
        type 2."""
        self.host_deflate_lanes += len(lanes)
        bit_depth = itemsize * 8
        color_type = 0 if samples == 1 else 2
        bpp = samples * itemsize
        payloads = [filtered[j, :h, : 1 + w * bpp].tobytes()
                    for j, (w, h) in enumerate(sizes)]
        engine = get_engine()
        pngs = [None] * len(lanes)
        if engine is not None:
            pngs = engine.png_assemble_batch(
                payloads, [w for w, _ in sizes], [h for _, h in sizes],
                [bit_depth] * len(lanes), [color_type] * len(lanes),
                level=self.png_level, strategy=self.png_strategy)
        for j, (i, png) in enumerate(zip(lanes, pngs)):
            w, h = sizes[j]
            results[i] = png if png is not None else assemble_png(
                payloads[j], w, h, bit_depth, color_type, self.png_level, self.png_strategy)

    # -- render lanes ------------------------------------------------------

    def _render_batch_lanes(self, idxs, resolved, ctxs, results):
        """Serve the batcher's super-tile groups first (``_supertile_group``,
        then one encode group per carved size class, ``_submit_carved``;
        the lanes a group declines stay here). Then plan and read every
        other render lane's channel planes (per image;
        projection lanes crop from the plane cache first, and a lane whose
        crops are all resident stays on the device), project, rasterize
        ROI masks, then submit one render group per (signature, pixel
        type, size, bucket, mask, residency), or encode on the host
        mirror (JPEG, larger than every bucket, ``device_deflate=False``).
        Returns [(lanes, group future)]. A lane that cannot render stays
        None (404); a projection stack over budget gets a 413 marker."""
        use_fused = self._fused
        pending = []
        st_groups: Dict[int, List[int]] = {}
        for i in idxs:
            token = ctxs[i].supertile
            if token is not None:
                st_groups.setdefault(id(token), []).append(i)
        fused: set = set()
        carved: Dict[tuple, list] = {}
        if self._get_mesh() is not None and not self.supertile_mesh:
            st_groups = {}  # ``supertile.mesh: false``: the lanes shard one by one
        for lanes in st_groups.values():
            fused |= self._supertile_group(lanes, resolved, ctxs, results, use_fused, pending,
                                           carved)
        self._submit_carved(carved, pending)
        if fused:
            idxs = [i for i in idxs if i not in fused]
        plans: Dict[int, tuple] = {}
        lane_dev: Dict[int, bool] = {}
        by_image: Dict[Tuple[int, int], List[int]] = {}
        for i in idxs:
            rt, ctx = resolved[i], ctxs[i]
            spec = ctx.render
            try:
                chans = spec.resolve_channels(rt.meta.size_c)
                zts = spec.plane_range(ctx.z, ctx.t, rt.meta.size_z, rt.meta.size_t)
            except Exception:
                log.debug("unrenderable spec for image %d", ctx.image_id, exc_info=True)
                continue
            if not _render_dtype_ok(rt.meta.dtype, chans):
                continue  # -> 404
            nplanes = len(chans) * len(zts)
            if (self.max_tile_bytes
                    and rt.w * rt.h * rt.meta.bytes_per_pixel * nplanes > self.max_tile_bytes):
                results[i] = RequestTooLargeError(
                    f"Projection stack {rt.w}x{rt.h} x {nplanes} planes exceeds "
                    f"max-tile-bytes ({self.max_tile_bytes})")
                continue
            upscale = None
            if rt.degrade_level is not None:
                # every channel plane from the coarse level, upscaled after
                # the read
                cx0, cy0, crw, crh, ys, xs = self._degrade_plan(rt)
                coords = [(z, ch.index, t, cx0, cy0, crw, crh) for ch in chans for (z, t) in zts]
                upscale = (ys, xs, crh, crw)
            else:
                coords = [(z, ch.index, t, rt.x, rt.y, rt.w, rt.h)
                          for ch in chans for (z, t) in zts]
            plans[i] = (chans, zts, coords, upscale)
            by_image.setdefault((rt.meta.image_id, rt.level if upscale is None
                                 else rt.degrade_level), []).append(i)

        stacks: Dict[int, RenderLane] = {}
        for (image_id, level), lanes in by_image.items():
            buf = resolved[lanes[0]].buffer
            per_lane: Dict[int, list] = {}
            flat: List[tuple] = []
            owners: List[Tuple[int, int]] = []
            for i in lanes:
                chans, zts, coords, upscale = plans[i]
                rt, spec = resolved[i], ctxs[i].render
                slots = [None] * len(coords)
                per_lane[i] = slots
                use_cache = (spec.projection is not None and upscale is None
                             and self.plane_cache is not None
                             and _plane_cacheable(buf, rt.meta.dtype))
                # a lane whose crops are all resident stays on the device:
                # the fused route, unsigned pixels (no view needed, no
                # quantization), no mask raster, a bucket to land in
                lane_dev[i] = (use_cache and use_fused
                               and spec.format == "png" and not spec.masks
                               and rt.meta.dtype.kind == "u"
                               and self._bucket(rt.w, rt.h) is not None)
                for j, coord in enumerate(coords):
                    arr = (self._plane_cache_region(buf, level, coord, rt.meta.dtype,
                                                    device=lane_dev[i])
                           if use_cache else None)
                    if arr is not None:
                        slots[j] = arr
                    else:
                        flat.append(coord)
                        owners.append((i, j))
            try:
                planes = self._read(buf, flat, level) if flat else []
            except DeviceIdctError:
                _idct_failed(lanes, results)
                continue
            except StoreUnavailableError as e:
                _unavailable(lanes, results, e)
                continue
            except Exception:
                log.exception("render read failed for image %d; lanes -> 404", image_id)
                continue
            for (i, j), arr in zip(owners, planes):
                per_lane[i][j] = arr
            for i in lanes:
                chans, zts, _, upscale = plans[i]
                lane_planes = per_lane[i]
                if any(p is None for p in lane_planes):
                    continue  # a read slot failed -> 404
                rt, spec = resolved[i], ctxs[i].render
                try:
                    if lane_dev[i]:
                        if all(isinstance(p, torch.Tensor) for p in lane_planes):
                            with self.dispatcher.stream_context():
                                stack = project_torch(torch.stack(lane_planes).reshape(
                                    len(chans), len(zts), rt.h, rt.w), spec.projection)
                            stacks[i] = RenderLane(stack, spec, rt.meta.dtype, device=True)
                            continue
                        # a mixed cold pan: the resident slots come back once
                        lane_planes = [self._pull_crop(p, rt.meta.dtype) for p in lane_planes]
                    if upscale is not None:
                        ys, xs, crh, crw = upscale
                        stack = np.stack(lane_planes).reshape(
                            len(chans), len(zts), crh, crw)[:, :, ys[:, None], xs[None, :]]
                    else:
                        stack = np.stack(lane_planes).reshape(len(chans), len(zts), rt.h, rt.w)
                    stack, tspec, tdtype = self._stage_stack(stack, spec, chans, rt.meta.dtype,
                                                             device_project=use_fused)
                    mask = None
                    if spec.masks:
                        mask = self._mask_cache.get(rt.meta.image_id, spec.masks,
                                                    (rt.x, rt.y, rt.w, rt.h))
                    stacks[i] = RenderLane(stack, tspec, tdtype, mask)
                except Exception:
                    log.exception("render staging failed for lane %d", i)

        groups: Dict[tuple, List[int]] = {}
        for i, lane in stacks.items():
            rt, spec = resolved[i], ctxs[i].render
            bucket = self._bucket(rt.w, rt.h) if use_fused and spec.format == "png" else None
            if bucket is None:
                self._render_host_lane(i, ctxs[i], lane, results)
                continue
            groups.setdefault((spec.signature(), lane.dtype.str, (rt.w, rt.h), bucket,
                               lane.mask is not None, lane.device), []).append(i)
        for (_, dtype_str, (w, h), (bw, bh), has_mask, is_dev), lanes in groups.items():
            lane0 = stacks[lanes[0]]
            try:
                INJECTOR.fire("render.engine")
                tables, luts = self._render_tables_for(lane0.spec, np.dtype(dtype_str))
                if is_dev:
                    with self.dispatcher.stream_context():
                        real = torch.stack([stacks[i].stack for i in lanes])
                        batch = torch.zeros(real.shape[:2] + (bh, bw), dtype=real.dtype,
                                            device=real.device)
                        batch[:, :, :h, :w] = real
                else:
                    host = np.zeros((len(lanes), lane0.stack.shape[0], bh, bw),
                                    dtype=lane0.stack.dtype)
                    for j, i in enumerate(lanes):
                        host[j, :, :h, :w] = stacks[i].stack
                    batch = bits_tensor(host)
                mask = None
                if has_mask:
                    mask = torch.from_numpy(
                        bucket_mask_batch([stacks[i].mask for i in lanes], bh, bw))
                fut = self.dispatcher.submit_render(
                    batch, tables, luts, h, 1 + w * 3, self._render_filter, "rle", lanes,
                    [(w, h)] * len(lanes), mask=mask, staged=is_dev)
            except Exception as e:
                fut = self.dispatcher.failed_group(e)
            pending.append((lanes, fut))
        return pending

    # -- super-tiles -------------------------------------------------------

    def _supertile_group(self, lanes, resolved, ctxs, results, use_fused, pending,
                         carved) -> set:
        """Serve one batcher-stamped super-tile: one plane gather over the
        group's bounding rectangle (resident planes cropped by the plane
        cache, pulled to the host and counted, as in the JAX package), one
        composite, per-lane carves. The carved lanes of each size class
        join ``carved[(w, h, bucket w, bucket h)]`` as (lanes, (B, bh, bw,
        3) uint8 batch made on the queue's stream) for ``_submit_carved``.
        Returns the lanes it handled (a result written, carved, or a
        failed group queued on ``pending``); a lane that
        re-validates out, or a whole group the fusion declines (an
        unrenderable spec, a rectangle over budget, a failed gather or
        staging), stays for the independent path."""
        live = [i for i in lanes
                if resolved[i] is not None and results[i] is None and not ctxs[i].expired]
        # degraded lanes fuse per resolved level (the stamp carries only the
        # flag; resolve may clear it): the modal level's lanes stay
        by_level: Dict[Optional[int], List[int]] = {}
        for i in live:
            by_level.setdefault(resolved[i].degrade_level, []).append(i)
        if len(by_level) > 1:
            keep = max(by_level.values(), key=len)
            self._st_decline([i for i in live if i not in keep])
            live = keep
        if len(live) < 2:
            return self._st_decline(live)
        rt0, ctx0 = resolved[live[0]], ctxs[live[0]]
        spec, dtype = ctx0.render, rt0.meta.dtype
        try:
            chans = spec.resolve_channels(rt0.meta.size_c)
            zts = spec.plane_range(ctx0.z, ctx0.t, rt0.meta.size_z, rt0.meta.size_t)
        except Exception:
            return self._st_decline(live)  # the independent path answers 404
        if not _render_dtype_ok(dtype, chans):
            return self._st_decline(live)
        rects = [(resolved[i].x, resolved[i].y, resolved[i].w, resolved[i].h) for i in live]
        bx, by, bw_, bh_ = stile.bounding_rect(rects)
        nplanes = len(chans) * len(zts)
        if (self.max_tile_bytes
                and bw_ * bh_ * rt0.meta.bytes_per_pixel * nplanes > self.max_tile_bytes):
            return self._st_decline(live)  # the tiles may still fit alone
        buf = rt0.buffer
        # a degraded group gathers the coarse cover of the bounding
        # rectangle and upscales once (equal to its lanes' own upscales:
        # the plan's indices are absolute)
        dlevel = rt0.degrade_level
        read_level, upscale = rt0.level, None
        if dlevel is not None:
            cx0, cy0, crw, crh, uys, uxs = self._degrade_plan_rect(
                buf, rt0.level, dlevel, bx, by, bw_, bh_)
            coords = [(z, ch.index, t, cx0, cy0, crw, crh) for ch in chans for (z, t) in zts]
            read_level, upscale = dlevel, (uys, uxs, crh, crw)
        else:
            coords = [(z, ch.index, t, bx, by, bw_, bh_) for ch in chans for (z, t) in zts]
        slots: List[Optional[np.ndarray]] = [None] * len(coords)
        missing, owners = [], []
        use_cache = (upscale is None and self.plane_cache is not None
                     and _plane_cacheable(buf, dtype))
        for j, coord in enumerate(coords):
            arr = self._plane_cache_region(buf, read_level, coord, dtype) if use_cache else None
            if arr is not None:
                slots[j] = arr
            else:
                missing.append(coord)
                owners.append(j)
        self._count(st_host_pulls=len(coords) - len(missing))
        try:
            for j, arr in zip(owners, self._read(buf, missing, read_level) if missing else []):
                slots[j] = arr
            if upscale is not None:
                uys, uxs, crh, crw = upscale
                raw = np.stack(slots).reshape(len(chans), len(zts), crh, crw)[
                    :, :, uys[:, None], uxs[None, :]]
            else:
                raw = np.stack(slots).reshape(len(chans), len(zts), bh_, bw_)
            stack, tspec, tdtype = self._stage_stack(raw, spec, chans, dtype,
                                                     device_project=use_fused)
        except DeviceIdctError:
            _idct_failed(live, results)
            return set(live)
        except StoreUnavailableError as e:
            _unavailable(live, results, e)  # as a grouped read
            return set(live)
        except Exception:
            log.exception("super-tile gather failed; lanes serve independently")
            return self._st_decline(live)
        rel = [(resolved[i].x - bx, resolved[i].y - by) for i in live]
        bucket = (self._bucket(max(r[2] for r in rects), max(r[3] for r in rects))
                  if use_fused and spec.format == "png" else None)
        if bucket is None:
            return self._supertile_host(live, rel, resolved, results, stack, spec, tspec,
                                        tdtype)
        bw_b, bh_b = bucket
        size_groups: Dict[Tuple[int, int], List[int]] = {}
        for j, i in enumerate(live):
            size_groups.setdefault((resolved[i].w, resolved[i].h), []).append(j)
        self._count(st_groups=1, st_device_lanes=len(live))
        stile.SUPERTILE_SIZE.observe(len(live))
        if self._get_mesh() is not None:
            return self._supertile_mesh(live, rel, stack, tspec, tdtype, size_groups, pending)
        stile.SUPERTILE_LANES.inc(len(live), path="device")
        try:
            INJECTOR.fire("render.supertile")
            tables, luts = self._render_tables_for(tspec, tdtype)
            packed = rengine.packed_rgb_tables(tables, luts)
            with self.dispatcher.stream_context():
                planes = bits_tensor(stack).to(self.device, non_blocking=True)
                start = self._mark_timing()
                cut = stile.composite_carve_torch(
                    planes, tables, luts, [(ry, rx) for rx, ry in rel], bh_b, bw_b,
                    packed=packed)
                self._st_timed(start, stack.nbytes + packed.nbytes
                               + len(live) * bh_b * bw_b * 3)
                subs = {}
                for size, js in size_groups.items():
                    subs[size] = cut if len(js) == len(live) else cut.index_select(
                        0, torch.tensor(js).to(cut.device, non_blocking=True))
        except Exception as e:
            log.exception("super-tile composite failed; lanes -> 500")
            pending.append((list(live), self.dispatcher.failed_group(e)))
            return set(live)
        for size, js in size_groups.items():
            carved.setdefault(size + bucket, []).append(([live[j] for j in js], subs[size]))
        return set(live)

    def _supertile_mesh(self, live, rel, stack, tspec, tdtype, size_groups, pending) -> set:
        """A super-tile fused on the mesh: one ``submit_supertile`` group
        per lane size, each slot compositing and carving its window of
        the bounding stack. A failure answers 500 for its lanes."""
        stile.SUPERTILE_LANES.inc(len(live), path="mesh")
        try:
            INJECTOR.fire("render.supertile")
            tables, luts = self._render_tables_for(tspec, tdtype)
        except Exception as e:
            log.exception("super-tile tables failed; lanes -> 500")
            pending.append((list(live), self.dispatcher.failed_group(e)))
            return set(live)
        for (w, h), js in size_groups.items():
            lane_ids = [live[j] for j in js]
            try:
                fut = self.dispatcher.submit_supertile(
                    stack, tables, luts, [(rel[j][0], rel[j][1], w, h) for j in js], w, h,
                    self._render_filter, "rle", lane_ids)
                self._count(st_encode_groups=1)
            except Exception as e:
                fut = self.dispatcher.failed_group(e)
            pending.append((lane_ids, fut))
        return set(live)

    def _submit_carved(self, carved, pending) -> None:
        """One staged ``rle`` encode group per (w, h, bucket) over every
        super-tile of the batch: the carved batches of a class are joined
        on the queue's stream, so two super-tiles of one batch share a
        group as their lanes would unfused."""
        for (w, h, _, _), parts in carved.items():
            lane_ids = [i for ids, _ in parts for i in ids]
            try:
                tiles = parts[0][1]
                if len(parts) > 1:
                    with self.dispatcher.stream_context():
                        tiles = torch.cat([t for _, t in parts])
                fut = self.dispatcher.submit(
                    tiles, h, 1 + w * 3, 3, self._render_filter, "rle", lane_ids,
                    [(w, h)] * len(lane_ids), 8, 2, staged=True)
                self._count(st_encode_groups=1)
            except Exception as e:
                fut = self.dispatcher.failed_group(e)
            pending.append((lane_ids, fut))

    def _st_decline(self, live) -> set:
        """Return a group's lanes to the independent path, counted."""
        self._count(st_fallback_lanes=len(live))
        stile.SUPERTILE_FALLBACK.inc(len(live))
        return set()

    def _mark_timing(self):
        """A timing event recorded on the current stream; None on the CPU."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _st_timed(self, start, nbytes: int) -> None:
        """Close a super-tile's composite + carve timing (``start`` from
        ``_mark_timing``) on the current stream and keep it, with the
        ``nbytes`` it must move, for ``supertile_snapshot``."""
        if start is None:
            return
        end = self._mark_timing()
        with self._stats_lock:
            self._drain_st_events()
            self._st_events.append((start, end, nbytes))

    def _supertile_host(self, live, rel, resolved, results, stack, spec, tspec, tdtype) -> set:
        """The host route of a super-tile (JPEG, ``device_deflate=False``,
        lanes larger than every bucket): one numpy composite (tables of
        ``tspec``/``tdtype``), a carve and an encode per lane, as in the
        JAX package. Counted in ``render.host_lanes`` and
        ``supertile.host_lanes``."""
        try:
            tables, luts = self._render_tables_for(tspec, tdtype)
            rgb = rengine.render_host(stack, tables, luts)
        except Exception:
            log.exception("super-tile host composite failed; lanes serve independently")
            return self._st_decline(live)
        self._count(st_groups=1, st_host_lanes=len(live))
        self.render_host_lanes += len(live)
        stile.SUPERTILE_SIZE.observe(len(live))
        stile.SUPERTILE_LANES.inc(len(live), path="host")
        rengine.RENDER_TILES.inc(len(live), path="host", format=spec.format)
        for (rx, ry), i in zip(rel, live):
            rt = resolved[i]
            try:
                tile_rgb = stile.carve_host(rgb, rx, ry, rt.w, rt.h)
                if spec.format == "png":
                    results[i] = rengine.png_from_rgb_host(tile_rgb, self._render_filter)
                else:
                    results[i] = rengine.encode_jpeg(np.ascontiguousarray(tile_rgb), spec.quality)
            except Exception:
                log.exception("super-tile carve encode failed for lane %d", i)
                results[i] = None
        return set(live)

    def _render_host_lane(self, i, ctx, lane, results) -> None:
        """One lane on the host mirror: numpy composite (+ mask) and the
        numpy twin of the device stream (the fused chain's PNG bytes), or
        Pillow JPEG (None without Pillow, -> 404)."""
        self.render_host_lanes += 1
        spec = ctx.render
        try:
            stack = lane.stack
            if isinstance(stack, torch.Tensor):
                stack = self._pull_crop(stack, lane.dtype)
            tables, luts = self._render_tables_for(lane.spec, lane.dtype)
            if spec.format == "png":
                results[i] = rengine.render_png_host(stack, tables, luts, self._render_filter,
                                                     lane.mask)
            else:
                rgb = rengine.render_host(stack, tables, luts, lane.mask)
                results[i] = rengine.encode_jpeg(rgb, spec.quality)
            rengine.RENDER_TILES.inc(path="host", format=spec.format)
        except Exception:
            log.exception("host render failed for lane %d", i)
            results[i] = None

    def _stage_stack(self, stack, spec, chans, dtype, device_project):
        """The shared pointwise tail of render staging (the JAX package's
        ``_stage_stack``), one implementation for the per-lane and the
        super-tile paths (their byte identity depends on it): quantize
        float/32-bit channels onto the 16-bit bin space (host float64;
        the tables then come from the spec without windows over uint16),
        project in integer arithmetic (on the device when
        ``device_project``), view signed pixels as their unsigned index.
        (C, Z, H, W) -> ((C, H, W) unsigned, table spec, table dtype)."""
        tspec, tdtype = spec, dtype
        if not rengine.renderable_dtype(dtype):
            q = np.empty(stack.shape, dtype=np.uint16)
            for ci, ch in enumerate(chans):
                win = ch.window if ch.window is not None else rengine.default_window(dtype)
                q[ci] = rengine.quantize_to_u16(stack[ci], win)
            stack = q
            tspec, tdtype = spec.without_windows(), np.dtype(np.uint16)
        if spec.projection is None or stack.shape[1] == 1:
            stack = stack[:, 0]
        elif device_project:
            out = project_torch(bits_tensor(stack).to(self.device), spec.projection,
                                signed=stack.dtype.kind == "i")
            stack = out.cpu().numpy().view(stack.dtype)
        else:
            stack = project_np(stack, spec.projection)
        return rengine.unsigned_view(np.ascontiguousarray(stack)), tspec, tdtype

    def _plane_cache_region(self, buf, level, coord, dtype, device=False):
        """One (z, c, t) region cropped from its plane in the plane cache
        (whose admission sees every touch, so a repeated projection pan
        stages its planes once); None when the crop would clamp at the
        plane's edge, the plane is not resident, or anything fails: the
        caller reads it from the host. ``device=True`` keeps the crop on
        the device (bits, made on the queue's stream); otherwise it comes
        back to the host as ``dtype``, counted."""
        z, c, t, x, y, w, h = coord
        try:
            size_x, size_y = buf.level_size(level)
            if x + w > size_x or y + h > size_y:
                return None
            plane = self.plane_cache.get_plane(buf, level, z, c, t, read=self._stage_read)
            if plane is None:
                return None
            if device:
                with self.dispatcher.stream_context():
                    return self.plane_cache.crop_batch(plane, [(y, x)], h, w)[0]
            crop = self.plane_cache.crop_batch(plane, [(y, x)], h, w)[0]
            self._proj_host_pulls += 1
            return crop.cpu().numpy().view(dtype)
        except Exception:
            log.debug("plane-cache region read failed", exc_info=True)
            return None

    def _pull_crop(self, arr, dtype):
        """A slot that may be a device tensor made on the queue's stream,
        as a host array of ``dtype``; each pull is counted (the round trip
        the resident route avoids)."""
        if isinstance(arr, np.ndarray):
            return arr
        self._proj_host_pulls += 1
        self.dispatcher.synchronize_stream()
        return arr.cpu().numpy().view(dtype)

    # -- histogram lanes -----------------------------------------------------

    def _hist_table_for(self, dtype, window, bins: int) -> np.ndarray:
        """Value -> bin table of an integer pixel type, memoized."""
        key = (np.dtype(dtype).str, float(window[0]), float(window[1]), bins)
        return _memo(self._hist_tables, key,
                     lambda: ranalysis.build_bin_table(np.dtype(dtype), window, bins))

    def _quant_hist_table_for(self, bins: int) -> np.ndarray:
        return _memo(self._hist_tables, ("quant", bins), lambda: ranalysis.quant_bin_table(bins))

    def _analysis_batch_lanes(self, idxs, resolved, ctxs, results) -> None:
        """Histogram lanes: read each lane's channel regions (grouped per
        image), map them to bin indices through host-built tables, reduce
        them on the device (``_reduce_histogram_jobs``) and write each
        lane's JSON body. A bad channel or pixel type, or a failed read,
        leaves the lane None (404); a region whose channels exceed
        ``max_tile_bytes`` gets a 413 marker."""
        plans: Dict[int, tuple] = {}
        by_image: Dict[Tuple[int, int], List[int]] = {}
        for i in idxs:
            rt, ctx = resolved[i], ctxs[i]
            try:
                chans = ctx.analysis.resolve_channels(rt.meta.size_c)
            except Exception:
                log.debug("bad histogram channel for image %d", ctx.image_id, exc_info=True)
                continue
            d = rt.meta.dtype
            if not (rengine.renderable_dtype(d) or rengine.quantizable_dtype(d)):
                continue
            if (self.max_tile_bytes
                    and rt.w * rt.h * rt.meta.bytes_per_pixel * len(chans) > self.max_tile_bytes):
                results[i] = RequestTooLargeError(
                    f"Histogram region {rt.w}x{rt.h} x {len(chans)} channels exceeds "
                    f"max-tile-bytes ({self.max_tile_bytes})")
                continue
            coords = [(ctx.z, ch.index, ctx.t, rt.x, rt.y, rt.w, rt.h) for ch in chans]
            plans[i] = (chans, coords)
            by_image.setdefault((rt.meta.image_id, rt.level), []).append(i)

        jobs: List[Tuple[int, list]] = []
        for (image_id, level), lanes in by_image.items():
            buf = resolved[lanes[0]].buffer
            try:
                planes = self._read(buf, [c for i in lanes for c in plans[i][1]], level)
            except DeviceIdctError:
                _idct_failed(lanes, results)
                continue
            except StoreUnavailableError as e:
                _unavailable(lanes, results, e)
                continue
            except Exception:
                log.exception("histogram read failed for image %d; lanes -> 404", image_id)
                continue
            pos = 0
            for i in lanes:
                chans, coords = plans[i]
                lane_planes = planes[pos : pos + len(coords)]
                pos += len(coords)
                rt, spec = resolved[i], ctxs[i].analysis
                try:
                    entry = []
                    for ch, plane in zip(chans, lane_planes):
                        window = ranalysis.resolve_window(ch, rt.meta.dtype, spec.use_pixel_range,
                                                          plane=plane)
                        if rengine.renderable_dtype(rt.meta.dtype):
                            tab = self._hist_table_for(rt.meta.dtype, window, spec.bins)
                            idx_plane = rengine.unsigned_view(np.ascontiguousarray(plane))
                        else:  # float/32-bit pixels: the 16-bit bin space
                            idx_plane = rengine.quantize_to_u16(plane, window)
                            tab = self._quant_hist_table_for(spec.bins)
                        entry.append((ch, window, idx_plane, tab))
                    jobs.append((i, entry))
                except Exception:
                    log.exception("histogram staging failed for lane %d", i)
        if jobs:
            self._reduce_histogram_jobs(jobs, ctxs, resolved, results)

    def _reduce_histogram_jobs(self, jobs, ctxs, resolved, results) -> None:
        """Group the staged (plane, table) pairs by shape and reduce each
        group in one ``histogram_batch`` on the device (``histogram_host``
        on the host engine); a device group that fails answers 500 for its
        lanes (no host mirror behind it)."""
        counts_map: Dict[Tuple[int, int], np.ndarray] = {}
        groups: Dict[tuple, List[Tuple[int, int]]] = {}
        for j, (i, entry) in enumerate(jobs):
            for e, (_ch, _win, idx_plane, tab) in enumerate(entry):
                key = (idx_plane.shape, idx_plane.dtype.str, tab.shape[0],
                       ctxs[i].analysis.bins)
                groups.setdefault(key, []).append((j, e))
        failed: set = set()
        for (_shape, _dstr, _k, bins), members in groups.items():
            planes = np.stack([jobs[j][1][e][2] for j, e in members])
            tabs = np.stack([jobs[j][1][e][3] for j, e in members])
            if self.device is None:
                # the host engine: the numpy reduction (path host)
                counts = ranalysis.histogram_host(planes, tabs, bins)
                ranalysis.HIST_TILES.inc(len(members), path="host")
                for (j, e), c in zip(members, counts):
                    counts_map[(j, e)] = c
                continue
            events = None
            if self.device.type == "cuda":
                events = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
            mesh = self._get_mesh()
            if mesh is not None:
                events = None
            try:
                INJECTOR.fire("analysis.engine")
                if mesh is not None:
                    counts = ranalysis.sharded_histogram_batch(mesh, planes, tabs, bins)
                else:
                    counts = ranalysis.histogram_batch(planes, tabs, bins, self.device, events)
            except Exception:
                log.exception("device histogram failed; lanes -> 500")
                self._count(hist_failed_groups=1)
                failed.update(jobs[j][0] for j, _ in members)
                continue
            self._count(hist_groups=1, hist_lanes=len(members))
            ranalysis.HIST_TILES.inc(len(members), path="device" if mesh is None else "mesh")
            if events is not None:
                ms = events[0].elapsed_time(events[1])
                with self._stats_lock:
                    self._stats_ms["hist"] += ms
                    self._stats["hist_timed_groups"] += 1
                    self._stats["hist_bytes"] += planes.nbytes + tabs.nbytes + counts.nbytes
            for (j, e), c in zip(members, counts):
                counts_map[(j, e)] = c
        for j, (i, entry) in enumerate(jobs):
            if i in failed:
                results[i] = InternalError("device histogram failed")
                continue
            try:
                spec, ctx, rt = ctxs[i].analysis, ctxs[i], resolved[i]
                ch_results = []
                for e, (ch, window, _p, _t) in enumerate(entry):
                    counts = counts_map[(j, e)]
                    ch_results.append({
                        "index": ch.index,
                        "window": [round(float(window[0]), 6), round(float(window[1]), 6)],
                        "counts": [int(x) for x in counts],
                        "stats": ranalysis.stats_from_counts(counts, window, spec.bins),
                    })
                results[i] = ranalysis.histogram_body(
                    ctx.image_id, ctx.z, ctx.t, (rt.x, rt.y, rt.w, rt.h), ctx.resolution,
                    spec, ch_results)
            except Exception:
                log.exception("histogram assembly failed for lane %d", i)


def _lane_unavailable(e: Exception) -> ServiceUnavailableError:
    """The 503 marker of a lane whose store's breaker is open."""
    return ServiceUnavailableError(str(e), retry_after_s=getattr(e, "retry_after_s", 1.0) or 1.0)


def _unavailable(lanes, results, e: Exception) -> None:
    """Every lane of a read whose store's breaker is open answers 503."""
    log.warning("store unavailable: %s", e)
    marker = _lane_unavailable(e)
    for i in lanes:
        results[i] = marker


def _idct_failed(lanes, results) -> None:
    """The lanes of a read whose device IDCT failed answer 500."""
    log.exception("device IDCT failed; lanes -> 500")
    for i in lanes:
        results[i] = InternalError("device IDCT failed")


def _png_lane(tile: np.ndarray) -> bool:
    """A tile the PNG lanes take: 8/16-bit, grey (h, w) or RGB (h, w, 3)."""
    return tile.dtype in _PNG_DTYPES and (
        tile.ndim == 2 or (tile.ndim == 3 and tile.shape[2] == 3))


def _pad_batch(tiles, bh, bw, dtype, samples) -> np.ndarray:
    """Tiles zero-padded right and bottom into one (B, bh, bw[, samples])
    batch."""
    shape = (len(tiles), bh, bw) + ((samples,) if samples > 1 else ())
    batch = np.zeros(shape, dtype=dtype)
    for j, t in enumerate(tiles):
        batch[j, : t.shape[0], : t.shape[1]] = t
    return batch


def _render_dtype_ok(dtype, chans) -> bool:
    """Whether channels of ``dtype`` render: 8/16-bit integers, or
    float/32-bit ones quantized, a float only with every window explicit
    (float pixels have no bounded type range to default to)."""
    if rengine.renderable_dtype(dtype):
        return True
    if not rengine.quantizable_dtype(dtype):
        return False
    return dtype.kind != "f" or all(ch.window is not None for ch in chans)


def _plane_cacheable(buf, dtype) -> bool:
    """Whether render reads of ``buf`` may crop from the plane cache: one
    sample per pixel, and 8/16-bit pixels (the cache holds their bits)."""
    return getattr(buf, "samples", 1) == 1 and np.dtype(dtype).itemsize <= 2


def _memo(store: dict, key, build):
    """``store[key]``, built on a miss; the store is cleared when it holds
    256 entries (coarse but bounded)."""
    hit = store.get(key)
    if hit is None:
        hit = build()
        if len(store) >= 256:
            store.clear()
        store[key] = hit
    return hit


def _stamp_device(ctxs, t_submit: float):
    """A group future's callback stamping ``device`` (submission to
    resolution) on its lanes' flight records."""
    def stamp(_group_fut):
        dt = time.perf_counter() - t_submit
        for ctx in ctxs:
            if ctx.obs is not None:
                ctx.obs.stamp("device", dt)
    return stamp


def _count_render_group(group_fut) -> None:
    """``render_tiles_total`` of a render encode group that came back."""
    if group_fut.exception() is None:
        rengine.RENDER_TILES.inc(len(group_fut.result()), path="device", format="png")


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
