"""HTTP/1.1 front on ``asyncio.start_server`` (counterpart of the /tile,
/render and /histogram routes of ``omero_ms_pixel_buffer_tpu/http/
server.py``, without aiohttp).

Routes: ``GET``/``HEAD /tile/{imageId}/{z}/{c}/{t}`` (query x/y/w/h/
resolution/format), ``GET``/``HEAD /render/{imageId}/{z}/{c}/{t}`` (the
same region query plus the render dialect of ``render/model.py``: c, m,
maps, p, roi, format png|jpeg, q; the path's c is the default channel),
``GET``/``HEAD /histogram/{imageId}/{z}/{c}/{t}`` (the same region query
plus ``bins``, ``usePixelsTypeRange`` and the render channel grammar of
``c``; a JSON body, ``render/analysis.py``),
``GET``/``HEAD /healthz`` and ``OPTIONS`` on any path (the service
discovery JSON). Any other method on a route, and any
unrouted path, answers 405 ``405: Method Not Allowed``, as the JAX
package's aiohttp app does with its catch-all OPTIONS route. HEAD answers
the GET's status and headers without the body. Connections are
keep-alive. Sessions: a ``sessionid`` cookie maps to an OMERO session key
through an in-memory map; with ``dev`` every cookie value is its own key
(the echo store). Every path but ``/healthz`` and every method but
OPTIONS needs a session: a missing or unknown cookie is 403 "Permission
denied", a bad parameter 400 with the parse message, an unknown image
404, as the JAX package answers. On ``/render`` a grammar error or an
unknown LUT is a 400 with the JAX message, a channel out of range a 404,
a projection stack over the tile budget a 413; ``annotations=`` is
ignored, as the JAX front does without an annotation store. On
``/histogram`` a bad ``bins`` or ``c`` is a 400 with the JAX message, a
channel out of range a 404, a region whose channels exceed the tile
budget a 413.

Tiles, renders and histograms go through the result cache's memory tier
(``cache/``), keyed by ``TileCtx.cache_key`` after the w/h = 0 spelling is rewritten to the
full plane's size. A 200 carries the content ``ETag``, ``Cache-Control:
private, max-age=60`` and ``X-Cache: hit|miss``; an ``If-None-Match``
that matches the ETag answers 304, on a hit or on a fresh render.
Concurrent misses with one ``TileCtx.dedupe_key`` share one pipeline
execution (single-flight), which fills the cache once.
"""

from __future__ import annotations

import asyncio
import http
import json
import logging
import re
import time
from http.cookies import CookieError, SimpleCookie
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qsl, urlsplit

from .. import __version__
from ..cache.result_cache import MAX_AGE_S, CachedTile, TileResultCache, etag_matches
from ..cache.single_flight import SingleFlight
from ..dispatch.batcher import BatchingTileWorker
from ..errors import TileError
from ..ops.kernels import launch_counts
from ..render.analysis import HistogramSpec
from ..render.model import RenderSpec
from ..runtime.native import host_engine
from ..tile_ctx import TileCtx

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.http")

CONTENT_TYPES = {
    None: "application/octet-stream",
    "png": "image/png",
    "tif": "image/tiff",
    "jpeg": "image/jpeg",
    "json": "application/json",  # histogram bodies
}

JSON_TYPE = "application/json; charset=utf-8"
_TILE_PATH = re.compile(r"^/tile/([^/]+)/([^/]+)/([^/]+)/([^/]+)$")
_RENDER_PATH = re.compile(r"^/render/([^/]+)/([^/]+)/([^/]+)/([^/]+)$")
_HISTOGRAM_PATH = re.compile(r"^/histogram/([^/]+)/([^/]+)/([^/]+)/([^/]+)$")
# what a routed path allows (aiohttp's Allow header): GET with its HEAD,
# and the catch-all OPTIONS; an unrouted path allows OPTIONS alone
_ROUTE_METHODS = "GET,HEAD,OPTIONS"
# the discovery document (getMicroserviceDetails)
DISCOVERY = {"provider": "PixelBufferMicroservice", "version": __version__, "features": []}
_MAX_HEADERS = 100
_MAX_BODY = 1 << 20
# per-request deadline (the JAX package's event-bus-send-timeout default)
REQUEST_BUDGET_S = 15.0
# JPEG quality without a q= parameter (the JAX package's render.jpeg-quality)
JPEG_QUALITY = 90


class TileServer:
    """The asyncio HTTP front over a batching worker."""

    def __init__(
        self,
        worker: BatchingTileWorker,
        dev: bool = False,
        sessions: Optional[Dict[str, str]] = None,
        gpu: Optional[dict] = None,
    ):
        self.worker = worker
        self.pipeline = worker.pipeline
        self.dev = dev
        self.sessions = dict(sessions or {})
        self.gpu = gpu
        self.cache = TileResultCache()
        self._flight = SingleFlight()
        self._server: Optional[asyncio.AbstractServer] = None
        self._writers: set = set()  # open connections, closed at shutdown
        self.port: Optional[int] = None

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start the worker and listen; returns the bound port."""
        await self.worker.start()
        self._server = await asyncio.start_server(self._client, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            for writer in list(self._writers):
                writer.close()  # idle keep-alive connections end here
            await self._server.wait_closed()
            self._server = None
        await self.worker.close()

    # -- connection loop ---------------------------------------------------

    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        try:
            while True:
                request = await self._read_request(reader)
                if request is None:
                    break
                method, target, version, headers = request
                keep_alive = _keep_alive(version, headers)
                status, out_headers, body = await self._dispatch(method, target, headers)
                _write_response(writer, status, out_headers, body, keep_alive,
                                head=method == "HEAD")
                await writer.drain()
                if not keep_alive:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except _BadRequest as e:
            _write_response(writer, 400, {}, str(e).encode(), False)
        finally:
            self._writers.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionError:
                pass

    @staticmethod
    async def _read_request(reader):
        line = await reader.readline()
        if not line:
            return None
        try:
            method, target, version = line.decode("latin-1").rstrip("\r\n").split(" ")
        except ValueError:
            raise _BadRequest("Malformed request line") from None
        headers: Dict[str, str] = {}
        for _ in range(_MAX_HEADERS + 1):
            raw = await reader.readline()
            if raw in (b"\r\n", b"\n", b""):
                break
            name, sep, value = raw.decode("latin-1").partition(":")
            if not sep:
                raise _BadRequest("Malformed header")
            headers[name.strip().lower()] = value.strip()
        else:
            raise _BadRequest("Too many headers")
        if "transfer-encoding" in headers:
            raise _BadRequest("Request bodies are not accepted")
        length = int(headers.get("content-length", "0") or 0)
        if length < 0 or length > _MAX_BODY:
            raise _BadRequest("Bad Content-Length")
        if length:
            await reader.readexactly(length)  # discarded: GET only
        return method, target, version, headers

    async def _dispatch(self, method: str, target: str, headers: Dict[str, str]
                        ) -> Tuple[int, dict, bytes]:
        parts = urlsplit(target)
        if method == "OPTIONS":
            return 200, {"Content-Type": JSON_TYPE}, json.dumps(DISCOVERY).encode()
        healthz = parts.path == "/healthz"
        m = render = histogram = None
        if not healthz:
            m = _TILE_PATH.match(parts.path)
            if m is None:
                m = render = _RENDER_PATH.match(parts.path)
            if m is None:
                m = histogram = _HISTOGRAM_PATH.match(parts.path)
        key = None
        if not healthz:
            key = self._session_key(headers.get("cookie"))
            if not key:
                return 403, {}, b"Permission denied"
        if method not in ("GET", "HEAD") or not (healthz or m):
            allow = _ROUTE_METHODS if healthz or m else "OPTIONS"
            return 405, {"Allow": allow}, b"405: Method Not Allowed"
        if healthz:
            return 200, {"Content-Type": JSON_TYPE}, json.dumps(self.health()).encode()
        query: Dict[str, str] = {}
        for k, v in parse_qsl(parts.query, keep_blank_values=True):
            query.setdefault(k, v)  # first value per key, as aiohttp's
        path_params = dict(zip(("imageId", "z", "c", "t"), m.groups()))
        if render is not None:
            ctx, error = self._render_ctx(path_params, query, key)
        elif histogram is not None:
            ctx, error = self._histogram_ctx(path_params, query, key)
        else:
            ctx, error = self._tile_ctx(path_params, query, key)
        if error is not None:
            return 400, {}, error.encode()
        return await self._serve(ctx, headers.get("if-none-match", ""))

    @staticmethod
    def _tile_ctx(path_params, query, key):
        """(ctx, None) for a /tile request, or (None, the 400 message)."""
        try:
            return TileCtx.from_params({**path_params, **query}, key), None
        except TileError as e:
            return None, e.message

    def _render_ctx(self, path_params, query, key):
        """(ctx, None) for a /render request, or (None, the 400 message):
        the path's ids, the RenderSpec of the query (the path's c is the
        default channel; named LUTs must be known), then the query's
        x/y/w/h/resolution, parsed in that order as the JAX front does."""
        try:
            ctx = TileCtx.from_params(path_params, key)
            spec = RenderSpec.from_params(query, default_channel=ctx.c,
                                          default_quality=JPEG_QUALITY)
        except TileError as e:
            return None, e.message
        for ch in spec.channels:
            if ch.lut is not None and ch.lut not in self.pipeline.lut_registry:
                return None, f"Unknown LUT: {ch.lut}"
        ctx.render = spec
        ctx.format = spec.format  # Content-Type and filename
        return _apply_region_params(ctx, query)

    def _histogram_ctx(self, path_params, query, key):
        """(ctx, None) for a /histogram request, or (None, the 400
        message): the path's ids, the HistogramSpec of the query (the
        path's c is the default channel; ``bins`` at most ``MAX_BINS``,
        the JAX ``analysis.max-bins`` default), then x/y/w/h/resolution, in
        the JAX front's order."""
        try:
            ctx = TileCtx.from_params(path_params, key)
            spec = HistogramSpec.from_params(query, default_channel=ctx.c)
        except TileError as e:
            return None, e.message
        ctx.analysis = spec
        ctx.format = "json"  # Content-Type and filename
        return _apply_region_params(ctx, query)

    async def _serve(self, ctx: TileCtx, inm: str) -> Tuple[int, dict, bytes]:
        """A parsed /tile, /render or /histogram request through the
        result cache."""
        await self._normalize_region(ctx)
        quality = self.pipeline.encode_signature()
        cache_key = ctx.cache_key(quality)
        entry = self.cache.get(cache_key)
        x_cache = "hit"
        if entry is None:
            x_cache = "miss"
            try:
                entry = await self._flight.do(ctx.dedupe_key(quality),
                                              lambda: self._render(ctx, cache_key))
            except TileError as e:
                return (e.code if e.code >= 1 else 500), {}, b""
        if inm and etag_matches(inm, entry.etag):
            return 304, _cache_headers(entry.etag), b""
        return 200, {
            "Content-Type": CONTENT_TYPES.get(ctx.format, "application/octet-stream"),
            "Content-Disposition": f'attachment; filename="{entry.filename}"',
            **_cache_headers(entry.etag),
            "X-Cache": x_cache,
        }, entry.body

    async def _render(self, ctx: TileCtx, cache_key: str) -> CachedTile:
        """One pipeline execution of a miss, memoized once per flight."""
        ctx.deadline = time.monotonic() + REQUEST_BUDGET_S
        body, meta = await self.worker.handle(ctx)
        entry = CachedTile(body, filename=meta["filename"])
        self.cache.put(cache_key, entry)
        return entry

    async def _normalize_region(self, ctx: TileCtx) -> None:
        """Rewrite w/h = 0 (the full plane) to the plane's size before any
        key derives from the region, so both spellings share one cache
        entry and one flight; an unknown image or level leaves it alone."""
        if ctx.region.width > 0 and ctx.region.height > 0:
            return
        extent = await asyncio.get_running_loop().run_in_executor(
            None, self._full_plane_extent, ctx)
        if extent is None:
            return
        if ctx.region.width == 0:
            ctx.region.width = extent[0]
        if ctx.region.height == 0:
            ctx.region.height = extent[1]

    def _full_plane_extent(self, ctx: TileCtx) -> Optional[Tuple[int, int]]:
        try:
            buf = self.pipeline.pixels_service.get_pixel_buffer(ctx.image_id)
            level = ctx.resolution or 0
            if buf is None or not 0 <= level < buf.resolution_levels:
                return None
            return buf.level_size(level)
        except Exception:
            return None

    def _session_key(self, cookie_header: Optional[str]) -> Optional[str]:
        if not cookie_header:
            return None
        try:
            jar = SimpleCookie(cookie_header)
        except CookieError:
            return None
        morsel = jar.get("sessionid")
        if morsel is None or not morsel.value:
            return None
        return morsel.value if self.dev else self.sessions.get(morsel.value)

    def health(self) -> dict:
        """/healthz body: kernel launch counters, the host engine and its
        lanes (oversize lanes; device-filtered lanes deflated on the host),
        the encode queue's (with its deflate mode and packer), the plane
        cache's, the batcher's (with its lone lanes and super-tile
        stamps), the result cache's, the render engine's, the histogram
        plane's and super-tile fusion's snapshots, the batched host reads
        (``reads``, with the RGB lanes sent to the device) and the JPEG
        device IDCT's (``jpeg``: its mode, calls and device ms)."""
        return {
            "status": "ok",
            "device": str(self.pipeline.device),
            "gpu": self.gpu,
            "kernels": launch_counts(),
            "host_engine": host_engine(),
            "host_png_lanes": self.pipeline.host_png_lanes,
            "device_deflate": self.pipeline.device_deflate,
            "host_deflate_lanes": self.pipeline.host_deflate_lanes,
            "render": {"enabled": True, **self.pipeline.render_snapshot()},
            "analysis": {"enabled": True, **self.pipeline.analysis_snapshot()},
            "supertile": {"enabled": self.worker.supertile,
                          "stamped_lanes": self.worker.stamped,
                          **self.pipeline.supertile_snapshot()},
            "queue": self.pipeline.device_queue_snapshot(),
            "plane_cache": self.pipeline.plane_cache_snapshot(),
            "batcher": self.worker.snapshot(),
            "result_cache": self.cache.snapshot(),
            "reads": self.pipeline.read_snapshot(),
            "jpeg": self.pipeline.pixels_service.idct.snapshot(),
        }


def create_server(
    registry_path: str, dev: bool = False, device: str = "cuda",
    buckets=(256, 512, 1024), queue_depth: int = 2,
    deflate_mode: str = "dynamic", packer: Optional[str] = None,
    device_deflate: bool = True, lut_dir: Optional[str] = None,
    supertile_enabled: bool = True,
) -> TileServer:
    """The service as ``python -m omero_ms_pixel_buffer_tpu_torch`` runs
    it: registry -> pixels service -> pipeline -> batcher -> HTTP front.
    ``deflate_mode`` is the device deflate mode (``dynamic``, ``rle`` or
    ``stored``), ``packer`` the bit packer (default
    ``device_deflate.default_packer``: ``OMPB_BITPACK``, else ``pallas``
    on CUDA); ``device_deflate=False`` filters PNG lanes on the device and
    deflates them on the host; ``lut_dir`` holds ``.lut`` files for
    ``/render``; ``supertile_enabled`` is the JAX ``supertile.enabled``
    (fusion on by default, with the JAX package's default limits). JPEG
    blocks' device IDCT (``OMPB_JPEG_DEVICE_IDCT=1``) runs on ``device``
    too; ``OMPB_MEMO_DIR`` keeps parsed TIFF IFD chains. On
    CUDA the kernels are built (or found built) here, so a build failure
    stops start-up; the host engine and the LUT registry are built (or
    found) here too, so their state shows on ``/healthz`` from the
    start."""
    from ..io.pixels_service import ImageRegistry, PixelsService
    from ..models.tile_pipeline import TilePipeline
    from ..runtime.device import gpu_info

    pipeline = TilePipeline(
        PixelsService(ImageRegistry(registry_path), device=device), buckets=tuple(buckets),
        queue_depth=queue_depth, device=device,
        device_deflate_mode=deflate_mode, packer=packer,
        device_deflate=device_deflate, lut_dir=lut_dir,
    )
    host_engine()
    pipeline.lut_registry  # noqa: B018 - read the LUT directory before serving
    gpu = None
    if pipeline.device.type == "cuda":
        from ..ops.kernels import _build

        _build.build()
        gpu = gpu_info(pipeline.device.index or 0)
    return TileServer(BatchingTileWorker(pipeline, supertile=supertile_enabled), dev=dev,
                      gpu=gpu)


class _BadRequest(Exception):
    pass


def _apply_region_params(ctx: TileCtx, query):
    """The query's x/y/w/h/resolution onto ``ctx``, the one parse of every
    query-region route (/render, /histogram): (ctx, None), or (None, the
    400 message)."""
    try:
        ctx.region.x = int(query.get("x", 0))
        ctx.region.y = int(query.get("y", 0))
        ctx.region.width = int(query.get("w", 0))
        ctx.region.height = int(query.get("h", 0))
        res = query.get("resolution")
        ctx.resolution = None if res is None else int(res)
    except (TypeError, ValueError) as e:
        return None, str(e)
    return ctx, None


def _keep_alive(version: str, headers: Dict[str, str]) -> bool:
    conn = headers.get("connection", "").lower()
    if version == "HTTP/1.0":
        return conn == "keep-alive"
    return conn != "close"


def _cache_headers(etag: str) -> dict:
    """Validator and freshness headers of a tile the cache saw. ``private``:
    tiles are authorized per session, so shared proxies must not keep them."""
    return {"ETag": etag, "Cache-Control": f"private, max-age={MAX_AGE_S}"}


def _write_response(writer, status: int, headers: dict, body: bytes,
                    keep_alive: bool, head: bool = False) -> None:
    """One response. A 304 has no body and no Content-Length; a HEAD
    answer keeps the GET's Content-Length and sends no body."""
    reason = http.HTTPStatus(status).phrase
    lines = [f"HTTP/1.1 {status} {reason}"]
    if body and "Content-Type" not in headers:
        headers = {**headers, "Content-Type": "text/plain; charset=utf-8"}
    for k, v in headers.items():
        lines.append(f"{k}: {v}")
    if status != 304:
        lines.append(f"Content-Length: {len(body)}")
    lines.append(f"Connection: {'keep-alive' if keep_alive else 'close'}")
    writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
                 + (b"" if head else body))
