"""Viewer-protocol adapters (counterpart of ``omero_ms_pixel_buffer_tpu/
http/protocols/``): thin grammar layers over the native ``/render`` core.

DZI (OpenSeadragon's default tile source), IIIF Image API and the Iris
RESTful dialect each translate their URLs into the same ``TileCtx`` and
``RenderSpec`` a native ``/render`` request builds and serve them through
the front's one serving path, so an adapter tile is byte-identical to its
native request, shares its ETag and cache entry, and is shed, degraded
and timed out as any tile is. Grammar errors answer 400; dialect features
the pipeline cannot serve byte-identically answer 501. Which adapters
are on and their tile grids come from the YAML ``protocols:`` block (all
on, 256 pixels, by default), held by the server (``server.tile_sizes``).

On the port's asyncio front a handler takes ``(server, groups, query,
headers, session key)`` and returns ``(status, headers, body)``;
``ROUTES`` is the route table the front matches, in order. Adapter
requests are counted per (dialect, kind) in ``protocol_requests_total``
(``/metrics``; ``request_counts`` for ``/healthz``).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, List, Optional, Tuple

from ...errors import ServiceUnavailableError, TileError
from ...io.stores import StoreUnavailableError
from ...tile_ctx import RegionDef, TileCtx
from ...utils.metrics import REGISTRY

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.protocols")

# an open breaker answers 503 with Retry-After, never the 404 of an
# unknown image
_UNAVAILABLE = (StoreUnavailableError, ServiceUnavailableError)

PROTOCOL_REQUESTS = REGISTRY.counter(
    "protocol_requests_total",
    "Viewer-protocol adapter requests by dialect and kind",
)


def count(dialect: str, kind: str) -> None:
    PROTOCOL_REQUESTS.inc(dialect=dialect, kind=kind)


def request_counts() -> Dict[str, int]:
    """Adapter requests by ``dialect.kind`` (``/healthz`` ``protocols``)."""
    return {f'{dict(k)["dialect"]}.{dict(k)["kind"]}': int(v)
            for k, v in PROTOCOL_REQUESTS.samples().items()}


def text(status: int, message: str, headers: Optional[dict] = None):
    """A plain-text answer, as aiohttp's ``web.Response(text=...)``."""
    return status, dict(headers or {}), message.encode()


async def image_level_sizes(server, image_id: int, key: Optional[str] = None
                            ) -> Optional[List[Tuple[int, int]]]:
    """[(size_x, size_y)] per pyramid level, or None (-> 404), looked up
    under the caller's session ``key`` where the metadata resolver applies
    ACLs. An open breaker raises (-> 503)."""
    svc = server.pipeline.pixels_service

    def lookup():
        try:
            buf = svc.get_pixel_buffer(image_id, session_key=key)
            if buf is None:
                return None
            return [buf.level_size(r) for r in range(buf.resolution_levels)]
        except _UNAVAILABLE:
            raise
        except Exception:
            log.debug("extent lookup failed for image %d", image_id, exc_info=True)
            return None

    return await asyncio.get_running_loop().run_in_executor(None, lookup)


async def levels_or_response(server, image_id: int, key: Optional[str] = None):
    """(level sizes, None) or (None, the error answer): an unknown image
    404, an open breaker 503 with ``Retry-After``."""
    try:
        sizes = await image_level_sizes(server, image_id, key)
    except _UNAVAILABLE as e:
        retry = getattr(e, "retry_after_s", None) or 1.0
        return None, text(503, "Service unavailable",
                          {"Retry-After": str(max(1, int(retry + 0.999)))})
    if sizes is None:
        return None, text(404, "Cannot find Image")
    return sizes, None


async def serve_translated(server, query: dict, headers: dict, key: Optional[str],
                           image_id: int, x: int, y: int, w: int, h: int,
                           resolution: Optional[int], overrides: Optional[dict] = None,
                           burst=None):
    """The shared tail of every adapter tile: the ctx and spec a native
    ``/render`` request with these parameters builds (the rendering query
    parameters ride along; ``overrides`` force the dialect's format or
    model), served through the front's one path. ``burst`` is the
    dialect's tile grid (``render.supertile.BurstHint``), transient."""
    q = dict(query)
    q.update(overrides or {})
    try:
        ctx = TileCtx.from_params(
            {"imageId": str(image_id), "z": q.pop("z", 0), "c": 0, "t": q.pop("t", 0)}, key)
    except TileError as e:
        return text(400, e.message)
    spec, error = server.build_render_spec(q, 0)
    if error is not None:
        return text(400, error)
    ctx.render = spec
    ctx.format = spec.format
    ctx.region = RegionDef(x, y, w, h)
    ctx.resolution = resolution
    ctx.burst = burst
    return await server.serve(ctx, headers)


def routes(enabled: Dict[str, bool]):
    """[(compiled path pattern, handler)] of every adapter ``enabled``
    names (the YAML ``protocols.<name>.enabled``; a disabled one's paths
    are unrouted: 405, as the JAX app registers no route for it)."""
    from . import dzi, iiif, iris

    modules = {"dzi": dzi, "iiif": iiif, "iris": iris}
    return [r for name, m in modules.items() if enabled.get(name, True) for r in m.ROUTES]
