"""DZI (Deep Zoom Image) adapter, OpenSeadragon's default dialect (copy of
``omero_ms_pixel_buffer_tpu/http/protocols/dzi.py``).

- ``GET /dzi/{image}.dzi``: the XML descriptor, byte for byte the JAX
  package's;
- ``GET /dzi/{image}_files/{level}/{col}_{row}.{fmt}``: tiles of the DZI
  ladder, level N being the image scaled by 2^(maxLevel - N) with
  maxLevel = ceil(log2(max(W, H))).

DZI level L serves pyramid resolution ``maxLevel - L``; a level the
stored pyramid does not back (coarser than its last level, or a
non-dyadic level) answers 404. The rendering query parameters (``c``,
``m``, ``maps``, ``q``, ``roi``, ``z``, ``t``) ride along.
"""

from __future__ import annotations

import re

from ...errors import BadRequestError
from ...render.supertile import BurstHint
from . import count, levels_or_response, serve_translated, text

_FORMATS = {"png": "png", "jpeg": "jpeg", "jpg": "jpeg"}

_DESCRIPTOR = (
    '<?xml version="1.0" encoding="UTF-8"?>\n'
    '<Image xmlns="http://schemas.microsoft.com/deepzoom/2008" '
    'Format="{fmt}" Overlap="0" TileSize="{tile}">'
    '<Size Height="{h}" Width="{w}"/></Image>'
)


def max_level(w: int, h: int) -> int:
    """ceil(log2(max(w, h))): the ladder's finest level."""
    level, extent = 0, max(int(w), int(h))
    while (1 << level) < extent:
        level += 1
    return level


def descriptor_xml(w: int, h: int, tile_size: int, fmt: str = "png") -> bytes:
    return _DESCRIPTOR.format(fmt=fmt, tile=tile_size, w=w, h=h).encode("ascii")


def _dyadic(extent: int, res: int, actual: int) -> bool:
    """Whether a stored level's extent is the ladder's 2^res halving
    (floor or ceil)."""
    lo = max(1, extent >> res)
    hi = max(1, (extent + (1 << res) - 1) >> res)
    return lo <= actual <= hi


def resolve_tile(level_sizes, dzi_level: int, col: int, row: int, tile_size: int):
    """(resolution, x, y, w, h) of one DZI tile, or None for a level or
    tile the pyramid does not back (-> 404)."""
    w0, h0 = level_sizes[0]
    top = max_level(w0, h0)
    if dzi_level > top:
        return None  # finer than the image
    res = top - dzi_level
    if res >= len(level_sizes):
        return None  # coarser than the stored pyramid
    lw, lh = level_sizes[res]
    if not (_dyadic(w0, res, lw) and _dyadic(h0, res, lh)):
        return None  # a non-dyadic level does not back this rung
    x, y = col * tile_size, row * tile_size
    if x >= lw or y >= lh:
        return None  # off the level's grid
    return res, x, y, min(tile_size, lw - x), min(tile_size, lh - y)


async def handle_descriptor(server, groups, query, headers, key):
    count("dzi", "descriptor")
    sizes, err = await levels_or_response(server, int(groups[0]), key)
    if err is not None:
        return err
    w, h = sizes[0]
    return 200, {"Content-Type": "application/xml"}, descriptor_xml(w, h, server.tile_sizes["dzi"])


async def handle_tile(server, groups, query, headers, key):
    count("dzi", "tile")
    image_id = int(groups[0])
    fmt = _FORMATS.get(groups[4])
    if fmt is None:
        return text(400, f"Unsupported DZI format: {groups[4]!r} (png|jpeg|jpg)")
    sizes, err = await levels_or_response(server, image_id, key)
    if err is not None:
        return err
    tile_size = server.tile_sizes["dzi"]
    try:
        placed = resolve_tile(sizes, int(groups[1]), int(groups[2]), int(groups[3]), tile_size)
    except BadRequestError as e:
        return text(400, e.message)
    if placed is None:
        return text(404, "No such tile")
    res, x, y, w, h = placed
    # a level row is a known rectangle on the TileSize grid
    return await serve_translated(server, query, headers, key, image_id, x, y, w, h, res,
                                  overrides={"format": fmt},
                                  burst=BurstHint(tile_size, tile_size))


ROUTES = [
    (re.compile(r"^/dzi/(\d+)\.dzi$"), handle_descriptor),
    (re.compile(r"^/dzi/(\d+)_files/(\d+)/(\d+)_(\d+)\.(\w+)$"), handle_tile),
]
