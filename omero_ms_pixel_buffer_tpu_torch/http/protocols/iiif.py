"""IIIF Image API adapter, 2.1 and 3.0, the subset the pipeline serves
(copy of ``omero_ms_pixel_buffer_tpu/http/protocols/iiif.py``).

- ``GET /iiif/{image}/info.json``: the image information document (3.0;
  ``?version=2`` answers the 2.1 shape), the stored pyramid as ``sizes``
  and one ``tiles`` ladder, profile level0.
- ``GET /iiif/{image}/{region}/{size}/{rotation}/{quality}.{format}``:
  region ``full`` or ``x,y,w,h`` (clipped to the image); size
  ``max``/``full``, an exact ``w,h``/``w,``/``,h`` equal to a stored
  level's mapped region, or best-fit ``!w,h``; rotation 0;
  quality ``default``/``color``/``gray``; format ``png``/``jpg``.

Outside that subset the answer is 501 (``pct:`` regions, ``square``,
other sizes, rotation, ``bitonal``, other formats); malformed grammar is
400. A served request is the native ``/render`` request of its level.
"""

from __future__ import annotations

import json
import re
from typing import List, Tuple

from ...errors import BadRequestError, UnsupportedDialectError
from ...render.supertile import BurstHint
from . import count, levels_or_response, serve_translated, text


class IiifNotSupported(UnsupportedDialectError):
    """Valid IIIF grammar the pipeline cannot serve byte-exactly (501)."""


_FORMATS = {"png": "png", "jpg": "jpeg"}
_QUALITIES = {"default": {}, "color": {}, "gray": {"m": "g"}, "grey": {"m": "g"}}


def parse_region(region: str, w0: int, h0: int) -> Tuple[int, int, int, int]:
    """``full`` or ``x,y,w,h`` in the full-resolution frame, clipped to
    the extent (a region wholly outside is a 400)."""
    if region == "full":
        return 0, 0, w0, h0
    if region == "square":
        raise IiifNotSupported("square region is not supported")
    if region.startswith("pct:"):
        raise IiifNotSupported("pct: regions are not supported")
    parts = region.split(",")
    if len(parts) != 4:
        raise BadRequestError(f"Malformed IIIF region: {region!r}")
    try:
        x, y, w, h = (int(p) for p in parts)
    except ValueError:
        raise BadRequestError(f"Malformed IIIF region: {region!r}") from None
    if x < 0 or y < 0 or w <= 0 or h <= 0:
        raise BadRequestError(f"Invalid IIIF region: {region!r}")
    if x >= w0 or y >= h0:
        raise BadRequestError(f"IIIF region lies outside the image: {region!r}")
    return x, y, min(w, w0 - x), min(h, h0 - y)


def map_region_to_level(x: int, y: int, w: int, h: int,
                        level_sizes: List[Tuple[int, int]], res: int
                        ) -> Tuple[int, int, int, int]:
    """The covering region at pyramid level ``res`` (the integer mapping
    of the degraded-read plan)."""
    w0, h0 = level_sizes[0]
    lw, lh = level_sizes[res]
    x0 = x * lw // w0
    y0 = y * lh // h0
    x1 = min(lw, ((x + w) * lw + w0 - 1) // w0)
    y1 = min(lh, ((y + h) * lh + h0 - 1) // h0)
    return x0, y0, max(1, x1 - x0), max(1, y1 - y0)


def parse_size(size: str, candidates: List[Tuple[int, Tuple[int, int, int, int]]]) -> int:
    """The pyramid level whose mapped region matches the size exactly
    (never resampled); ``candidates`` is [(resolution, region)] finest
    first."""
    if size in ("max", "full"):
        return candidates[0][0]
    if size.startswith("^"):
        raise IiifNotSupported("upscaling (^) is not supported")
    if size.startswith("pct:"):
        raise IiifNotSupported("pct: sizes are not supported")
    best_fit = size.startswith("!")
    if best_fit:
        size = size[1:]
    parts = size.split(",")
    if len(parts) != 2 or (parts[0] == "" and parts[1] == ""):
        raise BadRequestError(f"Malformed IIIF size: {size!r}")
    try:
        sw = int(parts[0]) if parts[0] else None
        sh = int(parts[1]) if parts[1] else None
    except ValueError:
        raise BadRequestError(f"Malformed IIIF size: {size!r}") from None
    if (sw is not None and sw <= 0) or (sh is not None and sh <= 0):
        raise BadRequestError(f"Invalid IIIF size: {size!r}")
    if best_fit:
        if sw is None or sh is None:
            raise BadRequestError(f"Malformed IIIF best-fit size: !{size!r}")
        for res, (_x, _y, w, h) in candidates:
            if w <= sw and h <= sh:
                return res
        raise IiifNotSupported("no stored pyramid level fits the requested size")
    for res, (_x, _y, w, h) in candidates:
        if (sw is None or w == sw) and (sh is None or h == sh):
            return res
    raise IiifNotSupported(
        "arbitrary scaling is not supported; request one of the advertised sizes")


def parse_rotation(rotation: str) -> None:
    if rotation in ("0", "360"):
        return
    raise IiifNotSupported(f"rotation {rotation!r} is not supported (only 0)")


def parse_quality_format(last: str) -> Tuple[dict, str]:
    """``{quality}.{format}`` -> (render parameter overrides, format)."""
    if "." not in last:
        raise BadRequestError(f"Malformed IIIF quality.format: {last!r}")
    quality, fmt = last.rsplit(".", 1)
    if quality == "bitonal":
        raise IiifNotSupported("bitonal quality is not supported")
    overrides = _QUALITIES.get(quality)
    if overrides is None:
        raise BadRequestError(f"Unknown IIIF quality: {quality!r}")
    mapped = _FORMATS.get(fmt)
    if mapped is None:
        raise IiifNotSupported(f"format {fmt!r} is not supported (png|jpg)")
    return dict(overrides), mapped


def info_document(base_id: str, level_sizes: List[Tuple[int, int]], tile_size: int,
                  version: int = 3) -> dict:
    w0, h0 = level_sizes[0]
    scale_factors = [max(1, round(w0 / lw)) for (lw, _lh) in level_sizes]
    sizes = [{"width": lw, "height": lh} for (lw, lh) in reversed(level_sizes)]
    tiles = [{"width": tile_size, "height": tile_size, "scaleFactors": scale_factors}]
    if version == 2:
        return {
            "@context": "http://iiif.io/api/image/2/context.json",
            "@id": base_id,
            "protocol": "http://iiif.io/api/image",
            "profile": ["http://iiif.io/api/image/2/level0.json"],
            "width": w0, "height": h0,
            "sizes": sizes, "tiles": tiles,
        }
    return {
        "@context": "http://iiif.io/api/image/3/context.json",
        "id": base_id,
        "type": "ImageService3",
        "protocol": "http://iiif.io/api/image",
        "profile": "level0",
        "width": w0, "height": h0,
        "sizes": sizes, "tiles": tiles,
    }


async def handle_info(server, groups, query, headers, key):
    count("iiif", "info")
    image_id = int(groups[0])
    sizes, err = await levels_or_response(server, image_id, key)
    if err is not None:
        return err
    version = 2 if query.get("version") == "2" else 3
    doc = info_document(f"http://{headers.get('host', '')}/iiif/{image_id}", sizes,
                        server.tile_sizes["iiif"], version)
    return 200, {"Content-Type": "application/json"}, json.dumps(
        doc, separators=(",", ":")).encode()


async def handle_tile(server, groups, query, headers, key):
    count("iiif", "tile")
    image_id = int(groups[0])
    sizes, err = await levels_or_response(server, image_id, key)
    if err is not None:
        return err
    w0, h0 = sizes[0]
    try:
        x, y, w, h = parse_region(groups[1], w0, h0)
        candidates = [(res, map_region_to_level(x, y, w, h, sizes, res))
                      for res in range(len(sizes))]
        res = parse_size(groups[2], candidates)
        parse_rotation(groups[3])
        overrides, fmt = parse_quality_format(groups[4])
    except BadRequestError as e:
        return text(400, e.message)
    except IiifNotSupported as e:
        return text(501, e.message)
    overrides["format"] = fmt
    lx, ly, lw, lh = dict(candidates)[res]
    tile_size = server.tile_sizes["iiif"]
    return await serve_translated(server, query, headers, key, image_id, lx, ly, lw, lh, res,
                                  overrides, burst=BurstHint(tile_size, tile_size))


ROUTES = [
    (re.compile(r"^/iiif/(\d+)/info\.json$"), handle_info),
    (re.compile(r"^/iiif/(\d+)/([^{}/]+)/([^{}/]+)/([^{}/]+)/([^{}/]+)$"), handle_tile),
]
