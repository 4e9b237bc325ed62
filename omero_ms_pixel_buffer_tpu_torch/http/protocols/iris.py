"""Iris RESTful adapter, the WSI dialect of OpenSeadragon's
IrisTileSource (copy of ``omero_ms_pixel_buffer_tpu/http/protocols/
iris.py``).

- ``GET /iris/{image}/metadata``: the extent and one entry per layer,
  coarsest first (Iris order), with its tile grid and scale, and, with
  the session plane on, its ``capabilities`` (the live channel and the
  annotations of the image);
- ``GET /iris/{image}/layers/{layer}/tiles/{tile}``: tiles by flat
  row-major index over the layer's 256 grid (``?format=png|jpeg|jpg``).

Layer ``l`` is pyramid resolution ``levels - 1 - l``; a layer or index
off the ladder answers 404. A tile is the native ``/render`` request of
its region.
"""

from __future__ import annotations

import json
import re
from typing import List, Tuple

from ...render.supertile import BurstHint
from . import count, levels_or_response, serve_translated, text

_FORMATS = {"png": "png", "jpeg": "jpeg", "jpg": "jpeg"}


def layer_grid(level_sizes: List[Tuple[int, int]], layer: int, tile_size: int):
    """(resolution, x_tiles, y_tiles, lw, lh) of one layer, or None off
    the ladder."""
    if not 0 <= layer < len(level_sizes):
        return None
    res = len(level_sizes) - 1 - layer  # coarsest first
    lw, lh = level_sizes[res]
    return (res, (lw + tile_size - 1) // tile_size, (lh + tile_size - 1) // tile_size, lw, lh)


def metadata_document(level_sizes: List[Tuple[int, int]], tile_size: int,
                      image_id: int = 0, session_plane: bool = False) -> dict:
    w0, h0 = level_sizes[0]
    layers = []
    for layer in range(len(level_sizes)):
        _res, x_tiles, y_tiles, lw, _lh = layer_grid(level_sizes, layer, tile_size)
        layers.append({"x_tiles": x_tiles, "y_tiles": y_tiles, "scale": max(1, round(w0 / lw))})
    doc = {
        "type": "iris_slide_metadata",
        "format": "png",
        "encoding": "image",
        "extent": {"width": w0, "height": h0, "tile_size": tile_size, "layers": layers},
    }
    if session_plane:
        # the session plane's push and annotation surfaces of this image
        doc["capabilities"] = {"push": f"/session/{image_id}/live",
                               "annotations": f"/annotations/{image_id}"}
    return doc


async def handle_metadata(server, groups, query, headers, key):
    count("iris", "metadata")
    image_id = int(groups[0])
    sizes, err = await levels_or_response(server, image_id, key)
    if err is not None:
        return err
    doc = metadata_document(sizes, server.tile_sizes["iris"], image_id=image_id,
                            session_plane=server.session_channels is not None)
    return 200, {"Content-Type": "application/json"}, json.dumps(
        doc, separators=(",", ":")).encode()


async def handle_tile(server, groups, query, headers, key):
    count("iris", "tile")
    image_id = int(groups[0])
    fmt = _FORMATS.get(query.get("format", "png"))
    if fmt is None:
        return text(400, "Unsupported Iris format (png|jpeg|jpg)")
    sizes, err = await levels_or_response(server, image_id, key)
    if err is not None:
        return err
    tile_size = server.tile_sizes["iris"]
    grid = layer_grid(sizes, int(groups[1]), tile_size)
    if grid is None:
        return text(404, "No such layer")
    res, x_tiles, y_tiles, lw, lh = grid
    tile = int(groups[2])
    if tile >= x_tiles * y_tiles:
        return text(404, "No such tile")
    x, y = (tile % x_tiles) * tile_size, (tile // x_tiles) * tile_size
    return await serve_translated(server, query, headers, key, image_id, x, y,
                                  min(tile_size, lw - x), min(tile_size, lh - y), res,
                                  overrides={"format": fmt},
                                  burst=BurstHint(tile_size, tile_size))


ROUTES = [
    (re.compile(r"^/iris/(\d+)/metadata$"), handle_metadata),
    (re.compile(r"^/iris/(\d+)/layers/(\d+)/tiles/(\d+)$"), handle_tile),
]
