"""Region resolution (counterpart of ``omero_ms_pixel_buffer_tpu/ops/
crop.py`` ``resolve_region``): ``w == 0 -> sizeX`` and ``h == 0 ->
sizeY`` *before* the bounds check, so an offset with a zero size
overflows the plane and is a 404, as in the reference."""

from __future__ import annotations

from typing import Tuple

from ..tile_ctx import RegionDef


def resolve_region(
    region: RegionDef, size_x: int, size_y: int
) -> Tuple[int, int, int, int]:
    """Apply w/h=0 defaulting and bounds-check against the plane.
    Returns (x, y, w, h); raises ValueError (-> 404) when the region is
    negative or falls outside the plane."""
    x, y, w, h = region.x, region.y, region.width, region.height
    if w == 0:
        w = size_x
    if h == 0:
        h = size_y
    if x < 0 or y < 0 or w < 0 or h < 0:
        raise ValueError(f"Negative region: x={x} y={y} w={w} h={h}")
    if x + w > size_x or y + h > size_y:
        raise ValueError(
            f"Region out of bounds: x={x} y={y} w={w} h={h} "
            f"plane={size_x}x{size_y}"
        )
    return x, y, w, h
