"""ROI shape masks — server-side rasterization for masked rendering.

A host-only copy of ``omero_ms_pixel_buffer_tpu/render/masks.py``: the port
imports nothing of the JAX package, and its 400 messages and signatures
must stay word for word the same.

A ``/render`` request may carry ``roi=`` — a JSON array of shape
objects — and the composited RGB is multiplied by the union mask of
those shapes before the encode chain: pixels outside every shape
render black. The grammar (validated here; any violation is a
``BadRequestError`` -> 400, like the rest of the render dialect):

- ``{"type": "rect",    "x": .., "y": .., "w": .., "h": ..}``
- ``{"type": "ellipse", "cx": .., "cy": .., "rx": .., "ry": ..}``
- ``{"type": "polygon",  "points": [[x, y], ...]}``  (>= 3 points)
- ``{"type": "polyline", "points": [[x, y], ...],
     "width": stroke}``  (>= 2 points; width defaults to 1)

Coordinates are IMAGE coordinates at the requested resolution level
(the same frame as ``x/y/w/h`` region params), so one shape set masks
every tile of a pan consistently. Rasterization is pure integer /
float64 host math with a fixed pixel-center convention (a pixel is
inside when its center (px + 0.5, py + 0.5) satisfies the shape
test, boundary-inclusive), so masks are deterministic across
platforms — mask bytes join the render signature, and masked tiles
keep the engine byte-identity contract.

Per-tile rasters are memoized in ``MaskRasterCache`` keyed
(shape-set signature, region) under an image namespace: a pan
re-rasterizes nothing, and image invalidation drops the namespace
with every other cached artifact of the image.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from ..errors import BadRequestError

SHAPE_TYPES = ("rect", "ellipse", "polygon", "polyline")

# rasters are small (w*h bytes) but a hostile client could churn shape
# sets; the cache is byte-budgeted and LRU like every other tier
_DEFAULT_MASK_CACHE_BYTES = 64 << 20

# request-sanity bounds (grammar-level, -> 400): a shape set is a
# hand-drawn overlay, not a point cloud
MAX_SHAPES = 64
MAX_POINTS = 4096


def _finite(value, what: str) -> float:
    try:
        f = float(value)
    except (TypeError, ValueError):
        raise BadRequestError(f"Invalid {what}: {value!r}") from None
    if not np.isfinite(f):
        raise BadRequestError(f"Non-finite {what}: {value!r}")
    return f


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One validated shape. ``points`` is the flattened (x0, y0, x1,
    y1, ...) tuple for polygon/polyline; the scalar fields serve
    rect/ellipse. Frozen + hashable so shape sets ride RenderSpec
    (cache keys, batch bucketing) like every other spec field."""

    type: str
    x: float = 0.0
    y: float = 0.0
    w: float = 0.0
    h: float = 0.0
    points: Tuple[float, ...] = ()
    width: float = 1.0

    def token(self) -> str:
        """Canonical signature fragment (joins RenderSpec.signature)."""
        if self.type == "rect":
            return f"r{self.x:g},{self.y:g},{self.w:g},{self.h:g}"
        if self.type == "ellipse":
            return f"e{self.x:g},{self.y:g},{self.w:g},{self.h:g}"
        pts = ";".join(f"{p:g}" for p in self.points)
        if self.type == "polygon":
            return f"p{pts}"
        return f"l{self.width:g}|{pts}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: dict) -> "ShapeSpec":
        return cls(
            type=obj["type"],
            x=float(obj.get("x", 0.0)),
            y=float(obj.get("y", 0.0)),
            w=float(obj.get("w", 0.0)),
            h=float(obj.get("h", 0.0)),
            points=tuple(float(p) for p in obj.get("points", ())),
            width=float(obj.get("width", 1.0)),
        )


def _parse_points(raw, minimum: int) -> Tuple[float, ...]:
    if not isinstance(raw, (list, tuple)) or len(raw) < minimum:
        raise BadRequestError(
            f"Shape 'points' must be a list of at least {minimum} "
            "[x, y] pairs"
        )
    if len(raw) > MAX_POINTS:
        raise BadRequestError(
            f"Shape has {len(raw)} points (limit {MAX_POINTS})"
        )
    flat = []
    for p in raw:
        if not isinstance(p, (list, tuple)) or len(p) != 2:
            raise BadRequestError(
                f"Invalid point {p!r} (expected [x, y])"
            )
        flat.append(_finite(p[0], "point x"))
        flat.append(_finite(p[1], "point y"))
    return tuple(flat)


def parse_shape(obj) -> ShapeSpec:
    if not isinstance(obj, dict):
        raise BadRequestError(f"Shape must be a JSON object: {obj!r}")
    stype = obj.get("type")
    if stype not in SHAPE_TYPES:
        raise BadRequestError(
            f"Unknown shape type: {stype!r} "
            f"(expected one of {SHAPE_TYPES})"
        )
    known = {"type", "x", "y", "w", "h", "cx", "cy", "rx", "ry",
             "points", "width"}
    unknown = set(obj) - known
    if unknown:
        raise BadRequestError(
            f"Unknown shape keys: {sorted(unknown)}"
        )
    if stype == "rect":
        w = _finite(obj.get("w"), "rect w")
        h = _finite(obj.get("h"), "rect h")
        if w <= 0 or h <= 0:
            raise BadRequestError("Rect w/h must be > 0")
        return ShapeSpec(
            type="rect",
            x=_finite(obj.get("x", 0), "rect x"),
            y=_finite(obj.get("y", 0), "rect y"),
            w=w, h=h,
        )
    if stype == "ellipse":
        rx = _finite(obj.get("rx"), "ellipse rx")
        ry = _finite(obj.get("ry"), "ellipse ry")
        if rx <= 0 or ry <= 0:
            raise BadRequestError("Ellipse rx/ry must be > 0")
        # stored on the shared scalar fields: x/y = center, w/h = radii
        return ShapeSpec(
            type="ellipse",
            x=_finite(obj.get("cx"), "ellipse cx"),
            y=_finite(obj.get("cy"), "ellipse cy"),
            w=rx, h=ry,
        )
    if stype == "polygon":
        return ShapeSpec(
            type="polygon", points=_parse_points(obj.get("points"), 3)
        )
    width = _finite(obj.get("width", 1.0), "polyline width")
    if width <= 0:
        raise BadRequestError("Polyline width must be > 0")
    return ShapeSpec(
        type="polyline",
        points=_parse_points(obj.get("points"), 2),
        width=width,
    )


def parse_roi(raw: str) -> Tuple[ShapeSpec, ...]:
    """Parse the ``roi=`` query param: a JSON array of shape objects.
    Every grammar violation is a 400 — the shape set is part of the
    request grammar, exactly like the channel dialect."""
    import json

    try:
        shapes = json.loads(raw)
    except (TypeError, ValueError):
        raise BadRequestError(f"Malformed 'roi' JSON: {raw!r}") from None
    if isinstance(shapes, dict):
        shapes = [shapes]  # a single bare shape object is accepted
    if not isinstance(shapes, list) or not shapes:
        raise BadRequestError(
            "'roi' must be a non-empty JSON array of shape objects"
        )
    if len(shapes) > MAX_SHAPES:
        raise BadRequestError(
            f"'roi' has {len(shapes)} shapes (limit {MAX_SHAPES})"
        )
    return tuple(parse_shape(s) for s in shapes)


# ---------------------------------------------------------------------------
# rasterization — pure host math, deterministic, pixel-center rule
# ---------------------------------------------------------------------------


def _raster_rect(shape, px, py, out) -> None:
    out |= (
        (px >= shape.x) & (px <= shape.x + shape.w)
        & (py >= shape.y) & (py <= shape.y + shape.h)
    )


def _raster_ellipse(shape, px, py, out) -> None:
    nx = (px - shape.x) / shape.w
    ny = (py - shape.y) / shape.h
    out |= nx * nx + ny * ny <= 1.0


def _raster_polygon(shape, px, py, out) -> None:
    """Even-odd rule over pixel centers, vectorized over the tile."""
    pts = np.asarray(shape.points, dtype=np.float64).reshape(-1, 2)
    inside = np.zeros(px.shape, dtype=bool)
    x0, y0 = pts[-1]
    for x1, y1 in pts:
        if y0 != y1:
            cond = (py >= min(y0, y1)) & (py < max(y0, y1))
            xi = x0 + (py - y0) * (x1 - x0) / (y1 - y0)
            inside ^= cond & (px < xi)
        x0, y0 = x1, y1
    out |= inside


def _raster_polyline(shape, px, py, out) -> None:
    """Stroke: pixels within width/2 of any segment."""
    pts = np.asarray(shape.points, dtype=np.float64).reshape(-1, 2)
    r2 = (shape.width / 2.0) ** 2
    for (x0, y0), (x1, y1) in zip(pts[:-1], pts[1:]):
        dx, dy = x1 - x0, y1 - y0
        ll = dx * dx + dy * dy
        if ll == 0.0:
            d2 = (px - x0) ** 2 + (py - y0) ** 2
        else:
            t = np.clip(((px - x0) * dx + (py - y0) * dy) / ll, 0.0, 1.0)
            d2 = (px - (x0 + t * dx)) ** 2 + (py - (y0 + t * dy)) ** 2
        out |= d2 <= r2


_RASTERIZERS = {
    "rect": _raster_rect,
    "ellipse": _raster_ellipse,
    "polygon": _raster_polygon,
    "polyline": _raster_polyline,
}


def rasterize(
    shapes: Tuple[ShapeSpec, ...], x: int, y: int, w: int, h: int
) -> np.ndarray:
    """(h, w) uint8 0/1 union mask of ``shapes`` over the tile at
    image offset (x, y). Pixel-center convention: image pixel (ix, iy)
    samples the shape tests at (ix + 0.5, iy + 0.5)."""
    px = x + np.arange(w, dtype=np.float64)[None, :] + 0.5
    py = y + np.arange(h, dtype=np.float64)[:, None] + 0.5
    px, py = np.broadcast_arrays(px, py)
    out = np.zeros((h, w), dtype=bool)
    for shape in shapes:
        _RASTERIZERS[shape.type](shape, px, py, out)
    return out.astype(np.uint8)


def mask_signature(shapes: Tuple[ShapeSpec, ...]) -> str:
    return ",".join(s.token() for s in shapes)


def bucket_mask_batch(masks, bh: int, bw: int) -> np.ndarray:
    """Assemble per-lane (h, w) rasters into one (B, bh, bw) uint8
    bucket batch, pad pixels 0: pad pixels composite to black, and
    their bytes are sliced away by the stream build anyway. Shared by
    the single-device fused render dispatch and the mesh chain — the
    batch is exactly what shards along the lane axis, so masked
    groups no longer split to a single device."""
    out = np.zeros((len(masks), bh, bw), dtype=np.uint8)
    for j, m in enumerate(masks):
        out[j, : m.shape[0], : m.shape[1]] = m
    return out


class MaskRasterCache:
    """Byte-budgeted LRU of per-tile mask rasters, keyed
    (image namespace, shape-set signature, region). Shapes arrive per
    request (image-independent), but rasters are namespaced per image
    so ``invalidate_image`` drops them with every other cached
    artifact — the conservative contract, matching the plane/result
    tiers (a changed image may change its extents and therefore which
    region grid the shape set is rasterized over)."""

    def __init__(self, max_bytes: int = _DEFAULT_MASK_CACHE_BYTES):
        self.max_bytes = max_bytes
        self._rasters: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(
        self,
        image_id: int,
        shapes: Tuple[ShapeSpec, ...],
        region: Tuple[int, int, int, int],
    ) -> np.ndarray:
        key = (image_id, mask_signature(shapes), region)
        with self._lock:
            hit = self._rasters.get(key)
            if hit is not None:
                self._rasters.move_to_end(key)
                self.hits += 1
                return hit
            self.misses += 1
        raster = rasterize(shapes, *region)
        with self._lock:
            if key not in self._rasters:
                self._rasters[key] = raster
                self._bytes += raster.nbytes
                while self._bytes > self.max_bytes and len(self._rasters) > 1:
                    _, old = self._rasters.popitem(last=False)
                    self._bytes -= old.nbytes
        return raster

    def invalidate_image(self, image_id: int) -> int:
        with self._lock:
            victims = [k for k in self._rasters if k[0] == image_id]
            for k in victims:
                self._bytes -= self._rasters.pop(k).nbytes
        return len(victims)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "rasters": len(self._rasters),
                "bytes": self._bytes,
                "hits": self.hits,
                "misses": self.misses,
            }
