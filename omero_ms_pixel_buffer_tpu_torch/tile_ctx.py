"""Tile request context (counterpart of ``omero_ms_pixel_buffer_tpu/
tile_ctx.py`` without the degraded and priority fields): imageId/z/c/t
are required integers, x/y/w/h default to 0, ``resolution`` is optional,
``format`` passes through verbatim; a parse failure is a 400 with the
same message. A ``/render`` request carries its ``RenderSpec`` in
``render``, a ``/histogram`` request its ``HistogramSpec`` in
``analysis``. ``cache_key`` and ``dedupe_key`` give the JAX package's key
strings."""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Any, Mapping, Optional

from .errors import BadRequestError

if TYPE_CHECKING:
    from .render.analysis import HistogramSpec
    from .render.model import RenderSpec


@dataclasses.dataclass
class RegionDef:
    """Mutable x/y/w/h rectangle."""

    x: int = 0
    y: int = 0
    width: int = 0
    height: int = 0


def _require_int(params: Mapping[str, Any], key: str) -> int:
    value = params.get(key)
    if value is None:
        raise BadRequestError(f"Missing parameter '{key}'")
    try:
        return int(value)
    except (TypeError, ValueError):
        raise BadRequestError(f'For input string: "{value}"') from None


def _optional_int(params: Mapping[str, Any], key: str, default=None):
    value = params.get(key)
    if value is None:
        return default
    try:
        return int(value)
    except (TypeError, ValueError):
        raise BadRequestError(f'For input string: "{value}"') from None


@dataclasses.dataclass
class TileCtx:
    """Parsed /tile request."""

    image_id: int
    z: int
    c: int
    t: int
    region: RegionDef
    resolution: Optional[int] = None
    format: Optional[str] = None
    omero_session_key: Optional[str] = None
    # absolute time.monotonic() by which the answer is due; None =
    # unbounded (tests and direct pipeline callers)
    deadline: Optional[float] = None
    # the rendering of a /render request (render/model.py); None for /tile
    render: Optional["RenderSpec"] = None
    # the histogram of a /histogram request (render/analysis.py); its
    # signature joins every key, as the render signature does
    analysis: Optional["HistogramSpec"] = None
    # the batcher's super-tile stamp (render/supertile.py: a shared
    # ``SuperTileGroup``). Transient: never part of a key, so fusion
    # changes where pixels are composited, never which bytes a tile serves
    supertile: Optional[object] = dataclasses.field(default=None, compare=False, repr=False)

    @classmethod
    def from_params(
        cls, params: Mapping[str, Any], omero_session_key: Optional[str]
    ) -> "TileCtx":
        return cls(
            image_id=_require_int(params, "imageId"),
            z=_require_int(params, "z"),
            c=_require_int(params, "c"),
            t=_require_int(params, "t"),
            region=RegionDef(
                x=_optional_int(params, "x", 0),
                y=_optional_int(params, "y", 0),
                width=_optional_int(params, "w", 0),
                height=_optional_int(params, "h", 0),
            ),
            resolution=_optional_int(params, "resolution", None),
            format=params.get("format"),
            omero_session_key=omero_session_key,
        )

    def remaining(self) -> Optional[float]:
        """Seconds left before the deadline (None when unbounded)."""
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()

    @property
    def expired(self) -> bool:
        left = self.remaining()
        return left is not None and left <= 0

    def cache_key(self, quality: str = "") -> str:
        """Result-cache content key, the JAX package's string: (image, z,
        c, t, requested region, resolution, format, quality[, render
        signature][, histogram signature]). No session: identical tiles are
        identical for every authorized caller."""
        r = self.region
        base = (
            f"img={self.image_id}|z={self.z}|c={self.c}|t={self.t}"
            f"|x={r.x}|y={r.y}|w={r.width}|h={r.height}"
            f"|res={self.resolution}|fmt={self.format}|q={quality}"
        )
        if self.render is not None:
            base += f"|render={self.render.signature()}"
        if self.analysis is not None:
            base += f"|hist={self.analysis.signature()}"
        return base

    def dedupe_key(self, quality: str = "") -> str:
        """Single-flight key: the content key scoped to the caller's
        session, so one caller never rides another's execution."""
        return self.cache_key(quality) + f"|sess={self.omero_session_key}"

    def lane_key(self) -> tuple:
        """Batch-dedupe key: equal lanes produce identical tiles for the
        same caller. The render and histogram signatures join it, so two
        renderings (or two histograms) of one region never merge."""
        r = self.region
        return (
            self.image_id, self.z, self.c, self.t,
            r.x, r.y, r.width, r.height,
            self.resolution, self.format, self.omero_session_key,
            None if self.render is None else self.render.signature(),
            None if self.analysis is None else self.analysis.signature(),
        )

    def filename(self) -> str:
        ext = self.format if self.format is not None else "bin"
        return (
            f"image{self.image_id}_z{self.z}_c{self.c}_t{self.t}"
            f"_x{self.region.x}_y{self.region.y}"
            f"_w{self.region.width}_h{self.region.height}.{ext}"
        )
