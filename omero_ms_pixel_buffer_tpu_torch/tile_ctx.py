"""Tile request context (counterpart of ``omero_ms_pixel_buffer_tpu/
tile_ctx.py``, without the trace context and the flight record):
imageId/z/c/t are required integers, x/y/w/h default to 0,
``resolution`` is optional, ``format`` passes through verbatim; a parse
failure is a 400 with the same message. A ``/render`` request carries its
``RenderSpec`` in ``render``, a ``/histogram`` request its
``HistogramSpec`` in ``analysis``. ``deadline`` is the request's
``Deadline``, minted at the front; ``priority`` is its scheduler class
(joins no key) and ``degraded`` the number of pyramid levels below the
requested one its pixels come from (joins every key as ``|deg=N``).
``cache_key``, ``dedupe_key`` and ``to_json`` give the JAX package's
strings and fields."""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Mapping, Optional

from .errors import BadRequestError
from .resilience.deadline import Deadline

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
    # the request's budget, minted at the front; None = unbounded (tests
    # and direct pipeline callers)
    deadline: Optional[Deadline] = None
    # the rendering of a /render request (render/model.py); None for /tile
    render: Optional["RenderSpec"] = None
    # the histogram of a /histogram request (render/analysis.py); its
    # signature joins every key, as the render signature does
    analysis: Optional["HistogramSpec"] = None
    # the scheduler's class (0 interactive, 1 prefetch, 2 bulk): orders the
    # batcher's queue, joins no key; ``degraded`` = d serves the pyramid
    # level d below the requested one, upscaled, and joins every key
    priority: int = 0
    degraded: int = 0
    # the flight record (obs/recorder.py): attached at the HTTP door,
    # stamped by every layer the request touches. Transient: never part of
    # a key, never serialized
    obs: Optional[object] = dataclasses.field(default=None, compare=False, repr=False)
    # an adapter's burst geometry (render/supertile.py ``BurstHint``).
    # Transient like ``supertile``: never part of a key, never changes bytes
    burst: Optional[object] = dataclasses.field(default=None, compare=False, repr=False)
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

    @property
    def expired(self) -> bool:
        return self.deadline is not None and self.deadline.expired

    def to_json(self) -> dict:
        """The JAX package's dispatch-boundary fields (the deadline as its
        remaining budget)."""
        r = self.region
        return {
            "imageId": self.image_id, "z": self.z, "c": self.c, "t": self.t,
            "region": {"x": r.x, "y": r.y, "width": r.width, "height": r.height},
            "resolution": self.resolution,
            "format": self.format,
            "omeroSessionKey": self.omero_session_key,
            "deadline": None if self.deadline is None else self.deadline.to_json(),
            "render": None if self.render is None else self.render.to_json(),
            "analysis": None if self.analysis is None else self.analysis.to_json(),
            "priority": self.priority,
            "degraded": self.degraded,
        }

    @classmethod
    def from_json(cls, obj: Any) -> "TileCtx":
        """Inverse of ``to_json``; a malformed object is a 400 "Illegal
        tile context", as in the JAX package."""
        from .render.analysis import HistogramSpec  # deferred: render imports errors
        from .render.model import RenderSpec

        try:
            region = obj.get("region") or {}
            return cls(
                image_id=int(obj["imageId"]), z=int(obj["z"]), c=int(obj["c"]),
                t=int(obj["t"]),
                region=RegionDef(
                    x=int(region.get("x", 0)), y=int(region.get("y", 0)),
                    width=int(region.get("width", 0)), height=int(region.get("height", 0)),
                ),
                resolution=None if obj.get("resolution") is None else int(obj["resolution"]),
                format=obj.get("format"),
                omero_session_key=obj.get("omeroSessionKey"),
                deadline=Deadline.from_json(obj.get("deadline")),
                render=(None if obj.get("render") is None
                        else RenderSpec.from_json(obj["render"])),
                analysis=(None if obj.get("analysis") is None
                          else HistogramSpec.from_json(obj["analysis"])),
                priority=int(obj.get("priority", 0) or 0),
                degraded=int(obj.get("degraded", 0) or 0),
            )
        except BadRequestError:
            raise
        except Exception:
            raise BadRequestError("Illegal tile context") from None

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
        if self.degraded:
            # a degraded body is another resource: it never overwrites, nor
            # serves as, the full-resolution entry
            base += f"|deg={self.degraded}"
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
            self.degraded,
        )

    def filename(self) -> str:
        ext = self.format if self.format is not None else "bin"
        return (
            f"image{self.image_id}_z{self.z}_c{self.c}_t{self.t}"
            f"_x{self.region.x}_y{self.region.y}"
            f"_w{self.region.width}_h{self.region.height}.{ext}"
        )
