"""RenderSpec — the canonical, hashable description of one rendering.

A host-only copy of ``omero_ms_pixel_buffer_tpu/render/model.py``: the port
imports nothing of the JAX package, and its 400 messages and signatures
must stay word for word the same.

The OMERO ecosystem's rendered-tile services (``omero-ms-image-region``,
webgateway's ``/render_image_region``) describe a rendering with query
params; this module parses that dialect into a frozen dataclass whose
``signature()`` is the cache/batch-bucketing key:

- ``c`` — active channels: ``1|100:600$FF0000,-2,3|0:255$cool.lut``.
  Comma-separated; each token is ``[-]index[|min:max][$color-or-lut]``
  with a 1-based channel index, a leading ``-`` marking the channel
  inactive, an optional ``min:max`` intensity window (floats), and an
  optional ``$`` suffix that is either a 6/8-digit hex color or a
  named LUT (``render/luts.py``). Without ``c`` the path's channel
  renders alone with defaults.
- ``m`` — ``c`` (color composite) or ``g`` (greyscale: the first
  active channel through a grey ramp).
- ``maps`` — JSON array aligned with the ``c`` tokens, the
  ``omero-ms-image-region`` spelling for per-channel reverse intensity
  and quantization: ``[{"reverse": {"enabled": true}, "quantization":
  {"family": "exponential", "coefficient": 1.5}}, ...]``. Families:
  ``linear`` (default), ``exponential``/``polynomial`` (gamma, x^k),
  and ``logarithmic`` (log(1 + k*x) / log(1 + k)).
- ``p`` — intensity projection: ``intmax`` or ``intmean``, optionally
  with an axis (``intmax:t`` projects over time; default ``:z``) and
  an inclusive range ``intmax|0:5``; without a range the whole stack.
- ``roi`` — JSON array of shape objects (render/masks.py grammar:
  rect/ellipse/polygon/polyline) rasterized into a per-tile mask and
  composited multiplicatively (outside-the-shapes pixels black).
- ``format`` — ``png`` (default) | ``jpeg`` (``jpg`` accepted);
  ``q`` — JPEG quality as the OMERO 0..1 float.

Every malformed value raises ``BadRequestError`` (-> 400 at the HTTP
front, unlike /tile's encode-time 404s — a render spec is part of the
request grammar, not a pipeline outcome). Channel indices are validated
against the image's SizeC at render time (out of range -> 404 like any
bad coordinate).
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, List, Mapping, Optional, Tuple

from ..errors import BadRequestError

_HEX_COLOR = re.compile(r"^[0-9a-fA-F]{6}([0-9a-fA-F]{2})?$")
_CHANNEL = re.compile(
    r"^(?P<sign>-?)(?P<idx>\d+)"
    r"(?:\|(?P<min>-?\d+(?:\.\d+)?):(?P<max>-?\d+(?:\.\d+)?))?"
    r"(?:\$(?P<suffix>.+))?$"
)
_PROJECTION = re.compile(
    r"^(?P<mode>intmax|intmean)(?::(?P<axis>[zt]))?"
    r"(?:\|(?P<start>\d+):(?P<end>\d+))?$"
)

# Quantization families (the OMERO quantum map). "exponential" is the
# historical gamma spelling this service shipped first (x^k);
# "polynomial" is OMERO's canonical name for the same curve and maps
# to identical tables; "logarithmic" is the normalized log map
# log(1 + k*x) / log(1 + k).
FAMILIES = ("linear", "exponential", "polynomial", "logarithmic")
PROJECTIONS = ("intmax", "intmean")
FORMATS = ("png", "jpeg")


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """One ACTIVE channel of a rendering. ``index`` is 0-based;
    ``window`` None means the pixel type's full range (resolved at
    table-build time); exactly one of ``color``/``lut`` may be set
    (both None -> the position-default color rotation)."""

    index: int
    window: Optional[Tuple[float, float]] = None
    color: Optional[str] = None  # 6-hex uppercase RRGGBB
    lut: Optional[str] = None  # LUT name (render/luts.py)
    reverse: bool = False
    family: str = "linear"
    coefficient: float = 1.0

    def token(self) -> str:
        w = (
            "auto" if self.window is None
            else f"{self.window[0]:g}:{self.window[1]:g}"
        )
        paint = self.color or self.lut or "-"
        rev = "r" if self.reverse else ""
        return (
            f"{self.index}:{w}:{paint}:{rev}"
            f"{self.family[:3]}{self.coefficient:g}"
        )


def _parse_maps(raw: Optional[str], n_tokens: int) -> List[dict]:
    if raw is None:
        return [{} for _ in range(n_tokens)]
    try:
        maps = json.loads(raw)
    except (TypeError, ValueError):
        raise BadRequestError(f"Malformed 'maps' JSON: {raw!r}") from None
    if not isinstance(maps, list) or any(
        not isinstance(m, (dict, type(None))) for m in maps
    ):
        raise BadRequestError("'maps' must be a JSON array of objects")
    maps = [m or {} for m in maps]
    maps += [{} for _ in range(n_tokens - len(maps))]
    return maps[:n_tokens]


def _channel_from_token(token: str, channel_map: dict) -> Optional[ChannelSpec]:
    m = _CHANNEL.match(token.strip())
    if m is None:
        raise BadRequestError(f"Malformed channel spec: {token!r}")
    if m.group("sign"):
        return None  # inactive
    index = int(m.group("idx")) - 1  # the query dialect is 1-based
    if index < 0:
        raise BadRequestError(f"Channel index must be >= 1: {token!r}")
    window = None
    if m.group("min") is not None:
        lo, hi = float(m.group("min")), float(m.group("max"))
        if not lo < hi:
            raise BadRequestError(
                f"Window min must be < max: {token!r}"
            )
        window = (lo, hi)
    color = lut = None
    suffix = m.group("suffix")
    if suffix:
        if _HEX_COLOR.match(suffix):
            color = suffix[:6].upper()  # 8-digit alpha is ignored
        else:
            lut = suffix
    reverse = bool(
        (channel_map.get("reverse") or {}).get("enabled", False)
    )
    quant = channel_map.get("quantization") or {}
    family = quant.get("family", "linear")
    if family not in FAMILIES:
        raise BadRequestError(
            f"Unknown quantization family: {family!r} "
            f"(expected one of {FAMILIES})"
        )
    try:
        coefficient = float(quant.get("coefficient", 1.0))
    except (TypeError, ValueError):
        raise BadRequestError(
            f"Invalid quantization coefficient: "
            f"{quant.get('coefficient')!r}"
        ) from None
    if coefficient <= 0:
        raise BadRequestError("Quantization coefficient must be > 0")
    return ChannelSpec(
        index=index, window=window, color=color, lut=lut,
        reverse=reverse, family=family, coefficient=coefficient,
    )


@dataclasses.dataclass(frozen=True)
class RenderSpec:
    """A parsed, canonical rendering request. ``channels`` holds the
    ACTIVE channels sorted by index (the composite is additive, so
    order cannot matter — sorting makes the signature canonical)."""

    channels: Tuple[ChannelSpec, ...]
    model: str = "c"  # c | g
    format: str = "png"  # png | jpeg
    quality: int = 90  # JPEG quality (1-100)
    projection: Optional[str] = None  # intmax | intmean
    proj_start: Optional[int] = None  # inclusive; None = 0
    proj_end: Optional[int] = None  # inclusive; None = size_{axis} - 1
    # which axis the projection collapses: "z" (the classic stack
    # projection) or "t" (``p=intmax:t`` — a time-series projection
    # over the SAME integer reduction)
    proj_axis: str = "z"
    # ROI shape masks (render/masks.py), parsed from the ``roi=`` JSON
    # query param: rasterized per tile into a uint8 mask composited
    # multiplicatively after the channel composite (masked-out pixels
    # render black). Canonically ordered tuple — part of signature().
    masks: Tuple["ShapeSpec", ...] = ()

    @classmethod
    def from_params(
        cls,
        params: Mapping[str, Any],
        default_channel: int = 0,
        default_quality: int = 90,
    ) -> "RenderSpec":
        """Parse the render query dialect; ``default_channel`` (the
        /render path's 0-based ``c`` segment) renders alone when no
        ``c=`` query narrows the selection."""
        model = params.get("m", "c")
        if model not in ("c", "g"):
            raise BadRequestError(
                f"Invalid rendering model: {model!r} (expected c|g)"
            )
        fmt = params.get("format", "png")
        if fmt == "jpg":
            fmt = "jpeg"
        if fmt not in FORMATS:
            raise BadRequestError(
                f"Invalid render format: {fmt!r} (expected png|jpeg)"
            )
        quality = int(default_quality)
        q_raw = params.get("q")
        if q_raw is not None:
            try:
                q = float(q_raw)
            except (TypeError, ValueError):
                raise BadRequestError(
                    f"Invalid quality: {q_raw!r}"
                ) from None
            if not 0.0 < q <= 1.0:
                raise BadRequestError("Quality must be in (0, 1]")
            quality = max(1, min(100, round(q * 100)))

        projection = proj_start = proj_end = None
        proj_axis = "z"
        p_raw = params.get("p")
        if p_raw is not None:
            m = _PROJECTION.match(p_raw)
            if m is None:
                raise BadRequestError(
                    f"Malformed projection: {p_raw!r} "
                    "(expected intmax|intmean, optionally :z|:t for "
                    "the axis and |start:end for the range)"
                )
            projection = m.group("mode")
            proj_axis = m.group("axis") or "z"
            if m.group("start") is not None:
                proj_start = int(m.group("start"))
                proj_end = int(m.group("end"))
                if proj_end < proj_start:
                    raise BadRequestError(
                        "Projection range end must be >= start"
                    )

        masks: Tuple = ()
        roi_raw = params.get("roi")
        if roi_raw is not None:
            from .masks import parse_roi  # deferred: keeps import light

            masks = parse_roi(roi_raw)

        c_raw = params.get("c")
        if c_raw is None:
            if default_channel < 0:
                raise BadRequestError("Channel must be >= 0")
            channels: List[ChannelSpec] = [
                ChannelSpec(index=int(default_channel))
            ]
        else:
            tokens = [t for t in str(c_raw).split(",") if t.strip()]
            if not tokens:
                raise BadRequestError("Empty channel list")
            maps = _parse_maps(params.get("maps"), len(tokens))
            channels = []
            for token, cmap in zip(tokens, maps):
                ch = _channel_from_token(token, cmap)
                if ch is not None:
                    channels.append(ch)
            if not channels:
                raise BadRequestError("No active channels")
            seen = set()
            for ch in channels:
                if ch.index in seen:
                    raise BadRequestError(
                        f"Duplicate channel index: {ch.index + 1}"
                    )
                seen.add(ch.index)
        return cls(
            channels=tuple(sorted(channels, key=lambda ch: ch.index)),
            model=model, format=fmt, quality=quality,
            projection=projection, proj_start=proj_start,
            proj_end=proj_end, proj_axis=proj_axis, masks=masks,
        )

    # -- canonical identity ------------------------------------------------

    def signature(self) -> str:
        """The render-identity string: equal signatures render
        byte-identically for the same source pixels. Keys the result
        cache, batch bucketing, and the engine's table cache."""
        p = (
            "-" if self.projection is None
            else f"{self.projection}:{self.proj_start}:{self.proj_end}"
        )
        if self.projection is not None and self.proj_axis != "z":
            # axis only joins when non-default, so every pre-existing
            # z-projection signature (and its cached entries) is stable
            p += f"@{self.proj_axis}"
        ch = ",".join(c.token() for c in self.channels)
        q = f":q{self.quality}" if self.format == "jpeg" else ""
        sig = f"m{self.model}:{self.format}{q}:p{p}:[{ch}]"
        if self.masks:
            sig += f":roi[{','.join(m.token() for m in self.masks)}]"
        return sig

    # -- dispatch-boundary (de)serialization (TileCtx contract) ------------

    def to_json(self) -> dict:
        return {
            "model": self.model,
            "format": self.format,
            "quality": self.quality,
            "projection": self.projection,
            "projStart": self.proj_start,
            "projEnd": self.proj_end,
            "projAxis": self.proj_axis,
            "channels": [dataclasses.asdict(c) for c in self.channels],
            "masks": [dataclasses.asdict(m) for m in self.masks],
        }

    @classmethod
    def from_json(cls, obj: Optional[dict]) -> Optional["RenderSpec"]:
        if obj is None:
            return None
        channels = tuple(
            ChannelSpec(
                index=int(c["index"]),
                window=(
                    None if c.get("window") is None
                    else tuple(c["window"])
                ),
                color=c.get("color"),
                lut=c.get("lut"),
                reverse=bool(c.get("reverse", False)),
                family=c.get("family", "linear"),
                coefficient=float(c.get("coefficient", 1.0)),
            )
            for c in obj.get("channels", [])
        )
        masks: Tuple = ()
        if obj.get("masks"):
            from .masks import ShapeSpec

            masks = tuple(
                ShapeSpec.from_json(m) for m in obj["masks"]
            )
        return cls(
            channels=channels,
            model=obj.get("model", "c"),
            format=obj.get("format", "png"),
            quality=int(obj.get("quality", 90)),
            projection=obj.get("projection"),
            proj_start=obj.get("projStart"),
            proj_end=obj.get("projEnd"),
            proj_axis=obj.get("projAxis", "z"),
            masks=masks,
        )

    # -- render-time resolution --------------------------------------------

    def resolve_channels(self, size_c: int) -> Tuple[ChannelSpec, ...]:
        """The channels this rendering composites, validated against
        the image's SizeC (out of range raises ValueError -> the
        pipeline's broad catch -> 404, like any bad coordinate). The
        greyscale model renders only the first active channel."""
        for ch in self.channels:
            if ch.index >= size_c:
                raise ValueError(
                    f"Channel {ch.index} out of range (SizeC={size_c})"
                )
        if self.model == "g":
            return self.channels[:1]
        return self.channels

    def z_range(self, z: int, size_z: int) -> List[int]:
        """The z planes one lane reads: [z] without a z-projection,
        else the clipped inclusive projection range. (Kept as the
        historical z-only spelling; ``plane_range`` is the general
        z/t form.)"""
        if self.projection is None or self.proj_axis != "z":
            return [z]
        return self._axis_range(size_z, "Z")

    def plane_range(
        self, z: int, t: int, size_z: int, size_t: int
    ) -> List[Tuple[int, int]]:
        """The (z, t) plane coordinates one lane reads, in projection
        order: a single plane without projection, the z stack for a
        z-projection at fixed t, the t series for a t-projection at
        fixed z."""
        if self.projection is None:
            return [(z, t)]
        if self.proj_axis == "t":
            return [(z, ti) for ti in self._axis_range(size_t, "T")]
        return [(zi, t) for zi in self._axis_range(size_z, "Z")]

    def _axis_range(self, size: int, label: str) -> List[int]:
        start = 0 if self.proj_start is None else self.proj_start
        end = size - 1 if self.proj_end is None else self.proj_end
        start, end = max(0, start), min(size - 1, end)
        if end < start:
            raise ValueError(
                f"Projection range [{self.proj_start}:{self.proj_end}] "
                f"outside the stack (Size{label}={size})"
            )
        return list(range(start, end + 1))

    def without_windows(self) -> "RenderSpec":
        """This spec with every channel window erased — the table key
        for quantized (float32/int32) lanes, whose windows are baked
        into the host value->bin quantization before the integer
        engine ever sees the pixels (render/engine.quantize_to_u16):
        two specs differing only in window share one u16 table set."""
        return dataclasses.replace(
            self,
            channels=tuple(
                dataclasses.replace(ch, window=None)
                for ch in self.channels
            ),
        )
