"""Pixel-intensity histograms, the ``/histogram`` surface (counterpart of
``omero_ms_pixel_buffer_tpu/render/analysis.py``).

``GET /histogram/{image}/{z}/{c}/{t}`` (the ``omero-ms-image-region``
histogram dialect: ``bins``, ``usePixelsTypeRange``, plus the region,
resolution and channel parameters of the other endpoints) answers
per-channel integer histograms. The reduction is

    bin  = bin_table[pixel]            # host-built value -> bin table
    hist = zeros(B * bins).scatter_add_(lane * bins + bin, 1)

All float math (window -> bin edges) happens on the host in float64
when a table is built; the device program is integer gathers and
integer counts, so the counts equal the JAX package's. Statistics
(min/max/mean/percentiles) derive from the counts and the bin edges
alone. The host parts (``HistogramSpec``, the tables, the stats, the
canonical JSON body) are copied; ``histogram_torch`` is the device
reduction (``_histogram_core`` in the JAX package) and ``histogram_host``
its numpy mirror, copied. The JAX package's mesh form,
``sharded_histogram_batch``, waits for the port's multi-device plane.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Any, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..errors import BadRequestError
from ..ops.convert import bits_tensor, bits_view
from .engine import QUANT_BINS, default_window
from .model import ChannelSpec, _channel_from_token, _parse_maps
from ..utils.metrics import REGISTRY

HIST_TILES = REGISTRY.counter(
    "analysis_histograms_total",
    "Histogram requests served by engine path",
)
HIST_SECONDS = REGISTRY.histogram(
    "analysis_histogram_seconds",
    "Histogram reduction wall time (stage=tables|device|host)",
)

MAX_BINS = 65536
DEFAULT_BINS = 256

_TRUTHY = ("1", "true", "yes")


@dataclasses.dataclass(frozen=True)
class HistogramSpec:
    """A parsed, canonical histogram request. ``channels`` reuses the
    render channel dialect (``c=1|100:600,2``): each active channel gets
    its own histogram; per-channel windows bound the bin range
    (``usePixelsTypeRange`` overrides every window with the pixel type's
    full range)."""

    channels: Tuple[ChannelSpec, ...]
    bins: int = DEFAULT_BINS
    use_pixel_range: bool = False

    @classmethod
    def from_params(
        cls,
        params: Mapping[str, Any],
        default_channel: int = 0,
        max_bins: int = MAX_BINS,
    ) -> "HistogramSpec":
        bins_raw = params.get("bins", DEFAULT_BINS)
        try:
            bins = int(bins_raw)
        except (TypeError, ValueError):
            raise BadRequestError(f"Invalid bins: {bins_raw!r}") from None
        if not 2 <= bins <= min(max_bins, MAX_BINS):
            raise BadRequestError(f"bins must be in [2, {min(max_bins, MAX_BINS)}]")
        upr = str(params.get("usePixelsTypeRange", "")).strip().lower()
        use_pixel_range = upr in _TRUTHY
        c_raw = params.get("c")
        if c_raw is None:
            if default_channel < 0:
                raise BadRequestError("Channel must be >= 0")
            channels: List[ChannelSpec] = [ChannelSpec(index=int(default_channel))]
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
                    raise BadRequestError(f"Duplicate channel index: {ch.index + 1}")
                seen.add(ch.index)
        return cls(
            channels=tuple(sorted(channels, key=lambda c: c.index)),
            bins=bins,
            use_pixel_range=use_pixel_range,
        )

    def signature(self) -> str:
        """Canonical identity: keys the result cache, the batcher's lane
        dedupe and the single-flight registry, as a render signature does."""
        ch = ",".join(
            f"{c.index}:"
            + ("auto" if c.window is None else f"{c.window[0]:g}:{c.window[1]:g}")
            for c in self.channels
        )
        r = "ptr" if self.use_pixel_range else "win"
        return f"hist:b{self.bins}:{r}:[{ch}]"

    def to_json(self) -> dict:
        return {
            "bins": self.bins,
            "usePixelsTypeRange": self.use_pixel_range,
            "channels": [dataclasses.asdict(c) for c in self.channels],
        }

    @classmethod
    def from_json(cls, obj: Optional[dict]) -> Optional["HistogramSpec"]:
        if obj is None:
            return None
        return cls(
            channels=tuple(
                ChannelSpec(
                    index=int(c["index"]),
                    window=None if c.get("window") is None else tuple(c["window"]),
                )
                for c in obj.get("channels", [])
            ),
            bins=int(obj.get("bins", DEFAULT_BINS)),
            use_pixel_range=bool(obj.get("usePixelsTypeRange", False)),
        )

    def resolve_channels(self, size_c: int) -> Tuple[ChannelSpec, ...]:
        for ch in self.channels:
            if ch.index >= size_c:
                raise ValueError(f"Channel {ch.index} out of range (SizeC={size_c})")
        return self.channels


# ---------------------------------------------------------------------------
# bin tables: all the float math, on the host, in float64 (copied)
# ---------------------------------------------------------------------------


def resolve_window(
    ch: ChannelSpec,
    dtype: np.dtype,
    use_pixel_range: bool,
    plane: Optional[np.ndarray] = None,
) -> Tuple[float, float]:
    """The value range one channel's histogram spans: the pixel type's
    full range under ``usePixelsTypeRange`` (or for an integer channel
    without a window), else the channel's window; a float plane without
    a window spans its observed finite range."""
    dtype = np.dtype(dtype)
    if dtype.kind in "ui":
        if use_pixel_range or ch.window is None:
            return default_window(dtype)
        return (float(ch.window[0]), float(ch.window[1]))
    if ch.window is not None and not use_pixel_range:
        return (float(ch.window[0]), float(ch.window[1]))
    if plane is None:
        raise ValueError("float histogram without a window needs the plane")
    finite = plane[np.isfinite(plane)]
    if finite.size == 0:
        return (0.0, 1.0)
    lo, hi = float(finite.min()), float(finite.max())
    if not lo < hi:
        hi = lo + 1.0
    return (lo, hi)


def build_bin_table(dtype: np.dtype, window: Tuple[float, float], bins: int) -> np.ndarray:
    """(K,) int32 value -> bin table over pixel type ``dtype`` (integers
    up to 16-bit; quantized planes use ``quant_bin_table``). Values below
    the window clamp into bin 0, above into bins - 1. Signed types index
    through their two's-complement unsigned view, as the render tables do."""
    dtype = np.dtype(dtype)
    if dtype.kind not in "ui" or dtype.itemsize > 2:
        raise ValueError(f"No direct bin table for {dtype}")
    k = 1 << (8 * dtype.itemsize)
    u = np.arange(k, dtype=np.int64)
    values = u if dtype.kind == "u" else ((u + k // 2) % k) - k // 2
    return _bins_for_values(values.astype(np.float64), window, bins)


def quant_bin_table(bins: int) -> np.ndarray:
    """(QUANT_BINS,) int32 bin table for planes already quantized to u16
    by ``engine.quantize_to_u16``: the bins split the u16 space linearly."""
    values = np.arange(QUANT_BINS, dtype=np.float64)
    return _bins_for_values(values, (0.0, float(QUANT_BINS - 1)), bins)


def _bins_for_values(values: np.ndarray, window: Tuple[float, float], bins: int) -> np.ndarray:
    lo, hi = float(window[0]), float(window[1])
    if not lo < hi:
        raise ValueError(f"Degenerate histogram window [{lo}:{hi}]")
    x = np.clip((values - lo) / (hi - lo), 0.0, 1.0)
    return np.minimum(np.floor(x * bins).astype(np.int64), bins - 1).astype(np.int32)


def bin_edges(window: Tuple[float, float], bins: int) -> np.ndarray:
    """(bins + 1,) float64 bin boundaries for the stats."""
    return np.linspace(float(window[0]), float(window[1]), bins + 1)


# ---------------------------------------------------------------------------
# the reduction: device program and its numpy mirror
# ---------------------------------------------------------------------------


def histogram_torch(planes: torch.Tensor, bin_tables: torch.Tensor, bins: int) -> torch.Tensor:
    """(B, H, W) 8/16-bit pixels (their unsigned view indexes the tables)
    + (B, K) int32 bin tables, on one device -> (B, bins) int32 counts on
    that device: one gather per pixel, then one ``scatter_add_`` of ones at
    ``lane * bins + bin`` (integer atomics on CUDA). The same integers as
    the JAX ``_histogram_core``."""
    bits = bits_view(planes)
    b = bits.shape[0]
    idx = bits.reshape(b, -1).to(torch.int64)
    if bits.dtype == torch.int16:
        idx &= 0xFFFF  # the unsigned view of a 16-bit pattern
    binned = torch.gather(bin_tables.to(torch.int64), 1, idx)
    binned += torch.arange(b, device=binned.device, dtype=torch.int64)[:, None] * bins
    flat = binned.reshape(-1)
    ones = torch.ones(1, dtype=torch.int32, device=flat.device).expand(flat.shape[0])
    counts = torch.zeros(b * bins, dtype=torch.int32, device=flat.device)
    return counts.scatter_add_(0, flat, ones).reshape(b, bins)


def histogram_batch(planes: np.ndarray, bin_tables: np.ndarray, bins: int,
                    device, events=None) -> np.ndarray:
    """``histogram_torch`` of host (B, H, W) unsigned planes and (B, K)
    tables on ``device``, the counts pulled back once: host (B, bins)
    int32. On CUDA the copies and the reduction run on a stream of their
    own (from PyTorch's pool), so the pull waits for this call's work
    alone; ``events``, a pair of timing CUDA events, is recorded on it
    around the reduction."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    with HIST_SECONDS.time(stage="device"), (
            contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)):
        planes_dev = bits_tensor(planes).to(device)
        tables_dev = torch.from_numpy(np.ascontiguousarray(bin_tables, dtype=np.int32)).to(device)
        if events is not None:
            events[0].record()
        counts = histogram_torch(planes_dev, tables_dev, bins)
        if events is not None:
            events[1].record()
        return counts.cpu().numpy()


def sharded_histogram_batch(mesh, planes: np.ndarray, bin_tables: np.ndarray,
                            bins: int) -> np.ndarray:
    """The mesh route (JAX ``render/analysis.py:302``): the lanes padded
    to a multiple of the mesh width and split into contiguous blocks,
    each slot reducing its block with ``histogram_batch`` on its device
    (no collectives): host (B, bins) int32, the same integers as one
    device's."""
    n = mesh.size
    b = planes.shape[0]
    pad = (-b) % n
    if pad:
        planes = np.concatenate([planes, np.zeros((pad,) + planes.shape[1:], planes.dtype)])
        bin_tables = np.concatenate(
            [bin_tables, np.zeros((pad,) + bin_tables.shape[1:], bin_tables.dtype)])
    per = planes.shape[0] // n
    out = [histogram_batch(planes[i * per:(i + 1) * per], bin_tables[i * per:(i + 1) * per],
                           bins, slot.device) for i, slot in enumerate(mesh.slots)]
    return np.concatenate(out)[:b]


def histogram_host(planes, bin_tables, bins: int) -> np.ndarray:
    """Numpy mirror: integer-identical counts."""
    planes = np.asarray(planes)
    bin_tables = np.asarray(bin_tables)
    with HIST_SECONDS.time(stage="host"):
        out = np.empty((planes.shape[0], bins), dtype=np.int32)
        for i in range(planes.shape[0]):
            idx = bin_tables[i][planes[i].reshape(-1).astype(np.int64)]
            out[i] = np.bincount(idx, minlength=bins)[:bins]
    return out


# ---------------------------------------------------------------------------
# stats + canonical JSON body (copied)
# ---------------------------------------------------------------------------

_PERCENTILES = (1, 25, 50, 75, 99)


def stats_from_counts(counts: np.ndarray, window: Tuple[float, float], bins: int) -> dict:
    """Summary statistics from (counts, bin edges) alone: min/max are the
    lower/upper edges of the extreme non-empty bins, the mean uses bin
    midpoints, a percentile is the lower edge of the bin where the
    cumulative count crosses it."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    edges = bin_edges(window, bins)
    out = {"count": total}
    nz = np.nonzero(counts)[0]
    if total == 0 or nz.size == 0:
        out.update({"min": None, "max": None, "mean": None})
        out.update({f"p{p}": None for p in _PERCENTILES})
        return out
    out["min"] = round(float(edges[nz[0]]), 6)
    out["max"] = round(float(edges[nz[-1] + 1]), 6)
    mids = (edges[:-1] + edges[1:]) / 2.0
    out["mean"] = round(float((counts * mids).sum() / total), 6)
    cum = np.cumsum(counts)
    for p in _PERCENTILES:
        rank = max(1, int(np.ceil(total * p / 100.0)))
        out[f"p{p}"] = round(float(edges[int(np.searchsorted(cum, rank))]), 6)
    return out


def histogram_body(
    image_id: int,
    z: int,
    t: int,
    region: Tuple[int, int, int, int],
    resolution: Optional[int],
    spec: HistogramSpec,
    channel_results: List[dict],
) -> bytes:
    """The canonical JSON encoding, one byte form per histogram (so the
    body caches and ETags like a tile). ``data`` mirrors the first
    channel's counts (the omero-ms-image-region field); ``channels``
    carries every channel's result."""
    obj = {
        "imageId": image_id,
        "z": z,
        "t": t,
        "region": list(region),
        "resolution": resolution,
        "bins": spec.bins,
        "usePixelsTypeRange": spec.use_pixel_range,
        "data": channel_results[0]["counts"] if channel_results else [],
        "channels": channel_results,
    }
    return json.dumps(obj, separators=(",", ":")).encode("ascii")
