"""The rendering engine: channel stacks -> composited RGB -> PNG/JPEG
(counterpart of ``omero_ms_pixel_buffer_tpu/render/engine.py``).

Every per-channel stage of the OMERO rendering model up to the LUT is a
function of the pixel value, so ``build_tables`` folds it into a
value -> level table per channel, built on the host in float64 (copied
from the JAX package: equal tables give equal bytes). The device work is
then integer only:

    level = index_table[c][pixel]          # gather
    rgb   = color_lut[c][level]            # gather, (256, 3)
    out   = clamp(sum_c rgb, 255)          # int32 add + min

``render_torch`` is that composite on the tensor's device (``render_local``
in the JAX package). It folds each channel's two gathers into one
value -> RGB table first and packs a table entry's three colours into one
int64 (16 bits each), so each pixel of each channel costs one gather and
one add, and the sums unpack as a view: the same integers. ``fused_render_filter_deflate_batch`` chains
the composite, the ROI mask multiply, the PNG filter kernel on
(B, H, W, 3) uint8 and the ``rle`` or ``stored`` stream build. The host
mirror (``render_host``, ``render_png_host``, the numpy filter and
``zlib_rle_np``) is copied and gives the same bytes; JPEG goes through
Pillow where it is installed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.convert import bits_view
from ..ops.device_deflate import (
    _pad_pow2_lanes,
    _streams_core,
    _to_device,
    resolve_packer,
    zlib_rle_np,
)
from ..ops.kernels.filter import filter_tiles
from ..ops.png import filter_rows_np, frame_png
from .luts import LUT_SIZE, LutRegistry
from .model import ChannelSpec, RenderSpec
from ..utils.metrics import REGISTRY

RENDER_TILES = REGISTRY.counter(
    "render_tiles_total", "Rendered tiles by engine path and format"
)
RENDER_FALLBACK = REGISTRY.counter(
    "render_fallback_total",
    "Render lanes that fell back from the device engine to the host",
)
RENDER_SECONDS = REGISTRY.histogram(
    "render_seconds", "Render stage wall time (stage=tables|host|jpeg)"
)

# position-default channel colors when a spec names none (the OMERO
# viewer's conventional rotation); a single active channel defaults to
# grey like webgateway does
DEFAULT_COLORS: Tuple[Tuple[int, int, int], ...] = (
    (255, 0, 0), (0, 255, 0), (0, 0, 255),
    (255, 0, 255), (0, 255, 255), (255, 255, 0), (255, 255, 255),
)

MAX_COMPOSITE_CHANNELS = 16  # request sanity, not arithmetic safety

QUANT_BINS = 65536  # the quantized (u16) index space


class RenderError(ValueError):
    """Unrenderable combination (pixel type, unknown LUT at build time):
    the pipeline's lane-level None -> 404."""


def unsigned_view(arr: np.ndarray) -> np.ndarray:
    """Signed integer pixels as their two's-complement unsigned bit
    pattern (the index the tables are built over)."""
    if arr.dtype.kind == "i":
        return arr.view(arr.dtype.str.replace("i", "u"))
    return arr


def default_window(dtype: np.dtype) -> Tuple[float, float]:
    if dtype.kind == "u":
        return (0.0, float((1 << (8 * dtype.itemsize)) - 1))
    half = 1 << (8 * dtype.itemsize - 1)
    return (float(-half), float(half - 1))


def renderable_dtype(dtype: np.dtype) -> bool:
    """The direct table domain: integer pixels up to 16-bit."""
    dtype = np.dtype(dtype)
    return dtype.kind in "ui" and dtype.itemsize <= 2


def quantizable_dtype(dtype: np.dtype) -> bool:
    """Pixel types windowed through the host value -> bin quantization
    (float32/float64/int32/uint32) onto ``QUANT_BINS`` uint16 bins."""
    dtype = np.dtype(dtype)
    return dtype.kind in "uif" and dtype.itemsize in (4, 8) and not renderable_dtype(dtype)


def quantize_to_u16(plane: np.ndarray, window: Tuple[float, float]) -> np.ndarray:
    """Window a float/int32 plane onto the uint16 bin space in host
    float64: clip to the window, scale to [0, 65535], round half up. NaN
    maps to bin 0, infinities clip to the window's edges."""
    lo, hi = float(window[0]), float(window[1])
    if not lo < hi or not (np.isfinite(lo) and np.isfinite(hi)):
        raise RenderError(f"Degenerate quantization window [{lo}:{hi}]")
    x = (plane.astype(np.float64) - lo) / (hi - lo)
    x = np.nan_to_num(x, nan=0.0, posinf=1.0, neginf=0.0)
    x = np.clip(x, 0.0, 1.0)
    return np.floor(x * float(QUANT_BINS - 1) + 0.5).astype(np.uint16)


def _channel_lut(ch: ChannelSpec, position: int, n_channels: int, greyscale: bool,
                 registry: Optional[LutRegistry]) -> np.ndarray:
    if greyscale:
        r = g = b = 255
    elif ch.lut is not None:
        table = registry.get(ch.lut) if registry is not None else None
        if table is None:
            raise RenderError(f"Unknown LUT: {ch.lut!r}")
        return np.asarray(table, dtype=np.uint8)
    elif ch.color is not None:
        r, g, b = (int(ch.color[i : i + 2], 16) for i in (0, 2, 4))
    elif n_channels == 1:
        r = g = b = 255
    else:
        r, g, b = DEFAULT_COLORS[position % len(DEFAULT_COLORS)]
    i = np.arange(LUT_SIZE, dtype=np.float64)
    return np.stack([np.floor(i * c / 255.0 + 0.5) for c in (r, g, b)], axis=1).astype(np.uint8)


def build_tables(spec: RenderSpec, dtype: np.dtype, registry: Optional[LutRegistry] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(index_tables (C, K) uint8, color_luts (C, 256, 3) uint8) for the
    spec's composited channels over pixel type ``dtype``: all the float
    math of the rendering model, in host float64, as the JAX package
    computes it."""
    dtype = np.dtype(dtype)
    if not renderable_dtype(dtype):
        raise RenderError(f"Unrenderable pixel type: {dtype}")
    channels = spec.channels[:1] if spec.model == "g" else spec.channels
    if len(channels) > MAX_COMPOSITE_CHANNELS:
        raise RenderError(
            f"{len(channels)} channels exceed the composite bound "
            f"({MAX_COMPOSITE_CHANNELS})"
        )
    k = 1 << (8 * dtype.itemsize)
    greyscale = spec.model == "g"
    with RENDER_SECONDS.time(stage="tables"):
        tables, luts = [], []
        u = np.arange(k, dtype=np.int64)
        values = u if dtype.kind == "u" else ((u + k // 2) % k) - k // 2
        for pos, ch in enumerate(channels):
            wmin, wmax = ch.window if ch.window is not None else default_window(dtype)
            if not wmin < wmax:
                raise RenderError(f"Degenerate window [{wmin}:{wmax}]")
            x = np.clip((values.astype(np.float64) - wmin) / (wmax - wmin), 0.0, 1.0)
            if ch.reverse:
                x = 1.0 - x
            if ch.family in ("exponential", "polynomial"):
                x = np.power(x, ch.coefficient)  # the gamma curve, two spellings
            elif ch.family == "logarithmic":
                x = np.log1p(ch.coefficient * x) / np.log1p(ch.coefficient)
            tables.append(np.clip(np.floor(x * 255.0 + 0.5), 0, 255).astype(np.uint8))
            luts.append(_channel_lut(ch, pos, len(channels), greyscale, registry))
        return np.stack(tables), np.stack(luts)


# ---------------------------------------------------------------------------
# the composite on the device
# ---------------------------------------------------------------------------


def packed_rgb_tables(index_tables: np.ndarray, color_luts: np.ndarray) -> np.ndarray:
    """(C, K) int64: per channel and pixel value, the LUT's RGB at the
    value's level, packed as r | g << 16 | b << 32 (a sum over at most
    ``MAX_COMPOSITE_CHANNELS`` channels of 255 never carries across)."""
    rgb = np.take_along_axis(
        np.asarray(color_luts, dtype=np.int64),
        np.asarray(index_tables, dtype=np.int64)[:, :, None], axis=1)  # (C, K, 3)
    return rgb[..., 0] | (rgb[..., 1] << 16) | (rgb[..., 2] << 32)


def _pixel_index(planes: torch.Tensor) -> torch.Tensor:
    """8/16-bit pixel bits -> int64 table indices. A 16-bit pattern with
    its top bit set reads as a negative int16, and torch indexing counts
    a negative index from the end of the 65536-entry table: the entry of
    the pattern's unsigned view."""
    return bits_view(planes).long()


def render_torch(planes: torch.Tensor, index_tables, color_luts,
                 mask: Optional[torch.Tensor] = None, packed=None) -> torch.Tensor:
    """(B, C, H, W) 8/16-bit pixels (their unsigned view indexes the
    tables) + (C, K) / (C, 256, 3) tables -> (B, H, W, 3) uint8 RGB on
    the planes' device; the same integers as the JAX ``render_local``.
    Only the tables' C channels composite (greyscale builds one).
    ``mask`` (B, H, W) uint8 0/1 multiplies the composite. ``packed`` is
    ``packed_rgb_tables`` of the tables when the caller has it."""
    if packed is None:
        packed = packed_rgb_tables(np.asarray(index_tables), np.asarray(color_luts))
    if isinstance(packed, np.ndarray):
        packed = _to_device(packed, planes.device)
    acc = None
    for c in range(packed.shape[0]):
        contrib = packed[c][_pixel_index(planes[:, c])]  # (B, H, W) int64
        acc = contrib if acc is None else acc + contrib
    # the int64 sums as their four 16-bit fields (r, g, b, 0: the byte
    # order of every CUDA host is little-endian); a field is at most
    # 16 * 255, so it reads the same as int16
    comp = acc.view(torch.int16).view(*acc.shape, 4).clamp(max=255)
    if mask is not None:
        comp = comp * mask[:, :, :, None].to(comp.dtype)
    return comp[..., :3].to(torch.uint8).contiguous()


def fused_render_filter_deflate_batch(
    planes: torch.Tensor, index_tables, color_luts, rows: int, row_bytes: int,
    filter_mode: str = "up", mode: str = "rle", packer: Optional[str] = None,
    mask: Optional[torch.Tensor] = None, packed=None, composite_events=None,
):
    """The render encode chain on the planes' device: (B, C, H, W) pixels
    (bucket-padded: filters look only up and left, so pad pixels never
    reach the real region's bytes) -> ((B, cap) uint8 zlib streams, (B,)
    lengths) of the leading ``rows`` x ``row_bytes`` of each lane's
    filtered RGB8 scanlines. Composite, mask multiply, the filter kernel
    on (B, H, W, 3) uint8 (bpp 3), then the ``mode`` stream (``rle`` or
    ``stored``) with ``packer``; the lane axis is padded to a power of
    two and the padding sliced off, as in the JAX package.
    ``composite_events``, a pair of timing CUDA events, is recorded on
    the current stream around the composite and the mask multiply."""
    if mode not in ("rle", "stored"):
        raise ValueError(f"Unknown device deflate mode: {mode}")
    packer = resolve_packer(packer, planes.device)
    planes, b = _pad_pow2_lanes(planes)
    if mask is not None:
        mask, _ = _pad_pow2_lanes(mask)  # pad lanes mask to 0
    if composite_events is not None:
        composite_events[0].record()
    rgb = render_torch(planes, index_tables, color_luts, mask, packed)
    if composite_events is not None:
        composite_events[1].record()
    filtered = filter_tiles(rgb, filter_mode)  # (B', H, 1 + W*3)
    flat = filtered[:, :rows, :row_bytes].contiguous().reshape(filtered.shape[0], -1)
    streams, lengths = _streams_core(flat, mode, packer)
    return streams[:b], lengths[:b]


# ---------------------------------------------------------------------------
# host mirror: the same chain in numpy, byte-identical output
# ---------------------------------------------------------------------------


def render_host(planes: np.ndarray, index_tables: np.ndarray, color_luts: np.ndarray,
                mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Numpy mirror of the composite for one lane: (C, H, W) unsigned
    pixels (+ an optional (H, W) uint8 mask) -> (H, W, 3) uint8."""
    acc = None
    for c in range(index_tables.shape[0]):  # greyscale: 1 table
        contrib = color_luts[c][index_tables[c][planes[c]]].astype(np.int32)
        acc = contrib if acc is None else acc + contrib
    comp = np.minimum(acc, 255)
    if mask is not None:
        comp = comp * mask[:, :, None].astype(np.int32)
    return comp.astype(np.uint8)


def png_from_rgb_host(rgb: np.ndarray, filter_mode: str = "up") -> bytes:
    """(H, W, 3) uint8 RGB -> PNG through the numpy scanline filter and
    ``zlib_rle_np``: the device chain's bytes."""
    h, w = rgb.shape[:2]
    filtered = filter_rows_np(np.ascontiguousarray(rgb).reshape(h, w * 3), 3, filter_mode)
    return frame_png(zlib_rle_np(filtered.tobytes()), w, h, 8, 2)


def render_png_host(planes: np.ndarray, index_tables: np.ndarray, color_luts: np.ndarray,
                    filter_mode: str = "up", mask: Optional[np.ndarray] = None) -> bytes:
    """One lane rendered and PNG-encoded on the host, byte-identical to
    the fused device chain."""
    with RENDER_SECONDS.time(stage="host"):
        return png_from_rgb_host(render_host(planes, index_tables, color_luts, mask), filter_mode)


def encode_jpeg(rgb: np.ndarray, quality: int) -> Optional[bytes]:
    """JPEG through Pillow; None (-> 404) where Pillow is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    import io

    with RENDER_SECONDS.time(stage="jpeg"):
        buf = io.BytesIO()
        Image.fromarray(rgb, mode="RGB").save(buf, format="JPEG", quality=int(quality))
        return buf.getvalue()
