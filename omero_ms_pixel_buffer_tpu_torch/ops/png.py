"""PNG framing and scanline filters (counterpart of
``omero_ms_pixel_buffer_tpu/ops/png.py``).

The device path builds complete zlib streams (``ops/device_deflate``);
the host frames them into PNG chunks (``frame_png``). ``filter_batch``
is the plain PyTorch filter — the contract the CUDA filter kernel
(``ops/kernels/filter.py``) is held to — and ``filter_rows_np`` is the
numpy reference both are tested against; it alone has the ``adaptive``
mode (the device filter has the five fixed modes). ``encode_png`` is the
host encode of one tile (numpy filter + Python zlib) under any filter,
level and strategy: the single-request route, and the host PNG route
(lanes larger than every bucket, the host engine, ``adaptive`` lanes)
wherever the native engine is missing or lacks the filter.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# filter type codes (PNG spec 4.5.4)
FILTER_NONE, FILTER_SUB, FILTER_UP, FILTER_AVERAGE, FILTER_PAETH = range(5)

FILTER_CODES = {
    "none": FILTER_NONE, "sub": FILTER_SUB, "up": FILTER_UP,
    "average": FILTER_AVERAGE, "paeth": FILTER_PAETH,
}

_PNG_DTYPES = {
    np.dtype(np.uint8): 8,
    np.dtype(np.int8): 8,
    np.dtype(np.uint16): 16,
    np.dtype(np.int16): 16,
}


# the PNG encode policy's defaults (backend.png: filter, level, strategy);
# a pipeline takes its own policy (``TilePipeline(png_filter=, png_level=,
# png_strategy=)``). ``filter`` is one of ``FILTER_CODES`` or ``adaptive``
# (host only), ``strategy`` one of ``ZLIB_STRATEGIES`` (an unknown name is
# zlib's default strategy, as in the JAX package)
PNG_FILTER = "up"
PNG_LEVEL = 6
PNG_STRATEGY = "fast"

ZLIB_STRATEGIES = {
    "default": zlib.Z_DEFAULT_STRATEGY,
    "filtered": zlib.Z_FILTERED,
    "huffman": zlib.Z_HUFFMAN_ONLY,
    "rle": zlib.Z_RLE,
    "fixed": zlib.Z_FIXED,
    # "fast" is the native RLE + dynamic-Huffman encoder; the closest
    # Python behaviour (the same match policy) is Z_RLE
    "fast": zlib.Z_RLE,
}


class PngEncodeError(ValueError):
    """Unsupported pixel type for PNG (-> 404)."""


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag)
    crc = zlib.crc32(data, crc) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def _ihdr(width: int, height: int, bit_depth: int, color_type: int) -> bytes:
    return _chunk(
        b"IHDR",
        struct.pack(">IIBBBBB", width, height, bit_depth, color_type, 0, 0, 0),
    )


def frame_png(
    idat: bytes, width: int, height: int, bit_depth: int, color_type: int
) -> bytes:
    """Wrap a complete zlib stream into a PNG container."""
    return (
        PNG_SIGNATURE
        + _ihdr(width, height, bit_depth, color_type)
        + _chunk(b"IDAT", idat)
        + _chunk(b"IEND", b"")
    )


def assemble_png(filtered_scanlines: bytes, width: int, height: int, bit_depth: int,
                 color_type: int, level: int = PNG_LEVEL,
                 strategy: str = PNG_STRATEGY) -> bytes:
    """Deflate filtered scanline bytes (filter byte + row data per row)
    with zlib at ``level`` and ``strategy`` into a complete PNG."""
    co = zlib.compressobj(level, zlib.DEFLATED, 15, 8, ZLIB_STRATEGIES.get(strategy, 0))
    idat = co.compress(filtered_scanlines) + co.flush()
    return frame_png(idat, width, height, bit_depth, color_type)


def _as_byte_rows(tile: np.ndarray):
    """(H, W[, 3]) pixel array -> ((H, row_bytes) big-endian byte matrix,
    width, height, bit depth, colour type, bpp: the filter unit)."""
    if tile.ndim == 2:
        samples, color_type = 1, 0  # grayscale
    elif tile.ndim == 3 and tile.shape[2] == 3:
        samples, color_type = 3, 2  # RGB
    else:
        raise PngEncodeError(f"Unsupported PNG shape: {tile.shape}")
    dtype = tile.dtype
    if dtype not in _PNG_DTYPES:
        raise PngEncodeError(f"Unsupported PNG pixel type: {dtype}")
    h, w = tile.shape[:2]
    be = np.ascontiguousarray(tile.astype(dtype.newbyteorder(">"), copy=False))
    rows = be.view(np.uint8).reshape(h, w * samples * dtype.itemsize)
    return rows, w, h, _PNG_DTYPES[dtype], color_type, samples * dtype.itemsize


def encode_png(tile: np.ndarray, filter_mode: str = PNG_FILTER, level: int = PNG_LEVEL,
               strategy: str = PNG_STRATEGY) -> bytes:
    """Host PNG encode of one tile: numpy filter, Python zlib."""
    rows, w, h, bit_depth, color_type, bpp = _as_byte_rows(tile)
    filtered = filter_rows_np(rows, bpp, filter_mode)
    return assemble_png(filtered.tobytes(), w, h, bit_depth, color_type, level, strategy)


# ---------------------------------------------------------------------------
# numpy reference filter
# ---------------------------------------------------------------------------


def _shift_left(rows: np.ndarray, bpp: int) -> np.ndarray:
    out = np.zeros_like(rows)
    out[:, bpp:] = rows[:, :-bpp]
    return out


def _shift_up(rows: np.ndarray) -> np.ndarray:
    out = np.zeros_like(rows)
    out[1:] = rows[:-1]
    return out


def _paeth_predictor(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    ai, bi, ci = (x.astype(np.int16) for x in (a, b, c))
    p = ai + bi - ci
    pa, pb, pc = np.abs(p - ai), np.abs(p - bi), np.abs(p - ci)
    out = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return out.astype(np.uint8)


def _residual(rows: np.ndarray, a: np.ndarray, b: np.ndarray, code: int) -> np.ndarray:
    """The filtered bytes of ``rows`` under filter ``code`` (``a``: the
    byte to the left, ``b``: the byte above)."""
    if code == FILTER_NONE:
        return rows
    if code == FILTER_SUB:
        return rows - a
    if code == FILTER_UP:
        return rows - b
    if code == FILTER_AVERAGE:
        avg = (a.astype(np.uint16) + b.astype(np.uint16)) >> 1
        return rows - avg.astype(np.uint8)
    return rows - _paeth_predictor(a, b, _shift_up(a))


def filter_rows_np(rows: np.ndarray, bpp: int, mode: str = "none") -> np.ndarray:
    """Filter a (H, row_bytes) byte matrix; returns (H, 1+row_bytes) with
    the filter-type byte prepended per row. ``mode`` is one of
    ``FILTER_CODES`` or ``adaptive``: per row, the filter whose residual
    has the least sum of |signed byte| (the first on a tie)."""
    h = rows.shape[0]
    a = _shift_left(rows, bpp)
    b = _shift_up(rows)
    if mode in FILTER_CODES:
        code = FILTER_CODES[mode]
        filt = np.full((h, 1), code, dtype=np.uint8)
        return np.concatenate([filt, _residual(rows, a, b, code)], axis=1)
    if mode != "adaptive":
        raise ValueError(f"Unknown filter mode: {mode}")
    cands = np.stack([_residual(rows, a, b, code) for code in range(5)])  # (5, H, RB)
    costs = np.abs(cands.astype(np.int8).astype(np.int32)).sum(axis=2)  # (5, H)
    best = costs.argmin(axis=0)
    chosen = cands[best, np.arange(h)]
    return np.concatenate([best.astype(np.uint8)[:, None], chosen], axis=1)


# ---------------------------------------------------------------------------
# plain PyTorch filter (the CUDA filter kernel's contract)
# ---------------------------------------------------------------------------


def filter_batch(rows: torch.Tensor, bpp: int, mode: str = "up") -> torch.Tensor:
    """rows: (B, H, RB) uint8 big-endian row bytes -> (B, H, 1+RB)
    filtered scanlines, on the tensor's device. Arithmetic in int32,
    reduced mod 256, exactly as the JAX ``_filter_batch``."""
    if mode not in FILTER_CODES:
        raise ValueError(f"Unknown filter mode: {mode}")
    B, H, RB = rows.shape
    x = rows.to(torch.int32)
    a = torch.zeros_like(x)
    a[:, :, bpp:] = x[:, :, : RB - bpp]
    b = torch.zeros_like(x)
    b[:, 1:, :] = x[:, : H - 1, :]
    code = FILTER_CODES[mode]
    if code == FILTER_NONE:
        res = x
    elif code == FILTER_SUB:
        res = x - a
    elif code == FILTER_UP:
        res = x - b
    elif code == FILTER_AVERAGE:
        res = x - ((a + b) >> 1)
    else:
        c = torch.zeros_like(a)
        c[:, 1:, :] = a[:, : H - 1, :]
        p = a + b - c
        pa, pb, pc = (p - a).abs(), (p - b).abs(), (p - c).abs()
        pred = torch.where(
            (pa <= pb) & (pa <= pc), a, torch.where(pb <= pc, b, c)
        )
        res = x - pred
    out = torch.empty((B, H, 1 + RB), dtype=torch.uint8, device=rows.device)
    out[:, :, 0] = code
    out[:, :, 1:] = (res & 0xFF).to(torch.uint8)
    return out
