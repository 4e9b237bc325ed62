"""Fused byteswap + PNG scanline filter: CUDA kernel and plain version.

Replaces the Pallas TPU kernel ``omero_ms_pixel_buffer_tpu/ops/pallas/
filter.py`` (``_filter_tiles``; ``pl.pallas_call`` at :137). The kernel
(``csrc/filter.cu``, ``filter_row_groups``) is bound by bytes — one read
of the tiles, one write of the scanlines — so it is built around wide
memory instructions with many of them in flight: each warp owns a group
of consecutive scanlines and walks them row by row in 512-byte column
steps, each lane holding one 16-byte chunk in registers (loaded with one
16-byte load, byteswapped with ``__byte_perm``; left neighbours by
shuffle, the row above from the previous row's registers, the next row
already loading). Sixteen output bytes a lane come from SIMD-in-word
intrinsics, the mode a template parameter, and are written with aligned
16-byte stores after a shuffle realigns them to the output row's offset.
Rows that are not 16-byte aligned (a misaligned tensor, a row length
that is not a multiple of 16) or wider left distances than 16 bytes take
a byte-load branch of the same entry point. The TPU kernel's VMEM size
cap does not apply: any shape is taken.
"""

from __future__ import annotations

import ctypes

import torch

from ..convert import bits_view, to_big_endian_bytes
from ..png import FILTER_CODES, filter_batch
from . import _build, count_launch

# ompb_filter(in, out, rows, H, WS, S, itemsize, mode, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _geometry(tiles: torch.Tensor):
    if tiles.ndim == 4:
        B, H, W, S = tiles.shape
    elif tiles.ndim == 3:
        (B, H, W), S = tiles.shape, 1
    else:
        raise ValueError(f"tiles must be (B, H, W[, S]), got {tuple(tiles.shape)}")
    return B, H, W, S


def filter_tiles_plain(tiles: torch.Tensor, mode: str = "up") -> torch.Tensor:
    """The plain PyTorch version: ``png.filter_batch`` over the
    big-endian bytes of ``tiles``, on the tensor's device."""
    B, H, _, S = _geometry(tiles)
    rows = to_big_endian_bytes(tiles).reshape(B, H, -1)
    return filter_batch(rows, S * bits_view(tiles).element_size(), mode)


def _launch(tiles: torch.Tensor, mode: str) -> torch.Tensor:
    B, H, W, S = _geometry(tiles)
    bits = bits_view(tiles)
    if not bits.is_contiguous():
        raise ValueError("filter kernel needs contiguous tiles")
    itemsize = bits.element_size()
    rows, ws = B * H, W * S
    if rows >= 2**31 or ws * itemsize + 1 >= 2**31:
        raise ValueError(f"tiles too large for the filter kernel: {tuple(tiles.shape)}")
    out = torch.empty((B, H, 1 + ws * itemsize), dtype=torch.uint8, device=tiles.device)
    if out.numel() == 0:
        return out
    fn = _build.entry("filter", "ompb_filter", _ARGTYPES)
    with torch.cuda.device(tiles.device):
        code = fn(bits.data_ptr(), out.data_ptr(), rows, H, ws, S, itemsize,
                  FILTER_CODES[mode], _build.stream_handle(tiles.device))
    _build.check(code, "filter kernel launch")
    count_launch(filter_tiles)
    return out


def filter_tiles(tiles: torch.Tensor, mode: str = "up") -> torch.Tensor:
    """(B, H, W[, S]) uint8/int8/uint16/int16 tiles -> (B, H, 1 +
    W*S*itemsize) uint8 filtered big-endian scanlines. A CUDA tensor
    launches the kernel (or raises); a CPU tensor takes the plain
    version."""
    if mode not in FILTER_CODES:
        raise ValueError(f"Unknown filter mode: {mode}")
    if tiles.device.type == "cuda":
        return _launch(tiles, mode)
    if tiles.device.type == "cpu":
        return filter_tiles_plain(tiles, mode)
    raise ValueError(f"Unsupported device: {tiles.device}")


filter_tiles.launches = 0
