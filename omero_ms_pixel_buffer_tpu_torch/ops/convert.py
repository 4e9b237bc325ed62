"""Pixel-type tables and big-endian conversion (counterpart of
``omero_ms_pixel_buffer_tpu/ops/convert.py``).

Device tensors of 16-bit pixels are held as ``torch.int16`` *bit
patterns* whatever the OMERO signedness: torch has few ``uint16``
operations, and every consumer here (byteswap, PNG filter) works on the
raw bits. 8-bit pixels are held as ``torch.uint8`` bits.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# OMERO PixelsType enum values (ome.model.enums.PixelsType) -> numpy.
OMERO_PIXEL_TYPES: Dict[str, np.dtype] = {
    "int8": np.dtype(np.int8),
    "uint8": np.dtype(np.uint8),
    "int16": np.dtype(np.int16),
    "uint16": np.dtype(np.uint16),
    "int32": np.dtype(np.int32),
    "uint32": np.dtype(np.uint32),
    "float": np.dtype(np.float32),
    "double": np.dtype(np.float64),
}

_NUMPY_TO_OMERO = {v: k for k, v in OMERO_PIXEL_TYPES.items()}

# torch dtype holding each pixel width's bits on the device
_BITS_DTYPE = {1: torch.uint8, 2: torch.int16}


def dtype_for(pixels_type: str) -> np.dtype:
    """numpy dtype for an OMERO pixels-type name."""
    try:
        return OMERO_PIXEL_TYPES[pixels_type]
    except KeyError:
        raise ValueError(f"Unknown pixels type: {pixels_type}") from None


def omero_type_for(dtype) -> str:
    return _NUMPY_TO_OMERO[np.dtype(dtype)]


def bytes_per_pixel(pixels_type: str) -> int:
    return dtype_for(pixels_type).itemsize


def bits_tensor(arr: np.ndarray) -> torch.Tensor:
    """Native-endian 8/16-bit numpy pixels -> a CPU tensor of their bits
    (uint8 or int16), sharing memory with ``arr`` where it can."""
    arr = np.ascontiguousarray(arr)
    itemsize = arr.dtype.itemsize
    if itemsize not in _BITS_DTYPE:
        raise ValueError(f"No device bit layout for {arr.dtype}")
    view = arr.view(np.uint8 if itemsize == 1 else np.int16)
    return torch.from_numpy(view)


def bits_view(x: torch.Tensor) -> torch.Tensor:
    """Any 8/16-bit integer tensor as its bit-pattern dtype (a view)."""
    if x.dtype in (torch.uint8, torch.int16):
        return x
    if x.dtype == torch.int8:
        return x.view(torch.uint8)
    if x.dtype == torch.uint16:
        return x.view(torch.int16)
    raise ValueError(f"Unsupported pixel tensor dtype: {x.dtype}")


def to_big_endian_bytes(x: torch.Tensor) -> torch.Tensor:
    """(..., W) 8/16-bit pixels -> (..., W*itemsize) uint8 big-endian
    bytes, on the tensor's device. 16-bit bits widen to int32 and mask
    to 0xFFFF, so signed and unsigned pixels byteswap alike."""
    x = bits_view(x)
    if x.dtype == torch.uint8:
        return x
    v = x.to(torch.int32) & 0xFFFF
    hi = (v >> 8).to(torch.uint8)
    lo = (v & 0xFF).to(torch.uint8)
    stacked = torch.stack([hi, lo], dim=-1)  # (..., W, 2)
    return stacked.reshape(*x.shape[:-1], x.shape[-1] * 2)


def to_big_endian_bytes_np(x: np.ndarray) -> np.ndarray:
    """Host big-endian bytes (raw tile bodies)."""
    be = np.ascontiguousarray(x.astype(x.dtype.newbyteorder(">"), copy=False))
    return be.view(np.uint8).reshape(*x.shape[:-1], x.shape[-1] * x.dtype.itemsize)
