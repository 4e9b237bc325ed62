"""Intensity projection, the ``p=intmax|intmean`` reduction (counterpart of
``omero_ms_pixel_buffer_tpu/render/projection.py``).

A projection collapses a z (or t) range of planes into one before
windowing: ``intmax`` is the elementwise maximum, ``intmean`` the
elementwise mean, both in integer arithmetic (mean = floor(sum / n)), so
the device reduction and the host mirror give identical pixels.

``project_torch`` is the device form (``_project_device`` in the JAX
package) on the tensor's own device; ``project_np`` is the host mirror,
copied. Device tensors hold pixels as their bit patterns (``ops/convert``):
the reduction widens them to int32 as the pixel type reads them, reduces,
and narrows back to the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.convert import bits_view

MODES = ("intmax", "intmean")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"Unknown projection mode: {mode}")


def project_np(stack: np.ndarray, mode: str) -> np.ndarray:
    """Host mirror: (..., Z, H, W) -> (..., H, W), native dtype kept."""
    _check_mode(mode)
    if mode == "intmax":
        return stack.max(axis=-3)
    n = stack.shape[-3]
    return (stack.astype(np.int64).sum(axis=-3) // n).astype(stack.dtype)


def project_torch(stack: torch.Tensor, mode: str, signed: bool = False) -> torch.Tensor:
    """(..., Z, H, W) 8/16-bit pixel bits -> (..., H, W) bits of the same
    dtype, on the tensor's device. ``signed`` says whether the bits are
    signed pixels (int8/int16) or unsigned ones (uint8/uint16)."""
    _check_mode(mode)
    bits = bits_view(stack)
    if bits.shape[-3] == 1:  # single plane: nothing to reduce
        return bits[..., 0, :, :]
    if bits.dtype == torch.uint8:
        wide = bits.view(torch.int8).to(torch.int32) if signed else bits.to(torch.int32)
    else:
        wide = bits.to(torch.int32)
        if not signed:
            wide = wide & 0xFFFF
    if mode == "intmax":
        out = wide.amax(dim=-3)
    else:
        # int32 sums (Z * 65535 stays far from the int32 edge) and floor
        # division, as the JAX reduction and the numpy mirror
        out = torch.div(wide.sum(dim=-3, dtype=torch.int32), bits.shape[-3],
                        rounding_mode="floor")
    return out.to(bits.dtype)
