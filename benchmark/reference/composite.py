"""The plain ``/render`` composite of OMERO's rendering model for the
channel grammar the traffic sends (``c=i|start:end$RRGGBB,...``, linear
family, no reverse, no projection): each channel's pixel is windowed
to a level in 0..255, its colour is scaled by the level, the colours
are summed and each component clamped at 255.

    level  = floor(clip((v - start) / (end - start), 0, 1) * 255 + 0.5)
    colour = floor(level * component / 255 + 0.5)

The arithmetic is float64, as the model states. ``pixel_dtype`` lets
the control run the same composite on pixels stored at a lower
precision."""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np

Channel = Tuple[int, float, float, str]  # (index 0-based, start, end, RRGGBB)


def parse_channels(c: str) -> list:
    """``1|500:30000$FF0000,2|...`` -> [(0, 500.0, 30000.0, "FF0000"), ...]."""
    out = []
    for part in c.split(","):
        index, _, rest = part.partition("|")
        window, _, color = rest.partition("$")
        start, _, end = window.partition(":")
        out.append((int(index) - 1, float(start), float(end), color.upper()))
    return out


def levels(values: np.ndarray, start: float, end: float) -> np.ndarray:
    """Pixel values (any numeric dtype) -> window levels 0..255 (int64)."""
    x = np.clip((values.astype(np.float64) - start) / (end - start), 0.0, 1.0)
    return np.floor(x * 255.0 + 0.5).astype(np.int64)


@lru_cache(maxsize=256)
def _u16_rgb(start: float, end: float, color: str) -> np.ndarray:
    """Every uint16 value's tinted colour, packed as r | g << 16 | b << 32
    (int64): the same float64 arithmetic, once per window and colour."""
    level = levels(np.arange(1 << 16), start, end)
    out = np.zeros(1 << 16, np.int64)
    for k in range(3):
        component = int(color[2 * k:2 * k + 2], 16)
        out |= np.floor(level * component / 255.0 + 0.5).astype(np.int64) << (16 * k)
    return out


def composite(planes: np.ndarray, channels: Sequence[Channel],
              pixel_dtype=None) -> np.ndarray:
    """(C, h, w) source pixels -> (h, w, 3) uint8 RGB. With ``pixel_dtype``
    the pixels are first stored in that type (the control's step)."""
    h, w = planes.shape[1:]
    if pixel_dtype is None and planes.dtype == np.uint16:
        # sums of at most 16 components of 255 never carry across 16 bits
        packed = sum(_u16_rgb(start, end, color)[planes[index]]
                     for index, start, end, color in channels)
        fields = packed.astype("<i8", copy=False).view("<i2").reshape(h, w, 4)
        return np.minimum(fields[:, :, :3], 255).astype(np.uint8)
    acc = np.zeros((h, w, 3), np.int64)
    for index, start, end, color in channels:
        level = levels(planes[index].astype(pixel_dtype or planes.dtype), start, end)
        for k in range(3):
            component = int(color[2 * k:2 * k + 2], 16)
            acc[:, :, k] += np.floor(level * component / 255.0 + 0.5).astype(np.int64)
    return np.minimum(acc, 255).astype(np.uint8)
