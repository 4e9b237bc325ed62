"""Lookup tables: built-in colormaps + the ImageJ ``.lut`` file format.

A host-only copy of ``omero_ms_pixel_buffer_tpu/render/luts.py``: the port
imports nothing of the JAX package, and its 400 messages and signatures
must stay word for word the same.

OMERO ships ImageJ's LUT collection and channels reference them by
file name (``$cool.lut`` in the channel spec). This registry carries a
procedurally-generated built-in set (the primaries plus the classic
fire/ice/spectrum ramps ImageJ popularized) and loads operator LUTs
from a configured directory (the server's ``--lut-dir``) at startup.

A LUT is a (256, 3) uint8 table: rendered index -> RGB. File formats
accepted (the ImageJ reader's rules):

- raw 768 bytes: 256 reds, 256 greens, 256 blues;
- NIH Image header: ``ICOL`` magic, 32-byte header, then the 768
  color bytes.

Anything else raises ``LutError`` (load-time; a request naming an
unknown LUT is a 400 at the HTTP front, which validates names against
this registry before dispatch).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.render.luts")

LUT_SIZE = 256


class LutError(ValueError):
    """Unreadable/unsupported LUT file."""


def _ramp(r: int, g: int, b: int) -> np.ndarray:
    """Linear ramp from black to (r, g, b)."""
    i = np.arange(LUT_SIZE, dtype=np.float64)
    table = np.stack(
        [np.floor(i * c / 255.0 + 0.5) for c in (r, g, b)], axis=1
    )
    return table.astype(np.uint8)


def _interpolate(points: List[int]) -> np.ndarray:
    """Expand an ImageJ-style 32-point control list to 256 entries
    (linear interpolation, the ImageJ ``interpolate`` behavior)."""
    xs = np.linspace(0, LUT_SIZE - 1, num=len(points))
    return np.clip(
        np.rint(np.interp(np.arange(LUT_SIZE), xs, points)), 0, 255
    ).astype(np.uint8)


# ImageJ's classic "fire" and "ice" 32-point control tables (LutLoader).
_FIRE_R = [0, 0, 1, 25, 49, 73, 98, 122, 146, 162, 173, 184, 195, 207,
           217, 229, 240, 252, 255, 255, 255, 255, 255, 255, 255, 255,
           255, 255, 255, 255, 255, 255]
_FIRE_G = [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 14, 35, 57, 79, 101,
           117, 133, 147, 161, 175, 190, 205, 219, 234, 248, 255, 255,
           255, 255]
_FIRE_B = [0, 61, 96, 130, 165, 192, 220, 227, 210, 181, 151, 122, 93,
           64, 35, 5, 0, 0, 0, 0, 0, 0, 0, 0, 0, 35, 98, 160, 223, 255,
           255, 255]
_ICE_R = [0, 0, 0, 0, 0, 0, 19, 29, 50, 48, 79, 112, 134, 158, 186,
          201, 217, 229, 242, 250, 250, 250, 250, 251, 250, 250, 250,
          250, 251, 251, 243, 230]
_ICE_G = [156, 165, 176, 184, 190, 196, 193, 184, 171, 162, 146, 125,
          107, 93, 81, 87, 92, 97, 95, 93, 93, 90, 85, 69, 64, 54, 47,
          35, 19, 0, 4, 0]
_ICE_B = [140, 147, 158, 166, 170, 176, 209, 220, 234, 225, 236, 246,
          250, 251, 250, 250, 245, 230, 230, 222, 202, 180, 163, 142,
          123, 114, 106, 94, 84, 64, 26, 27]


def _spectrum() -> np.ndarray:
    """Hue sweep (ImageJ "spectrum": HSB hue 0..1 at full
    saturation/brightness)."""
    h = np.arange(LUT_SIZE, dtype=np.float64) / LUT_SIZE * 6.0
    x = 1.0 - np.abs(h % 2.0 - 1.0)
    zeros = np.zeros(LUT_SIZE)
    ones = np.ones(LUT_SIZE)
    sector = h.astype(np.int64) % 6
    r = np.select(
        [sector == 0, sector == 1, sector == 2, sector == 3,
         sector == 4, sector == 5],
        [ones, x, zeros, zeros, x, ones],
    )
    g = np.select(
        [sector == 0, sector == 1, sector == 2, sector == 3,
         sector == 4, sector == 5],
        [x, ones, ones, x, zeros, zeros],
    )
    b = np.select(
        [sector == 0, sector == 1, sector == 2, sector == 3,
         sector == 4, sector == 5],
        [zeros, zeros, x, ones, ones, x],
    )
    return np.clip(
        np.rint(np.stack([r, g, b], axis=1) * 255.0), 0, 255
    ).astype(np.uint8)


def builtin_luts() -> Dict[str, np.ndarray]:
    return {
        "grey": _ramp(255, 255, 255),
        "gray": _ramp(255, 255, 255),
        "red": _ramp(255, 0, 0),
        "green": _ramp(0, 255, 0),
        "blue": _ramp(0, 0, 255),
        "cyan": _ramp(0, 255, 255),
        "magenta": _ramp(255, 0, 255),
        "yellow": _ramp(255, 255, 0),
        "fire": np.stack(
            [_interpolate(_FIRE_R), _interpolate(_FIRE_G),
             _interpolate(_FIRE_B)], axis=1,
        ),
        "ice": np.stack(
            [_interpolate(_ICE_R), _interpolate(_ICE_G),
             _interpolate(_ICE_B)], axis=1,
        ),
        "spectrum": _spectrum(),
    }


def load_imagej_lut(path: str) -> np.ndarray:
    """Read one ImageJ ``.lut`` file -> (256, 3) uint8."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] == b"ICOL":
        raw = raw[32:]
    if len(raw) < 3 * LUT_SIZE:
        raise LutError(
            f"{path}: {len(raw)} bytes; expected raw 768 or an "
            "ICOL-headered NIH LUT"
        )
    arr = np.frombuffer(raw[: 3 * LUT_SIZE], dtype=np.uint8)
    return arr.reshape(3, LUT_SIZE).T.copy()  # 256R,256G,256B -> (256,3)


def write_imagej_lut(path: str, table: np.ndarray) -> None:
    """Write the raw-768 form (tests round-trip through this)."""
    table = np.asarray(table, dtype=np.uint8)
    if table.shape != (LUT_SIZE, 3):
        raise LutError(f"LUT table must be (256, 3); got {table.shape}")
    with open(path, "wb") as f:
        f.write(table.T.tobytes())  # (3, 256): 256R, 256G, 256B


class LutRegistry:
    """Name -> (256, 3) table. Lookups are case-insensitive and accept
    the name with or without the ``.lut`` suffix (requests copy names
    out of OMERO configs, which use both spellings)."""

    def __init__(self, lut_dir: Optional[str] = None):
        self._tables: Dict[str, np.ndarray] = {}
        for name, table in builtin_luts().items():
            self._tables[name] = table
        self.lut_dir = lut_dir
        if lut_dir:
            self._load_dir(lut_dir)

    def _load_dir(self, lut_dir: str) -> None:
        if not os.path.isdir(lut_dir):
            log.warning("LUT directory %s is not a directory", lut_dir)
            return
        for fname in sorted(os.listdir(lut_dir)):
            if not fname.lower().endswith(".lut"):
                continue
            name = fname[: -len(".lut")].lower()
            try:
                self._tables[name] = load_imagej_lut(
                    os.path.join(lut_dir, fname)
                )
            except (LutError, OSError) as e:
                # one bad file must not take down the registry (or the
                # deploy) — the name simply stays unknown -> 400s
                log.warning("skipping LUT %s: %s", fname, e)

    @staticmethod
    def _key(name: str) -> str:
        name = name.strip().lower()
        return name[: -len(".lut")] if name.endswith(".lut") else name

    def get(self, name: str) -> Optional[np.ndarray]:
        return self._tables.get(self._key(name))

    def __contains__(self, name: str) -> bool:
        return self._key(name) in self._tables

    def names(self) -> List[str]:
        return sorted(self._tables)

    def __len__(self) -> int:
        return len(self._tables)
