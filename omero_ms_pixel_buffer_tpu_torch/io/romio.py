"""ROMIO pixel-buffer reader, OMERO's classic plane-file layout (copy of
``omero_ms_pixel_buffer_tpu/io/romio.py``): one flat file of big-endian
planes at ``<data-dir>/Pixels/<id>``, concatenated in XYZCT order (X
fastest, then Y, Z, C, T). Single-resolution: OMERO keeps pyramids of
large images in separate files (served by the OME-TIFF reader).
"""

from __future__ import annotations

import mmap
import os
from typing import Optional, Tuple

import numpy as np

from .pixel_buffer import PixelBuffer, PixelsMeta, check_bounds


class RomioPixelBuffer(PixelBuffer):
    def __init__(self, path: str, meta: PixelsMeta):
        super().__init__(meta)
        self.path = path
        expected = (
            meta.size_x * meta.size_y * meta.size_z * meta.size_c
            * meta.size_t * meta.bytes_per_pixel
        )
        actual = os.path.getsize(path)
        if actual != expected:
            raise ValueError(
                f"ROMIO file size mismatch for {path}: "
                f"expected {expected}, got {actual}"
            )
        self._file = open(path, "rb")
        self.mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        # big-endian on disk (OMERO convention)
        self._disk_dtype = meta.dtype.newbyteorder(">")

    def get_tile_at(self, level, z, c, t, x, y, w, h) -> np.ndarray:
        if level != 0:
            raise ValueError("ROMIO buffers are single-resolution")
        m = self.meta
        check_bounds(z, c, t, x, y, w, h, m.size_x, m.size_y,
                     m.size_z, m.size_c, m.size_t)
        bpp = m.bytes_per_pixel
        plane_px = m.size_x * m.size_y
        # XYZCT: plane index = z + c*Z + t*Z*C
        plane = z + c * m.size_z + t * m.size_z * m.size_c
        base = plane * plane_px * bpp
        # one strided view over the mmap'd plane; astype does the copy
        full = np.frombuffer(
            self.mm, dtype=self._disk_dtype, count=plane_px, offset=base
        ).reshape(m.size_y, m.size_x)
        return full[y : y + h, x : x + w].astype(m.dtype.newbyteorder("="))

    def close(self) -> None:
        self.mm.close()
        self._file.close()


def write_romio(path: str, data: np.ndarray) -> None:
    """Write 5D TCZYX data as a ROMIO plane file (XYZCT order,
    big-endian) — fixture/export support."""
    if data.ndim != 5:
        raise ValueError("write_romio expects TCZYX data")
    T, C, Z, Y, X = data.shape
    be = data.astype(data.dtype.newbyteorder(">"), copy=False)
    with open(path, "wb") as f:
        for t in range(T):
            for c in range(C):
                for z in range(Z):
                    f.write(np.ascontiguousarray(be[t, c, z]).tobytes())
