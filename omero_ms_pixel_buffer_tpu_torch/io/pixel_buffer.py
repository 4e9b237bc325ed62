"""The pixel-buffer contract (counterpart of ``omero_ms_pixel_buffer_tpu/
io/pixel_buffer.py``): the ``Pixels`` metadata row, a random-access
reader with explicit resolution levels, and a decoded-block LRU."""

from __future__ import annotations

import dataclasses
import itertools
import threading
from collections import OrderedDict
from typing import Hashable, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.convert import dtype_for

# monotonic namespace ids: buffers sharing one BlockCache never alias
_cache_namespace = itertools.count(1).__next__


class BlockCache:
    """Byte-bounded, thread-safe LRU of decoded storage blocks: a
    compressed chunk is inflated once and every later tile that overlaps
    it assembles from the cached bytes."""

    def __init__(self, max_bytes: int = 256 << 20):
        self.max_bytes = max_bytes
        self._entries: "OrderedDict[Hashable, np.ndarray]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    def get(self, key: Hashable) -> Optional[np.ndarray]:
        with self._lock:
            value = self._entries.get(key)
            if value is not None:
                self._entries.move_to_end(key)
            return value

    def put(self, key: Hashable, value: np.ndarray) -> None:
        size = int(value.nbytes)
        if size > self.max_bytes:
            return
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= int(old.nbytes)
            self._entries[key] = value
            self._bytes += size
            while self._bytes > self.max_bytes:
                _, evicted = self._entries.popitem(last=False)
                self._bytes -= int(evicted.nbytes)


@dataclasses.dataclass(frozen=True)
class PixelsMeta:
    """Dimensions + pixel type of one image."""

    image_id: int
    size_x: int
    size_y: int
    size_z: int
    size_c: int
    size_t: int
    pixels_type: str  # OMERO PixelsType enum value, e.g. "uint16"
    image_name: str = ""

    @property
    def dtype(self) -> np.dtype:
        return dtype_for(self.pixels_type)

    @property
    def bytes_per_pixel(self) -> int:
        return self.dtype.itemsize


class PixelBuffer:
    """Abstract pixel reader; reads take the resolution level
    explicitly (buffers are shared across concurrent requests)."""

    def __init__(self, meta: PixelsMeta):
        self.meta = meta
        self.cache_ns = _cache_namespace()

    @property
    def resolution_levels(self) -> int:
        return 1

    def level_size(self, level: int = 0) -> Tuple[int, int]:
        """(size_x, size_y) at ``level``."""
        if level == 0:
            return self.meta.size_x, self.meta.size_y
        raise NotImplementedError

    def get_tile_at(
        self, level: int, z: int, c: int, t: int,
        x: int, y: int, w: int, h: int,
    ) -> np.ndarray:
        """(h, w) native-endian array; out-of-bounds raises (-> 404)."""
        raise NotImplementedError

    def read_tiles(
        self, coords: Sequence[Tuple[int, int, int, int, int, int, int]],
        level: int = 0,
    ) -> List[Optional[np.ndarray]]:
        """Batched read of (z, c, t, x, y, w, h) tuples."""
        return [self.get_tile_at(level, *co) for co in coords]

    def close(self) -> None:
        pass

    def __enter__(self) -> "PixelBuffer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def check_bounds(
    z: int, c: int, t: int, x: int, y: int, w: int, h: int,
    size_x: int, size_y: int, size_z: int, size_c: int, size_t: int,
) -> None:
    """Shared coordinate validation for readers."""
    if not (0 <= z < size_z and 0 <= c < size_c and 0 <= t < size_t):
        raise ValueError(
            f"Plane out of range: z={z}/{size_z} c={c}/{size_c} t={t}/{size_t}"
        )
    if x < 0 or y < 0 or w <= 0 or h <= 0 or x + w > size_x or y + h > size_y:
        raise ValueError(
            f"Region out of bounds: x={x} y={y} w={w} h={h} "
            f"plane={size_x}x{size_y}"
        )
