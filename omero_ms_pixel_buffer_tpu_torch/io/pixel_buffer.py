"""The pixel-buffer contract (counterpart of ``omero_ms_pixel_buffer_tpu/
io/pixel_buffer.py``): the ``Pixels`` metadata row, a random-access
reader with explicit resolution levels, and a decoded-block LRU."""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import OrderedDict
from typing import Any, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.convert import dtype_for

# monotonic namespace ids: buffers sharing one BlockCache never alias
_cache_namespace = itertools.count(1).__next__

_MISSING = object()

# An absent chunk (Zarr fill_value) is an answer worth remembering, but a
# writer may backfill it: negatives expire after a process-wide TTL (the
# JAX package's ``io.negative-ttl-s`` default; 0 keeps them for good;
# ``set_negative_ttl`` applies the YAML key) and charge a nominal size,
# so a sea of fill_value cannot grow the entry count without bound.
NEGATIVE_TTL_S = 300.0
_NEGATIVE_ENTRY_BYTES = 64


def set_negative_ttl(seconds: float) -> None:
    """The process-wide TTL of cached absent chunks (``io.negative-ttl-s``)."""
    global NEGATIVE_TTL_S
    NEGATIVE_TTL_S = float(seconds)


class _Negative:
    """A cached absence with its expiry stamp."""

    __slots__ = ("expires_at",)

    def __init__(self, expires_at: Optional[float]):
        self.expires_at = expires_at

    def expired(self) -> bool:
        return self.expires_at is not None and time.monotonic() >= self.expires_at


class BlockCache:
    """Byte-bounded, thread-safe LRU of decoded storage blocks (the JAX
    package's ``BlockCache``): a compressed block or chunk is inflated
    once and every later tile that overlaps it assembles from the cached
    array. A value of None is a legitimately absent chunk (Zarr
    fill_value), kept as a TTL-bounded negative; ``purge_ns`` drops a
    buffer's entries. ``max_bytes`` <= 0 keeps nothing."""

    def __init__(self, max_bytes: int = 256 << 20):
        self.max_bytes = max_bytes
        self._entries: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    @staticmethod
    def _size(value: Any) -> int:
        if isinstance(value, np.ndarray):
            return int(value.nbytes)
        if isinstance(value, _Negative):
            return _NEGATIVE_ENTRY_BYTES
        return 0

    def get(self, key: Hashable, default: Any = None) -> Any:
        """The cached array, None for a live negative, else ``default``."""
        with self._lock:
            value = self._entries.get(key, _MISSING)
            if isinstance(value, _Negative):
                if value.expired():
                    # the chunk may exist by now: ask the store again
                    self._entries.pop(key)
                    self._bytes -= _NEGATIVE_ENTRY_BYTES
                    value = _MISSING
                else:
                    value = None
            if value is _MISSING:
                return default
            self._entries.move_to_end(key)
            return value

    def __setitem__(self, key: Hashable, value: Any) -> None:
        if self.max_bytes <= 0:
            return
        if value is None:
            value = _Negative(time.monotonic() + NEGATIVE_TTL_S if NEGATIVE_TTL_S > 0 else None)
        size = self._size(value)
        if size > self.max_bytes:
            return  # one oversized block would evict everything
        with self._lock:
            old = self._entries.pop(key, _MISSING)
            if old is not _MISSING:
                self._bytes -= self._size(old)
            self._entries[key] = value
            self._bytes += size
            while self._bytes > self.max_bytes and self._entries:
                _, evicted = self._entries.popitem(last=False)
                self._bytes -= self._size(evicted)

    def purge_ns(self, cache_ns) -> int:
        """Drop every entry whose tuple key leads with ``cache_ns`` (its
        decoded blocks and its negatives); returns how many."""
        dropped = 0
        with self._lock:
            for key in [k for k in self._entries
                        if isinstance(k, tuple) and k and k[0] == cache_ns]:
                self._bytes -= self._size(self._entries.pop(key))
                dropped += 1
        return dropped


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
    # the image's Format enum value and its ExternalInfo row, where the
    # OMERO database has them (``db/metadata.py``)
    image_format: Optional[str] = None
    external_info: Optional[dict] = None

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
