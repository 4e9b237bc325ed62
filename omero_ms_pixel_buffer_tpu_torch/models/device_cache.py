"""GPU-resident plane cache (counterpart of ``omero_ms_pixel_buffer_tpu/
models/device_cache.py``).

The first tiles of a plane read from disk; on the plane's
``admit_after``-th touch (default 2) the whole decoded plane is staged
into device memory, and every later tile on it is a batched gather on
the device, so no tile bytes cross from the host. Planes evict LRU by a
byte budget; one thread stages a given plane at a time (followers take
the host-read path meanwhile).

Planes are held as their bit patterns (uint8 or int16, see
``ops/convert``). ``crop_batch`` clamps each start into the plane, as
``lax.dynamic_slice`` does; the pipeline only sends lanes whose bucket
fits, so the clamp never moves a real lane.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import torch

from ..ops.convert import bits_tensor


class DevicePlaneCache:
    """LRU of device-resident (buffer, level, z, c, t) planes."""

    def __init__(self, device: torch.device, max_bytes: int = 4 << 30,
                 admit_after: int = 2):
        self.device = device
        self.max_bytes = max_bytes
        self.admit_after = admit_after
        self._planes: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
        self._touches: "OrderedDict[tuple, int]" = OrderedDict()
        self._staging: set = set()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get_plane(self, buffer, level: int, z: int, c: int, t: int
                  ) -> Optional[torch.Tensor]:
        """The device tensor of a whole plane, staged once the admission
        threshold is met; None while not resident (caller reads from
        the host)."""
        key = (buffer.cache_ns, level, z, c, t)
        with self._lock:
            plane = self._planes.get(key)
            if plane is not None:
                self._planes.move_to_end(key)
                self.hits += 1
                return plane
            self.misses += 1
            touches = self._touches.pop(key, 0) + 1
            if touches < self.admit_after:
                self._touches[key] = touches
                while len(self._touches) > 4096:
                    self._touches.popitem(last=False)
                return None
            if key in self._staging:
                return None  # single-flight: another thread stages it
            self._staging.add(key)
        plane = None
        try:
            size_x, size_y = buffer.level_size(level)
            nbytes = size_x * size_y * buffer.meta.bytes_per_pixel
            if self.max_bytes <= 0 or nbytes > self.max_bytes:
                return None
            # the batched reader inflates the plane's blocks in parallel
            host = buffer.read_tiles([(z, c, t, 0, 0, size_x, size_y)], level)[0]
            plane = bits_tensor(host).to(self.device)
            if self.device.type == "cuda":
                # complete before any other stream crops from it
                torch.cuda.current_stream(self.device).synchronize()
        finally:
            with self._lock:
                self._staging.discard(key)
                if plane is not None and key not in self._planes:
                    self._planes[key] = plane
                    self._bytes += plane.numel() * plane.element_size()
                    while self._bytes > self.max_bytes and len(self._planes) > 1:
                        _, evicted = self._planes.popitem(last=False)
                        self._bytes -= evicted.numel() * evicted.element_size()
        return plane

    @staticmethod
    def crop_batch(plane: torch.Tensor, coords: Sequence[Tuple[int, int]],
                   bh: int, bw: int) -> torch.Tensor:
        """(N, bh, bw) crops at the (y, x) starts, gathered on the
        plane's device in the current stream. Starts clamp into the
        plane like ``lax.dynamic_slice``."""
        H, W = plane.shape
        if bh > H or bw > W:
            raise ValueError(f"crop {bh}x{bw} larger than plane {H}x{W}")
        dev = plane.device
        if dev.type == "cuda":
            # the plane may be evicted while this stream still reads it
            plane.record_stream(torch.cuda.current_stream(dev))
        starts = torch.tensor(coords, dtype=torch.int64).reshape(-1, 2)
        # non-blocking: a pageable copy stages at once, no stream sync
        ys = starts[:, 0].clamp(0, H - bh).to(dev, non_blocking=True)
        xs = starts[:, 1].clamp(0, W - bw).to(dev, non_blocking=True)
        rows = ys[:, None] + torch.arange(bh, device=dev)
        cols = xs[:, None] + torch.arange(bw, device=dev)
        return plane[rows[:, :, None], cols[:, None, :]]

    def snapshot(self) -> dict:
        """/healthz view of the plane tier."""
        with self._lock:
            return {
                "planes": len(self._planes),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._planes)
