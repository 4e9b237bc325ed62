"""Pixels service: imageId -> metadata -> pixel buffer (counterpart of
``ImageRegistry`` and ``PixelsService`` in ``omero_ms_pixel_buffer_tpu/
io/pixels_service.py``, OME-TIFF only).

Registry file shape::

    {"images": [{"id": 1, "path": "images/a.ome.tiff", "name": "a"}]}

Relative paths resolve against the registry file's directory.
"""

from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict
from typing import Optional

from .ometiff import OmeTiffPixelBuffer
from .pixel_buffer import BlockCache, PixelBuffer, PixelsMeta


class ImageRegistry:
    """Filesystem metadata plane: image ids -> OME-TIFF paths."""

    def __init__(self, registry_path: Optional[str] = None):
        self._images: dict = {}
        self._root = "."
        if registry_path:
            self._root = os.path.dirname(os.path.abspath(registry_path))
            with open(registry_path) as f:
                doc = json.load(f)
            for img in doc.get("images", []):
                self._images[int(img["id"])] = img

    def add(self, image_id: int, path: str, **extra) -> None:
        self._images[int(image_id)] = {"id": int(image_id), "path": path, **extra}

    def entry(self, image_id: int) -> Optional[dict]:
        return self._images.get(int(image_id))

    def resolve_path(self, entry: dict) -> str:
        p = entry["path"]
        return p if os.path.isabs(p) else os.path.join(self._root, p)


class PixelsService:
    """Image id -> open, cached pixel buffer (LRU of ``max_open``), all
    buffers sharing one decoded-block cache."""

    def __init__(self, registry: ImageRegistry, max_open: int = 128,
                 block_cache_bytes: int = 256 << 20):
        self.registry = registry
        self.max_open = max_open
        self.block_cache = BlockCache(block_cache_bytes)
        self._cache: "OrderedDict[int, PixelBuffer]" = OrderedDict()
        self._lock = threading.Lock()

    def get_pixels(self, image_id: int) -> Optional[PixelsMeta]:
        """Metadata row; None when the image is unknown (-> 404)."""
        buf = self.get_pixel_buffer(image_id)
        return None if buf is None else buf.meta

    def get_pixel_buffer(self, image_id: int) -> Optional[PixelBuffer]:
        image_id = int(image_id)
        with self._lock:
            buf = self._cache.get(image_id)
            if buf is not None:
                self._cache.move_to_end(image_id)
                return buf
        entry = self.registry.entry(image_id)
        if entry is None:
            return None
        kind = entry.get("type")
        if kind not in (None, "ometiff", "tiff"):
            raise ValueError(f"Unsupported image type: {kind}")
        path = self.registry.resolve_path(entry)
        buf = OmeTiffPixelBuffer(
            path, image_id=image_id,
            image_name=entry.get("name", os.path.basename(path)),
            block_cache=self.block_cache,
        )
        with self._lock:
            existing = self._cache.get(image_id)
            if existing is not None:
                buf.close()
                self._cache.move_to_end(image_id)
                return existing
            self._cache[image_id] = buf
            while len(self._cache) > self.max_open:
                # dropped, not closed: concurrent reads may still hold it
                self._cache.popitem(last=False)
        return buf

    def close(self) -> None:
        with self._lock:
            for buf in self._cache.values():
                buf.close()
            self._cache.clear()
