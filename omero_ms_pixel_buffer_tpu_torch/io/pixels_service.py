"""Pixels service: imageId -> metadata -> pixel buffer (counterpart of
``ImageRegistry`` and ``PixelsService`` in ``omero_ms_pixel_buffer_tpu/
io/pixels_service.py``, for OME-TIFF and ROMIO storage).

Registry file shape::

    {"images": [
        {"id": 1, "path": "images/a.ome.tiff", "name": "a"},
        {"id": 3, "path": "images/3", "type": "romio",
         "sizeX": 512, "sizeY": 512, "sizeZ": 1, "sizeC": 1,
         "sizeT": 1, "pixelsType": "uint16"}
    ]}

Relative paths resolve against the registry file's directory. A ROMIO
entry carries its dimensions (the plane file has no header); a TIFF
carries its own.
"""

from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict
from typing import Optional

from .jpeg import DeviceIdct
from .ometiff import OmeTiffPixelBuffer
from .pixel_buffer import BlockCache, PixelBuffer, PixelsMeta
from .romio import RomioPixelBuffer


class ImageRegistry:
    """Filesystem metadata plane: image ids -> storage paths (and, for
    ROMIO, explicit dimensions)."""

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

    def romio_meta(self, image_id: int, entry: dict) -> PixelsMeta:
        """The ``Pixels`` row of a ROMIO entry, from the registry."""
        return PixelsMeta(
            image_id=int(image_id),
            size_x=int(entry["sizeX"]), size_y=int(entry["sizeY"]),
            size_z=int(entry.get("sizeZ", 1)), size_c=int(entry.get("sizeC", 1)),
            size_t=int(entry.get("sizeT", 1)), pixels_type=entry["pixelsType"],
            image_name=entry.get("name", str(image_id)),
        )


class PixelsService:
    """Image id -> open, cached pixel buffer (LRU of ``max_open``), all
    buffers sharing one decoded-block cache (``OMPB_MEMO_DIR`` keeps
    parsed TIFF IFD chains across restarts). ``device`` is where JPEG
    blocks' device IDCT runs when ``OMPB_JPEG_DEVICE_IDCT=1`` (default
    ``cuda``; ``idct`` counts it)."""

    def __init__(self, registry: ImageRegistry, max_open: int = 128,
                 block_cache_bytes: int = 256 << 20, device="cuda"):
        self.registry = registry
        self.max_open = max_open
        self.block_cache = BlockCache(block_cache_bytes)
        self.idct = DeviceIdct(device)
        self._cache: "OrderedDict[int, PixelBuffer]" = OrderedDict()
        self._lock = threading.Lock()

    def get_pixels(self, image_id: int) -> Optional[PixelsMeta]:
        """Metadata row; None when the image is unknown (-> 404). A ROMIO
        row comes from the registry without opening the file."""
        entry = self.registry.entry(image_id)
        if entry is None:
            return None
        if entry.get("type") == "romio":
            return self.registry.romio_meta(image_id, entry)
        buf = self.get_pixel_buffer(image_id)
        return None if buf is None else buf.meta

    def _open(self, image_id: int, entry: dict) -> PixelBuffer:
        path = self.registry.resolve_path(entry)
        kind = entry.get("type")
        if kind == "romio":
            return RomioPixelBuffer(path, self.registry.romio_meta(image_id, entry))
        if kind not in (None, "ometiff", "tiff"):
            raise ValueError(f"Unknown image type: {kind}")
        return OmeTiffPixelBuffer(
            path, image_id=image_id, image_name=entry.get("name", os.path.basename(path)),
            block_cache=self.block_cache, device_idct=self.idct,
        )

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
        buf = self._open(image_id, entry)
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
