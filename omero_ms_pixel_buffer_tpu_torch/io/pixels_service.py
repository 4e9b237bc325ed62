"""Pixels service: imageId -> metadata -> pixel buffer (counterpart of
``ImageRegistry`` and ``PixelsService`` in ``omero_ms_pixel_buffer_tpu/
io/pixels_service.py``, for OME-TIFF, OME-NGFF/Zarr and ROMIO storage).

Registry file shape::

    {"images": [
        {"id": 1, "path": "images/a.ome.tiff", "name": "a"},
        {"id": 2, "path": "images/b.zarr"},
        {"id": 4, "path": "s3://bucket/c.zarr", "type": "zarr"},
        {"id": 3, "path": "images/3", "type": "romio",
         "sizeX": 512, "sizeY": 512, "sizeZ": 1, "sizeC": 1,
         "sizeT": 1, "pixelsType": "uint16"}
    ]}

Relative paths resolve against the registry file's directory;
``s3://``, ``http://`` and ``https://`` URIs stay as they are. An entry
of type ``zarr``, a directory, or a remote URI without a type opens as
OME-NGFF (``io/zarr.py``); a ROMIO entry carries its dimensions (the
plane file has no header); a TIFF carries its own.

The registry may also be ``db/resolver.py``'s ``OmeroImageSource`` (the
OMERO database and ``omero.data.dir``), and a ``metadata_resolver``
(``db/metadata.py``) may answer ``get_pixels`` instead of the buffers: a
resolver whose ``get_pixels`` takes ``session_key`` applies OMERO's ACLs
per caller, and an image the caller may not read resolves as None (404),
as a missing one does.
"""

from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict
from typing import Optional, Tuple

from .jpeg import DeviceIdct
from .ometiff import OmeTiffPixelBuffer
from .pixel_buffer import BlockCache, PixelBuffer, PixelsMeta
from .romio import RomioPixelBuffer
from .zarr import ZarrPixelBuffer

_REMOTE = ("s3://", "http://", "https://")


def _scoped(resolver) -> bool:
    """Whether a resolver's ``get_pixels`` accepts ``session_key`` (it
    applies OMERO's permission model per caller)."""
    import inspect

    try:
        return "session_key" in inspect.signature(resolver.get_pixels).parameters
    except (AttributeError, TypeError, ValueError):
        return False


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
        if p.startswith(_REMOTE):
            return p  # a remote store URI, never registry-relative
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
    buffers sharing one decoded-block cache of TIFF blocks and Zarr
    chunks. ``memo_dir`` (the YAML ``omero.server``
    ``omero.pixeldata.memoizer.dir``; else ``OMPB_MEMO_DIR``) keeps parsed
    TIFF IFD chains across restarts. ``device`` is where JPEG blocks'
    device IDCT runs when ``OMPB_JPEG_DEVICE_IDCT=1`` (default ``cuda``;
    ``idct`` counts it)."""

    def __init__(self, registry, max_open: int = 128,
                 block_cache_bytes: int = 256 << 20, device="cuda",
                 metadata_resolver=None, memo_dir: Optional[str] = None):
        self.registry = registry
        self.max_open = max_open
        self.memo_dir = memo_dir
        # a permission-aware registry (``OmeroImageSource``) is the
        # metadata plane itself: request lookups go through its scoped
        # surface, so a bare PixelsService over it never bypasses ACLs
        if metadata_resolver is None and _scoped(registry):
            metadata_resolver = registry
        self.metadata_resolver = metadata_resolver
        self._resolver_scoped = metadata_resolver is not None and _scoped(metadata_resolver)
        self.block_cache = BlockCache(block_cache_bytes)
        self.idct = DeviceIdct(device)
        self._cache: "OrderedDict[int, PixelBuffer]" = OrderedDict()
        self._lock = threading.Lock()

    def get_pixels(self, image_id: int, session_key: Optional[str] = None
                   ) -> Optional[PixelsMeta]:
        """Metadata row; None when the image is unknown or, under a
        scoped resolver, not readable by ``session_key`` (-> 404). Without
        a resolver a ROMIO row comes from the registry without opening the
        file, any other from the (cached) buffer."""
        if self.metadata_resolver is not None:
            if self._resolver_scoped:
                return self.metadata_resolver.get_pixels(image_id, session_key=session_key)
            return self.metadata_resolver.get_pixels(image_id)
        entry = self.registry.entry(image_id)
        if entry is None:
            return None
        if entry.get("type") == "romio":
            return self._romio_meta(image_id, entry)
        buf = self.get_pixel_buffer(image_id)
        return None if buf is None else buf.meta

    def _romio_meta(self, image_id: int, entry: dict) -> PixelsMeta:
        if isinstance(self.registry, ImageRegistry):
            return self.registry.romio_meta(image_id, entry)
        # a database source: the pixels row carries the dimensions
        return self.registry.get_pixels(image_id)

    def _open(self, image_id: int, entry: dict) -> PixelBuffer:
        path = self.registry.resolve_path(entry)
        kind = entry.get("type")
        name = entry.get("name", os.path.basename(path))
        if kind == "romio":
            return RomioPixelBuffer(path, self._romio_meta(image_id, entry))
        if kind == "zarr" or (kind is None and (path.startswith(_REMOTE) or os.path.isdir(path))):
            return ZarrPixelBuffer(path, image_id=image_id, image_name=name,
                                   block_cache=self.block_cache)
        if kind not in (None, "ometiff", "tiff"):
            raise ValueError(f"Unknown image type: {kind}")
        return OmeTiffPixelBuffer(path, image_id=image_id, image_name=name,
                                  block_cache=self.block_cache, memo_dir=self.memo_dir,
                                  device_idct=self.idct)

    def get_pixel_buffer(self, image_id: int, session_key: Optional[str] = None
                         ) -> Optional[PixelBuffer]:
        """The open buffer of ``image_id``; None when it is unknown. With
        ``session_key`` and a scoped resolver the caller's ACL is checked
        first (None when it may not read the image); without a key no
        check is made, so every request path calls ``get_pixels`` with
        its key first (``TilePipeline.resolve`` does)."""
        image_id = int(image_id)
        if session_key is not None and self._resolver_scoped:
            if self.metadata_resolver.get_pixels(image_id, session_key=session_key) is None:
                return None
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

    def peek_extent(self, image_id: int, resolution=None) -> Optional[Tuple[int, int]]:
        """(size_x, size_y) at ``resolution`` from the open-buffer cache
        alone: never opens a buffer, never blocks on I/O. None when the
        image has no open buffer or the level is out of range."""
        with self._lock:
            buf = self._cache.get(int(image_id))
        if buf is None:
            return None
        try:
            level = 0 if resolution is None else int(resolution)
            if not 0 <= level < buf.resolution_levels:
                return None
            return buf.level_size(level)
        except Exception:
            return None

    def invalidate(self, image_id: int) -> Optional[int]:
        """Drop the image's open buffer (a changed ``pixels`` row makes
        its parsed structure stale) and its memoized shard indexes; the
        buffer is not closed, since reads may still hold it. Returns its
        block and plane cache namespace, or None when none was open."""
        with self._lock:
            buf = self._cache.pop(int(image_id), None)
        if buf is None:
            return None
        purge = getattr(buf, "purge_shard_indexes", None)
        if purge is not None:
            try:
                purge()
            except Exception:
                pass  # invalidation never fails its caller
        return getattr(buf, "cache_ns", None)

    def note_epoch(self, image_id: int, epoch: Optional[int]) -> None:
        """Stamp an image epoch onto the open buffer's shard-index memo
        without dropping the buffer: reads that still hold it miss their
        next footer lookup instead of serving old offsets."""
        with self._lock:
            buf = self._cache.get(int(image_id))
        note = getattr(buf, "note_epoch", None)
        if note is not None:
            try:
                note(epoch)
            except Exception:
                pass  # invalidation never fails its caller

    def close(self) -> None:
        with self._lock:
            for buf in self._cache.values():
                buf.close()
            self._cache.clear()
