"""imageId → on-disk storage path from the OMERO database + data dir (a
copy of ``omero_ms_pixel_buffer_tpu/db/resolver.py``, the PyTorch port's
own: it imports nothing of the JAX package).

The reference resolves a ``Pixels`` row to its file automatically via
``ome.services.OmeroFilePathResolver`` — constructed from
``${omero.data.dir}`` + SQL in
the reference's beanRefContext.xml:14-17 and used
inside ``ZarrPixelsService.getPixelBuffer``
(TileRequestHandler.java:201-211). This module is that resolver,
native: a deployment configured with only ``omero.db.uri`` +
``omero.data.dir`` serves tiles with no hand-written JSON registry.

OMERO's storage layouts, as the resolver walks them:

1. **FS imports (OMERO 5+)**: the image's fileset links original-file
   rows carrying ``(path, name, repo)``. ``repo`` non-null means the
   file lives under the managed repository — whose root is itself an
   ``originalfile`` row (``mimetype='Repository'``, ``hash`` = the
   repo uuid); when that row is absent/unreadable the conventional
   ``${omero.data.dir}/ManagedRepository`` is used. ``repo`` null is
   the pre-FS "legacy" layout: ``${omero.data.dir}/<path><name>``.
2. **Generated pyramids**: ``<pixels path>_pyramid`` next to the ROMIO
   location (OMERO writes these as tiled TIFFs; the in-tree OME-TIFF
   reader serves them).
3. **Pre-FS ROMIO plane files**:
   ``${omero.data.dir}/Pixels[/Dir-xxx]*/<pixelsId>`` with the
   thousands fan-out of ``ome.io.nio.AbstractFileSystemService``
   (``Dir-%03d`` per thousand-order digit group).

Reader choice is by what's on disk, like the reference's
ZarrPixelsService→PixelsService backend dispatch (beanRefContext.xml:51
alias chain): an NGFF hierarchy (``.zarr`` directory or zarr metadata
files) → the Zarr buffer; a TIFF file → the OME-TIFF buffer; a bare
plane file → ROMIO with dimensions from the metadata plane.

Resolved entries cache with a TTL; misses are never negatively cached
(an image mid-import must appear on the next request, mirroring
db/metadata.py's policy).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import List, Optional, Tuple

from ..io.pixel_buffer import PixelsMeta
from .metadata import OmeroPostgresMetadataResolver

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.db.resolver")

# The fileset's original files for an image: the rows
# OmeroFilePathResolver's SQL reads (name/path/repo per entry).
FILESET_FILES_QUERY = (
    "SELECT o.path, o.name, o.repo, p.id "
    "FROM pixels p "
    "JOIN image i ON p.image = i.id "
    "JOIN filesetentry fse ON fse.fileset = i.fileset "
    "JOIN originalfile o ON fse.originalfile = o.id "
    "WHERE i.id = $1 "
    "ORDER BY fse.id"
)

# Pre-FS images have no fileset; the pixels id alone locates the ROMIO
# plane file / generated pyramid.
PIXELS_ID_QUERY = (
    "SELECT p.id FROM pixels p WHERE p.image = $1 ORDER BY p.id"
)

# The managed repository root is itself an originalfile row.
REPO_ROOT_QUERY = (
    "SELECT path, name FROM originalfile "
    "WHERE mimetype = 'Repository' AND hash = $1"
)

_ZARR_MARKERS = (".zgroup", ".zattrs", "zarr.json")

# Extensions that are TIFF containers the in-tree reader opens
# directly (classic, OME, BigTIFF, Aperio SVS — plain tiled TIFF with
# JPEG/deflate pages). Other FS-import formats (.czi/.ndpi/...) serve
# via their generated pyramid instead.
_TIFF_SUFFIXES = (
    ".tif", ".tiff", ".svs", ".btf", ".tf2", ".tf8",
)


def pixels_fanout_path(data_dir: str, pixels_id: int) -> str:
    """``${data.dir}/Pixels[/Dir-xxx]*/<id>`` — the thousands fan-out
    of ``ome.io.nio.AbstractFileSystemService.getPath`` (each division
    by 1000 prepends a ``Dir-%03d`` level)."""
    suffix = ""
    remaining = int(pixels_id)
    while remaining > 999:
        remaining //= 1000
        suffix = os.sep + f"Dir-{remaining % 1000:03d}" + suffix
    return os.path.join(data_dir, "Pixels" + suffix, str(pixels_id))


def _is_ngff(path: str) -> bool:
    if not os.path.isdir(path):
        return False
    if path.rstrip(os.sep).endswith(".zarr"):
        return True
    return any(
        os.path.exists(os.path.join(path, m)) for m in _ZARR_MARKERS
    )


class OmeroImageSource:
    """The registry surface (``entry`` / ``resolve_path`` /
    ``get_pixels``) of ``io.pixels_service``, answered from the OMERO
    database instead of a JSON file. Wire it as::

        src = OmeroImageSource(uri, data_dir)
        PixelsService(src, metadata_resolver=src.metadata)

    (``PixelsService(src)`` alone is also safe — the service detects
    the scoped ``get_pixels`` and routes request-derived metadata
    lookups through it, so ACL enforcement on ``src.metadata`` is
    never bypassed.)

    The metadata plane (dimensions/type, the HQL contract) rides the
    same connection via the embedded ``OmeroPostgresMetadataResolver``;
    pass one in to share a connection the app already holds."""

    def __init__(
        self,
        uri: str,
        data_dir: str,
        metadata: Optional[OmeroPostgresMetadataResolver] = None,
        cache_ttl_s: float = 300.0,
        cache_max: int = 4096,
        enforce_permissions: bool = True,
    ):
        self.data_dir = data_dir
        # secure by default: a source constructed standalone enforces
        # OMERO's ACLs on scoped lookups (callers passing a resolver
        # they built choose its enforcement themselves)
        self.metadata = metadata or OmeroPostgresMetadataResolver(
            uri, enforce_permissions=enforce_permissions
        )
        self._owns_metadata = metadata is None
        self._cache_ttl_s = cache_ttl_s
        self._cache_max = cache_max
        self._cache: dict = {}  # image_id -> (expires_at, entry)
        self._repo_roots: dict = {}  # repo uuid -> root dir
        self._lock = threading.Lock()
        # a changed pixels row also means the storage path may have
        # moved (re-import, regenerated pyramid): drop the resolved
        # entry so the next request re-walks the fileset
        if hasattr(self.metadata, "add_invalidation_listener"):
            self.metadata.add_invalidation_listener(self.invalidate)

    def invalidate(self, image_id: int) -> None:
        """Forget the resolved storage entry for one image (the
        metadata plane's invalidation listener)."""
        with self._lock:
            self._cache.pop(int(image_id), None)

    # -- registry surface -------------------------------------------------

    def entry(self, image_id: int) -> Optional[dict]:
        image_id = int(image_id)
        with self._lock:
            hit = self._cache.get(image_id)
            if hit is not None and hit[0] > time.monotonic():
                return hit[1]
        entry = self._resolve(image_id)
        if entry is not None:
            with self._lock:
                if len(self._cache) >= self._cache_max:
                    self._cache.clear()  # coarse but bounded
                self._cache[image_id] = (
                    time.monotonic() + self._cache_ttl_s, entry
                )
        return entry

    def resolve_path(self, entry: dict) -> str:
        return entry["path"]  # entries always carry absolute paths

    def get_pixels(
        self, image_id: int, session_key: Optional[str] = None
    ) -> Optional[PixelsMeta]:
        # the DB is authoritative for dimensions/type (the HQL plane);
        # ROMIO buffers need this since the plane file carries no
        # header. A keyless call is the buffer plane's internal dims
        # lookup (authorization already happened at resolve time);
        # a keyed call applies the full ACL.
        if session_key is None:
            return self.metadata.get_pixels_unchecked(image_id)
        return self.metadata.get_pixels(
            image_id, session_key=session_key
        )

    def close_sync(self) -> None:
        if self._owns_metadata:
            self.metadata.close_sync()

    # -- resolution -------------------------------------------------------

    def _resolve(self, image_id: int) -> Optional[dict]:
        rows = self.metadata.query(FILESET_FILES_QUERY, [str(image_id)])
        candidates = [
            self._fileset_file(path, name, repo)
            for path, name, repo, _pid in rows
        ]
        existing = [p for p in candidates if p and os.path.exists(p)]
        # 1. NGFF hierarchy (the ZarrPixelsService branch)
        for p in existing:
            if _is_ngff(p):
                return self._entry(image_id, p, "zarr")
            # the fileset may point at files INSIDE the hierarchy
            # (OMERO lists every member file); walk up to the .zarr root
            parent = p
            for _ in range(8):
                parent = os.path.dirname(parent)
                if parent.endswith(".zarr") and _is_ngff(parent):
                    return self._entry(image_id, parent, "zarr")
                if not parent or parent == os.sep:
                    break
        # 2. TIFF original file (the Bio-Formats branch) — only
        # TIFF-container suffixes the in-tree reader can open
        # (canonical OME-TIFF first, then plain/BigTIFF/Aperio). A
        # fileset whose files exist but are NOT TIFF containers
        # (.czi/.ndpi/...) falls through to the generated-pyramid
        # lookup below: OMERO writes a <pixelsId>_pyramid tiled TIFF
        # for originals its renderer can't stream, and that — not the
        # unreadable original — is what serves (previously
        # ANY existing fileset file was handed to the TIFF reader and
        # the open errored).
        tiffs = sorted(
            (
                p for p in existing
                if os.path.isfile(p)
                and p.lower().endswith(_TIFF_SUFFIXES)
            ),
            key=lambda p: not p.lower().endswith(
                (".ome.tif", ".ome.tiff", ".ome.btf")
            ),
        )
        if tiffs:
            return self._entry(image_id, tiffs[0], "ometiff")
        # 3. legacy layouts keyed by pixels id
        pixels_id = (
            int(rows[0][3]) if rows else self._pixels_id(image_id)
        )
        if pixels_id is None:
            return None  # -> 404 "Cannot find Image:<id>"
        romio = pixels_fanout_path(self.data_dir, pixels_id)
        pyramid = romio + "_pyramid"
        if os.path.isfile(pyramid):
            return self._entry(image_id, pyramid, "ometiff")
        if os.path.isfile(romio):
            return self._entry(image_id, romio, "romio")
        if existing:
            log.warning(
                "image %d: %d fileset file(s) on disk but none "
                "readable (non-TIFF originals, no generated pyramid "
                "at %s) — import may still be processing",
                image_id, len(existing), pyramid,
            )
        elif candidates:
            log.warning(
                "image %d: %d fileset file(s) in the DB but none on "
                "disk under %s (first: %s)",
                image_id, len(candidates), self.data_dir,
                candidates[0],
            )
        return None

    def _pixels_id(self, image_id: int) -> Optional[int]:
        rows = self.metadata.query(PIXELS_ID_QUERY, [str(image_id)])
        return int(rows[0][0]) if rows else None

    def _fileset_file(
        self, path: Optional[str], name: Optional[str],
        repo: Optional[str],
    ) -> Optional[str]:
        if name is None:
            return None
        rel = os.path.join(path or "", name)
        root = self._repo_root(repo) if repo else self.data_dir
        full = os.path.normpath(os.path.join(root, rel))
        return full

    def _repo_root(self, repo_uuid: str) -> str:
        with self._lock:
            cached = self._repo_roots.get(repo_uuid)
        if cached is not None:
            return cached
        root = os.path.join(self.data_dir, "ManagedRepository")
        try:
            rows = self.metadata.query(REPO_ROOT_QUERY, [repo_uuid])
            if rows:
                path, name = rows[0]
                joined = os.path.join(path or "", name or "")
                if joined:
                    root = (
                        joined
                        if os.path.isabs(joined)
                        and os.path.isdir(joined)
                        else os.path.join(self.data_dir, joined)
                    )
        except Exception:
            log.debug(
                "repo root lookup failed for %s; using %s",
                repo_uuid, root, exc_info=True,
            )
        with self._lock:
            self._repo_roots[repo_uuid] = root
        return root

    def _entry(self, image_id: int, path: str, kind: str) -> dict:
        return {"id": image_id, "path": path, "type": kind}
