"""Shard assembly and commit for the ingest plane (counterpart of
``omero_ms_pixel_buffer_tpu/ingest/assembler.py``; the bytes it writes
are the JAX package's).

``ShardAssembler`` turns tile writes into whole-object store commits:

1. **Stage.** Each tile is scattered into whole inner chunks. A chunk the
   tile covers in part is first read through the array's decode path, so
   a write never clobbers its neighbours. A multiscale image stages the
   stride-2 subsample of the tile into every pyramid level (the
   downsampling ``write_ngff`` uses), so lower levels agree with the
   written tile.
2. **Commit.** Staged chunks group by store object. An unsharded array
   re-encodes each chunk and puts its key. A ``sharding_indexed`` array
   rebuilds the whole shard: untouched inner chunks carry over byte for
   byte, dirty ones re-encode, and the crc32c-checksummed (offset,
   nbytes) index is rewritten with its absent-chunk sentinels, for both
   ``index_location`` spellings. ``store.put`` publishes each object
   atomically (``FileStore``: write and rename; S3: one PUT or a
   multipart upload).

Fault points: ``ingest.index`` fires before each shard's index rebuild
and ``ingest.commit`` before each publish, so a fault at either aborts
before anything is visible.

``IngestPlane`` wraps the assembler with a lock per image and the
config's bounds. The epoch bump, the purges and the pushes follow the
commit in the HTTP layer.
"""

from __future__ import annotations

import struct
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io.zarr import _SHARD_ABSENT, ZarrError, ZarrPixelBuffer, crc32c
from ..resilience.faultinject import INJECTOR


class IngestError(Exception):
    """A write the ingest plane refuses; ``code`` maps to the HTTP
    status the handler answers with (4xx: the request is the problem,
    not the service)."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


def _writable_store(store) -> bool:
    return hasattr(store, "put")


class ShardAssembler:
    """Stages tile writes for ONE image and commits them as atomic
    whole-object store writes. Instances are single-use and must be
    externally serialized per image (IngestPlane's per-image lock):
    stage_tile() any number of times, then commit() once."""

    def __init__(
        self,
        buffer: ZarrPixelBuffer,
        max_inflight_shards: int = 64,
        staging_bytes: int = 256 << 20,
    ):
        if not isinstance(buffer, ZarrPixelBuffer):
            raise IngestError(
                409, "image is not NGFF/Zarr-backed; ingest supports "
                "Zarr images only"
            )
        if not _writable_store(buffer.store):
            raise IngestError(
                409, f"store {buffer.store.describe()} is read-only"
            )
        self.buffer = buffer
        self.max_inflight_shards = max_inflight_shards
        self.staging_bytes = staging_bytes
        # (level, chunk_idx) -> full staged inner chunk (writable copy)
        self._staged: Dict[Tuple[int, Tuple[int, ...]], np.ndarray] = {}
        self._staged_nbytes = 0
        for lv, arr in enumerate(buffer.levels):
            if arr.chunks[:3] != (1, 1, 1):
                raise IngestError(
                    409, f"level {lv} chunks span t/c/z "
                    f"({arr.chunks}); ingest supports planar "
                    "(1,1,1,cy,cx) chunking only"
                )

    # -- staging --------------------------------------------------------

    def stage_tile(
        self, z: int, c: int, t: int, x: int, y: int, w: int, h: int,
        data: np.ndarray,
    ) -> None:
        """Stage one full-resolution tile write, plus its stride-2
        subsample into every pyramid level. Bounds must already be
        validated against level 0 (the handler's check_bounds)."""
        a0 = self.buffer.levels[0]
        data = np.asarray(data)
        if data.shape != (h, w):
            raise IngestError(
                400, f"tile body is {data.shape}, query says ({h}, {w})"
            )
        self._stage_level(0, z, c, t, x, y, data)
        for lv in range(1, len(self.buffer.levels)):
            arr = self.buffer.levels[lv]
            s = 1 << lv
            # only stride-2 pyramids (write_ngff's shape law:
            # ceil-halving per level) can be kept consistent from the
            # written bytes alone
            want = -(-a0.shape[3] // s), -(-a0.shape[4] // s)
            if (arr.shape[3], arr.shape[4]) != want:
                raise IngestError(
                    409, f"level {lv} is not a stride-2 downsample "
                    f"(shape {arr.shape[3:]} != {want}); ingest "
                    "supports stride-2 pyramids only"
                )
            ys = -(-y // s) * s          # first sampled row >= y
            xs = -(-x // s) * s
            if ys >= y + h or xs >= x + w:
                continue  # tile covers no sample points at this level
            sub = data[ys - y::s, xs - x::s]
            self._stage_level(lv, z, c, t, xs // s, ys // s, sub)

    def _stage_level(
        self, level: int, z: int, c: int, t: int,
        x: int, y: int, data: np.ndarray,
    ) -> None:
        arr = self.buffer.levels[level]
        h, w = data.shape
        cy, cx = arr.chunks[3], arr.chunks[4]
        for iy in range(y // cy, (y + h - 1) // cy + 1):
            for ix in range(x // cx, (x + w - 1) // cx + 1):
                idx = (t, c, z, iy, ix)
                chunk = self._chunk_for_write(level, arr, idx)
                y0, x0 = iy * cy, ix * cx
                lo_y, hi_y = max(y, y0), min(y + h, y0 + cy)
                lo_x, hi_x = max(x, x0), min(x + w, x0 + cx)
                chunk[0, 0, 0, lo_y - y0:hi_y - y0,
                      lo_x - x0:hi_x - x0] = data[
                    lo_y - y:hi_y - y, lo_x - x:hi_x - x
                ]

    def _chunk_for_write(self, level: int, arr, idx) -> np.ndarray:
        key = (level, idx)
        chunk = self._staged.get(key)
        if chunk is not None:
            return chunk
        # read-modify-write: load the chunk's CURRENT bytes through
        # the normal decode path (decoded arrays are frombuffer views
        # — copy for writability); absent chunks start at fill_value
        current = arr.read_chunk(idx)
        chunk = (
            np.full(arr.chunks, arr.fill_value, dtype=arr.dtype)
            if current is None else current.astype(arr.dtype, copy=True)
        )
        nbytes = chunk.nbytes
        if self._staged_nbytes + nbytes > self.staging_bytes:
            raise IngestError(
                413, "staged bytes would exceed ingest.staging-bytes "
                f"({self.staging_bytes}); commit in smaller batches"
            )
        if len(self._objects(extra=(level, idx))) > (
            self.max_inflight_shards
        ):
            raise IngestError(
                413, "write touches more objects than "
                f"ingest.max-inflight-shards ({self.max_inflight_shards})"
            )
        self._staged[key] = chunk
        self._staged_nbytes += nbytes
        return chunk

    def _objects(self, extra=None) -> set:
        """Distinct target store objects the staged set will commit
        (shards for sharded levels, chunk keys otherwise)."""
        out = set()
        items = list(self._staged)
        if extra is not None:
            items.append(extra)
        for level, idx in items:
            arr = self.buffer.levels[level]
            if arr.sharding is None:
                out.add((level, idx))
            else:
                out.add((level, arr._locate_inner(idx)[0]))
        return out

    # -- commit ---------------------------------------------------------

    def commit(self) -> dict:
        """Publish every staged chunk: one atomic ``store.put`` per
        touched object. Returns {objects, chunks, bytes}. A fault
        mid-commit leaves already-published objects new and the rest
        old — each object individually is never torn (the epoch bump
        that follows in the HTTP layer invalidates readers either
        way)."""
        by_object: Dict[Tuple[int, Tuple[int, ...]], dict] = {}
        for (level, idx), chunk in self._staged.items():
            arr = self.buffer.levels[level]
            if arr.sharding is None:
                by_object[(level, idx)] = {None: chunk}
            else:
                shard_idx, linear = arr._locate_inner(idx)
                by_object.setdefault((level, shard_idx), {})[
                    linear
                ] = chunk
        written = 0
        chunks = 0
        for (level, obj_idx), members in sorted(by_object.items()):
            arr = self.buffer.levels[level]
            if arr.sharding is None:
                payload = arr.encode_chunk(members[None])
                chunks += 1
            else:
                payload = self._build_shard(arr, obj_idx, members)
                chunks += len(members)
            INJECTOR.fire("ingest.commit")
            arr.store.put(arr._chunk_key(obj_idx), payload)
            written += len(payload)
        stats = {
            "objects": len(by_object),
            "chunks": chunks,
            "bytes": written,
        }
        self._staged.clear()
        self._staged_nbytes = 0
        return stats

    def _build_shard(
        self, arr, shard_idx: Tuple[int, ...],
        dirty: Dict[int, np.ndarray],
    ) -> bytes:
        """Rebuild one whole shard object: dirty inner chunks
        re-encode, untouched ones carry over byte-for-byte from the
        old object, absent positions keep the sentinel. Offsets in
        the rewritten index are absolute within the object (matching
        the reader), for both ``index_location`` spellings."""
        info = arr.sharding
        key = arr._chunk_key(shard_idx)
        old = arr.store.get(key)
        old_index = None
        if old is not None:
            footer = (
                old[-info.index_nbytes:] if info.index_at_end
                else old[:info.index_nbytes]
            )
            # strict: committing over a corrupt shard would launder
            # the corruption into a "valid" object
            old_index = arr._parse_shard_index(footer, key)
        base = 0 if info.index_at_end else info.index_nbytes
        body = bytearray()
        entries: List[Tuple[int, int]] = []
        INJECTOR.fire("ingest.index")
        for linear in range(info.chunks_per_shard):
            inner = self._inner_from_linear(arr, shard_idx, linear)
            in_bounds = all(
                i * c < s for i, c, s in zip(
                    inner, arr.chunks, arr.shape
                )
            )
            if not in_bounds:
                entries.append((_SHARD_ABSENT, _SHARD_ABSENT))
                continue
            if linear in dirty:
                raw = arr.encode_chunk(dirty[linear])
            elif old_index is not None:
                off = int(old_index[linear, 0])
                nb = int(old_index[linear, 1])
                if off == _SHARD_ABSENT and nb == _SHARD_ABSENT:
                    entries.append((_SHARD_ABSENT, _SHARD_ABSENT))
                    continue
                raw = old[off:off + nb]
                if len(raw) != nb:
                    raise ZarrError(
                        f"Truncated inner chunk in shard {key} "
                        f"(wanted {nb} bytes at {off})"
                    )
            else:
                entries.append((_SHARD_ABSENT, _SHARD_ABSENT))
                continue
            entries.append((base + len(body), len(raw)))
            body += raw
        index = b"".join(
            struct.pack("<QQ", off, nb) for off, nb in entries
        )
        if info.index_crc:
            index += struct.pack("<I", crc32c(index))
        return (
            bytes(body) + index if info.index_at_end
            else index + bytes(body)
        )

    @staticmethod
    def _inner_from_linear(
        arr, shard_idx: Tuple[int, ...], linear: int
    ) -> Tuple[int, ...]:
        """Inverse of ``_locate_inner``: the inner-chunk-grid index at
        C-order position ``linear`` of shard ``shard_idx``."""
        ratio = arr.sharding.ratio
        local = []
        rem = linear
        for r in reversed(ratio):
            local.append(rem % r)
            rem //= r
        local.reverse()
        return tuple(
            s * r + l for s, r, l in zip(shard_idx, ratio, local)
        )


class IngestPlane:
    """Per-process ingest coordinator: per-image write serialization,
    config bounds, and counters. The HTTP layer owns auth, scheduling,
    and the post-commit epoch/invalidation fan-out."""

    def __init__(
        self,
        pixels_service,
        max_inflight_shards: int = 64,
        staging_bytes: int = 256 << 20,
    ):
        self.pixels_service = pixels_service
        self.max_inflight_shards = max_inflight_shards
        self.staging_bytes = staging_bytes
        self._locks: Dict[int, threading.Lock] = {}
        self._locks_guard = threading.Lock()
        self._stats_lock = threading.Lock()
        self._commits = 0
        self._tiles = 0
        self._bytes = 0
        self._failures = 0

    def _image_lock(self, image_id: int) -> threading.Lock:
        with self._locks_guard:
            lock = self._locks.get(image_id)
            if lock is None:
                lock = self._locks[image_id] = threading.Lock()
            return lock

    def write_tiles(
        self,
        image_id: int,
        tiles: List[Tuple[int, int, int, int, int, int, int, bytes]],
        session_key: Optional[str] = None,
    ) -> dict:
        """Stage + commit a batch of tile writes for one image. Each
        tile is (z, c, t, x, y, w, h, raw_bytes) with raw BIG-endian
        pixels of the image's dtype — the same network byte order the
        raw /tile read surface serves (OMERO's RawPixelsStore
        convention), so the bytes a client PUTs are exactly the bytes
        a GET returns. Blocking (store I/O) — the handler runs it on
        a worker thread. Returns commit stats merged with the tile
        count."""
        image_id = int(image_id)
        buffer = self.pixels_service.get_pixel_buffer(
            image_id, session_key=session_key
        )
        if buffer is None:
            raise IngestError(404, f"Cannot find Image:{image_id}")
        lock = self._image_lock(image_id)
        with lock:
            try:
                asm = ShardAssembler(
                    buffer,
                    max_inflight_shards=self.max_inflight_shards,
                    staging_bytes=self.staging_bytes,
                )
                a0 = buffer.levels[0]
                st, sc, sz, sy, sx = a0.shape
                for z, c, t, x, y, w, h, raw in tiles:
                    self._check_tile(
                        z, c, t, x, y, w, h, sx, sy, sz, sc, st
                    )
                    want = w * h * a0.dtype.itemsize
                    if len(raw) != want:
                        raise IngestError(
                            400, f"tile body is {len(raw)} bytes; a "
                            f"{w}x{h} {a0.dtype.name} tile is {want}"
                        )
                    data = np.frombuffer(
                        raw, dtype=a0.dtype.newbyteorder(">")
                    ).reshape(h, w)
                    asm.stage_tile(z, c, t, x, y, w, h, data)
                stats = asm.commit()
            except Exception:
                with self._stats_lock:
                    self._failures += 1
                raise
        with self._stats_lock:
            self._commits += 1
            self._tiles += len(tiles)
            self._bytes += stats["bytes"]
        stats["tiles"] = len(tiles)
        return stats

    @staticmethod
    def _check_tile(z, c, t, x, y, w, h, sx, sy, sz, sc, st) -> None:
        if not (0 <= z < sz and 0 <= c < sc and 0 <= t < st):
            raise IngestError(
                400, f"plane (z={z}, c={c}, t={t}) out of bounds"
            )
        if w <= 0 or h <= 0 or x < 0 or y < 0 or (
            x + w > sx or y + h > sy
        ):
            raise IngestError(
                400, f"tile ({x}, {y}, {w}, {h}) out of bounds "
                f"for {sx}x{sy}"
            )

    def snapshot(self) -> dict:
        with self._stats_lock:
            return {
                "commits": self._commits,
                "tiles": self._tiles,
                "bytes": self._bytes,
                "failures": self._failures,
                "max_inflight_shards": self.max_inflight_shards,
                "staging_bytes": self.staging_bytes,
            }
