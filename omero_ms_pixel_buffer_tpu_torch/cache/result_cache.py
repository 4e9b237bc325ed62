"""The tile result cache (counterpart of
``omero_ms_pixel_buffer_tpu/cache/result_cache.py``): content ETags,
``If-None-Match`` matching, a byte-budgeted segmented-LRU memory tier of
encoded tiles with the optional TinyLFU admission gate (``cache/plane/
tinylfu.py``: every get and put is recorded, and at eviction a candidate
displaces the probation victim only when its estimated frequency is at
least the victim's), and the optional disk tier.

Disk tier (``disk_dir``): entries evicted from memory are written
``<sha1>.tile`` (tmp + rename) on a one-thread I/O executor; a disk hit
re-admits to memory. With ``manifest`` (default) admissions and
evictions are journaled (``cache/plane/manifest.py``) and replayed at
start-up, so a restart begins warm; without it leftover files are swept.
The tier sits behind its own breaker (``cache:disk``) and fault point
(``cache.disk``): repeated I/O errors open the breaker and the tier drops
out. A broken cache never fails a request: every ``get`` and ``put``
catches, counts, and degrades to pass-through.

Lookups, stores, evictions and invalidations go to ``/metrics`` under the
JAX names (``tile_cache_*``). The cluster coordinator's enumerations
(``hot_entries``, ``warm_keys``) belong to the fleet plane and are not
ported.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import hashlib
import logging
import os
import threading
import time
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..resilience.breaker import BreakerOpenError, for_dependency
from ..resilience.faultinject import INJECTOR
from ..resilience.timeouts import io_timeout_s
from ..utils.metrics import REGISTRY

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.cache")

# the JAX package's cache defaults (cache: memory-mb, protected-fraction,
# max-entry-kb, disk-mb); the front takes them, and max-age-s, from its
# config
MEMORY_BYTES = 256 << 20
PROTECTED_FRACTION = 0.8
MAX_ENTRY_BYTES = 4096 << 10
DISK_BYTES = 1 << 30

CACHE_REQUESTS = REGISTRY.counter(
    "tile_cache_requests_total",
    "Result-cache lookups by tier and outcome",
)
CACHE_STORES = REGISTRY.counter(
    "tile_cache_stores_total", "Entries admitted, by tier"
)
CACHE_EVICTIONS = REGISTRY.counter(
    "tile_cache_evictions_total", "Entries evicted, by tier"
)
CACHE_ERRORS = REGISTRY.counter(
    "tile_cache_errors_total",
    "Cache operations that degraded to pass-through, by tier",
)
CACHE_INVALIDATIONS = REGISTRY.counter(
    "tile_cache_invalidations_total",
    "Entries purged by image invalidation",
)

# one process-wide bytes gauge over every live cache: the registry never
# unregisters, so a gauge per cache would pin a closed cache's contents
_LIVE_CACHES: "weakref.WeakSet" = weakref.WeakSet()


def _bytes_by_tier() -> Dict[tuple, float]:
    caches = list(_LIVE_CACHES)
    out = {(("tier", "memory"),): float(sum(c.memory.nbytes for c in caches))}
    disk = [c.disk.nbytes for c in caches if c.disk is not None]
    if disk:
        out[(("tier", "disk"),)] = float(sum(disk))
    return out


CACHE_BYTES = REGISTRY.gauge_fn(
    "tile_cache_bytes", "Live bytes held per cache tier",
    _bytes_by_tier,
)


def make_etag(body: bytes) -> str:
    """Strong content ETag: a quoted 16-byte blake2b digest of the encoded
    bytes, so identical bytes get identical validators everywhere."""
    return '"' + hashlib.blake2b(body, digest_size=16).hexdigest() + '"'


def etag_matches(if_none_match: str, etag: str) -> bool:
    """If-None-Match comparison: comma-separated validators, a ``W/``
    prefix still matches. ``*`` is deliberately not honoured: only a
    matching content ETag proves the client holds these exact bytes."""
    if not if_none_match:
        return False
    for candidate in if_none_match.split(","):
        candidate = candidate.strip()
        if candidate.startswith("W/"):
            candidate = candidate[2:]
        if candidate == etag:
            return True
    return False


class CachedTile:
    """One memoized response: encoded bytes, validator (default: the
    content ETag), reply filename and the monotonic time it was stored."""

    __slots__ = ("body", "etag", "filename", "stored_at")

    def __init__(self, body: bytes, etag: Optional[str] = None, filename: str = "",
                 stored_at: Optional[float] = None):
        self.body = body
        self.etag = etag if etag is not None else make_etag(body)
        self.filename = filename
        self.stored_at = time.monotonic() if stored_at is None else stored_at

    @property
    def nbytes(self) -> int:
        return len(self.body)


class SegmentedLRU:
    """Byte-budgeted SLRU of ``CachedTile`` entries: new entries enter
    probation, a second touch promotes them to the protected segment
    (``protected_fraction`` of the budget), whose overflow demotes back to
    probation. ``admission`` (a ``TinyLFU``, or None for the plain SLRU)
    records every get and put and speaks at eviction. Thread-safe."""

    def __init__(self, max_bytes: int = MEMORY_BYTES,
                 protected_fraction: float = PROTECTED_FRACTION, admission=None):
        self.max_bytes = max_bytes
        self.protected_max = int(max_bytes * protected_fraction)
        self._probation: "OrderedDict[str, CachedTile]" = OrderedDict()
        self._protected: "OrderedDict[str, CachedTile]" = OrderedDict()
        self._bytes = 0
        self._protected_bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.admission = admission

    def get(self, key: str) -> Optional[CachedTile]:
        if self.admission is not None:
            self.admission.record(key)
        with self._lock:
            entry = self._protected.get(key)
            if entry is not None:
                self._protected.move_to_end(key)
                self.hits += 1
                return entry
            entry = self._probation.pop(key, None)
            if entry is None:
                self.misses += 1
                return None
            self.hits += 1
            self._protected[key] = entry
            self._protected_bytes += entry.nbytes
            while self._protected_bytes > self.protected_max and len(self._protected) > 1:
                demoted_key, demoted = self._protected.popitem(last=False)
                self._protected_bytes -= demoted.nbytes
                self._probation[demoted_key] = demoted
            return entry

    def put(self, key: str, entry: CachedTile) -> List[Tuple[str, CachedTile]]:
        """Insert ``entry`` (replacing ``key``); returns what was evicted,
        the candidate itself when the admission gate turned it away."""
        evicted: List[Tuple[str, CachedTile]] = []
        if entry.nbytes > self.max_bytes:
            return evicted  # can never fit
        if self.admission is not None:
            self.admission.record(key)
        with self._lock:
            old = self._probation.pop(key, None)
            if old is None:
                old = self._protected.pop(key, None)
                if old is not None:
                    self._protected_bytes -= old.nbytes
            if old is not None:
                self._bytes -= old.nbytes
            self._probation[key] = entry
            self._bytes += entry.nbytes
            while self._bytes > self.max_bytes:
                if self._probation:
                    # the TinyLFU gate: a candidate that does not beat the
                    # probation victim's frequency leaves itself
                    victim_key = next(iter(self._probation))
                    if (self.admission is not None and victim_key != key
                            and key in self._probation
                            and not self.admission.admit(key, victim_key)):
                        e = self._probation.pop(key)
                        self._bytes -= e.nbytes
                        evicted.append((key, e))
                        break
                    k, e = self._probation.popitem(last=False)
                else:
                    k, e = self._protected.popitem(last=False)
                    self._protected_bytes -= e.nbytes
                self._bytes -= e.nbytes
                if k != key:
                    evicted.append((k, e))
        return evicted

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def peek(self, key: str) -> Optional[CachedTile]:
        """The entry, without promotion or hit counting."""
        with self._lock:
            entry = self._protected.get(key)
            return entry if entry is not None else self._probation.get(key)

    def items_snapshot(self) -> List[Tuple[str, CachedTile]]:
        """A point-in-time (key, entry) list, protected tier first, each
        in MRU order: the hot-set enumeration the cluster transfers serve
        from (entries are immutable once stored)."""
        with self._lock:
            return (list(reversed(self._protected.items()))
                    + list(reversed(self._probation.items())))

    def remove_prefix(self, prefix: str) -> int:
        """Drop every entry whose key starts with ``prefix``; returns how
        many."""
        removed = 0
        with self._lock:
            for seg in (self._probation, self._protected):
                for key in [k for k in seg if k.startswith(prefix)]:
                    entry = seg.pop(key)
                    self._bytes -= entry.nbytes
                    if seg is self._protected:
                        self._protected_bytes -= entry.nbytes
                    removed += 1
        return removed

    def __len__(self) -> int:
        with self._lock:
            return len(self._probation) + len(self._protected)

    def snapshot(self) -> dict:
        with self._lock:
            return {"entries": len(self._probation) + len(self._protected),
                    "protected_entries": len(self._protected), "bytes": self._bytes,
                    "max_bytes": self.max_bytes, "hits": self.hits, "misses": self.misses}


class DiskTier:
    """Spill directory with an in-memory LRU index. Every method but
    ``peek_stored_at`` runs on the cache's I/O thread: blocking file I/O
    is the point. With a ``manifest`` (``cache/plane/manifest.py``) the
    tier is restartable: admissions and evictions are journaled and
    replayed at construction. Without one, leftover files are swept at
    construction, then the directory is fsynced."""

    def __init__(self, directory: str, max_bytes: int, manifest=None):
        self.directory = directory
        self.max_bytes = max_bytes
        self.manifest = manifest
        # key -> (path, nbytes, etag, filename, stored_at)
        self._index: "OrderedDict[str, tuple]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        os.makedirs(directory, exist_ok=True)
        if manifest is not None:
            self._restore(manifest)
            return
        swept = False
        for stale in os.listdir(directory):
            if stale.endswith((".tile", ".tmp")):
                try:
                    os.unlink(os.path.join(directory, stale))
                    swept = True
                except OSError:
                    pass
        if swept:
            # without this a crash after the sweep can bring the files back,
            # and a manifest enabled on the next start would replay ghosts
            from .plane.manifest import fsync_dir

            fsync_dir(directory)

    def _restore(self, manifest) -> None:
        """Warm start: the journal replayed and reconciled, the index
        rebuilt in admission order; a smaller ``max_bytes`` than before
        evicts from the LRU end."""
        with self._lock:
            for key, nbytes, etag, filename, stored_at in manifest.restore(self._fname):
                path = os.path.join(self.directory, self._fname(key))
                self._index[key] = (path, nbytes, etag, filename, stored_at)
                self._bytes += nbytes
            while self._bytes > self.max_bytes and len(self._index) > 1:
                key, meta = self._index.popitem(last=False)
                self._bytes -= meta[1]
                manifest.record_evict(key)
                try:
                    os.unlink(meta[0])
                except OSError:
                    pass

    @staticmethod
    def _fname(key: str) -> str:
        return hashlib.sha1(key.encode()).hexdigest() + ".tile"

    def get(self, key: str) -> Optional[CachedTile]:
        with self._lock:
            meta = self._index.get(key)
            if meta is not None:
                self._index.move_to_end(key)
            else:
                self.misses += 1
        if meta is None:
            return None
        path, _nbytes, etag, filename, stored_at = meta
        with open(path, "rb") as fh:
            body = fh.read()
        with self._lock:
            self.hits += 1
        return CachedTile(body, etag, filename, stored_at)

    def keys_snapshot(self, limit: int = 0) -> List[str]:
        """Up to ``limit`` keys from the MRU end of the index (all when
        0): the disk half of the anti-entropy digest. Index only, like
        ``peek_stored_at``."""
        with self._lock:
            keys = list(self._index)
        keys.reverse()  # MRU first: the warmest slice wins the bound
        return keys[:limit] if limit else keys

    def peek_stored_at(self, key: str) -> Optional[float]:
        """The entry's ``stored_at``, or None: index only (no file I/O, no
        promotion, no hit counted), so safe on the serving loop."""
        with self._lock:
            meta = self._index.get(key)
            return None if meta is None else meta[4]

    def put(self, key: str, entry: CachedTile) -> None:
        if entry.nbytes > self.max_bytes:
            return
        path = os.path.join(self.directory, self._fname(key))
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(entry.body)
        os.replace(tmp, path)
        victims: List[Tuple[str, str]] = []  # (key, path)
        with self._lock:
            old = self._index.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._index[key] = (path, entry.nbytes, entry.etag, entry.filename,
                                entry.stored_at)
            self._bytes += entry.nbytes
            while self._bytes > self.max_bytes and len(self._index) > 1:
                k, meta = self._index.popitem(last=False)
                self._bytes -= meta[1]
                victims.append((k, meta[0]))
        for _k, victim_path in victims:
            CACHE_EVICTIONS.inc(tier="disk")
            try:
                os.unlink(victim_path)
            except OSError:
                pass
        if self.manifest is not None:
            # journaled after the data: a crash between the rename and
            # this append leaves an orphan file (reconciled away at the
            # next start), never an admit record without data
            self.manifest.record_admit(key, entry.nbytes, entry.etag, entry.filename,
                                       entry.stored_at)
            for k, _p in victims:
                self.manifest.record_evict(k)
            self._maybe_compact()

    def remove_prefix(self, prefix: str) -> int:
        with self._lock:
            victims = [(k, meta) for k, meta in self._index.items() if k.startswith(prefix)]
            for k, meta in victims:
                del self._index[k]
                self._bytes -= meta[1]
        for _, meta in victims:
            try:
                os.unlink(meta[0])
            except OSError:
                pass
        if self.manifest is not None and victims:
            for k, _meta in victims:
                self.manifest.record_evict(k)
            self._maybe_compact()
        return len(victims)

    def _maybe_compact(self) -> None:
        """Rewrite a grown journal down to the live index."""
        if not self.manifest.needs_compaction:
            return
        with self._lock:
            live = [(k, meta[1], meta[2], meta[3], meta[4]) for k, meta in self._index.items()]
        self.manifest.compact(live)

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    def snapshot(self) -> dict:
        with self._lock:
            return {"entries": len(self._index), "bytes": self._bytes,
                    "max_bytes": self.max_bytes, "hits": self.hits, "misses": self.misses}


class TileResultCache:
    """The tiers behind the front: ``get`` (async: memory, then disk) and
    ``put`` by content key, entries above ``max_entry_bytes`` never
    admitted, entries older than ``ttl_s`` missed (0, the JAX default: no
    expiry, invalidation purges). ``invalidate_image`` drops an image's
    entries from both tiers and bumps the generation, so a fill that began
    before it (``put(..., generation=)``, or a disk read in flight) is not
    admitted. ``admission`` is the memory tier's TinyLFU gate (None: the
    plain SLRU). ``disk_dir`` turns the disk tier on (``disk_bytes``
    budget; ``manifest`` journals it); a directory that cannot be used
    leaves the cache memory-only."""

    def __init__(self, memory_bytes: int = MEMORY_BYTES,
                 max_entry_bytes: int = MAX_ENTRY_BYTES,
                 protected_fraction: float = PROTECTED_FRACTION, ttl_s: float = 0.0,
                 admission=None, disk_dir: Optional[str] = None,
                 disk_bytes: int = DISK_BYTES, manifest: bool = True):
        self.memory = SegmentedLRU(memory_bytes, protected_fraction, admission=admission)
        self.max_entry_bytes = max_entry_bytes
        self.ttl_s = ttl_s
        # bumped on every purge: a fill (or a disk read) that began under
        # an older generation is not admitted
        self._generation = 0
        self._generation_lock = threading.Lock()
        self.disk: Optional[DiskTier] = None
        self._io: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._disk_breaker = None
        self._disk_error_logged = False
        if disk_dir:
            try:
                disk_manifest = None
                if manifest:
                    from .plane.manifest import DiskManifest

                    disk_manifest = DiskManifest(disk_dir)
                self.disk = DiskTier(disk_dir, disk_bytes, manifest=disk_manifest)
                self._io = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="tile-cache-io")
                self._disk_breaker = for_dependency("cache:disk")
            except Exception:
                # a bad spill directory must not take the service down
                log.exception("disk cache tier unavailable at %s; memory-only", disk_dir)
                self.disk = None
        _LIVE_CACHES.add(self)

    def _fresh(self, entry: Optional[CachedTile]) -> Optional[CachedTile]:
        if entry is not None and self.ttl_s > 0 and (
                time.monotonic() - entry.stored_at > self.ttl_s):
            return None
        return entry

    async def get(self, key: str) -> Optional[CachedTile]:
        """Memory, then disk (re-admitting to memory); None on a miss or on
        any cache failure (pass-through)."""
        try:
            await INJECTOR.fire_async("cache.memory")
            entry = self._fresh(self.memory.get(key))
            if entry is not None:
                CACHE_REQUESTS.inc(tier="memory", outcome="hit")
                return entry
            CACHE_REQUESTS.inc(tier="memory", outcome="miss")
            if not self._disk_usable():
                return None
            # the generation before the executor hop: a purge racing the
            # read blocks the re-admission below
            generation = self.generation()
            fut = asyncio.get_running_loop().run_in_executor(self._io, self._disk_get, key)
            timeout = io_timeout_s()
            try:
                entry = await (asyncio.wait_for(fut, timeout) if timeout > 0 else fut)
            except asyncio.TimeoutError:
                # a hung disk reads as a miss; the breaker stops new work
                # queueing behind the stuck thread
                self._disk_failure()
                CACHE_REQUESTS.inc(tier="disk", outcome="miss")
                return None
            entry = self._fresh(entry)
            if entry is not None:
                evicted = self._put_guarded(key, entry, generation)
                if evicted is None:
                    # a purge raced the read: the bytes may predate it
                    CACHE_REQUESTS.inc(tier="disk", outcome="miss")
                    return None
                # the displaced spill to disk; the key just read is already
                # there (a disk hit does not remove it)
                self._spill_evicted([(k, e) for k, e in evicted if k != key])
                CACHE_REQUESTS.inc(tier="disk", outcome="hit")
                return entry
            CACHE_REQUESTS.inc(tier="disk", outcome="miss")
            return None
        except asyncio.CancelledError:
            raise
        except Exception:
            CACHE_ERRORS.inc(tier="get")
            log.exception("cache get failed; passing through")
            return None

    def contains(self, key: str) -> bool:
        """Memory-only presence probe (no promotion, no hit counted): the
        prefetcher's dedupe check."""
        try:
            return self._fresh(self.memory.peek(key)) is not None
        except Exception:
            return False

    def contains_any_tier(self, key: str) -> bool:
        """Presence probe over memory and the disk tier's index (no file
        I/O, no promotion), under the TTL ``get`` applies: the door gate's
        hit exemption, since a disk-resident entry serves without a
        scheduler slot like a memory hit."""
        if self.contains(key):
            return True
        if self.disk is None:
            return False
        try:
            stored_at = self.disk.peek_stored_at(key)
        except Exception:
            return False
        if stored_at is None:
            return False
        return not (self.ttl_s > 0 and time.monotonic() - stored_at > self.ttl_s)

    def hot_entries(self, limit: int = 128, max_bytes: int = 32 << 20
                    ) -> List[Tuple[str, CachedTile]]:
        """The top ``limit`` memory entries by admission-sketch frequency
        (protected-MRU order without a sketch, and as the tie-break),
        bounded in count and bytes; never touches disk. Empty on any
        failure (the hot-set transfer's payload)."""
        try:
            items = self.memory.items_snapshot()
            admission = self.memory.admission
            if admission is not None:
                # stable sort: equal estimates keep protected-MRU order
                items.sort(key=lambda kv: admission.estimate(kv[0]), reverse=True)
            out: List[Tuple[str, CachedTile]] = []
            total = 0
            for key, entry in items:
                if len(out) >= limit or total + entry.nbytes > max_bytes:
                    break
                out.append((key, entry))
                total += entry.nbytes
            return out
        except Exception:
            log.exception("hot-set enumeration failed; empty transfer")
            return []

    def warm_keys(self, limit: int = 128) -> List[str]:
        """Up to ``limit`` keys of the whole warm set: the hottest memory
        entries first (the ``hot_entries`` ranking), then the disk tier's
        index keys, deduplicated (the anti-entropy digest's keys). Empty
        on any failure."""
        try:
            out: List[str] = []
            seen = set()
            for key, _entry in self.hot_entries(limit):
                out.append(key)
                seen.add(key)
            if self.disk is not None and len(out) < limit:
                for key in self.disk.keys_snapshot(limit):
                    if key in seen:
                        continue
                    out.append(key)
                    if len(out) >= limit:
                        break
            return out
        except Exception:
            log.exception("warm-set enumeration failed; empty digest")
            return []

    def generation(self) -> int:
        with self._generation_lock:
            return self._generation

    def _put_guarded(self, key: str, entry: CachedTile, generation: Optional[int]
                     ) -> Optional[List[Tuple[str, CachedTile]]]:
        """Insert into memory under the generation lock: None when a purge
        ran since ``generation``, else what was evicted."""
        with self._generation_lock:
            if generation is not None and generation != self._generation:
                return None
            return self.memory.put(key, entry)

    def put(self, key: str, entry: CachedTile, generation: Optional[int] = None) -> None:
        try:
            if entry.nbytes > self.max_entry_bytes:
                return
            evicted = self._put_guarded(key, entry, generation)
            if evicted is None:
                return  # an invalidation ran while this entry was made
            CACHE_STORES.inc(tier="memory")
            self._spill_evicted(evicted)
        except Exception:
            CACHE_ERRORS.inc(tier="put")
            log.exception("cache put failed; passing through")

    def _disk_usable(self) -> bool:
        """No disk work is queued while the tier's breaker is open: a hung
        disk wedges the one I/O thread."""
        return (self.disk is not None and self._io is not None
                and self._disk_breaker.state != "open")

    def _spill_evicted(self, evicted: List[Tuple[str, CachedTile]]) -> None:
        """Count the displaced entries and spill them to disk, never
        awaited: a slow disk costs the eviction, not the reply."""
        if not evicted:
            return
        CACHE_EVICTIONS.inc(len(evicted), tier="memory")
        if self._disk_usable():
            self._io.submit(self._disk_spill, evicted)

    # -- the disk tier's work (I/O thread) -----------------------------

    def _disk_get(self, key: str) -> Optional[CachedTile]:
        """A breaker-gated read: an open breaker or an I/O error is a miss."""
        try:
            self._disk_breaker.allow()
        except BreakerOpenError:
            return None
        try:
            INJECTOR.fire("cache.disk")
            entry = self.disk.get(key)
        except Exception:
            self._disk_failure()
            return None
        self._disk_breaker.record_success()
        return entry

    def _disk_spill(self, evicted: List[Tuple[str, CachedTile]]) -> None:
        try:
            self._disk_breaker.allow()
        except BreakerOpenError:
            return
        try:
            INJECTOR.fire("cache.disk")
            for key, entry in evicted:
                self.disk.put(key, entry)
                CACHE_STORES.inc(tier="disk")
        except Exception:
            self._disk_failure()
            return
        self._disk_breaker.record_success()

    def _disk_failure(self) -> None:
        self._disk_breaker.record_failure()
        if not self._disk_error_logged:
            self._disk_error_logged = True
            log.warning("disk cache tier failing; memory-only until its breaker heals",
                        exc_info=True)

    # -- invalidation --------------------------------------------------

    def invalidate_image(self, image_id: int) -> int:
        """Drop every cached tile of one image from both tiers (any
        thread; the disk's share is queued on the I/O thread); returns how
        many left memory."""
        prefix = f"img={int(image_id)}|"
        removed = 0
        try:
            with self._generation_lock:
                self._generation += 1
                removed = self.memory.remove_prefix(prefix)
            if removed:
                CACHE_INVALIDATIONS.inc(removed, tier="memory")
            if self.disk is not None and self._io is not None:
                self._io.submit(self._disk_invalidate, prefix)
        except Exception:
            CACHE_ERRORS.inc(tier="invalidate")
            log.exception("cache invalidation failed for image %s", image_id)
        return removed

    def _disk_invalidate(self, prefix: str) -> None:
        try:
            removed = self.disk.remove_prefix(prefix)
            if removed:
                CACHE_INVALIDATIONS.inc(removed, tier="disk")
        except Exception:
            self._disk_failure()

    # -- lifecycle, observability --------------------------------------

    def snapshot(self) -> dict:
        out = {"enabled": True, "memory": self.memory.snapshot()}
        if self.memory.admission is not None:
            out["admission"] = self.memory.admission.snapshot()
        if self.disk is not None:
            disk = self.disk.snapshot()
            disk["breaker"] = self._disk_breaker.state
            if self.disk.manifest is not None:
                disk["manifest"] = self.disk.manifest.snapshot()
            out["disk"] = disk
        return out

    def close(self) -> None:
        """Stop the I/O thread without waiting (a hung disk must not wedge
        shutdown) and close the journal; a spill racing this reads as a
        disk failure and its file reconciles as an orphan."""
        _LIVE_CACHES.discard(self)
        if self._io is not None:
            self._io.shutdown(wait=False)
        if self.disk is not None and self.disk.manifest is not None:
            self.disk.manifest.close()
