"""The tile result cache's memory tier (counterpart of
``omero_ms_pixel_buffer_tpu/cache/result_cache.py``): content ETags,
``If-None-Match`` matching, and a byte-budgeted segmented LRU of encoded
tiles, with the optional TinyLFU admission gate (``cache/plane/
tinylfu.py``: every get and put is recorded, and at eviction a candidate
displaces the probation victim only when its estimated frequency is at
least the victim's). Lookups, stores, evictions and invalidations go to
``/metrics`` under the JAX names (``tile_cache_*``). The JAX package's
disk tier and cluster tiers are not ported.
"""

from __future__ import annotations

import hashlib
import threading
import time
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..utils.metrics import REGISTRY

# the JAX package's cache defaults (cache: memory-mb, protected-fraction,
# max-entry-kb); the front takes them, and max-age-s, from its config
MEMORY_BYTES = 256 << 20
PROTECTED_FRACTION = 0.8
MAX_ENTRY_BYTES = 4096 << 10

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
    return {(("tier", "memory"),): float(sum(c.memory.nbytes for c in list(_LIVE_CACHES)))}


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
    """One memoized response: encoded bytes, validator, reply filename."""

    __slots__ = ("body", "etag", "filename", "stored_at")

    def __init__(self, body: bytes, filename: str = ""):
        self.body = body
        self.etag = make_etag(body)
        self.filename = filename
        self.stored_at = time.monotonic()

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


class TileResultCache:
    """The memory tier behind the front: ``get`` and ``put`` by content key,
    entries above ``max_entry_bytes`` never admitted, entries older than
    ``ttl_s`` missed (0, the JAX default: no expiry, invalidation purges).
    ``invalidate_image`` drops an image's entries and bumps the
    generation, so a fill that began before it (``put(...,
    generation=)``) is not admitted. ``admission`` is the memory tier's
    TinyLFU gate (None: the plain SLRU)."""

    def __init__(self, memory_bytes: int = MEMORY_BYTES,
                 max_entry_bytes: int = MAX_ENTRY_BYTES,
                 protected_fraction: float = PROTECTED_FRACTION, ttl_s: float = 0.0,
                 admission=None):
        self.memory = SegmentedLRU(memory_bytes, protected_fraction, admission=admission)
        self.max_entry_bytes = max_entry_bytes
        self.ttl_s = ttl_s
        self._generation = 0
        self._generation_lock = threading.Lock()
        _LIVE_CACHES.add(self)

    def _fresh(self, entry: Optional[CachedTile]) -> Optional[CachedTile]:
        if entry is not None and self.ttl_s > 0 and (
                time.monotonic() - entry.stored_at > self.ttl_s):
            return None
        return entry

    def get(self, key: str) -> Optional[CachedTile]:
        entry = self._fresh(self.memory.get(key))
        CACHE_REQUESTS.inc(tier="memory", outcome="miss" if entry is None else "hit")
        return entry

    def contains(self, key: str) -> bool:
        """The door gate's probe: no promotion, no hit counted."""
        return self._fresh(self.memory.peek(key)) is not None

    def generation(self) -> int:
        with self._generation_lock:
            return self._generation

    def put(self, key: str, entry: CachedTile, generation: Optional[int] = None) -> None:
        if entry.nbytes > self.max_entry_bytes:
            return
        with self._generation_lock:
            if generation is not None and generation != self._generation:
                return  # an invalidation ran while this entry was made
            evicted = self.memory.put(key, entry)
        CACHE_STORES.inc(tier="memory")
        if evicted:
            CACHE_EVICTIONS.inc(len(evicted), tier="memory")

    def invalidate_image(self, image_id: int) -> int:
        """Drop every cached tile of one image (any thread); returns how
        many."""
        with self._generation_lock:
            self._generation += 1
            removed = self.memory.remove_prefix(f"img={int(image_id)}|")
        if removed:
            CACHE_INVALIDATIONS.inc(removed, tier="memory")
        return removed

    def snapshot(self) -> dict:
        out = {"enabled": True, "memory": self.memory.snapshot()}
        if self.memory.admission is not None:
            out["admission"] = self.memory.admission.snapshot()
        return out
