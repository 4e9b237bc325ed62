"""The tile result cache's memory tier (counterpart of
``omero_ms_pixel_buffer_tpu/cache/result_cache.py``): content ETags,
``If-None-Match`` matching, and a byte-budgeted segmented LRU of encoded
tiles. The JAX package's disk tier, its TinyLFU admission gate and the
cluster tiers are not ported; without the gate the memory tier is the
plain SLRU the JAX package runs with ``cache.tinylfu.enabled: false``.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

# the JAX package's cache defaults (cache: memory-mb, protected-fraction,
# max-entry-kb, max-age-s)
MEMORY_BYTES = 256 << 20
PROTECTED_FRACTION = 0.8
MAX_ENTRY_BYTES = 4096 << 10
MAX_AGE_S = 60


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

    __slots__ = ("body", "etag", "filename")

    def __init__(self, body: bytes, filename: str = ""):
        self.body = body
        self.etag = make_etag(body)
        self.filename = filename

    @property
    def nbytes(self) -> int:
        return len(self.body)


class SegmentedLRU:
    """Byte-budgeted SLRU of ``CachedTile`` entries: new entries enter
    probation, a second touch promotes them to the protected segment
    (``protected_fraction`` of the budget), whose overflow demotes back to
    probation. Thread-safe."""

    def __init__(self, max_bytes: int = MEMORY_BYTES,
                 protected_fraction: float = PROTECTED_FRACTION):
        self.max_bytes = max_bytes
        self.protected_max = int(max_bytes * protected_fraction)
        self._probation: "OrderedDict[str, CachedTile]" = OrderedDict()
        self._protected: "OrderedDict[str, CachedTile]" = OrderedDict()
        self._bytes = 0
        self._protected_bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> Optional[CachedTile]:
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
        """Insert ``entry`` (replacing ``key``); returns what was evicted."""
        evicted: List[Tuple[str, CachedTile]] = []
        if entry.nbytes > self.max_bytes:
            return evicted  # can never fit
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
                    k, e = self._probation.popitem(last=False)
                else:
                    k, e = self._protected.popitem(last=False)
                    self._protected_bytes -= e.nbytes
                self._bytes -= e.nbytes
                if k != key:
                    evicted.append((k, e))
        return evicted

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
    entries above ``max_entry_bytes`` never admitted. As with the JAX
    package's defaults, entries do not expire (``cache.ttl-s`` 0); the port
    has no invalidation source yet (no metadata database), so no purge
    exists."""

    def __init__(self, memory_bytes: int = MEMORY_BYTES,
                 max_entry_bytes: int = MAX_ENTRY_BYTES):
        self.memory = SegmentedLRU(memory_bytes, PROTECTED_FRACTION)
        self.max_entry_bytes = max_entry_bytes

    def get(self, key: str) -> Optional[CachedTile]:
        return self.memory.get(key)

    def put(self, key: str, entry: CachedTile) -> None:
        if entry.nbytes <= self.max_entry_bytes:
            self.memory.put(key, entry)

    def snapshot(self) -> dict:
        return {"enabled": True, "memory": self.memory.snapshot()}
