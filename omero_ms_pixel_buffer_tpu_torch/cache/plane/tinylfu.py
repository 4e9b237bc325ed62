"""TinyLFU admission filter: frequency-informed cache admission (copy of
``omero_ms_pixel_buffer_tpu/cache/plane/tinylfu.py``).

The SLRU memory tier is scan-*resistant* but not scan-*proof*: a robot
that touches each tile twice in quick succession (overlapping viewport
fetches do exactly this) promotes its keys into the protected segment
and displaces the interactive viewers' working set. TinyLFU (Einziger,
Friedman & Manes, "TinyLFU: A Highly Efficient Cache Admission
Policy") fixes this with an approximate frequency history in front of
admission: a candidate only displaces the eviction victim when its
*frequency* beats the victim's, so a twice-seen sweep key cannot push
out a tile a viewer loops over every few seconds.

Components, sized for O(64 KiB) at the defaults:

- **4-bit count-min sketch** — ``depth`` rows of ``counters`` 4-bit
  saturating counters (two per byte). Estimates are the row minimum;
  over-estimation from collisions only, never under (modulo halving).
- **Periodic halving** — after ``sample_size`` recorded accesses every
  counter is halved (one shift-and-mask pass over the table) and the
  doorkeeper resets, so the history ages: a formerly-hot key decays
  instead of squatting on its peak frequency forever.
- **Doorkeeper bloom filter** — one-hit wonders (most of a robot
  sweep) park in a bloom filter and never touch the sketch; only a
  SECOND occurrence within the sample period spends sketch counters.
  Membership adds 1 to the estimate.

Admission rule: ``estimate(candidate) >= estimate(victim)``. The
deviation from the paper's strict ``>`` is deliberate: the prefetcher
fills tiles nobody has requested yet (frequency 0-1), and a strict
rule would refuse every speculative fill into a full cache — ties fall
back to recency (plain SLRU behavior), which keeps the filter a pure
improvement over the status quo. The paper's randomized tie-break for
hash-flood resistance is not implemented.

Thread-safe: the SLRU calls it under its own lock from both the event
loop and invalidation threads; the sketch carries its own lock so
direct callers (tests, the A/B bench) are safe too.
"""

from __future__ import annotations

import hashlib
import threading

from ...utils.metrics import REGISTRY

ADMISSION = REGISTRY.counter(
    "tile_cache_admission_total",
    "TinyLFU admission decisions at the memory tier, by outcome",
)


def _hashes(key: str) -> tuple:
    """Four independent 32-bit hashes from one blake2b digest —
    deterministic across processes and runs (a requirement for tests
    that pin estimates, and cheap: one digest per recorded access)."""
    d = hashlib.blake2b(key.encode(), digest_size=16).digest()
    return (
        int.from_bytes(d[0:4], "little"),
        int.from_bytes(d[4:8], "little"),
        int.from_bytes(d[8:12], "little"),
        int.from_bytes(d[12:16], "little"),
    )


class CountMinSketch:
    """4-bit saturating count-min sketch, two counters per byte."""

    def __init__(self, counters: int = 16384, depth: int = 4):
        if counters < 2 or depth < 1 or depth > 4:
            raise ValueError("counters >= 2 and 1 <= depth <= 4")
        self.counters = counters
        self.depth = depth
        self._table = bytearray((counters * depth + 1) // 2)

    def _nibble(self, idx: int) -> int:
        byte = self._table[idx >> 1]
        return (byte >> 4) if (idx & 1) else (byte & 0x0F)

    def _set_nibble(self, idx: int, value: int) -> None:
        byte = self._table[idx >> 1]
        if idx & 1:
            self._table[idx >> 1] = (byte & 0x0F) | (value << 4)
        else:
            self._table[idx >> 1] = (byte & 0xF0) | value

    def increment(self, hashes: tuple) -> None:
        for row in range(self.depth):
            idx = row * self.counters + hashes[row] % self.counters
            v = self._nibble(idx)
            if v < 15:
                self._set_nibble(idx, v + 1)

    def estimate(self, hashes: tuple) -> int:
        return min(
            self._nibble(
                row * self.counters + hashes[row] % self.counters
            )
            for row in range(self.depth)
        )

    def halve(self) -> None:
        """Age the history: halve every 4-bit counter in one pass.
        ``(b >> 1) & 0x77`` halves both nibbles of a byte at once (the
        mask strips each nibble's bit that shifted across the
        boundary)."""
        table = self._table
        for i in range(len(table)):
            table[i] = (table[i] >> 1) & 0x77


class Doorkeeper:
    """Bloom filter (two hash functions) absorbing first occurrences."""

    def __init__(self, bits: int = 16384):
        self.bits = bits
        self._bytes = bytearray((bits + 7) // 8)

    def _positions(self, hashes: tuple) -> tuple:
        return (hashes[0] % self.bits, hashes[1] % self.bits)

    def contains(self, hashes: tuple) -> bool:
        return all(
            self._bytes[p >> 3] & (1 << (p & 7))
            for p in self._positions(hashes)
        )

    def add(self, hashes: tuple) -> None:
        for p in self._positions(hashes):
            self._bytes[p >> 3] |= 1 << (p & 7)

    def clear(self) -> None:
        for i in range(len(self._bytes)):
            self._bytes[i] = 0


class TinyLFU:
    """The admission policy handed to ``SegmentedLRU``: ``record``
    every access (reads and writes, the Caffeine convention),
    ``admit`` at eviction time."""

    def __init__(
        self,
        counters: int = 16384,
        depth: int = 4,
        sample_size: int = 0,
    ):
        self.sketch = CountMinSketch(counters, depth)
        self.doorkeeper = Doorkeeper(counters)
        # the paper's W: accesses per aging period; 10x the counter
        # count mirrors Caffeine's 10x-capacity default
        self.sample_size = sample_size if sample_size > 0 else counters * 10
        self._additions = 0
        self.resets = 0
        self._lock = threading.Lock()

    def record(self, key: str) -> None:
        hashes = _hashes(key)
        with self._lock:
            if not self.doorkeeper.contains(hashes):
                self.doorkeeper.add(hashes)
            else:
                self.sketch.increment(hashes)
            self._additions += 1
            if self._additions >= self.sample_size:
                self.sketch.halve()
                self.doorkeeper.clear()
                self._additions //= 2
                self.resets += 1

    def estimate(self, key: str) -> int:
        hashes = _hashes(key)
        with self._lock:
            return self._estimate_locked(hashes)

    def _estimate_locked(self, hashes: tuple) -> int:
        est = self.sketch.estimate(hashes)
        if self.doorkeeper.contains(hashes):
            est += 1
        return est

    def admit(self, candidate: str, victim: str) -> bool:
        """Should ``candidate`` displace ``victim``? Ties admit (see
        module docstring: recency breaks ties so speculative fills
        survive a cold sketch)."""
        c_hashes, v_hashes = _hashes(candidate), _hashes(victim)
        with self._lock:
            ok = (
                self._estimate_locked(c_hashes)
                >= self._estimate_locked(v_hashes)
            )
        ADMISSION.inc(decision="admit" if ok else "reject")
        return ok

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": self.sketch.counters,
                "depth": self.sketch.depth,
                "sample_size": self.sample_size,
                "additions": self._additions,
                "resets": self.resets,
            }
