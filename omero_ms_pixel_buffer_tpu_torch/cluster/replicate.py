"""Hot-set replication — an owner crash must not cold-start its keys.

(Copy of ``omero_ms_pixel_buffer_tpu/cluster/replicate.py``.)

With ``cluster.replication-factor`` >= 2, entries that the TinyLFU
sketch considers HOT are pushed to the next ``factor - 1`` distinct
owners clockwise on the ring (``POST /internal/replica``). When the
owner crashes, the membership lease expires, the ring rebuilds, and —
by the consistent-hash construction — the keys the dead owner held
remap to exactly the successors that hold the replicas: the re-
requests that follow are HITS, not a render stampede (the bench pins
>= 80% on the replicated hot set).

Qualification is frequency, not recency: a key replicates when its
admission-sketch estimate reaches ``hot_threshold`` — at fill time
for re-rendered hot keys, and from the serving hit path the moment a
key crosses the bar (one push per key, deduplicated by a bounded LRU
set that resets on ring changes, since new ownership means new
successors). Without a sketch (TinyLFU off) every fill qualifies —
replication without a frequency filter is still replication.

Join-time warm-up is the same machinery in reverse: a replica that
boots COLD (no manifest-warmed disk tier, empty RAM) pulls each live
peer's hottest entries once (``GET /internal/transfer``, bounded by
``cluster.transfer-max-entries`` and a byte cap) so a fresh
autoscaled replica serves warm within one transfer round instead of
re-rendering the fleet's working set.

The transfer payload is length-prefixed frames over the L2 entry
encoding (epoch stamps included, so a stale transfer entry is
rejected exactly like a stale replica push):

    [u32 key-len][key utf-8][u32 frame-len][l2 entry frame] ...
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from typing import List, Optional, Tuple

from ..utils.metrics import REGISTRY

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.cluster")

REPLICATION = REGISTRY.counter(
    "cluster_replication_total",
    "Hot-set replication activity by op and outcome",
)

MAX_TRANSFER_BYTES = 32 << 20  # hard bound on one transfer payload


def encode_transfer(items: List[Tuple[str, bytes]]) -> bytes:
    """Frame ``(key, l2-entry-frame)`` pairs into one transfer body,
    dropping anything past the byte bound."""
    out = bytearray()
    for key, frame in items:
        kb = key.encode()
        record_len = 8 + len(kb) + len(frame)
        if len(out) + record_len > MAX_TRANSFER_BYTES:
            break
        out += len(kb).to_bytes(4, "big")
        out += kb
        out += len(frame).to_bytes(4, "big")
        out += frame
    return bytes(out)


def decode_transfer(body: bytes) -> List[Tuple[str, bytes]]:
    """Parse a transfer body; truncated/malformed tails are dropped
    (a torn transfer yields the intact prefix, never an error)."""
    items: List[Tuple[str, bytes]] = []
    view = memoryview(body)
    pos = 0
    try:
        while pos + 4 <= len(view):
            klen = int.from_bytes(view[pos:pos + 4], "big")
            pos += 4
            if klen > 4096 or pos + klen + 4 > len(view):
                break
            key = bytes(view[pos:pos + klen]).decode()
            pos += klen
            flen = int.from_bytes(view[pos:pos + 4], "big")
            pos += 4
            if pos + flen > len(view):
                break
            items.append((key, bytes(view[pos:pos + flen])))
            pos += flen
    except Exception:
        log.debug("malformed transfer payload; keeping intact prefix",
                  exc_info=True)
    return items


class HotSetReplicator:
    """Decides WHAT replicates and remembers what already did; the
    cache plane owns the pushes (its peer client, its fire-and-forget
    task machinery)."""

    _MAX_PUSHED = 4096

    def __init__(
        self,
        self_url: str,
        replication_factor: int = 2,
        # the admission sketch counts the miss-probe AND the fill, so
        # a brand-new key sits at ~2 the moment it lands; 3 means "a
        # second request touched this" — the cheapest real evidence
        # of heat
        hot_threshold: int = 3,
        transfer_max_entries: int = 128,
    ):
        self.self_url = self_url
        self.replication_factor = max(1, int(replication_factor))
        self.hot_threshold = max(1, int(hot_threshold))
        self.transfer_max_entries = max(0, int(transfer_max_entries))
        self._pushed: "OrderedDict[str, bool]" = OrderedDict()
        self.pushes = 0
        self.push_errors = 0
        self.received = 0
        self.rejected_stale = 0
        self.transfers_served = 0
        self.transfers_pulled = 0

    def targets(self, ring, key: str) -> List[str]:
        """The replica holders for ``key``: the first
        ``replication_factor`` distinct owners clockwise, minus this
        replica."""
        if ring is None or self.replication_factor < 2:
            return []
        return [
            m for m in ring.owners(key, self.replication_factor)
            if m != self.self_url
        ][: self.replication_factor - 1]

    def qualifies(self, key: str, estimate: Optional[int]) -> bool:
        """Hot enough to replicate, and not already pushed under the
        current ring. ``estimate`` None means no sketch — everything
        qualifies."""
        if self.replication_factor < 2:
            return False
        if estimate is not None and estimate < self.hot_threshold:
            return False
        if key in self._pushed:
            return False
        return True

    def mark_pushed(self, key: str) -> None:
        self._pushed[key] = True
        self._pushed.move_to_end(key)
        while len(self._pushed) > self._MAX_PUSHED:
            self._pushed.popitem(last=False)

    def ring_changed(self) -> None:
        """New ring, new successors: what was pushed no longer lands
        where ownership says — let hot keys re-replicate."""
        self._pushed.clear()

    def snapshot(self) -> dict:
        return {
            "factor": self.replication_factor,
            "hot_threshold": self.hot_threshold,
            "pushed": self.pushes,
            "push_errors": self.push_errors,
            "received": self.received,
            "rejected_stale": self.rejected_stale,
            "transfers_served": self.transfers_served,
            "transfers_pulled": self.transfers_pulled,
            "pushed_tracked": len(self._pushed),
        }
