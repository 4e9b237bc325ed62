"""Epoch stamps — cluster invalidation that wins every race.

(Copy of ``omero_ms_pixel_buffer_tpu/cluster/epochs.py``.)

The r11 plane's cluster invalidation was best-effort: L2 ``SCAN+DEL``
plus a peer purge fan-out, TTL-backstopped. Two holes remained:

- a fill IN FLIGHT during a purge lands in L2 *after* the DELs and
  serves stale until the TTL;
- a replica that missed the fan-out (down, partitioned) keeps serving
  its L2 reads as fresh.

Epochs close both. Every image has a monotonically increasing epoch
counter in the shared Redis (``ompb:cluster:epoch:<image>``), bumped
FIRST by every purge (the DELs that follow are space reclamation, not
correctness). Every L2 entry is stamped with the epoch its writer
observed BEFORE the render began; every L2 read compares the entry's
stamp against the CURRENT counter (fetched in the same MGET round
trip — no extra latency). A stale-epoch read IS a miss: the in-flight
fill that raced the purge arrives already-stale, and no replica needs
to have seen the fan-out.

The registry also keeps a local high-water mark per image
(``note``/``known``): peer purges carry the new epoch on the wire, so
a replica can reject an in-flight replica-push against an image it
just purged without a Redis round trip. Unstamped entries (written by
an older replica, or while Redis was unreachable at fill time) count
as epoch 0 — stale after the image's first bump, fresh before it: the
safe direction both ways.
"""

from __future__ import annotations

import logging
import re
import threading
from typing import Optional

from ..utils.metrics import REGISTRY

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.cluster")

EPOCH_PREFIX = "ompb:cluster:epoch:"
_IMAGE_RE = re.compile(r"^img=(\d+)\|")

EPOCH_EVENTS = REGISTRY.counter(
    "cluster_epoch_events_total",
    "Epoch registry activity by kind (bump, stale_read, bump_error)",
)


def image_id_of(cache_key: str) -> Optional[int]:
    """The image id a result-cache key belongs to (the key schema
    leads with ``img=<id>|``), or None for a foreign key."""
    m = _IMAGE_RE.match(cache_key or "")
    return int(m.group(1)) if m else None


def epoch_key(image_id: int) -> bytes:
    return (EPOCH_PREFIX + str(int(image_id))).encode()


class EpochRegistry:
    """Local epoch knowledge + the authoritative bump.

    Thread-safe: bumps arrive from invalidation listeners (resolver
    threads) via the serving loop, notes from the serving path and
    the internal peer handlers."""

    _MAX_KNOWN = 4096  # bounded local high-water map

    def __init__(self, link=None):
        self.link = link
        self._known: dict = {}
        self._lock = threading.Lock()
        self.bumps = 0
        self.stale_reads = 0

    # -- local knowledge ----------------------------------------------

    def note(self, image_id: int, epoch: Optional[int]) -> None:
        if epoch is None:
            return
        image_id = int(image_id)
        with self._lock:
            while len(self._known) >= self._MAX_KNOWN and (
                image_id not in self._known
            ):
                # evict oldest-inserted, never clear(): wiping the
                # whole map would erase a milliseconds-old purge mark
                # and let an in-flight stale replica push resurrect
                # invalidated bytes
                self._known.pop(next(iter(self._known)))
            if epoch > self._known.get(image_id, 0):
                self._known[image_id] = int(epoch)

    def known(self, image_id: int) -> int:
        with self._lock:
            return self._known.get(int(image_id), 0)

    def known_map(self, limit: int = 512) -> dict:
        """The most recent ``limit`` entries of the local high-water
        map — the gossip digest's epoch payload (cluster/gossip.py).
        Insertion order is first-sight order, so the tail holds the
        images most recently active on this replica — the epochs most
        worth disseminating."""
        with self._lock:
            items = list(self._known.items())
        return dict(items[-limit:]) if limit else {}

    def is_stale(
        self, cache_key: str, entry_epoch: Optional[int]
    ) -> bool:
        """Whether an entry stamped ``entry_epoch`` (None = unstamped
        = 0) predates the locally-known epoch of its image."""
        image_id = image_id_of(cache_key)
        if image_id is None:
            return False
        stale = (entry_epoch or 0) < self.known(image_id)
        if stale:
            self.count_stale()
        return stale

    def count_stale(self) -> None:
        self.stale_reads += 1
        EPOCH_EVENTS.inc(kind="stale_read")

    # -- the authoritative bump ---------------------------------------

    async def bump(self, image_id: int) -> Optional[int]:
        """INCR the image's epoch in the shared Redis; the new epoch,
        or None when the link is absent/down (the purge degrades to
        the r11 behavior: DELs + TTL backstop)."""
        self.note(image_id, self.known(image_id) + 1)  # local-first
        if self.link is None:
            return None
        try:
            reply = await self.link.command(
                b"INCR", epoch_key(image_id)
            )
            epoch = int(reply)
        except Exception:
            EPOCH_EVENTS.inc(kind="bump_error")
            log.debug("epoch bump failed for image %s", image_id,
                      exc_info=True)
            return None
        self.bumps += 1
        EPOCH_EVENTS.inc(kind="bump")
        self.note(image_id, epoch)
        return epoch

    def snapshot(self) -> dict:
        with self._lock:
            tracked = len(self._known)
        return {
            "bumps": self.bumps,
            "stale_reads": self.stale_reads,
            "tracked_images": tracked,
        }
