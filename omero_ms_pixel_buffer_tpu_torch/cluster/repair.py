"""Anti-entropy repair — replication that heals instead of hoping.

(Copy of ``omero_ms_pixel_buffer_tpu/cluster/repair.py``.)

Next-owner replication (replicate.py) is push-time-bounded: a push
lost to a timeout, an entry the successor evicted and the ring never
invalidated the dedupe for, or a replica that joined mid-burst all
leave holes the r17 design never repairs — the KNOWN_GAPS
"hot-set-only replication without anti-entropy" item. This module is
the low-duty background loop that closes them.

Every ``cluster.repair.interval-s`` the repairer picks ONE live peer
(round-robin over the membership view, drainers and demoted replicas
skipped) and runs a digest exchange:

1. ``GET /internal/digest`` — the peer answers a COMPACT summary of
   its hottest RAM entries: ``{"sum": <crc of the whole digest>,
   "entries": [{"k": key, "ep": epoch}, ...]}``, bounded by
   ``repair.max-keys``. The top-level checksum lets the puller skip
   an unchanged peer for the price of one small GET — in the
   converged steady state a repair round costs a digest, nothing
   else. The skip is BOUNDED (``MAX_SKIPS`` consecutive rounds):
   the checksum describes the peer's holdings, not this replica's,
   so a locally-evicted copy still re-diffs within a bounded number
   of rounds.
2. **diff locally** — the puller wants exactly the digest entries
   where the ring says it is one of the key's ``replication-factor``
   owners, the peer is the primary owner (the push direction the
   replication contract promises), the entry is not epoch-stale, and
   it is locally absent.
3. ``POST /internal/pull`` — the missing keys (capped at
   ``repair.max-keys``) come back as one transfer-framed payload
   (capped by the transfer byte bound), absorbed through the same
   epoch-checked path as a join warm-up.

Bytes per round are therefore bounded twice (key count and payload
bytes) and the cadence is config-bounded, so repair can never compete
with serving; convergence is pinned in the chaos suite — a
deliberately-dropped push is healed within ceil(members) rounds
(every peer gets visited once per rotation).
"""

from __future__ import annotations

import json
import logging
import zlib
from typing import Dict, List, Optional, Tuple

from ..utils.metrics import REGISTRY

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.cluster")

REPAIR_ROUNDS = REGISTRY.counter(
    "cluster_repair_rounds_total",
    "Anti-entropy repair rounds by outcome",
)
REPAIR_PULLED = REGISTRY.counter(
    "cluster_repair_pulled_total",
    "Entries pulled by the anti-entropy repair loop",
)


def build_digest(items: List[Tuple[str, Optional[int]]]) -> bytes:
    """The /internal/digest response body: a bounded JSON summary of
    (key, epoch) pairs with a whole-digest checksum so an unchanged
    peer costs its puller one comparison."""
    entries = [
        {"k": key, "ep": epoch} for key, epoch in items
    ]
    acc = 0
    for e in entries:
        acc = zlib.crc32(
            f"{e['k']}\x00{e['ep']}".encode(), acc
        )
    return json.dumps(
        {"sum": acc & 0xFFFFFFFF, "entries": entries},
        separators=(",", ":"),
    ).encode()


def parse_digest(body: bytes) -> Optional[dict]:
    """``{"sum": int, "entries": [{"k","ep"}...]}`` or None on any
    malformation — a corrupt digest skips the round, never errors."""
    try:
        parsed = json.loads(body)
        if not isinstance(parsed, dict):
            return None
        entries = parsed.get("entries")
        if not isinstance(entries, list):
            return None
        clean = []
        for e in entries:
            if not isinstance(e, dict) or not isinstance(
                e.get("k"), str
            ):
                continue
            ep = e.get("ep")
            clean.append({
                "k": e["k"],
                "ep": int(ep) if ep is not None else None,
            })
        return {"sum": int(parsed.get("sum") or 0), "entries": clean}
    except Exception:
        return None


class AntiEntropyRepairer:
    """Round rotation + the local diff; the cache plane owns the loop
    cadence and the network ops."""

    def __init__(
        self,
        self_url: str,
        interval_s: float = 5.0,
        max_keys: int = 64,
    ):
        self.self_url = self_url
        self.interval_s = float(interval_s)
        self.max_keys = max(1, int(max_keys))
        self.rounds = 0
        self.skipped_unchanged = 0
        self.pulled = 0
        self.pull_errors = 0
        self.digests_served = 0
        self.last_round_pulled = 0
        self._rotation = 0
        # peer -> last seen digest checksum (the converged-steady-
        # state fast path); reset on ring changes, when ownership —
        # and therefore what we should hold — moved under us
        self._last_sums: Dict[str, int] = {}
        # consecutive checksum-skips per peer: the digest sum only
        # describes the PEER's holdings, not ours — an entry this
        # replica evicted locally leaves the peer's sum unchanged,
        # so an unbounded skip would never re-diff (and never
        # re-pull) it. Re-diffing every MAX_SKIPS rounds bounds that
        # staleness at MAX_SKIPS x interval while keeping the
        # steady state one digest GET per round.
        self._skips: Dict[str, int] = {}

    MAX_SKIPS = 8

    def next_peer(self, candidates: List[str]) -> Optional[str]:
        """Round-robin over the eligible peers (stable across
        membership-order jitter: rotation indexes the sorted list)."""
        peers = sorted(m for m in candidates if m != self.self_url)
        if not peers:
            return None
        peer = peers[self._rotation % len(peers)]
        self._rotation += 1
        return peer

    def ring_changed(self) -> None:
        self._last_sums.clear()
        self._skips.clear()

    def unchanged(self, peer: str, digest_sum: int) -> bool:
        """True when this peer's digest is byte-for-byte the one we
        already diffed SUCCESSFULLY — the round ends at the digest
        GET. The sum is recorded by ``note_synced`` only after a
        fully-successful round, so a failed pull can never make the
        next round skip the very holes it failed to fill; and at most
        ``MAX_SKIPS`` consecutive rounds skip, so a LOCALLY-evicted
        copy (invisible to the peer's checksum) still re-diffs and
        re-pulls within a bounded number of rounds."""
        if self._last_sums.get(peer) != digest_sum:
            return False
        skips = self._skips.get(peer, 0)
        if skips >= self.MAX_SKIPS:
            self._skips[peer] = 0
            return False  # periodic full re-diff
        self._skips[peer] = skips + 1
        return True

    def note_synced(self, peer: str, digest_sum: int) -> None:
        self._last_sums[peer] = digest_sum
        while len(self._last_sums) > 256:  # bounded per fleet size
            self._last_sums.pop(next(iter(self._last_sums)))

    def select_missing(
        self,
        peer: str,
        digest_entries: List[dict],
        ring,
        replication_factor: int,
        has_local,
        is_stale,
    ) -> List[str]:
        """The keys worth pulling from ``peer``: the replication
        contract says they should already be here (peer owns them,
        this replica is a configured successor), they are not stale,
        and they are locally absent. Bounded by ``max_keys``."""
        wanted: List[str] = []
        if ring is None or replication_factor < 2:
            return wanted
        for entry in digest_entries:
            key = entry["k"]
            try:
                owners = ring.owners(key, replication_factor)
            except Exception:
                continue
            if not owners or owners[0] != peer:
                continue
            if self.self_url not in owners[1:]:
                continue
            if is_stale(key, entry.get("ep")):
                continue
            if has_local(key):
                continue
            wanted.append(key)
            if len(wanted) >= self.max_keys:
                break
        return wanted

    def snapshot(self) -> dict:
        return {
            "interval_s": self.interval_s,
            "max_keys": self.max_keys,
            "rounds": self.rounds,
            "skipped_unchanged": self.skipped_unchanged,
            "pulled": self.pulled,
            "pull_errors": self.pull_errors,
            "digests_served": self.digests_served,
            "last_round_pulled": self.last_round_pulled,
        }
