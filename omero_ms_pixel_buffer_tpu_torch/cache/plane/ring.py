"""Consistent-hash ownership ring — which replica owns a tile key.

(Copy of ``omero_ms_pixel_buffer_tpu/cache/plane/ring.py``.)

N replicas partition the cache-key space so each unique tile has ONE
owner responsible for rendering it; everyone else peer-fetches. The
classic virtual-node ring keeps two properties the cluster needs:

- **balance** — each member hashes to ``virtual_nodes`` points on the
  ring, so ownership splits near-evenly even for small member counts;
- **stability** — removing a member from the static list only remaps
  the keys that member owned; every other key keeps its owner (so a
  rolling config change does not cold-start the whole fleet's
  ownership map).

The ring itself is immutable; LIVENESS is layered on top. The member
list starts from the validated ``cluster:`` config block and — with
``cluster.lease-ttl-s`` > 0 — is replaced live by the lease-backed
membership view (cluster/membership.py): every membership change
swaps in a freshly built ring (stability means only the departed/
arrived member's keys remap). Hashing is blake2b, deterministic
across processes and platforms: every replica computes the identical
ring from the identical member view, which is the whole correctness
argument for ownership (two replicas disagreeing on an owner merely
costs a double render, never wrong bytes — keys carry the full
encode signature).
"""

from __future__ import annotations

import bisect
import hashlib
from typing import List, Sequence


def _point(data: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(data.encode(), digest_size=8).digest(), "big"
    )


class HashRing:
    def __init__(self, members: Sequence[str], virtual_nodes: int = 64):
        if not members:
            raise ValueError("HashRing needs at least one member")
        if len(set(members)) != len(members):
            raise ValueError("duplicate cluster members")
        self.members: List[str] = list(members)
        self.virtual_nodes = virtual_nodes
        points = []
        for member in self.members:
            for i in range(virtual_nodes):
                points.append((_point(f"{member}#{i}"), member))
        points.sort()
        self._hashes = [p for p, _m in points]
        self._owners = [m for _p, m in points]

    def owner(self, key: str) -> str:
        """The member owning ``key``: the first ring point clockwise
        of the key's hash (wrapping past the top)."""
        idx = bisect.bisect_right(self._hashes, _point(key))
        if idx == len(self._hashes):
            idx = 0
        return self._owners[idx]

    def owners(self, key: str, n: int = 1) -> List[str]:
        """The first ``n`` DISTINCT members clockwise of the key's
        hash — the owner first, then its replication successors (the
        classic consistent-hashing preference list: when the owner
        leaves, the rebuilt ring maps the key to exactly the next
        member on this list). Fewer than ``n`` when the ring is
        smaller."""
        start = bisect.bisect_right(self._hashes, _point(key))
        found: List[str] = []
        for i in range(len(self._owners)):
            member = self._owners[(start + i) % len(self._owners)]
            if member not in found:
                found.append(member)
                if len(found) >= n:
                    break
        return found

    def snapshot(self) -> dict:
        return {
            "members": list(self.members),
            "virtual_nodes": self.virtual_nodes,
        }
