"""The cluster plane (counterpart of ``omero_ms_pixel_buffer_tpu/cluster/``).

- **membership** — coordination-free replica leases in the shared Redis
  (heartbeat-refreshed, TTL-expired). ``cluster.members`` is the
  bootstrap seed; each membership change rebuilds the ownership ring.
- **gossip** — SWIM-style push-pull of membership, epochs and brains over
  the signed ``/internal/gossip`` route; Redis, where configured, is only
  the L2 and a join hint.
- **brains** — per-replica pressure, open breakers and serve quality,
  shared through Redis or gossip: fleet pressure for the scheduler,
  suspect breakers, and the quality quorum's demotions.
- **epochs** — generation stamps on shared-tier entries plus a purge-
  time bump, so a stale-epoch L2 read IS a miss and an in-flight fill
  that raced a purge lands already-stale.
- **link** — the coordination connection to the shared Redis.
- **replicate** — next-owner replication of TinyLFU-qualified hot
  entries, and the transfer framing every batch of entries rides.
- **repair** — low-duty anti-entropy: a bounded digest exchange with
  one rotating peer per round pulls replicated entries this replica
  missed.
- **hedge** — owner-side hedging off the observed peer-stage p99.
- **security** — HMAC authentication of the ``/internal/*`` surface and
  of peer hops (nonce-stamped, replay-proof), and sealed values.
- **integrity** — every transferred body is checked against its entry's
  strong content hash.
- **suspect** — the serve-quality tracker (its quorum reaches the ring
  through the fleet brains).
- **lifecycle** — graceful drain: announce the leave, hand the RAM hot
  set to the post-drain owners, quiesce, leave.

Everything here inherits the cache plane's
contract: no operation may fail a request; every network edge carries a
breaker, a fault point and a per-call timeout; every failure degrades to
single-process behaviour.
"""

from .brains import FleetBrains
from .epochs import EpochRegistry, image_id_of
from .gossip import GossipManager
from .hedge import HedgePolicy
from .integrity import CorruptionLedger, body_matches
from .lifecycle import DrainCoordinator
from .link import RedisLink
from .membership import MembershipManager
from .repair import AntiEntropyRepairer, build_digest, parse_digest
from .replicate import HotSetReplicator, decode_transfer, encode_transfer
from .security import NonceCache, SIG_HEADER, seal, sign, unseal, verify
from .suspect import QualityTracker, SuspicionPolicy

__all__ = [
    "FleetBrains",
    "EpochRegistry",
    "image_id_of",
    "GossipManager",
    "HedgePolicy",
    "CorruptionLedger",
    "body_matches",
    "DrainCoordinator",
    "RedisLink",
    "MembershipManager",
    "AntiEntropyRepairer",
    "build_digest",
    "parse_digest",
    "HotSetReplicator",
    "encode_transfer",
    "decode_transfer",
    "NonceCache",
    "SIG_HEADER",
    "seal",
    "sign",
    "unseal",
    "verify",
    "QualityTracker",
    "SuspicionPolicy",
]
