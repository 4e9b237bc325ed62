"""HMAC authentication for the peer surface.

(Copy of ``omero_ms_pixel_buffer_tpu/cluster/security.py``.)

``/internal/*`` (purge fan-out, hot-entry replication, warm-up
transfer, drain/repair control) and the ``X-OMPB-Peer``-marked serving
hops were a pure network-trust surface — any process that could reach
the port could purge caches or pull the hot set (the KNOWN_GAPS
"trusts the network" item). With ``cluster.secret`` configured, every
such request must carry

    X-OMPB-Sig: v2:<unix-ts>:<nonce>:<hex hmac-sha256>

where the MAC covers ``method \\n path?query \\n ts \\n nonce \\n
peer \\n sha256(body)`` under the shared secret — ``peer`` is the
``X-OMPB-Peer`` identity the sender claims, INSIDE the MAC so a
captured signature cannot be re-presented under a rotated peer name
(the nonce cache is keyed per peer; an un-MACed peer identity would
let an attacker dodge it with a fresh name per replay, and flood the
per-peer bounds with invented peers). Verification is constant-time
(``hmac.compare_digest``), bounded by a clock-skew window, AND
replay-proof: the nonce joins the signature, and the verifier keeps a
bounded per-peer cache of nonces it has already accepted inside the
skew window — a captured header re-presented verbatim fails even
within the window (the r17 KNOWN_GAPS replay item). Nonces are only
recorded for signatures that are otherwise VALID, so garbage traffic
cannot churn the cache; the cache is bounded per peer so one peer's
flood cannot evict another peer's replay protection.

The r17 ``v1`` scheme (no nonce) is rejected outright — a mixed-
version fleet mid-rolling-restart renders locally for one deploy
window instead of keeping the replay hole open. Without a secret the
surface keeps its previous posture: the peer marker is required and
deploy-time network policy is the boundary.
"""

from __future__ import annotations

import hashlib
import hmac
import secrets as _secrets
import threading
import time
from collections import OrderedDict
from typing import Optional

SIG_HEADER = "X-OMPB-Sig"
DEFAULT_SKEW_S = 30.0
_VERSION = "v2"
_NONCE_HEX_LEN = 16  # 8 random bytes — plenty inside a 60 s window


class NonceCache:
    """Replay guard: nonces accepted inside the skew window, bounded
    per peer AND in peer count. ``seen_or_record`` is the only
    operation: True means REPLAY (reject), False records the nonce
    and admits. Expired nonces are pruned opportunistically on every
    insert into the same peer's map, so the cache never needs a
    background sweeper. Thread-safe — verification runs on the
    serving loop today, but a lock keeps the contract local."""

    def __init__(
        self,
        max_peers: int = 64,
        max_per_peer: int = 4096,
        skew_s: float = DEFAULT_SKEW_S,
    ):
        self.max_peers = max_peers
        self.max_per_peer = max_per_peer
        self.skew_s = skew_s
        self.replays_rejected = 0
        self._lock = threading.Lock()
        # peer -> OrderedDict[nonce -> expiry] (insertion order ~
        # expiry order: expiries are now + a constant window)
        self._peers: "OrderedDict[str, OrderedDict]" = OrderedDict()

    def seen_or_record(
        self, peer: str, nonce: str, now: Optional[float] = None
    ) -> bool:
        wall = time.time() if now is None else now
        expiry = wall + 2.0 * self.skew_s
        with self._lock:
            nonces = self._peers.get(peer)
            if nonces is None:
                nonces = self._peers[peer] = OrderedDict()
                while len(self._peers) > self.max_peers:
                    self._peers.popitem(last=False)
            if nonce in nonces:
                if nonces[nonce] > wall:
                    self.replays_rejected += 1
                    return True
                del nonces[nonce]  # expired: the window has moved on
            # prune expired heads (oldest-inserted expire first)
            while nonces:
                head, head_expiry = next(iter(nonces.items()))
                if head_expiry > wall:
                    break
                del nonces[head]
            nonces[nonce] = expiry
            self._peers.move_to_end(peer)
            while len(nonces) > self.max_per_peer:
                nonces.popitem(last=False)
            return False

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "peers": len(self._peers),
                "nonces": sum(len(n) for n in self._peers.values()),
                "replays_rejected": self.replays_rejected,
            }


def _mac(
    secret: str, method: str, path_qs: str, ts: str, nonce: str,
    peer: str, body: bytes,
) -> str:
    message = "\n".join(
        (
            method.upper(), path_qs, ts, nonce, peer,
            hashlib.sha256(body).hexdigest(),
        )
    ).encode()
    return hmac.new(secret.encode(), message, hashlib.sha256).hexdigest()


def sign(
    secret: str,
    method: str,
    path_qs: str,
    body: bytes = b"",
    now: Optional[float] = None,
    nonce: Optional[str] = None,
    peer: str = "-",
) -> str:
    """The ``X-OMPB-Sig`` header value for one outbound exchange;
    ``peer`` must equal the ``X-OMPB-Peer`` header the request will
    carry (``-`` when it carries none). A fresh random nonce is
    minted per call — two signings of the same request are distinct
    header values, so a legitimate re-send (a purge retried by its
    caller) never collides with its own past."""
    ts = str(int(time.time() if now is None else now))
    if nonce is None:
        nonce = _secrets.token_hex(_NONCE_HEX_LEN // 2)
    return (
        f"{_VERSION}:{ts}:{nonce}:"
        f"{_mac(secret, method, path_qs, ts, nonce, peer, body)}"
    )


def verify(
    secret: str,
    header_value: Optional[str],
    method: str,
    path_qs: str,
    body: bytes = b"",
    skew_s: float = DEFAULT_SKEW_S,
    now: Optional[float] = None,
    nonce_cache: Optional[NonceCache] = None,
    peer: str = "-",
) -> bool:
    """True iff ``header_value`` authenticates the exchange: well-
    formed v2, inside the clock-skew window, a constant-time MAC
    match over (method, path, ts, nonce, PEER, body-digest) — the
    claimed peer identity is inside the MAC, so the nonce cache's
    per-peer keying cannot be dodged by rotating the header — and,
    when a ``nonce_cache`` is supplied, a nonce this verifier has
    not accepted before (the replay guard; the nonce is recorded
    only after the MAC checks out). Never raises — a malformed
    header is simply False."""
    if not secret or not header_value:
        return False
    parts = header_value.split(":")
    if len(parts) != 4 or parts[0] != _VERSION:
        return False  # v1 (and anything else) is rejected: no nonce,
        #               no replay protection
    _, ts, nonce, mac = parts
    if not nonce or len(nonce) > 64:
        return False
    try:
        ts_val = float(ts)
    except (TypeError, ValueError):
        return False
    wall = time.time() if now is None else now
    if abs(wall - ts_val) > skew_s:
        return False
    expected = _mac(secret, method, path_qs, ts, nonce, peer, body)
    if not hmac.compare_digest(expected, mac):
        return False
    if nonce_cache is not None and nonce_cache.seen_or_record(
        peer, nonce, now=wall
    ):
        return False  # verbatim replay inside the window
    return True


# --------------------------------------------------------------- values
#
# Coordination VALUES stored in Redis (membership leases, fleet
# brains) are a second trust surface: anyone who can reach Redis can
# SET a lease key and join the ring, or plant a brain payload and
# steer suspicion. Sealing binds each stored value to the cluster
# secret so reaching Redis no longer grants membership — a reader
# that verifies discards anything unsealed or tampered. Epoch
# counters cannot be sealed (they are bare INCR integers); poisoning
# one forces re-renders but never wrong bytes, which is the accepted
# residual (see KNOWN_GAPS).

_SEAL_VERSION = b"s1"


def seal(secret: str, payload: bytes) -> bytes:
    """Wrap ``payload`` as ``s1:<hex hmac-sha256>:<payload>`` under
    ``secret``. With no secret configured the payload passes through
    unchanged (back-compat with unsigned fleets)."""
    if not secret:
        return payload
    mac = hmac.new(secret.encode(), payload, hashlib.sha256).hexdigest()
    return _SEAL_VERSION + b":" + mac.encode() + b":" + payload


def unseal(secret: str, raw: Optional[bytes]) -> Optional[bytes]:
    """The payload inside a sealed value, or ``None`` when the seal
    is missing, malformed, or fails the constant-time MAC check.
    With no secret configured the raw value passes through (the
    unsigned posture). Never raises."""
    if raw is None:
        return None
    if not secret:
        return raw
    if not raw.startswith(_SEAL_VERSION + b":"):
        return None
    rest = raw[len(_SEAL_VERSION) + 1:]
    sep = rest.find(b":")
    if sep != 64:  # hex sha256 is exactly 64 bytes
        return None
    mac, payload = rest[:sep], rest[sep + 1:]
    expected = hmac.new(
        secret.encode(), payload, hashlib.sha256
    ).hexdigest().encode()
    if not hmac.compare_digest(expected, mac):
        return None
    return payload
