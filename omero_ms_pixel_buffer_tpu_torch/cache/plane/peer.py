"""Peer fetch — one bounded internal GET to a tile's owner.

(Copy of ``omero_ms_pixel_buffer_tpu/cache/plane/peer.py``.)

A replica that misses locally (and in L2) on a tile it does NOT own
asks the owner once before rendering locally. The owner serves from
its cache or renders exactly once (its local single-flight coalesces
concurrent peer fetches with its own traffic), which makes the
single-flight dedupe effectively cross-process: a popular tile going
cold cluster-wide is rendered by one process, not N.

The client is a deliberately minimal HTTP/1.1 GET over asyncio streams
(the RESP/Postgres wire-client precedent — and it keeps the whole
exchange inside one ``asyncio.wait_for`` window):

- ``X-OMPB-Peer: <self-url>`` marks the hop; the receiving server
  treats any request carrying it as terminal (serve locally, never
  re-forward), so ownership disagreements between replicas mid-config-
  change cost one extra render, never a forwarding loop;
- the browser's ``sessionid`` cookie is forwarded verbatim, so the
  owner applies the same session auth + ACL path it applies to direct
  traffic — peer fetch grants nothing the caller could not get itself;
- the deadline is short (``cluster.peer-timeout-ms``) and the whole
  exchange — connect, request, response — sits under it;
- each member gets its own ``cache:peer:<host:port>`` breaker (one
  dead peer must not stop fetches to the others) and the shared
  ``cache.peer`` fault point drives the chaos suite.

Every failure degrades to "render locally" — exactly today's
single-process behavior.
"""

from __future__ import annotations

import asyncio
import logging
import re
import time
from typing import Dict, Optional, Tuple
from urllib.parse import urlparse

from ...resilience.breaker import BreakerOpenError, for_dependency
from ...resilience.faultinject import INJECTOR
from ...utils.metrics import REGISTRY

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.cache.plane")

PEER_REQUESTS = REGISTRY.counter(
    "tile_cache_peer_requests_total",
    "Peer-fetch attempts by outcome",
)

PEER_HEADER = "X-OMPB-Peer"
# Trace continuity across the hop (obs/recorder): the requester's
# trace id + its root span id ride the peer GET, and the owner's
# flight record JOINS the trace instead of minting a new one — one
# trace spans requester and owner. Honored only together with the
# peer marker (the same network-trust surface as /internal/*, and —
# with cluster.secret configured — HMAC-authenticated like it).
TRACE_HEADER = "X-OMPB-Trace-Id"
TRACE_PARENT_HEADER = "X-OMPB-Trace-Span"
# The image epoch the requester observed in its L2 consult, forwarded
# on the owner hop so the owner's fill stamps the REQUESTER's
# pre-render snapshot (cluster/epochs.py) without an extra Redis RTT
# on the owner's serving path. Purge fan-outs carry the new epoch on
# the same header so receivers advance their local high-water mark.
EPOCH_HEADER = "X-OMPB-Epoch"
# Replica pushes (POST /internal/replica) name their cache key here —
# result-cache keys are pure ASCII (img=..|..|q=..), header-safe.
KEY_HEADER = "X-OMPB-Key"
_MAX_BODY = 64 << 20  # hard bound on a peer reply body
_FILENAME_RE = re.compile(r'filename="([^"]*)"')


def filename_from_disposition(value: str) -> str:
    m = _FILENAME_RE.search(value or "")
    return m.group(1) if m else ""


class PeerClient:
    """Issues the bounded internal GETs. One instance per process;
    connections are per-call (Connection: close) — peer fetches are
    rare (only non-owner cold misses) so a pool would be dead weight."""

    def __init__(
        self, self_url: str, timeout_s: float = 0.5,
        secret: Optional[str] = None,
    ):
        self.self_url = self_url
        self.timeout_s = timeout_s
        # cluster.secret: every outbound exchange (peer fetch included
        # — it carries the trusted peer marker) is HMAC-signed so the
        # receiving side can reject forged cluster identity
        self.secret = secret
        self._breakers: Dict[str, object] = {}
        # per-member failure counts since the last take — the quality-
        # suspicion signal (cluster/suspect): a peer this client keeps
        # failing against is observably sick whatever its lease says
        self._failures: Dict[str, int] = {}

    #: per-member breaker map cap: member URLs churn with the fleet,
    #: and an unbounded map would hold a breaker for every ex-member a
    #: long-lived replica has ever seen. Far above any real ring size.
    _MAX_BREAKERS = 256

    def _breaker(self, member: str):
        b = self._breakers.get(member)
        if b is None:
            netloc = urlparse(member).netloc or member
            b = for_dependency(f"cache:peer:{netloc}")
            # oldest-inserted evicted first; a re-appearing member
            # simply re-registers (for_dependency returns the same
            # shared breaker for the same dependency name)
            while len(self._breakers) >= self._MAX_BREAKERS:
                self._breakers.pop(next(iter(self._breakers)))
            self._breakers[member] = b
        return b

    async def _bounded(
        self,
        member: str,
        method: str,
        path_qs: str,
        session_cookie: Optional[str] = None,
        trace_context: Optional[Dict[str, str]] = None,
        body: bytes = b"",
        extra_headers: Optional[Dict[str, str]] = None,
        outcome_prefix: str = "",
    ) -> Optional[Tuple[int, Dict[str, str], bytes]]:
        """One guarded exchange — the shared breaker/fault/timeout
        wrapper every peer operation rides. None on open breaker,
        fault, timeout, or transport failure."""
        breaker = self._breaker(member)
        try:
            breaker.allow()
        except BreakerOpenError:
            PEER_REQUESTS.inc(outcome=outcome_prefix + "breaker_open")
            return None
        t0 = time.monotonic()
        try:
            await INJECTOR.fire_async("cache.peer")
            result = await asyncio.wait_for(
                self._exchange(
                    member, method, path_qs, session_cookie,
                    trace_context=trace_context, body=body,
                    extra_headers=extra_headers,
                ),
                self.timeout_s,
            )
        except asyncio.CancelledError:
            raise
        except Exception:
            breaker.record_failure()
            self._failures[member] = self._failures.get(member, 0) + 1
            PEER_REQUESTS.inc(outcome=outcome_prefix + "error")
            return None
        breaker.record_success(duration_s=time.monotonic() - t0)
        return result

    def take_failures(self) -> Dict[str, int]:
        """Per-member failure counts since the last take (reset on
        read) — one brain-heartbeat window's worth of peer-observed
        sickness (cluster/suspect.py). Breaker-open rejections do NOT
        count: an open breaker already stopped observing, and counting
        its fast-fails would keep a recovered peer demoted forever."""
        taken, self._failures = self._failures, {}
        return taken

    async def fetch(
        self,
        member: str,
        path_qs: str,
        session_cookie: Optional[str],
        trace_context: Optional[Dict[str, str]] = None,
        epoch_hint: Optional[int] = None,
    ) -> Optional[Tuple[int, Dict[str, str], bytes]]:
        """GET ``path_qs`` from ``member``; ``(status, headers, body)``
        on an HTTP-complete exchange, None on any transport failure,
        timeout, or open breaker (the caller renders locally).
        ``trace_context`` ({trace_id, span_id}) injects the requester's
        trace onto the hop so the owner's record joins it;
        ``epoch_hint`` forwards the requester's observed image epoch
        so the owner's fill stamps the pre-render snapshot."""
        extra = None
        if epoch_hint is not None:
            extra = {EPOCH_HEADER: str(int(epoch_hint))}
        return await self._bounded(
            member, "GET", path_qs, session_cookie,
            trace_context=trace_context, extra_headers=extra,
        )

    async def purge(
        self, member: str, image_id: int,
        epoch: Optional[int] = None,
    ) -> bool:
        """Best-effort invalidation fan-out: POST the internal purge
        endpoint on one peer (``epoch`` rides along so the receiver
        advances its local epoch high-water mark). False (never an
        exception) on failure — a dead peer must not block anyone's
        local purge."""
        extra = None
        if epoch is not None:
            extra = {EPOCH_HEADER: str(int(epoch))}
        result = await self._bounded(
            member, "POST", f"/internal/purge/{int(image_id)}",
            extra_headers=extra, outcome_prefix="purge_",
        )
        if result is None:
            return False
        ok = result[0] == 200
        PEER_REQUESTS.inc(
            outcome="purge_ok" if ok else "purge_rejected"
        )
        return ok

    async def push_replica(
        self, member: str, key: str, frame: bytes
    ) -> bool:
        """Next-owner replication: POST one hot entry's L2 frame to a
        ring successor (cluster/replicate.py). Best-effort — False on
        any failure or a non-200 answer."""
        result = await self._bounded(
            member, "POST", "/internal/replica",
            body=frame, extra_headers={KEY_HEADER: key},
            outcome_prefix="replica_",
        )
        if result is None:
            return False  # _bounded already counted the failure
        ok = result[0] == 200
        PEER_REQUESTS.inc(
            outcome="replica_ok" if ok else "replica_rejected"
        )
        return ok

    async def pull_transfer(
        self, member: str, limit: int
    ) -> Optional[bytes]:
        """Join-time warm-up: GET one peer's hot-set transfer payload.
        None on any failure (the joiner simply starts cold toward that
        peer)."""
        result = await self._bounded(
            member, "GET", f"/internal/transfer?limit={int(limit)}",
            outcome_prefix="transfer_",
        )
        if result is None:
            return None  # _bounded already counted the failure
        if result[0] != 200:
            PEER_REQUESTS.inc(outcome="transfer_rejected")
            return None
        PEER_REQUESTS.inc(outcome="transfer_ok")
        return result[2]

    async def push_handoff(self, member: str, payload: bytes) -> bool:
        """Graceful-drain handoff (cluster/lifecycle.py): POST one
        transfer-framed batch of this replica's RAM hot set to a
        post-drain owner. Best-effort — a dead successor costs its
        batch (those keys re-render once), never the drain."""
        result = await self._bounded(
            member, "POST", "/internal/handoff",
            body=payload, outcome_prefix="handoff_",
        )
        if result is None:
            return False
        ok = result[0] == 200
        PEER_REQUESTS.inc(
            outcome="handoff_ok" if ok else "handoff_rejected"
        )
        return ok

    async def push_session_handoff(
        self, member: str, payload: bytes
    ) -> bool:
        """Session-plane drain handoff (session/channels.py): POST the
        draining replica's live-channel subscription summary to its
        successor as JSON on the same authenticated ``/internal/handoff``
        surface cache batches ride — the receiver routes on content
        type. Best-effort: a dead successor costs nothing durable
        (clients reconnect and re-subscribe), never the drain."""
        result = await self._bounded(
            member, "POST", "/internal/handoff",
            body=payload,
            extra_headers={"Content-Type": "application/json"},
            outcome_prefix="session_handoff_",
        )
        if result is None:
            return False
        ok = result[0] == 200
        PEER_REQUESTS.inc(
            outcome="session_handoff_ok" if ok
            else "session_handoff_rejected"
        )
        return ok

    async def get_digest(
        self, member: str, limit: int
    ) -> Optional[bytes]:
        """Anti-entropy round, step 1 (cluster/repair.py): one peer's
        compact hot-set digest. None on any failure (the round is
        skipped; the next rotation retries)."""
        result = await self._bounded(
            member, "GET", f"/internal/digest?limit={int(limit)}",
            outcome_prefix="digest_",
        )
        if result is None or result[0] != 200:
            if result is not None:
                PEER_REQUESTS.inc(outcome="digest_rejected")
            return None
        PEER_REQUESTS.inc(outcome="digest_ok")
        return result[2]

    async def gossip(
        self, member: str, payload: bytes
    ) -> Optional[dict]:
        """One push-pull gossip exchange (cluster/gossip.py): POST
        our digest, return the peer's parsed digest reply. None on
        any transport failure, non-200, or an unparseable reply —
        the round simply skips that target. Rides the shared
        breaker/fault/timeout wrapper like every other peer op."""
        import json as _json

        result = await self._bounded(
            member, "POST", "/internal/gossip",
            body=payload, extra_headers={
                "Content-Type": "application/json"
            },
            outcome_prefix="gossip_",
        )
        if result is None or result[0] != 200:
            if result is not None:
                PEER_REQUESTS.inc(outcome="gossip_rejected")
            return None
        try:
            reply = _json.loads(result[2])
        except Exception:
            PEER_REQUESTS.inc(outcome="gossip_rejected")
            return None
        if not isinstance(reply, dict):
            PEER_REQUESTS.inc(outcome="gossip_rejected")
            return None
        PEER_REQUESTS.inc(outcome="gossip_ok")
        return reply

    async def get_json(
        self, member: str, path_qs: str
    ) -> Optional[dict]:
        """One signed GET expecting a JSON object — the fleet-wide
        debug scatter-gather (``/debug/requests?fleet=1``). None on
        any failure; the member's column simply reads absent."""
        import json as _json

        result = await self._bounded(
            member, "GET", path_qs, outcome_prefix="json_",
        )
        if result is None or result[0] != 200:
            return None
        try:
            reply = _json.loads(result[2])
        except Exception:
            return None
        return reply if isinstance(reply, dict) else None

    async def pull_keys(
        self, member: str, keys: list
    ) -> Optional[bytes]:
        """Anti-entropy round, step 3: the missing entries, transfer-
        framed. The key list rides a JSON body (cache keys are long;
        a query string would not bound them)."""
        import json as _json

        body = _json.dumps({"keys": list(keys)}).encode()
        result = await self._bounded(
            member, "POST", "/internal/pull",
            body=body, extra_headers={
                "Content-Type": "application/json"
            },
            outcome_prefix="pull_",
        )
        if result is None or result[0] != 200:
            if result is not None:
                PEER_REQUESTS.inc(outcome="pull_rejected")
            return None
        PEER_REQUESTS.inc(outcome="pull_ok")
        return result[2]

    async def _exchange(
        self,
        member: str,
        method: str,
        path_qs: str,
        session_cookie: Optional[str],
        trace_context: Optional[Dict[str, str]] = None,
        body: bytes = b"",
        extra_headers: Optional[Dict[str, str]] = None,
    ) -> Tuple[int, Dict[str, str], bytes]:
        parsed = urlparse(member)
        host = parsed.hostname or "localhost"
        port = parsed.port or 80
        reader, writer = await asyncio.open_connection(host, port)  # ompb-lint: disable=resilience-coverage -- deliberately single-attempt: every peer op has a cheap local fallback (render locally, skip the round, expire by TTL) that a retry would only delay — the short peer timeout IS the tail bound, and a redial would spend it twice
        try:
            lines = [
                f"{method} {path_qs} HTTP/1.1",
                f"Host: {parsed.netloc}",
                f"{PEER_HEADER}: {self.self_url}",
                "Connection: close",
                "Accept-Encoding: identity",
                f"Content-Length: {len(body)}",
            ]
            if self.secret:
                from ...cluster.security import SIG_HEADER, sign

                # peer= the X-OMPB-Peer value this request carries:
                # the claimed identity is inside the MAC, so a
                # captured signature cannot be replayed under a
                # rotated peer name
                lines.append(
                    f"{SIG_HEADER}: "
                    f"{sign(self.secret, method, path_qs, body, peer=self.self_url)}"
                )
            if trace_context:
                tid = trace_context.get("trace_id")
                if tid:
                    lines.append(f"{TRACE_HEADER}: {tid}")
                sid = trace_context.get("span_id")
                if sid:
                    lines.append(f"{TRACE_PARENT_HEADER}: {sid}")
            if extra_headers:
                for name, value in extra_headers.items():
                    lines.append(f"{name}: {value}")
            if session_cookie:
                lines.append(f"Cookie: sessionid={session_cookie}")
            writer.write(
                ("\r\n".join(lines) + "\r\n\r\n").encode() + body
            )
            await writer.drain()
            status_line = await reader.readline()
            parts = status_line.decode("latin-1").split(None, 2)
            if len(parts) < 2 or not parts[1].isdigit():
                raise ConnectionError(
                    f"malformed peer status line: {status_line!r}"
                )
            status = int(parts[1])
            headers: Dict[str, str] = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                name, _, value = line.decode("latin-1").partition(":")
                headers[name.strip().lower()] = value.strip()
            length = headers.get("content-length")
            if length is not None:
                n = int(length)
                if n > _MAX_BODY:
                    raise ConnectionError("peer reply too large")
                body = await reader.readexactly(n) if n else b""
            else:
                body = await reader.read(_MAX_BODY)
            return status, headers, body
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass

    def snapshot(self) -> dict:
        return {
            member: getattr(b, "state", "closed")
            for member, b in sorted(self._breakers.items())
        }
