"""OMERO.web session stores (a copy of
``omero_ms_pixel_buffer_tpu/auth/stores.py``, the PyTorch port's own: it
imports nothing of the JAX package).

Replaces omero-ms-core's ``OmeroWebSessionStore`` family
(PixelBufferMicroserviceVerticle.java:262-276): async lookup of the
browser's Django ``sessionid`` cookie in the store OMERO.web writes
to, yielding the OMERO session key — or None, which the request
handler turns into a 403.

- ``MemorySessionStore`` — tests/dev (and the `memory` config type).
- ``RedisSessionStore`` — the ``OmeroWebRedisSessionStore`` analog:
  a minimal asyncio RESP2 client (no redis package in the
  environment); reads Django cache-backend keys
  ``:<version>:django.cache:<KEY_PREFIX>:<sessionid>`` patterns,
  configurable, and decodes the pickled session via auth.django.
- ``PostgresSessionStore`` — the ``OmeroWebJDBCSessionStore`` analog:
  reads Django's ``django_session`` table over the in-tree Postgres
  wire-protocol client (db/postgres.py; no external driver needed).
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, Optional
from urllib.parse import urlparse

from ..errors import ServiceUnavailableError
from ..resilience.breaker import BreakerOpenError, for_dependency
from ..resilience.faultinject import INJECTOR
from ..resilience.timeouts import io_timeout_s
from ..utils.connstate import ConnState
from .django import decode_session_payload, extract_omero_session_key

# Store-down (breaker open / backend unreachable) raises
# errors.ServiceUnavailableError — the same 503 + Retry-After contract
# the Ice edge uses. Distinct from an unknown session (-> 403): auth
# *unavailable* must not read as auth *denied*.


class OmeroWebSessionStore:
    async def get_omero_session_key(self, session_id: str) -> Optional[str]:
        raise NotImplementedError

    async def close(self) -> None:  # stop() contract
        pass


class MemorySessionStore(OmeroWebSessionStore):
    def __init__(self, sessions: Optional[Dict[str, str]] = None):
        # session_id -> omero session key
        self.sessions: Dict[str, str] = dict(sessions or {})

    def put(self, session_id: str, omero_session_key: str) -> None:
        self.sessions[session_id] = omero_session_key

    async def get_omero_session_key(self, session_id: str) -> Optional[str]:
        return self.sessions.get(session_id)


# connections a RedisSessionStore keeps: lookups run concurrently up to
# this many (the JAX store's one connection serialized every request's
# session check behind the one before it)
REDIS_CONNECTIONS = 8


class RedisSessionStore(OmeroWebSessionStore):
    """Minimal RESP2 GET client over asyncio streams.

    Key layout: Django's cache session backend writes
    ``:{version}:{prefix}{session_id}``; OMERO.web's default is
    version 1 with prefix ``django.contrib.sessions.cache``. Both are
    overridable; several candidate patterns are probed so deployments
    with custom ``KEY_PREFIX`` still resolve.

    Up to ``REDIS_CONNECTIONS`` lookups run at once, each on a
    connection of its own (AUTH and SELECT sent when it opens); a lookup
    holds its connection for its whole exchange, so the per-connection
    protocol stays strictly request-reply, as in the JAX store, which
    keeps one.
    """

    def __init__(self, uri: str, key_patterns: Optional[list] = None):
        parsed = urlparse(uri)
        self.host = parsed.hostname or "localhost"
        self.port = parsed.port or 6379
        self.db = int(parsed.path.lstrip("/") or 0) if parsed.path else 0
        self.password = parsed.password
        self.key_patterns = key_patterns or [
            ":1:django.contrib.sessions.cache{sid}",
            ":1:django.contrib.sessions.cached_db{sid}",
            "{sid}",
        ]
        # transport state in one holder per connection (utils/connstate);
        # a lookup takes the idle one used last (connections open only as
        # concurrency needs them), or waits for one
        self._conns = [ConnState() for _ in range(REDIS_CONNECTIONS)]
        self._idle: asyncio.LifoQueue = asyncio.LifoQueue()
        for conn in self._conns:
            self._idle.put_nowait(conn)
        self._closed = False
        self.breaker = for_dependency(
            f"session-store:redis:{self.host}:{self.port}"
        )

    async def _connect(self, conn: ConnState) -> None:
        reader, writer = await asyncio.open_connection(
            self.host, self.port
        )
        conn.attach(reader, writer)
        if self.password:
            await self._command(conn, b"AUTH", self.password.encode())
        if self.db:
            await self._command(conn, b"SELECT", str(self.db).encode())

    async def _command(self, conn: ConnState, *parts: bytes):
        w, r = conn.writer, conn.reader
        out = b"*%d\r\n" % len(parts)
        for p in parts:
            out += b"$%d\r\n%s\r\n" % (len(p), p)
        w.write(out)
        await w.drain()
        return await self._read_reply(r)

    async def _read_reply(self, r: asyncio.StreamReader):
        line = (await r.readline()).rstrip(b"\r\n")
        if not line:
            raise ConnectionError("redis connection closed")
        marker, rest = line[:1], line[1:]
        if marker in (b"+", b":"):
            return rest
        if marker == b"-":
            raise RuntimeError(f"redis error: {rest.decode()}")
        if marker == b"$":
            n = int(rest)
            if n == -1:
                return None
            data = await r.readexactly(n + 2)
            return data[:-2]
        if marker == b"*":
            n = int(rest)
            return [await self._read_reply(r) for _ in range(n)]
        raise RuntimeError(f"unexpected redis reply: {line!r}")

    async def _reset(self, conn: ConnState) -> None:
        conn.drop()  # the dead/desynced transport
        await self._connect(conn)

    async def get_omero_session_key(self, session_id: str) -> Optional[str]:
        try:
            self.breaker.allow()
        except BreakerOpenError as e:
            raise ServiceUnavailableError(
                f"Session store unavailable: {e}",
                retry_after_s=e.retry_after_s,
            ) from None
        t0 = time.monotonic()  # slow-call input (chaos latency included)
        try:
            # per-call cap (resilience/timeouts): one lookup exchange
            # — connect + GET probes, injected chaos latency included
            # — is bounded; a Redis that stops answering fails (and
            # feeds the breaker) like one that refuses connections
            timeout = io_timeout_s()
            if timeout > 0:
                result = await asyncio.wait_for(
                    self._faulted_lookup(session_id), timeout
                )
            else:
                result = await self._faulted_lookup(session_id)
        except asyncio.TimeoutError:
            # the cancelled lookup dropped its desynced connection
            self.breaker.record_failure()
            raise
        except (ConnectionError, EOFError, OSError,
                asyncio.IncompleteReadError):
            # transport outage: breaker input
            self.breaker.record_failure()
            raise
        except RuntimeError:
            # a redis error reply (_read_reply) is an answer — the
            # store is up; success also releases a half-open probe
            self.breaker.record_success(
                duration_s=time.monotonic() - t0
            )
            raise
        self.breaker.record_success(duration_s=time.monotonic() - t0)
        return result

    async def _faulted_lookup(self, session_id: str) -> Optional[str]:
        """Fault point + lookup under ONE clock, so injected chaos
        latency counts against the per-call timeout like real network
        stall would."""
        await INJECTOR.fire_async("session_store")
        return await self._lookup(session_id)

    async def _lookup(self, session_id: str) -> Optional[str]:
        conn = await self._idle.get()
        try:
            if self._closed:
                raise ConnectionError("session store closed")
            return await self._lookup_on(conn, session_id)
        except BaseException:
            # an exchange cut short (an error, or the timeout's
            # cancellation) leaves the connection desynced
            conn.drop()
            raise
        finally:
            self._idle.put_nowait(conn)

    async def _lookup_on(self, conn: ConnState, session_id: str) -> Optional[str]:
        if not conn.connected:
            await self._connect(conn)
        for pattern in self.key_patterns:
            key = pattern.format(sid=session_id)
            try:
                raw = await self._command(conn, b"GET", key.encode())
            except (ConnectionError, EOFError, OSError,
                    asyncio.IncompleteReadError):
                await self._reset(conn)
                raw = await self._command(conn, b"GET", key.encode())
            if raw is None:
                continue
            session = decode_session_payload(raw)
            if session is None:
                continue
            key_out = extract_omero_session_key(session)
            if key_out:
                return key_out
        return None

    async def close(self) -> None:
        """Terminal teardown: lock-free closed flags + drops (utils/
        connstate) — never parked behind a wedged lookup; a lookup
        arriving later raises instead of reconnecting."""
        self._closed = True
        for conn in self._conns:
            writer = conn.close()
            if writer is not None:
                try:
                    await writer.wait_closed()
                except Exception:
                    pass


class EchoSessionStore(OmeroWebSessionStore):
    """Dev/bench-only store: any ``sessionid`` cookie is accepted and
    becomes its own OMERO session key. Never use in production — it
    turns auth off (the reference has no equivalent; curl testing
    against it mirrors README.md:129-144 without an OMERO.web)."""

    async def get_omero_session_key(self, session_id: str) -> Optional[str]:
        return session_id or None


class PostgresSessionStore(OmeroWebSessionStore):
    """The ``OmeroWebJDBCSessionStore`` analog: look the Django session
    row up in OMERO.web's Postgres session table over the in-tree wire
    protocol client (db/postgres.py — no external driver exists in
    this environment, mirroring the RESP2 approach above).

    Django's ``django_session`` schema: ``session_key`` (PK),
    ``session_data`` (base64 text payload), ``expire_date``. Expired
    rows are treated as absent, like Django itself does."""

    QUERY = (
        "SELECT session_data FROM django_session "
        "WHERE session_key = $1 AND expire_date > now()"
    )

    def __init__(self, uri: str):
        from ..db.postgres import PostgresClient

        self._client = PostgresClient.from_uri(uri)
        # breaker accounting lives on the PostgresClient; exposed here
        # so /healthz and tests see the session store's dependency
        self.breaker = self._client.breaker

    async def get_omero_session_key(self, session_id: str) -> Optional[str]:
        from ..db.postgres import PostgresUnavailableError

        await INJECTOR.fire_async("session_store")
        try:
            rows = await self._client.query(self.QUERY, [session_id])
        except PostgresUnavailableError as e:
            raise ServiceUnavailableError(
                f"Session store unavailable: {e}",
                retry_after_s=e.retry_after_s,
            ) from None
        if not rows or rows[0][0] is None:
            return None
        session = decode_session_payload(rows[0][0].encode())
        if session is None:
            return None
        return extract_omero_session_key(session)

    async def close(self) -> None:
        await self._client.close()


def make_session_store(store_type: str, uri: Optional[str]) -> OmeroWebSessionStore:
    """Factory mirroring the reference's type dispatch
    (PixelBufferMicroserviceVerticle.java:264-273)."""
    if store_type == "redis":
        return RedisSessionStore(uri or "redis://localhost:6379/0")
    if store_type == "postgres":
        return PostgresSessionStore(
            uri or "postgresql://omero@localhost:5432/omero_web"
        )
    if store_type == "memory":
        return MemorySessionStore()
    raise ValueError(
        "Missing/invalid value for 'session-store.type' in config"
    )
