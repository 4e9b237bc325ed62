"""Coordination link — the cluster plane's own RESP2 connection.

(Copy of ``omero_ms_pixel_buffer_tpu/cluster/link.py``.)

Membership leases, epoch bumps, and brain publishes all talk to the
same Redis the L2 tier uses, but over their OWN connection: the L2
client serializes commands under a lock, and a background membership
SCAN must never head-of-line-block a serving-path tile GET (nor the
other way around — a slow tile body must not delay a lease refresh
past its TTL).

Same client shape as the L2 tier and the auth store (no redis package
in this environment): one connection, commands serialized, reconnect-
once on transport error. The resilience contract matches every other
remote edge — ``cluster:coord`` breaker, ``cluster.coord`` fault
point, per-call io timeout. ``command`` RAISES on failure; every
caller in this package degrades (keep the last-known ring, skip a
brain round) rather than surfacing anything to a request.
"""

from __future__ import annotations

import asyncio
import logging
import time
from urllib.parse import urlparse

from ..resilience.breaker import for_dependency
from ..resilience.faultinject import INJECTOR
from ..resilience.timeouts import io_timeout_s
from ..utils.connstate import ConnState

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.cluster")


class RedisLink:
    """The guarded RESP2 exchange the coordination modules share."""

    def __init__(self, uri: str):
        parsed = urlparse(uri)
        self.host = parsed.hostname or "localhost"
        self.port = parsed.port or 6379
        self.db = int(parsed.path.lstrip("/") or 0) if parsed.path else 0
        self.password = parsed.password
        # transport state in the one holder (utils/connstate):
        # exchanges run under the op lock, teardown runs lock-free
        # off the terminal `closed` flag
        self._conn = ConnState()
        self._lock = asyncio.Lock()
        self.breaker = for_dependency("cluster:coord")

    async def _connect(self) -> None:
        reader, writer = await asyncio.open_connection(
            self.host, self.port
        )
        self._conn.attach(reader, writer)
        if self.password:
            await self._command(b"AUTH", self.password.encode())
        if self.db:
            await self._command(b"SELECT", str(self.db).encode())

    async def _command(self, *parts: bytes):
        w, r = self._conn.writer, self._conn.reader
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

    async def _exchange(self, *parts: bytes):
        async with self._lock:
            if self._conn.closed:
                raise ConnectionError("coordination link closed")
            if not self._conn.connected:
                await self._connect()
            try:
                return await self._command(*parts)
            except (ConnectionError, EOFError, OSError,
                    asyncio.IncompleteReadError):
                await self._reset()
                return await self._command(*parts)

    async def _reset(self) -> None:
        self._conn.drop()
        await self._connect()

    async def command(self, *parts: bytes):
        """One guarded round trip: breaker gate, fault point, per-call
        timeout, slow-call accounting. Raises on breaker-open, fault,
        timeout, and transport error — callers degrade."""
        self.breaker.allow()
        t0 = time.monotonic()
        try:
            await INJECTOR.fire_async("cluster.coord")
            timeout = io_timeout_s()
            if timeout > 0:
                result = await asyncio.wait_for(
                    self._exchange(*parts), timeout
                )
            else:
                result = await self._exchange(*parts)
        except asyncio.TimeoutError:
            # mid-protocol desync: drop the connection so the next
            # call starts clean instead of reading a stale reply (the
            # holder's drop is a lock-free atomic swap)
            self._conn.drop()
            self.breaker.record_failure()
            raise
        except (ConnectionError, EOFError, OSError,
                asyncio.IncompleteReadError):
            self.breaker.record_failure()
            raise
        except RuntimeError:
            # a redis ERROR reply is an answer — the store is up
            self.breaker.record_success(duration_s=time.monotonic() - t0)
            raise
        self.breaker.record_success(duration_s=time.monotonic() - t0)
        return result

    async def scan_keys(self, pattern: bytes, limit: int = 4096) -> list:
        """Cursor SCAN with a MATCH, bounded round trips; the live
        keys as a list of bytes. Raises like ``command``."""
        keys: list = []
        cursor = b"0"
        for _ in range(256):  # hard bound on SCAN round trips
            reply = await self.command(
                b"SCAN", cursor, b"MATCH", pattern, b"COUNT", b"512",
            )
            cursor, batch = reply[0], reply[1]
            keys.extend(batch)
            if cursor == b"0" or len(keys) >= limit:
                break
        return keys[:limit]

    async def close(self) -> None:
        """Terminal teardown: lock-free closed-flag + drop (utils/
        connstate) — never parked behind a wedged exchange."""
        writer = self._conn.close()
        if writer is not None:
            try:
                await writer.wait_closed()
            except Exception:
                pass

    def snapshot(self) -> dict:
        return {
            "host": self.host,
            "port": self.port,
            "breaker": self.breaker.state,
        }
