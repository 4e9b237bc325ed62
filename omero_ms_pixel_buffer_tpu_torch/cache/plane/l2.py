"""Shared L2 cache tier — RESP (Redis) between the local tiers and render.

(Copy of ``omero_ms_pixel_buffer_tpu/cache/plane/l2.py``.)

The reference ecosystem shares rendered tiles across replicas through
Redis (omero-ms-image-region's rendered-tile cache); this tier does
the same for this service's encoded tile bodies, keyed by the exact
result-cache key schema (``img=..|..|q=<encode-signature>``) so a
config change on any replica keys fresh entries cluster-wide.

Protocol: the same minimal asyncio RESP2 client machinery as the auth
store (auth/stores.RedisSessionStore — no redis package exists in this
environment): one connection, commands serialized under a lock,
reconnect-once on transport error. Values are framed as
``OMPB1 | u32 header-length | json{etag, fn, wall} | body`` so a hit
reconstructs the complete ``CachedTile`` (validator included — both
replicas must serve byte-identical ETags).

The resilience contract matches the disk tier: a sick Redis must never
fail a request. Every operation is gated by the ``cache:l2`` breaker,
carries the ``cache.l2`` fault point, and is bounded by the per-call
io timeout; any failure reads as a miss (get), a no-op (put/delete),
and a breaker input. TTLs (``cluster.l2.ttl-s``) bound staleness for
entries written by replicas that die before an invalidation reaches
Redis.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import List, Optional, Tuple
from urllib.parse import urlparse

from ...cluster.integrity import INTEGRITY_FAILS, body_matches
from ...resilience.breaker import BreakerOpenError, for_dependency
from ...resilience.faultinject import INJECTOR
from ...resilience.timeouts import io_timeout_s
from ...utils.connstate import ConnState
from ...utils.metrics import REGISTRY
from ..result_cache import CachedTile

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.cache.plane")

L2_REQUESTS = REGISTRY.counter(
    "tile_cache_l2_requests_total",
    "Shared L2 (Redis) tier operations by op and outcome",
)

_MAGIC = b"OMPB1"
KEY_PREFIX = "ompb:tile:"


def encode_entry(
    entry: CachedTile, epoch: Optional[int] = None
) -> bytes:
    header_fields = {
        "etag": entry.etag,
        "fn": entry.filename,
        "wall": time.time() - max(
            0.0, time.monotonic() - entry.stored_at
        ),
    }
    if epoch is not None:
        # the image epoch the writer observed BEFORE its render began
        # (cluster/epochs.py) — a purge that lands mid-flight bumps
        # past this stamp and the entry arrives already-stale
        header_fields["ep"] = int(epoch)
    header = json.dumps(header_fields, separators=(",", ":")).encode()
    return _MAGIC + len(header).to_bytes(4, "big") + header + entry.body


def decode_entry_epoch(
    raw: bytes,
) -> Tuple[Optional[CachedTile], Optional[int]]:
    """(entry, epoch stamp) — (None, None) on any framing problem: a
    corrupt L2 value is a miss, never an error (and never served).
    An unstamped entry (older writer) decodes with epoch None."""
    try:
        if not raw.startswith(_MAGIC):
            return None, None
        hlen = int.from_bytes(raw[5:9], "big")
        header = json.loads(raw[9:9 + hlen])
        body = bytes(raw[9 + hlen:])
        stored_at = time.monotonic() - max(
            0.0, time.time() - float(header.get("wall") or 0.0)
        )
        epoch = header.get("ep")
        return CachedTile(
            body, etag=header.get("etag"),
            filename=header.get("fn") or "", stored_at=stored_at,
        ), (int(epoch) if epoch is not None else None)
    except Exception:
        return None, None


def decode_entry(raw: bytes) -> Optional[CachedTile]:
    return decode_entry_epoch(raw)[0]


class RedisL2Tier:
    """One RESP2 connection to the shared tier. All public operations
    degrade: they return a miss/no-op on breaker-open, fault, timeout,
    or transport error — the caller never sees an exception."""

    def __init__(
        self,
        uri: str,
        ttl_s: float = 3600.0,
        key_prefix: str = KEY_PREFIX,
        epochs=None,
        verify_bodies: bool = True,
    ):
        parsed = urlparse(uri)
        self.host = parsed.hostname or "localhost"
        self.port = parsed.port or 6379
        self.db = int(parsed.path.lstrip("/") or 0) if parsed.path else 0
        self.password = parsed.password
        self.ttl_s = ttl_s
        self.key_prefix = key_prefix
        # epoch registry (cluster/epochs.py): when present, every GET
        # becomes an MGET of (entry, image-epoch) in ONE round trip,
        # stale-stamped entries read as misses, and PUTs stamp the
        # writer's observed epoch — cluster invalidation stops being
        # TTL-backstopped
        self.epochs = epochs
        # r20 integrity: every served body is re-hashed against the
        # frame's strong ETag — a bit-flipped Redis value (failing
        # RAM on the Redis host, a tampering writer) reads as a miss
        # and the entry is deleted, instead of flowing to a client
        # as a wrong-but-200
        self.verify_bodies = verify_bodies
        self.integrity_fails = 0
        # transport state in the one holder (utils/connstate):
        # exchanges run under the op lock, teardown runs lock-free
        # off the terminal `closed` flag
        self._conn = ConnState()
        self._lock = asyncio.Lock()
        self.breaker = for_dependency("cache:l2")

    # -- RESP2 plumbing (the auth-store client shape) ------------------

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

    async def _reset(self) -> None:
        self._conn.drop()
        await self._connect()

    async def _exchange(self, *parts: bytes):
        """One serialized command with reconnect-once semantics. A
        CLOSED tier raises (reads as a miss upstream) instead of
        reconnecting under the owner's teardown."""
        async with self._lock:
            if self._conn.closed:
                raise ConnectionError("l2 tier closed")
            if not self._conn.connected:
                await self._connect()
            try:
                return await self._command(*parts)
            except (ConnectionError, EOFError, OSError,
                    asyncio.IncompleteReadError):
                await self._reset()
                return await self._command(*parts)

    async def _guarded(self, *parts: bytes):
        """The full resilience wrapper: breaker gate, fault point,
        per-call timeout, slow-call accounting. Raises to the caller
        methods below, which translate every failure into a miss."""
        self.breaker.allow()
        t0 = time.monotonic()
        try:
            await INJECTOR.fire_async("cache.l2")
            timeout = io_timeout_s()
            if timeout > 0:
                result = await asyncio.wait_for(
                    self._exchange(*parts), timeout
                )
            else:
                result = await self._exchange(*parts)
        except asyncio.TimeoutError:
            # mid-protocol connection is desynced: drop it so the next
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
            self.breaker.record_success(
                duration_s=time.monotonic() - t0
            )
            raise
        self.breaker.record_success(duration_s=time.monotonic() - t0)
        return result

    def _key(self, key: str) -> bytes:
        return (self.key_prefix + key).encode()

    # -- tier operations (never raise) ---------------------------------

    async def get(self, key: str) -> Optional[CachedTile]:
        entry, _epoch = await self.get_with_epoch(key)
        return entry

    async def get_with_epoch(
        self, key: str
    ) -> Tuple[Optional[CachedTile], Optional[int]]:
        """(entry-or-None, current image epoch observed in the same
        round trip). The epoch comes back even on a MISS — it is the
        stamp the caller's eventual fill must carry, captured here,
        before the render, so a purge landing mid-flight outruns the
        fill by construction."""
        image_id = None
        if self.epochs is not None:
            from ...cluster.epochs import epoch_key, image_id_of

            image_id = image_id_of(key)
        try:
            if image_id is not None:
                raw, epoch_raw = await self._guarded(
                    b"MGET", self._key(key), epoch_key(image_id)
                )
            else:
                raw = await self._guarded(b"GET", self._key(key))
                epoch_raw = None
        except BreakerOpenError:
            L2_REQUESTS.inc(op="get", outcome="breaker_open")
            return None, None
        except asyncio.CancelledError:
            raise
        except Exception:
            L2_REQUESTS.inc(op="get", outcome="error")
            return None, None
        current_epoch = None
        if epoch_raw is not None:
            try:
                current_epoch = int(epoch_raw)
            except (TypeError, ValueError):
                current_epoch = None
        elif image_id is not None:
            current_epoch = 0  # no counter yet: epoch zero
        if current_epoch is not None and self.epochs is not None:
            self.epochs.note(image_id, current_epoch)
        if raw is None:
            L2_REQUESTS.inc(op="get", outcome="miss")
            return None, current_epoch
        entry, entry_epoch = decode_entry_epoch(raw)
        if entry is None:
            L2_REQUESTS.inc(op="get", outcome="corrupt")
            return None, current_epoch
        if current_epoch is not None and (
            (entry_epoch or 0) < current_epoch
        ):
            # written before the image's latest purge: a stale-epoch
            # read IS a miss — the TTL stops being the backstop
            if self.epochs is not None:
                self.epochs.count_stale()
            L2_REQUESTS.inc(op="get", outcome="stale_epoch")
            return None, current_epoch
        if self.verify_bodies and not body_matches(
            entry.etag, entry.body
        ):
            # the framing decoded but the bytes do not hash to the
            # ETag the writer stamped: corruption between the
            # writer's put and this read. Discard, delete, count —
            # the caller re-renders; wrong bytes are never served.
            self.integrity_fails += 1
            INTEGRITY_FAILS.inc(source="l2")
            L2_REQUESTS.inc(op="get", outcome="integrity_fail")
            await self.delete(key)
            return None, current_epoch
        L2_REQUESTS.inc(op="get", outcome="hit")
        return entry, current_epoch

    async def delete(self, key: str) -> bool:
        """Best-effort DEL of one entry (the integrity path's
        quarantine). False on any failure — the TTL remains the
        backstop."""
        try:
            await self._guarded(b"DEL", self._key(key))
        except asyncio.CancelledError:
            raise
        except Exception:
            L2_REQUESTS.inc(op="delete", outcome="error")
            return False
        L2_REQUESTS.inc(op="delete", outcome="done")
        return True

    async def put(
        self, key: str, entry: CachedTile,
        epoch: Optional[int] = None,
    ) -> bool:
        parts: List[bytes] = [
            b"SET", self._key(key), encode_entry(entry, epoch=epoch),
        ]
        if self.ttl_s > 0:
            parts += [b"PX", str(int(self.ttl_s * 1000)).encode()]
        try:
            await self._guarded(*parts)
        except asyncio.CancelledError:
            raise
        except Exception:
            L2_REQUESTS.inc(op="put", outcome="error")
            return False
        L2_REQUESTS.inc(op="put", outcome="stored")
        return True

    async def delete_image(self, image_id: int) -> int:
        """Best-effort purge of every L2 key of one image: cursor SCAN
        with a MATCH on the key schema's image prefix, DEL in batches.
        Returns how many keys went (0 on any failure)."""
        pattern = (self.key_prefix + f"img={int(image_id)}|*").encode()
        removed = 0
        cursor = b"0"
        try:
            for _ in range(1024):  # hard bound on SCAN round trips
                reply = await self._guarded(
                    b"SCAN", cursor, b"MATCH", pattern,
                    b"COUNT", b"512",
                )
                cursor, keys = reply[0], reply[1]
                if keys:
                    await self._guarded(b"DEL", *keys)
                    removed += len(keys)
                if cursor == b"0":
                    break
        except asyncio.CancelledError:
            raise
        except Exception:
            L2_REQUESTS.inc(op="purge", outcome="error")
            return removed
        L2_REQUESTS.inc(op="purge", outcome="done")
        return removed

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
            "ttl_s": self.ttl_s,
            "breaker": self.breaker.state,
        }
