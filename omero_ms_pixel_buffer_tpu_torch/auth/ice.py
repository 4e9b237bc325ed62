"""Minimal Ice-protocol client for Glacier2 session joins (a copy of
``omero_ms_pixel_buffer_tpu/auth/ice.py``, the PyTorch port's own: it
imports nothing of the JAX package).

The reference validates every request by joining the caller's OMERO
server session over Ice/Glacier2 (omero-ms-core ``OmeroRequest``,
PixelBufferVerticle.java:106-110, dep ``com.zeroc:icegrid``): a
``createSession(key, key)`` against the OMERO Glacier2 router succeeds
iff the session key is alive; ``PermissionDeniedException`` /
``CannotCreateSessionException`` mean an invalid key (-> 403).

No Ice runtime ships in this environment, so — like the Redis and
Postgres clients in this package — the wire protocol is implemented
directly: the Ice protocol 1.0 framing (magic "IceP", little-endian
sizes, ValidateConnection / Request / Reply messages) with encoding
1.1 encapsulations, which is exactly enough for one twoway
``createSession`` call and reading its reply status.

Scope notes:
- TLS ("ssl" endpoints) is plain TLS over the same framing; the
  ``secure`` flag wraps the socket (OMERO defaults to ssl on 4064).
- On success the connection is closed without ``destroySession``;
  Glacier2 reaps the router session on disconnect and the underlying
  OMERO session (which existed before the join) is untouched.
- User-exception bodies are not fully unmarshaled; the exception type
  id strings embedded in the reply distinguish the two 403 cases from
  transport/config errors.
"""

from __future__ import annotations

import asyncio
import ssl as ssl_mod
import struct
import time
from typing import Optional, Tuple

from ..errors import ServiceUnavailableError
from ..resilience.breaker import BreakerOpenError, for_dependency
from ..resilience.faultinject import INJECTOR
from ..resilience.timeouts import io_timeout_s
from .validator import SessionValidator

HEADER_MAGIC = b"IceP"
MSG_REQUEST = 0
MSG_REPLY = 2
MSG_VALIDATE = 3
MSG_CLOSE = 4

REPLY_OK = 0
REPLY_USER_EXCEPTION = 1

ROUTER_CATEGORY = "Glacier2"
ROUTER_NAME = "router"


class IceProtocolError(RuntimeError):
    pass


class IceMarshal:
    """Encoding 1.0/1.1 primitives (little-endian)."""

    def __init__(self):
        self.buf = bytearray()

    def byte(self, v: int) -> "IceMarshal":
        self.buf.append(v & 0xFF)
        return self

    def int32(self, v: int) -> "IceMarshal":
        self.buf += struct.pack("<i", v)
        return self

    def size(self, v: int) -> "IceMarshal":
        if v < 255:
            self.buf.append(v)
        else:
            self.buf.append(255)
            self.buf += struct.pack("<i", v)
        return self

    def string(self, s: str) -> "IceMarshal":
        data = s.encode()
        self.size(len(data))
        self.buf += data
        return self


def _encapsulate(payload: bytes, major: int = 1, minor: int = 1) -> bytes:
    # size includes the 6 bytes of (size, major, minor)
    return struct.pack("<iBB", len(payload) + 6, major, minor) + payload


def build_request(
    request_id: int, identity: Tuple[str, str], operation: str,
    params: bytes, mode: int = 0,
) -> bytes:
    m = IceMarshal()
    m.int32(request_id)
    m.string(identity[1])       # identity.name
    m.string(identity[0])       # identity.category
    m.size(0)                   # facet: empty string sequence
    m.string(operation)
    m.byte(mode)                # OperationMode.Normal
    m.size(0)                   # context: empty dictionary
    body = bytes(m.buf) + _encapsulate(params)
    header = HEADER_MAGIC + bytes(
        [1, 0, 1, 0, MSG_REQUEST, 0]
    ) + struct.pack("<i", 14 + len(body))
    return header + body


def marshal_two_strings(a: str, b: str) -> bytes:
    m = IceMarshal()
    m.string(a)
    m.string(b)
    return bytes(m.buf)


class Glacier2Client:
    """One connection, one purpose: ``createSession`` and report how it
    ended. Exposes the three outcomes the dispatch layer maps to HTTP:
    joined (200 path), denied (403), or a transport/protocol error
    (500)."""

    def __init__(
        self, host: str, port: int = 4064, secure: bool = False,
        timeout_s: Optional[float] = None, verify_tls: bool = True,
    ):
        self.host, self.port = host, port
        self.secure = secure
        # None -> the process-wide per-call I/O timeout
        # (resilience.io-timeout-ms), read per call so configure()
        # at startup takes effect; an explicit value pins it
        self._timeout_s = timeout_s
        self.verify_tls = verify_tls

    @property
    def timeout_s(self) -> float:
        if self._timeout_s is not None:
            return self._timeout_s
        configured = io_timeout_s()
        return configured if configured > 0 else 10.0

    async def _connect(self):
        ssl_ctx = None
        if self.secure:
            ssl_ctx = ssl_mod.create_default_context()
            if not self.verify_tls:
                # Opt-out ONLY (omero.verify-tls: false) for
                # deployments with self-signed router certs. Without
                # verification, an on-path attacker can fake the
                # router's createSession reply — i.e. forge auth — so
                # the default verifies.
                ssl_ctx.check_hostname = False
                ssl_ctx.verify_mode = ssl_mod.CERT_NONE
        return await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port, ssl=ssl_ctx),
            self.timeout_s,
        )

    async def _read_message(self, reader) -> Tuple[int, bytes]:
        header = await asyncio.wait_for(
            reader.readexactly(14), self.timeout_s
        )
        if header[:4] != HEADER_MAGIC:
            raise IceProtocolError(f"bad Ice magic: {header[:4]!r}")
        msg_type = header[8]
        compression = header[9]
        (total,) = struct.unpack("<i", header[10:14])
        if compression not in (0, 1):
            raise IceProtocolError("compressed Ice replies unsupported")
        body = b""
        if total > 14:
            body = await asyncio.wait_for(
                reader.readexactly(total - 14), self.timeout_s
            )
        return msg_type, body

    async def create_session(
        self, user: str, password: str
    ) -> Tuple[bool, Optional[str]]:
        """(joined, denial_reason). ``joined`` False means the router
        answered with PermissionDenied/CannotCreateSession; transport
        or protocol failures raise."""
        reader, writer = await self._connect()
        try:
            msg_type, _ = await self._read_message(reader)
            if msg_type != MSG_VALIDATE:
                raise IceProtocolError(
                    f"expected ValidateConnection, got {msg_type}"
                )
            request = build_request(
                1, (ROUTER_CATEGORY, ROUTER_NAME), "createSession",
                marshal_two_strings(user, password),
            )
            writer.write(request)
            await writer.drain()
            while True:
                msg_type, body = await self._read_message(reader)
                if msg_type == MSG_CLOSE:
                    raise IceProtocolError(
                        "connection closed before reply"
                    )
                if msg_type != MSG_REPLY:
                    continue  # ignore stray validate/heartbeat
                (reply_id,) = struct.unpack("<i", body[:4])
                if reply_id != 1:
                    continue
                status = body[4]
                if status == REPLY_OK:
                    return True, None
                if status == REPLY_USER_EXCEPTION:
                    blob = body[5:]
                    if b"PermissionDenied" in blob:
                        return False, "Permission denied"
                    if b"CannotCreateSession" in blob:
                        return False, "Cannot create session"
                    raise IceProtocolError(
                        "unrecognized Glacier2 user exception"
                    )
                raise IceProtocolError(
                    f"createSession failed with reply status {status}"
                )
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass


class IceSessionValidator(SessionValidator):
    """SessionValidator over a real Glacier2 join (the OmeroRequest
    contract): a key validates iff ``createSession(key, key)``
    succeeds against the OMERO router.

    Validated keys are cached for ``cache_ttl_s`` so a viewport pan
    issuing hundreds of tiles doesn't pay one TLS handshake + router
    session per tile; denials are NOT cached (a session created between
    two requests must validate immediately). ``cache_ttl_s=0`` disables
    caching AND request merging entirely — every request performs its
    own Glacier2 join, exactly the reference's per-request OmeroRequest
    behavior (PixelBufferVerticle.java:106-110); config key
    ``omero.session-validation-ttl``."""

    def __init__(
        self, host: str, port: int = 4064, secure: bool = False,
        timeout_s: Optional[float] = None, verify_tls: bool = True,
        cache_ttl_s: float = 30.0, cache_max: int = 10_000,
    ):
        self._client = Glacier2Client(
            host, port, secure=secure, timeout_s=timeout_s,
            verify_tls=verify_tls,
        )
        self._cache_ttl_s = cache_ttl_s
        self._cache_max = cache_max
        self._valid_until: dict = {}  # key -> monotonic expiry
        self._in_flight: dict = {}  # key -> Task[bool]
        # a wedged/unreachable router fails joins fast (503, not a
        # worker parked behind a TLS timeout per tile); a denial is an
        # ANSWER and never counts against the breaker
        self.breaker = for_dependency(f"glacier2:{host}:{port}")

    async def _create_session(self, key: str) -> bool:
        """One breaker-gated Glacier2 join. BreakerOpen -> 503 (auth
        backend unavailable, not auth denied)."""
        try:
            self.breaker.allow()
        except BreakerOpenError as e:
            raise ServiceUnavailableError(
                str(e), retry_after_s=e.retry_after_s
            ) from None
        t0 = time.monotonic()  # slow-call input (chaos latency included)
        try:
            await INJECTOR.fire_async("auth.ice")
            try:
                joined, _reason = await self._client.create_session(
                    key, key
                )
            except (ConnectionError, EOFError, OSError,
                    asyncio.IncompleteReadError):
                # reconnect-once (the wire-client recovery every
                # other remote edge has): each attempt dials a fresh
                # connection, so a stale NAT mapping or a router
                # restart between keepalives costs one redial, not a
                # user-visible auth failure. Timeouts deliberately do
                # NOT retry — a silent router would park the worker
                # for a second full window.
                joined, _reason = await self._client.create_session(
                    key, key
                )
        except ServiceUnavailableError:
            raise
        except Exception:
            self.breaker.record_failure()
            raise
        self.breaker.record_success(duration_s=time.monotonic() - t0)
        return joined

    async def _join(self, key: str) -> bool:
        try:
            joined = await self._create_session(key)
            if joined:
                if len(self._valid_until) >= self._cache_max:
                    self._valid_until.clear()  # coarse but bounded
                self._valid_until[key] = (
                    time.monotonic() + self._cache_ttl_s
                )
            return joined
        finally:
            self._in_flight.pop(key, None)

    async def validate(self, omero_session_key: Optional[str]) -> bool:
        if not omero_session_key:
            return False
        if self._cache_ttl_s <= 0:
            # strict per-request join parity: no cache, no merging
            return await self._create_session(omero_session_key)
        expiry = self._valid_until.get(omero_session_key)
        if expiry is not None and expiry > time.monotonic():
            return True
        # single-flight: a cold-cache tile burst must cost ONE join per
        # key, not one TLS handshake + router session per tile. The
        # join runs as its OWN task so one waiter's cancellation (a
        # client hanging up) never aborts the others — shield keeps the
        # task alive and the remaining waiters get its result.
        task = self._in_flight.get(omero_session_key)
        if task is None:
            task = asyncio.get_running_loop().create_task(
                self._join(omero_session_key)
            )
            # consume the exception if every waiter cancelled before
            # the join failed ("Task exception was never retrieved")
            task.add_done_callback(
                lambda t: t.cancelled() or t.exception()
            )
            self._in_flight[omero_session_key] = task
        return await asyncio.shield(task)
