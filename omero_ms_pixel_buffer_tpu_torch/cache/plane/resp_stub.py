"""In-memory RESP2 server stub, for development, benchmarks and tests
only (a copy of ``omero_ms_pixel_buffer_tpu/cache/plane/resp_stub.py``).

No Redis ships with the service, so its tests and ``chip_smoke.py``'s
``path_config`` phase boot this instead: an asyncio server speaking just
enough RESP2 for the session store (and the JAX package's L2 tier) —
GET/SET (EX/PX)/DEL/SCAN (MATCH/COUNT)/AUTH/SELECT/PING/FLUSHDB — with
real expiry semantics. Never use in production (the EchoSessionStore
precedent). The data dict is shared across connections (and accessible to tests
for direct inspection); ``fail_mode`` turns the server into a chaos
actor: ``"close"`` drops each connection on its next command,
``"hang"`` stops answering without closing — the two shapes of a sick
Redis the breaker/timeout contract must absorb.
"""

from __future__ import annotations

import asyncio
import fnmatch
import time
from typing import Dict, Optional, Tuple


class InMemoryRespServer:
    def __init__(self):
        self.data: Dict[bytes, Tuple[bytes, Optional[float]]] = {}
        self.commands = 0
        self.fail_mode: Optional[str] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._conn_tasks: set = set()
        self.port: Optional[int] = None

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._server = await asyncio.start_server(
            self._serve, host, port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            # cancel live connection handlers (a "hang" chaos handler
            # would otherwise park wait_closed on 3.12+)
            for task in list(self._conn_tasks):
                task.cancel()
            await self._server.wait_closed()
            self._server = None

    @property
    def uri(self) -> str:
        return f"redis://127.0.0.1:{self.port}/0"

    # -- storage helpers (expiry-aware) --------------------------------

    def _live(self, key: bytes) -> Optional[bytes]:
        item = self.data.get(key)
        if item is None:
            return None
        value, expires = item
        if expires is not None and time.monotonic() >= expires:
            del self.data[key]
            return None
        return value

    def live_keys(self):
        return [k for k in list(self.data) if self._live(k) is not None]

    # -- protocol ------------------------------------------------------

    async def _serve(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        try:
            while True:
                parts = await self._read_command(reader)
                if parts is None:
                    break
                self.commands += 1
                if self.fail_mode == "hang":
                    await asyncio.sleep(3600)
                if self.fail_mode == "close":
                    break
                writer.write(self._dispatch(parts))
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except asyncio.CancelledError:  # ompb-lint: disable=error-taxonomy -- terminal handler task: close() cancels chaos-hung connections; nothing above this frame resumes
            pass
        finally:
            self._conn_tasks.discard(task)
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass

    @staticmethod
    async def _read_command(reader):
        line = await reader.readline()
        if not line:
            return None
        if not line.startswith(b"*"):
            raise ConnectionError(f"bad RESP frame: {line!r}")
        n = int(line[1:].rstrip())
        parts = []
        for _ in range(n):
            header = await reader.readline()
            size = int(header[1:].rstrip())
            data = await reader.readexactly(size + 2)
            parts.append(data[:-2])
        return parts

    @staticmethod
    def _bulk(value: Optional[bytes]) -> bytes:
        if value is None:
            return b"$-1\r\n"
        return b"$%d\r\n%s\r\n" % (len(value), value)

    def _dispatch(self, parts) -> bytes:
        cmd = parts[0].upper()
        if cmd in (b"PING",):
            return b"+PONG\r\n"
        if cmd in (b"AUTH", b"SELECT"):
            return b"+OK\r\n"
        if cmd == b"FLUSHDB":
            self.data.clear()
            return b"+OK\r\n"
        if cmd == b"GET":
            return self._bulk(self._live(parts[1]))
        if cmd == b"MGET":
            out = b"*%d\r\n" % (len(parts) - 1)
            for key in parts[1:]:
                out += self._bulk(self._live(key))
            return out
        if cmd == b"INCR":
            try:
                value = int(self._live(parts[1]) or b"0") + 1
            except ValueError:
                return b"-ERR value is not an integer\r\n"
            self.data[parts[1]] = (str(value).encode(), None)
            return b":%d\r\n" % value
        if cmd == b"SET":
            expires = None
            i = 3
            while i < len(parts):
                opt = parts[i].upper()
                if opt == b"PX" and i + 1 < len(parts):
                    expires = time.monotonic() + int(parts[i + 1]) / 1e3
                    i += 2
                elif opt == b"EX" and i + 1 < len(parts):
                    expires = time.monotonic() + int(parts[i + 1])
                    i += 2
                else:
                    i += 1
            self.data[parts[1]] = (parts[2], expires)
            return b"+OK\r\n"
        if cmd == b"DEL":
            removed = 0
            for key in parts[1:]:
                if self.data.pop(key, None) is not None:
                    removed += 1
            return b":%d\r\n" % removed
        if cmd == b"SCAN":
            # single-pass cursor: everything in one reply, cursor 0
            pattern = b"*"
            for i in range(2, len(parts) - 1):
                if parts[i].upper() == b"MATCH":
                    pattern = parts[i + 1]
            pat = pattern.decode("latin-1")
            keys = [
                k for k in self.live_keys()
                if fnmatch.fnmatchcase(k.decode("latin-1"), pat)
            ]
            out = b"*2\r\n" + self._bulk(b"0")
            out += b"*%d\r\n" % len(keys)
            for k in keys:
                out += self._bulk(k)
            return out
        return b"-ERR unknown command '%s'\r\n" % cmd
