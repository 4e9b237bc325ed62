"""The load: closed-loop clients over keep-alive HTTP/1.1 connections,
on one asyncio loop in the benchmark's own process (not the server's).
A client sends the requests of a step at once, one per connection of
its own, waits for every answer, then sends its next step."""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import List, Optional

HOST = "127.0.0.1"
ANSWER_TIMEOUT_S = 60.0  # an answer still missing this long after it was sent never comes


@dataclass
class Answer:
    spec: dict
    sent: float  # time.monotonic()
    done: float
    status: int  # 0: no answer (transport error or timeout)
    body: Optional[bytes]
    error: str = ""


class Connection:
    """One keep-alive connection; reopened after a transport error."""

    def __init__(self, port: int, cookie: str):
        self.port, self.cookie = port, cookie
        self.reader = self.writer = None

    async def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
            try:
                await self.writer.wait_closed()
            except OSError:
                pass
            self.reader = self.writer = None

    async def _get(self, path: str) -> tuple:
        if self.writer is None:
            self.reader, self.writer = await asyncio.open_connection(
                HOST, self.port, limit=1 << 20)
        self.writer.write(f"GET {path} HTTP/1.1\r\nHost: {HOST}\r\n"
                          f"Cookie: sessionid={self.cookie}\r\n\r\n".encode("latin-1"))
        line = await self.reader.readline()
        if not line:
            raise ConnectionError("connection closed before the status line")
        status = int(line.split()[1])
        length, close = 0, False
        while True:
            h = await self.reader.readline()
            if h in (b"\r\n", b""):
                break
            key, _, value = h.decode("latin-1").partition(":")
            key = key.strip().lower()
            if key == "content-length":
                length = int(value)
            elif key == "connection" and value.strip().lower() == "close":
                close = True
        body = await self.reader.readexactly(length) if length else b""
        if close:
            await self.close()
        return status, body

    async def get(self, spec: dict) -> Answer:
        sent = time.monotonic()
        try:
            status, body = await asyncio.wait_for(self._get(spec["path"]), ANSWER_TIMEOUT_S)
            return Answer(spec, sent, time.monotonic(), status, body)
        except (OSError, ValueError, IndexError, asyncio.IncompleteReadError,
                asyncio.TimeoutError) as e:
            await self.close()
            return Answer(spec, sent, time.monotonic(), 0, None, f"{type(e).__name__}: {e}")


async def closed_loop(port: int, streams, until: float, width: int) -> List[Answer]:
    """Run every client (a ``traffic.Client``) until ``until``
    (``time.monotonic()``): no step starts after it; the steps started
    are answered in full. ``width``: connections a client holds."""

    async def client(stream) -> List[Answer]:
        conns = [Connection(port, f"bench-{stream.client}") for _ in range(width)]
        out: List[Answer] = []
        try:
            while time.monotonic() < until:
                step = stream.step()
                out += await asyncio.gather(*(c.get(s) for c, s in zip(conns, step)))
        finally:
            for c in conns:
                await c.close()
        return out

    results = await asyncio.gather(*(client(s) for s in streams))
    return [a for r in results for a in r]


async def sequence(port: int, specs, cookie: str = "bench-warm") -> List[Answer]:
    """The requests one after another on one connection."""
    conn = Connection(port, cookie)
    try:
        return [await conn.get(s) for s in specs]
    finally:
        await conn.close()


async def fetch(port: int, path: str) -> bytes:
    """One GET on a connection of its own; the body of a 200 answer."""
    conn = Connection(port, "bench-probe")
    try:
        answer = await conn.get({"path": path})
    finally:
        await conn.close()
    if answer.status != 200:
        raise RuntimeError(f"{path} answered {answer.status} {answer.error}")
    return answer.body
