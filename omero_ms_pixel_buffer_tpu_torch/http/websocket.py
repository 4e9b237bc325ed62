"""RFC 6455 WebSocket server side on asyncio streams, for the session
plane's live channel (the JAX package serves it with aiohttp's
``WebSocketResponse``; the card host has no aiohttp).

- ``handshake``: aiohttp's checks and 400 messages, and the 101 answer's
  headers with ``Sec-WebSocket-Accept`` = base64(sha1(key + GUID)). The
  ``permessage-deflate`` extension is declined (left out of the answer,
  as RFC 6455 allows), so frames are never compressed.
- ``WebSocket``: unmasked text frames out; masked, possibly fragmented
  frames in (a message at most ``MAX_MESSAGE`` bytes, aiohttp's
  ``max_msg_size``). A ping is answered with a pong and a close with a
  close, as aiohttp's ``autoping``/``autoclose`` do; binary messages are
  dropped, as the JAX handler ignores them.
"""

from __future__ import annotations

import asyncio
import base64
import binascii
import hashlib
import json
import struct
from typing import Optional, Tuple

GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
OP_CONTINUATION, OP_TEXT, OP_BINARY = 0x0, 0x1, 0x2
OP_CLOSE, OP_PING, OP_PONG = 0x8, 0x9, 0xA
CLOSE_OK, CLOSE_PROTOCOL_ERROR, CLOSE_INVALID_DATA, CLOSE_TOO_BIG = 1000, 1002, 1007, 1009
MAX_MESSAGE = 4 << 20


def accept_value(key: str) -> str:
    return base64.b64encode(hashlib.sha1(key.encode() + GUID).digest()).decode()


def handshake(headers: dict) -> Tuple[Optional[dict], Optional[str]]:
    """(the 101 answer's headers, None), or (None, the 400 text) with
    aiohttp's message. ``headers`` has lower-case names."""
    upgrade = headers.get("upgrade")
    if (upgrade or "").lower().strip() != "websocket":
        return None, ('No WebSocket UPGRADE hdr: {}\n Can "Upgrade" only to '
                      '"WebSocket".').format(upgrade)
    connection = headers.get("connection")
    if "upgrade" not in (connection or "").lower():
        return None, f"No CONNECTION upgrade hdr: {connection}"
    version = headers.get("sec-websocket-version", "")
    if version not in ("13", "8", "7"):
        return None, f"Unsupported version: {version}"
    key = headers.get("sec-websocket-key")
    try:
        if not key or len(base64.b64decode(key)) != 16:
            return None, f"Handshake error: {key!r}"
    except binascii.Error:
        return None, f"Handshake error: {key!r}"
    return {"Upgrade": "websocket", "Connection": "upgrade",
            "Sec-WebSocket-Accept": accept_value(key)}, None


def encode_frame(opcode: int, payload: bytes) -> bytes:
    """One final, unmasked frame (the server never masks)."""
    n = len(payload)
    if n < 126:
        head = struct.pack(">BB", 0x80 | opcode, n)
    elif n < 1 << 16:
        head = struct.pack(">BBH", 0x80 | opcode, 126, n)
    else:
        head = struct.pack(">BBQ", 0x80 | opcode, 127, n)
    return head + payload


def _unmask(data: bytes, mask: bytes) -> bytes:
    if not data:
        return data
    n = len(data)
    key = (mask * (n // 4 + 1))[:n]
    return (int.from_bytes(data, "big") ^ int.from_bytes(key, "big")).to_bytes(n, "big")


class WebSocket:
    """One upgraded connection. ``closed`` is set once the server's close
    frame is sent; ``receive`` returns the next text message, or None at
    the peer's close, at EOF or after a protocol error (answered with a
    close frame of its code)."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.closed = False

    async def _send(self, opcode: int, payload: bytes) -> None:
        self.writer.write(encode_frame(opcode, payload))
        await self.writer.drain()

    async def send_str(self, text: str) -> None:
        await self._send(OP_TEXT, text.encode())

    async def send_json(self, obj) -> None:
        """``json.dumps`` with its default separators, as aiohttp's
        ``send_json``."""
        await self.send_str(json.dumps(obj))

    async def close(self, code: int = CLOSE_OK) -> None:
        if self.closed:
            return
        self.closed = True
        await self._send(OP_CLOSE, struct.pack(">H", code))

    async def _fail(self, code: int) -> None:
        try:
            await self.close(code)
        except (ConnectionError, OSError):
            pass

    async def receive(self) -> Optional[str]:
        fragments, opcode, size = [], None, 0
        read = self.reader.readexactly
        try:
            while True:
                b0, b1 = await read(2)
                fin, rsv, op = b0 & 0x80, b0 & 0x70, b0 & 0x0F
                n = b1 & 0x7F
                if n == 126:
                    (n,) = struct.unpack(">H", await read(2))
                elif n == 127:
                    (n,) = struct.unpack(">Q", await read(8))
                if rsv or not b1 & 0x80 or (op >= 0x8 and (n > 125 or not fin)):
                    await self._fail(CLOSE_PROTOCOL_ERROR)  # no extension, unmasked
                    return None
                if op < 0x8 and size + n > MAX_MESSAGE:
                    await self._fail(CLOSE_TOO_BIG)
                    return None
                mask = await read(4)
                data = _unmask(await read(n), mask)
                if op == OP_PING:
                    await self._send(OP_PONG, data)
                    continue
                if op == OP_PONG:
                    continue
                if op == OP_CLOSE:
                    await self._fail(CLOSE_OK)  # the echo; nothing once ours is sent
                    return None
                if op == OP_CONTINUATION:
                    if opcode is None:
                        await self._fail(CLOSE_PROTOCOL_ERROR)
                        return None
                elif op in (OP_TEXT, OP_BINARY):
                    if opcode is not None:
                        await self._fail(CLOSE_PROTOCOL_ERROR)
                        return None
                    opcode = op
                else:
                    await self._fail(CLOSE_PROTOCOL_ERROR)
                    return None
                fragments.append(data)
                size += n
                if not fin:
                    continue
                message, done = b"".join(fragments), opcode
                fragments, opcode, size = [], None, 0
                if done == OP_BINARY:
                    continue
                try:
                    return message.decode("utf-8")
                except UnicodeDecodeError:
                    await self._fail(CLOSE_INVALID_DATA)
                    return None
        except (asyncio.IncompleteReadError, ConnectionError):
            return None
