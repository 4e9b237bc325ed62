"""A plain PNG decoder: chunk walk with CRC checks, zlib inflate and the
five scanline filter types of the PNG specification (ISO/IEC 15948,
section 9), for greyscale 8/16-bit and RGB 8-bit images."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_SAMPLES = {0: 1, 2: 3}  # colour type -> samples per pixel


class PngError(ValueError):
    """The bytes are not a PNG this decoder reads."""


def chunks(body: bytes):
    """(type, data) of each chunk, every CRC checked."""
    if body[:8] != SIGNATURE:
        raise PngError("no PNG signature")
    pos, out = 8, []
    while pos < len(body):
        if pos + 12 > len(body):
            raise PngError("truncated chunk")
        (n,) = struct.unpack(">I", body[pos:pos + 4])
        tag, data = body[pos + 4:pos + 8], body[pos + 8:pos + 8 + n]
        if len(data) != n or pos + 12 + n > len(body):
            raise PngError("truncated chunk")
        (crc,) = struct.unpack(">I", body[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + data) & 0xFFFFFFFF != crc:
            raise PngError(f"bad CRC in {tag!r}")
        out.append((tag, data))
        pos += 12 + n
        if tag == b"IEND":
            break
    if not out or out[0][0] != b"IHDR" or out[-1][0] != b"IEND":
        raise PngError("IHDR first and IEND last are required")
    return out


def header(body: bytes):
    """(width, height, bit depth, colour type) from the IHDR chunk."""
    (tag, data), = chunks(body)[:1]
    w, h, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB", data[:13])
    if (color, depth) not in ((0, 8), (0, 16), (2, 8)) or comp or filt or interlace:
        raise PngError(f"unsupported PNG: colour {color}, depth {depth}, interlace {interlace}")
    return w, h, depth, color


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(h, 1 + rb) filtered scanlines -> (h, rb) raw bytes. Runs of rows
    filtered ``none`` or ``up`` are undone at once (``up`` is a running
    sum down the columns, restarted by each ``none`` row); ``sub``,
    ``average`` and ``paeth`` rows go one row at a time."""
    kinds = rows[:, 0]
    if (kinds > 4).any():
        raise PngError(f"unknown filter type {int(kinds.max())}")
    res = rows[:, 1:]
    h, rb = res.shape
    out = np.empty((h, rb), np.uint8)
    prev = np.zeros(rb, np.uint8)
    y = 0
    while y < h:
        if kinds[y] in (0, 2):
            end = y + 1
            while end < h and kinds[end] in (0, 2):
                end += 1
            starts = [y] + [k for k in range(y + 1, end) if kinds[k] == 0]
            for s, e in zip(starts, starts[1:] + [end]):
                out[s:e] = np.cumsum(res[s:e], axis=0, dtype=np.uint8)  # mod 256
                if kinds[s] == 2:
                    out[s:e] += prev
                prev = out[e - 1]
            y = end
            continue
        cur = res[y].tolist()
        up = prev.tolist()
        row = [0] * rb
        kind = kinds[y]
        for x in range(rb):
            left = row[x - bpp] if x >= bpp else 0
            if kind == 1:  # sub
                pred = left
            elif kind == 3:  # average
                pred = (left + up[x]) >> 1
            else:  # paeth
                pred = _paeth(left, up[x], up[x - bpp] if x >= bpp else 0)
            row[x] = (cur[x] + pred) & 0xFF
        out[y] = row
        prev = out[y]
        y += 1
    return out


def decode(body: bytes) -> np.ndarray:
    """PNG bytes -> (h, w) uint8/uint16 or (h, w, 3) uint8 pixels."""
    w, h, depth, color = header(body)
    idat = b"".join(data for tag, data in chunks(body) if tag == b"IDAT")
    samples = _SAMPLES[color]
    bpp = samples * depth // 8
    rb = w * bpp
    try:
        raw = zlib.decompress(idat)
    except zlib.error as e:
        raise PngError(f"bad zlib stream: {e}") from None
    if len(raw) != h * (1 + rb):
        raise PngError(f"inflated {len(raw)} bytes, expected {h * (1 + rb)}")
    out = unfilter(np.frombuffer(raw, np.uint8).reshape(h, 1 + rb), bpp)
    if samples == 3:
        return out.reshape(h, w, 3)
    return out.view(">u2").astype(np.uint16) if depth == 16 else out
