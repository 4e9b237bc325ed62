"""The reference PNG decoder against PNGs made here with zlib, in each
of the five filter types, for the three formats the service emits."""

import struct
import zlib

import numpy as np
import pytest

from reference import png


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def filter_row(kind, row, prev, bpp):
    """The PNG filter of one scanline, written out byte by byte."""
    out = []
    for x, v in enumerate(row):
        a = row[x - bpp] if x >= bpp else 0
        b = prev[x]
        c = prev[x - bpp] if x >= bpp else 0
        pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][kind]
        out.append((v - pred) % 256)
    return bytes([kind] + out)


def encode(pixels: np.ndarray, kinds) -> bytes:
    """A PNG of ``pixels`` whose row y is filtered with ``kinds[y % len]``."""
    h, w = pixels.shape[:2]
    if pixels.ndim == 3:
        depth, color, raw = 8, 2, pixels.astype(np.uint8)
    elif pixels.dtype == np.uint16:
        depth, color, raw = 16, 0, pixels.astype(">u2")
    else:
        depth, color, raw = 8, 0, pixels
    rows = raw.view(np.uint8).reshape(h, -1)
    bpp = (3 if color == 2 else 1) * depth // 8
    prev = [0] * rows.shape[1]
    data = b""
    for y in range(h):
        row = rows[y].tolist()
        data += filter_row(kinds[y % len(kinds)], row, prev, bpp)
        prev = row

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(data, 6)) + chunk(b"IEND", b""))


def _pixels(kind: str, rng):
    if kind == "u16":
        return rng.integers(0, 65536, (9, 7), dtype=np.uint16)
    if kind == "u8":
        return rng.integers(0, 256, (9, 7), dtype=np.uint8)
    return rng.integers(0, 256, (9, 7, 3), dtype=np.uint8)


@pytest.mark.parametrize("fmt", ["u8", "u16", "rgb8"])
@pytest.mark.parametrize("kinds", [[0], [1], [2], [3], [4], [2, 0, 4, 1, 3, 2, 2, 0]],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_decodes_every_filter_type(fmt, kinds):
    pixels = _pixels(fmt, np.random.default_rng(len(kinds) * 7 + len(fmt)))
    got = png.decode(encode(pixels, kinds))
    assert got.dtype == pixels.dtype and np.array_equal(got, pixels)


def test_header_reads_size_and_format():
    body = encode(np.zeros((5, 3, 3), np.uint8), [2])
    assert png.header(body) == (3, 5, 8, 2)


@pytest.mark.parametrize("damage", ["crc", "truncated", "signature", "filter"])
def test_refuses_malformed(damage):
    body = bytearray(encode(np.arange(12, dtype=np.uint16).reshape(3, 4), [2]))
    if damage == "crc":
        body[-5] ^= 1  # IEND's CRC
    elif damage == "truncated":
        body = body[:-20]
    elif damage == "signature":
        body[1] = 0
    else:
        raw = bytes([7]) + bytes(8)
        body = bytearray(encode(np.zeros((1, 4), np.uint16), [0]))
        start = body.index(b"IDAT") - 4
        n = struct.unpack(">I", body[start:start + 4])[0]
        idat = zlib.compress(raw)
        body[start:start + 12 + n] = (struct.pack(">I", len(idat)) + b"IDAT" + idat
                                      + struct.pack(">I", zlib.crc32(b"IDAT" + idat)))
    with pytest.raises(png.PngError):
        png.decode(bytes(body))
