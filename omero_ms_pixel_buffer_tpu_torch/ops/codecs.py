"""TIFF block codecs (copy of ``omero_ms_pixel_buffer_tpu/ops/codecs.py``):
LZW (5) and PackBits (32773), bounded inflate (8) and zstd (50000), plus
the horizontal-differencing predictor (tag 317, value 2).

Decoders here are the pure-Python path; the native engine
(``native/ompb_native.cc``, bound in ``runtime/native.py``) carries the
batched C++ versions of inflate, LZW and PackBits that the reader uses
when it builds. Encoders exist for the writer (fixtures and round-trip
tests). Every decoder is bounded at the caller's capacity and answers
None for a corrupt or oversized stream (the caller fails that block's
lanes alone).

TIFF LZW specifics (TIFF 6.0 spec §13):
- MSB-first bit packing; 9-bit initial codes;
- ClearCode=256, EOI=257, first table entry 258;
- "early change": the code width bumps one code earlier than the
  table size strictly requires (libtiff/Bio-Formats behavior).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

LZW = 5
DEFLATE = 8
PACKBITS = 32773

_CLEAR = 256
_EOI = 257


def bounded_inflate(
    data: bytes, cap: int, wbits: int = 15
) -> Optional[bytes]:
    """zlib-family decompress with output bounded at ``cap`` — the
    shared defence against hostile streams that balloon far past the
    expected block size. ``wbits``: 15 = zlib wrapper, 31 = gzip.
    Returns None on overflow or a truncated stream (callers degrade
    per-lane / per-block), matching native uncompress-with-cap
    semantics."""
    import zlib

    try:
        d = zlib.decompressobj(wbits)
        out = d.decompress(data, cap)
        if d.unconsumed_tail or not d.eof:
            return None  # overflow past cap, or truncated stream
        return out
    except zlib.error:
        return None


def bounded_zstd(data: bytes, cap: int) -> Optional[bytes]:
    """zstd decompress with output truly bounded at ``cap``.

    python-zstandard's ``max_output_size`` only applies when the frame
    header does NOT declare a content size — a hostile frame declaring
    terabytes would otherwise drive the allocation directly. Check the
    declared size against the cap first; unknown-size frames fall back
    to the (then effective) ``max_output_size`` bound. Returns None on
    overflow/corruption/unavailable codec (callers degrade per-block).
    """
    try:
        import zstandard
    except ImportError:  # pragma: no cover - baked into the image
        return None
    try:
        declared = zstandard.frame_content_size(data)
    except zstandard.ZstdError:
        return None
    if declared is not None and declared >= 0 and declared > cap:
        return None
    try:
        return zstandard.ZstdDecompressor().decompress(
            data, max_output_size=cap
        )
    except zstandard.ZstdError:
        return None


def lzw_decode(data: bytes, cap: int) -> Optional[bytes]:
    """Decode a TIFF-flavor LZW stream to at most ``cap`` bytes.
    Returns None on a corrupt stream (callers degrade per-lane)."""
    out = bytearray()
    # table as byte strings; rebuilt on every Clear
    table: list = []

    def reset():
        nonlocal table, width, next_code
        table = [bytes((i,)) for i in range(256)] + [b"", b""]
        width = 9
        next_code = 258

    width = 9
    next_code = 258
    reset()
    bitbuf = 0
    nbits = 0
    pos = 0
    old: Optional[bytes] = None
    n = len(data)
    while True:
        while nbits < width:
            if pos >= n:
                # stream may simply end without EOI (some writers);
                # tolerate only when output is complete — a full block
                # returns at the cap check below, so reaching here
                # means the block is truncated (serve None, not a
                # partially-decoded tile)
                return bytes(out) if len(out) >= cap else None
            bitbuf = (bitbuf << 8) | data[pos]
            pos += 1
            nbits += 8
        code = (bitbuf >> (nbits - width)) & ((1 << width) - 1)
        nbits -= width
        if code == _EOI:
            break
        if code == _CLEAR:
            reset()
            old = None
            continue
        if old is None:
            if code >= 256:
                return None  # first code after Clear must be literal
            entry = table[code]
        elif code < next_code:
            entry = table[code]
            table.append(old + entry[:1])
            next_code += 1
        elif code == next_code:
            entry = old + old[:1]
            table.append(entry)
            next_code += 1
        else:
            return None  # code beyond table: corrupt
        out += entry
        if len(out) >= cap:
            return bytes(out[:cap])
        old = entry
        # "early change" (TIFF/libtiff convention, calibrated against
        # libtiff-written streams): the decoder bumps width when its
        # next free entry reaches 511/1023/2047 — one entry before a
        # 9/10/11-bit code could actually overflow
        if next_code == (1 << width) - 1 and width < 12:
            width += 1
    return bytes(out)


def lzw_encode(data: bytes) -> bytes:
    """TIFF-flavor LZW encoder (early change), for the OME-TIFF writer.
    Emits Clear at start and whenever the table fills, EOI at end."""
    out = bytearray()
    bitbuf = 0
    nbits = 0

    def put(code: int, width: int):
        nonlocal bitbuf, nbits
        bitbuf = (bitbuf << width) | code
        nbits += width
        while nbits >= 8:
            out.append((bitbuf >> (nbits - 8)) & 0xFF)
            nbits -= 8

    table = {bytes((i,)): i for i in range(256)}
    next_code = 258
    width = 9
    put(_CLEAR, width)
    w = b""
    for byte in data:
        c = bytes((byte,))
        wc = w + c
        if wc in table:
            w = wc
            continue
        put(table[w], width)
        table[wc] = next_code
        next_code += 1
        # the encoder's table runs one entry ahead of the decoder's
        # (the decoder can only complete an entry when it sees the
        # NEXT code), so its width bump lands one entry later — at
        # 512/1024/2048 (calibrated against libtiff both ways)
        if next_code == (1 << width) and width < 12:
            width += 1
        elif next_code > 4093:  # table nearly full: restart
            put(_CLEAR, width)
            table = {bytes((i,)): i for i in range(256)}
            next_code = 258
            width = 9
        w = c
    if w:
        put(table[w], width)
    put(_EOI, width)
    if nbits:
        out.append((bitbuf << (8 - nbits)) & 0xFF)
    return bytes(out)


def packbits_decode(data: bytes, cap: int) -> Optional[bytes]:
    """Apple PackBits (TIFF 6.0 §9): n in 0..127 copies n+1 literals;
    n in -127..-1 repeats the next byte 1-n times; -128 is a no-op."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < cap:
        b = data[i]
        i += 1
        if b == 128:  # -128: no-op
            continue
        if b < 128:
            run = b + 1
            if i + run > n:
                return None
            out += data[i : i + run]
            i += run
        else:
            run = 257 - b  # 1 - (b - 256)
            if i >= n:
                return None
            out += data[i : i + 1] * run
            i += 1
    return bytes(out[:cap])


def packbits_encode_row(row: bytes) -> bytes:
    """One row, spec-shaped: literal runs <=128, repeat runs 2..128."""
    out = bytearray()
    i = 0
    n = len(row)
    while i < n:
        # find run length at i
        j = i + 1
        while j < n and j - i < 128 and row[j] == row[i]:
            j += 1
        run = j - i
        if run >= 2:
            out.append(257 - run)
            out.append(row[i])
            i = j
            continue
        # literal stretch: until a run of >=3 starts (2-byte runs are
        # cheaper folded into the literal) or 128 bytes
        lit_start = i
        while i < n and i - lit_start < 128:
            j = i + 1
            while j < n and j - i < 128 and row[j] == row[i]:
                j += 1
            if j - i >= 3:
                break
            # a 2-byte run may straddle the 128-byte literal cap
            i = min(j, lit_start + 128)
        out.append(i - lit_start - 1)
        out += row[lit_start:i]
    return bytes(out)


def packbits_encode(data: bytes, row_bytes: int) -> bytes:
    """Pack a block row by row (TIFF: 'each row must be packed
    separately'); decoding is boundary-oblivious so this only matters
    for interop with strict readers."""
    out = bytearray()
    for off in range(0, len(data), row_bytes):
        out += packbits_encode_row(data[off : off + row_bytes])
    return bytes(out)


def undo_predictor2(
    block: np.ndarray, row_samples: int, itemsize: int, samples: int,
    byteorder: str,
) -> np.ndarray:
    """Invert TIFF predictor 2 (horizontal differencing) over a decoded
    block: each sample accumulates its same-channel left neighbor
    (distance = samples-per-pixel). ``block`` is the raw uint8 decode
    output; ``row_samples`` = pixels-per-row * samples for the block
    geometry (tile width or strip width). Returns the un-differenced
    bytes in the block's byte order."""
    dtype = np.dtype(f"{byteorder}u{itemsize}" if itemsize > 1 else "u1")
    vals = block.view(dtype).astype(dtype.newbyteorder("="))
    arr = vals.reshape(-1, row_samples // samples, samples)
    np.cumsum(arr, axis=1, dtype=arr.dtype, out=arr)
    return arr.reshape(-1).astype(dtype).view(np.uint8)


def apply_predictor2(
    block: np.ndarray, row_samples: int, itemsize: int, samples: int,
    byteorder: str,
) -> np.ndarray:
    """Forward predictor 2 for the writer: difference each sample
    against the previous pixel's same channel (modular arithmetic —
    unsigned wraparound is the spec behavior)."""
    dtype = np.dtype(f"{byteorder}u{itemsize}" if itemsize > 1 else "u1")
    vals = block.view(dtype).astype(dtype.newbyteorder("="))
    arr = vals.reshape(-1, row_samples // samples, samples)
    diff = arr.copy()
    diff[:, 1:, :] = arr[:, 1:, :] - arr[:, :-1, :]  # wraps (unsigned)
    return diff.reshape(-1).astype(dtype).view(np.uint8)
