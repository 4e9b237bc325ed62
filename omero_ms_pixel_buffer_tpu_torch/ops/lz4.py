"""LZ4 block codec, pure Python (copy of ``omero_ms_pixel_buffer_tpu/ops/
lz4.py``).

Real OME-NGFF stores are mostly Blosc-compressed with ``cname='lz4'``
(the numcodecs default, and bioformats2raw's), and the port ships no
``lz4`` or ``blosc`` package: it carries its own block codec, as the
JAX package does. The decoder runs in Python under the GIL, so it bounds
the read of such chunks.

Block format (lz4.github.io/lz4/lz4_Block_format.html): a sequence
stream; each sequence is

    token (hi nibble: literal count, lo nibble: match length - 4;
    15 in either nibble extends with 255-saturated continuation bytes)
    [literal-length extension] [literals]
    [2-byte little-endian match offset >= 1]
    [match-length extension]

Matches copy from already-decoded output and may overlap themselves
(offset < length == RLE). The final sequence is literals-only.

The decoder is hostile-input safe: bounded by the declared output size,
offset/overrun validation, no quadratic paths. The encoder (a greedy
hash-chain-less matcher) exists for fixtures and round-trip tests —
the decoder is also pinned by hand-built spec vectors
(``tests/test_torch_lz4_blosc.py``).
"""

from __future__ import annotations


class Lz4Error(ValueError):
    pass


def lz4_block_decompress(data: bytes, out_size: int) -> bytes:
    """Decode one LZ4 block into exactly ``out_size`` bytes."""
    if out_size < 0:
        raise Lz4Error("negative output size")
    if out_size == 0:
        if data:
            raise Lz4Error("trailing input for empty output")
        return b""
    src = memoryview(data)
    n = len(src)
    out = bytearray(out_size)
    ip = 0
    op = 0
    while True:
        if ip >= n:
            if op == out_size:
                # spec encoders end on literals, but a stream ending
                # exactly after a match with complete output is
                # unambiguous — accept it
                return bytes(out)
            raise Lz4Error("truncated stream (no token)")
        token = src[ip]
        ip += 1
        # -- literals --------------------------------------------------
        lit = token >> 4
        if lit == 15:
            while True:
                if ip >= n:
                    raise Lz4Error("truncated literal length")
                b = src[ip]
                ip += 1
                lit += b
                if b != 255:
                    break
        if lit:
            if ip + lit > n:
                raise Lz4Error("truncated literals")
            if op + lit > out_size:
                raise Lz4Error("literal overrun")
            out[op : op + lit] = src[ip : ip + lit]
            ip += lit
            op += lit
        if ip == n:
            # literals-only final sequence
            if op != out_size:
                raise Lz4Error(
                    f"short output: {op} of {out_size} bytes"
                )
            return bytes(out)
        # -- match -----------------------------------------------------
        if ip + 2 > n:
            raise Lz4Error("truncated match offset")
        offset = src[ip] | (src[ip + 1] << 8)
        ip += 2
        if offset == 0 or offset > op:
            raise Lz4Error(f"invalid match offset {offset} at {op}")
        mlen = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                if ip >= n:
                    raise Lz4Error("truncated match length")
                b = src[ip]
                ip += 1
                mlen += b
                if b != 255:
                    break
        if op + mlen > out_size:
            raise Lz4Error("match overrun")
        start = op - offset
        if offset >= mlen:
            out[op : op + mlen] = out[start : start + mlen]
            op += mlen
        else:
            # overlapping match: byte-serial semantics (RLE-style);
            # replicate the period instead of looping per byte
            period = out[start:op]
            reps = -(-mlen // offset)
            chunk = (period * reps)[:mlen]
            out[op : op + mlen] = chunk
            op += mlen


def lz4_block_compress(data: bytes) -> bytes:
    """Greedy LZ4 block encoder (hash table of 4-byte prefixes).

    Fixture/test support: produces valid, reasonably compact blocks —
    not speed-tuned. Honors the spec's end conditions (last 5 bytes
    literal, matches end >= 12 bytes before the block end)."""
    n = len(data)
    if n == 0:
        return b""
    src = data
    out = bytearray()
    table: dict = {}
    anchor = 0
    i = 0
    # spec: the last match must start at least 12 bytes before the end,
    # and the last 5 bytes are always literals
    match_limit = n - 12

    def emit(literals: bytes, mlen: int = 0, offset: int = 0) -> None:
        lit = len(literals)
        tok_lit = 15 if lit >= 15 else lit
        if mlen:
            m = mlen - 4
            tok_m = 15 if m >= 15 else m
        else:
            tok_m = 0
        out.append((tok_lit << 4) | tok_m)
        if lit >= 15:
            rest = lit - 15
            while rest >= 255:
                out.append(255)
                rest -= 255
            out.append(rest)
        out.extend(literals)
        if mlen:
            out.append(offset & 0xFF)
            out.append(offset >> 8)
            if mlen - 4 >= 15:
                rest = mlen - 4 - 15
                while rest >= 255:
                    out.append(255)
                    rest -= 255
                out.append(rest)

    while i <= match_limit:
        key = src[i : i + 4]
        cand = table.get(key)
        table[key] = i
        if cand is not None and i - cand <= 0xFFFF:
            # extend the match forward (stop 5 bytes before the end)
            mlen = 4
            limit = n - 5
            while i + mlen < limit and src[cand + mlen] == src[i + mlen]:
                mlen += 1
            emit(src[anchor:i], mlen, i - cand)
            i += mlen
            anchor = i
        else:
            i += 1
    emit(src[anchor:])  # final literals-only sequence
    return bytes(out)
