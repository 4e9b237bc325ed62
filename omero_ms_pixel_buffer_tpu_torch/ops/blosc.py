"""Blosc v1 container codec, decode and fixture-grade encode (copy of
``omero_ms_pixel_buffer_tpu/ops/blosc.py``).

OME-NGFF chunks in the wild are mostly Blosc frames (the numcodecs
default is ``Blosc(cname='lz4', shuffle=SHUFFLE)``). No ``blosc``
package ships with the port, so the container is parsed here.

Frame layout (c-blosc 1.x, BLOSC_VERSION_FORMAT 2):

    byte 0   version            byte 1   versionlz
    byte 2   flags: bit0 byte-shuffle, bit1 memcpyed, bit2 bit-shuffle,
             bits 5-7 codec (0 blosclz, 1 lz4/lz4hc, 2 snappy,
             3 zlib, 4 zstd)
    byte 3   typesize
    4-7      nbytes   (LE, uncompressed)
    8-11     blocksize(LE)
    12-15    cbytes   (LE, whole frame)
    then, unless memcpyed: int32 LE bstarts[nblocks] (absolute offsets),
    each block at its bstart: int32 LE csize + csize compressed bytes
    (csize == block size means the block is stored raw).

Shuffle is per block: the leading ``size - size % typesize`` bytes are
a (typesize, n) byte transpose; the remainder is copied verbatim.

Bit-shuffle (flag bit 2) is the bitshuffle-library transform c-blosc
embeds: the block's leading whole group of ``8*typesize``-byte units
is treated as an (elements, typesize*8) bit matrix — bit order within
an element is byte-major then LSB-first, matching
``bshuf_trans_bit_elem``'s scalar reference — and transposed into
bit-planes, each plane packing element bits LSB-first. The trailing
partial group (fewer than 8 elements) is copied verbatim, like the
byte-shuffle remainder.

Supported codecs: lz4 (in-tree, ops/lz4), zstd (the ``zstandard``
wheel), zlib (stdlib), memcpy. blosclz/snappy raise a clear error —
callers surface it as an unreadable chunk.
"""

from __future__ import annotations

import struct
import zlib as _zlib

import numpy as np

from . import codecs as _codecs
from .lz4 import lz4_block_compress, lz4_block_decompress

try:
    import zstandard as _zstd
except ImportError:  # pragma: no cover - baked into the image
    _zstd = None

_HEADER = 16
_MEMCPYED = 0x2
_BYTE_SHUFFLE = 0x1
_BIT_SHUFFLE = 0x4
_CODECS = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}
_CODEC_IDS = {v: k for k, v in _CODECS.items()}


class BloscError(ValueError):
    pass


def _unshuffle(block: bytes, typesize: int) -> bytes:
    if typesize <= 1 or len(block) < typesize:
        return block
    main = len(block) - len(block) % typesize
    arr = np.frombuffer(block, np.uint8, count=main)
    un = arr.reshape(typesize, main // typesize).T.reshape(-1)
    return un.tobytes() + block[main:]


def _shuffle(block: bytes, typesize: int) -> bytes:
    if typesize <= 1 or len(block) < typesize:
        return block
    main = len(block) - len(block) % typesize
    arr = np.frombuffer(block, np.uint8, count=main)
    sh = arr.reshape(main // typesize, typesize).T.reshape(-1)
    return sh.tobytes() + block[main:]


def _bit_main(block: bytes, typesize: int) -> int:
    """Bytes covered by whole 8-element groups (the bit-transposable
    region); the remainder is copied verbatim on both directions."""
    nelem = len(block) // typesize
    return (nelem - nelem % 8) * typesize


def _bit_shuffle(block: bytes, typesize: int) -> bytes:
    """bitshuffle forward transform: (elements, typesize*8) bit matrix
    -> transposed bit planes, LSB-first within bytes on both axes."""
    if typesize < 1:
        return block
    main = _bit_main(block, typesize)
    if main == 0:
        return block
    nelem = main // typesize
    arr = np.frombuffer(block, np.uint8, count=main).reshape(
        nelem, typesize
    )
    bits = np.unpackbits(arr, axis=1, bitorder="little")
    planes = np.packbits(bits.T, axis=1, bitorder="little")
    return planes.tobytes() + block[main:]


def _bit_unshuffle(block: bytes, typesize: int) -> bytes:
    """Inverse of ``_bit_shuffle``: unpack the bit planes and
    re-interleave each element's bits."""
    if typesize < 1:
        return block
    main = _bit_main(block, typesize)
    if main == 0:
        return block
    nelem = main // typesize
    nbits = typesize * 8
    planes = np.frombuffer(block, np.uint8, count=main).reshape(
        nbits, nelem // 8
    )
    bits = np.unpackbits(planes, axis=1, bitorder="little")
    elems = np.packbits(bits.T, axis=1, bitorder="little")
    return elems.tobytes() + block[main:]


def blosc_decompress(data: bytes, expected_nbytes: int = -1) -> bytes:
    """Decode one Blosc frame. ``expected_nbytes`` (e.g. the Zarr chunk
    capacity) bounds hostile headers; -1 trusts the frame."""
    if len(data) < _HEADER:
        raise BloscError("truncated blosc header")
    version, _versionlz, flags, typesize = data[0], data[1], data[2], data[3]
    nbytes, blocksize, cbytes = struct.unpack_from("<iii", data, 4)
    if version < 1 or version > 2:
        raise BloscError(f"unsupported blosc version {version}")
    if nbytes < 0 or blocksize <= 0 or cbytes != len(data):
        raise BloscError("inconsistent blosc header")
    if expected_nbytes >= 0 and nbytes > expected_nbytes:
        raise BloscError(
            f"blosc frame declares {nbytes} bytes, expected "
            f"<= {expected_nbytes}"
        )
    if (flags & _BIT_SHUFFLE) and (flags & _BYTE_SHUFFLE):
        raise BloscError("both shuffle flags set")
    if nbytes == 0:
        return b""
    if flags & _MEMCPYED:
        out = data[_HEADER : _HEADER + nbytes]
        if len(out) != nbytes:
            raise BloscError("truncated memcpy frame")
        return out
    codec = _CODECS.get(flags >> 5)
    nblocks = -(-nbytes // blocksize)
    starts_end = _HEADER + 4 * nblocks
    if starts_end > len(data):
        raise BloscError("truncated bstarts")
    bstarts = struct.unpack_from(f"<{nblocks}i", data, _HEADER)
    out = bytearray()
    for i, start in enumerate(bstarts):
        bsize = min(blocksize, nbytes - i * blocksize)
        if start < starts_end or start + 4 > len(data):
            raise BloscError(f"bad bstart[{i}]")
        (csize,) = struct.unpack_from("<i", data, start)
        payload = data[start + 4 : start + 4 + csize]
        if csize < 0 or len(payload) != csize:
            raise BloscError(f"truncated block {i}")
        if csize == bsize:
            block = payload  # stored raw
        elif codec == "lz4":
            try:
                block = lz4_block_decompress(payload, bsize)
            except Exception as e:
                raise BloscError(f"corrupt lz4 block {i}: {e}") from None
        elif codec == "zstd":
            if _zstd is None:  # pragma: no cover
                raise BloscError("zstd unavailable")
            # declared-size-checked bound (max_output_size alone is
            # ignored for frames that declare their content size)
            block = _codecs.bounded_zstd(payload, bsize)
            if block is None:
                raise BloscError(f"corrupt zstd block {i}")
        elif codec == "zlib":
            # bounded at the block size (decompression-bomb defence,
            # same posture as the lz4/zstd paths)
            block = _codecs.bounded_inflate(payload, bsize, 15)
            if block is None:
                raise BloscError(f"corrupt zlib block {i}")
        else:
            raise BloscError(f"unsupported blosc codec: {codec}")
        if len(block) != bsize:
            raise BloscError(
                f"block {i} decoded {len(block)} of {bsize} bytes"
            )
        if flags & _BYTE_SHUFFLE:
            block = _unshuffle(block, typesize)
        elif flags & _BIT_SHUFFLE:
            block = _bit_unshuffle(block, typesize)
        out.extend(block)
    return bytes(out)


def blosc_compress(
    data: bytes,
    typesize: int = 1,
    cname: str = "lz4",
    shuffle=True,
    blocksize: int = 0,
) -> bytes:
    """Fixture/test-grade Blosc frame writer (valid frames, no tuning).
    ``blocksize`` 0 picks one block for small inputs, 256 KiB blocks
    otherwise (the c-blosc ballpark). ``shuffle``: True/"byte" for
    byte shuffle, "bit" for bit shuffle, False/None for none."""
    nbytes = len(data)
    if cname not in ("lz4", "zstd", "zlib"):
        raise BloscError(f"unsupported compressor: {cname}")
    if blocksize <= 0:
        blocksize = nbytes if nbytes <= (1 << 18) else (1 << 18)
    blocksize = max(blocksize, typesize, 1)
    if shuffle in (True, "byte"):
        shuffle_flag = _BYTE_SHUFFLE
    elif shuffle == "bit":
        shuffle_flag = _BIT_SHUFFLE
    elif shuffle in (False, None, "none"):
        shuffle_flag = 0
    else:
        raise BloscError(f"unknown shuffle mode: {shuffle!r}")
    flags = (_CODEC_IDS[cname] << 5) | shuffle_flag
    if nbytes == 0:
        header = struct.pack(
            "<BBBBiii", 2, 1, flags, typesize, 0, blocksize, _HEADER
        )
        return header
    nblocks = -(-nbytes // blocksize)
    chunks = []
    for i in range(nblocks):
        block = data[i * blocksize : (i + 1) * blocksize]
        if shuffle_flag == _BYTE_SHUFFLE:
            block = _shuffle(block, typesize)
        elif shuffle_flag == _BIT_SHUFFLE:
            block = _bit_shuffle(block, typesize)
        if cname == "lz4":
            comp = lz4_block_compress(block)
        elif cname == "zstd":
            comp = _zstd.ZstdCompressor().compress(block)
        else:
            comp = _zlib.compress(block)
        if len(comp) >= len(block):
            comp = block  # store raw (csize == bsize signals it)
        chunks.append(comp)
    starts_end = _HEADER + 4 * nblocks
    bstarts = []
    pos = starts_end
    for comp in chunks:
        bstarts.append(pos)
        pos += 4 + len(comp)
    cbytes = pos
    frame = bytearray(
        struct.pack(
            "<BBBBiii", 2, 1, flags, typesize, nbytes, blocksize, cbytes
        )
    )
    frame.extend(struct.pack(f"<{nblocks}i", *bstarts))
    for comp in chunks:
        frame.extend(struct.pack("<i", len(comp)))
        frame.extend(comp)
    return bytes(frame)
