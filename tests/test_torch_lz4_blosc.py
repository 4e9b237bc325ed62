"""The port's LZ4 block and Blosc container codecs (``ops/lz4.py``,
``ops/blosc.py``) against the JAX package's on the same inputs, made from
a seed with numpy. Tolerance: zero — compressed frames and decoded bytes
are compared byte for byte, hostile streams must raise the same error
class, and the LZ4 block spec's hand-built vectors decode in the port."""

import struct

import numpy as np
import pytest

from conftest import needs_zstd

from omero_ms_pixel_buffer_tpu.ops import blosc as jblosc
from omero_ms_pixel_buffer_tpu.ops import lz4 as jlz4
from omero_ms_pixel_buffer_tpu_torch.ops import blosc as pblosc
from omero_ms_pixel_buffer_tpu_torch.ops import lz4 as plz4


def _data(kind: str, n: int, seed: int = 61) -> bytes:
    """Random, runny (compressible) or smooth 16-bit data of ``n`` bytes."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, n).astype(np.uint8).tobytes()
    if kind == "runny":
        return np.repeat(rng.integers(0, 5, n // 8 + 1), 8).astype(np.uint8).tobytes()[:n]
    field = 2000 + 800 * np.sin(np.arange(n // 2 + 1) / 37.0) + rng.normal(0, 20, n // 2 + 1)
    return field.astype("<u2").tobytes()[:n]


@pytest.mark.parametrize("kind", ["random", "runny", "smooth"])
@pytest.mark.parametrize("n", [0, 1, 4, 12, 13, 64, 1000, 70_000])
def test_lz4_block_bytes_match_jax(kind, n):
    data = _data(kind, n)
    comp = plz4.lz4_block_compress(data)
    assert comp == jlz4.lz4_block_compress(data)
    assert plz4.lz4_block_decompress(comp, n) == jlz4.lz4_block_decompress(comp, n) == data


def test_lz4_far_match_offset_boundary():
    block = _data("random", 70_000)
    data = block + block[:100]
    comp = plz4.lz4_block_compress(data)
    assert comp == jlz4.lz4_block_compress(data)
    assert plz4.lz4_block_decompress(comp, len(data)) == data


# hand-built vectors of lz4_Block_format.html (tests/test_lz4_blosc.py)
SPEC_VECTORS = [
    (b"\x50hello", 5, b"hello"),                       # literals only
    (b"\x11a\x01\x00", 6, b"aaaaaa"),                  # overlapping match
    (b"\x40abcd\x04\x00", 8, b"abcdabcd"),             # match from a distance
    (b"\xf0\x05" + bytes(range(20)), 20, bytes(range(20))),  # extended literals
    (b"\x1fx\x01\x00\x0a", 30, b"x" * 30),             # extended match length
    (b"\x1fx\x01\x00\xff\x03", 278, b"x" * 278),       # 255-saturated extension
]


@pytest.mark.parametrize("data,out_size,want", SPEC_VECTORS)
def test_lz4_spec_vectors(data, out_size, want):
    assert plz4.lz4_block_decompress(data, out_size) == want
    assert jlz4.lz4_block_decompress(data, out_size) == want


HOSTILE_LZ4 = [
    (b"\x11a\x00\x00", 6),    # offset 0
    (b"\x11a\x05\x00", 6),    # offset beyond the output
    (b"\x50hel", 5),          # truncated literals
    (b"\x11a\x01", 6),        # truncated offset
    (b"\x50hello", 3),        # literal overrun
    (b"\x11a\x01\x00", 3),    # match overrun
    (b"\x50hello", 9),        # short output
    (b"", 4),                 # no token
    (b"\x00", 0),             # trailing input for an empty output
    (b"\x50hello", -1),       # negative size
]


@pytest.mark.parametrize("data,out_size", HOSTILE_LZ4)
def test_lz4_hostile_streams_raise_the_same_error(data, out_size):
    with pytest.raises(jlz4.Lz4Error):
        jlz4.lz4_block_decompress(data, out_size)
    with pytest.raises(plz4.Lz4Error) as info:
        plz4.lz4_block_decompress(data, out_size)
    assert type(info.value).__name__ == "Lz4Error" and isinstance(info.value, ValueError)


CNAMES = ["lz4", "zlib", pytest.param("zstd", marks=needs_zstd)]


@pytest.mark.parametrize("cname", CNAMES)
@pytest.mark.parametrize("typesize,shuffle", [
    (1, False), (2, True), (2, "bit"), (4, True), (4, "bit"), (8, True), (2, None),
])
@pytest.mark.parametrize("blocksize", [0, 4096])
def test_blosc_frames_match_jax(cname, typesize, shuffle, blocksize):
    data = _data("smooth", 20_000 + 3)
    frame = pblosc.blosc_compress(data, typesize=typesize, cname=cname, shuffle=shuffle,
                                  blocksize=blocksize)
    assert frame == jblosc.blosc_compress(data, typesize=typesize, cname=cname,
                                          shuffle=shuffle, blocksize=blocksize)
    assert pblosc.blosc_decompress(frame, len(data)) == data
    assert jblosc.blosc_decompress(frame, len(data)) == data


@pytest.mark.parametrize("kind", ["random", "runny"])
def test_blosc_incompressible_and_multi_block(kind):
    data = _data(kind, 300_000)
    frame = pblosc.blosc_compress(data, typesize=2)
    assert frame == jblosc.blosc_compress(data, typesize=2)
    assert pblosc.blosc_decompress(frame) == data


def test_blosc_empty_and_memcpyed():
    assert pblosc.blosc_compress(b"") == jblosc.blosc_compress(b"")
    assert pblosc.blosc_decompress(pblosc.blosc_compress(b"")) == b""
    payload = bytes(range(40))
    frame = struct.pack("<BBBBiii", 2, 1, 0x2, 1, 40, 40, 16 + 40) + payload
    assert pblosc.blosc_decompress(frame) == jblosc.blosc_decompress(frame) == payload


def _hostile_blosc():
    good = jblosc.blosc_compress(_data("smooth", 4000), typesize=2)
    bad_start = bytearray(good)
    struct.pack_into("<i", bad_start, 16, 4)  # bstart inside the header
    snappy = bytearray(good)
    snappy[2] = (2 << 5) | 0x1  # snappy codec id
    both = bytearray(good)
    both[2] |= 0x4  # byte and bit shuffle at once
    return [
        (b"\x02\x01", -1),                  # truncated header
        (good[:-3], -1),                    # cbytes != length
        (b"\x03" + good[1:], -1),           # version 3
        (good, 100),                        # over the expected capacity
        (bytes(bad_start), -1),
        (bytes(snappy), -1),
        (bytes(both), -1),
        (good[:16] + b"\x00" * (len(good) - 16), -1),  # zeroed offsets
    ]


@pytest.mark.parametrize("case", range(8))
def test_blosc_hostile_frames_raise_the_same_error(case):
    frame, cap = _hostile_blosc()[case]
    with pytest.raises(jblosc.BloscError):
        jblosc.blosc_decompress(frame, cap)
    with pytest.raises(pblosc.BloscError) as info:
        pblosc.blosc_decompress(frame, cap)
    assert type(info.value).__name__ == "BloscError" and isinstance(info.value, ValueError)


@pytest.mark.parametrize("typesize", [1, 2, 4])
def test_bit_shuffle_planes_match_jax(typesize):
    block = _data("random", 8 * typesize * 37 + 5)
    assert pblosc._bit_shuffle(block, typesize) == jblosc._bit_shuffle(block, typesize)
    assert pblosc._bit_unshuffle(pblosc._bit_shuffle(block, typesize), typesize) == block
