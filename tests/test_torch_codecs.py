"""The port's TIFF block codecs (``ops/codecs.py``) and its native batch
decoder (``runtime/native.py`` ``decode_batch``) against the JAX
package's, on the same seeded inputs made with numpy.

Every encoder's bytes, every decoder's output on good streams and its
answer on hostile ones (None at the same caps: truncated, corrupt,
overflowing the capacity, declaring a larger zstd frame) and the
predictor both ways must be equal. Tolerance: zero (bytes)."""

import zlib

import numpy as np
import pytest

from omero_ms_pixel_buffer_tpu.ops import codecs as jc
from omero_ms_pixel_buffer_tpu_torch.ops import codecs as pc

try:
    import zstandard
except ImportError:  # the decoders answer None without it, in both packages
    zstandard = None


def _smooth(n, seed):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.integers(-3, 4, n), dtype=np.int64).astype(np.uint8).tobytes()


def _noise(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _runs(n, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 4, n // 7 + 1, dtype=np.uint8)
    return np.repeat(vals, rng.integers(1, 14, vals.size))[:n].tobytes()


DATA = {
    "smooth_70k": _smooth(70_000, 1),  # crosses the 9..12-bit LZW widths and a Clear
    "noise_5k": _noise(5_000, 2),
    "runs_3k": _runs(3_000, 3),
    "one_byte": b"\x07",
}


@pytest.mark.parametrize("name", sorted(DATA))
def test_lzw_encode_decode_equal(name):
    data = DATA[name]
    enc = pc.lzw_encode(data)
    assert enc == jc.lzw_encode(data)
    assert pc.lzw_decode(enc, len(data)) == jc.lzw_decode(enc, len(data)) == data
    # a cap below the data: both truncate at it
    cap = max(1, len(data) // 3)
    assert pc.lzw_decode(enc, cap) == jc.lzw_decode(enc, cap) == data[:cap]


@pytest.mark.parametrize("name", sorted(DATA))
@pytest.mark.parametrize("row_bytes", [1, 37, 256])
def test_packbits_encode_decode_equal(name, row_bytes):
    data = DATA[name]
    enc = pc.packbits_encode(data, row_bytes)
    assert enc == jc.packbits_encode(data, row_bytes)
    assert pc.packbits_decode(enc, len(data)) == jc.packbits_decode(enc, len(data)) == data


def test_packbits_encode_row_equal():
    rng = np.random.default_rng(5)
    for trial in range(60):
        n = int(rng.integers(1, 400))
        row = rng.integers(0, int(rng.integers(2, 256)), n).astype(np.uint8).tobytes()
        assert pc.packbits_encode_row(row) == jc.packbits_encode_row(row), trial


def _lzw_hostile():
    enc = jc.lzw_encode(DATA["smooth_70k"][:4000])
    return {
        "empty": (b"", 100),
        "nonliteral_first": (b"\xff\xff\xff\xff", 100),
        "truncated": (enc[: len(enc) // 2], 4000),
        "garbage": (_noise(300, 9), 5000),
        "no_eoi_short": (enc[:-2], 4000),
    }


@pytest.mark.parametrize("case", sorted(_lzw_hostile()))
def test_lzw_hostile_equal(case):
    data, cap = _lzw_hostile()[case]
    assert pc.lzw_decode(data, cap) == jc.lzw_decode(data, cap)


PACKBITS_HOSTILE = {
    "literal_past_end": (b"\x05ab", 10),
    "repeat_without_byte": (b"\xfe", 10),
    "noop_only": (b"\x80\x80", 4),
    "overflow_cap": (b"\x81x" * 10, 5),
    "noise": (_noise(200, 4), 300),
}


@pytest.mark.parametrize("case", sorted(PACKBITS_HOSTILE))
def test_packbits_hostile_equal(case):
    data, cap = PACKBITS_HOSTILE[case]
    assert pc.packbits_decode(data, cap) == jc.packbits_decode(data, cap)


def _inflate_cases():
    good = zlib.compress(DATA["smooth_70k"], 6)
    return {
        "exact": (good, 70_000),
        "over_cap": (good, 69_999),
        "truncated": (good[:-9], 70_000),
        "garbage": (b"\x78\x9cjunkjunk", 100),
        "gzip_wrapper_as_zlib": (b"\x1f\x8b" + good[2:], 70_000),
    }


@pytest.mark.parametrize("case", sorted(_inflate_cases()))
def test_bounded_inflate_equal(case):
    data, cap = _inflate_cases()[case]
    assert pc.bounded_inflate(data, cap) == jc.bounded_inflate(data, cap)


def _zstd_cases():
    if zstandard is None:
        return {"no_codec": (b"\x28\xb5\x2f\xfd" + b"\x00" * 8, 100)}
    raw = DATA["runs_3k"]
    frame = zstandard.ZstdCompressor(level=3).compress(raw)
    unsized = zstandard.ZstdCompressor(write_content_size=False).compress(raw)
    declared_huge = bytearray(zstandard.ZstdCompressor().compress(b"\x00" * 70000))
    return {
        "exact": (frame, len(raw)),
        "declared_over_cap": (frame, len(raw) - 1),
        "unsized_over_cap": (unsized, len(raw) - 1),
        "unsized_exact": (unsized, len(raw)),
        "truncated": (frame[:-5], len(raw)),
        "garbage": (_noise(64, 6), 1000),
        "declared_70k_cap_10": (bytes(declared_huge), 10),
    }


@pytest.mark.parametrize("case", sorted(_zstd_cases()))
def test_bounded_zstd_equal(case):
    data, cap = _zstd_cases()[case]
    assert pc.bounded_zstd(data, cap) == jc.bounded_zstd(data, cap)


@pytest.mark.parametrize("itemsize,bo", [(1, "<"), (2, "<"), (2, ">"), (4, ">"), (8, "<")])
@pytest.mark.parametrize("samples", [1, 3])
def test_predictor2_both_ways_equal(itemsize, bo, samples):
    rng = np.random.default_rng(17 + itemsize + samples)
    w, rows = 23, 5
    block = rng.integers(0, 256, rows * w * samples * itemsize, dtype=np.uint8)
    fwd_p = pc.apply_predictor2(block.copy(), w * samples, itemsize, samples, bo)
    fwd_j = jc.apply_predictor2(block.copy(), w * samples, itemsize, samples, bo)
    assert fwd_p.tobytes() == fwd_j.tobytes()
    back_p = pc.undo_predictor2(fwd_p.copy(), w * samples, itemsize, samples, bo)
    back_j = jc.undo_predictor2(fwd_j.copy(), w * samples, itemsize, samples, bo)
    assert back_p.tobytes() == back_j.tobytes() == block.tobytes()


def _batch():
    smooth = DATA["smooth_70k"][:20_000]
    lzw = jc.lzw_encode(smooth)
    return [
        (zlib.compress(smooth), 20_000, 8),
        (lzw, 20_000, 5),
        (jc.packbits_encode(DATA["runs_3k"], 100), 3_000, 32773),
        (b"\x78\x9cjunk", 500, 8),                # corrupt zlib
        (lzw[: len(lzw) // 3], 20_000, 5),       # truncated LZW
        (b"\x05ab", 50, 32773),                   # PackBits literal past the end
        (zlib.compress(smooth), 19_999, 8),       # over its capacity
    ]


def test_native_decode_batch_equals_jax():
    """One batch of mixed codecs with corrupt lanes through the port's
    native binding against the JAX package's: the same arrays, None on
    the same lanes."""
    from omero_ms_pixel_buffer_tpu.runtime.native import get_engine as jax_engine
    from omero_ms_pixel_buffer_tpu_torch.runtime.native import get_engine

    port, ref = get_engine(), jax_engine()
    if port is None or ref is None:
        pytest.skip("the native engine does not build here")
    raws, caps, codes = zip(*_batch())
    got = port.decode_batch(list(raws), list(caps), list(codes))
    want = ref.decode_batch(list(raws), list(caps), list(codes))
    for g, w, code in zip(got, want, codes):
        if w is None:
            assert g is None, code
        else:
            assert g is not None and g.tobytes() == w.tobytes(), code
