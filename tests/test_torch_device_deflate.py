"""The port's two-pass dynamic-Huffman chain against the JAX package's
``ops/device_deflate`` on the same tiles (JAX CPU path: XLA filter +
scan packer). Tolerance: zero — pass-1 payloads and counts, the host
tables, and the pass-2 zlib streams are byte contracts."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omero_ms_pixel_buffer_tpu.ops import device_deflate as jdd
from omero_ms_pixel_buffer_tpu_torch.ops import device_deflate as tdd
from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor

H, W = 40, 48


def _field(lanes, seed=0, noise=40.0):
    """Smooth field + noise: run-heavy after the Up filter, like
    microscopy tiles (the dynamic code wins on these lanes)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = 2000 + 1500 * np.sin(xx / 9.0) + 1500 * np.cos(yy / 13.0)
    data = base + rng.normal(0, noise, (lanes, H, W))
    return data.clip(0, 65535).astype(np.uint16)


def _pass1_both(tiles, rows, w):
    row_bytes = 1 + w * 2
    jout = jdd.fused_filter_histogram_batch(jnp.asarray(tiles), rows, row_bytes, 2)
    tout = tdd.fused_filter_histogram_batch(bits_tensor(tiles), rows, row_bytes, 2)
    return jout, tout


def test_pass1_matches():
    tiles = _field(3)
    (jf, jc, je, jb), (tf, tc, te, tb) = _pass1_both(tiles, 31, 37)
    assert jb == tb == 3
    assert tf.shape == (4, 31 * (1 + 37 * 2))  # lanes pow2-padded
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_tables_match():
    tiles = _field(4, seed=1)
    (_, jc, je, _), (_, tc, te, _) = _pass1_both(tiles, H, W)
    want = jdd.build_dynamic_tables(np.asarray(jc), np.asarray(je))
    got = tdd.build_dynamic_tables(tc.numpy(), te.numpy())
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # lanes took their own dynamic code: header token 0 is BFINAL=1,
    # BTYPE=10 (LSB-first value 5) instead of the fixed header's 3
    assert (got[0][:, 0] == 5).any()


def test_pass2_matches_with_shared_tables():
    tiles = _field(3, seed=2)
    (jf, jc, je, jb), (tf, _, _, _) = _pass1_both(tiles, H, W)
    tables = jdd.build_dynamic_tables(np.asarray(jc), np.asarray(je), real=jb)
    want_s, want_l = jdd._zlib_dynamic(jf, *tables, packer="scan", interpret=False)
    got_s, got_l = tdd.dynamic_emit(tf, tdd.tables_from_numpy(tables, "cpu"))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    for i in range(jb):
        raw = got_s[i, : int(got_l[i])].numpy().tobytes()
        assert zlib.decompress(raw) == tf[i].numpy().tobytes()


def test_white_noise_lane_takes_stored_fallback():
    rng = np.random.default_rng(4)
    tiles = _field(2, seed=4)
    tiles[1] = rng.integers(0, 65535, (H, W), dtype=np.uint16)
    (jf, jc, je, jb), (tf, tc, te, tb) = _pass1_both(tiles, H, W)
    want_s, want_l = jdd.dynamic_emit_batch(jf, np.asarray(jc), np.asarray(je), real=jb)
    got_s, got_l = tdd.dynamic_emit_batch(tf, tc.numpy(), te.numpy(), real=tb)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    payload_len = tf.shape[1]
    stored = tdd.stored_stream_len(payload_len)
    assert int(got_l[1]) == stored
    assert got_s[1, 2] == 1  # BFINAL=1, BTYPE=00: a stored block
    assert (got_l <= stored).all()
    assert int(got_l[0]) < stored
    for i in range(tb):
        raw = got_s[i, : int(got_l[i])].numpy().tobytes()
        assert zlib.decompress(raw) == tf[i].numpy().tobytes()


def test_pow2_padding_with_three_real_lanes():
    tiles = _field(3, seed=5)
    (jf, jc, je, jb), (tf, tc, te, tb) = _pass1_both(tiles, H, W)
    assert tb == 3 and tf.shape[0] == 4
    got_s, got_l = tdd.dynamic_emit_batch(tf, tc.numpy(), te.numpy(), real=3)
    want_s, want_l = jdd.dynamic_emit_batch(jf, np.asarray(jc), np.asarray(je), real=3)
    assert got_s.shape[0] == 3 and got_l.shape == (3,)
    assert got_s.shape[1] == tdd.max_stream_len(tf.shape[1])
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    # pad lanes keep the fixed tables
    tables = tdd.build_dynamic_tables(tc.numpy(), te.numpy(), real=3)
    assert tables[0][3, 0] == 3 and tables[7][3] == 7


def test_bpp_must_match_tiles():
    with pytest.raises(ValueError):
        tdd.fused_filter_histogram_batch(
            torch.zeros((1, 4, 4), dtype=torch.int16), 4, 9, 1
        )
