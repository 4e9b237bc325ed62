"""The port's one-pass device deflate modes ``rle`` and ``stored`` and its
packer choice against the JAX package's ``ops/device_deflate`` on the
same tiles (JAX CPU path: XLA filter + scan packer), for every packer
name. Tolerance: zero — zlib streams and lengths are byte contracts, and
every stream must inflate back to its payload."""

import functools
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omero_ms_pixel_buffer_tpu.ops import device_deflate as jdd
from omero_ms_pixel_buffer_tpu_torch.__main__ import _parse
from omero_ms_pixel_buffer_tpu_torch.io.pixels_service import ImageRegistry, PixelsService
from omero_ms_pixel_buffer_tpu_torch.models.device_dispatch import DeviceEncodeDispatcher
from omero_ms_pixel_buffer_tpu_torch.models.tile_pipeline import TilePipeline
from omero_ms_pixel_buffer_tpu_torch.ops import device_deflate as tdd
from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor

LANES = 5  # pow2-padded to 8 inside the chain
PACKERS = ("scan", "pallas", "pallas_dense", "gather")


@functools.lru_cache(maxsize=None)
def _tiles(h, w, dtype):
    """Smooth field + noise (runs after the Up filter) with one white-noise
    lane (which takes the stored fallback in rle)."""
    rng = np.random.default_rng(h * w)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 2000 + 1500 * np.sin(xx / 9.0) + 1500 * np.cos(yy / 13.0)
    data = (base + rng.normal(0, 40, (LANES, h, w))).clip(0, 65535)
    data[2] = rng.integers(0, 65535, (h, w))
    data = data.astype(np.uint16)
    return data if dtype == "u16" else (data >> 4).astype(np.uint8)


def _geometry(h, w, dtype, cropped):
    """(rows, row_bytes, bpp): a bucket-padded region when ``cropped``."""
    bpp = 2 if dtype == "u16" else 1
    rows, cols = (h - 3, w - 5) if cropped else (h, w)
    return rows, 1 + cols * bpp, bpp


@functools.lru_cache(maxsize=None)
def _jax_streams(h, w, dtype, cropped, mode):
    rows, row_bytes, bpp = _geometry(h, w, dtype, cropped)
    s, n = jdd.fused_filter_deflate_batch(
        jnp.asarray(_tiles(h, w, dtype)), rows, row_bytes, bpp, mode=mode, packer="scan")
    return np.asarray(s), np.asarray(n)


def _payloads(tiles, rows, row_bytes, bpp):
    flat, b = tdd._filtered_payloads(bits_tensor(tiles), rows, row_bytes, bpp, "up")
    return flat[:b].numpy()


CASES = [
    # (h, w, dtype, cropped, mode, packer): every packer in rle on small
    # lanes, the kernels' packers on 256x256, stored on both
    *[(48, 64, d, True, "rle", p) for d in ("u16", "u8") for p in PACKERS],
    *[(256, 256, d, False, "rle", p) for d in ("u16", "u8")
      for p in ("scan", "pallas", "pallas_dense")],
    *[(h, w, d, c, "stored", None) for h, w, c in ((48, 64, True), (256, 256, False))
      for d in ("u16", "u8")],
]


@pytest.mark.parametrize(
    "h,w,dtype,cropped,mode,packer", CASES,
    ids=[f"{m}-{p or 'default'}-{d}-{h}x{w}" for h, w, d, _, m, p in CASES],
)
def test_streams_match_jax(h, w, dtype, cropped, mode, packer):
    tiles = _tiles(h, w, dtype)
    rows, row_bytes, bpp = _geometry(h, w, dtype, cropped)
    got_s, got_l = tdd.fused_filter_deflate_batch(
        bits_tensor(tiles), rows, row_bytes, bpp, mode=mode, packer=packer)
    want_s, want_l = _jax_streams(h, w, dtype, cropped, mode)
    assert got_s.shape[0] == LANES
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_l.numpy(), want_l)
    payloads = _payloads(tiles, rows, row_bytes, bpp)
    stored = tdd.stored_stream_len(payloads.shape[1])
    for i in range(LANES):
        raw = got_s[i, : int(got_l[i])].numpy().tobytes()
        assert zlib.decompress(raw) == payloads[i].tobytes()
    if mode == "stored":
        assert got_s.shape[1] == stored and (got_l == stored).all()
    else:
        assert got_s.shape[1] == tdd.max_stream_len(payloads.shape[1])
        assert int(got_l[2]) == stored  # white noise: the stored fallback
        assert int(got_l[0]) < stored


@pytest.mark.parametrize("packer", ["pallas_dense", "gather"])
def test_dynamic_chain_with_named_packer_matches_jax(packer):
    """Dynamic mode's two passes with the packer named (``gather`` is
    rerouted to ``scan``, as in the JAX package)."""
    tiles = _tiles(48, 64, "u16")
    rows, row_bytes, bpp = _geometry(48, 64, "u16", True)
    want_s, want_l = jdd.fused_filter_deflate_batch(
        jnp.asarray(tiles), rows, row_bytes, bpp, mode="dynamic", packer="scan")
    flat, counts, extras, real = tdd.fused_filter_histogram_batch(
        bits_tensor(tiles), rows, row_bytes, bpp)
    got_s, got_l = tdd.dynamic_emit_batch(
        flat, counts.numpy(), extras.numpy(), packer=packer, real=real)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_rle_tokens_match_jax():
    payloads = _payloads(_tiles(48, 64, "u8"), 48, 65, 1)
    bits, nbits = tdd._lane_tokens(torch.from_numpy(payloads))
    for i, p in enumerate(payloads):
        jb, jn = jdd._lane_tokens(jnp.asarray(p))
        np.testing.assert_array_equal(bits[i].numpy(), np.asarray(jb).astype(np.int64))
        np.testing.assert_array_equal(nbits[i].numpy(), np.asarray(jn))
    assert bits.shape == (payloads.shape[0], payloads.shape[1] + 1)
    assert int(bits[0, 0]) == 3 and int(nbits[0, 0]) == 3  # BFINAL=1, BTYPE=01


def test_stored_batch_and_payload_checks():
    payloads = torch.from_numpy(_payloads(_tiles(48, 64, "u8"), 48, 65, 1))
    streams = tdd.zlib_stored_batch(payloads)
    np.testing.assert_array_equal(
        streams.numpy(), np.asarray(jdd.zlib_stored_batch(payloads.numpy())))
    with pytest.raises(ValueError):
        tdd.zlib_rle_batch(payloads[:, :0])
    with pytest.raises(ValueError):
        tdd.zlib_stored_batch(payloads[0])


def test_default_packer_honours_env_and_ignores_junk(monkeypatch):
    monkeypatch.delenv("OMPB_BITPACK", raising=False)
    assert tdd.default_packer("cuda") == "pallas"  # the default reaches a kernel
    assert tdd.default_packer("cpu") == "scan"
    for name in PACKERS:
        monkeypatch.setenv("OMPB_BITPACK", name)
        assert tdd.default_packer("cuda") == tdd.default_packer("cpu") == name
    monkeypatch.setenv("OMPB_BITPACK", "junk")
    assert tdd.default_packer("cuda") == "pallas"
    assert tdd.resolve_packer(None, "cpu") == "scan"
    with pytest.raises(ValueError):
        tdd.resolve_packer("junk", "cpu")


def test_unknown_modes_and_packers_raise():
    service = PixelsService(ImageRegistry())
    with pytest.raises(ValueError, match="deflate mode"):
        TilePipeline(service, device="cpu", device_deflate_mode="fast")
    with pytest.raises(ValueError, match="deflate mode"):
        _parse(["--registry", "r.json", "--deflate-mode", "fast"])
    assert _parse(["--registry", "r.json", "--deflate-mode", "rle"]).deflate_mode == "rle"
    assert _parse(["--registry", "r.json"]).deflate_mode == "dynamic"
    with pytest.raises(ValueError, match="packer"):
        DeviceEncodeDispatcher(torch.device("cpu"), packer="fast")
    tiles = bits_tensor(_tiles(48, 64, "u8"))
    for mode in ("fast", "dynamic"):  # the fused entry is one-pass only
        with pytest.raises(ValueError, match="deflate mode"):
            tdd.fused_filter_deflate_batch(tiles, 48, 65, 1, mode=mode)


def test_one_pass_group_reports_compute_stage():
    tiles = _tiles(48, 64, "u16")
    rows, row_bytes, bpp = _geometry(48, 64, "u16", True)
    q = DeviceEncodeDispatcher(torch.device("cpu"), packer="pallas_dense")
    try:
        out = q.submit(bits_tensor(tiles), rows, row_bytes, bpp, "up", "rle",
                       list(range(LANES)), [(64 - 5, rows)] * LANES, 16, 0).result(60)
        assert sorted(out) == list(range(LANES))
        snap = q.snapshot()
        assert snap["packer"] == "pallas_dense" and snap["failed"] == 0
        assert set(snap["stage_ms_mean"]) == {"stage", "compute", "pull", "frame"}
        assert snap["completed"] == 1
        assert snap["stage_groups"] == dict.fromkeys(snap["stage_ms_mean"], 1)
        assert set(snap["stage_ms_total"]) == set(snap["stage_ms_mean"])
        bad = q.submit(bits_tensor(tiles), rows, row_bytes, bpp, "up", "fast",
                       [0], [(1, 1)], 16, 0)
        with pytest.raises(ValueError, match="deflate mode"):
            bad.result(60)
        assert q.snapshot()["failed"] == 1
    finally:
        q.close()
