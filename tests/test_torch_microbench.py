"""The port's kernel microbenchmarks (``runtime/microbench.py``) against
the JAX package's ``runtime/microbench.py``.

On the CPU at ``batch=2, tile=64, plane=256``: the synthetic fixtures are
the same arrays from the same seed; ``run_microbench`` gives JAX's key
set (nested dicts included); its deterministic values equal JAX's (the
batch and tile, the device and host stream bytes and their ratios, the
compression, the emit op counts); every rate and time is positive; and
``project_throughput`` of one dict is the same in both. ``cuda``: on the
card, the byte and ratio keys equal the CPU run's (the kernels are
byte-equal to their plain versions). Tolerance: zero (keys and
deterministic values)."""

import numpy as np
import pytest
import torch

from omero_ms_pixel_buffer_tpu_torch.runtime import microbench as pmb

SMALL = dict(batch=2, tile=64, plane=256)
# values that depend only on the inputs, never on a clock
DETERMINISTIC = ("batch", "tile", "device_bytes_per_tile", "host_bytes_per_tile",
                 "deflate_ratio_vs_host", "deflate_compression_x",
                 "deflate_ratio_vs_host_dynamic", "deflate_ratio_vs_host_rle_rgb",
                 "emit_ops_per_token")
RATES = ("filter_gbps", "filter_ms_per_batch", "filter_gbps_xla", "deflate_gbps",
         "deflate_ms_per_batch", "pack_gbps", "pack_gbps_gather", "pack_speedup_vs_gather",
         "batch_ms_steady", "chain_tiles_per_sec_compute", "deflate_dynamic_gbps")


@pytest.fixture(scope="module")
def runs():
    from omero_ms_pixel_buffer_tpu.runtime import microbench as jmb

    return jmb.run_microbench(**SMALL), pmb.run_microbench(**SMALL, device="cpu")


def _keys(d: dict, prefix: str = "") -> set:
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


@pytest.mark.parametrize("fixture", ["synth_tiles", "synth_rgb_tiles"])
def test_fixtures_match_jax(fixture):
    from omero_ms_pixel_buffer_tpu.runtime import microbench as jmb

    for shape, seed in (((3, 40, 56), 5), ((1, 64, 64), 11)):
        want = getattr(jmb, fixture)(*shape, seed=seed)
        got = getattr(pmb, fixture)(*shape, seed=seed)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_keys_match_jax(runs):
    jax_out, port_out = runs
    assert _keys(port_out) == _keys(jax_out)
    assert port_out["backend"] == jax_out["backend"] == "cpu"
    assert set(port_out["stage_breakdown"]) == {"h2d_ms", "compute_ms", "d2h_ms", "pack_gbps"}


@pytest.mark.parametrize("key", DETERMINISTIC)
def test_deterministic_values_match_jax(runs, key):
    jax_out, port_out = runs
    assert port_out[key] == jax_out[key]


@pytest.mark.parametrize("key", RATES)
def test_rates_are_positive(runs, key):
    _, port_out = runs
    assert port_out[key] > 0


@pytest.mark.parametrize("link_mbps", [None, 10.0, 1250.0])
def test_project_throughput_matches_jax(runs, link_mbps):
    from omero_ms_pixel_buffer_tpu.runtime import microbench as jmb

    jax_out, port_out = runs
    for micro in (jax_out, port_out, {"batch": 2}):
        assert pmb.project_throughput(micro, link_mbps) == jmb.project_throughput(micro, link_mbps)
    assert pmb._PNG_FRAME_BYTES == jmb._PNG_FRAME_BYTES == 57


def test_emit_ops_match_jax():
    from omero_ms_pixel_buffer_tpu.ops.pallas.bitpack import emit_ops_per_token as jax_ops
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack_dense import emit_ops_per_token

    for kind in ("dense", "sp"):
        assert emit_ops_per_token(kind) == jax_ops(kind)
    with pytest.raises(ValueError):
        emit_ops_per_token("bogus")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
def test_cuda_run_matches_the_cpu_bytes(cuda_device):
    cpu = pmb.run_microbench(**SMALL, device="cpu")
    card = pmb.run_microbench(**SMALL, device=cuda_device)
    assert card["backend"] == "cuda" and _keys(card) == _keys(cpu)
    for key in DETERMINISTIC:
        assert card[key] == cpu[key], key
