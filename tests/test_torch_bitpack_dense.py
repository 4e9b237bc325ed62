"""The port's dense bit packer (``pack_tokens_dense``: plain version on the
CPU, CUDA kernel on the card) against the JAX package's vmapped scan
packer ``device_deflate._pack_bits_scan``, the oracle its tests pin both
Pallas packers to (their interpret path does not run on this tree's
jax). Tolerance: zero (packed bytes and bit totals).

The JAX package is imported by fixtures, so that the ``cuda``-marked cases
also run where only PyTorch is installed
(``python -m pytest tests/test_torch_bitpack_dense.py -m cuda --noconftest``)."""

import numpy as np
import pytest
import torch

from omero_ms_pixel_buffer_tpu_torch.ops.kernels import launch_counts
from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack import pack_tokens_sp_plain
from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack_dense import (
    DENSE_TILE,
    OPS_PER_TOKEN,
    SPAN,
    dense_tiles,
    dense_workspace_bytes,
    pack_tokens_dense,
    pack_tokens_dense_plain,
)
from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack_edges import SP_EDGES, sp_edge_case


def _tokens(rng, lanes, ntok):
    """Random valid tokens: bit counts in [0, 21] with zero-length tokens,
    a 21-bit first token in every lane, a last lane of 1-bit tokens;
    values below 2^nbits (20 significant bits at most)."""
    nbits = rng.integers(0, 22, (lanes, ntok)).astype(np.int32)
    nbits[:, 3::7] = 0  # zero-length tokens (run interiors, padding)
    nbits[:, :1] = 21  # a full-width token
    nbits[-1] = 1  # a lane of 1-bit tokens
    vals = rng.integers(0, 1 << 20, (lanes, ntok)).astype(np.int64)
    vals &= (1 << np.minimum(nbits, 20)) - 1
    return vals.astype(np.int32), nbits


def _maxbits(nbits):
    return int(-(-int(nbits.sum(axis=1).max()) // 1024) * 1024 + 1024)


@pytest.fixture(scope="module")
def jax_pack():
    """The JAX package's scan packer, vmapped over lanes: (bits, nbits,
    maxbits) numpy arrays -> (packed bytes, bit totals)."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from omero_ms_pixel_buffer_tpu.ops.device_deflate import _pack_bits_scan

    def pack(bits, nbits, maxbits):
        fn = jax.jit(jax.vmap(lambda b, n: _pack_bits_scan(b, n, maxbits)))
        packed, totals = fn(jnp.asarray(bits.astype(np.uint32)), jnp.asarray(nbits))
        return np.asarray(packed), np.asarray(totals)

    return pack


@pytest.mark.parametrize(
    "ntok,maxbits",
    [(1, None), (257, None), (5003, None), (600, 1024)],
    ids=["ntok1", "ntok257", "ntok5003", "truncated_at_1024_bits"],
)
def test_dense_matches_jax_scan(jax_pack, ntok, maxbits):
    rng = np.random.default_rng(ntok)
    bits, nbits = _tokens(rng, 3, ntok)
    maxbits = maxbits or _maxbits(nbits)
    if maxbits == 1024:
        assert nbits.sum(axis=1).max() > 2 * maxbits  # really truncates
    want_p, want_t = jax_pack(bits, nbits, maxbits)
    before = launch_counts()["bitpack_dense"]
    got_p, got_t = pack_tokens_dense(torch.from_numpy(bits), torch.from_numpy(nbits), maxbits)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    assert launch_counts()["bitpack_dense"] == before  # CPU: the plain version


def test_dense_equals_sp_across_chunks(monkeypatch):
    """Blocks taken in several chunks give the same bytes as in one."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import bitpack_dense

    rng = np.random.default_rng(5)
    bits, nbits = _tokens(rng, 2, 3000)
    b, n = torch.from_numpy(bits), torch.from_numpy(nbits)
    maxbits = _maxbits(nbits)
    monkeypatch.setattr(bitpack_dense, "_CHUNK_BYTES", 8 * SPAN * 256 * 3)
    got = pack_tokens_dense_plain(b, n, maxbits)
    want = pack_tokens_sp_plain(b, n, maxbits)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_formulation_constants_match_jax():
    pytest.importorskip("jax")
    from omero_ms_pixel_buffer_tpu.ops.pallas.bitpack import _SPAN, emit_ops_per_token

    assert SPAN == _SPAN == 170
    assert OPS_PER_TOKEN == emit_ops_per_token("dense") == 1036


def test_rejects_bad_arguments():
    z = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        pack_tokens_dense(z, z[:1], 64)
    with pytest.raises(ValueError):
        pack_tokens_dense(z, z, 100)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ntok", [1, 257, 70001], ids=lambda n: f"ntok{n}")
def test_cuda_kernel_matches_plain(cuda_device, ntok):
    rng = np.random.default_rng(ntok)
    bits, nbits = _tokens(rng, 4, ntok)
    maxbits = _maxbits(nbits)
    b = torch.from_numpy(bits).to(cuda_device)
    n = torch.from_numpy(nbits).to(cuda_device)
    before = pack_tokens_dense.launches
    got_p, got_t = pack_tokens_dense(b, n, maxbits)
    assert pack_tokens_dense.launches == before + 1
    want_p, want_t = pack_tokens_dense_plain(b, n, maxbits)
    torch.testing.assert_close(got_p, want_p, rtol=0, atol=0)
    torch.testing.assert_close(got_t, want_t, rtol=0, atol=0)
    truncated = pack_tokens_dense(b, n, 1024)[0]
    torch.testing.assert_close(truncated, pack_tokens_dense_plain(b, n, 1024)[0], rtol=0, atol=0)


def test_workspace_covers_every_tile():
    """A lane's row starts up to 3 tokens into its first tile, so a lane of
    DENSE_TILE - 3 tokens fits one tile and one more token needs a second;
    a lane of no tokens still has one tile (it writes the zero words)."""
    assert [dense_tiles(n) for n in (0, 1, DENSE_TILE - 3, DENSE_TILE - 2, 524_801)] == [
        1, 1, 1, 2, 129]
    assert dense_workspace_bytes(32, 524_801) == 8 + 16 * 32 * 129


@pytest.mark.parametrize("geometry", list(SP_EDGES))
def test_plain_edge_geometries_match_sp_plain(geometry):
    """The kernel's edge cases through the plain version on the CPU: the
    same bytes as the scan packer."""
    bits, nbits, maxbits = sp_edge_case(geometry, 37)
    b, n = torch.from_numpy(bits), torch.from_numpy(nbits)
    got = pack_tokens_dense(b, n, maxbits)
    want = pack_tokens_sp_plain(b, n, maxbits)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _cuda_matches_plain(bits, nbits, maxbits):
    """Kernel against plain version on the card: byte-equal, one launch."""
    before = pack_tokens_dense.launches
    got_p, got_t = pack_tokens_dense(bits, nbits, maxbits)
    assert pack_tokens_dense.launches == before + 1
    want_p, want_t = pack_tokens_dense_plain(bits, nbits, maxbits)
    torch.testing.assert_close(got_p, want_p, rtol=0, atol=0)
    torch.testing.assert_close(got_t, want_t, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", list(SP_EDGES))
def test_cuda_kernel_edge_geometries(cuda_device, geometry):
    """Every edge case: odd ntok (misaligned rows), zero-length lanes,
    tiles under 32 bits, single tokens, truncation, long zero tails."""
    bits, nbits, maxbits = sp_edge_case(geometry, 29)
    _cuda_matches_plain(torch.from_numpy(bits).to(cuda_device),
                        torch.from_numpy(nbits).to(cuda_device), maxbits)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,ntok", [(3, 0), (2, 5), (4, 2 * DENSE_TILE + 7)],
                         ids=["no_tokens", "lanes_of_zero_bits", "one_zero_bit_lane"])
def test_cuda_kernel_zero_length_lanes(cuda_device, lanes, ntok):
    rng = np.random.default_rng(41)
    bits, nbits = _tokens(rng, lanes, max(ntok, 1))
    bits, nbits = bits[:, :ntok].copy(), nbits[:, :ntok].copy()
    if ntok < 10:
        bits[:], nbits[:] = 0, 0
    else:
        bits[1], nbits[1] = 0, 0
    _cuda_matches_plain(torch.from_numpy(bits).to(cuda_device),
                        torch.from_numpy(nbits).to(cuda_device), 4096)


@pytest.mark.cuda
@pytest.mark.parametrize("pads", [(1, 1), (2, 2), (1, 2)], ids=lambda p: f"pads{p[0]}{p[1]}")
def test_cuda_kernel_misaligned_views(cuda_device, pads):
    """Token arrays that start one or two int32 past an aligned allocation:
    misaligned alike they keep the 16-byte loads, misaligned differently
    they take the scalar ones."""
    bits, nbits = _tokens(np.random.default_rng(31), 3, 2 * DENSE_TILE + 5)
    maxbits = _maxbits(nbits)

    def view(a, pad):
        flat = torch.from_numpy(np.concatenate([np.zeros(pad, np.int32), a.ravel()]))
        return flat.to(cuda_device)[pad:].view(a.shape)

    b, n = view(bits, pads[0]), view(nbits, pads[1])
    assert b.data_ptr() % 16 == 4 * pads[0] and n.data_ptr() % 16 == 4 * pads[1]
    _cuda_matches_plain(b, n, maxbits)
