"""The port's bit packer (plain version on the CPU, CUDA kernel on the
card) against the JAX package's vmapped scan packer
``device_deflate._pack_bits_scan`` — the JAX CPU path, which the Pallas
packer is pinned to. Tolerance: zero (packed bytes and bit totals).

The JAX package is imported by the ``jax_ref`` fixture, so that the
``cuda``-marked cases also run where only PyTorch is installed
(``python -m pytest tests/test_torch_bitpack.py -m cuda --noconftest``)."""

import zlib

import numpy as np
import pytest
import torch

from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack import (
    SP_TILE,
    block_bases,
    pack_tokens_sp,
    pack_tokens_sp_plain,
    sp_tiles,
    sp_workspace_bytes,
)
from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack_edges import (
    SP_EDGES,
    padded_maxbits as _maxbits,
    random_tokens as _tokens,
    sp_edge_case as _edge,
)


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


@pytest.mark.parametrize("ntok", [257, 1000, 5003], ids=lambda n: f"ntok{n}")
def test_plain_matches_jax_scan(jax_pack, ntok):
    rng = np.random.default_rng(ntok)
    bits, nbits = _tokens(rng, 3, ntok, one_bit_lane=True)
    maxbits = _maxbits(nbits)
    want_p, want_t = jax_pack(bits, nbits, maxbits)
    got_p, got_t = pack_tokens_sp(torch.from_numpy(bits), torch.from_numpy(nbits), maxbits)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    np.testing.assert_array_equal(got_t.numpy(), want_t)


def test_truncates_at_maxbits_like_jax(jax_pack):
    rng = np.random.default_rng(1)
    bits, nbits = _tokens(rng, 2, 600)
    maxbits = 1024  # well below the lanes' totals
    want_p, _ = jax_pack(bits, nbits, maxbits)
    got_p, _ = pack_tokens_sp(torch.from_numpy(bits), torch.from_numpy(nbits), maxbits)
    np.testing.assert_array_equal(got_p.numpy(), want_p)


def test_stored_block_bits_inflate():
    """A packed stored-block deflate body (BFINAL=1, BTYPE=00, aligned
    LEN/NLEN and payload as 8-bit tokens) inflates to the payload."""
    payload = np.random.default_rng(3).integers(0, 256, 300, dtype=np.int32)
    n = payload.size
    hdr = [(1, 3), (0, 5), (n & 0xFF, 8), (n >> 8, 8),
           ((n & 0xFF) ^ 0xFF, 8), ((n >> 8) ^ 0xFF, 8)]
    bits = np.array([v for v, _ in hdr] + list(payload), np.int32)[None]
    nbits = np.array([b for _, b in hdr] + [8] * n, np.int32)[None]
    packed, total = pack_tokens_sp(torch.from_numpy(bits), torch.from_numpy(nbits), 4096)
    body = packed.numpy()[0, : (int(total[0]) + 7) // 8].tobytes()
    assert zlib.decompress(body, -15) == payload.astype(np.uint8).tobytes()


def test_block_bases_are_block_start_offsets():
    rng = np.random.default_rng(9)
    _, nbits = _tokens(rng, 2, 1000)
    t = torch.from_numpy(nbits)
    excl = torch.cumsum(t.long(), dim=1) - t.long()
    torch.testing.assert_close(block_bases(t), excl[:, ::256], rtol=0, atol=0)


def test_rejects_bad_arguments():
    z = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        pack_tokens_sp(z, z[:1], 64)
    with pytest.raises(ValueError):
        pack_tokens_sp(z, z, 100)


def test_workspace_covers_every_tile():
    """A lane's row starts up to 3 tokens into its first tile, so a lane of
    SP_TILE - 3 tokens fits one tile and one more token needs a second."""
    assert [sp_tiles(n) for n in (1, SP_TILE - 3, SP_TILE - 2, 525_121)] == [1, 1, 2, 129]
    assert sp_workspace_bytes(32, 525_121) == 8 + 16 * 32 * 129


@pytest.mark.parametrize("geometry", list(SP_EDGES))
def test_edge_geometries_are_valid_tokens(geometry):
    """Every edge case is a valid token array: int32, bit counts in
    [0, 21], values below 2^nbits, the same from the same seed."""
    bits, nbits, maxbits = _edge(geometry, 23)
    assert bits.dtype == nbits.dtype == np.int32 and bits.shape == nbits.shape
    assert nbits.min() >= 0 and nbits.max() <= 21
    assert (bits.astype(np.int64) >> nbits == 0).all()
    assert maxbits > 0 and maxbits % 32 == 0
    again = _edge(geometry, 23)
    np.testing.assert_array_equal(again[0], bits)
    np.testing.assert_array_equal(again[1], nbits)


@pytest.mark.parametrize("geometry", list(SP_EDGES))
def test_edge_geometries_match_jax_scan(jax_pack, geometry):
    bits, nbits, maxbits = _edge(geometry, 23)
    want_p, want_t = jax_pack(bits, nbits, maxbits)
    got_p, got_t = pack_tokens_sp(torch.from_numpy(bits), torch.from_numpy(nbits), maxbits)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    np.testing.assert_array_equal(got_t.numpy(), want_t)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ntok", [1, 257, 70001], ids=lambda n: f"ntok{n}")
def test_cuda_kernel_matches_plain(cuda_device, ntok):
    rng = np.random.default_rng(ntok)
    bits, nbits = _tokens(rng, 4, ntok, one_bit_lane=True)
    maxbits = _maxbits(nbits)
    b = torch.from_numpy(bits).to(cuda_device)
    n = torch.from_numpy(nbits).to(cuda_device)
    before = pack_tokens_sp.launches
    got_p, got_t = pack_tokens_sp(b, n, maxbits)
    assert pack_tokens_sp.launches == before + 1
    want_p, want_t = pack_tokens_sp_plain(b, n, maxbits)
    torch.testing.assert_close(got_p, want_p, rtol=0, atol=0)
    torch.testing.assert_close(got_t, want_t, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", list(SP_EDGES))
def test_cuda_kernel_edge_geometries(cuda_device, geometry):
    bits, nbits, maxbits = _edge(geometry, 29)
    b = torch.from_numpy(bits).to(cuda_device)
    n = torch.from_numpy(nbits).to(cuda_device)
    before = pack_tokens_sp.launches
    got_p, got_t = pack_tokens_sp(b, n, maxbits)
    assert pack_tokens_sp.launches == before + 1
    want_p, want_t = pack_tokens_sp_plain(b, n, maxbits)
    torch.testing.assert_close(got_p, want_p, rtol=0, atol=0)
    torch.testing.assert_close(got_t, want_t, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("pads", [(1, 1), (2, 2), (1, 2)], ids=lambda p: f"pads{p[0]}{p[1]}")
def test_cuda_kernel_misaligned_views(cuda_device, pads):
    """Token arrays that start one or two int32 past an aligned allocation:
    misaligned alike they keep the 16-byte loads, misaligned differently
    they take the scalar ones."""
    bits, nbits = _tokens(np.random.default_rng(31), 3, 2 * SP_TILE + 5)
    maxbits = _maxbits(nbits)

    def view(a, pad):
        flat = torch.from_numpy(np.concatenate([np.zeros(pad, np.int32), a.ravel()]))
        return flat.to(cuda_device)[pad:].view(a.shape)

    b, n = view(bits, pads[0]), view(nbits, pads[1])
    assert b.data_ptr() % 16 == 4 * pads[0] and n.data_ptr() % 16 == 4 * pads[1]
    got_p, got_t = pack_tokens_sp(b, n, maxbits)
    want_p, want_t = pack_tokens_sp_plain(b, n, maxbits)
    torch.testing.assert_close(got_p, want_p, rtol=0, atol=0)
    torch.testing.assert_close(got_t, want_t, rtol=0, atol=0)
