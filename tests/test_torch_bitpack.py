"""The port's bit packer (plain version on the CPU, CUDA kernel on the
card) against the JAX package's vmapped scan packer
``device_deflate._pack_bits_scan`` — the JAX CPU path, which the Pallas
packer is pinned to. Tolerance: zero (packed bytes and bit totals)."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omero_ms_pixel_buffer_tpu.ops.device_deflate import _pack_bits_scan
from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack import (
    block_bases,
    pack_tokens_sp,
    pack_tokens_sp_plain,
)


def _tokens(rng, lanes, ntok, max_bits=21, one_bit_lane=False):
    """Random valid tokens: bit counts in [0, max_bits] (zeros included),
    values below 2^nbits (20 significant bits at most)."""
    nbits = rng.integers(0, max_bits + 1, (lanes, ntok)).astype(np.int32)
    nbits[:, :: 7] = 0  # zero-length tokens (run interiors, padding)
    nbits[:, 1] = max_bits  # a full-width token in every lane
    if one_bit_lane:
        nbits[-1] = 1
    vals = rng.integers(0, 1 << 20, (lanes, ntok)).astype(np.int64)
    vals &= (1 << np.minimum(nbits, 20)) - 1
    return vals.astype(np.int32), nbits


def _maxbits(nbits):
    return int(-(-int(nbits.sum(axis=1).max()) // 1024) * 1024 + 1024)


def _jax_pack(bits, nbits, maxbits):
    fn = jax.jit(jax.vmap(lambda b, n: _pack_bits_scan(b, n, maxbits)))
    packed, totals = fn(jnp.asarray(bits.astype(np.uint32)), jnp.asarray(nbits))
    return np.asarray(packed), np.asarray(totals)


@pytest.mark.parametrize("ntok", [257, 1000, 5003], ids=lambda n: f"ntok{n}")
def test_plain_matches_jax_scan(ntok):
    rng = np.random.default_rng(ntok)
    bits, nbits = _tokens(rng, 3, ntok, one_bit_lane=True)
    maxbits = _maxbits(nbits)
    want_p, want_t = _jax_pack(bits, nbits, maxbits)
    got_p, got_t = pack_tokens_sp(torch.from_numpy(bits), torch.from_numpy(nbits), maxbits)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    np.testing.assert_array_equal(got_t.numpy(), want_t)


def test_truncates_at_maxbits_like_jax():
    rng = np.random.default_rng(1)
    bits, nbits = _tokens(rng, 2, 600)
    maxbits = 1024  # well below the lanes' totals
    want_p, _ = _jax_pack(bits, nbits, maxbits)
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
