"""Deflate token bit packer, dense (word-owned) formulation: CUDA kernel
and plain version.

Replaces the Pallas TPU kernel ``omero_ms_pixel_buffer_tpu/ops/pallas/
bitpack.py`` ``pack_tokens`` (``pl.pallas_call`` at :275, the packer named
``pallas_dense``). It computes what ``bitpack.pack_tokens_sp`` computes,
word-owned instead of token-owned: each output word is assembled from the
tokens that touch it. The TPU kernel does that as a one-hot compare-reduce
(every 256-token block owns a strip of ``SPAN`` words, and each word sums,
over the block's tokens, the word part of those starting in it and the
spill of those starting one word below). The kernel
(``csrc/bitpack_dense.cu``, CUDA name ``dense_pack_tiles``) is bound by
bytes and drops the sweep: each CTA takes a tile of ``DENSE_TILE`` tokens,
stages their start bits and values in shared memory, takes its bit offset
from a decoupled look-back, and each thread gathers its words by a binary
search of the starts. One call is one ctypes call: a memset of the tiles'
status words and the kernel, into outputs from ``torch.empty``.

The plain version is the TPU formulation in PyTorch: int64 values masked
to 32 bits, the blocks' offsets from ``block_bases``, the blocks taken in
chunks so that no temporary passes ``_CHUNK_BYTES``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .bitpack import TB, _check_args, _MASK, _words_to_bytes, block_bases, launch_tiles

SPAN = (TB * 21 + 31) // 32 + 2  # words one block can touch (21-bit tokens)
# the formulation's int ops per token: two (SPAN, TB) compare-select-add
# sweeps plus the log-step offset scan (the JAX package's
# ``emit_ops_per_token("dense")``)
OPS_PER_TOKEN = 2 * 3 * SPAN + 2 * (TB.bit_length() - 1)
_CHUNK_BYTES = 512 << 20  # largest int64 temporary of the plain version
DENSE_TILE = 4096  # tokens per CTA of the kernel (csrc/bitpack_dense.cu)


def dense_tiles(ntok: int) -> int:
    """Tiles per lane of the kernel: tiles start on 16-byte boundaries of
    the flat arrays, so a lane's row may begin up to 3 tokens into its
    first tile."""
    return -(-(ntok + 3) // DENSE_TILE)


def dense_workspace_bytes(B: int, ntok: int) -> int:
    """Bytes of the kernel's workspace: an 8-byte ticket, then two 8-byte
    status words per tile (its prefix, its partial last word)."""
    return 8 + 16 * B * dense_tiles(ntok)


def _block_strips(bits: torch.Tensor, nbits: torch.Tensor):
    """Per (lane, block): the strip's first word and its (SPAN,) word
    sums, from the (SPAN, TB) one-hot reduce."""
    B, ntok = bits.shape
    dev = bits.device
    nblocks = -(-ntok // TB)
    pad = nblocks * TB - ntok
    nb = torch.nn.functional.pad(nbits.to(torch.int64), (0, pad))
    val = torch.nn.functional.pad(bits.to(torch.int64) & _MASK, (0, pad))
    base = block_bases(nbits)  # (B, nblocks)
    nb = nb.reshape(B * nblocks, TB)
    val = val.reshape(B * nblocks, TB)
    base = base.reshape(B * nblocks, 1)
    offs = base + torch.cumsum(nb, dim=1) - nb  # global exclusive offsets
    s = offs & 31
    lo = (val << s) & _MASK
    hi = (val >> (31 - s)) >> 1
    wstart = base >> 5
    rel = (offs >> 5) - wstart  # in [0, SPAN - 2]
    widx = torch.arange(SPAN, device=dev, dtype=torch.int64)[None, :, None]
    strips = torch.empty((B * nblocks, SPAN), dtype=torch.int64, device=dev)
    step = max(1, _CHUNK_BYTES // (8 * SPAN * TB))
    for c in range(0, B * nblocks, step):
        sl = slice(c, c + step)
        hit = rel[sl, None, :] == widx  # (n, SPAN, TB) one-hot rows
        acc = torch.where(hit, lo[sl, None, :], 0).sum(dim=2)
        hit = rel[sl, None, :] + 1 == widx  # spill into the next word
        acc += torch.where(hit, hi[sl, None, :], 0).sum(dim=2)
        strips[sl] = acc & _MASK
    return wstart.reshape(B, nblocks), strips.reshape(B, nblocks, SPAN)


def pack_tokens_dense_plain(
    bits: torch.Tensor, nbits: torch.Tensor, maxbits: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch dense packer, on the tensors' device: (B,
    maxbits // 8) uint8 packed bytes and (B,) int64 body bit totals."""
    _check_args(bits, nbits, maxbits)
    B = bits.shape[0]
    nwords = maxbits // 32
    totals = nbits.sum(dim=1, dtype=torch.int64)
    if bits.shape[1] == 0:
        return _words_to_bytes(bits.new_zeros((B, nwords), dtype=torch.int64)), totals
    wstart, strips = _block_strips(bits, nbits)
    # strips overlap only at their end words; disjoint bits: + == |
    words = torch.zeros((B, nwords + SPAN), dtype=torch.int64, device=bits.device)
    idx = torch.clamp(wstart[:, :, None] + torch.arange(SPAN, device=bits.device),
                      max=nwords + SPAN - 1)
    words.scatter_add_(1, idx.reshape(B, -1), strips.reshape(B, -1))
    return _words_to_bytes(words[:, :nwords] & _MASK), totals


def pack_tokens_dense(
    bits: torch.Tensor, nbits: torch.Tensor, maxbits: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, ntok) token values and bit counts (<= 21) -> ((B, maxbits //
    8) uint8 LSB-first packed bytes, (B,) int64 body bit totals). A CUDA
    tensor launches the kernel (or raises); a CPU tensor takes the plain
    version."""
    _check_args(bits, nbits, maxbits)
    if bits.device.type == "cuda":
        return launch_tiles(bits, nbits, maxbits, "bitpack_dense", "ompb_dense_pack",
                            dense_workspace_bytes(*bits.shape), pack_tokens_dense)
    if bits.device.type == "cpu":
        return pack_tokens_dense_plain(bits, nbits, maxbits)
    raise ValueError(f"Unsupported device: {bits.device}")


pack_tokens_dense.launches = 0
