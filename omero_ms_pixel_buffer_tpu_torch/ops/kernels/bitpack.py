"""Deflate token bit packer, scalar-prefetch formulation: CUDA kernel
and plain version.

Replaces the Pallas TPU kernel ``omero_ms_pixel_buffer_tpu/ops/pallas/
bitpack.py`` ``pack_tokens_sp`` (``pl.pallas_call`` at :201, the packer
named ``pallas``; ``bitpack_dense.py`` ports the other one). The kernel
(``csrc/bitpack.cu``, CUDA name ``sp_pack_tiles``) is bound by bytes:
each token (value + bit count, 8 bytes) is read once and each output
word written once. Hopper runs blocks in no order, so instead of the
TPU's in-order walk with a VMEM-resident lane, each CTA packs a tile of
``SP_TILE`` tokens into a shared-memory word strip and takes its bit
offset from a single-pass chained scan with decoupled look-back; tiles
hand their partial last word to their successors the same way. One call
is one ctypes call: a memset of the tiles' status words and the kernel,
into outputs from ``torch.empty``.

The plain version is ``pack_bits_scan``, the carry-free prefix-sum
packer (the JAX package's XLA ``device_deflate._pack_bits_scan``) batched
over lanes in PyTorch: wrapping uint32 sums become int64 sums masked to
32 bits, and the word boundaries come from ``torch.searchsorted``. The
same function is the packer named ``scan``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build, count_launch

TB = 256  # tokens per block of the dense formulation (``block_bases``)
SP_TILE = 4096  # tokens per CTA of the scalar-prefetch kernel (csrc/bitpack.cu)
_MASK = 0xFFFFFFFF

# ompb_sp_pack and ompb_dense_pack (bits, nbits, out, totals, ws, ws_bytes, B,
# ntok, nwords, stream)
_TILE_ARGTYPES = [ctypes.c_void_p] * 5 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_void_p,
]


def _check_args(bits: torch.Tensor, nbits: torch.Tensor, maxbits: int):
    if bits.ndim != 2 or bits.shape != nbits.shape:
        raise ValueError(
            f"bits/nbits must be equal (B, ntok), got {tuple(bits.shape)} "
            f"and {tuple(nbits.shape)}"
        )
    if maxbits <= 0 or maxbits % 32:
        raise ValueError(f"maxbits must be a positive multiple of 32: {maxbits}")
    if bits.device != nbits.device:
        raise ValueError("bits and nbits must share a device")


def _words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """(B, nwords) int64 words (< 2^32) -> (B, 4*nwords) LSB-first bytes."""
    shifts = torch.arange(0, 32, 8, device=words.device, dtype=torch.int64)
    packed = (words[:, :, None] >> shifts) & 0xFF
    return packed.to(torch.uint8).reshape(words.shape[0], -1)


def pack_bits_scan(
    bits: torch.Tensor, nbits: torch.Tensor, maxbits: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan packer (``_pack_bits_scan`` batched over lanes), on the
    tensors' device: (B, maxbits // 8) uint8 packed bytes and (B,) int64
    body bit totals."""
    _check_args(bits, nbits, maxbits)
    B, ntok = bits.shape
    dev = bits.device
    nb = nbits.to(torch.int64)
    offs = torch.cumsum(nb, dim=1) - nb  # exclusive; non-decreasing
    totals = nb.sum(dim=1)
    s = offs & 31
    val = bits.to(torch.int64) & _MASK
    lo = (val << s) & _MASK
    hi = (val >> (31 - s)) >> 1  # logical shift by 32 - s without s = 0 UB
    zero = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    # the sums stay below 2^53, so int64 needs no wrap: segment sums of
    # disjoint bit ranges are exact differences
    tl = torch.cat([zero, torch.cumsum(lo, dim=1)], dim=1)
    th = torch.cat([zero, torch.cumsum(hi, dim=1)], dim=1)
    nwords = maxbits // 32
    edges = (torch.arange(nwords, device=dev, dtype=torch.int64) + 1) * 32
    c = torch.searchsorted(
        offs.contiguous(), edges.expand(B, nwords).contiguous(), side="left"
    )
    gl = tl.gather(1, c)
    gh = th.gather(1, c)
    gl1 = torch.cat([zero, gl[:, :-1]], dim=1)
    gh1 = torch.cat([zero, gh[:, :-1]], dim=1)
    gh2 = torch.cat([zero, gh1[:, :-1]], dim=1)
    words = ((gl - gl1) + (gh1 - gh2)) & _MASK
    return _words_to_bytes(words), totals


def block_bases(nbits: torch.Tensor) -> torch.Tensor:
    """(B, ceil(ntok / 256)) int64 exclusive bit offset of each 256-token
    block: the scan the dense formulation's blocks start from."""
    B, ntok = nbits.shape
    full, tail = divmod(ntok, TB)
    nblocks = full + (1 if tail else 0)
    sums = torch.zeros((B, nblocks), dtype=torch.int64, device=nbits.device)
    if full:
        sums[:, :full] = nbits[:, : full * TB].reshape(B, full, TB).sum(
            dim=2, dtype=torch.int64
        )
    if tail:
        sums[:, full] = nbits[:, full * TB:].sum(dim=1, dtype=torch.int64)
    return torch.cumsum(sums, dim=1) - sums


def _check_kernel_args(bits: torch.Tensor, nbits: torch.Tensor, source: str) -> None:
    if bits.dtype != torch.int32 or nbits.dtype != torch.int32:
        raise ValueError(f"{source} kernel needs int32 bits and nbits")
    if not (bits.is_contiguous() and nbits.is_contiguous()):
        raise ValueError(f"{source} kernel needs contiguous token arrays")
    if bits.shape[0] > 65535:
        raise ValueError(f"{source} kernel takes at most 65535 lanes, got {bits.shape[0]}")


def sp_tiles(ntok: int) -> int:
    """Tiles per lane of the scalar-prefetch kernel: tiles start on 16-byte
    boundaries of the flat arrays, so a lane's row may begin up to 3
    tokens into its first tile."""
    return -(-(ntok + 3) // SP_TILE)


def sp_workspace_bytes(B: int, ntok: int) -> int:
    """Bytes of the scalar-prefetch kernel's workspace: an 8-byte ticket,
    then two 8-byte status words per tile (its prefix, its partial last
    word)."""
    return 8 + 16 * B * sp_tiles(ntok)


def launch_tiles(bits: torch.Tensor, nbits: torch.Tensor, maxbits: int, source: str,
                 symbol: str, ws_bytes: int, wrapper) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ctypes call into a tile packer (``source``'s C entry ``symbol``,
    with the argument list ``_TILE_ARGTYPES``): its ``ws_bytes`` of tile
    status words cleared and the kernel launched on the current stream,
    into outputs from ``torch.empty``; counted on ``wrapper``."""
    _check_kernel_args(bits, nbits, source)
    B, ntok = bits.shape
    nwords = maxbits // 32
    dev = bits.device
    out = torch.empty((B, nwords), dtype=torch.int32, device=dev)
    totals = torch.empty((B,), dtype=torch.int64, device=dev)
    ws = torch.empty((ws_bytes,), dtype=torch.uint8, device=dev)
    fn = _build.entry(source, symbol, _TILE_ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(bits.data_ptr(), nbits.data_ptr(), out.data_ptr(), totals.data_ptr(),
                  ws.data_ptr(), ws_bytes, B, ntok, nwords, _build.stream_handle(dev))
    _build.check(code, f"{source} kernel launch")
    count_launch(wrapper)
    # little-endian words: their bytes in memory are the LSB-first stream
    return out.view(torch.uint8), totals


# the plain version of ``pack_tokens_sp`` is the scan packer
pack_tokens_sp_plain = pack_bits_scan


def pack_tokens_sp(
    bits: torch.Tensor, nbits: torch.Tensor, maxbits: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, ntok) token values and bit counts -> ((B, maxbits // 8) uint8
    LSB-first packed bytes, (B,) int64 body bit totals). A CUDA tensor
    launches the kernel (or raises); a CPU tensor takes the plain
    version."""
    _check_args(bits, nbits, maxbits)
    if bits.device.type == "cuda":
        return launch_tiles(bits, nbits, maxbits, "bitpack", "ompb_sp_pack",
                            sp_workspace_bytes(*bits.shape), pack_tokens_sp)
    if bits.device.type == "cpu":
        return pack_tokens_sp_plain(bits, nbits, maxbits)
    raise ValueError(f"Unsupported device: {bits.device}")


pack_tokens_sp.launches = 0
