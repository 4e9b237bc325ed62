"""Zlib streams built on the device (counterpart of
``omero_ms_pixel_buffer_tpu/ops/device_deflate.py``) in the three device
deflate modes, each with the Z_RLE match policy:

- ``dynamic``, two passes. Pass 1 (``fused_filter_histogram_batch``)
  runs the PNG filter kernel, the run decomposition and a 286-symbol
  histogram per lane; only the (B, 286) counts cross to the host. The
  host builds per-lane length-limited canonical Huffman codes
  (``build_dynamic_tables``, the numpy planner copied verbatim). Pass 2
  (``dynamic_emit_batch``) re-runs the decomposition, maps every token
  through its lane's tables, packs the bits and frames each lane.
- ``rle``, one pass (``zlib_rle_batch``): the same decomposition mapped
  through the fixed Huffman tables, packed and framed, with no host hop.
- ``stored``, one pass (``zlib_stored_batch``): stored blocks only.

``fused_filter_deflate_batch`` runs the filter kernel and the chain of
a one-pass mode. Coded streams fall back per lane to stored blocks when those
are shorter. The packer is chosen by name as in the JAX package
(``default_packer``, ``OMPB_BITPACK``): ``pallas`` is the scalar-prefetch
kernel (``kernels/bitpack.py``), ``pallas_dense`` the dense kernel
(``kernels/bitpack_dense.py``), ``scan`` and ``gather`` the PyTorch ports
of the JAX package's XLA packers. Every stream is byte-identical to the
JAX package's for the same payloads, tables and mode, whatever the packer.

    payloads (B, L) uint8 -> streams (B, max_stream_len(L)) uint8,
                             lengths (B,) int64
    (stored: streams (B, stored_stream_len(L)), every length equal)
"""

from __future__ import annotations

import functools
import os
import zlib
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .kernels.bitpack import pack_bits_scan, pack_tokens_sp
from .kernels.bitpack_dense import pack_tokens_dense
from .kernels.filter import filter_tiles

_MOD = 65521  # largest prime < 2^16 (adler32 modulus)
_BLOCK = 65535  # max stored-block payload (16-bit LEN)
_MAX_MATCH = 258  # deflate maximum match length


# ---------------------------------------------------------------------------
# Fixed-Huffman code tables (RFC 1951 §3.2.6), precomputed on host and
# stored pre-bit-reversed for LSB-first emission.
# ---------------------------------------------------------------------------


def _bit_reverse(code: int, nbits: int) -> int:
    r = 0
    for _ in range(nbits):
        r = (r << 1) | (code & 1)
        code >>= 1
    return r


_LEN_BASE = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
             35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258]
_LEN_EXTRA = [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
              3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0]
_NUM_LITLEN = 286  # 0-255 literals, 256 EOB, 257-285 length symbols


def _length_code_index(length: int) -> int:
    if length == _MAX_MATCH:
        return 28  # code 285, exact, 0 extra
    return max(
        k for k in range(28)
        if _LEN_BASE[k] <= length
        and length < _LEN_BASE[k] + (1 << _LEN_EXTRA[k])
    )


def _build_tables():
    lit_bits = np.zeros(256, np.uint32)
    lit_nbits = np.zeros(256, np.int32)
    for v in range(256):
        if v < 144:
            code, n = 0x30 + v, 8
        else:
            code, n = 0x190 + (v - 144), 9
        lit_bits[v] = _bit_reverse(code, n)
        lit_nbits[v] = n

    match_bits = np.zeros(_MAX_MATCH + 1, np.uint32)
    match_nbits = np.zeros(_MAX_MATCH + 1, np.int32)
    mlen_sym = np.zeros(_MAX_MATCH + 1, np.int32)
    mlen_extra = np.zeros(_MAX_MATCH + 1, np.int32)
    mlen_base = np.zeros(_MAX_MATCH + 1, np.int32)
    for length in range(3, _MAX_MATCH + 1):
        i = _length_code_index(length)
        symbol = 257 + i
        mlen_sym[length] = symbol
        mlen_extra[length] = _LEN_EXTRA[i]
        mlen_base[length] = _LEN_BASE[i]
        if symbol <= 279:
            rev, n = _bit_reverse(symbol - 256, 7), 7
        else:
            rev, n = _bit_reverse(0xC0 + (symbol - 280), 8), 8
        extra_val = length - _LEN_BASE[i]
        match_bits[length] = rev | (extra_val << n)
        match_nbits[length] = n + _LEN_EXTRA[i] + 5
    return (lit_bits, lit_nbits, match_bits, match_nbits,
            mlen_sym, mlen_extra, mlen_base)


(_LIT_BITS, _LIT_NBITS, _MATCH_BITS, _MATCH_NBITS,
 _MLEN_SYM, _MLEN_EXTRA, _MLEN_BASE) = _build_tables()

_FIXED_SYM_LEN = np.zeros(_NUM_LITLEN, np.int64)
_FIXED_SYM_LEN[:144] = 8
_FIXED_SYM_LEN[144:256] = 9
_FIXED_SYM_LEN[256:280] = 7
_FIXED_SYM_LEN[280:] = 8


def stored_stream_len(payload_len: int) -> int:
    """Total zlib-stream bytes for a stored-block encode."""
    nblocks = max(1, -(-payload_len // _BLOCK))
    return 2 + 5 * nblocks + payload_len + 4


def _packing_maxbits(payload_len: int) -> int:
    """Worst-case deflate bits (all-literal at 9 bits/byte + 3 header
    + 7 EOB), rounded up to a multiple of 1024."""
    raw = 3 + 9 * payload_len + 7
    return ((raw + 1023) // 1024) * 1024


def max_stream_len(payload_len: int) -> int:
    """Stream capacity: packing capacity + zlib header + adler32."""
    return 2 + _packing_maxbits(payload_len) // 8 + 4


# ---------------------------------------------------------------------------
# Device passes (batched over lanes)
# ---------------------------------------------------------------------------


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A small host array on ``device`` without a stream sync: a pageable
    non-blocking copy is staged at once, so the queue's threads never
    wait here for earlier work on the stream."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device, non_blocking=True)


def _adler32(payloads: torch.Tensor) -> torch.Tensor:
    """adler32 per lane: (B, L) uint8 -> (B,) int64. int64 sums mod
    65521: the weighted sum stays below 2^63 for any tile."""
    n = payloads.shape[1]
    data = payloads.to(torch.int64)
    weights = torch.arange(n, 0, -1, dtype=torch.int64, device=payloads.device) % _MOD
    s1 = (1 + data.sum(dim=1)) % _MOD
    s2 = (n % _MOD + (data * weights).sum(dim=1)) % _MOD
    return (s2 << 16) | s1


def _run_decompose(payloads: torch.Tensor):
    """Z_RLE run decomposition of every lane with two scans: a maximal
    run of r identical bytes is one literal head, then matches of <= 258
    (distance 1), short tails literal. Returns per-position
    ``(is_lit, is_match, mlen)``; pass 1 and pass 2 share it, so pass 2
    emits exactly the tokens pass 1 counted."""
    B, n = payloads.shape
    dev = payloads.device
    arange = torch.arange(n, dtype=torch.int32, device=dev).expand(B, n)
    same = torch.zeros((B, n), dtype=torch.bool, device=dev)
    same[:, 1:] = payloads[:, 1:] == payloads[:, :-1]
    run_start = ~same
    start_pos = torch.cummax(
        torch.where(run_start, arange, torch.full_like(arange, -1)), dim=1
    ).values
    p_in_run = arange - start_pos  # 0 at the run head
    after = torch.full((B, n), n, dtype=torch.int32, device=dev)
    after[:, :-1] = torch.where(run_start[:, 1:], arange[:, 1:], after[:, 1:])
    next_start = torch.cummin(after.flip(1), dim=1).values.flip(1)
    rem = next_start - arange  # bytes from here to run end, inclusive
    qmod = torch.remainder(p_in_run - 1, _MAX_MATCH)
    chunk_size = torch.clamp(rem + qmod, max=_MAX_MATCH)
    is_lit = (p_in_run == 0) | (chunk_size < 3)
    is_match = (p_in_run >= 1) & (qmod == 0) & (chunk_size >= 3)
    mlen = torch.clamp(rem, 0, _MAX_MATCH)
    return is_lit, is_match, mlen


@functools.lru_cache(maxsize=None)
def _fixed_tables(device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The fixed-Huffman code tables on ``device``, uploaded once (with
    the one stream sync of a blocking copy): (literal bits, literal
    nbits, match bits, match nbits) int32."""
    return tuple(torch.from_numpy(t.astype(np.int32)).to(device)
                 for t in (_LIT_BITS, _LIT_NBITS, _MATCH_BITS, _MATCH_NBITS))


def _rle_tokens(payloads: torch.Tensor):
    """Per-position fixed-Huffman (bits, nbits) token arrays from the
    Z_RLE decomposition: ((B, L) int32, (B, L) int32)."""
    is_lit, is_match, mlen = _run_decompose(payloads)
    lit_bits, lit_nbits, match_bits, match_nbits = _fixed_tables(payloads.device)
    pay = payloads.long()
    mlen_l = mlen.long()
    zero = torch.zeros((), dtype=torch.int32, device=payloads.device)
    bits = torch.where(is_lit, lit_bits[pay], torch.where(is_match, match_bits[mlen_l], zero))
    nbits = torch.where(is_lit, lit_nbits[pay], torch.where(is_match, match_nbits[mlen_l], zero))
    return bits, nbits


def _lane_tokens(payloads: torch.Tensor):
    """(B, L) payloads -> (B, L + 1) (bits, nbits) token arrays including
    the block-header token (BFINAL=1, BTYPE=01 -> LSB-first value 3, 3
    bits). The end-of-block code is left implicit (``_frame_lanes``
    ``eob_bits=7``)."""
    bits, nbits = _rle_tokens(payloads)
    head = torch.full((payloads.shape[0], 1), 3, dtype=torch.int32,
                      device=payloads.device)
    return torch.cat([head, bits], dim=1), torch.cat([head, nbits], dim=1)


def _dyn_stats(payloads: torch.Tensor):
    """Pass-1 statistics per lane: ((B, 286) int64 literal/length symbol
    counts, (B,) int64 total match extra bits)."""
    is_lit, is_match, mlen = _run_decompose(payloads)
    dev = payloads.device
    mlen_l = mlen.long()
    msym = _to_device(_MLEN_SYM.astype(np.int64), dev)[mlen_l]
    sym = torch.where(
        is_lit, payloads.long(),
        torch.where(is_match, msym, torch.full_like(msym, _NUM_LITLEN)),
    )
    counts = torch.zeros((payloads.shape[0], _NUM_LITLEN + 1),
                         dtype=torch.int64, device=dev)
    counts.scatter_add_(1, sym, torch.ones_like(sym))
    mextra = _to_device(_MLEN_EXTRA.astype(np.int64), dev)[mlen_l]
    extras = torch.where(is_match, mextra, torch.zeros_like(mextra)).sum(dim=1)
    return counts[:, :_NUM_LITLEN], extras


def _pad_pow2_lanes(arr: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Pad the lane axis to a power of two with zero lanes (the same
    lane shapes the JAX package encodes, so streams stay comparable)."""
    b = arr.shape[0]
    padded_b = 1 << max(b - 1, 0).bit_length()
    if padded_b != b:
        pad = torch.zeros((padded_b - b,) + tuple(arr.shape[1:]),
                          dtype=arr.dtype, device=arr.device)
        arr = torch.cat([arr, pad], dim=0)
    return arr, b


def _filtered_payloads(
    tiles: torch.Tensor, rows: int, row_bytes: int, bpp: int, filter_mode: str,
) -> Tuple[torch.Tensor, int]:
    """Pow2 lane padding, the filter kernel, then the leading ``rows`` x
    ``row_bytes`` of each filtered lane flattened: ((B', L) uint8
    payloads, real lane count)."""
    samples = tiles.shape[3] if tiles.ndim == 4 else 1
    if bpp != samples * tiles.element_size():
        raise ValueError(
            f"bpp {bpp} does not match {samples} sample(s) of "
            f"{tiles.element_size()} byte(s)"
        )
    tiles, b = _pad_pow2_lanes(tiles)
    filtered = filter_tiles(tiles, filter_mode)
    return filtered[:, :rows, :row_bytes].reshape(filtered.shape[0], -1), b


def fused_filter_histogram_batch(
    tiles: torch.Tensor, rows: int, row_bytes: int, bpp: int,
    filter_mode: str = "up",
):
    """Pass 1: PNG filter kernel + flatten + symbol histogram. ``tiles``
    (B, H, W[, S]) 8/16-bit on the device; the leading ``rows`` x
    ``row_bytes`` of each filtered lane is the payload. Returns ``(flat,
    counts, extras, real_b)`` with the lanes pow2-padded; ``flat`` stays
    on the device for pass 2."""
    flat, b = _filtered_payloads(tiles, rows, row_bytes, bpp, filter_mode)
    counts, extras = _dyn_stats(flat)
    return flat, counts, extras, b


# ---------------------------------------------------------------------------
# Packer choice
# ---------------------------------------------------------------------------

# Bit-packing geometry of the legacy gather packer: output bits are cut
# into 128-bit chunks; each chunk's covering tokens come from a window
# of 24 tokens starting at the last token at or before the chunk start.
# Real fixed-Huffman tokens are >= 3 bits and all but the header >= 8.
_CHUNK_BITS = 128
_WIN = 24


def _pack_lane_gather(bits: torch.Tensor, nbits: torch.Tensor, maxbits: int):
    """One lane of the gather packer: compaction of the real tokens, a
    token window per 128-bit chunk, a dense one-hot reduce per bit."""
    dev = bits.device
    ntok = bits.shape[0]
    order = torch.sort((nbits == 0).to(torch.int8), stable=True).indices
    bits_c = bits[order].to(torch.int64)
    nbits_c = nbits[order].to(torch.int64)
    offs_c = torch.cumsum(nbits_c, 0) - nbits_c  # exclusive; sorted
    total = offs_c[-1] + nbits_c[-1]
    nchunks = maxbits // _CHUNK_BITS
    chunk_starts = torch.arange(nchunks, dtype=torch.int64, device=dev) * _CHUNK_BITS
    first = torch.searchsorted(offs_c, chunk_starts, right=True) - 1
    win = torch.clamp(
        torch.clamp(first, min=0)[:, None]
        + torch.arange(_WIN, dtype=torch.int64, device=dev)[None, :],
        0, ntok - 1,
    )  # (C, W) token indices
    wo, wb, wn = offs_c[win], bits_c[win], nbits_c[win]
    jg = chunk_starts[:, None] + torch.arange(_CHUNK_BITS, dtype=torch.int64, device=dev)
    # prefix-true per (chunk, bit) row: the covering token is the LAST w
    # with wo <= j
    cmp = wo[:, None, :] <= jg[:, :, None]  # (C, CB, W)
    last = cmp & ~torch.cat([cmp[:, :, 1:], torch.zeros_like(cmp[:, :, :1])], dim=2)
    onehot = last.to(torch.int64)
    sel_b = (onehot * wb[:, None, :]).sum(2)
    sel_n = (onehot * wn[:, None, :]).sum(2)
    shift = (onehot * (jg[:, :, None] - wo[:, None, :])).sum(2)
    bit = torch.where(shift < sel_n, (sel_b >> torch.clamp(shift, 0, 31)) & 1, 0)
    weights = 1 << torch.arange(8, dtype=torch.int64, device=dev)  # LSB-first
    return (bit.reshape(-1, 8) * weights).sum(1).to(torch.uint8), total


def _pack_bits_gather(bits: torch.Tensor, nbits: torch.Tensor, maxbits: int):
    """The legacy gather packer (the JAX package's XLA
    ``_pack_bits_gather``), lane by lane: O(maxbits x 24) work per lane,
    kept because the JAX package keeps it as a packer name."""
    lanes = [_pack_lane_gather(b, nb, maxbits) for b, nb in zip(bits, nbits)]
    return (torch.stack([p for p, _ in lanes]),
            torch.stack([t for _, t in lanes]))


# packer name -> (B, ntok) bits/nbits, maxbits -> (packed bytes, totals)
_PACK_FNS = {
    "scan": pack_bits_scan,
    "pallas": pack_tokens_sp,
    "pallas_dense": pack_tokens_dense,
    "gather": _pack_bits_gather,
}
_PACKERS = tuple(_PACK_FNS)  # the JAX package's names and order


def default_packer(device="cuda") -> str:
    """``pallas`` (the scalar-prefetch kernel) on a CUDA device, ``scan``
    on the CPU; ``OMPB_BITPACK=scan|pallas|pallas_dense|gather``
    overrides it, and any other value is ignored, as in the JAX
    package."""
    forced = os.environ.get("OMPB_BITPACK")
    if forced in _PACKERS:
        return forced
    return "pallas" if torch.device(device).type == "cuda" else "scan"


def resolve_packer(packer: Optional[str], device) -> str:
    """``packer``, or the default for ``device``; ValueError on an
    unknown name."""
    packer = packer or default_packer(device)
    if packer not in _PACKERS:
        raise ValueError(f"Unknown bit packer: {packer} (one of {_PACKERS})")
    return packer


def _pack_dispatch(bits, nbits, maxbits: int, packer: str):
    """Route batched token arrays through the named packer."""
    return _PACK_FNS[packer](bits, nbits, maxbits)


# ---------------------------------------------------------------------------
# Host Huffman planner (numpy; verbatim from the JAX package)
# ---------------------------------------------------------------------------

_HDR_TOKENS = 320

_CL_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)


def _build_lengths_np(freq_in, limit: int) -> np.ndarray:
    """Length-limited canonical Huffman code lengths from symbol
    frequencies: heap tree build + frequency damping (halve-and-
    rebuild) until the depth fits — the native fast_deflate.cc
    algorithm, deterministic via (freq, insertion-order) heap keys."""
    import heapq

    n = len(freq_in)
    lengths = np.zeros(n, np.int32)
    freq = np.asarray(freq_in, np.int64).copy()
    while True:
        sym = np.flatnonzero(freq)
        if sym.size == 0:
            return lengths
        if sym.size == 1:
            lengths[:] = 0
            lengths[sym[0]] = 1
            return lengths
        heap = [(int(freq[s]), int(s), int(s)) for s in sym]
        heapq.heapify(heap)
        children = {}
        next_id = n
        while len(heap) > 1:
            fa, _, a = heapq.heappop(heap)
            fb, _, b = heapq.heappop(heap)
            children[next_id] = (a, b)
            heapq.heappush(heap, (fa + fb, next_id, next_id))
            next_id += 1
        lengths[:] = 0
        maxdepth = 0
        stack = [(heap[0][2], 0)]
        while stack:
            node, d = stack.pop()
            kids = children.get(node)
            if kids is None:
                lengths[node] = max(d, 1)
                maxdepth = max(maxdepth, max(d, 1))
            else:
                stack.append((kids[0], d + 1))
                stack.append((kids[1], d + 1))
        if maxdepth <= limit:
            return lengths
        freq[freq > 0] = (freq[freq > 0] + 1) >> 1  # damp, keep nonzero


def _build_codes_np(lengths: np.ndarray, max_len: int) -> np.ndarray:
    """Canonical codes from lengths (RFC 1951 §3.2.2), pre-bit-reversed
    for LSB-first emission."""
    bl_count = np.bincount(lengths, minlength=max_len + 1).astype(np.int64)
    bl_count[0] = 0
    next_code = np.zeros(max_len + 1, np.int64)
    code = 0
    for bits in range(1, max_len + 1):
        code = (code + int(bl_count[bits - 1])) << 1
        next_code[bits] = code
    codes = np.zeros(len(lengths), np.uint32)
    for i, ln in enumerate(lengths):
        if ln:
            codes[i] = _bit_reverse(int(next_code[ln]), int(ln))
            next_code[ln] += 1
    return codes


def _encode_code_lengths_np(lens: np.ndarray):
    """RFC 1951 §3.2.7 run coding of the code-length sequence with CL
    symbols 16/17/18 -> ([(sym, extra_bits, extra_val)], (19,) freq)."""
    ops = []
    cl_freq = np.zeros(19, np.int64)
    i, n = 0, len(lens)
    while i < n:
        v = int(lens[i])
        run = 1
        while i + run < n and lens[i + run] == v:
            run += 1
        if v == 0:
            while run >= 3:
                take = min(run, 138)
                if take >= 11:
                    ops.append((18, 7, take - 11))
                    cl_freq[18] += 1
                else:
                    ops.append((17, 3, take - 3))
                    cl_freq[17] += 1
                run -= take
                i += take
            while run > 0:
                ops.append((0, 0, 0))
                cl_freq[0] += 1
                i += 1
                run -= 1
        else:
            ops.append((v, 0, 0))
            cl_freq[v] += 1
            i += 1
            run -= 1
            while run >= 3:
                take = min(run, 6)
                ops.append((16, 2, take - 3))
                cl_freq[16] += 1
                run -= take
                i += take
            while run > 0:
                ops.append((v, 0, 0))
                cl_freq[v] += 1
                i += 1
                run -= 1
    return ops, cl_freq


def _lane_dynamic_plan(counts: np.ndarray, extra_bits: int):
    """One lane's dynamic-vs-fixed decision from the pass-1 counts.

    Returns ``None`` when the fixed tables win (both totals are exact
    bit counts computed analytically — no trial emit), else
    ``(header_tokens, lit_code, lit_len, ml_bits, ml_nbits, eob_bits,
    eob_len)`` ready to drop into the per-lane emit tables."""
    counts = counts.astype(np.int64)
    match_tokens = int(counts[257:].sum())
    any_run = match_tokens > 0
    freq = counts.copy()
    freq[256] = 1  # end-of-block (pass 1 histograms payload tokens only)
    lit_len = _build_lengths_np(freq, 15)
    dyn_body = (
        int((counts * lit_len.astype(np.int64)).sum())
        + int(extra_bits) + match_tokens + int(lit_len[256])
    )
    fixed_total = (
        3 + int((counts * _FIXED_SYM_LEN).sum())
        + int(extra_bits) + match_tokens * 5 + 7
    )
    hlit = _NUM_LITLEN
    while hlit > 257 and lit_len[hlit - 1] == 0:
        hlit -= 1
    all_lens = np.concatenate(
        [lit_len[:hlit], np.asarray([1 if any_run else 0], np.int32)]
    )
    ops, cl_freq = _encode_code_lengths_np(all_lens)
    cl_len = _build_lengths_np(cl_freq, 7)
    nz = np.flatnonzero(cl_len)
    if nz.size == 1:
        # a single 1-bit CL code is an incomplete code-length tree,
        # which inflate rejects; a dummy 1-bit code completes it
        cl_len[0 if nz[0] != 0 else 1] = 1
    cl_code = _build_codes_np(cl_len, 7)
    hclen = 19
    while hclen > 4 and cl_len[_CL_ORDER[hclen - 1]] == 0:
        hclen -= 1
    hdr = [(5, 3), (hlit - 257, 5), (0, 5), (hclen - 4, 4)]
    hdr += [(int(cl_len[_CL_ORDER[k]]), 3) for k in range(hclen)]
    for s, eb, ev in ops:
        cn = int(cl_len[s])
        hdr.append((int(cl_code[s]) | (ev << cn), cn + eb))
    dyn_total = sum(t[1] for t in hdr) + dyn_body
    if dyn_total >= fixed_total or len(hdr) > _HDR_TOKENS:
        return None
    lit_code = _build_codes_np(lit_len, 15)
    ml_bits = np.zeros(_MAX_MATCH + 1, np.uint32)
    ml_nbits = np.zeros(_MAX_MATCH + 1, np.int32)
    for ln in range(3, _MAX_MATCH + 1):
        s = int(_MLEN_SYM[ln])
        cn = int(lit_len[s])
        if cn == 0:
            continue  # symbol absent from this lane: length never occurs
        ev = ln - int(_MLEN_BASE[ln])
        ml_bits[ln] = int(lit_code[s]) | (ev << cn)
        # + extra bits + the 1-bit distance-1 code (value 0)
        ml_nbits[ln] = cn + int(_MLEN_EXTRA[ln]) + 1
    return (
        hdr, lit_code[:256], lit_len[:256], ml_bits, ml_nbits,
        int(lit_code[256]), int(lit_len[256]),
    )


def build_dynamic_tables(
    counts: np.ndarray, extras: np.ndarray, real: Optional[int] = None
):
    """Per-lane emit tables from the pass-1 stats: lanes where the
    canonical dynamic code wins get their own header tokens + code
    tables; lanes where fixed wins keep the fixed tables and the 3-bit
    fixed header. Only the first ``real`` lanes get a plan (pow2 pad
    lanes keep the fixed tables). Returns the 8 numpy arrays
    ``(hdr_b, hdr_n, lit_b, lit_n, ml_b, ml_n, eob_b, eob_n)``."""
    b = counts.shape[0]
    hdr_b = np.zeros((b, _HDR_TOKENS), np.uint32)
    hdr_n = np.zeros((b, _HDR_TOKENS), np.int32)
    hdr_b[:, 0] = 3
    hdr_n[:, 0] = 3
    lit_b = np.tile(_LIT_BITS, (b, 1))
    lit_n = np.tile(_LIT_NBITS, (b, 1))
    ml_b = np.tile(_MATCH_BITS, (b, 1))
    ml_n = np.tile(_MATCH_NBITS, (b, 1))
    eob_b = np.zeros(b, np.uint32)
    eob_n = np.full(b, 7, np.int32)  # fixed EOB: 7-bit all-zero code
    for i in range(b if real is None else min(real, b)):
        plan = _lane_dynamic_plan(counts[i], int(extras[i]))
        if plan is None:
            continue  # fixed wins: the prefilled tables ARE the plan
        hdr, lcode, llen, mbits, mnbits, ebits, elen = plan
        hdr_b[i, 0] = hdr_n[i, 0] = 0
        for j, (v, nb) in enumerate(hdr):
            hdr_b[i, j], hdr_n[i, j] = v, nb
        lit_b[i], lit_n[i] = lcode, llen
        ml_b[i], ml_n[i] = mbits, mnbits
        eob_b[i], eob_n[i] = ebits, elen
    return hdr_b, hdr_n, lit_b, lit_n, ml_b, ml_n, eob_b, eob_n


# ---------------------------------------------------------------------------
# Pass 2: emit through per-lane tables, pack, frame
# ---------------------------------------------------------------------------


class EmitTables(NamedTuple):
    """Per-lane code tables on the device (all int32; every value is
    below 2^31): header tokens (B, 320), literal codes (B, 256), match
    codes by length (B, 259), and the end-of-block code (B,)."""

    hdr_b: torch.Tensor
    hdr_n: torch.Tensor
    lit_b: torch.Tensor
    lit_n: torch.Tensor
    ml_b: torch.Tensor
    ml_n: torch.Tensor
    eob_b: torch.Tensor
    eob_n: torch.Tensor


def tables_from_numpy(tables, device) -> EmitTables:
    """The 8 numpy arrays ``build_dynamic_tables`` returns (from either
    package) -> the port's device tables: the state pass 1 hands to
    pass 2."""
    return EmitTables(*(
        _to_device(np.asarray(t).astype(np.int32), device) for t in tables
    ))


def emit_tokens(flat: torch.Tensor, tables: EmitTables):
    """Pass-2 token arrays: header ++ body ++ explicit EOB per lane,
    ((B, 320 + L + 1) int32 code values, same-shape int32 bit counts)."""
    is_lit, is_match, mlen = _run_decompose(flat)
    pay = flat.long()
    mlen_l = mlen.long()
    zero = torch.zeros((), dtype=torch.int32, device=flat.device)
    body_b = torch.where(
        is_lit, tables.lit_b.gather(1, pay),
        torch.where(is_match, tables.ml_b.gather(1, mlen_l), zero),
    )
    body_n = torch.where(
        is_lit, tables.lit_n.gather(1, pay),
        torch.where(is_match, tables.ml_n.gather(1, mlen_l), zero),
    )
    bits = torch.cat([tables.hdr_b, body_b, tables.eob_b[:, None]], dim=1)
    nbits = torch.cat([tables.hdr_n, body_n, tables.eob_n[:, None]], dim=1)
    return bits, nbits


def _stored_streams(payloads: torch.Tensor, adler: torch.Tensor, cap: int):
    """Every lane's stored-block zlib stream, zero-padded to ``cap``."""
    B, n = payloads.shape
    dev = payloads.device
    nblocks = max(1, -(-n // _BLOCK))
    pieces = [_to_device(np.array([0x78, 0x01], np.uint8), dev).expand(B, 2)]
    for i in range(nblocks):
        start = i * _BLOCK
        size = min(_BLOCK, n - start)
        final = 1 if i == nblocks - 1 else 0
        header = [final, size & 0xFF, size >> 8,
                  (size & 0xFF) ^ 0xFF, (size >> 8) ^ 0xFF]
        pieces.append(_to_device(np.array(header, np.uint8), dev).expand(B, 5))
        pieces.append(payloads[:, start:start + size])
    pieces.append(adler)
    stream = torch.cat(pieces, dim=1)
    out = torch.zeros((B, cap), dtype=torch.uint8, device=dev)
    out[:, : stream.shape[1]] = stream
    return out


def _adler_bytes(payloads: torch.Tensor) -> torch.Tensor:
    """Every lane's adler32 as its 4 big-endian stream bytes (B, 4)."""
    shifts = 24 - 8 * torch.arange(4, dtype=torch.int64, device=payloads.device)
    return ((_adler32(payloads)[:, None] >> shifts) & 0xFF).to(torch.uint8)


def _frame_lanes(payloads: torch.Tensor, packed: torch.Tensor,
                 body_bits: torch.Tensor, eob_bits: int):
    """Zlib-frame every lane's packed deflate body, then keep per lane
    the smaller of the coded and stored streams: (streams (B, 2 + packed
    bytes + 4) uint8, lengths (B,)). ``eob_bits``: the fixed-Huffman
    emit leaves the end-of-block symbol implicit (its 7-bit all-zero
    code, counted here as length only); the dynamic emit carries it as
    a token and passes 0."""
    B, n = payloads.shape
    dev = payloads.device
    deflate_nbytes = (body_bits + eob_bits + 7) // 8
    cap = 2 + packed.shape[1] + 4
    coded_len = 2 + deflate_nbytes + 4
    adler_bytes = _adler_bytes(payloads)
    out = torch.zeros((B, cap), dtype=torch.uint8, device=dev)
    out[:, 0] = 0x78
    out[:, 1] = 0x01
    out[:, 2:2 + packed.shape[1]] = packed
    # adler32 after the last body byte (start clamped into the buffer,
    # as the JAX dynamic_update_slice clamps)
    start = torch.clamp(2 + deflate_nbytes, max=cap - 4)
    pos = start[:, None] + torch.arange(4, device=dev)
    out.scatter_(1, pos, adler_bytes)
    stored_len = stored_stream_len(n)
    use_coded = coded_len <= stored_len
    out = torch.where(use_coded[:, None], out, _stored_streams(payloads, adler_bytes, cap))
    lengths = torch.where(use_coded, coded_len, torch.full_like(coded_len, stored_len))
    return out, lengths


def dynamic_emit(flat: torch.Tensor, tables: EmitTables, packer: Optional[str] = None):
    """Pass 2 on the device: emit through the per-lane tables, pack with
    the named packer, frame. Streams are ``max_stream_len(L)`` wide."""
    packer = resolve_packer(packer, flat.device)
    if packer == "gather":
        # the gather packer's window assumes >= 7-bit real tokens;
        # dynamic codes can be 1 bit, so the JAX package routes to scan
        packer = "scan"
    bits, nbits = emit_tokens(flat, tables)
    packed, body_bits = _pack_dispatch(
        bits, nbits, _packing_maxbits(flat.shape[1]), packer)
    return _frame_lanes(flat, packed, body_bits, eob_bits=0)


def dynamic_emit_batch(
    flat: torch.Tensor, counts_np: np.ndarray, extras_np: np.ndarray,
    packer: Optional[str] = None, real: Optional[int] = None,
):
    """Pass 2 from the pulled pass-1 counts: host table build, then the
    device emit. ``real`` bounds the host planning to the real lanes and
    slices the pow2 padding off the outputs."""
    tables = build_dynamic_tables(
        np.asarray(counts_np), np.asarray(extras_np), real=real
    )
    streams, lengths = dynamic_emit(
        flat, tables_from_numpy(tables, flat.device), packer=packer)
    if real is not None:
        return streams[:real], lengths[:real]
    return streams, lengths


# ---------------------------------------------------------------------------
# One-pass modes: fixed Huffman (rle) and stored blocks
# ---------------------------------------------------------------------------


def _check_payloads(payloads: torch.Tensor) -> None:
    if payloads.ndim != 2 or payloads.dtype != torch.uint8:
        raise ValueError(f"payloads must be (B, L) uint8, got {tuple(payloads.shape)} "
                         f"{payloads.dtype}")
    if payloads.shape[1] == 0:
        raise ValueError("empty payload")


def zlib_stored_batch(payloads: torch.Tensor) -> torch.Tensor:
    """Complete zlib streams of stored blocks for equal-length payloads:
    (B, L) uint8 -> (B, stored_stream_len(L)) uint8, every stream exactly
    that long."""
    _check_payloads(payloads)
    return _stored_streams(payloads, _adler_bytes(payloads),
                           stored_stream_len(payloads.shape[1]))


def zlib_rle_batch(payloads: torch.Tensor, packer: Optional[str] = None):
    """Compressive zlib streams (Z_RLE match policy, fixed Huffman,
    per-lane stored fallback) for equal-length payloads, one device
    chain with no host hop: (B, L) uint8 -> ((B, max_stream_len(L))
    uint8, (B,) lengths)."""
    _check_payloads(payloads)
    packer = resolve_packer(packer, payloads.device)
    bits, nbits = _lane_tokens(payloads)
    maxbits = _packing_maxbits(payloads.shape[1])
    packed, body_bits = _pack_dispatch(bits, nbits, maxbits, packer)
    return _frame_lanes(payloads, packed, body_bits, eob_bits=7)


def _streams_core(flat: torch.Tensor, mode: str, packer: Optional[str]):
    if mode == "stored":
        lengths = torch.full((flat.shape[0],), stored_stream_len(flat.shape[1]),
                             dtype=torch.int64, device=flat.device)
        return zlib_stored_batch(flat), lengths
    return zlib_rle_batch(flat, packer)


DEFLATE_MODES = ("dynamic", "rle", "stored")


def fused_filter_deflate_batch(
    tiles: torch.Tensor, rows: int, row_bytes: int, bpp: int,
    filter_mode: str = "up", mode: str = "rle", packer: Optional[str] = None,
):
    """The one-pass device encode chain (``mode`` ``rle`` or ``stored``):
    tiles (B, H, W[, S]) 8/16-bit -> ((B, cap) uint8 zlib streams, (B,)
    lengths) for the leading ``rows`` x ``row_bytes`` of each filtered
    lane. The lanes are padded to a power of two, run through the filter
    kernel and the chain, and the padding is sliced off. ``dynamic`` is
    two passes with a host plan between them: ``fused_filter_histogram_batch``
    then ``dynamic_emit_batch``."""
    if mode not in ("rle", "stored"):
        raise ValueError(f"Unknown one-pass device deflate mode: {mode}")
    packer = resolve_packer(packer, tiles.device)
    flat, b = _filtered_payloads(tiles, rows, row_bytes, bpp, filter_mode)
    streams, lengths = _streams_core(flat, mode, packer)
    return streams[:b], lengths[:b]


def fused_filter_deflate_dynamic(
    tiles: torch.Tensor, rows: int, row_bytes: int, bpp: int,
    filter_mode: str = "up", packer: Optional[str] = None,
):
    """Both ``dynamic`` passes back to back (the microbenchmark and other
    callers outside the encode queue): pass 1, one pull of the counts,
    the host plan, pass 2. ((B, cap) uint8 streams, (B,) lengths)."""
    flat, counts, extras, b = fused_filter_histogram_batch(
        tiles, rows, row_bytes, bpp, filter_mode=filter_mode)
    return dynamic_emit_batch(flat, counts.cpu().numpy(), extras.cpu().numpy(),
                              packer=packer, real=b)


def deflate_filtered_batch(
    filtered: torch.Tensor, rows: int, row_bytes: int, mode: str = "rle",
    packer: Optional[str] = None,
):
    """Streams of already-filtered scanlines (B, H, 1 + W*bpp) on the
    device, possibly bucket-padded: ((B, cap) uint8 zlib streams, (B,)
    lengths) of the leading ``rows`` x ``row_bytes`` of each lane in a
    one-pass ``mode`` (``rle`` or ``stored``; the JAX package's
    ``deflate_filtered_batch``, which the microbenchmark times)."""
    if mode not in ("rle", "stored"):
        raise ValueError(f"Unknown one-pass device deflate mode: {mode}")
    packer = resolve_packer(packer, filtered.device)
    filtered, b = _pad_pow2_lanes(filtered)
    flat = filtered[:, :rows, :row_bytes].reshape(filtered.shape[0], -1)
    streams, lengths = _streams_core(flat, mode, packer)
    return streams[:b], lengths[:b]


# ---------------------------------------------------------------------------
# Host twin of the rle stream (the render host mirror's encoder)
# ---------------------------------------------------------------------------


def _rle_tokens_np(payload: np.ndarray):
    """Numpy twin of ``_rle_tokens`` for one lane: the same run
    decomposition, tables and token order."""
    n = payload.shape[0]
    arange = np.arange(n, dtype=np.int64)
    same = np.concatenate([np.zeros(1, bool), payload[1:] == payload[:-1]])
    run_start = ~same
    start_pos = np.maximum.accumulate(np.where(run_start, arange, -1))
    p_in_run = arange - start_pos
    starts = np.where(run_start, arange, n)
    after = np.concatenate([starts[1:], np.full(1, n, np.int64)])
    next_start = np.minimum.accumulate(after[::-1])[::-1]
    rem = next_start - arange
    qmod = (p_in_run - 1) % _MAX_MATCH
    chunk_size = np.minimum(_MAX_MATCH, rem + qmod)
    is_lit = (p_in_run == 0) | (chunk_size < 3)
    is_match = (p_in_run >= 1) & (qmod == 0) & (chunk_size >= 3)
    mlen = np.clip(rem, 0, _MAX_MATCH)
    bits = np.where(is_lit, _LIT_BITS[payload],
                    np.where(is_match, _MATCH_BITS[mlen], 0)).astype(np.uint32)
    nbits = np.where(is_lit, _LIT_NBITS[payload],
                     np.where(is_match, _MATCH_NBITS[mlen], 0)).astype(np.int64)
    return bits, nbits


def _pack_bits_scan_np(bits: np.ndarray, nbits: np.ndarray, maxbits: int):
    """Numpy twin of the carry-free prefix-sum packer: the same word math
    on wrapping uint32 cumulative sums, so the bytes equal every device
    packer's. Returns (LSB-first bytes of ``maxbits`` bits, total bits)."""
    offs = np.cumsum(nbits) - nbits
    total_bits = int(offs[-1] + nbits[-1])
    s = (offs & 31).astype(np.uint32)
    val = bits.astype(np.uint32)
    lo = val << s
    hi = (val >> (np.uint32(31) - s)) >> np.uint32(1)
    zero = np.zeros(1, np.uint32)
    tl = np.concatenate([zero, np.cumsum(lo, dtype=np.uint32)])
    th = np.concatenate([zero, np.cumsum(hi, dtype=np.uint32)])
    edges = (np.arange(maxbits // 32, dtype=np.int64) + 1) * 32
    c = np.searchsorted(offs, edges, side="left")
    gl, gh = tl[c], th[c]
    gl1 = np.concatenate([zero, gl[:-1]])
    gh1 = np.concatenate([zero, gh[:-1]])
    gh2 = np.concatenate([zero, gh1[:-1]])
    words = (gl - gl1) + (gh1 - gh2)
    return words.astype("<u4").tobytes(), total_bits


def zlib_rle_np(payload) -> bytes:
    """The ``rle`` stream of one lane built on the host: Z_RLE tokens,
    fixed Huffman, the carry-free packer and the smaller of the coded and
    stored streams. Byte-identical to ``zlib_rle_batch`` of the same
    payload, which keeps the render host mirror's PNGs equal to the
    device chain's."""
    data = np.frombuffer(payload, dtype=np.uint8) if isinstance(
        payload, (bytes, bytearray, memoryview)
    ) else np.ascontiguousarray(payload, dtype=np.uint8).ravel()
    n = data.shape[0]
    if n == 0:
        raise ValueError("empty payload")
    tok_bits, tok_nbits = _rle_tokens_np(data)
    bits = np.concatenate([np.full(1, 3, np.uint32), tok_bits])
    nbits = np.concatenate([np.full(1, 3, np.int64), tok_nbits])
    packed, body_bits = _pack_bits_scan_np(bits, nbits, _packing_maxbits(n))
    deflate_nbytes = (body_bits + 7 + 7) // 8  # + the 7-bit all-zero EOB code
    adler = (zlib.adler32(data.tobytes()) & 0xFFFFFFFF).to_bytes(4, "big")
    if 2 + deflate_nbytes + 4 <= stored_stream_len(n):
        return b"\x78\x01" + packed[:deflate_nbytes] + adler
    out = bytearray(b"\x78\x01")
    for i in range(max(1, -(-n // _BLOCK))):
        start = i * _BLOCK
        size = min(_BLOCK, n - start)
        final = 1 if start + size == n else 0
        out += bytes([final, size & 0xFF, size >> 8, (size & 0xFF) ^ 0xFF, (size >> 8) ^ 0xFF])
        out += data[start:start + size].tobytes()
    return bytes(out + adler)
