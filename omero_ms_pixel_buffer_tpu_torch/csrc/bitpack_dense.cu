// Deflate token bit packer, dense word-owned formulation, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in omero_ms_pixel_buffer_tpu/ops/pallas/bitpack.py
// (pack_tokens, body _kernel: the "pallas_dense" packer). Contract as the
// token-owned kernel in bitpack.cu: batched token arrays (B, ntok) of code
// values (< 2^32) and bit counts (<= 21) -> (B, nwords) 32-bit words whose
// little-endian bytes are the LSB-first deflate bitstream, bits past
// nwords*32 dropped, zero-length tokens writing nothing: the same bytes as
// the scan packer device_deflate._pack_bits_scan.
//
// What bounds it on the card: the function is bound by bytes (8 bytes in per
// token, the stream out once), but this formulation by its operations. Each
// 256-token block owns a strip of SPAN = 170 words (256 tokens x 21 bits +
// 31 bits of misalignment, + the spill word), and every word of the strip
// compares itself against every token of the block: 2 x 170
// compare-select-adds per token, where bitpack.cu does a scan and two
// shifts. It is kept as that kernel's comparison point. The TPU
// kernel carries the block's starting bit offset from grid step to grid
// step in SMEM; Hopper runs blocks in no order, so the offset comes from
// the wrapper's block-sum scan (bitpack.block_bases) instead. One CUDA
// block handles one (lane, token block): its threads scan the block's bit
// counts with warp shuffles, stage each token's (lo, hi, rel) in shared
// memory as one 16-byte record, and then thread w < SPAN sums, over the
// block's tokens, lo where rel == w and hi where rel + 1 == w. The records
// are read by every thread at the same address (a broadcast, one 16-byte
// load per token). Token bit ranges are disjoint, so the sums carry nothing
// and equal the OR; only nonzero words are ORed into the zeroed output with
// atomicOr (the words at a strip's two ends are shared with the
// neighbouring blocks), and none at or beyond nwords.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB = 256;    // tokens per block
constexpr int SPAN = 170;  // words one block can touch: (TB*21 + 31) / 32 + 2
constexpr int WARPS = TB / 32;

__global__ void __launch_bounds__(TB)
dense_pack_words(const int32_t* __restrict__ bits, const int32_t* __restrict__ nbits,
                 const long long* __restrict__ base, uint32_t* __restrict__ out,
                 long long ntok, int nblocks, long long nwords) {
  __shared__ int warp_sums[WARPS];
  __shared__ uint4 tok[TB];  // (lo, hi, rel, unused) per token
  const int lane = blockIdx.y;
  const int blk = blockIdx.x;
  const int t = threadIdx.x;
  const long long i = (long long)blk * TB + t;
  int nb = 0;
  uint32_t val = 0;
  if (i < ntok) {
    nb = nbits[(size_t)lane * ntok + i];
    val = (uint32_t)bits[(size_t)lane * ntok + i];
  }
  // inclusive scan inside the warp, then across the block's warps
  const int wid = t >> 5, lid = t & 31;
  int inc = nb;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, d);
    if (lid >= d) inc += v;
  }
  if (lid == 31) warp_sums[wid] = inc;
  __syncthreads();
  if (wid == 0) {
    int s = lid < WARPS ? warp_sums[lid] : 0;
#pragma unroll
    for (int d = 1; d < WARPS; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, s, d);
      if (lid >= d) s += v;
    }
    if (lid < WARPS) warp_sums[lid] = s;
  }
  __syncthreads();
  const long long b0 = base[(size_t)lane * nblocks + blk];
  const long long off = b0 + (wid ? warp_sums[wid - 1] : 0) + inc - nb;
  const uint32_t s = (uint32_t)(off & 31);
  const long long wstart = b0 >> 5;
  // rel in [0, SPAN - 2] for tokens of <= 21 bits; uint32 shifts, and the
  // spill as (v >> (31 - s)) >> 1 so that s == 0 needs no shift by 32
  tok[t] = make_uint4(val << s, (val >> (31u - s)) >> 1, (uint32_t)((off >> 5) - wstart), 0u);
  __syncthreads();
  if (t >= SPAN) return;
  const uint32_t w = (uint32_t)t;
  uint32_t acc = 0;
#pragma unroll 8
  for (int k = 0; k < TB; ++k) {
    const uint4 r = tok[k];
    acc += (r.z == w ? r.x : 0u) + (r.z + 1u == w ? r.y : 0u);
  }
  const long long gw = wstart + w;
  if (acc != 0 && gw < nwords) atomicOr(out + (size_t)lane * nwords + gw, acc);
}

}  // namespace

// bits, nbits: (B, ntok) int32; base: (B, nblocks) int64 exclusive bit
// offset of each 256-token block; out: (B, nwords) uint32, zeroed.
extern "C" int ompb_bitpack_dense(const void* bits, const void* nbits, const void* base,
                                  void* out, int B, long long ntok, int nblocks,
                                  long long nwords, void* stream) {
  if (B < 0 || B > 65535 || ntok < 0 || nwords < 0 ||
      nblocks != (int)((ntok + TB - 1) / TB)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || nblocks == 0) return 0;
  dim3 grid(nblocks, B);
  dense_pack_words<<<grid, TB, 0, (cudaStream_t)stream>>>(
      (const int32_t*)bits, (const int32_t*)nbits, (const long long*)base,
      (uint32_t*)out, ntok, nblocks, nwords);
  return (int)cudaGetLastError();
}
