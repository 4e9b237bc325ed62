// Deflate token bit packer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in omero_ms_pixel_buffer_tpu/ops/pallas/bitpack.py
// (pack_tokens_sp, body _kernel_sp). Contract: batched token arrays
// (B, ntok) of code values (< 2^32, in practice <= 20 significant bits)
// and bit counts (<= 21) -> (B, nwords) 32-bit words whose little-endian
// bytes are the LSB-first deflate bitstream, bits past nwords*32 dropped:
// the same bytes as the scan packer device_deflate._pack_bits_scan.
//
// What bounds it on the card: bytes. Every token is read once (8 bytes)
// and the packed stream written once; the arithmetic is a scan and two
// shifts per token. The TPU kernel walks one lane's token blocks in
// order with the output strip resident in VMEM; Hopper runs blocks in no
// order, so nothing is carried between them. Instead the starting bit
// offset of every 256-token block comes from a scan done before the
// launch (the wrapper's block sums + cumsum, as bitpack.py:188 does with
// XLA), one CUDA block handles one (lane, token block), an exclusive
// warp-shuffle scan of the bit counts gives each token its bit offset,
// and each thread ORs its word part `val << (off & 31)` and its spill
// into the next word with atomicOr. Token bit ranges are disjoint, so the
// OR is exact in any order; the output is zeroed by the wrapper. Offsets
// are 64-bit, so a lane may exceed 2^31 bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB = 256;  // tokens per block
constexpr int WARPS = TB / 32;

__global__ void __launch_bounds__(TB)
pack_block(const int32_t* __restrict__ bits, const int32_t* __restrict__ nbits,
           const long long* __restrict__ base, uint32_t* __restrict__ out,
           long long ntok, int nblocks, long long nwords) {
  __shared__ int warp_sums[WARPS];
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
  if (val == 0) return;  // zero-length tokens (run interiors, padding) carry 0
  const long long off = base[(size_t)lane * nblocks + blk] +
                        (wid ? warp_sums[wid - 1] : 0) + inc - nb;
  const int s = (int)(off & 31);
  const long long w = off >> 5;
  uint32_t* row = out + (size_t)lane * nwords;
  if (w < nwords) atomicOr(row + w, val << s);
  // spill into the next word; s == 0 has none (avoids a shift by 32)
  const uint32_t hi = s ? (val >> (32 - s)) : 0u;
  if (hi != 0 && w + 1 < nwords) atomicOr(row + w + 1, hi);
}

}  // namespace

// bits, nbits: (B, ntok) int32; base: (B, nblocks) int64 exclusive bit
// offset of each 256-token block; out: (B, nwords) uint32, zeroed.
extern "C" int ompb_bitpack(const void* bits, const void* nbits, const void* base,
                            void* out, int B, long long ntok, int nblocks,
                            long long nwords, void* stream) {
  if (B < 0 || B > 65535 || ntok < 0 || nwords < 0 ||
      nblocks != (int)((ntok + TB - 1) / TB)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || nblocks == 0) return 0;
  dim3 grid(nblocks, B);
  pack_block<<<grid, TB, 0, (cudaStream_t)stream>>>(
      (const int32_t*)bits, (const int32_t*)nbits, (const long long*)base,
      (uint32_t*)out, ntok, nblocks, nwords);
  return (int)cudaGetLastError();
}
