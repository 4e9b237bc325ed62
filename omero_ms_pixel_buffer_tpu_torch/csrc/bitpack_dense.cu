// Deflate token bit packer, word-owned, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in omero_ms_pixel_buffer_tpu/ops/pallas/bitpack.py
// (pack_tokens, body _kernel: the "pallas_dense" packer). Contract as the
// token-owned kernel in bitpack.cu: batched token arrays (B, ntok) of code
// values (< 2^nbits) and bit counts (<= 21) -> (B, nwords) 32-bit words
// whose little-endian bytes are the LSB-first deflate bitstream, bits past
// nwords*32 dropped, zero-length tokens writing nothing, and (B,) int64 bit
// totals: the same bytes as the scan packer device_deflate._pack_bits_scan.
//
// What bounds it on the card: bytes. Each token (8 bytes) is read once and
// each output word written once. The TPU kernel is word-owned: every word
// of a block's strip compares itself with every token of the block (a
// one-hot compare-reduce, 2 x 170 compare-select-adds per token) and the
// block's bit offset is carried from grid step to grid step. An earlier
// port kept that sweep and was bound by its operations (1.12 ms on an
// H100 80GB HBM3 at the main shape, against a 0.046 ms bound). This
// design keeps the word-owned identity (each output word is assembled by
// one thread, which gathers the tokens that touch it) and drops the sweep:
//
// - One CTA takes a tile of 4096 consecutive tokens of one lane, 16 per
//   thread as four 16-byte loads of each array, warp-striped. Tiles start
//   on 16-byte boundaries of the flat (B * ntok) arrays, so a lane whose
//   row is misaligned (ntok odd) masks the few tokens of its neighbours in
//   its first and last quads; they count as zero-length tokens.
// - A block scan gives each token's tile-relative start bit; the starts
//   (non-decreasing, 4097 of them: the last is the tile's bit count) and
//   the values are staged in shared memory.
// - The tile's bit offset in its lane comes from a single-pass chained scan
//   with decoupled look-back, as in bitpack.cu: an atomic ticket hands out
//   tiles in lane order, and status and value share one 64-bit word, read
//   and written relaxed. Offsets are 64-bit, so a lane may pass 2^31 bits.
// - Words: once the offset is known, every token that holds the first bit
//   of a word (a token of at most 21 bits holds at most one) writes its
//   index into a shared word -> first-token table. A thread owns a
//   16-byte-aligned group of four words (or one word at a row's unaligned
//   ends): it looks up the group's first token and walks the tokens
//   starting before the group's end, ORing in the low part of a token
//   starting inside and the spill of one starting in the word before. A
//   zero-length token shares its start with the next token, so the walk
//   jumps over a run of them with a galloping search of the starts; the walk
//   is bounded by the next group's first token, whatever the number of
//   tokens in a word. The group is written once with one 16-byte store: no
//   atomics.
// - Words on tile boundaries: a word is stored by the last tile that starts
//   in or before it. Each tile publishes the bits it put into its last,
//   partial word and whether its bits began in that word too; its
//   successor ORs into its first word the partial words of the tiles
//   before it that share that word, walking back while they say
//   "continue" (tiles under 32 bits, zero-length lanes). The lane's last
//   tile writes the lane's total and the words up to nwords, zeros past its
//   end. No memset of the output.
//
// The only per-call clearing is the ticket and the tiles' two status words:
// cudaMemsetAsync of 8 + 16 * B * ntiles bytes on the call's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// flags: status in the top two bits, the value below
constexpr unsigned long long ST_AGG = 1ull;   // the tile's aggregate
constexpr unsigned long long ST_INCL = 2ull;  // its inclusive prefix
constexpr int ST_SHIFT = 62;
constexpr unsigned long long VAL_MASK = (1ull << ST_SHIFT) - 1;
// hand-over words: the tile's bits in its last word, and two flags
constexpr unsigned long long HAND_VALID = 1ull << 63;
constexpr unsigned long long HAND_CONT = 1ull << 62;  // its bits began in that word too

// 256 threads x 4 quads: tokens per tile (DENSE_TILE in
// ops/kernels/bitpack_dense.py, which sizes the workspace)
constexpr int THREADS = 256, QUADS = 4;
constexpr int TILE = THREADS * QUADS * 4;
constexpr int WARPS = THREADS / 32;
constexpr int WARP_TOKENS = TILE / WARPS;
constexpr int MAX_BITS = 21;  // bits of the longest token
// words a tile's bits can touch, counted from the word holding its first bit
constexpr int SPAN = (31 + TILE * MAX_BITS) / 32 + 1;

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// spin until the word is at least `least`
__device__ __forceinline__ unsigned long long spin_until(const unsigned long long* p,
                                                         unsigned long long least) {
  unsigned long long f;
  while ((f = ld_relaxed(p)) < least) {
  }
  return f;
}

// The four tokens at flat index g (16-byte aligned when VEC): those
// outside [lo, hi) read as zero.
template <bool VEC>
__device__ __forceinline__ uint4 load_quad(const int32_t* __restrict__ a, long long g,
                                           long long lo, long long hi) {
  if (VEC && g >= lo && g + 4 <= hi) {
    return __ldcs(reinterpret_cast<const uint4*>(a + g));
  }
  uint32_t v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long i = g + k;
    v[k] = (i >= lo && i < hi) ? (uint32_t)__ldcs(a + i) : 0u;
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// The last token starting at bit s, given start[i] == s: past a run of
// zero-length tokens. Runs are mostly short (match interiors), so the
// search gallops from i before it bisects.
__device__ __forceinline__ int last_at(const int* start, int i, int s) {
  int lo = i, hi = i + 1, step = 1;  // start[lo] == s; start[hi] > s once found
  while (hi <= TILE && start[hi] == s) {
    lo = hi;
    hi += step;
    step <<= 1;
  }
  if (hi > TILE + 1) hi = TILE + 1;
  while (hi - lo > 1) {  // start[lo] == s, start[hi] > s (or hi == TILE + 1)
    const int mid = (lo + hi) >> 1;
    if (start[mid] > s) {
      hi = mid;
    } else {
      lo = mid;
    }
  }
  return lo;
}

// OR value v into the 128-bit window (lo, hi) at bit p (-32 < p < 128):
// a negative p is the spill of a token starting before the window.
__device__ __forceinline__ void place(unsigned long long& lo, unsigned long long& hi,
                                      uint32_t v, int p) {
  if (p < 0) {
    lo |= (unsigned long long)(v >> (-p));
  } else if (p < 64) {
    lo |= (unsigned long long)v << p;
    if (p > 32) hi |= (unsigned long long)v >> (64 - p);
  } else {
    hi |= (unsigned long long)v << (p - 64);
  }
}

// The tile's bits in the window [b, b + width) of tile-relative bits, as
// (lo, hi) 64-bit halves (width <= 128). b is -s0 (the tile's first word)
// or a word boundary at or past the tile's first bit: b + s0 = 32 * k, and
// word_tok[k] is the token holding bit b when b < agg.
__device__ __forceinline__ void gather(const int* start, const uint32_t* val,
                                       const short* word_tok, int s0, int agg, int b, int width,
                                       unsigned long long& lo, unsigned long long& hi) {
  lo = hi = 0;
  if (b >= agg) return;
  const int end = b + width;
  int i = b < 0 ? 0 : word_tok[(b + s0) >> 5];
  int s = start[i];
  while (i < TILE && s < end) {
    // two tokens a step: their starts and values load together
    const int e = start[i + 1], e2 = start[i + 2];
    const uint32_t v = val[i], v2 = val[i + 1];
    if (e == s) {
      // zero-length: jump to the last token starting at s, which has bits
      // (or is past the tile's end)
      i = last_at(start, i, s);
      continue;
    }
    place(lo, hi, v, s - b);
    if (e < end && i + 1 < TILE && e2 != e) {
      place(lo, hi, v2, e - b);
      i += 2;
      s = e2;
    } else {
      ++i;
      s = e;
    }
  }
}

struct Args {
  const int32_t* bits;
  const int32_t* nbits;
  uint32_t* out;
  long long* totals;
  unsigned int* ticket;
  unsigned long long* flags;  // per tile, lane-major
  unsigned long long* hand;   // per tile, lane-major
  int B, ntiles, misalign;
  long long ntok, nwords;
};

// Five CTAs per SM (48 registers, a few spilled): the gather is bound by
// the latency of its shared-memory walk, and the fifth CTA hides more of it
// than the spills cost (on an H100 80GB HBM3 at the main path's shape,
// 0.100-0.110 against 0.116 ms per call at four).
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 5) dense_pack_tiles(Args A) {
  __shared__ __align__(16) int start[TILE + 4];  // start[TILE]: the tile's bits
  __shared__ __align__(16) uint32_t val[TILE + 4];  // val[TILE]: read, never used
  __shared__ short word_tok[SPAN];  // word (from the tile's first) -> its first token
  __shared__ int warp_sums[WARPS];
  __shared__ unsigned int s_ticket;
  __shared__ long long s_prefix;

  const int t = threadIdx.x;
  const int wid = t >> 5, lid = t & 31;
  if (t == 0) s_ticket = atomicAdd(A.ticket, 1u);
  __syncthreads();
  // tiles in ticket order: tile 0 of every lane, then tile 1, ...
  const unsigned ticket = s_ticket;
  const int lane = (int)(ticket % (unsigned)A.B);
  const int tile = (int)(ticket / (unsigned)A.B);
  const long long row = (long long)lane * A.ntok;
  const long long g0 = row - ((row + A.misalign) & 3) + (long long)tile * TILE +
                       wid * WARP_TOKENS + lid * 4;
  uint4 qv[QUADS], qn[QUADS];
#pragma unroll
  for (int q = 0; q < QUADS; ++q) {
    qn[q] = load_quad<VEC>(A.nbits, g0 + q * 128, row, row + A.ntok);
    qv[q] = load_quad<VEC>(A.bits, g0 + q * 128, row, row + A.ntok);
  }

  // tile-local exclusive bit offset of each quad: warp scans of quad sums
  int qoff[QUADS];
  int run = 0;
#pragma unroll
  for (int q = 0; q < QUADS; ++q) {
    const int s = (int)(qn[q].x + qn[q].y + qn[q].z + qn[q].w);
    int inc = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, d);
      if (lid >= d) inc += v;
    }
    qoff[q] = run + inc - s;
    run += __shfl_sync(0xffffffffu, inc, 31);
  }
  if (lid == 31) warp_sums[wid] = run;
  __syncthreads();
  int wexcl = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int v = warp_sums[w];
    wexcl += w < wid ? v : 0;
    agg += v;
  }
  // stage every token's start bit and value
#pragma unroll
  for (int q = 0; q < QUADS; ++q) {
    const int k = wid * WARP_TOKENS + q * 128 + lid * 4;
    const int o = wexcl + qoff[q];
    const int o1 = o + (int)qn[q].x, o2 = o1 + (int)qn[q].y, o3 = o2 + (int)qn[q].z;
    *reinterpret_cast<int4*>(start + k) = make_int4(o, o1, o2, o3);
    *reinterpret_cast<uint4*>(val + k) = qv[q];
  }
  if (t == 0) start[TILE] = agg;

  const long long first = (long long)lane * A.ntiles;  // the lane's first tile record
  if (wid == 0) {
    if (lid == 0) {
      st_relaxed(A.flags + first + tile,
                 ((tile ? ST_AGG : ST_INCL) << ST_SHIFT) | (unsigned long long)agg);
    }
    // decoupled look-back over windows of 32 predecessors
    long long excl = 0;
    for (int base = tile - 1;; base -= 32) {
      const int j = base - lid;
      unsigned long long f = ST_INCL << ST_SHIFT;  // before the lane's first tile: 0
      if (j >= 0) f = spin_until(A.flags + first + j, ST_AGG << ST_SHIFT);
      const unsigned incl = __ballot_sync(0xffffffffu, (f >> ST_SHIFT) >= ST_INCL);
      const int stop = incl ? __ffs(incl) - 1 : 31;
      long long v = lid <= stop ? (long long)(f & VAL_MASK) : 0;
#pragma unroll
      for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
      excl += v;
      if (incl) break;
    }
    if (lid == 0) {
      st_relaxed(A.flags + first + tile, (ST_INCL << ST_SHIFT) | (unsigned long long)(excl + agg));
      s_prefix = excl;
    }
  }
  __syncthreads();
  const long long prefix = s_prefix;
  const int s0 = (int)(prefix & 31);
  const long long wfirst = prefix >> 5;  // the lane's word holding the tile's first bit
  const long long end = prefix + agg;    // the tile's inclusive prefix
  const bool last_tile = tile == A.ntiles - 1;
  // words this tile stores: [wfirst, end >> 5), and for the lane's last
  // tile everything up to nwords
  long long wstop = last_tile ? A.nwords : (end >> 5);
  if (wstop > A.nwords) wstop = A.nwords;
  uint32_t* orow = A.out + (long long)lane * A.nwords;
  unsigned long long lo, hi;

  // the word -> first-token table: a token holding a word's first bit
  // (counted from the word holding the tile's first bit) names itself
#pragma unroll
  for (int q = 0; q < QUADS; ++q) {
    const int k = wid * WARP_TOKENS + q * 128 + lid * 4;
    const int4 st = *reinterpret_cast<const int4*>(start + k);
    const int b[5] = {st.x, st.y, st.z, st.w, start[k + 4]};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int w = (b[j] + s0 + 31) >> 5;  // the first word starting in or after it
      if ((w << 5) < b[j + 1] + s0 && w < SPAN) word_tok[w] = (short)(k + j);
    }
  }
  __syncthreads();

  if (t == 0) {
    // hand over the partial last word first: the successor waits on it
    gather(start, val, word_tok, s0, agg, (int)(((end >> 5) << 5) - prefix), 32, lo, hi);
    const bool cont = s0 && wfirst == (end >> 5);
    st_relaxed(A.hand + first + tile, HAND_VALID | (cont ? HAND_CONT : 0ull) | (uint32_t)lo);
    if (last_tile) A.totals[lane] = end;
    if (wfirst < wstop) {
      // the partial words of the tiles before that share word wfirst
      uint32_t carry = 0;
      if (s0) {
        for (int j = tile - 1; j >= 0; --j) {
          const unsigned long long h = spin_until(A.hand + first + j, HAND_VALID);
          carry |= (uint32_t)h;
          if (!(h & HAND_CONT)) break;
        }
      }
      gather(start, val, word_tok, s0, agg, -s0, 32, lo, hi);
      orow[wfirst] = (uint32_t)lo | carry;
    }
  }
  // every other word: aligned groups of four with 16-byte stores, single
  // words at the row's unaligned ends; zeros past the tile's bits
  const long long wlo = wfirst + 1;
  if (wlo < wstop) {
    const int amis = (int)(((uintptr_t)orow >> 2) & 3);  // orow + w aligned: (w + amis) % 4 == 0
    long long vstart = wlo + ((4 - ((wlo + amis) & 3)) & 3);
    if (vstart > wstop) vstart = wstop;
    const long long vend = vstart + ((wstop - vstart) & ~3LL);
    const long long ones = (vstart - wlo) + (wstop - vend);  // single words
    for (long long k = t; k < ones; k += THREADS) {
      const long long w = k < vstart - wlo ? wlo + k : vend + (k - (vstart - wlo));
      const long long b = 32 * w - prefix;
      uint32_t v = 0;
      if (b < agg) {
        gather(start, val, word_tok, s0, agg, (int)b, 32, lo, hi);
        v = (uint32_t)lo;
      }
      orow[w] = v;
    }
    for (long long w = vstart + 4LL * t; w < vend; w += 4LL * THREADS) {
      const long long b = 32 * w - prefix;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (b < agg) {
        gather(start, val, word_tok, s0, agg, (int)b, 128, lo, hi);
        v = make_uint4((uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi, (uint32_t)(hi >> 32));
      }
      __stcs(reinterpret_cast<uint4*>(orow + w), v);
    }
  }
}

}  // namespace

// bits, nbits: (B, ntok) int32; out: (B, nwords) uint32; totals: (B,)
// int64; ws: 8-byte aligned workspace of 8 + 16 * B * ntiles bytes, ntiles
// = ceil((ntok + 3) / TILE): the ticket and the tiles' status words
// (dense_workspace_bytes in ops/kernels/bitpack_dense.py).
extern "C" int ompb_dense_pack(const void* bits, const void* nbits, void* out, void* totals,
                               void* ws, long long ws_bytes, int B, long long ntok,
                               long long nwords, void* stream) {
  if (B < 0 || B > 65535 || ntok < 0 || nwords < 0 || ((uintptr_t)ws & 7)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long ntiles = (ntok + 3 + TILE - 1) / TILE;
  const long long n = (long long)B * ntiles;
  if (ws_bytes < 8 + 16 * n || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(ws, 0, 8 + 16 * n, s);
  if (err != cudaSuccess) return (int)err;
  Args A;
  A.bits = (const int32_t*)bits;
  A.nbits = (const int32_t*)nbits;
  A.out = (uint32_t*)out;
  A.totals = (long long*)totals;
  A.ticket = (unsigned int*)ws;
  A.flags = (unsigned long long*)((char*)ws + 8);
  A.hand = A.flags + n;
  A.B = B;
  A.ntiles = (int)ntiles;
  A.misalign = (int)(((uintptr_t)bits >> 2) & 3);
  A.ntok = ntok;
  A.nwords = nwords;
  const bool vec = (((uintptr_t)bits ^ (uintptr_t)nbits) & 15) == 0;
  if (vec) {
    dense_pack_tiles<true><<<(unsigned)n, THREADS, 0, s>>>(A);
  } else {
    dense_pack_tiles<false><<<(unsigned)n, THREADS, 0, s>>>(A);
  }
  return (int)cudaGetLastError();
}
