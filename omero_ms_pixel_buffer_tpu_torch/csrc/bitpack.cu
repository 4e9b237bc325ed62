// Deflate token bit packer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in omero_ms_pixel_buffer_tpu/ops/pallas/bitpack.py
// (pack_tokens_sp, body _kernel_sp). Contract: batched token arrays
// (B, ntok) of code values (< 2^32, in practice <= 20 significant bits)
// and bit counts (<= 21) -> (B, nwords) 32-bit words whose little-endian
// bytes are the LSB-first deflate bitstream, bits past nwords*32 dropped,
// and (B,) int64 bit totals: the same bytes as the scan packer
// device_deflate._pack_bits_scan.
//
// What bounds it on the card: bytes. Each token (8 bytes) is read once and
// each output word written once; the arithmetic is a scan and a few shifts
// per token. The TPU kernel walks one lane's token blocks in order with the
// output strip resident in VMEM and carries the bit offset from block to
// block. Hopper runs blocks in no order, and an earlier design paid for that
// with a scan of block sums before the launch (extra passes over the bit
// counts), a zeroed output and one global atomicOr per token. This one reads
// and writes nothing but the function's own bytes, plus 16 bytes per tile:
//
// - One CTA packs a tile of 4096 consecutive tokens of one lane, 16 per
//   thread as four 16-byte loads of each array, warp-striped. Tiles start on
//   16-byte boundaries of the flat (B * ntok) arrays, so a lane whose row
//   is misaligned (ntok odd) masks the few tokens of its neighbours in its
//   first and last quads instead of loading word by word.
// - Tile offsets come from a single-pass chained scan with decoupled
//   look-back (Merrill and Garland): a CTA takes its tile from an atomic
//   ticket, so it only waits on tiles already running; it publishes its
//   aggregate, a warp sums its predecessors' published aggregates back to
//   the first inclusive prefix, and it publishes its own inclusive prefix.
//   Status and value share one 64-bit word, so relaxed loads and stores
//   suffice (no fences); offsets are 64-bit, so a lane may pass 2^31 bits.
//   The lane's last tile writes the lane's total.
// - The tile's words live in a shared-memory strip: each thread ORs its
//   quads (four tokens joined in registers) into it with shared atomics,
//   and the strip is written out with coalesced 16-byte stores.
// - Words on tile boundaries: a tile stores the words from the one holding
//   its first bit up to, not including, the one holding its end, so a word
//   is stored by the last tile that starts in or before it. Each tile
//   publishes, in one more 64-bit word, the bits it put into its last,
//   partial word and whether its bits began in that word too; its successor
//   ORs into its first word the partial words of the tiles before it that
//   share that word (more than one when a tile holds fewer bits than reach
//   a word boundary, e.g. only zero-length tokens). The lane's last tile
//   stores its last word and zeros up to nwords. No global atomics besides
//   the ticket, no memset of the output.
//
// The only per-call clearing is the ticket and the tiles' two status words:
// cudaMemsetAsync of 8 + 16 * B * ntiles bytes on the call's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_BITS = 21;  // bits of the longest token

// flags: status in the top two bits, the value below
constexpr unsigned long long ST_AGG = 1ull;   // the tile's aggregate
constexpr unsigned long long ST_INCL = 2ull;  // its inclusive prefix
constexpr int ST_SHIFT = 62;
constexpr unsigned long long VAL_MASK = (1ull << ST_SHIFT) - 1;
// hand-over words: the tile's bits in its last word, and two flags
constexpr unsigned long long HAND_VALID = 1ull << 63;
constexpr unsigned long long HAND_CONT = 1ull << 62;  // its bits began in that word too

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

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
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

// OR value v into the 128-bit window (lo, hi) at bit b (b + 32 <= 128).
__device__ __forceinline__ void place(unsigned long long& lo, unsigned long long& hi,
                                      uint32_t v, int b) {
  if (b < 64) {
    lo |= (unsigned long long)v << b;
    if (b > 32) hi |= (unsigned long long)v >> (64 - b);
  } else {
    hi |= (unsigned long long)v << (b - 64);
  }
}

struct Args {
  const int32_t* bits;
  const int32_t* nbits;
  uint32_t* out;
  long long* totals;
  unsigned int* ticket;
  unsigned long long* flags;   // per tile, lane-major
  unsigned long long* hand;    // per tile, lane-major
  unsigned long long* stamps;  // STAMPS: 8 per ticket, phase times (ns) and the SM
  int B, ntiles, misalign;
  long long ntok, nwords;
};

// 256 threads x 4 quads: tokens per tile (SP_TILE in ops/kernels/bitpack.py,
// which sizes the workspace)
constexpr int THREADS = 256, QUADS = 4;
constexpr int TILE = THREADS * QUADS * 4;

// Pack one tile per CTA. STAMPS records each CTA's phase times (a
// diagnostic build only: it costs registers).
template <bool VEC, bool STAMPS>
__global__ void __launch_bounds__(THREADS) sp_pack_tiles(Args A) {
  constexpr int WARPS = THREADS / 32;
  constexpr int WARP_TOKENS = TILE / WARPS;
  // words a quad's 128-bit window can touch: its first word at most
  // (31 + TILE * MAX_BITS) / 32, and three more
  constexpr int STRIP = (31 + TILE * MAX_BITS) / 32 + 4;
  __shared__ uint32_t strip[STRIP];
  __shared__ int warp_sums[WARPS];
  __shared__ unsigned int s_ticket;
  __shared__ long long s_prefix;

  const int t = threadIdx.x;
  const int wid = t >> 5, lid = t & 31;
  unsigned long long stamp[6];
  if (STAMPS) stamp[0] = now_ns();
  if (t == 0) s_ticket = atomicAdd(A.ticket, 1u);
  for (int k = t; k < STRIP; k += THREADS) strip[k] = 0u;
  __syncthreads();
  if (STAMPS) stamp[1] = now_ns();
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
  if (STAMPS) stamp[2] = now_ns();
  int wexcl = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int v = warp_sums[w];
    wexcl += w < wid ? v : 0;
    agg += v;
  }

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
  if (STAMPS) stamp[3] = now_ns();
  const long long prefix = s_prefix;
  const int s0 = (int)(prefix & 31);
  const long long wfirst = prefix >> 5;  // the lane's word holding the tile's first bit

  // each quad's four tokens joined in a 128-bit window, ORed into the strip
#pragma unroll
  for (int q = 0; q < QUADS; ++q) {
    const int b0 = s0 + wexcl + qoff[q];
    const int sb = b0 & 31;
    unsigned long long lo = 0, hi = 0;
    const int n0 = (int)qn[q].x, n1 = (int)qn[q].y, n2 = (int)qn[q].z;
    place(lo, hi, qv[q].x, sb);
    place(lo, hi, qv[q].y, sb + n0);
    place(lo, hi, qv[q].z, sb + n0 + n1);
    place(lo, hi, qv[q].w, sb + n0 + n1 + n2);
    uint32_t* w = strip + (b0 >> 5);
    if ((uint32_t)lo) atomicOr(w, (uint32_t)lo);
    if ((uint32_t)(lo >> 32)) atomicOr(w + 1, (uint32_t)(lo >> 32));
    if ((uint32_t)hi) atomicOr(w + 2, (uint32_t)hi);
    if ((uint32_t)(hi >> 32)) atomicOr(w + 3, (uint32_t)(hi >> 32));
  }
  __syncthreads();
  if (STAMPS) stamp[4] = now_ns();

  const long long end = prefix + agg;      // the tile's inclusive prefix
  const int last_local = (s0 + agg) >> 5;  // strip index of the word holding bit `end`
  const bool last_tile = tile == A.ntiles - 1;
  // words this tile stores: [wfirst, end >> 5), and for the lane's last
  // tile everything up to nwords
  long long wstop = last_tile ? A.nwords : (end >> 5);
  if (wstop > A.nwords) wstop = A.nwords;
  uint32_t* orow = A.out + (long long)lane * A.nwords;

  if (t == 0) {
    const bool cont = s0 && wfirst == (end >> 5);
    st_relaxed(A.hand + first + tile,
               HAND_VALID | (cont ? HAND_CONT : 0ull) | strip[last_local]);
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
      orow[wfirst] = strip[0] | carry;
    }
    if (STAMPS) stamp[5] = now_ns();
  }
  // every other word: strip words, then (last tile) zeros; 16-byte stores
  // where the row's alignment allows
  const long long lo = wfirst + 1;
  if (lo < wstop) {
    const int amis = (int)(((uintptr_t)orow >> 2) & 3);  // orow + w aligned: (w + amis) % 4 == 0
    long long vstart = lo + ((4 - ((lo + amis) & 3)) & 3);
    if (vstart > wstop) vstart = wstop;
    const long long vend = vstart + ((wstop - vstart) & ~3LL);
    for (long long w = lo + t; w < vstart; w += THREADS) {
      const long long k = w - wfirst;
      orow[w] = k <= last_local ? strip[k] : 0u;
    }
    for (long long w = vend + t; w < wstop; w += THREADS) {
      const long long k = w - wfirst;
      orow[w] = k <= last_local ? strip[k] : 0u;
    }
    for (long long w = vstart + 4LL * t; w < vend; w += 4LL * THREADS) {
      const long long k = w - wfirst;
      uint4 v;
      v.x = k <= last_local ? strip[k] : 0u;
      v.y = k + 1 <= last_local ? strip[k + 1] : 0u;
      v.z = k + 2 <= last_local ? strip[k + 2] : 0u;
      v.w = k + 3 <= last_local ? strip[k + 3] : 0u;
      __stcs(reinterpret_cast<uint4*>(orow + w), v);
    }
  }
  if (STAMPS) {
    __syncthreads();
    if (t == 0) {
      unsigned smid;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
      unsigned long long* rec = A.stamps + 8LL * ticket;
      for (int i = 0; i < 6; ++i) rec[i] = stamp[i];
      rec[6] = now_ns();
      rec[7] = smid;
    }
  }
}

template <bool VEC>
cudaError_t launch(const Args& A, unsigned n, cudaStream_t s) {
  if (A.stamps) {
    sp_pack_tiles<VEC, true><<<n, THREADS, 0, s>>>(A);
  } else {
    sp_pack_tiles<VEC, false><<<n, THREADS, 0, s>>>(A);
  }
  return cudaGetLastError();
}

int sp_pack(const void* bits, const void* nbits, void* out, void* totals, void* ws,
            long long ws_bytes, int B, long long ntok, long long nwords, void* stream,
            void* stamps) {
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
  A.stamps = (unsigned long long*)stamps;
  A.B = B;
  A.ntiles = (int)ntiles;
  A.misalign = (int)(((uintptr_t)bits >> 2) & 3);
  A.ntok = ntok;
  A.nwords = nwords;
  const bool vec = (((uintptr_t)bits ^ (uintptr_t)nbits) & 15) == 0;
  return (int)(vec ? launch<true>(A, (unsigned)n, s) : launch<false>(A, (unsigned)n, s));
}

}  // namespace

// bits, nbits: (B, ntok) int32; out: (B, nwords) uint32; totals: (B,)
// int64; ws: 8-byte aligned workspace of 8 + 16 * B * ntiles bytes, ntiles
// = ceil((ntok + 3) / TILE): the ticket and the tiles' status words
// (sp_workspace_bytes in ops/kernels/bitpack.py).
extern "C" int ompb_sp_pack(const void* bits, const void* nbits, void* out, void* totals,
                            void* ws, long long ws_bytes, int B, long long ntok,
                            long long nwords, void* stream) {
  return sp_pack(bits, nbits, out, totals, ws, ws_bytes, B, ntok, nwords, stream, nullptr);
}

// The same through the STAMPS build, which also writes 8 uint64 per tile,
// in ticket order, to `stamps` (not null): %globaltimer at entry, ticket
// taken, tokens scanned, prefix known, strip built, partial words handed
// over (thread 0) and end, then the SM's index.
extern "C" int ompb_sp_pack_stamped(const void* bits, const void* nbits, void* out,
                                    void* totals, void* ws, long long ws_bytes, int B,
                                    long long ntok, long long nwords, void* stream,
                                    void* stamps) {
  if (!stamps) return (int)cudaErrorInvalidValue;
  return sp_pack(bits, nbits, out, totals, ws, ws_bytes, B, ntok, nwords, stream, stamps);
}
