// Fused byteswap + PNG scanline filter for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _filter_tiles in
// omero_ms_pixel_buffer_tpu/ops/pallas/filter.py (pl.pallas_call at :137,
// bodies _kernel_u16 / _kernel_u8). Contract: for native 8- or 16-bit tiles
// (B, H, W[, S]) the output (B, H, OB = 1 + IB) with IB = W*S*itemsize is
// exactly png.filter_batch(to_big_endian_bytes(tiles), bpp, mode), bpp =
// S*itemsize: byte 0 of every row holds the filter code, the rest the
// big-endian residual bytes x - predictor(a, b, c) mod 256.
//
// What bounds it: bytes. Each output byte costs a few integer operations
// against one read of the tiles and one write of the scanlines, so the
// design is about memory instructions and keeping loads in flight:
//
// 1. Row groups. Each warp of filter_row_groups owns R consecutive
//    scanlines of the flattened B*H row space (R from the row width: about
//    4 KB of output, 4 rows at 512 uint16 columns), so a CTA of 8 warps owns
//    8R consecutive rows. A group may straddle two lanes: the warp tracks
//    each row's index inside its lane (no division per byte) and the first
//    row of a lane has no row above it.
// 2. Wide loads, byteswap in registers. The warp walks its rows in column
//    steps of 512 bytes, lane l holding 16-byte chunk l of the step, loaded
//    with one 16-byte load and swapped to big-endian sample order with
//    __byte_perm. The row above is the previous row's chunk, still in the
//    lane's registers, so each input byte is loaded once (plus one row per
//    group); the left neighbours (bpp <= 16 bytes back) come from the left
//    lane by shuffle, or for lane 0 from one load of the chunk before it.
//    The next row's loads are issued before this row is filtered.
// 3. Sixteen output bytes per lane, the mode a template parameter. The a
//    (left) and c (above-left) chunks are byte windows of two chunks (a
//    warp-uniform funnel shift). None/Sub/Up are __vsub4 on each word,
//    Average __vsub4 of __vhaddu4 (floor((a + b) / 2)), Paeth unpacks to
//    int32 with filter.py's tie order.
// 4. Aligned stores. Output row r starts at r*OB, at any alignment m. Each
//    lane stores the 16-byte aligned chunk made of its left lane's last m
//    result bytes and its own first 16 - m (a shuffle and a funnel shift),
//    so all stores inside a column step are 16-byte stores; only the two
//    ends of a step (lane 0's head, the last lane's tail) and the filter
//    code byte are byte stores.
//
// No shared memory and no barrier: warps are independent, so one row's
// loads overlap other warps' arithmetic and stores. Rows that are not
// 16-byte aligned (a misaligned tensor, a row length that is not a multiple
// of 16 bytes) or bpp > 16 take filter_row_groups_bytes: the same row
// groups and 16 bytes a lane, with byte loads and stores. Any width runs.
//
// Signed samples are filtered as their unsigned bits; Paeth runs in int32
// like _residual (filter.py:100-107); Average is floor((a + b) / 2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;         // 8 warps, each owning one row group
constexpr int kGroupOutBytes = 4096;  // output bytes a row group aims for
constexpr int kMaxRows = 64;          // rows per group at most

template <int MODE>
__device__ __forceinline__ int predict(int a, int b, int c) {
  if (MODE == 0) return 0;
  if (MODE == 1) return a;
  if (MODE == 2) return b;
  if (MODE == 3) return (a + b) >> 1;
  const int p = a + b - c;
  const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  return (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
}

// Four residual bytes from four packed x, a, b, c bytes.
template <int MODE>
__device__ __forceinline__ uint32_t residual4(uint32_t x, uint32_t a, uint32_t b,
                                              uint32_t c) {
  if (MODE == 0) return x;
  if (MODE == 1) return __vsub4(x, a);
  if (MODE == 2) return __vsub4(x, b);
  if (MODE == 3) return __vsub4(x, __vhaddu4(a, b));
  uint32_t pred = 0;
#pragma unroll
  for (int s = 0; s < 32; s += 8) {
    pred |= (uint32_t)predict<4>((a >> s) & 0xFF, (b >> s) & 0xFF, (c >> s) & 0xFF) << s;
  }
  return __vsub4(x, pred);
}

template <int MODE>
__device__ __forceinline__ uint4 residual16(uint4 x, uint4 a, uint4 b, uint4 c) {
  return make_uint4(residual4<MODE>(x.x, a.x, b.x, c.x), residual4<MODE>(x.y, a.y, b.y, c.y),
                    residual4<MODE>(x.z, a.z, b.z, c.z), residual4<MODE>(x.w, a.w, b.w, c.w));
}

// Bytes [s, s + 16) of the 32 bytes p then q, 0 <= s <= 16; s is the same
// across the warp, so the switch does not diverge.
__device__ __forceinline__ uint4 window(uint4 p, uint4 q, int s) {
  uint32_t w0, w1, w2, w3, w4;
  switch (s >> 2) {
    case 0: w0 = p.x; w1 = p.y; w2 = p.z; w3 = p.w; w4 = q.x; break;
    case 1: w0 = p.y; w1 = p.z; w2 = p.w; w3 = q.x; w4 = q.y; break;
    case 2: w0 = p.z; w1 = p.w; w2 = q.x; w3 = q.y; w4 = q.z; break;
    case 3: w0 = p.w; w1 = q.x; w2 = q.y; w3 = q.z; w4 = q.w; break;
    default: return q;
  }
  const int b = (s & 3) * 8;
  return make_uint4(__funnelshift_r(w0, w1, b), __funnelshift_r(w1, w2, b),
                    __funnelshift_r(w2, w3, b), __funnelshift_r(w3, w4, b));
}

__device__ __forceinline__ uint4 shfl_up16(uint4 v) {
  return make_uint4(__shfl_up_sync(~0u, v.x, 1), __shfl_up_sync(~0u, v.y, 1),
                    __shfl_up_sync(~0u, v.z, 1), __shfl_up_sync(~0u, v.w, 1));
}

// 16 native bytes -> big-endian sample order (16-bit samples swap bytes).
template <int ISZ>
__device__ __forceinline__ uint4 big_endian(uint4 v) {
  if (ISZ == 1) return v;
  return make_uint4(__byte_perm(v.x, 0, 0x2301), __byte_perm(v.y, 0, 0x2301),
                    __byte_perm(v.z, 0, 0x2301), __byte_perm(v.w, 0, 0x2301));
}

__device__ __forceinline__ uint32_t byte_of(uint4 v, int i) {
  const uint32_t w = i < 4 ? v.x : i < 8 ? v.y : i < 12 ? v.z : v.w;
  return (w >> (8 * (i & 3))) & 0xFF;
}

// One 16-byte chunk of a row as loaded: the chunk and, for lane 0 of a
// column step after the first, the chunk before it (its left neighbours).
struct Chunk {
  uint4 x, left;
};

// Each warp owns R consecutive scanlines of the flattened B*H rows and walks
// them in column steps of 512 bytes (lane l: 16-byte chunk l of the step),
// row by row down each step: the row above is the previous row's chunk,
// still in registers, and the next row's loads are in flight while this row
// is filtered. Needs 16-aligned rows (in % 16 == 0, IB % 16 == 0) and
// bpp <= 16; filter_row_groups_bytes takes every other shape.
template <int ISZ, int MODE>
__global__ void __launch_bounds__(kThreads)
filter_row_groups(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int rows, int H,
                  int IB, int bpp, int R) {
  const int lane = threadIdx.x & 31;
  const int warp = (int)((blockIdx.x * (unsigned)blockDim.x + threadIdx.x) >> 5);
  if ((long long)warp * R >= rows) return;
  const int r_begin = warp * R, r_end = min(rows, r_begin + R);
  const int OB = IB + 1;
  for (int r = r_begin + lane; r < r_end; r += 32) out[(size_t)r * OB] = (uint8_t)MODE;
  constexpr bool kLeft = MODE == 1 || MODE == 3 || MODE == 4;
  const int chunks = IB >> 4;
  for (int c0 = 0; c0 < chunks; c0 += 32) {
    const int c = c0 + lane;
    const bool live = c < chunks;
    const int last = min(31, chunks - 1 - c0);  // last live lane of this step
    auto load = [&](int row) {
      Chunk k{make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
      const uint4* src = reinterpret_cast<const uint4*>(in + (size_t)row * IB) + c;
      if (live) k.x = __ldg(src);
      if (lane == 0 && c0 > 0) k.left = __ldg(src - 1);
      return k;
    };
    // the chunk of the row, big-endian, and the chunk left of it
    auto unpack = [&](const Chunk& k, uint4& x, uint4& xl) {
      x = big_endian<ISZ>(k.x);
      xl = shfl_up16(x);
      if (lane == 0) xl = big_endian<ISZ>(k.left);
    };
    int pos = r_begin % H;  // row index inside its lane
    uint4 b = make_uint4(0, 0, 0, 0), bl = b;
    if (pos != 0) unpack(load(r_begin - 1), b, bl);
    Chunk next = load(r_begin);
    for (int r = r_begin; r < r_end; ++r) {
      const Chunk cur = next;
      if (r + 1 < r_end) next = load(r + 1);
      uint4 x, xl;
      unpack(cur, x, xl);
      const bool up = pos != 0;
      const uint4 zero = make_uint4(0, 0, 0, 0);
      const uint4 a = kLeft ? window(xl, x, 16 - bpp) : zero;
      const uint4 bu = up ? b : zero;
      const uint4 cu = MODE == 4 && up ? window(bl, b, 16 - bpp) : zero;
      const uint4 res = residual16<MODE>(x, a, bu, cu);
      // residual byte 16c of row r sits at `dst`; 16-byte stores need the
      // chunk that starts m bytes before it: the left lane's last m bytes
      // and this lane's first 16 - m
      uint8_t* dst = out + (size_t)r * OB + 1 + 16 * c;
      const int m = (int)((uintptr_t)(out + (size_t)r * OB + 1) & 15);
      const uint4 res_l = shfl_up16(res);
      if (live) {
        if (m == 0) {
          *reinterpret_cast<uint4*>(dst) = res;
        } else {
          if (lane > 0) {
            *reinterpret_cast<uint4*>(dst - m) = window(res_l, res, 16 - m);
          } else {
#pragma unroll
            for (int i = 0; i < 16; ++i) {
              if (i < 16 - m) dst[i] = (uint8_t)byte_of(res, i);
            }
          }
          if (lane == last) {
#pragma unroll
            for (int i = 0; i < 16; ++i) {
              if (i >= 16 - m) dst[i] = (uint8_t)byte_of(res, i);
            }
          }
        }
      }
      b = x;
      bl = xl;
      if (++pos == H) pos = 0;
    }
  }
}

// Any other shape (a misaligned tensor, rows that are not a multiple of 16
// bytes, bpp > 16): the same row groups, 16 output bytes a lane, but byte
// loads and stores.
template <int ISZ, int MODE>
__global__ void __launch_bounds__(kThreads)
filter_row_groups_bytes(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int rows,
                        int H, int IB, int bpp, int R) {
  const int lane = threadIdx.x & 31;
  const int warp = (int)((blockIdx.x * (unsigned)blockDim.x + threadIdx.x) >> 5);
  if ((long long)warp * R >= rows) return;
  const int r_begin = warp * R, r_end = min(rows, r_begin + R);
  const int OB = IB + 1;
  const int sw = ISZ == 2 ? 1 : 0;  // big-endian byte j is native byte j ^ 1
  for (int r = r_begin + lane; r < r_end; r += 32) out[(size_t)r * OB] = (uint8_t)MODE;
  for (int r = r_begin; r < r_end; ++r) {
    const uint8_t* row = in + (size_t)r * IB;
    uint8_t* dst = out + (size_t)r * OB + 1;
    const bool up = (r % H) != 0;
    for (int j0 = 16 * lane; j0 < IB; j0 += 512) {
#pragma unroll 4
      for (int i = 0; i < 16; ++i) {
        const int j = j0 + i;
        if (j < IB) {
          const bool left = j >= bpp;
          const int a = left ? row[(j - bpp) ^ sw] : 0;
          const int b = up ? row[(j ^ sw) - IB] : 0;
          const int c = up && left ? row[((j - bpp) ^ sw) - IB] : 0;
          dst[j] = (uint8_t)((int)row[j ^ sw] - predict<MODE>(a, b, c));
        }
      }
    }
  }
}

template <int ISZ, int MODE>
cudaError_t launch(const uint8_t* in, uint8_t* out, int rows, int H, int IB, int bpp,
                   int group_bytes, cudaStream_t s) {
  const int R = min(kMaxRows, max(1, (group_bytes + IB) / (IB + 1)));
  const long long warps = rows / R + (rows % R != 0);
  const int ctas = (int)((warps * 32 + kThreads - 1) / kThreads);
  if ((uintptr_t)in % 16 == 0 && IB % 16 == 0 && bpp <= 16) {
    filter_row_groups<ISZ, MODE><<<ctas, kThreads, 0, s>>>(in, out, rows, H, IB, bpp, R);
  } else {
    filter_row_groups_bytes<ISZ, MODE><<<ctas, kThreads, 0, s>>>(in, out, rows, H, IB, bpp, R);
  }
  return cudaGetLastError();
}

template <int ISZ>
cudaError_t launch_mode(int mode, const uint8_t* in, uint8_t* out, int rows, int H, int IB,
                        int bpp, int group_bytes, cudaStream_t s) {
  switch (mode) {
    case 0: return launch<ISZ, 0>(in, out, rows, H, IB, bpp, group_bytes, s);
    case 1: return launch<ISZ, 1>(in, out, rows, H, IB, bpp, group_bytes, s);
    case 2: return launch<ISZ, 2>(in, out, rows, H, IB, bpp, group_bytes, s);
    case 3: return launch<ISZ, 3>(in, out, rows, H, IB, bpp, group_bytes, s);
    default: return launch<ISZ, 4>(in, out, rows, H, IB, bpp, group_bytes, s);
  }
}

}  // namespace

// ompb_filter with the row group's output bytes given (rows per group =
// group_bytes / (1 + WS*itemsize) rounded up, 1 to 64); for sweeps of the
// launch shape.
extern "C" int ompb_filter_tuned(const void* in, void* out, int rows, int H, int WS, int S,
                                 int itemsize, int mode, int group_bytes, void* stream) {
  if (rows < 0 || H <= 0 || WS < 0 || S <= 0 || mode < 0 || mode > 4 ||
      (itemsize != 1 && itemsize != 2) || (uintptr_t)in % itemsize != 0 || group_bytes <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  const int IB = WS * itemsize, bpp = S * itemsize;
  const uint8_t* src = (const uint8_t*)in;
  uint8_t* dst = (uint8_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(itemsize == 1 ? launch_mode<1>(mode, src, dst, rows, H, IB, bpp, group_bytes, s)
                             : launch_mode<2>(mode, src, dst, rows, H, IB, bpp, group_bytes, s));
}

// rows = B*H scanlines of WS samples each (WS = W*S); itemsize 1 or 2;
// mode 0..4 = none/sub/up/average/paeth. Launches on `stream`; returns
// cudaGetLastError() (or cudaErrorInvalidValue for bad arguments).
extern "C" int ompb_filter(const void* in, void* out, int rows, int H, int WS, int S,
                           int itemsize, int mode, void* stream) {
  return ompb_filter_tuned(in, out, rows, H, WS, S, itemsize, mode, kGroupOutBytes, stream);
}
