// Fused byteswap + PNG scanline filter for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in omero_ms_pixel_buffer_tpu/ops/pallas/filter.py
// (_filter_tiles, bodies _kernel_u16 / _kernel_u8). Contract: for native
// 8- or 16-bit tiles (B, H, W[, S]) the output (B, H, 1 + W*S*itemsize) is
// exactly png.filter_batch(to_big_endian_bytes(tiles), S*itemsize, mode):
// column 0 of every row holds the filter code, the rest the big-endian
// residual bytes x - predictor(a, b, c) mod 256.
//
// What bounds it on the card: bytes. Each output byte needs at most four
// input bytes that neighbouring threads also read (left, above,
// above-left), so the work is a few integer operations per byte against
// one read of the input and one write of the output through device
// memory. The design is one thread per output byte: a warp covers 32
// consecutive output bytes of one row, so loads and stores coalesce, and
// the neighbour reads hit L1/L2. 16-bit samples are read once per byte
// plane (hi first, then lo), which is the big-endian order, so no
// separate byteswap pass or intermediate array exists. The TPU kernel's
// VMEM cap (filter.py supports()) does not apply: any shape is taken.
//
// Signed samples are filtered as their unsigned bits; Paeth runs in int32
// like _residual (filter.py:100-107); Average uses (a + b) >> 1 in int32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int ISZ, typename T>
__device__ __forceinline__ int byte_of(T v, int k) {
  if (ISZ == 1) return (int)v;
  return k == 0 ? (int)(v >> 8) : (int)(v & 0xFF);
}

template <int ISZ, typename T>
__global__ void filter_rows(const T* __restrict__ in, uint8_t* __restrict__ out,
                            int rows, int H, int WS, int S, int mode) {
  const int OB = 1 + WS * ISZ;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= OB) return;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    uint8_t* o = out + (size_t)row * OB;
    if (col == 0) {
      o[0] = (uint8_t)mode;
      continue;
    }
    const int j = col - 1;
    const int e = j / ISZ;
    const int k = j - e * ISZ;
    const T* r = in + (size_t)row * WS;
    const bool has_up = (row % H) != 0;
    const bool has_left = e >= S;
    const int x = byte_of<ISZ>(r[e], k);
    int a = 0, b = 0, c = 0;
    if (mode != 0 && mode != 2 && has_left) a = byte_of<ISZ>(r[e - S], k);
    if (mode >= 2 && has_up) b = byte_of<ISZ>(r[e - WS], k);
    if (mode == 4 && has_up && has_left) c = byte_of<ISZ>(r[e - WS - S], k);
    int pred;
    switch (mode) {
      case 0: pred = 0; break;
      case 1: pred = a; break;
      case 2: pred = b; break;
      case 3: pred = (a + b) >> 1; break;
      default: {
        const int p = a + b - c;
        const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
        pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
      }
    }
    o[col] = (uint8_t)((x - pred) & 0xFF);
  }
}

}  // namespace

// rows = B*H scanlines of WS samples each (WS = W*S); itemsize 1 or 2;
// mode 0..4 = none/sub/up/average/paeth. Launches on `stream`; returns
// cudaGetLastError() (or cudaErrorInvalidValue for bad arguments).
extern "C" int ompb_filter(const void* in, void* out, int rows, int H, int WS,
                           int S, int itemsize, int mode, void* stream) {
  if (rows < 0 || H <= 0 || WS < 0 || S <= 0 || mode < 0 || mode > 4 ||
      (itemsize != 1 && itemsize != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  const int threads = 256;
  const int OB = 1 + WS * itemsize;
  dim3 grid((OB + threads - 1) / threads, rows < 65535 ? rows : 65535);
  cudaStream_t s = (cudaStream_t)stream;
  if (itemsize == 1) {
    filter_rows<1><<<grid, threads, 0, s>>>((const uint8_t*)in, (uint8_t*)out,
                                            rows, H, WS, S, mode);
  } else {
    filter_rows<2><<<grid, threads, 0, s>>>((const uint16_t*)in, (uint8_t*)out,
                                            rows, H, WS, S, mode);
  }
  return (int)cudaGetLastError();
}
