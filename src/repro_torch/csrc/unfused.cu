// unfused.cu: the seed (pre-fusion) kernels, one launch per op per plane.
//
// Replaces benchmarks/unfused_baseline.py `_sep_kernel` (seed_gaussian_blur),
// `_morph_kernel` (seed_erode) and `_thresh_kernel` (seed_threshold), the
// per-op Pallas kernels the fused stencil engine replaced.  They are the
// baseline rung of the fused-vs-staged pipeline benchmark: what one plane,
// one op and one launch at a time costs, every intermediate in device memory.
//
// Bound on an H100: bytes, by far.  Each kernel reads its (H, W) u8 plane
// once and writes it once: 0.52 MB for 512x512, 0.16 us at 3.35 TB/s, below
// a launch's latency, so the seed rung measures launches and per-op traffic.
// The TPU kernels' prev/cur/next triple BlockSpec (each band read three
// times) and their pad to whole bands and lanes are TPU artifacts and are
// not carried over: a block reads its tile plus halo from device memory
// once, with the edge-replicate border done by clamped indices, and writes
// its tile once.
//
// seed_gaussian_blur is latency-bound (a launch, one load round trip, two
// passes), so its design cuts the steps a block takes.  One block of 256
// threads per 16 x 128 output tile (a 512x512 plane is 128 blocks: one
// wave on 132 SMs).  The window (the tile's rows +- k/2, clamped, by 160
// columns: the tile's 128 and one 16-byte segment either side) is copied
// as 16-byte loads where a segment lies inside the plane and the rows are
// 16-byte aligned, else byte by byte with clamped columns (edge segments,
// or rows of a width not a multiple of 16): no division per element.  The
// row pass runs in register strips (a thread converts the k + 3 window
// values of 4 adjacent outputs once and computes the 4), stored to shared
// memory as f32; one barrier; the column pass reads 4 adjacent columns a
// tap as one 16-byte load, and stores the 4 bytes as one word where
// aligned.  The kernel is compiled once per odd k (1..31), so every loop is
// unrolled and the taps, passed by value, are constant-bank operands.
//
// Arithmetic, which the plain versions (kernels/unfused.py) repeat bit for
// bit: the blur widens to f32, runs the row pass (taps left to right), then
// the column pass (taps top to bottom), each product and sum rounded on its
// own (the order of stencil_ops.cuh's row_pass / col_pass, shared with the
// fused kernels), then rounds half to even (rintf, as jnp.round) and
// saturates to [0, 255].  Erosion is a min over 2r+1 rows, then over 2r+1
// columns, on u8.  The threshold compares the u8 value with `thresh` cast
// to u8 on the host (truncated toward zero, then wrapped modulo 256, as XLA
// casts it): it does not share the fused threshold stage's f32 compare.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stencil_ops.cuh"

namespace {

constexpr int kTileH = 16;  // output tile of an erode block
constexpr int kTileW = 64;
constexpr int kThreads = 256;
// seed_gaussian_blur's block (kernels/unfused.py BLUR_ROWS, BLUR_COLS,
// BLUR_PAD, BLUR_THREADS): output rows and columns of a tile, window columns
// either side of it (one 16-byte segment, >= the largest halo 15), threads
constexpr int kBlurRows = 16;
constexpr int kBlurCols = 128;
constexpr int kBlurPad = 16;
constexpr int kBlurThreads = 256;
constexpr int kBlurWinW = kBlurCols + 2 * kBlurPad;  // bytes of a window row
constexpr int kBlurSegs = kBlurWinW / 16;           // 16-byte segments of a window row
constexpr int kBlurStrips = kBlurCols / 4;          // 4-output strips of a tile row

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

struct Taps {
  float v[32];  // the 1-D Gaussian, taps 0 .. k - 1
};

template <int K>
__global__ void __launch_bounds__(kBlurThreads)
    seed_gaussian_blur_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                              const Taps taps, int h, int w) {
  constexpr int HK = K / 2, WH = kBlurRows + 2 * HK;
  __shared__ __align__(16) uint8_t win[WH * kBlurWinW];  // window byte (i, x0 - kBlurPad + j)
  __shared__ __align__(16) float row[WH * kBlurCols];    // row pass at (i, x0 + j)
  const int y0 = blockIdx.y * kBlurRows, x0 = blockIdx.x * kBlurCols;
  const bool vec = (w & 15) == 0 && (reinterpret_cast<uintptr_t>(in) & 15) == 0;
  for (int e = threadIdx.x; e < WH * kBlurSegs; e += kBlurThreads) {
    const int i = e / kBlurSegs, sg = e - i * kBlurSegs;
    const uint8_t* src = in + size_t(clampi(y0 - HK + i, 0, h - 1)) * w;
    const int gx = x0 - kBlurPad + 16 * sg;
    uint8_t* dst = win + i * kBlurWinW + 16 * sg;
    if (vec && gx >= 0 && gx + 16 <= w) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src + gx);
    } else {
#pragma unroll
      for (int q = 0; q < 16; ++q) dst[q] = src[clampi(gx + q, 0, w - 1)];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < WH * kBlurStrips; e += kBlurThreads) {
    const int i = e / kBlurStrips, c = 4 * (e % kBlurStrips);
    const uint8_t* x = win + i * kBlurWinW + kBlurPad - HK + c;
    float v[K + 3];
#pragma unroll
    for (int q = 0; q < K + 3; ++q) v[q] = float(x[q]);
    float acc[4];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      acc[o] = __fmul_rn(taps.v[0], v[o]);
#pragma unroll
      for (int q = 1; q < K; ++q) acc[o] = __fadd_rn(acc[o], __fmul_rn(taps.v[q], v[o + q]));
    }
    *reinterpret_cast<float4*>(row + i * kBlurCols + c) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
  __syncthreads();
  const bool vec_out = (w & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  for (int e = threadIdx.x; e < kBlurRows * kBlurStrips; e += kBlurThreads) {
    const int i = e / kBlurStrips, c = 4 * (e % kBlurStrips);
    const int y = y0 + i, x = x0 + c;
    if (y >= h || x >= w) continue;
    const float* r = row + i * kBlurCols + c;
    float4 a = *reinterpret_cast<const float4*>(r);
    float acc[4] = {__fmul_rn(taps.v[0], a.x), __fmul_rn(taps.v[0], a.y),
                    __fmul_rn(taps.v[0], a.z), __fmul_rn(taps.v[0], a.w)};
#pragma unroll
    for (int q = 1; q < K; ++q) {
      a = *reinterpret_cast<const float4*>(r + q * kBlurCols);
      acc[0] = __fadd_rn(acc[0], __fmul_rn(taps.v[q], a.x));
      acc[1] = __fadd_rn(acc[1], __fmul_rn(taps.v[q], a.y));
      acc[2] = __fadd_rn(acc[2], __fmul_rn(taps.v[q], a.z));
      acc[3] = __fadd_rn(acc[3], __fmul_rn(taps.v[q], a.w));
    }
    uint8_t b[4];
#pragma unroll
    for (int o = 0; o < 4; ++o) b[o] = uint8_t(stencil::pack(acc[o], true));
    uint8_t* dst = out + size_t(y) * w + x;
    if (vec_out && x + 4 <= w) {
      *reinterpret_cast<uchar4*>(dst) = make_uchar4(b[0], b[1], b[2], b[3]);
    } else {
      for (int o = 0; o < 4 && x + o < w; ++o) dst[o] = b[o];
    }
  }
}

// One block per output tile: the u8 window (tile + r on every side), the
// min over 2r+1 rows at every window column, then over 2r+1 columns.
__global__ void seed_erode_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int h,
                                  int w, int r) {
  extern __shared__ uint8_t bytes[];
  const int WH = kTileH + 2 * r, WW = kTileW + 2 * r;
  uint8_t* win = bytes;           // WH x WW input window
  uint8_t* col = bytes + WH * WW;  // kTileH x WW row-direction minima
  const int ty0 = blockIdx.y * kTileH, tx0 = blockIdx.x * kTileW;
  for (int e = threadIdx.x; e < WH * WW; e += blockDim.x) {
    const int i = e / WW, j = e - i * WW;
    const int y = clampi(ty0 - r + i, 0, h - 1), x = clampi(tx0 - r + j, 0, w - 1);
    win[e] = in[size_t(y) * w + x];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTileH * WW; e += blockDim.x) {
    const int i = e / WW, j = e - i * WW;
    uint8_t m = win[i * WW + j];
    for (int q = 1; q <= 2 * r; ++q) {
      const uint8_t v = win[(i + q) * WW + j];
      m = v < m ? v : m;
    }
    col[e] = m;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTileH * kTileW; e += blockDim.x) {
    const int i = e / kTileW, j = e - i * kTileW;
    const int y = ty0 + i, x = tx0 + j;
    if (y < h && x < w) {
      const uint8_t* c = col + i * WW + j;
      uint8_t m = c[0];
      for (int q = 1; q <= 2 * r; ++q) m = c[q] < m ? c[q] : m;
      out[size_t(y) * w + x] = m;
    }
  }
}

// THRESH_BINARY on u8 with the threshold already cast to u8: elementwise.
__global__ void seed_threshold_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                                      long long n, int t8, int maxval8) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n; e += stride)
    out[e] = int(in[e]) > t8 ? uint8_t(maxval8) : uint8_t(0);
}

dim3 tile_grid(int h, int w) { return dim3((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH); }

}  // namespace

// Each launcher runs on `stream` over one (h, w) u8 plane and returns
// cudaGetLastError() after the launch (0 = ok).
template <int K>
int launch_blur(const void* in, void* out, const Taps& taps, int h, int w, cudaStream_t stream) {
  const dim3 grid((w + kBlurCols - 1) / kBlurCols, (h + kBlurRows - 1) / kBlurRows);
  seed_gaussian_blur_kernel<K><<<grid, kBlurThreads, 0, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), taps, h, w);
  return int(cudaGetLastError());
}

// taps: k floats in host memory, passed to the kernel by value.
extern "C" int seed_gaussian_blur_launch(const void* in, void* out, const float* taps, int h, int w,
                                         int k, void* stream) {
  if (h == 0 || w == 0) return 0;
  Taps t = {};
  for (int q = 0; q < k && q < 32; ++q) t.v[q] = taps[q];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch_blur<1>(in, out, t, h, w, st);
    case 3: return launch_blur<3>(in, out, t, h, w, st);
    case 5: return launch_blur<5>(in, out, t, h, w, st);
    case 7: return launch_blur<7>(in, out, t, h, w, st);
    case 9: return launch_blur<9>(in, out, t, h, w, st);
    case 11: return launch_blur<11>(in, out, t, h, w, st);
    case 13: return launch_blur<13>(in, out, t, h, w, st);
    case 15: return launch_blur<15>(in, out, t, h, w, st);
    case 17: return launch_blur<17>(in, out, t, h, w, st);
    case 19: return launch_blur<19>(in, out, t, h, w, st);
    case 21: return launch_blur<21>(in, out, t, h, w, st);
    case 23: return launch_blur<23>(in, out, t, h, w, st);
    case 25: return launch_blur<25>(in, out, t, h, w, st);
    case 27: return launch_blur<27>(in, out, t, h, w, st);
    case 29: return launch_blur<29>(in, out, t, h, w, st);
    case 31: return launch_blur<31>(in, out, t, h, w, st);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" int seed_erode_launch(const void* in, void* out, int h, int w, int r, void* stream) {
  if (h == 0 || w == 0) return 0;
  const size_t smem = size_t(kTileH + 2 * r) * (kTileW + 2 * r) + size_t(kTileH) * (kTileW + 2 * r);
  cudaError_t err = cudaFuncSetAttribute(seed_erode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  seed_erode_kernel<<<tile_grid(h, w), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), h, w, r);
  return int(cudaGetLastError());
}

extern "C" int seed_threshold_launch(const void* in, void* out, int h, int w, int t8, int maxval8,
                                     void* stream) {
  const long long n = (long long)h * w;
  if (n == 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  seed_threshold_kernel<<<unsigned(blocks < 4096 ? blocks : 4096), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), n, t8, maxval8);
  return int(cudaGetLastError());
}
