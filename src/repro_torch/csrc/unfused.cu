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
// That is what the rung is for, and these kernels are simple and right
// rather than fast.  The TPU kernels' prev/cur/next triple BlockSpec (each
// band read three times) and their pad to whole bands and lanes are TPU
// artifacts and are not carried over: a block reads its tile plus halo from
// device memory once, with the edge-replicate border done by clamped
// indices, and writes its tile once.
//
// Arithmetic, which the plain versions (kernels/unfused.py) repeat bit for
// bit: the blur widens to f32, runs the row pass (taps left to right), then
// the column pass (taps top to bottom), each product and sum rounded on its
// own (the row_pass / col_pass of stencil_ops.cuh, shared with the fused
// kernels), then rounds half to even (rintf, as jnp.round) and saturates to
// [0, 255].  Erosion is a min over 2r+1 rows, then over 2r+1 columns, on u8.
// The threshold compares the u8 value with `thresh` cast to u8 on the host
// (truncated toward zero, then wrapped modulo 256, as XLA casts it): it does
// not share the fused threshold stage's f32 compare.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stencil_ops.cuh"

namespace {

constexpr int kTileH = 16;  // output tile of a blur / erode block
constexpr int kTileW = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// One block per (kTileH x kTileW) output tile: the window (tile + halo h on
// every side) widened to f32, the row pass over all its rows, the column pass.
__global__ void seed_gaussian_blur_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                                          const float* __restrict__ taps, int h, int w, int k) {
  extern __shared__ float smem[];
  const int hk = k / 2;
  const int WH = kTileH + 2 * hk, WW = kTileW + 2 * hk;
  float* win = smem;            // WH x WW input window
  float* row = smem + WH * WW;  // WH x kTileW row-pass results
  float* kx = row + WH * kTileW;
  const int ty0 = blockIdx.y * kTileH, tx0 = blockIdx.x * kTileW;
  for (int e = threadIdx.x; e < k; e += blockDim.x) kx[e] = taps[e];
  for (int e = threadIdx.x; e < WH * WW; e += blockDim.x) {
    const int i = e / WW, j = e - i * WW;
    const int y = clampi(ty0 - hk + i, 0, h - 1), x = clampi(tx0 - hk + j, 0, w - 1);
    win[e] = float(in[size_t(y) * w + x]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < WH * kTileW; e += blockDim.x) {
    const int i = e / kTileW, j = e - i * kTileW;
    row[e] = stencil::row_pass(stencil::kSep, win + i * WW + j, kx, k);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTileH * kTileW; e += blockDim.x) {
    const int i = e / kTileW, j = e - i * kTileW;
    const int y = ty0 + i, x = tx0 + j;
    if (y < h && x < w) {
      const float v = stencil::col_pass(stencil::kSep, row + i * kTileW + j, kTileW, kx, k, 0.0f);
      out[size_t(y) * w + x] = uint8_t(stencil::pack(v, true));
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
extern "C" int seed_gaussian_blur_launch(const void* in, void* out, const void* taps, int h, int w,
                                         int k, void* stream) {
  if (h == 0 || w == 0) return 0;
  const int hk = k / 2;
  const size_t smem = sizeof(float) * (size_t(kTileH + 2 * hk) * (kTileW + 2 * hk) +
                                       size_t(kTileH + 2 * hk) * kTileW + k);
  cudaError_t err = cudaFuncSetAttribute(seed_gaussian_blur_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  seed_gaussian_blur_kernel<<<tile_grid(h, w), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), static_cast<const float*>(taps),
      h, w, k);
  return int(cudaGetLastError());
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
