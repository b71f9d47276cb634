// stencil_chain: a whole Stage chain over (N, H, W) f32 planes in one launch.
//
// Replaces src/repro/kernels/stencil/exec_window.py `window_kernel` (with
// `window_pass`, the stage bodies and `launch`), and covers what
// exec_streaming.py `streaming_kernel` computes (the same bands).
//
// Bound on an H100: at the BoW path's 32x32 planes the chain is bound by
// bytes.  Each input pixel is read once and each output band written once
// (the octave chain at B=1024: 4 MB in, 28 MB out); its arithmetic (a few
// hundred FLOP per output pixel) is far below the card's fp32 rate.  What
// the kernel must avoid is moving intermediate bands through device memory,
// and for 32x32 planes under a 34-pixel halo, re-reading a padded copy.
//
// Design: one block per (plane, output tile).  The block loads its window
// (tile + 2x the accumulated halo) into dynamic shared memory with
// replicate-clamped reads, the only place a coordinate is clamped, so the
// chain runs on the extended domain exactly as `chain_ref` does: the input
// is edge-padded once and every stage is a valid-mode op.  The stages then
// run in shared memory, ping-ponging between slots that share the window's
// coordinate frame, so cropping a pass-through band costs nothing.  Each
// band is written to device memory once, as soon as it is final.  The
// host-side planner (exec_window.py) turns the chain into a step table held
// in device memory and copied into shared memory by each block.  (Passing
// the table by value as a __grid_constant__ parameter, with its taps read
// from the parameter space or copied to shared memory, measured 6-22%
// slower per call on the H100: PERF.md.)
//
// Arithmetic: every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn; no FMA contraction), in tap order, as the plain PyTorch
// version computes it.  sqrt is the correctly rounded __fsqrt_rn.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSteps = 32;
constexpr int kMaxWeights = 512;

enum Op : int { kSep = 0, kErode = 1, kGrad = 2, kStore = 3 };

struct Step {
  int op;              // Op
  int src, dst, tmp;   // shared-memory slots
  int kh, kw;          // column and row extents of the stencil (halo = k / 2)
  int wx, wy;          // offsets of the row and column taps in weights[]
  int rh, rw;          // halo the source band still carries before the step
  int store;           // output band written from dst after the step, or -1
  int pad;
};

struct ChainProgram {
  int n_steps;
  int pad[3];
  Step steps[kMaxSteps];
  float weights[kMaxWeights];
};

__global__ void stencil_chain_kernel(const float* __restrict__ in, float* __restrict__ out,
                                     const ChainProgram* __restrict__ prog, int n, int h, int w,
                                     int tile_h, int tile_w, int ph, int pw, int tiles_x,
                                     int tiles_y) {
  __shared__ ChainProgram sp;
  extern __shared__ float smem[];

  {
    const int* from = reinterpret_cast<const int*>(prog);
    int* to = reinterpret_cast<int*>(&sp);
    for (int e = threadIdx.x; e < int(sizeof(ChainProgram) / sizeof(int)); e += blockDim.x)
      to[e] = from[e];
  }

  const int WH = tile_h + 2 * ph;
  const int WW = tile_w + 2 * pw;
  const int slot_size = WH * WW;
  const int tiles = tiles_x * tiles_y;
  const int plane = blockIdx.x / tiles;
  const int t = blockIdx.x - plane * tiles;
  const int ty0 = (t / tiles_x) * tile_h;
  const int tx0 = (t % tiles_x) * tile_w;
  const size_t plane_size = size_t(h) * w;
  const float* src_plane = in + plane * plane_size;

  // slot 0 <- the input window, edge-padded by clamping the read coordinate
  for (int e = threadIdx.x; e < slot_size; e += blockDim.x) {
    const int i = e / WW, j = e - (e / WW) * WW;
    const int y = min(max(ty0 - ph + i, 0), h - 1);
    const int x = min(max(tx0 - pw + j, 0), w - 1);
    smem[e] = src_plane[size_t(y) * w + x];
  }
  __syncthreads();

  for (int si = 0; si < sp.n_steps; ++si) {
    const Step s = sp.steps[si];
    const float* src = smem + s.src * slot_size;
    float* dst = smem + s.dst * slot_size;
    float* tmp = smem + s.tmp * slot_size;
    // the source band is valid on window rows [r0, r1) and columns [c0, c1)
    const int r0 = ph - s.rh, r1 = ph + tile_h + s.rh;
    const int c0 = pw - s.rw, c1 = pw + tile_w + s.rw;
    const int hy = s.kh / 2, hx = s.kw / 2;

    if (s.op == kSep || s.op == kErode) {
      // row pass over every valid row -> tmp
      const float* kx = sp.weights + s.wx;
      const int rows = r1 - r0, cols = c1 - c0 - 2 * hx;
      for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
        const int i = r0 + e / cols, j = c0 + hx + e % cols;
        const float* x = src + i * WW + j - hx;
        float acc;
        if (s.op == kSep) {
          acc = __fmul_rn(kx[0], x[0]);
          for (int q = 1; q < s.kw; ++q) acc = __fadd_rn(acc, __fmul_rn(kx[q], x[q]));
        } else {
          acc = x[0];
          for (int q = 1; q < s.kw; ++q) acc = fminf(acc, x[q]);
        }
        tmp[i * WW + j] = acc;
      }
      __syncthreads();
      // column pass -> dst
      const float* ky = sp.weights + s.wy;
      const int orows = rows - 2 * hy;
      for (int e = threadIdx.x; e < orows * cols; e += blockDim.x) {
        const int i = r0 + hy + e / cols, j = c0 + hx + e % cols;
        const float* x = tmp + (i - hy) * WW + j;
        float acc;
        if (s.op == kSep) {
          acc = __fmul_rn(ky[0], x[0]);
          for (int q = 1; q < s.kh; ++q) acc = __fadd_rn(acc, __fmul_rn(ky[q], x[q * WW]));
        } else {
          acc = x[0];
          for (int q = 1; q < s.kh; ++q) acc = fminf(acc, x[q * WW]);
        }
        dst[i * WW + j] = acc;
      }
    } else if (s.op == kGrad) {
      // central differences: sqrt(dx^2 + dy^2), halo 1
      const int rows = r1 - r0 - 2, cols = c1 - c0 - 2;
      for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
        const int i = r0 + 1 + e / cols, j = c0 + 1 + e % cols;
        const float dy = __fmul_rn(__fsub_rn(src[(i + 1) * WW + j], src[(i - 1) * WW + j]), 0.5f);
        const float dx = __fmul_rn(__fsub_rn(src[i * WW + j + 1], src[i * WW + j - 1]), 0.5f);
        dst[i * WW + j] = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
      }
    }
    __syncthreads();

    if (s.store >= 0) {
      // the band is final: write the tile's interior, clipped to the plane
      float* ob = out + (size_t(s.store) * n + plane) * plane_size;
      for (int e = threadIdx.x; e < tile_h * tile_w; e += blockDim.x) {
        const int i = e / tile_w, j = e % tile_w;
        const int y = ty0 + i, x = tx0 + j;
        if (y < h && x < w) ob[size_t(y) * w + x] = dst[(ph + i) * WW + pw + j];
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int stencil_chain_program_bytes() { return int(sizeof(ChainProgram)); }

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
extern "C" int stencil_chain_launch(const float* in, float* out, const void* prog, int n, int h,
                                    int w, int tile_h, int tile_w, int ph, int pw, int n_slots,
                                    int threads, void* stream) {
  const int tiles_x = (w + tile_w - 1) / tile_w;
  const int tiles_y = (h + tile_h - 1) / tile_h;
  const size_t smem = size_t(n_slots) * (tile_h + 2 * ph) * (tile_w + 2 * pw) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stencil_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const long long blocks = (long long)n * tiles_x * tiles_y;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  stencil_chain_kernel<<<unsigned(blocks), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      in, out, static_cast<const ChainProgram*>(prog), n, h, w, tile_h, tile_w, ph, pw, tiles_x,
      tiles_y);
  return int(cudaGetLastError());
}
