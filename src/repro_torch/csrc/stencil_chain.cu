// stencil_chain: a whole Stage chain over (N, H, W) u8 or f32 planes in one
// launch, by overlapping windows.
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
// Arithmetic: the stage bodies of stencil_ops.cuh, shared with
// stencil_stream.cu (every product and sum rounded on its own, in tap order,
// as the plain PyTorch version computes it; u8 packed after every stage).
// The window is held in f32 whatever the carrier; a u8 layout is queued.
//
// A pyrDown (the octave's next-base tap, or a lone map pyrDown) runs only as
// the chain's last stage.  Tiles are even and the window's pad is aligned to
// the stride, so the block computes the row pass at the tile's image-even
// columns, the column pass at its image-even rows, and stores the result
// straight to the half-resolution output (`out_half`, (ceil(H/2), ceil(W/2))
// a plane): a quarter of the column work of the full-resolution stage.

#include "stencil_ops.cuh"

namespace {

using namespace stencil;

constexpr int kMaxSteps = 32;
constexpr int kMaxWeights = 512;

struct Step {
  int op;              // stencil::Op
  int src, dst, tmp;   // shared-memory slots
  int kh, kw;          // column and row extents of the stencil (halo = k / 2)
  int wx, wy;          // offsets of the row / column taps (or scalars) in weights[]
  int rh, rw;          // halo the source band still carries before the step
  int store;           // output band written from dst after the step, or -1
  int down;            // 2: a pyrDown, stored to out_half[store] by the step itself
};

struct ChainProgram {
  int n_steps;
  int pad[3];
  Step steps[kMaxSteps];
  float weights[kMaxWeights];
};

template <typename T>
__global__ void stencil_chain_kernel(const T* __restrict__ in, T* __restrict__ out,
                                     T* __restrict__ out_half,
                                     const ChainProgram* __restrict__ prog, int n, int h, int w,
                                     int tile_h, int tile_w, int ph, int pw, int tiles_x,
                                     int tiles_y) {
  __shared__ ChainProgram sp;
  extern __shared__ float smem[];
  constexpr bool u8 = sizeof(T) == 1;

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
  const T* src_plane = in + plane * plane_size;

  // slot 0 <- the input window, edge-padded by clamping the read coordinate
  for (int e = threadIdx.x; e < slot_size; e += blockDim.x) {
    const int i = e / WW, j = e - (e / WW) * WW;
    const int y = min(max(ty0 - ph + i, 0), h - 1);
    const int x = min(max(tx0 - pw + j, 0), w - 1);
    smem[e] = load_f32(src_plane + size_t(y) * w + x);
  }
  __syncthreads();

  for (int si = 0; si < sp.n_steps; ++si) {
    const Step s = sp.steps[si];
    const float* src = smem + s.src * slot_size;
    float* dst = smem + s.dst * slot_size;
    float* tmp = smem + s.tmp * slot_size;
    const LinRows rows{src, WW};
    // the source band is valid on window rows [r0, r1) and columns [c0, c1)
    const int r0 = ph - s.rh, r1 = ph + tile_h + s.rh;
    const int c0 = pw - s.rw, c1 = pw + tile_w + s.rw;
    const int hy = s.kh / 2, hx = s.kw / 2;
    const float* wts = sp.weights + s.wx;

    if (s.down > 1) {
      // pyrDown, the chain's last stage: the row pass at the tile's
      // image-even columns -> tmp, then the column pass at its image-even
      // rows, stored straight to the half-resolution band
      const int oy = ty0 - ph, ox = tx0 - pw;  // image coordinate of window (0, 0)
      const int i0 = first_even(r0 + hy, oy), j0 = first_even(c0 + hx, ox);
      const int orows = (r1 - hy - i0 + 1) / 2, ocols = (c1 - hx - j0 + 1) / 2;
      const int nr = r1 - r0;
      for (int e = threadIdx.x; e < nr * ocols; e += blockDim.x) {
        const int i = r0 + e / ocols, j = j0 + 2 * (e % ocols);
        tmp[i * WW + j] = row_pass(s.op, src + i * WW + j - hx, wts, s.kw);
      }
      __syncthreads();
      const int hh = (h + 1) / 2, hw = (w + 1) / 2;
      T* ob = out_half + (size_t(s.store) * n + plane) * (size_t(hh) * hw);
      for (int e = threadIdx.x; e < orows * ocols; e += blockDim.x) {
        const int i = i0 + 2 * (e / ocols), j = j0 + 2 * (e % ocols);
        const int y = (oy + i) / 2, x = (ox + j) / 2;
        if (y < hh && x < hw) {
          const float v = col_pass(s.op, tmp + (i - hy) * WW + j, WW, sp.weights + s.wy, s.kh, wts[0]);
          store_val(ob + size_t(y) * hw + x, pack(v, u8));
        }
      }
    } else if (separable(s.op)) {
      // row pass over every valid row -> tmp
      const int nr = r1 - r0, cols = c1 - c0 - 2 * hx;
      for (int e = threadIdx.x; e < nr * cols; e += blockDim.x) {
        const int i = r0 + e / cols, j = c0 + hx + e % cols;
        tmp[i * WW + j] = row_pass(s.op, src + i * WW + j - hx, wts, s.kw);
      }
      __syncthreads();
      // column pass -> dst
      const int orows = nr - 2 * hy;
      for (int e = threadIdx.x; e < orows * cols; e += blockDim.x) {
        const int i = r0 + hy + e / cols, j = c0 + hx + e % cols;
        const float v = col_pass(s.op, tmp + (i - hy) * WW + j, WW, sp.weights + s.wy, s.kh, wts[0]);
        dst[i * WW + j] = pack(v, u8);
      }
    } else if (s.op == kFilter2d || s.op == kGrad) {
      const int orows = r1 - r0 - 2 * hy, cols = c1 - c0 - 2 * hx;
      for (int e = threadIdx.x; e < orows * cols; e += blockDim.x) {
        const int i = r0 + hy + e / cols, j = c0 + hx + e % cols;
        const float v = s.op == kGrad ? grad_at(rows, i, j)
                                      : filter2d_at(rows, i - hy, j - hx, wts, s.kh, s.kw);
        dst[i * WW + j] = pack(v, u8);
      }
    } else if (s.op == kThreshold || s.op == kAffine) {
      const int nr = r1 - r0, cols = c1 - c0;
      for (int e = threadIdx.x; e < nr * cols; e += blockDim.x) {
        const int i = r0 + e / cols, j = c0 + e % cols;
        dst[i * WW + j] = pack(pointwise(s.op, src[i * WW + j], wts), u8);
      }
    }
    __syncthreads();

    if (s.store >= 0 && s.down <= 1) {
      // the band is final: write the tile's interior, clipped to the plane
      T* ob = out + (size_t(s.store) * n + plane) * plane_size;
      for (int e = threadIdx.x; e < tile_h * tile_w; e += blockDim.x) {
        const int i = e / tile_w, j = e % tile_w;
        const int y = ty0 + i, x = tx0 + j;
        if (y < h && x < w) store_val(ob + size_t(y) * w + x, dst[(ph + i) * WW + pw + j]);
      }
      __syncthreads();
    }
  }
}

template <typename T>
int launch(const void* in, void* out, void* out_half, const void* prog, int n, int h, int w,
           int tile_h, int tile_w, int ph, int pw, int n_slots, int threads, cudaStream_t stream) {
  const int tiles_x = (w + tile_w - 1) / tile_w;
  const int tiles_y = (h + tile_h - 1) / tile_h;
  const size_t smem = size_t(n_slots) * (tile_h + 2 * ph) * (tile_w + 2 * pw) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(stencil_chain_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const long long blocks = (long long)n * tiles_x * tiles_y;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  stencil_chain_kernel<T><<<unsigned(blocks), threads, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), static_cast<T*>(out_half),
      static_cast<const ChainProgram*>(prog), n, h, w, tile_h, tile_w, ph, pw, tiles_x, tiles_y);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int stencil_chain_program_bytes() { return int(sizeof(ChainProgram)); }

// Launch on `stream` for u8 (u8 != 0) or f32 planes; `out` holds the
// full-resolution bands, `out_half` the bands a pyrDown made.  Returns
// cudaGetLastError() after the launch (0 = ok).
extern "C" int stencil_chain_launch(const void* in, void* out, void* out_half, const void* prog,
                                    int n, int h, int w, int tile_h, int tile_w, int ph, int pw,
                                    int n_slots, int threads, int u8, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (u8)
    return launch<uint8_t>(in, out, out_half, prog, n, h, w, tile_h, tile_w, ph, pw, n_slots,
                           threads, st);
  return launch<float>(in, out, out_half, prog, n, h, w, tile_h, tile_w, ph, pw, n_slots, threads,
                       st);
}
