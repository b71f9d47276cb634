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
// A strided stage (pyrDown, resize2; the octave's next-base tap, or a lone
// map stage) runs only as the chain's last.  Tiles are even and the
// window's pad is aligned to the stride, so the block computes it at the
// tile's image-even rows and columns only (pyrDown: the row pass at the even
// columns, the column pass at the even rows) and stores the result straight
// to its decimated band: a quarter of the work of the full-resolution stage.
//
// Bands of two dtypes share a launch: a Sobel emits an f32 (dx, dy) pair on
// a u8 chain.  Every band has its own output buffer (`Bands`, by value) and
// every step its own pack flag; slots hold f32 whatever the band.  A Sobel
// step writes two slots, the pair reduction reads two.  The gathers (warp,
// remap) sample their source slot at absolute image coordinates: the
// window's origin (ty0 - ph, tx0 - pw) plus the window index, which is the
// JAX kernel's (row step, row offset, column origin) meta for this tile.
// Remap's map planes are read from device memory, so they cost no shared
// memory; an output coordinate outside the image clamps to the map's edge.

#include "stencil_ops.cuh"

namespace {

using namespace stencil;

constexpr int kMaxSteps = 32;
constexpr int kMaxWeights = 512;

struct Step {
  int op;              // stencil::Op
  int src, src2;       // shared-memory slots read (src2: the reduction's second band)
  int dst, dst2, tmp;  // slots written (dst2: a Sobel's dy) and the row-pass scratch
  int kh, kw;          // column and row extents of the stencil (halo = k / 2)
  int wx, wy;          // offsets of the row / column taps (or scalars) in weights[]
  int rh, rw;          // halo the source band still carries before the step
  int store, store2;   // output bands written from dst / dst2 after the step, or -1
  int down;            // 2: a strided stage, stored to band `store` by the step itself
  int pk;              // 1: pack the step's result to u8
};

struct ChainProgram {
  int n_steps;
  int pad[3];
  Step steps[kMaxSteps];
  float weights[kMaxWeights];
};

template <typename T>
__global__ void stencil_chain_kernel(const T* __restrict__ in, const Bands bd,
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
  const int oy = ty0 - ph, ox = tx0 - pw;  // image coordinate of window (0, 0)
  const T* src_plane = in + plane * (size_t(h) * w);

  // slot 0 <- the input window, edge-padded by clamping the read coordinate
  for (int e = threadIdx.x; e < slot_size; e += blockDim.x) {
    const int i = e / WW, j = e - (e / WW) * WW;
    const int y = min(max(oy + i, 0), h - 1);
    const int x = min(max(ox + j, 0), w - 1);
    smem[e] = load_f32(src_plane + size_t(y) * w + x);
  }
  __syncthreads();

  for (int si = 0; si < sp.n_steps; ++si) {
    const Step s = sp.steps[si];
    const float* src = smem + s.src * slot_size;
    const float* src2 = smem + s.src2 * slot_size;
    float* dst = smem + s.dst * slot_size;
    float* dst2 = smem + s.dst2 * slot_size;
    float* tmp = smem + s.tmp * slot_size;
    const LinRows rows{src, WW};
    // the source band is valid on window rows [r0, r1) and columns [c0, c1)
    const int r0 = ph - s.rh, r1 = ph + tile_h + s.rh;
    const int c0 = pw - s.rw, c1 = pw + tile_w + s.rw;
    const int hy = s.kh / 2, hx = s.kw / 2;
    const float* wts = sp.weights + s.wx;
    const int orows = r1 - r0 - 2 * hy, cols = c1 - c0 - 2 * hx;  // the step's output region

    if (s.op == kPyrDown) {
      // the chain's last stage: the row pass at the tile's image-even
      // columns -> tmp, then the column pass at its image-even rows, stored
      // straight to the decimated band
      const int i0 = first_even(r0 + hy, oy), j0 = first_even(c0 + hx, ox);
      const int erows = (r1 - hy - i0 + 1) / 2, ecols = (c1 - hx - j0 + 1) / 2;
      const int nr = r1 - r0;
      for (int e = threadIdx.x; e < nr * ecols; e += blockDim.x) {
        const int i = r0 + e / ecols, j = j0 + 2 * (e % ecols);
        tmp[i * WW + j] = row_pass(s.op, src + i * WW + j - hx, wts, s.kw);
      }
      __syncthreads();
      for (int e = threadIdx.x; e < erows * ecols; e += blockDim.x) {
        const int i = i0 + 2 * (e / ecols), j = j0 + 2 * (e % ecols);
        const int y = (oy + i) / 2, x = (ox + j) / 2;
        if (y < bd.h[s.store] && x < bd.w[s.store]) {
          const float v = col_pass(s.op, tmp + (i - hy) * WW + j, WW, sp.weights + s.wy, s.kh, wts[0]);
          store_band(bd, s.store, plane, y, x, pack(v, s.pk));
        }
      }
    } else if (s.op == kResize2) {
      // the chain's last stage: 2x2 means at the tile's image-even rows and
      // columns, stored straight to the decimated band (floor size)
      const int i0 = first_even(r0, oy), j0 = first_even(c0, ox);
      const int erows = (r1 - i0) / 2, ecols = (c1 - j0) / 2;
      for (int e = threadIdx.x; e < erows * ecols; e += blockDim.x) {
        const int i = i0 + 2 * (e / ecols), j = j0 + 2 * (e % ecols);
        const int y = (oy + i) / 2, x = (ox + j) / 2;
        if (y < bd.h[s.store] && x < bd.w[s.store])
          store_band(bd, s.store, plane, y, x, pack(resize2_at(rows, i, j), s.pk));
      }
    } else if (separable(s.op)) {
      // row pass over every valid row -> tmp
      const int nr = r1 - r0;
      for (int e = threadIdx.x; e < nr * cols; e += blockDim.x) {
        const int i = r0 + e / cols, j = c0 + hx + e % cols;
        tmp[i * WW + j] = row_pass(s.op, src + i * WW + j - hx, wts, s.kw);
      }
      __syncthreads();
      // column pass -> dst
      for (int e = threadIdx.x; e < orows * cols; e += blockDim.x) {
        const int i = r0 + hy + e / cols, j = c0 + hx + e % cols;
        const float v = col_pass(s.op, tmp + (i - hy) * WW + j, WW, sp.weights + s.wy, s.kh, wts[0]);
        dst[i * WW + j] = pack(v, s.pk);
      }
    } else if (s.op == kSobel) {
      for (int e = threadIdx.x; e < orows * cols; e += blockDim.x) {
        const int i = r0 + 1 + e / cols, j = c0 + 1 + e % cols;
        float dx, dy;
        sobel_at(rows, i, j, dx, dy);
        dst[i * WW + j] = dx;
        dst2[i * WW + j] = dy;
      }
    } else if (s.op == kWarp || s.op == kRemap) {
      const float* mx = bd.maps[2 * s.wx];
      const float* my = bd.maps[2 * s.wx + 1];
      for (int e = threadIdx.x; e < orows * cols; e += blockDim.x) {
        const int i = r0 + hy + e / cols, j = c0 + hx + e % cols;
        float sy, sx;
        if (s.op == kWarp)
          warp_coords(wts, oy + i, ox + j, sy, sx);
        else
          remap_coords(mx, my, h, w, oy + i, ox + j, sy, sx);
        dst[i * WW + j] = pack(bilinear_at(rows, sy, sx, oy, ox, r0, r1, c0, c1), s.pk);
      }
    } else if (s.op == kFilter2d || s.op == kGrad) {
      for (int e = threadIdx.x; e < orows * cols; e += blockDim.x) {
        const int i = r0 + hy + e / cols, j = c0 + hx + e % cols;
        const float v = s.op == kGrad ? grad_at(rows, i, j)
                                      : filter2d_at(rows, i - hy, j - hx, wts, s.kh, s.kw);
        dst[i * WW + j] = pack(v, s.pk);
      }
    } else if (s.op == kGradPair) {
      for (int e = threadIdx.x; e < orows * cols; e += blockDim.x) {
        const int k = (r0 + e / cols) * WW + c0 + e % cols;
        dst[k] = pack(grad_pair(src[k], src2[k]), s.pk);
      }
    } else if (s.op == kThreshold || s.op == kAffine) {
      for (int e = threadIdx.x; e < orows * cols; e += blockDim.x) {
        const int k = (r0 + e / cols) * WW + c0 + e % cols;
        dst[k] = pack(pointwise(s.op, src[k], wts), s.pk);
      }
    }
    __syncthreads();

    if (s.down <= 1 && (s.store >= 0 || s.store2 >= 0)) {
      // final bands: write the tile's interior, clipped to the plane
      for (int e = threadIdx.x; e < tile_h * tile_w; e += blockDim.x) {
        const int i = e / tile_w, j = e % tile_w;
        const int y = ty0 + i, x = tx0 + j;
        if (y < h && x < w) {
          const int k = (ph + i) * WW + pw + j;
          if (s.store >= 0) store_band(bd, s.store, plane, y, x, dst[k]);
          if (s.store2 >= 0) store_band(bd, s.store2, plane, y, x, dst2[k]);
        }
      }
      __syncthreads();
    }
  }
}

template <typename T>
int launch(const void* in, const Bands& bd, const void* prog, int n, int h, int w, int tile_h,
           int tile_w, int ph, int pw, int n_slots, int threads, cudaStream_t stream) {
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
      static_cast<const T*>(in), bd, static_cast<const ChainProgram*>(prog), n, h, w, tile_h,
      tile_w, ph, pw, tiles_x, tiles_y);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int stencil_chain_program_bytes() { return int(sizeof(ChainProgram)); }

extern "C" int stencil_bands_bytes() { return int(sizeof(Bands)); }

// Launch on `stream` for u8 (u8 != 0) or f32 planes; `bands` (host memory)
// names every output band's buffer and the remap stages' map planes.
// Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int stencil_chain_launch(const void* in, const void* bands, const void* prog, int n,
                                    int h, int w, int tile_h, int tile_w, int ph, int pw,
                                    int n_slots, int threads, int u8, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const Bands& bd = *static_cast<const Bands*>(bands);
  if (u8)
    return launch<uint8_t>(in, bd, prog, n, h, w, tile_h, tile_w, ph, pw, n_slots, threads, st);
  return launch<float>(in, bd, prog, n, h, w, tile_h, tile_w, ph, pw, n_slots, threads, st);
}
