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
// run in shared memory, ping-ponging between slots.  Each band is written to
// device memory once, as soon as it is final.  The host-side planner
// (exec_window.py) turns the chain into a step table held in device memory
// and copied into shared memory by each block.  (Passing the table by value
// as a __grid_constant__ parameter, with its taps read from the parameter
// space or copied to shared memory, measured 6-22% slower per call on the
// H100: PERF.md.)
//
// Frames: a chain walks one or more resolution levels (the input's, then one
// per strided or upsampling stage before the last).  Every slot of a level
// shares that level's frame: the block's tile at that resolution (the input
// tile halved through each stride, doubled through each upsample; tiles are
// multiples of the stride product, so each is whole and image-even above a
// stride) plus the level's pad, the most rows and columns any of its stages
// needs around the tile.  So cropping a pass-through band costs nothing.  A
// step reads its source in its source level's frame and writes its output
// in its output level's frame: a mid-chain stride writes the half-size frame
// from the image-even rows and columns of its source, a pyrUp the
// double-size frame, both phases interleaved, from the source row and
// column of each output's absolute image coordinate (floor of half), the
// phase its parity.  Slots are as large as the largest frame, or the
// row-pass scratch of a resolution change if that is larger.
//
// Arithmetic: the stage bodies of stencil_ops.cuh, shared with
// stencil_stream.cu (every product and sum rounded on its own, in tap order,
// as the plain PyTorch version computes it; u8 packed after every stage).
// The window is held in f32 whatever the carrier; a u8 layout is queued.
//
// A strided last stage (pyrDown, resize2; the octave's next-base tap, or a
// lone map stage) is cheaper: the block computes it at the tile's image-even
// rows and columns only (pyrDown: the row pass at the even columns, the
// column pass at the even rows) and stores the result straight to its
// decimated band: a quarter of the work of the full-resolution stage.
//
// Bands of two dtypes share a launch: a Sobel emits an f32 (dx, dy) pair on
// a u8 chain.  Every band has its own output buffer (`Bands`, by value) and
// every step its own pack flag; slots hold f32 whatever the band.  A Sobel
// step writes two slots, the pair reduction reads two.  The gathers (warp,
// remap) sample their source slot at absolute image coordinates: the
// frame's origin (the tile's origin at its level minus the level's pad) plus
// the frame index, which is the JAX kernel's (row step, row offset, column
// origin) meta for this tile.  Remap's map planes are read from device
// memory, so they cost no shared memory; an output coordinate outside the
// image clamps to the map's edge.

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
  int rh, rw;          // rows / columns around the tile the source band holds, at level ls
  int oh, ow;          // rows / columns around the tile the output covers, at level lo
  int ls, lo;          // levels of the source and of the output
  int store, store2;   // output bands written from dst / dst2 after the step, or -1
  int down;            // 2: a strided last stage, stored to band `store` by the step itself
  int pk;              // 1: pack the step's result to u8
};

struct ChainProgram {
  int n_steps, n_levels;
  int pad[2];
  Step steps[kMaxSteps];
  int pads[2 * kMaxLevels];  // per level: rows, columns of the frame's pad
  float weights[kMaxWeights];
};

// One level's frame for a block: the tile's origin at that resolution minus
// the pad is local (0, 0); WW columns a row.
struct Frame {
  int th, tw, py, px, WW, oy, ox;
};

__device__ __forceinline__ Frame frame_of(const ChainProgram& sp, const Bands& bd, int l, int ti,
                                          int tj) {
  Frame f;
  f.th = bd.th[l];
  f.tw = bd.tw[l];
  f.py = sp.pads[2 * l];
  f.px = sp.pads[2 * l + 1];
  f.WW = f.tw + 2 * f.px;
  f.oy = ti * f.th - f.py;
  f.ox = tj * f.tw - f.px;
  return f;
}

template <typename T>
__global__ void stencil_chain_kernel(const T* __restrict__ in, const Bands bd,
                                     const ChainProgram* __restrict__ prog, int n, int h, int w,
                                     int slot_size, int tiles_x, int tiles_y) {
  __shared__ ChainProgram sp;
  __shared__ Frame frames[kMaxLevels];  // each level's frame for this block's tile
  extern __shared__ float smem[];

  {
    const int* from = reinterpret_cast<const int*>(prog);
    int* to = reinterpret_cast<int*>(&sp);
    for (int e = threadIdx.x; e < int(sizeof(ChainProgram) / sizeof(int)); e += blockDim.x)
      to[e] = from[e];
  }
  __syncthreads();

  const int tiles = tiles_x * tiles_y;
  const int plane = blockIdx.x / tiles;
  const int t = blockIdx.x - plane * tiles;
  const int ti = t / tiles_x, tj = t % tiles_x;
  const T* src_plane = in + plane * (size_t(h) * w);
  if (threadIdx.x < sp.n_levels) frames[threadIdx.x] = frame_of(sp, bd, threadIdx.x, ti, tj);
  __syncthreads();

  // slot 0 <- the input window, edge-padded by clamping the read coordinate
  {
    const Frame& f = frames[0];
    const int WH = f.th + 2 * f.py;
    for (int e = threadIdx.x; e < WH * f.WW; e += blockDim.x) {
      const int i = e / f.WW, j = e - (e / f.WW) * f.WW;
      const int y = min(max(f.oy + i, 0), h - 1);
      const int x = min(max(f.ox + j, 0), w - 1);
      smem[e] = load_f32(src_plane + size_t(y) * w + x);
    }
  }
  __syncthreads();

  for (int si = 0; si < sp.n_steps; ++si) {
    const Step s = sp.steps[si];
    const Frame& fs = frames[s.ls];
    const Frame& fd = frames[s.lo];
    const int WW = fs.WW, oy = fs.oy, ox = fs.ox;
    const float* src = smem + s.src * slot_size;
    const float* src2 = smem + s.src2 * slot_size;
    float* dst = smem + s.dst * slot_size;
    float* dst2 = smem + s.dst2 * slot_size;
    float* tmp = smem + s.tmp * slot_size;
    const LinRows rows{src, WW};
    // the source band is valid on frame rows [r0, r1) and columns [c0, c1)
    const int r0 = fs.py - s.rh, r1 = fs.py + fs.th + s.rh;
    const int c0 = fs.px - s.rw, c1 = fs.px + fs.tw + s.rw;
    const int hy = s.kh / 2, hx = s.kw / 2;
    const float* wts = sp.weights + s.wx;
    const int orows = r1 - r0 - 2 * hy, cols = c1 - c0 - 2 * hx;  // the step's output region
    // a resolution change's output region, in the output level's frame
    const int i0 = fd.py - s.oh, i1 = fd.py + fd.th + s.oh;
    const int j0 = fd.px - s.ow, j1 = fd.px + fd.tw + s.ow;
    const int ni = i1 - i0, nj = j1 - j0;

    if (s.op == kPyrUp) {
      // row pass: each output row's phase over the source columns its
      // outputs read -> tmp (output rows at the source's width)
      const int x0 = floor2(fd.ox + j0) - 1 - ox, x1 = floor2(fd.ox + j1 - 1) + 2 - ox;
      const int nx = x1 - x0;
      for (int e = threadIdx.x; e < ni * nx; e += blockDim.x) {
        const int i = i0 + e / nx, x = x0 + e % nx;
        const int Y = fd.oy + i, q = floor2(Y) - oy;
        const float b = src[q * WW + x], c = src[(q + 1) * WW + x];
        tmp[i * WW + x] = (Y & 1) ? pyr_up_odd(b, c) : pyr_up_even(src[(q - 1) * WW + x], b, c);
      }
      __syncthreads();
      for (int e = threadIdx.x; e < ni * nj; e += blockDim.x) {
        const int i = i0 + e / nj, j = j0 + e % nj;
        const int X = fd.ox + j, q = floor2(X) - ox;
        const float* r = tmp + i * WW;
        const float v = (X & 1) ? pyr_up_odd(r[q], r[q + 1]) : pyr_up_even(r[q - 1], r[q], r[q + 1]);
        dst[i * fd.WW + j] = pack(v, s.pk);
      }
    } else if (s.op == kPyrDown && s.down == 1) {
      // a stride before the last stage: the row pass over the source rows
      // the output reads, at the image-even source columns of its columns
      // -> tmp (source rows at the output's width), then the column pass
      const int q0 = 2 * (fd.oy + i0) - hy - oy, q1 = 2 * (fd.oy + i1 - 1) + hy + 1 - oy;
      for (int e = threadIdx.x; e < (q1 - q0) * nj; e += blockDim.x) {
        const int q = q0 + e / nj, j = j0 + e % nj;
        const int x = 2 * (fd.ox + j) - ox;
        tmp[q * fd.WW + j] = row_pass(s.op, src + q * WW + x - hx, wts, s.kw);
      }
      __syncthreads();
      for (int e = threadIdx.x; e < ni * nj; e += blockDim.x) {
        const int i = i0 + e / nj, j = j0 + e % nj;
        const int q = 2 * (fd.oy + i) - oy;
        const float v = col_pass(s.op, tmp + (q - hy) * fd.WW + j, fd.WW, sp.weights + s.wy, s.kh,
                                 wts[0]);
        dst[i * fd.WW + j] = pack(v, s.pk);
      }
    } else if (s.op == kResize2 && s.down == 1) {
      for (int e = threadIdx.x; e < ni * nj; e += blockDim.x) {
        const int i = i0 + e / nj, j = j0 + e % nj;
        const float v = resize2_at(rows, 2 * (fd.oy + i) - oy, 2 * (fd.ox + j) - ox);
        dst[i * fd.WW + j] = pack(v, s.pk);
      }
    } else if (s.op == kPyrDown) {
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
          remap_coords(mx, my, bd.lh[s.ls], bd.lw[s.ls], oy + i, ox + j, sy, sx);
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
      // final bands: write the tile's interior at the output's level,
      // clipped to the band (a level's bands share one size)
      const int b = s.store >= 0 ? s.store : s.store2;
      const int nh = max(0, min(fd.th, bd.h[b] - ti * fd.th));
      const int nw = max(0, min(fd.tw, bd.w[b] - tj * fd.tw));
      for (int e = threadIdx.x; e < nh * nw; e += blockDim.x) {
        const int i = e / nw, j = e % nw;
        const int y = ti * fd.th + i, x = tj * fd.tw + j;
        const int k = (fd.py + i) * fd.WW + fd.px + j;
        if (s.store >= 0) store_band(bd, s.store, plane, y, x, dst[k]);
        if (s.store2 >= 0) store_band(bd, s.store2, plane, y, x, dst2[k]);
      }
      __syncthreads();
    }
  }
}

template <typename T>
int launch(const void* in, const Bands& bd, const void* prog, int n, int h, int w, int tile_h,
           int tile_w, int slot_size, int n_slots, int threads, cudaStream_t stream) {
  const int tiles_x = (w + tile_w - 1) / tile_w;
  const int tiles_y = (h + tile_h - 1) / tile_h;
  const size_t smem = size_t(n_slots) * slot_size * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(stencil_chain_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const long long blocks = (long long)n * tiles_x * tiles_y;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  stencil_chain_kernel<T><<<unsigned(blocks), threads, smem, stream>>>(
      static_cast<const T*>(in), bd, static_cast<const ChainProgram*>(prog), n, h, w, slot_size,
      tiles_x, tiles_y);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int stencil_chain_program_bytes() { return int(sizeof(ChainProgram)); }

extern "C" int stencil_bands_bytes() { return int(sizeof(Bands)); }

// Launch on `stream` for u8 (u8 != 0) or f32 planes, tile_h x tile_w input
// tiles, n_slots slots of slot_size floats; `bands` (host memory) names
// every output band's buffer, the remap stages' map planes and the levels'
// sizes.  Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int stencil_chain_launch(const void* in, const void* bands, const void* prog, int n,
                                    int h, int w, int tile_h, int tile_w, int slot_size,
                                    int n_slots, int threads, int u8, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const Bands& bd = *static_cast<const Bands*>(bands);
  if (u8)
    return launch<uint8_t>(in, bd, prog, n, h, w, tile_h, tile_w, slot_size, n_slots, threads, st);
  return launch<float>(in, bd, prog, n, h, w, tile_h, tile_w, slot_size, n_slots, threads, st);
}
