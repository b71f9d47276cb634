// stencil_stream: a whole Stage chain over (N, H, W) u8 or f32 planes in one
// launch, carrying rows from step to step in shared-memory rings.
//
// Replaces src/repro/kernels/stencil/exec_streaming.py `streaming_kernel`
// (TPU, Pallas) in both its plans: "streaming" (one column tile of the full
// width) and "tiled2d" (column tiles from `plan.pick_tile_plan`).
//
// Bound on an H100: the paper's single ops and short chains on u8 images are
// bound by bytes (erode: 2 bytes a pixel against ~8 compares), a large
// filter2d by operations (k = 13: 338 FLOP a pixel).  Either way the kernel
// must not recompute what it computed once: the window kernel
// (stencil_chain.cu) recomputes every stage's halo in every 32x32 block;
// here every stage computes each of its rows once per column tile.
//
// Design: one block per (plane, column tile, row segment).  The block walks
// down its segment in steps of `rows` output rows.  Each stream (one band
// after one stage; stream 0 is the input) lives in a ring of `depth` rows of
// the tile's width plus the accumulated column halo, indexed by the absolute
// image row modulo the depth: rows are never copied, only the index moves.
// Depths come from `plan.stream_layout`: `rows` plus the most any reader
// lags, i.e. a stage's 2*halo rows of carry, plus the delay of the tap
// stages a pass-through band crosses (its delay FIFO, held as extra depth
// of its own ring and read later rather than copied), plus an output band's
// lead over the rows stored.  Columns are recomputed per tile; only rows are
// carried.  The block primes its rings from the real rows above its
// segment: the first steps (i < 0) compute only the rows of each stream that
// lie at or below y0 - lead, so together they are the window pass of the
// JAX kernel's step 0, computed `rows` at a time in the steady-state rings.
// Reads are clamped at the image edge only (extended-domain borders).  The
// last step computes whole steps into the extended domain and stores only
// the rows inside the segment and the plane.  A final band with lead 0 that
// nothing reads is stored straight from registers.
//
// Levels: a stream lives at the resolution of the stage that made it (the
// input's, then one level per strided or upsampling stage before the last).
// Rows are counted at each stream's own level: a step adds `mult` rows to a
// stream (twice the last level's rows above a stride, half below a pyrUp),
// its segment starts at that level's image of the segment's first row, and
// its ring is indexed by the absolute row at its level.  Columns: the
// streams of a level share its frame, the tile at that resolution plus the
// level's pad.  A stride before the last stage reads its source rows at
// twice its output rows; a pyrUp reads rows floor(Y/2) - 1 .. floor(Y/2) + 1
// for output row Y and interleaves the phases by Y's parity, so a step that
// starts on an odd row needs one more source row (JAX's 2*halo + 1 ring on
// an odd-phase interface), which the plan's depths hold.
//
// A strided last stage (pyrDown, resize2) is planned at its input's
// resolution: its step computes at the image-even columns of the tile and
// the image-even rows among the step's rows (pyrDown: the row pass at the
// even columns, the column pass at the even rows), and stores them straight
// to the decimated band.  Step rows, segment starts and column tiles are
// multiples of the stride product, so the steps of a segment and the
// segments of a plane cover disjoint decimated rows.
//
// Every band has its own output buffer and dtype (`Bands`, by value): a
// Sobel emits an f32 (dx, dy) pair into two streams on a u8 chain, and the
// pair reduction reads two streams.  The bands a Sobel passes by lag as
// those of a tap stage do (the JAX kernel's `delayed(news[:-1])`), in the
// extra depth of their own rings.  A gather's ring holds its source rows
// out to the displacement halo on both sides; ring rows are absolute image
// rows, so the gather's row origin is the block's global row, not the
// segment-local step, and its column origin is the tile's, tx0 - pw.
//
// Arithmetic: the stage bodies of stencil_ops.cuh, shared with
// stencil_chain.cu, so both kernels and the plain version agree bit for bit.

#include "stencil_ops.cuh"

namespace {

using namespace stencil;

constexpr int kMaxSteps = 32;
constexpr int kMaxStreams = kMaxSteps + 1;
constexpr int kMaxWeights = 512;

struct StreamStep {
  int op;          // stencil::Op
  int src, src2;   // streams read (src2: the reduction's second band)
  int dst, dst2;   // streams written (dst2: a Sobel's dy); -1: store straight to
                   // output band `store` / `store2`
  int kh, kw;      // stencil extents (halo = k / 2)
  int wx, wy;      // offsets of taps or scalars in weights[] (a remap: its maps)
  int rw;          // columns around the tile the source stream holds (its level)
  int cw;          // columns around the tile the output covers (its level)
  int lead;        // rows the destination stream runs ahead of the step's rows
  int mult;        // rows the destination stream adds a step
  int ls, lo;      // levels of the source and of the output
  int store, store2;  // output bands of direct stores, else -1
  int down;        // 2: a strided last stage, stored directly to band `store`
  int pk;          // 1: pack the step's result to u8
};

struct Stream {
  int depth;  // ring rows (0: never buffered)
  int level;  // its level: the ring's row width is that level's frame
  int mult;   // rows it adds a step
  int lead;   // rows it runs ahead of a step's rows (and starts above a segment)
  int store;  // output band stored from this ring after every step, or -1
};

struct StreamProgram {
  int n_steps, n_streams, n_levels, rows, prime, pad[3];
  StreamStep steps[kMaxSteps];
  Stream streams[kMaxStreams];
  int col_pads[kMaxLevels];
  float weights[kMaxWeights];
};

__device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T>
__global__ void stencil_stream_kernel(const T* __restrict__ in, const Bands bd,
                                      const StreamProgram* __restrict__ prog, int n, int h, int w,
                                      int tile_w, int tiles_x, int n_seg, int seg_rows) {
  __shared__ StreamProgram sp;
  __shared__ int ring_at[kMaxStreams + 1];  // each ring's first float; then the scratch
  extern __shared__ float smem[];

  {
    const int* from = reinterpret_cast<const int*>(prog);
    int* to = reinterpret_cast<int*>(&sp);
    for (int e = threadIdx.x; e < int(sizeof(StreamProgram) / sizeof(int)); e += blockDim.x)
      to[e] = from[e];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int at = 0;
    for (int s = 0; s < sp.n_streams; ++s) {
      ring_at[s] = at;
      const int l = sp.streams[s].level;
      at += sp.streams[s].depth * (bd.tw[l] + 2 * sp.col_pads[l]);
    }
    ring_at[sp.n_streams] = at;
  }
  __syncthreads();

  const int m = sp.rows, last = sp.n_levels - 1;
  const int per_plane = tiles_x * n_seg;
  const int plane = blockIdx.x / per_plane;
  const int rem = blockIdx.x - plane * per_plane;
  const int tile = rem / n_seg;
  const int seg = rem - tile * n_seg;
  // the last level's frame: stores and direct stores
  const int pwT = sp.col_pads[last], tileT = bd.tw[last];
  const int tx0 = tile * tileT;                 // image column of the tile at the last level
  const int oxT = tx0 - pwT;                    // ... of its frame's column 0
  const int tw = min(tileT, bd.lw[last] - tx0);  // columns of this tile inside the band
  const int y0 = seg * seg_rows;                // segment rows at the last level
  const int y1 = min(y0 + seg_rows, bd.lh[last]);
  const int step0 = y0 / m;                     // the segment's first step of the plane
  const T* src_plane = in + plane * (size_t(h) * w);
  float* scratch = smem + ring_at[sp.n_streams];

  auto width = [&](int l) { return bd.tw[l] + 2 * sp.col_pads[l]; };
  auto origin = [&](int l) { return tile * bd.tw[l] - sp.col_pads[l]; };
  auto ring = [&](int s) {
    const Stream& st = sp.streams[s];
    return RingRows{smem + ring_at[s], st.depth, width(st.level)};
  };

  for (int i = -sp.prime; i < ceil_div(y1 - y0, m); ++i) {
    // stream 0: the input rows this step adds, read with clamped coordinates
    {
      const Stream& st = sp.streams[0];
      const RingRows r0 = ring(0);
      const int W0 = width(0), ox0 = origin(0), Y0 = step0 * st.mult;
      const int lo = max(Y0 + i * st.mult + st.lead, Y0 - st.lead);
      const int hi = Y0 + (i + 1) * st.mult + st.lead;
      for (int e = threadIdx.x; e < (hi - lo) * W0; e += blockDim.x) {
        const int r = lo + e / W0, j = e % W0;
        const int y = min(max(r, 0), h - 1);
        const int x = min(max(ox0 + j, 0), w - 1);
        r0(r)[j] = load_f32(src_plane + size_t(y) * w + x);
      }
      __syncthreads();
    }

    for (int si = 0; si < sp.n_steps; ++si) {
      const StreamStep s = sp.steps[si];
      // the destination stream's new rows [lo, hi) at this step, at its level
      const int Y0 = step0 * s.mult;
      const int lo = max(Y0 + i * s.mult + s.lead, Y0 - s.lead), hi = Y0 + (i + 1) * s.mult + s.lead;
      if (lo >= hi) continue;  // not primed this far yet (uniform across the block)
      const RingRows src = ring(s.src);
      const int hy = s.kh / 2, hx = s.kw / 2;
      const int pw = sp.col_pads[s.lo], WWd = width(s.lo), oxd = origin(s.lo);
      const int WWs = width(s.ls), ox = origin(s.ls);
      const int c0 = pw - s.cw, c1 = pw + bd.tw[s.lo] + s.cw;  // output columns
      const int cols = c1 - c0, nr = hi - lo;
      const float* wts = sp.weights + s.wx;
      const RingRows dst = s.dst < 0 ? RingRows{nullptr, 1, 0} : ring(s.dst);
      const RingRows dst2 = s.dst2 < 0 ? RingRows{nullptr, 1, 0} : ring(s.dst2);

      // write v (packed) to the destination ring, or store it when the band
      // is final and stored straight from registers
      auto put = [&](const RingRows& d, int dk, int b, int r, int j, float v) {
        if (dk >= 0) {
          d(r)[j] = v;
        } else if (r >= y0 && r < y1 && j >= pwT && j < pwT + tw) {
          store_band(bd, b, plane, r, oxT + j, v);
        }
      };

      if (s.op == kPyrUp) {
        // row pass: each output row's phase over the source columns the
        // outputs read -> scratch (the step's rows at the source's width),
        // then the column pass
        const int x0 = floor2(oxd + c0) - 1 - ox, x1 = floor2(oxd + c1 - 1) + 2 - ox;
        const int nx = x1 - x0;
        for (int e = threadIdx.x; e < nr * nx; e += blockDim.x) {
          const int a = e / nx, x = x0 + e % nx;
          const int Y = lo + a, y = floor2(Y);
          const float b = src(y)[x], c = src(y + 1)[x];
          scratch[a * WWs + x] = (Y & 1) ? pyr_up_odd(b, c) : pyr_up_even(src(y - 1)[x], b, c);
        }
        __syncthreads();
        for (int e = threadIdx.x; e < nr * cols; e += blockDim.x) {
          const int a = e / cols, j = c0 + e % cols;
          const int X = oxd + j, q = floor2(X) - ox;
          const float* r = scratch + a * WWs;
          const float v = (X & 1) ? pyr_up_odd(r[q], r[q + 1]) : pyr_up_even(r[q - 1], r[q], r[q + 1]);
          put(dst, s.dst, s.store, lo + a, j, pack(v, s.pk));
        }
      } else if (s.op == kPyrDown && s.down == 1) {
        // a stride before the last stage: the row pass over source rows
        // [2 lo - hy, 2 (hi - 1) + hy] at the image-even source columns of
        // the output's columns -> scratch, then the column pass
        const int ra = 2 * lo - hy, na = 2 * (nr - 1) + 2 * hy + 1;
        for (int e = threadIdx.x; e < na * cols; e += blockDim.x) {
          const int a = e / cols, j = c0 + e % cols;
          const int x = 2 * (oxd + j) - ox;
          scratch[a * WWd + j] = row_pass(s.op, src(ra + a) + x - hx, wts, s.kw);
        }
        __syncthreads();
        for (int e = threadIdx.x; e < nr * cols; e += blockDim.x) {
          const int a = e / cols, j = c0 + e % cols;
          const float v = col_pass(s.op, scratch + 2 * a * WWd + j, WWd, sp.weights + s.wy, s.kh,
                                   wts[0]);
          put(dst, s.dst, s.store, lo + a, j, pack(v, s.pk));
        }
      } else if (s.op == kResize2 && s.down == 1) {
        for (int e = threadIdx.x; e < nr * cols; e += blockDim.x) {
          const int r = lo + e / cols, j = c0 + e % cols;
          const float v = resize2_at(src, 2 * r, 2 * (oxd + j) - ox);
          put(dst, s.dst, s.store, r, j, pack(v, s.pk));
        }
      } else if (s.op == kPyrDown) {
        // the chain's last stage: the row pass over rows [lo - hy, hi + hy)
        // at the image-even columns -> scratch, then the column pass at the
        // image-even rows, stored to the decimated band
        const int j0 = first_even(c0, ox), ecols = (c1 - j0 + 1) / 2;
        const int ry0 = first_even(lo, 0), erows = (hi - ry0 + 1) / 2;
        for (int e = threadIdx.x; e < (nr + 2 * hy) * ecols; e += blockDim.x) {
          const int a = e / ecols, j = j0 + 2 * (e % ecols);
          scratch[a * WWs + j] = row_pass(s.op, src(lo - hy + a) + j - hx, wts, s.kw);
        }
        __syncthreads();
        for (int e = threadIdx.x; e < erows * ecols; e += blockDim.x) {
          const int r = ry0 + 2 * (e / ecols), j = j0 + 2 * (e % ecols), x = ox + j;
          if (r >= y0 && r < y1 && x >= tx0 && x < tx0 + tw && r / 2 < bd.h[s.store] &&
              x / 2 < bd.w[s.store]) {
            const float v = col_pass(s.op, scratch + (r - lo) * WWs + j, WWs, sp.weights + s.wy,
                                     s.kh, wts[0]);
            store_band(bd, s.store, plane, r / 2, x / 2, pack(v, s.pk));
          }
        }
      } else if (s.op == kResize2) {
        // the chain's last stage: 2x2 means at the image-even rows and
        // columns, stored to the decimated band (floor size)
        const int j0 = first_even(c0, ox), ecols = (c1 - j0) / 2;
        const int ry0 = first_even(lo, 0), erows = (hi - ry0) / 2;
        for (int e = threadIdx.x; e < erows * ecols; e += blockDim.x) {
          const int r = ry0 + 2 * (e / ecols), j = j0 + 2 * (e % ecols), x = ox + j;
          if (r >= y0 && r < y1 && x >= tx0 && x < tx0 + tw && r / 2 < bd.h[s.store] &&
              x / 2 < bd.w[s.store])
            store_band(bd, s.store, plane, r / 2, x / 2, pack(resize2_at(src, r, j), s.pk));
        }
      } else if (separable(s.op)) {
        // row pass over rows [lo - hy, hi + hy) -> scratch, then column pass
        for (int e = threadIdx.x; e < (nr + 2 * hy) * cols; e += blockDim.x) {
          const int a = e / cols, j = c0 + e % cols;
          scratch[a * WWs + j] = row_pass(s.op, src(lo - hy + a) + j - hx, wts, s.kw);
        }
        __syncthreads();
        for (int e = threadIdx.x; e < nr * cols; e += blockDim.x) {
          const int a = e / cols, j = c0 + e % cols;
          const float v = col_pass(s.op, scratch + a * WWs + j, WWs, sp.weights + s.wy, s.kh, wts[0]);
          put(dst, s.dst, s.store, lo + a, j, pack(v, s.pk));
        }
      } else if (s.op == kSobel) {
        for (int e = threadIdx.x; e < nr * cols; e += blockDim.x) {
          const int r = lo + e / cols, j = c0 + e % cols;
          float dx, dy;
          sobel_at(src, r, j, dx, dy);
          put(dst, s.dst, s.store, r, j, dx);
          put(dst2, s.dst2, s.store2, r, j, dy);
        }
      } else if (s.op == kWarp || s.op == kRemap) {
        // the source ring holds rows [lo - hy, hi + hy) and columns
        // [c0 - hx, c1 + hx); coordinates are absolute image ones
        const float* mx = bd.maps[2 * s.wx];
        const float* my = bd.maps[2 * s.wx + 1];
        for (int e = threadIdx.x; e < nr * cols; e += blockDim.x) {
          const int r = lo + e / cols, j = c0 + e % cols;
          float sy, sx;
          if (s.op == kWarp)
            warp_coords(wts, r, ox + j, sy, sx);
          else
            remap_coords(mx, my, bd.lh[s.ls], bd.lw[s.ls], r, ox + j, sy, sx);
          const float v = bilinear_at(src, sy, sx, 0, ox, lo - hy, hi + hy, c0 - hx, c1 + hx);
          put(dst, s.dst, s.store, r, j, pack(v, s.pk));
        }
      } else if (s.op == kFilter2d || s.op == kGrad) {
        for (int e = threadIdx.x; e < nr * cols; e += blockDim.x) {
          const int r = lo + e / cols, j = c0 + e % cols;
          const float v = s.op == kGrad ? grad_at(src, r, j)
                                        : filter2d_at(src, r - hy, j - hx, wts, s.kh, s.kw);
          put(dst, s.dst, s.store, r, j, pack(v, s.pk));
        }
      } else if (s.op == kGradPair) {
        const RingRows src2 = ring(s.src2);
        for (int e = threadIdx.x; e < nr * cols; e += blockDim.x) {
          const int r = lo + e / cols, j = c0 + e % cols;
          put(dst, s.dst, s.store, r, j, pack(grad_pair(src(r)[j], src2(r)[j]), s.pk));
        }
      } else {
        for (int e = threadIdx.x; e < nr * cols; e += blockDim.x) {
          const int r = lo + e / cols, j = c0 + e % cols;
          put(dst, s.dst, s.store, r, j, pack(pointwise(s.op, src(r)[j], wts), s.pk));
        }
      }
      __syncthreads();
    }

    // output bands held in rings: store this step's rows inside the segment
    if (i >= 0) {
      const int lo = y0 + i * m, hi = min(lo + m, y1);
      for (int k = 0; k < sp.n_streams; ++k) {
        const Stream& st = sp.streams[k];
        if (st.store < 0 || st.depth == 0) continue;
        const RingRows rr = ring(k);
        for (int e = threadIdx.x; e < (hi - lo) * tw; e += blockDim.x) {
          const int r = lo + e / tw, j = e % tw;
          store_band(bd, st.store, plane, r, tx0 + j, rr(r)[pwT + j]);
        }
      }
      __syncthreads();
    }
  }
}

template <typename T>
int launch(const void* in, const Bands& bd, const void* prog, int n, int h, int w, int tile_w,
           int n_seg, int seg_rows, int smem_floats, int threads, cudaStream_t stream) {
  const int tiles_x = (w + tile_w - 1) / tile_w;
  const size_t smem = size_t(smem_floats) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(stencil_stream_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const long long blocks = (long long)n * tiles_x * n_seg;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  stencil_stream_kernel<T><<<unsigned(blocks), threads, smem, stream>>>(
      static_cast<const T*>(in), bd, static_cast<const StreamProgram*>(prog), n, h, w, tile_w,
      tiles_x, n_seg, seg_rows);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int stencil_stream_program_bytes() { return int(sizeof(StreamProgram)); }

extern "C" int stencil_bands_bytes() { return int(sizeof(Bands)); }

// Launch on `stream` for u8 (u8 != 0) or f32 planes, column tiles of tile_w
// input columns, n_seg segments of seg_rows rows (at the chain's last level)
// a plane, smem_floats of rings and scratch a block; `bands` (host memory)
// names every output band's buffer, the remap stages' map planes and the
// levels' sizes.  Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int stencil_stream_launch(const void* in, const void* bands, const void* prog, int n,
                                     int h, int w, int tile_w, int n_seg, int seg_rows,
                                     int smem_floats, int threads, int u8, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const Bands& bd = *static_cast<const Bands*>(bands);
  if (u8)
    return launch<uint8_t>(in, bd, prog, n, h, w, tile_w, n_seg, seg_rows, smem_floats, threads,
                           st);
  return launch<float>(in, bd, prog, n, h, w, tile_w, n_seg, seg_rows, smem_floats, threads, st);
}
