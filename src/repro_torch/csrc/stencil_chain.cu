// stencil_chain: a whole Stage chain over (N, H, W) u8 or f32 planes in one
// launch, by overlapping windows.
//
// Replaces src/repro/kernels/stencil/exec_window.py `window_kernel` (with
// `window_pass`, the stage bodies and `launch`), and covers what
// exec_streaming.py `streaming_kernel` computes (the same bands).
//
// Bound on an H100: by the chain's own counts, bytes (each input pixel read
// once, each output band written once; the BoW octave of a request moves
// 8.4 MB); by what a window must compute, operations: a block recomputes
// its tile's halo through every stage, and the kernels may not contract a
// product and a sum into one FMA (every product and sum is rounded on its
// own, as the plain version computes them).  The BoW octave (7 separable
// Gaussians, taps 11..15, on 256 planes of 32x32 under a 34-pixel halo)
// computes ~1.34 MFLOP a plane in full 100x100 windows.  So the design
// computes only what is distinct, keeps the work on the FP32 pipes, and
// fills the card in one wave:
//
//  * Frames (exec_window.py `compile_chain`).  Every band lives in a slot of
//    dynamic shared memory, in a frame of its own: its tile at its level
//    plus the rows and columns its readers need around it.  A band made from
//    the input through level-0, stride-1, position-independent stages
//    repeats its row -L above the image and its row H - 1 + L below it
//    (L: the halos along its lineage), so its frame is cut to [-L, H + L)
//    and every read of it clamps into the frame: bit-identical by
//    construction, and the octave's largest frame is 64x64, not 100x100.
//    The input's frame is the case L = 0: the tile and its halo inside the
//    image, read once from device memory.  Bands read by gathers,
//    resolution changes and everything after them keep full frames.
//  * Register strips.  A separable stage's row pass gives each thread 4
//    adjacent outputs of one row: it loads the k + 3 source values once,
//    into registers, and runs the 4 sums tap by tap; its column pass gives
//    each thread 4 adjacent rows of one column, walking k + 3 rows of the
//    scratch.  filter2d does the row pass's strip for each of its k rows.
//    Rows and column groups are walked with counts fixed per step (one
//    division a pass, none per value).  Strips unroll up to kMaxTaps taps,
//    odd or even; longer taps take the same loops without unrolling.  A
//    warp's row-pass lanes take 32 rows at one column group, at an odd row
//    stride, so their shared-memory reads fall in distinct banks.
//  * One wave.  exec_window.py `window_geometry` picks 128-512 threads and
//    counts the blocks an SM holds (plan.chain_threads: shared memory,
//    threads, and the 64 registers a thread of __launch_bounds__(512, 2)):
//    a request's 256 planes run as 256 blocks of 512 threads, two an SM.
//  * The program (frames, steps, weights) is copied into the block's shared
//    memory at the size the chain uses, not a fixed table; so a chain may
//    have any number of steps and weights that its block's shared memory
//    holds.  Output bands are stored from the values as each step makes
//    them (no store pass); a band that no later stage reads takes no slot.
//
// Levels: a chain walks one or more resolution levels (the input's, then one
// per strided or upsampling stage before the last).  A step reads its
// source in its frame at the source's level and writes its output frame at
// the output's level: a mid-chain stride writes the half-size frame from
// the image-even rows and columns of its source, a pyrUp the double-size
// frame, both phases interleaved, from the source row and column of each
// output's absolute image coordinate (floor of half), the phase its parity.
// A strided last stage (pyrDown, resize2; the octave's next-base tap, or a
// lone map stage) computes the tile's image-even rows and columns only and
// stores them straight to its decimated band.
//
// Bands of two dtypes share a launch: a Sobel emits an f32 (dx, dy) pair on
// a u8 chain.  Every band has its own output buffer (`Bands`, by value) and
// every step its own pack flag; slots hold f32 whatever the band.  The
// gathers (warp, remap) sample their source at absolute image coordinates,
// clamped to the rows and columns around the tile the step's source must
// hold (the JAX kernel's window); remap's map planes are read from device
// memory.
//
// Arithmetic: the stage bodies of stencil_ops.cuh and strips that repeat
// them in the same order (every product and sum rounded on its own, in the
// JAX body's index order; sums start from the first product, as -0 + p = p;
// erode and dilate from the first value, as from +-inf), so this kernel,
// stencil_stream.cu and the plain PyTorch version agree bit for bit.

#include "stencil_ops.cuh"

namespace {

using namespace stencil;

constexpr int kMaxThreads = 512;  // kernels/stencil/plan.py CHAIN_THREADS, CHAIN_REGS
constexpr int kStrip = 4;         // outputs of a register strip
constexpr int kMaxTaps = 16;      // taps a strip unrolls; longer ones loop

// The program, as exec_window.py `ChainProgram.packed` lays it out: a
// header, one FrameDesc per band, one Step per stage application, then the
// weights (floats).
struct Header {
  int n_steps, n_frames, n_weights, pad;
};

struct FrameDesc {
  int level;   // the band's resolution level
  int ry, rx;  // rows / columns around the tile its frame holds
  int ly, lx;  // the frame is cut to [-ly, H + ly) x [-lx, W + lx) (UNCUT: not cut)
  int pad;
};

struct Step {
  int op;              // stencil::Op
  int src, src2;       // shared-memory slots read (src2: the reduction's second band)
  int dst, dst2;       // slots written (dst2: a Sobel's dy), -1: stored only
  int tmp;             // the row-pass scratch's slot, or -1
  int fs, fs2;         // frames of the sources
  int fd, fd2;         // frames of the outputs, -1 for a strided last stage
  int kh, kw;          // the stencil's extents (halo k / 2; even taps read o - k/2 .. o - k/2 + k - 1)
  int wx, wy;          // offsets of the row / column taps (or scalars) in the weights
  int rh, rw;          // rows / columns around the tile the source must hold, at level ls
  int ls, lo;          // levels of the source and of the output
  int store, store2;   // output bands stored from the outputs, or -1
  int down;            // 2: a strided last stage, stored to band `store` decimated
  int pk;              // 1: pack the step's result to u8
};

// A band's frame in one block: image rows [y0, y1) x columns [x0, x1) at its
// level, row stride ld (odd), in the slot at p (nullptr: no slot).
struct Frame {
  float* p;
  int y0, y1, x0, x1, ld;
  __device__ __forceinline__ float* row(int y) const { return p + (y - y0) * ld; }
  // the value at (y, x), clamped into the frame
  __device__ __forceinline__ float at(int y, int x) const {
    return row(min(max(y, y0), y1 - 1))[min(max(x, x0), x1 - 1) - x0];
  }
};

__device__ __forceinline__ Frame make_frame(float* p, int y0, int y1, int x0, int x1) {
  return Frame{p, y0, y1, x0, x1, (x1 - x0) | 1};
}

// Band frame `f` of tile (ti, tj): the tile at the band's level plus ry, rx
// each way, cut to [-ly, H + ly) x [-lx, W + lx).
__device__ __forceinline__ Frame frame_of(const FrameDesc& f, float* p, const Bands& bd, int ti,
                                          int tj) {
  const int l = f.level, th = bd.th[l], tw = bd.tw[l];
  const int ty = ti * th, tx = tj * tw;
  return make_frame(p, max(ty - f.ry, -f.ly), min(ty + th + f.ry, bd.lh[l] + f.ly),
                    max(tx - f.rx, -f.lx), min(tx + tw + f.rx, bd.lw[l] + f.lx));
}

// Where a step's values go: its output frame (the region it computes; the
// slot, when the band has one) and the output band it stores, over the
// tile's part of the band.
struct Out {
  Frame f;
  int band, plane;
  int ty0, ty1, tx0, tx1;
  __device__ __forceinline__ void put(const Bands& bd, int y, int x, float v) const {
    if (f.p) f.row(y)[x - f.x0] = v;
    if (band >= 0 && y >= ty0 && y < ty1 && x >= tx0 && x < tx1) store_band(bd, band, plane, y, x, v);
  }
};

__device__ __forceinline__ Out make_out(const Frame& f, int band, int plane, const Bands& bd,
                                        int level, int ti, int tj) {
  Out o{f, band, plane, 0, 0, 0, 0};
  if (band >= 0) {
    const int th = bd.th[level], tw = bd.tw[level];
    o.ty0 = ti * th;
    o.ty1 = min(o.ty0 + th, bd.h[band]);
    o.tx0 = tj * tw;
    o.tx1 = min(o.tx0 + tw, bd.w[band]);
  }
  return o;
}

// f(r, g) for every item of an nr x ng space, r fastest, spread over the
// block: one division a pass, none an item.
template <class F>
__device__ __forceinline__ void for_items(int nr, int ng, F&& f) {
  if (nr <= 0 || ng <= 0) return;
  const int T = blockDim.x, total = nr * ng;
  int r = threadIdx.x % nr, g = threadIdx.x / nr;
  const int dr = T % nr, dg = T / nr;
  for (int it = threadIdx.x; it < total; it += T) {
    f(r, g);
    r += dr;
    g += dg;
    if (r >= nr) {
      r -= nr;
      ++g;
    }
  }
}

// f(r, c) for rows [0, nr) and columns [0, nc): the block as rows of nx
// column lanes (consecutive lanes on consecutive columns).
template <class F>
__device__ __forceinline__ void for2d(int nr, int nc, F&& f) {
  if (nr <= 0 || nc <= 0) return;
  int nx = blockDim.x;
  while (nx > 32 && nx >= 2 * nc) nx >>= 1;
  const int tx = threadIdx.x % nx, ty = threadIdx.x / nx, ny = blockDim.x / nx;
  for (int r = ty; r < nr; r += ny)
    for (int c = tx; c < nc; c += nx) f(r, c);
}

// ---------------------------------------------------------------------------
// Register strips
// ---------------------------------------------------------------------------

// acc = op(acc, w, x) in the separable ops' order: a rounded product then a
// rounded sum (sep), a sum (box), a min (erode), a max (dilate).
template <int OP>
__device__ __forceinline__ float tap(float acc, float w, float x) {
  if (OP == kSep) return __fadd_rn(acc, __fmul_rn(w, x));
  if (OP == kBox) return __fadd_rn(acc, x);
  if (OP == kErode) return fminf(acc, x);
  return fmaxf(acc, x);
}

template <int OP>
__device__ __forceinline__ float first(float w, float x) {
  return OP == kSep ? __fmul_rn(w, x) : x;
}

// The K + kStrip - 1 values at s[b0 ..] (local indices, clamped into [0,
// n)) into registers: unclamped where the whole run lies inside.
__device__ __forceinline__ void load_run(const float* s, int b0, int n, int K,
                                         float (&x)[kMaxTaps + kStrip - 1]) {
  if (b0 >= 0 && b0 + K + kStrip - 1 <= n) {
#pragma unroll
    for (int b = 0; b < kMaxTaps + kStrip - 1; ++b) {
      if (b >= K + kStrip - 1) break;
      x[b] = s[b0 + b];
    }
  } else {
#pragma unroll
    for (int b = 0; b < kMaxTaps + kStrip - 1; ++b) {
      if (b >= K + kStrip - 1) break;
      x[b] = s[min(max(b0 + b, 0), n - 1)];
    }
  }
}

// The same run at stride ld (a column of the scratch).
__device__ __forceinline__ void load_col(const float* s, int ld, int b0, int n, int K,
                                         float (&x)[kMaxTaps + kStrip - 1]) {
  if (b0 >= 0 && b0 + K + kStrip - 1 <= n) {
#pragma unroll
    for (int b = 0; b < kMaxTaps + kStrip - 1; ++b) {
      if (b >= K + kStrip - 1) break;
      x[b] = s[(b0 + b) * ld];
    }
  } else {
#pragma unroll
    for (int b = 0; b < kMaxTaps + kStrip - 1; ++b) {
      if (b >= K + kStrip - 1) break;
      x[b] = s[min(max(b0 + b, 0), n - 1) * ld];
    }
  }
}

// kStrip outputs of a separable pass over the run x: output c takes x[c ..
// c + K - 1] with taps k (row_pass's / col_pass's order).
template <int OP>
__device__ __forceinline__ void strip_sums(const float (&x)[kMaxTaps + kStrip - 1],
                                           const float* k, int K, float (&o)[kStrip]) {
#pragma unroll
  for (int c = 0; c < kStrip; ++c) o[c] = first<OP>(k[0], x[c]);
#pragma unroll
  for (int q = 1; q < kMaxTaps; ++q) {
    if (q >= K) break;
    const float w = OP == kSep ? k[q] : 0.0f;
#pragma unroll
    for (int c = 0; c < kStrip; ++c) o[c] = tap<OP>(o[c], w, x[q + c]);
  }
}

// The same for any K, without registers for the run: v(i) is the i-th value.
template <int OP, class V>
__device__ __forceinline__ void strip_sums_any(V&& v, const float* k, int K, float (&o)[kStrip]) {
#pragma unroll
  for (int c = 0; c < kStrip; ++c) {
    float acc = first<OP>(k[0], v(c));
    for (int q = 1; q < K; ++q) acc = tap<OP>(acc, OP == kSep ? k[q] : 0.0f, v(q + c));
    o[c] = acc;
  }
}

// Row pass of a separable stage: tmp (rows: source rows, columns: the
// output's) <- the row sums of src, kStrip columns a thread, rows fastest.
template <int OP>
__device__ void row_pass_strips(const Frame& src, const Frame& tmp, const float* kx, int kw) {
  const int hx = kw / 2, nr = tmp.y1 - tmp.y0, nc = tmp.x1 - tmp.x0, n = src.x1 - src.x0;
  for_items(nr, (nc + kStrip - 1) / kStrip, [&](int r, int g) {
    const float* s = src.row(tmp.y0 + r);
    const int b0 = tmp.x0 + g * kStrip - hx - src.x0;
    float o[kStrip];
    if (kw <= kMaxTaps) {
      float x[kMaxTaps + kStrip - 1];
      load_run(s, b0, n, kw, x);
      strip_sums<OP>(x, kx, kw, o);
    } else {
      strip_sums_any<OP>([&](int i) { return s[min(max(b0 + i, 0), n - 1)]; }, kx, kw, o);
    }
    float* t = tmp.row(tmp.y0 + r) + g * kStrip;
#pragma unroll
    for (int c = 0; c < kStrip; ++c)
      if (g * kStrip + c < nc) t[c] = o[c];
  });
}

// Column pass of a separable stage: the output frame <- the column sums of
// tmp, kStrip rows of one column a thread, columns fastest (box scales the
// sum after it).
template <int OP>
__device__ void col_pass_strips(const Frame& tmp, const Out& out, const Bands& bd, const float* ky,
                                int kh, float scale, int pk) {
  const Frame& f = out.f;
  const int hy = kh / 2, nrow = f.y1 - f.y0, nc = f.x1 - f.x0, n = tmp.y1 - tmp.y0;
  for_items(nc, (nrow + kStrip - 1) / kStrip, [&](int c, int g) {
    const int y = f.y0 + g * kStrip;
    const float* s = tmp.p + c;
    const int b0 = y - hy - tmp.y0;
    float o[kStrip];
    if (kh <= kMaxTaps) {
      float x[kMaxTaps + kStrip - 1];
      load_col(s, tmp.ld, b0, n, kh, x);
      strip_sums<OP>(x, ky, kh, o);
    } else {
      strip_sums_any<OP>([&](int i) { return s[min(max(b0 + i, 0), n - 1) * tmp.ld]; }, ky, kh,
                         o);
    }
#pragma unroll
    for (int i = 0; i < kStrip; ++i) {
      if (g * kStrip + i < nrow) {
        const float v = OP == kBox ? __fmul_rn(o[i], scale) : o[i];
        out.put(bd, y + i, f.x0 + c, pack(v, pk));
      }
    }
  });
}

// filter2d: each thread kStrip adjacent outputs of one row, column groups
// fastest (a warp stores whole runs of a row, and at an odd row stride its
// reads of a few rows fall in distinct banks); for each of the kh source
// rows, the kw + 3 values into registers, then each tap's products; taps
// row-major, the sum from -0.
__device__ void filter2d_strips(const Frame& src, const Out& out, const Bands& bd, const float* k,
                                int kh, int kw, int pk) {
  const Frame& f = out.f;
  const int hy = kh / 2, hx = kw / 2, nr = f.y1 - f.y0, nc = f.x1 - f.x0, n = src.x1 - src.x0;
  for_items((nc + kStrip - 1) / kStrip, nr, [&](int g, int r) {
    const int y = f.y0 + r, x0 = f.x0 + g * kStrip;
    const int b0 = x0 - hx - src.x0;
    float o[kStrip];
#pragma unroll
    for (int c = 0; c < kStrip; ++c) o[c] = -0.0f;
    for (int a = 0; a < kh; ++a) {
      const float* s = src.row(min(max(y - hy + a, src.y0), src.y1 - 1));
      const float* ka = k + a * kw;
      if (kw <= kMaxTaps) {
        float x[kMaxTaps + kStrip - 1];
        load_run(s, b0, n, kw, x);
#pragma unroll
        for (int b = 0; b < kMaxTaps; ++b) {
          if (b >= kw) break;
          const float w = ka[b];
#pragma unroll
          for (int c = 0; c < kStrip; ++c) o[c] = __fadd_rn(o[c], __fmul_rn(w, x[b + c]));
        }
      } else {
        for (int b = 0; b < kw; ++b) {
          const float w = ka[b];
#pragma unroll
          for (int c = 0; c < kStrip; ++c)
            o[c] = __fadd_rn(o[c], __fmul_rn(w, s[min(max(b0 + b + c, 0), n - 1)]));
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kStrip; ++c)
      if (g * kStrip + c < nc) out.put(bd, y, x0 + c, pack(o[c], pk));
  });
}

template <int OP>
__device__ void separable_step(const Frame& src, const Frame& tmp, const Out& out, const Bands& bd,
                               const float* kx, const float* ky, int kh, int kw, int pk) {
  row_pass_strips<OP>(src, tmp, kx, kw);
  __syncthreads();
  col_pass_strips<OP>(tmp, out, bd, ky, kh, OP == kBox ? kx[0] : 0.0f, pk);
}

// A frame from the plane: a warp's lanes on consecutive columns of one row,
// each lane with four rows' loads in flight before it stores them.
template <typename T>
__device__ __forceinline__ void load_frame(const Frame& f, const T* plane, int h, int w) {
  const int nr = f.y1 - f.y0, nc = f.x1 - f.x0;
  int nx = blockDim.x;
  while (nx > 32 && nx > nc) nx >>= 1;
  const int tx = threadIdx.x % nx, ty = threadIdx.x / nx, ny = blockDim.x / nx;
  auto at = [&](const T* col, int r) {
    return load_f32(col + size_t(min(max(f.y0 + r, 0), h - 1)) * w);
  };
  for (int c = tx; c < nc; c += nx) {
    const T* col = plane + min(max(f.x0 + c, 0), w - 1);
    int r = ty;
    for (; r + 3 * ny < nr; r += 4 * ny) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = at(col, r + u * ny);
#pragma unroll
      for (int u = 0; u < 4; ++u) f.p[(r + u * ny) * f.ld + c] = v[u];
    }
    for (; r < nr; r += ny) f.p[r * f.ld + c] = at(col, r);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
    stencil_chain_kernel(const T* __restrict__ in, const Bands bd, const int* __restrict__ prog,
                         int prog_ints, int n, int h, int w, int slot_size, int tiles_x,
                         int tiles_y) {
  extern __shared__ __align__(16) float smem[];
  int* table = reinterpret_cast<int*>(smem);
  for (int e = threadIdx.x; e < prog_ints; e += blockDim.x) table[e] = prog[e];
  __syncthreads();
  const Header hd = *reinterpret_cast<const Header*>(table);
  const FrameDesc* fdesc = reinterpret_cast<const FrameDesc*>(table + 4);
  const Step* steps = reinterpret_cast<const Step*>(table + 4 + 6 * hd.n_frames);
  const float* weights =
      reinterpret_cast<const float*>(table + 4 + 6 * hd.n_frames + 22 * hd.n_steps);
  float* slots = smem + ((prog_ints + 3) & ~3);

  const int tiles = tiles_x * tiles_y;
  const int plane = blockIdx.x / tiles;
  const int t = blockIdx.x - plane * tiles;
  const int ti = t / tiles_x, tj = t - (t / tiles_x) * tiles_x;
  const T* src_plane = in + plane * (size_t(h) * w);

  // slot 0 <- the input band's frame, edge-padded by clamping the read
  // coordinate (a cut frame lies inside the image)
  load_frame(frame_of(fdesc[0], slots, bd, ti, tj), src_plane, h, w);
  __syncthreads();

  for (int si = 0; si < hd.n_steps; ++si) {
    const Step s = steps[si];
    const Frame fs = frame_of(fdesc[s.fs], slots + s.src * slot_size, bd, ti, tj);
    const float* wts = weights + s.wx;
    const int hy = s.kh / 2, hx = s.kw / 2;
    // the tile at the source's level, and the rows / columns around it the
    // step's source must hold (the gathers' clamp, the strided last's rows)
    const int sth = bd.th[s.ls], stw = bd.tw[s.ls];
    const int sty = ti * sth, stx = tj * stw;

    if (s.op == kStore) {
      const Out o = make_out(fs, s.store, plane, bd, s.ls, ti, tj);
      for2d(o.ty1 - o.ty0, o.tx1 - o.tx0, [&](int r, int c) {
        store_band(bd, s.store, plane, o.ty0 + r, o.tx0 + c, fs.at(o.ty0 + r, o.tx0 + c));
      });
      __syncthreads();
      continue;
    }
    if (s.down == 2) {
      // the chain's last stage, strided: the tile's image-even rows and
      // columns only, stored straight to the decimated band
      const int b = s.store, erows = (sth + 1) / 2, ecols = (stw + 1) / 2;
      if (s.op == kPyrDown) {
        // row pass over rows [sty - hy, sty + sth + hy) at the even columns
        // -> tmp, then the column pass at the even rows
        const Frame tmp = make_frame(slots + s.tmp * slot_size, sty - hy, sty + sth + hy, 0, ecols);
        for2d(tmp.y1 - tmp.y0, ecols, [&](int r, int e) {
          const int q = tmp.y0 + r;
          tmp.row(q)[e] = row_pass(kPyrDown, fs.row(q) + stx + 2 * e - hx - fs.x0, wts, s.kw);
        });
        __syncthreads();
        for2d(erows, ecols, [&](int i, int e) {
          const int y = (sty + 2 * i) / 2, x = (stx + 2 * e) / 2;
          if (y < bd.h[b] && x < bd.w[b]) {
            const float v = col_pass(kPyrDown, tmp.row(sty + 2 * i - hy) + e, tmp.ld,
                                     weights + s.wy, s.kh, wts[0]);
            store_band(bd, b, plane, y, x, pack(v, s.pk));
          }
        });
      } else {
        const LinRows rows{fs.p, fs.ld};
        for2d(erows, ecols, [&](int i, int e) {
          const int Y = sty + 2 * i, X = stx + 2 * e;
          if (Y / 2 < bd.h[b] && X / 2 < bd.w[b])
            store_band(bd, b, plane, Y / 2, X / 2,
                       pack(resize2_at(rows, Y - fs.y0, X - fs.x0), s.pk));
        });
      }
      __syncthreads();
      continue;
    }

    const Frame fd = frame_of(fdesc[s.fd], s.dst >= 0 ? slots + s.dst * slot_size : nullptr, bd,
                              ti, tj);
    const Out out = make_out(fd, s.store, plane, bd, s.lo, ti, tj);
    const int Y0 = fd.y0, X0 = fd.x0, ny = fd.y1 - fd.y0, nx = fd.x1 - fd.x0;

    switch (s.op) {
      case kSep:
      case kErode:
      case kDilate:
      case kBox: {
        // the source rows the output reads (clamped into the source frame)
        // by the output's columns
        const Frame tmp = make_frame(slots + s.tmp * slot_size, max(fd.y0 - hy, fs.y0),
                                     min(fd.y1 - 1 - hy + s.kh - 1, fs.y1 - 1) + 1, fd.x0, fd.x1);
        const float* ky = weights + s.wy;
        if (s.op == kSep)
          separable_step<kSep>(fs, tmp, out, bd, wts, ky, s.kh, s.kw, s.pk);
        else if (s.op == kErode)
          separable_step<kErode>(fs, tmp, out, bd, wts, ky, s.kh, s.kw, s.pk);
        else if (s.op == kDilate)
          separable_step<kDilate>(fs, tmp, out, bd, wts, ky, s.kh, s.kw, s.pk);
        else
          separable_step<kBox>(fs, tmp, out, bd, wts, ky, s.kh, s.kw, s.pk);
        break;
      }
      case kFilter2d:
        filter2d_strips(fs, out, bd, wts, s.kh, s.kw, s.pk);
        break;
      case kGrad:
        for2d(ny, nx, [&](int r, int c) {
          const int y = Y0 + r, x = X0 + c;
          const float dy = __fmul_rn(__fsub_rn(fs.at(y + 1, x), fs.at(y - 1, x)), 0.5f);
          const float dx = __fmul_rn(__fsub_rn(fs.at(y, x + 1), fs.at(y, x - 1)), 0.5f);
          out.put(bd, y, x, pack(__fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy))), s.pk));
        });
        break;
      case kSobel: {
        const Frame fd2 = frame_of(fdesc[s.fd2], s.dst2 >= 0 ? slots + s.dst2 * slot_size : nullptr,
                                   bd, ti, tj);
        const Out out2 = make_out(fd2, s.store2, plane, bd, s.lo, ti, tj);
        for2d(ny, nx, [&](int r, int c) {
          const int y = Y0 + r, x = X0 + c;
          float cd[3], cs[3];
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const float a = fs.at(y - 1 + d, x - 1), b = fs.at(y - 1 + d, x),
                        e = fs.at(y - 1 + d, x + 1);
            cd[d] = __fsub_rn(e, a);
            cs[d] = __fadd_rn(__fadd_rn(a, e), __fmul_rn(2.0f, b));
          }
          out.put(bd, y, x, __fadd_rn(__fadd_rn(cd[0], __fmul_rn(2.0f, cd[1])), cd[2]));
          out2.put(bd, y, x, __fsub_rn(cs[2], cs[0]));
        });
        break;
      }
      case kGradPair: {
        const Frame fs2 = frame_of(fdesc[s.fs2], slots + s.src2 * slot_size, bd, ti, tj);
        for2d(ny, nx, [&](int r, int c) {
          const int y = Y0 + r, x = X0 + c;
          out.put(bd, y, x, pack(grad_pair(fs.at(y, x), fs2.at(y, x)), s.pk));
        });
        break;
      }
      case kThreshold:
      case kAffine:
        for2d(ny, nx, [&](int r, int c) {
          const int y = Y0 + r, x = X0 + c;
          out.put(bd, y, x, pack(pointwise(s.op, fs.at(y, x), wts), s.pk));
        });
        break;
      case kWarp:
      case kRemap: {
        // the source holds rows [sty - rh, sty + sth + rh) and columns
        // likewise: the bilinear taps clamp into them
        const float* mx = bd.maps[2 * s.wx];
        const float* my = bd.maps[2 * s.wx + 1];
        const LinRows rows{fs.p, fs.ld};
        const int rlo = sty - s.rh - fs.y0, rhi = sty + sth + s.rh - fs.y0;
        const int clo = stx - s.rw - fs.x0, chi = stx + stw + s.rw - fs.x0;
        for2d(ny, nx, [&](int r, int c) {
          const int y = Y0 + r, x = X0 + c;
          float sy, sx;
          if (s.op == kWarp)
            warp_coords(wts, y, x, sy, sx);
          else
            remap_coords(mx, my, bd.lh[s.ls], bd.lw[s.ls], y, x, sy, sx);
          out.put(bd, y, x, pack(bilinear_at(rows, sy, sx, fs.y0, fs.x0, rlo, rhi, clo, chi), s.pk));
        });
        break;
      }
      case kPyrUp: {
        // row pass: each output row's phase over the source columns its
        // outputs read -> tmp (output rows by source columns), then the
        // column phases
        const Frame tmp = make_frame(slots + s.tmp * slot_size, fd.y0, fd.y1, floor2(fd.x0) - 1,
                                     floor2(fd.x1 - 1) + 2);
        for2d(ny, tmp.x1 - tmp.x0, [&](int r, int c) {
          const int Y = Y0 + r, x = tmp.x0 + c, q = floor2(Y);
          const float b = fs.row(q)[x - fs.x0], e = fs.row(q + 1)[x - fs.x0];
          tmp.row(Y)[c] = (Y & 1) ? pyr_up_odd(b, e) : pyr_up_even(fs.row(q - 1)[x - fs.x0], b, e);
        });
        __syncthreads();
        for2d(ny, nx, [&](int r, int c) {
          const int Y = Y0 + r, X = X0 + c;
          const float* t = tmp.row(Y) + floor2(X) - tmp.x0;
          const float v = (X & 1) ? pyr_up_odd(t[0], t[1]) : pyr_up_even(t[-1], t[0], t[1]);
          out.put(bd, Y, X, pack(v, s.pk));
        });
        break;
      }
      case kPyrDown: {
        // a stride before the last stage: the row pass over the source rows
        // the output reads, at the image-even source columns of its columns
        // -> tmp (source rows by output columns), then the column pass
        const Frame tmp = make_frame(slots + s.tmp * slot_size, 2 * fd.y0 - hy,
                                     2 * (fd.y1 - 1) + hy + 1, fd.x0, fd.x1);
        for2d(tmp.y1 - tmp.y0, nx, [&](int r, int c) {
          const int q = tmp.y0 + r, x = 2 * (X0 + c);
          tmp.row(q)[c] = row_pass(kPyrDown, fs.row(q) + x - hx - fs.x0, wts, s.kw);
        });
        __syncthreads();
        for2d(ny, nx, [&](int r, int c) {
          const int Y = Y0 + r;
          const float v = col_pass(kPyrDown, tmp.row(2 * Y - hy) + c, tmp.ld, weights + s.wy, s.kh,
                                   wts[0]);
          out.put(bd, Y, X0 + c, pack(v, s.pk));
        });
        break;
      }
      case kResize2: {
        const LinRows rows{fs.p, fs.ld};
        for2d(ny, nx, [&](int r, int c) {
          const int Y = Y0 + r, X = X0 + c;
          out.put(bd, Y, X, pack(resize2_at(rows, 2 * Y - fs.y0, 2 * X - fs.x0), s.pk));
        });
        break;
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* in, const Bands& bd, const void* prog, int prog_bytes, int n, int h, int w,
           int tile_h, int tile_w, int slot_size, int n_slots, int threads, cudaStream_t stream) {
  const int tiles_x = (w + tile_w - 1) / tile_w;
  const int tiles_y = (h + tile_h - 1) / tile_h;
  const int prog_ints = prog_bytes / 4;
  const size_t smem = size_t((prog_ints + 3) & ~3) * 4 + size_t(n_slots) * slot_size * sizeof(float);
  // the kernel's attribute on this device, set when a launch needs more
  // shared memory than any before it there (setting it costs the host
  // microseconds a call)
  constexpr int kMaxDevices = 64;
  static int smem_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  int& set = smem_set[dev < kMaxDevices ? dev : 0];
  if (dev >= kMaxDevices || int(smem) > set) {
    err = cudaFuncSetAttribute(stencil_chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return int(err);
    set = int(smem);
  }
  const long long blocks = (long long)n * tiles_x * tiles_y;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL || threads > kMaxThreads) return int(cudaErrorInvalidConfiguration);
  stencil_chain_kernel<T><<<unsigned(blocks), threads, smem, stream>>>(
      static_cast<const T*>(in), bd, static_cast<const int*>(prog), prog_ints, n, h, w, slot_size,
      tiles_x, tiles_y);
  return int(cudaGetLastError());
}

}  // namespace

// The byte sizes of the program's header, frame and step records
// (exec_window.py checks them against its own).
extern "C" void stencil_chain_layout(int* out) {
  out[0] = int(sizeof(Header));
  out[1] = int(sizeof(FrameDesc));
  out[2] = int(sizeof(Step));
}

extern "C" int stencil_bands_bytes() { return int(sizeof(Bands)); }

// Launch on `stream` for u8 (u8 != 0) or f32 planes, tile_h x tile_w input
// tiles, the program of prog_bytes at `prog` (device memory), n_slots slots
// of slot_size floats; `bands` (host memory) names every output band's
// buffer, the remap stages' map planes and the levels' sizes.  Returns
// cudaGetLastError() after the launch (0 = ok).
extern "C" int stencil_chain_launch(const void* in, const void* bands, const void* prog,
                                    int prog_bytes, int n, int h, int w, int tile_h, int tile_w,
                                    int slot_size, int n_slots, int threads, int u8, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const Bands& bd = *static_cast<const Bands*>(bands);
  if (u8)
    return launch<uint8_t>(in, bd, prog, prog_bytes, n, h, w, tile_h, tile_w, slot_size, n_slots,
                           threads, st);
  return launch<float>(in, bd, prog, prog_bytes, n, h, w, tile_h, tile_w, slot_size, n_slots,
                       threads, st);
}
