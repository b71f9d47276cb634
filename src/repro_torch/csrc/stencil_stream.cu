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
// A pyrDown runs only as the chain's last stage, planned at full resolution:
// its step computes the row pass at the image-even columns of the tile and
// the column pass at the image-even rows among the step's rows, and stores
// them straight to the half-resolution output (`out_half`).  Step rows,
// segment starts and column tiles are even, so the steps of a segment and
// the segments of a plane cover disjoint half-resolution rows.
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
  int src, dst;    // streams; dst -1: store straight to output band `store`
  int kh, kw;      // stencil extents (halo = k / 2)
  int wx, wy;      // offsets of taps or scalars in weights[]
  int rw;          // column halo the source stream still carries
  int lead;        // rows the destination stream runs ahead of the output rows
  int store;       // output band of a direct store, else -1
  int down;        // 2: a pyrDown, stored directly to out_half[store]
};

struct Stream {
  int depth;   // ring rows (0: never buffered)
  int offset;  // first ring row in shared memory, in rows of the tile's width
  int store;   // output band stored from this ring after every step, or -1
};

struct StreamProgram {
  int n_steps, n_streams, ph, pw, rows, scratch, pad[2];
  StreamStep steps[kMaxSteps];
  Stream streams[kMaxStreams];
  float weights[kMaxWeights];
};

__device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T>
__global__ void stencil_stream_kernel(const T* __restrict__ in, T* __restrict__ out,
                                      T* __restrict__ out_half,
                                      const StreamProgram* __restrict__ prog, int n, int h, int w,
                                      int tile_w, int tiles_x, int n_seg, int seg_rows) {
  __shared__ StreamProgram sp;
  extern __shared__ float smem[];
  constexpr bool u8 = sizeof(T) == 1;

  {
    const int* from = reinterpret_cast<const int*>(prog);
    int* to = reinterpret_cast<int*>(&sp);
    for (int e = threadIdx.x; e < int(sizeof(StreamProgram) / sizeof(int)); e += blockDim.x)
      to[e] = from[e];
  }
  __syncthreads();

  const int ph = sp.ph, pw = sp.pw, m = sp.rows;
  const int WW = tile_w + 2 * pw;
  const int per_plane = tiles_x * n_seg;
  const int plane = blockIdx.x / per_plane;
  const int rem = blockIdx.x - plane * per_plane;
  const int tile = rem / n_seg;
  const int seg = rem - tile * n_seg;
  const int tx0 = tile * tile_w;
  const int tw = min(tile_w, w - tx0);  // columns of this tile inside the plane
  const int y0 = seg * seg_rows;
  const int y1 = min(y0 + seg_rows, h);
  const size_t plane_size = size_t(h) * w;
  const T* src_plane = in + plane * plane_size;
  float* scratch = smem + sp.scratch * WW;

  auto ring = [&](int s) {
    const Stream& st = sp.streams[s];
    return RingRows{smem + st.offset * WW, st.depth, WW};
  };

  for (int i = -ceil_div(2 * ph, m); i < ceil_div(y1 - y0, m); ++i) {
    // stream 0: the input rows this step adds, read with clamped coordinates
    {
      const RingRows r0 = ring(0);
      const int lo = max(y0 + i * m + ph, y0 - ph), hi = y0 + (i + 1) * m + ph;
      for (int e = threadIdx.x; e < (hi - lo) * WW; e += blockDim.x) {
        const int r = lo + e / WW, j = e % WW;
        const int y = min(max(r, 0), h - 1);
        const int x = min(max(tx0 - pw + j, 0), w - 1);
        r0(r)[j] = load_f32(src_plane + size_t(y) * w + x);
      }
      __syncthreads();
    }

    for (int si = 0; si < sp.n_steps; ++si) {
      const StreamStep s = sp.steps[si];
      // the destination stream's new rows [lo, hi) at this step
      const int lo = max(y0 + i * m + s.lead, y0 - s.lead), hi = y0 + (i + 1) * m + s.lead;
      if (lo >= hi) continue;  // not primed this far yet (uniform across the block)
      const RingRows src = ring(s.src);
      const int hy = s.kh / 2, hx = s.kw / 2;
      const int c0 = pw - s.rw + hx, c1 = pw + tile_w + s.rw - hx;  // output columns
      const int cols = c1 - c0, nr = hi - lo;
      const float* wts = sp.weights + s.wx;
      T* ob = s.dst < 0 ? out + (size_t(s.store) * n + plane) * plane_size : nullptr;
      const RingRows dst = s.dst < 0 ? RingRows{nullptr, 1, 0} : ring(s.dst);

      auto put = [&](int r, int j, float v) {
        v = pack(v, u8);
        if (s.dst >= 0) {
          dst(r)[j] = v;
        } else if (r >= y0 && r < y1 && j >= pw && j < pw + tw) {
          store_val(ob + size_t(r) * w + tx0 + j - pw, v);
        }
      };

      if (s.down > 1) {
        // pyrDown, the chain's last stage: the row pass over rows
        // [lo - hy, hi + hy) at the image-even columns -> scratch, then the
        // column pass at the image-even rows, stored to the half-size band
        const int ox = tx0 - pw;  // image column of local column 0
        const int j0 = first_even(c0, ox), ocols = (c1 - j0 + 1) / 2;
        const int ry0 = first_even(lo, 0), orows = (hi - ry0 + 1) / 2;
        for (int e = threadIdx.x; e < (nr + 2 * hy) * ocols; e += blockDim.x) {
          const int a = e / ocols, j = j0 + 2 * (e % ocols);
          scratch[a * WW + j] = row_pass(s.op, src(lo - hy + a) + j - hx, wts, s.kw);
        }
        __syncthreads();
        const int hh = (h + 1) / 2, hw = (w + 1) / 2;
        T* oh = out_half + (size_t(s.store) * n + plane) * (size_t(hh) * hw);
        for (int e = threadIdx.x; e < orows * ocols; e += blockDim.x) {
          const int r = ry0 + 2 * (e / ocols), j = j0 + 2 * (e % ocols), x = ox + j;
          if (r >= y0 && r < y1 && x >= tx0 && x < tx0 + tw) {
            const float v = col_pass(s.op, scratch + (r - lo) * WW + j, WW, sp.weights + s.wy,
                                     s.kh, wts[0]);
            store_val(oh + size_t(r / 2) * hw + x / 2, pack(v, u8));
          }
        }
      } else if (separable(s.op)) {
        // row pass over rows [lo - hy, hi + hy) -> scratch, then column pass
        for (int e = threadIdx.x; e < (nr + 2 * hy) * cols; e += blockDim.x) {
          const int a = e / cols, j = c0 + e % cols;
          scratch[a * WW + j] = row_pass(s.op, src(lo - hy + a) + j - hx, wts, s.kw);
        }
        __syncthreads();
        for (int e = threadIdx.x; e < nr * cols; e += blockDim.x) {
          const int a = e / cols, j = c0 + e % cols;
          put(lo + a, j, col_pass(s.op, scratch + a * WW + j, WW, sp.weights + s.wy, s.kh, wts[0]));
        }
      } else if (s.op == kFilter2d || s.op == kGrad) {
        for (int e = threadIdx.x; e < nr * cols; e += blockDim.x) {
          const int r = lo + e / cols, j = c0 + e % cols;
          put(r, j, s.op == kGrad ? grad_at(src, r, j)
                                  : filter2d_at(src, r - hy, j - hx, wts, s.kh, s.kw));
        }
      } else {
        for (int e = threadIdx.x; e < nr * cols; e += blockDim.x) {
          const int r = lo + e / cols, j = c0 + e % cols;
          put(r, j, pointwise(s.op, src(r)[j], wts));
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
        T* ob = out + (size_t(st.store) * n + plane) * plane_size;
        for (int e = threadIdx.x; e < (hi - lo) * tw; e += blockDim.x) {
          const int r = lo + e / tw, j = e % tw;
          store_val(ob + size_t(r) * w + tx0 + j, rr(r)[pw + j]);
        }
      }
      __syncthreads();
    }
  }
}

template <typename T>
int launch(const void* in, void* out, void* out_half, const void* prog, int n, int h, int w,
           int tile_w, int n_seg, int seg_rows, int smem_rows, int pw, int threads,
           cudaStream_t stream) {
  const int tiles_x = (w + tile_w - 1) / tile_w;
  const size_t smem = size_t(smem_rows) * (tile_w + 2 * pw) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(stencil_stream_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const long long blocks = (long long)n * tiles_x * n_seg;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  stencil_stream_kernel<T><<<unsigned(blocks), threads, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), static_cast<T*>(out_half),
      static_cast<const StreamProgram*>(prog), n, h, w, tile_w, tiles_x, n_seg, seg_rows);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int stencil_stream_program_bytes() { return int(sizeof(StreamProgram)); }

// Launch on `stream` for u8 (u8 != 0) or f32 planes; `out` holds the
// full-resolution bands, `out_half` the bands a pyrDown made.  Returns
// cudaGetLastError() after the launch (0 = ok).
extern "C" int stencil_stream_launch(const void* in, void* out, void* out_half, const void* prog,
                                     int n, int h, int w, int tile_w, int n_seg, int seg_rows,
                                     int smem_rows, int pw, int threads, int u8, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (u8)
    return launch<uint8_t>(in, out, out_half, prog, n, h, w, tile_w, n_seg, seg_rows, smem_rows,
                           pw, threads, st);
  return launch<float>(in, out, out_half, prog, n, h, w, tile_w, n_seg, seg_rows, smem_rows, pw,
                       threads, st);
}
