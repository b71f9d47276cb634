// stencil_stream: a whole Stage chain over (N, H, W) u8 or f32 planes in one
// launch, carrying rows from step to step in shared-memory rings.
//
// Replaces src/repro/kernels/stencil/exec_streaming.py `streaming_kernel`
// (TPU, Pallas) in both its plans: "streaming" (one column tile of the full
// width) and "tiled2d" (column tiles from `plan.pick_tile_plan`).
//
// Bound on an H100: the paper's single ops and short chains on u8 images are
// bound by bytes (erode: 2 bytes a pixel against ~8 compares), a large
// filter2d by operations (k = 13: 338 FLOP a pixel, none of them contracted
// into an FMA, so the attainable floor is about twice the 67 TFLOP/s bound).
// Either way the kernel must not recompute what it computed once: the window
// kernel (stencil_chain.cu) recomputes every stage's halo in every 32x32
// block; here every stage computes each of its rows once per column tile.
//
// Algorithm: one block per (plane, column tile, row segment).  The block
// walks down its segment in steps of `rows` output rows.  Each stream (one
// band after one stage; stream 0 is the input) lives in a ring of `depth`
// rows of the tile's width plus the accumulated column halo, indexed by the
// absolute image row modulo the depth: rows are never copied, only the index
// moves.  Depths come from `plan.stream_layout`: `rows` plus the most any
// reader lags, i.e. a stage's 2*halo rows of carry, plus the delay of the tap
// stages a pass-through band crosses (its delay FIFO, held as extra depth of
// its own ring and read later rather than copied), plus an output band's
// lead over the rows stored.  Columns are recomputed per tile; only rows are
// carried.  The block primes its rings from the real rows above its
// segment: the first steps (i < 0) compute only the rows of each stream that
// lie at or below y0 - lead, so together they are the window pass of the
// JAX kernel's step 0, computed `rows` at a time in the steady-state rings.
// Reads are clamped at the image edge only (extended-domain borders).  The
// last step computes whole steps into the extended domain and stores only
// the rows inside the segment and the plane.
//
// Execution on Hopper:
//  * Rings hold the data's own dtype: stream 0 of a u8 chain and every
//    stream a stage packs to u8 are u8 rings (a quarter of the f32 bytes),
//    Sobel pairs, gathers' f32 sources and f32 chains are f32 rings.  Ring
//    rows start on 16-byte boundaries, with 16 bytes of slack after each
//    row (a strip's overhang reads it and discards what it computes there).
//  * The planner sizes a block so that at least two fit on an SM (shared
//    memory, threads, and __launch_bounds__ for the registers).
//  * Stream 0's rows arrive by cp.async: 16-byte copies where the plane's
//    row and the ring's row agree modulo 16, else 4-byte or single values;
//    rows are clamped through the coordinates and the columns past the
//    image's edges are filled from the edge column once the copies land.
//    With `ahead`, stream 0 has `mult` more rows of depth and a step's
//    loads are issued at the start of the step before it, so they fly
//    while that step computes; without it (when the deeper ring would keep
//    a second block off the SM), a step issues its successor's loads once
//    the last stage that reads stream 0 is done (`rd0`).
//  * filter2d (k = 3..13), the separable stages (sep 3..15; erode, dilate,
//    box 3..7) and the pointwise stages run register strips, specialised at
//    compile time on the kernel size: a thread takes up to 8 of a step's
//    rows at 4 adjacent columns, walks the source rows once, keeps the taps
//    (or a separable stage's row-pass results) in registers and needs no
//    scratch.  Every output keeps its products' and sums' order (row-major
//    taps, ascending, each rounded on its own).  Results go to the ring 4
//    values at a time, or straight to the band from registers (a final band
//    with lead 0), 4 bytes or 16 bytes a store where aligned.
//  * The other stage bodies (gathers, pyrUp, pyrDown, resize2, Sobel, the
//    pair reduction, grad, other kernel sizes, even taps) run the generic
//    path: a 2-D thread layout over the step's rows and columns, with ring
//    slots found from the step's oldest held row instead of a modulo, and
//    the taps' extents read at run time (an even k reads rows o - k/2 ..
//    o - k/2 + k - 1, within the rings' k/2 halo).
//  * The program (steps, streams, column pads, weights) is copied into the
//    front of the block's dynamic shared memory at the size the chain uses,
//    followed by each ring's offset and row stride; there is no fixed table,
//    and no static shared memory.
//  * A band held in a ring is stored after every step, 16 bytes a copy
//    where the ring row and the band row align.
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
// stencil_chain.cu, and strips that repeat them in the same order, so both
// kernels and the plain version agree bit for bit.

#include <type_traits>

#include "stencil_ops.cuh"

namespace {

using namespace stencil;

constexpr int kMaxThreads = 256;  // kernels/stencil/exec_streaming.py STREAM_THREADS
constexpr int kAlign = 16;        // ring rows and ring starts, in bytes
constexpr int kStripRows = 8;     // most rows of a register strip
constexpr int kStripCols = 4;     // columns of a register strip

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
  int strip;       // 1: the register-strip body of its op and kernel size
};

struct Stream {
  int depth;  // ring rows (0: never buffered); stream 0's without the rows loaded ahead
  int level;  // its level: the ring's row width is that level's frame
  int mult;   // rows it adds a step
  int lead;   // rows it runs ahead of a step's rows (and starts above a segment)
  int store;  // output band stored from this ring after every step, or -1
  int u8;     // 1: a u8 ring, else f32
};

// The program, as exec_streaming.py `StreamProgram.packed` lays it out: a
// header, one StreamStep per stage application, one Stream per stream, each
// level's column pad (ints), then the weights (floats).  Each block copies
// it into the front of its dynamic shared memory at the size the chain
// uses, followed by each ring's first byte and row stride.
struct Header {
  int n_steps, n_streams, n_levels, rows, prime;
  int rd0;  // the last step that reads stream 0 (n_steps: the stores read it)
  int n_weights, pad;
};

// Bytes of the table and the ring offsets before the rings (exec_streaming.py
// `StreamProgram.table_smem`), 16-byte aligned.
__host__ __device__ __forceinline__ int table_smem(int prog_ints, int n_streams) {
  return ((prog_ints + 2 * n_streams + 1) * 4 + kAlign - 1) / kAlign * kAlign;
}

__device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }
__device__ __forceinline__ int mod(int i, int d) {
  const int q = i % d;
  return q < 0 ? q + d : q;
}

// A u8 value as f32, exactly: 2^23 + v, less 2^23.
__device__ __forceinline__ float to_f32(uint8_t v) {
  return __fsub_rn(__int_as_float(0x4B000000 | v), 8388608.0f);
}
__device__ __forceinline__ float to_f32(float v) { return v; }

// A ring of one stream at one step: `base` is the oldest row it holds then
// and `bslot` that row's slot, so a row it holds finds its slot with one
// compare instead of a modulo (the rows a step reads and writes all lie in
// [base, base + depth)).
template <typename E>
struct Ring {
  E* p;
  int depth, ld;  // rows; row stride in values
  int base, bslot;
  __device__ __forceinline__ int at(int i) const {
    const int q = i - base + bslot;
    return q >= depth ? q - depth : q;
  }
  __device__ __forceinline__ int next(int q) const { return q + 1 == depth ? 0 : q + 1; }
  __device__ __forceinline__ E* ptr(int q) const { return p + q * ld; }
  __device__ __forceinline__ E* operator()(int i) const { return ptr(at(i)); }
};

// A ring in bytes, whichever its dtype.
struct RawRing {
  unsigned char* p;
  int depth, ld_bytes, base, bslot, u8;
  template <typename E>
  __device__ __forceinline__ Ring<E> as() const {
    return Ring<E>{reinterpret_cast<E*>(p), depth, ld_bytes / int(sizeof(E)), base, bslot};
  }
  __device__ __forceinline__ unsigned char* row(int i) const {
    const int q = i - base + bslot;
    return p + (q >= depth ? q - depth : q) * ld_bytes;
  }
  __device__ __forceinline__ void put(int i, int j, float v) const {
    if (u8)
      row(i)[j] = uint8_t(v);
    else
      reinterpret_cast<float*>(row(i))[j] = v;
  }
};

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One value, asynchronously where the copy unit takes it (4 bytes), else a
// plain load and store.
__device__ __forceinline__ void copy_one(float* d, const float* s) { cp_async4(d, s); }
__device__ __forceinline__ void copy_one(uint8_t* d, const uint8_t* s) { *d = *s; }

// Copy values [ja, jb) of a row from device memory at g to the ring row at d
// (16-byte aligned): 16-byte copies where both addresses can be aligned at
// once, else 4-byte copies (u8 rows whose addresses agree modulo 4), else
// one value at a time.  Threads stride over the copies.
template <typename T>
__device__ __forceinline__ void load_row(T* d, const T* g, int ja, int jb) {
  constexpr int V = kAlign / int(sizeof(T));
  const uintptr_t ga = reinterpret_cast<uintptr_t>(g);
  int v = 1;
  if ((ga & (kAlign - 1)) == 0)
    v = V;
  else if (sizeof(T) == 1 && (ga & 3) == 0)
    v = 4;
  const int a = min(jb, (ja + v - 1) / v * v), b = max(a, jb / v * v);
  for (int c = a + threadIdx.x * v; c < b; c += blockDim.x * v) {
    if (v == V)
      cp_async16(d + c, g + c);
    else if (v == 4)
      cp_async4(d + c, g + c);
    else
      copy_one(d + c, g + c);
  }
  const int n_head = a - ja;
  for (int t = threadIdx.x; t < n_head + (jb - b); t += blockDim.x) {
    const int c = t < n_head ? ja + t : b + t - n_head;
    copy_one(d + c, g + c);
  }
}

// ---------------------------------------------------------------------------
// Register strips
// ---------------------------------------------------------------------------

// What a strip body needs to know, passed by value to its (non-inlined)
// function: the source ring, the destination ring or output band, the
// weights, and the step's rows and columns.
struct Strip {
  RawRing src, dst;        // dst.p == nullptr: store straight to the band
  unsigned char* out;      // that band's plane at (row 0, column oxT)
  int out_u8, out_w;       // its dtype and row length
  const float* kx;         // taps (filter2d: row-major kh x kw) or scalars
  const float* ky;         // a separable stage's column taps
  int lo, hi, c0, c1;      // the step's output rows and frame columns
  int pk;                  // pack to u8
  int y0, y1, pwT, tw;     // direct stores: rows of the segment, columns of the tile
};

template <int OP>
__device__ __forceinline__ float strip_init() {
  return OP == kErode ? __int_as_float(0x7f800000) : OP == kDilate ? __int_as_float(0xff800000) : -0.0f;
}

// filter2d over output rows [r0, r0 + n) at frame columns [j, j + 4): for
// each source row (top to bottom), the K + 3 values it needs, then each
// output row's K taps of that source row.  -0 + p = p, so the first product
// starts each sum as it is; the taps of an output run row-major.
template <int K, typename TS>
__device__ __forceinline__ void filter2d_strip(const Ring<TS>& src, int r0, int n, int j,
                                               const float* k, float (&acc)[kStripRows][kStripCols]) {
  constexpr int H = K / 2;
  for (int s = 0; s < n + K - 1; ++s) {
    const TS* row = src(r0 - H + s) + j - H;
    float x[K + kStripCols - 1];
#pragma unroll
    for (int b = 0; b < K + kStripCols - 1; ++b) x[b] = to_f32(row[b]);
#pragma unroll
    for (int r = 0; r < kStripRows; ++r) {
      const int a = s - r;  // the tap row output row r takes from this source row
      if (r < n && a >= 0 && a < K) {
        const float* kr = k + a * K;
#pragma unroll
        for (int b = 0; b < K; ++b) {
          const float w = kr[b];
#pragma unroll
          for (int c = 0; c < kStripCols; ++c) acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(w, x[b + c]));
        }
      }
    }
  }
}

// A separable stage (sep, box, erode, dilate) over the same strip: each
// source row's row pass at the strip's 4 columns (row_pass's order), then
// its turn in the column pass of every output row that reads it (col_pass's
// order).  Box scales the column sum after it.
template <int OP, int K, typename TS>
__device__ __forceinline__ void sep_strip(const Ring<TS>& src, int r0, int n, int j, const float* kx,
                                          const float* ky, float (&acc)[kStripRows][kStripCols]) {
  constexpr int H = K / 2;
  for (int s = 0; s < n + K - 1; ++s) {
    const TS* row = src(r0 - H + s) + j - H;
    float x[K + kStripCols - 1];
#pragma unroll
    for (int b = 0; b < K + kStripCols - 1; ++b) x[b] = to_f32(row[b]);
    float rp[kStripCols];
#pragma unroll
    for (int c = 0; c < kStripCols; ++c) {
      float v = OP == kSep ? __fmul_rn(kx[0], x[c]) : x[c];
#pragma unroll
      for (int q = 1; q < K; ++q) {
        if (OP == kSep)
          v = __fadd_rn(v, __fmul_rn(kx[q], x[c + q]));
        else if (OP == kBox)
          v = __fadd_rn(v, x[c + q]);
        else if (OP == kErode)
          v = fminf(v, x[c + q]);
        else
          v = fmaxf(v, x[c + q]);
      }
      rp[c] = v;
    }
#pragma unroll
    for (int r = 0; r < kStripRows; ++r) {
      const int a = s - r;
      if (r < n && a >= 0 && a < K) {
        const float w = OP == kSep ? ky[a] : 0.0f;
#pragma unroll
        for (int c = 0; c < kStripCols; ++c) {
          if (OP == kSep)
            acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(w, rp[c]));
          else if (OP == kBox)
            acc[r][c] = __fadd_rn(acc[r][c], rp[c]);
          else if (OP == kErode)
            acc[r][c] = fminf(acc[r][c], rp[c]);
          else
            acc[r][c] = fmaxf(acc[r][c], rp[c]);
        }
      }
    }
  }
  if (OP == kBox) {
#pragma unroll
    for (int r = 0; r < kStripRows; ++r)
#pragma unroll
      for (int c = 0; c < kStripCols; ++c) acc[r][c] = __fmul_rn(acc[r][c], kx[0]);
  }
}

// Store output row `row` of a strip at frame columns [j, j + 4).
__device__ __forceinline__ void strip_emit(const Strip& a, int row, int j, const float (&v)[kStripCols]) {
  if (a.dst.p) {
    unsigned char* p = a.dst.row(row);
    const bool whole = j >= a.c0 && j + kStripCols <= a.c1;
    if (a.dst.u8) {
      if (whole) {
        *reinterpret_cast<uint32_t*>(p + j) = uint32_t(v[0]) | uint32_t(v[1]) << 8 |
                                              uint32_t(v[2]) << 16 | uint32_t(v[3]) << 24;
      } else {
#pragma unroll
        for (int c = 0; c < kStripCols; ++c)
          if (j + c >= a.c0 && j + c < a.c1) p[j + c] = uint8_t(v[c]);
      }
    } else {
      float* f = reinterpret_cast<float*>(p) + j;
      if (whole) {
        *reinterpret_cast<float4*>(f) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int c = 0; c < kStripCols; ++c)
          if (j + c >= a.c0 && j + c < a.c1) f[c] = v[c];
      }
    }
    return;
  }
  if (row < a.y0 || row >= a.y1) return;
  const int jl = max(j, a.pwT), jh = min(j + kStripCols, a.pwT + a.tw);
  if (jl >= jh) return;
  const long long at = (long long)row * a.out_w + (j - a.pwT);
  if (a.out_u8) {
    uint8_t* p = a.out + at;
    if (jl == j && jh == j + kStripCols && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
      *reinterpret_cast<uint32_t*>(p) = uint32_t(v[0]) | uint32_t(v[1]) << 8 |
                                        uint32_t(v[2]) << 16 | uint32_t(v[3]) << 24;
    } else {
      for (int c = jl - j; c < jh - j; ++c) p[c] = uint8_t(v[c]);
    }
  } else {
    float* p = reinterpret_cast<float*>(a.out) + at;
    if (jl == j && jh == j + kStripCols && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int c = jl - j; c < jh - j; ++c) p[c] = v[c];
    }
  }
}

// One strip stage over the step's rows [lo, hi) and frame columns [c0, c1):
// work items of (rows, 4 columns), with fewer rows an item while that
// still leaves half the block's threads idle.
template <int OP, int K, typename TS>
__device__ __noinline__ void strip_stage(const Strip a) {
  const Ring<TS> src = a.src.as<TS>();
  const int jA = a.c0 & ~(kStripCols - 1);
  const int groups = (a.c1 - jA + kStripCols - 1) / kStripCols;
  const int nr = a.hi - a.lo;
  int rs = kStripRows;
  while (rs > 2 && 2 * groups * ceil_div(nr, rs) <= int(blockDim.x)) rs >>= 1;
  const int items = groups * ceil_div(nr, rs);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int part = it / groups;
    const int j = jA + kStripCols * (it - part * groups);
    const int r0 = a.lo + part * rs, n = min(rs, a.hi - r0);
    float acc[kStripRows][kStripCols];
#pragma unroll
    for (int r = 0; r < kStripRows; ++r)
#pragma unroll
      for (int c = 0; c < kStripCols; ++c) acc[r][c] = strip_init<OP>();
    if (OP == kFilter2d) {
      filter2d_strip<K>(src, r0, n, j, a.kx, acc);
    } else if (OP == kThreshold || OP == kAffine) {
#pragma unroll
      for (int r = 0; r < kStripRows; ++r) {
        if (r < n) {
          const TS* x = src(r0 + r) + j;
#pragma unroll
          for (int c = 0; c < kStripCols; ++c) acc[r][c] = pointwise(OP, to_f32(x[c]), a.kx);
        }
      }
    } else {
      sep_strip<OP, K>(src, r0, n, j, a.kx, a.ky, acc);
    }
#pragma unroll
    for (int r = 0; r < kStripRows; ++r) {
      if (r < n) {
        float v[kStripCols];
#pragma unroll
        for (int c = 0; c < kStripCols; ++c) v[c] = pack(acc[r][c], a.pk);
        strip_emit(a, r0 + r, j, v);
      }
    }
  }
}

// The strip body of (op, k), for a source ring of TS; false if there is none
// (the planner marks only these as strips).
template <typename TS>
__device__ __forceinline__ bool run_strip(int op, int k, const Strip& a) {
#define STRIP_K(OP, KK) \
  case KK:              \
    strip_stage<OP, KK, TS>(a); \
    return true;
  switch (op) {
    case kFilter2d:
      switch (k) { STRIP_K(kFilter2d, 3) STRIP_K(kFilter2d, 5) STRIP_K(kFilter2d, 7)
                   STRIP_K(kFilter2d, 9) STRIP_K(kFilter2d, 11) STRIP_K(kFilter2d, 13) }
      break;
    case kSep:
      switch (k) { STRIP_K(kSep, 3) STRIP_K(kSep, 5) STRIP_K(kSep, 7) STRIP_K(kSep, 9)
                   STRIP_K(kSep, 11) STRIP_K(kSep, 13) STRIP_K(kSep, 15) }
      break;
    case kErode:
      switch (k) { STRIP_K(kErode, 3) STRIP_K(kErode, 5) STRIP_K(kErode, 7) }
      break;
    case kDilate:
      switch (k) { STRIP_K(kDilate, 3) STRIP_K(kDilate, 5) STRIP_K(kDilate, 7) }
      break;
    case kBox:
      switch (k) { STRIP_K(kBox, 3) STRIP_K(kBox, 5) STRIP_K(kBox, 7) }
      break;
    case kThreshold:
      switch (k) { STRIP_K(kThreshold, 1) }
      break;
    case kAffine:
      switch (k) { STRIP_K(kAffine, 1) }
      break;
  }
#undef STRIP_K
  return false;
}

// f(a, j) for rows a in [0, nr) and columns j in [c0, c1): the block as rows
// of nx column lanes (no division per value).
template <class F>
__device__ __forceinline__ void for2d(int nr, int c0, int c1, F&& f) {
  int nx = blockDim.x;
  while (nx > 32 && nx >= 2 * (c1 - c0)) nx >>= 1;
  const int tx = threadIdx.x % nx, ty = threadIdx.x / nx, ny = blockDim.x / nx;
  for (int a = ty; a < nr; a += ny)
    for (int j = c0 + tx; j < c1; j += nx) f(a, j);
}

// Copy n values from a ring row (16-byte aligned) at s to device memory at
// g: 16-byte copies where both can be aligned at once, else one at a time.
template <typename T>
__device__ __forceinline__ void store_row(T* g, const T* s, int n) {
  constexpr int V = kAlign / int(sizeof(T));
  const uintptr_t d = reinterpret_cast<uintptr_t>(g) - reinterpret_cast<uintptr_t>(s);
  if ((d & (kAlign - 1)) == 0) {
    // the first value of s whose address is 16-byte aligned
    const int a = min(n, int(((kAlign - (reinterpret_cast<uintptr_t>(s) & (kAlign - 1))) &
                               (kAlign - 1)) / sizeof(T)));
    const int b = a + (n - a) / V * V;
    for (int c = a + threadIdx.x * V; c < b; c += blockDim.x * V)
      *reinterpret_cast<uint4*>(g + c) = *reinterpret_cast<const uint4*>(s + c);
    for (int t = threadIdx.x; t < a + (n - b); t += blockDim.x) {
      const int c = t < a ? t : b + t - a;
      g[c] = s[c];
    }
  } else {
    for (int c = threadIdx.x; c < n; c += blockDim.x) g[c] = s[c];
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
    stencil_stream_kernel(const T* __restrict__ in, const Bands bd, const int* __restrict__ prog,
                          int prog_ints, int n, int h, int w, int tile_w, int tiles_x, int n_seg,
                          int seg_rows, int ahead) {
  extern __shared__ __align__(16) unsigned char smem_all[];
  int* table = reinterpret_cast<int*>(smem_all);
  for (int e = threadIdx.x; e < prog_ints; e += blockDim.x) table[e] = prog[e];
  __syncthreads();
  const Header sp = *reinterpret_cast<const Header*>(table);
  const StreamStep* steps = reinterpret_cast<const StreamStep*>(table + 8);
  const Stream* streams = reinterpret_cast<const Stream*>(table + 8 + 20 * sp.n_steps);
  const int* col_pads = table + 8 + 20 * sp.n_steps + 6 * sp.n_streams;
  const float* weights = reinterpret_cast<const float*>(col_pads + sp.n_levels);
  int* ring_at = table + prog_ints;           // each ring's first byte; then the scratch
  int* ring_ld = ring_at + sp.n_streams + 1;  // each ring's row stride in bytes
  unsigned char* smem = smem_all + table_smem(prog_ints, sp.n_streams);
  if (threadIdx.x == 0) {
    int at = kAlign;  // slack before the first ring
    for (int s = 0; s < sp.n_streams; ++s) {
      const Stream& st = streams[s];
      const int l = st.level;
      const int width = bd.tw[l] + 2 * col_pads[l];
      ring_ld[s] = (width * (st.u8 ? 1 : 4) + kAlign - 1) / kAlign * kAlign + kAlign;
      ring_at[s] = at;
      at += (st.depth + (s == 0 && ahead ? st.mult : 0)) * ring_ld[s];
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
  const int pwT = col_pads[last], tileT = bd.tw[last];
  const int tx0 = tile * tileT;                 // image column of the tile at the last level
  const int oxT = tx0 - pwT;                    // ... of its frame's column 0
  const int tw = min(tileT, bd.lw[last] - tx0);  // columns of this tile inside the band
  const int y0 = seg * seg_rows;                // segment rows at the last level
  const int y1 = min(y0 + seg_rows, bd.lh[last]);
  const int step0 = y0 / m;                     // the segment's first step of the plane
  const T* src_plane = in + plane * (size_t(h) * w);
  float* scratch = reinterpret_cast<float*>(smem + ring_at[sp.n_streams]);
  const int n_last = ceil_div(y1 - y0, m);

  auto width = [&](int l) { return bd.tw[l] + 2 * col_pads[l]; };
  auto origin = [&](int l) { return tile * bd.tw[l] - col_pads[l]; };
  // stream s's ring at step i
  auto ring = [&](int s, int i) {
    const Stream& st = streams[s];
    const int depth = st.depth + (s == 0 && ahead ? st.mult : 0);
    const int newest = (step0 + i + 1) * st.mult + st.lead - 1;
    const int base = newest - depth + 1;
    return RawRing{smem + ring_at[s], depth, ring_ld[s], base, mod(base, depth), st.u8};
  };
  // the rows [lo, hi) a stream adds at step i (lo >= hi: none yet)
  auto new_rows = [&](int mult, int lead, int i, int& lo, int& hi) {
    const int Y0 = step0 * mult;
    lo = max(Y0 + i * mult + lead, Y0 - lead);
    hi = Y0 + (i + 1) * mult + lead;
  };

  // stream 0: the plane's columns the frame holds, and its rows of a step
  const int W0 = width(0), ox0 = origin(0);
  const int ja = min(W0, max(0, -ox0)), jb = max(ja, min(W0, w - ox0));
  const int D0 = streams[0].depth + (ahead ? streams[0].mult : 0);
  T* const r0p = reinterpret_cast<T*>(smem + ring_at[0]);
  const int ld0 = ring_ld[0] / int(sizeof(T));
  auto issue = [&](int i) {
    int lo, hi;
    new_rows(streams[0].mult, streams[0].lead, i, lo, hi);
    for (int r = lo; r < hi; ++r) {
      const T* g = src_plane + size_t(min(max(r, 0), h - 1)) * w + ox0;
      load_row(r0p + mod(r, D0) * ld0, g, ja, jb);
    }
  };
  auto edges = [&](int i) {  // the columns past the image's edges, from the edge column
    int lo, hi;
    new_rows(streams[0].mult, streams[0].lead, i, lo, hi);
    const int nl = ja, nrt = W0 - jb;
    for2d(max(0, hi - lo), 0, nl + nrt, [&](int a, int t) {
      T* row = r0p + mod(lo + a, D0) * ld0;
      row[t < nl ? t : jb + t - nl] = row[t < nl ? ja : jb - 1];
    });
  };

  issue(-sp.prime);
  for (int i = -sp.prime; i < n_last; ++i) {
    cp_async_wait_all();
    __syncthreads();
    if (ja > 0 || jb < W0) {
      edges(i);
      __syncthreads();
    }
    if (ahead && i + 1 < n_last) issue(i + 1);

    for (int si = 0; si < sp.n_steps; ++si) {
      const StreamStep s = steps[si];
      // the destination stream's new rows [lo, hi) at this step, at its level
      int lo, hi;
      new_rows(s.mult, s.lead, i, lo, hi);
      if (lo < hi) {
        const RawRing sr = ring(s.src, i);
        const RawRing dr = s.dst < 0 ? RawRing{nullptr, 1, 0, 0, 0, 0} : ring(s.dst, i);
        const int pw = col_pads[s.lo];
        const int c0 = pw - s.cw, c1 = pw + bd.tw[s.lo] + s.cw;  // output columns
        const float* wts = weights + s.wx;
        bool done = false;
        if (s.strip) {
          Strip a;
          a.src = sr;
          a.dst = dr;
          a.out = nullptr;
          a.out_u8 = a.out_w = 0;
          if (s.dst < 0) {
            a.out_u8 = bd.u8[s.store];
            a.out_w = bd.w[s.store];
            const size_t at = (size_t(plane) * bd.h[s.store]) * bd.w[s.store] + oxT + pwT;
            a.out = static_cast<unsigned char*>(bd.out[s.store]) + at * (a.out_u8 ? 1 : 4);
          }
          a.kx = wts;
          a.ky = weights + s.wy;
          a.lo = lo, a.hi = hi, a.c0 = c0, a.c1 = c1, a.pk = s.pk;
          a.y0 = y0, a.y1 = y1, a.pwT = pwT, a.tw = tw;
          done = sr.u8 ? run_strip<uint8_t>(s.op, s.kh, a) : run_strip<float>(s.op, s.kh, a);
        }
        if (!done) {
          auto generic = [&](auto tag) {
            using TS = typename std::remove_pointer<decltype(tag)>::type;
            const Ring<TS> src = sr.as<TS>();
            const int hy = s.kh / 2, hx = s.kw / 2;
            const int WWd = width(s.lo), oxd = origin(s.lo);
            const int WWs = width(s.ls), ox = origin(s.ls);
            const int nr = hi - lo;
            const RawRing dr2 = s.dst2 < 0 ? RawRing{nullptr, 1, 0, 0, 0, 0} : ring(s.dst2, i);

            // write v (packed) to the destination ring, or store it when the
            // band is final and stored straight from registers
            auto put = [&](const RawRing& d, int b, int r, int j, float v) {
              if (d.p) {
                d.put(r, j, v);
              } else if (r >= y0 && r < y1 && j >= pwT && j < pwT + tw) {
                store_band(bd, b, plane, r, oxT + j, v);
              }
            };

            if (s.op == kPyrUp) {
              // row pass: each output row's phase over the source columns the
              // outputs read -> scratch (the step's rows at the source's
              // width), then the column pass
              const int x0 = floor2(oxd + c0) - 1 - ox, x1 = floor2(oxd + c1 - 1) + 2 - ox;
              for2d(nr, x0, x1, [&](int a, int x) {
                const int Y = lo + a, y = floor2(Y);
                const float b = to_f32(src(y)[x]), c = to_f32(src(y + 1)[x]);
                scratch[a * WWs + x] =
                    (Y & 1) ? pyr_up_odd(b, c) : pyr_up_even(to_f32(src(y - 1)[x]), b, c);
              });
              __syncthreads();
              for2d(nr, c0, c1, [&](int a, int j) {
                const int X = oxd + j, q = floor2(X) - ox;
                const float* r = scratch + a * WWs;
                const float v =
                    (X & 1) ? pyr_up_odd(r[q], r[q + 1]) : pyr_up_even(r[q - 1], r[q], r[q + 1]);
                put(dr, s.store, lo + a, j, pack(v, s.pk));
              });
            } else if (s.op == kPyrDown && s.down == 1) {
              // a stride before the last stage: the row pass over source rows
              // [2 lo - hy, 2 (hi - 1) + hy] at the image-even source columns
              // of the output's columns -> scratch, then the column pass
              const int ra = 2 * lo - hy, na = 2 * (nr - 1) + 2 * hy + 1;
              for2d(na, c0, c1, [&](int a, int j) {
                const int x = 2 * (oxd + j) - ox;
                scratch[a * WWd + j] = row_pass(s.op, src(ra + a) + x - hx, wts, s.kw);
              });
              __syncthreads();
              for2d(nr, c0, c1, [&](int a, int j) {
                const float v = col_pass(s.op, scratch + 2 * a * WWd + j, WWd,
                                         weights + s.wy, s.kh, wts[0]);
                put(dr, s.store, lo + a, j, pack(v, s.pk));
              });
            } else if (s.op == kResize2 && s.down == 1) {
              for2d(nr, c0, c1, [&](int a, int j) {
                const int r = lo + a;
                const float v = resize2_at(src, 2 * r, 2 * (oxd + j) - ox);
                put(dr, s.store, r, j, pack(v, s.pk));
              });
            } else if (s.op == kPyrDown) {
              // the chain's last stage: the row pass over rows [lo - hy, hi +
              // hy) at the image-even columns -> scratch, then the column pass
              // at the image-even rows, stored to the decimated band
              const int j0 = first_even(c0, ox), ecols = (c1 - j0 + 1) / 2;
              const int ry0 = first_even(lo, 0), erows = (hi - ry0 + 1) / 2;
              for2d(nr + 2 * hy, 0, ecols, [&](int a, int e) {
                const int j = j0 + 2 * e;
                scratch[a * WWs + j] = row_pass(s.op, src(lo - hy + a) + j - hx, wts, s.kw);
              });
              __syncthreads();
              for2d(erows, 0, ecols, [&](int a, int e) {
                const int r = ry0 + 2 * a, j = j0 + 2 * e, x = ox + j;
                if (r >= y0 && r < y1 && x >= tx0 && x < tx0 + tw && r / 2 < bd.h[s.store] &&
                    x / 2 < bd.w[s.store]) {
                  const float v = col_pass(s.op, scratch + (r - lo) * WWs + j, WWs,
                                           weights + s.wy, s.kh, wts[0]);
                  store_band(bd, s.store, plane, r / 2, x / 2, pack(v, s.pk));
                }
              });
            } else if (s.op == kResize2) {
              // the chain's last stage: 2x2 means at the image-even rows and
              // columns, stored to the decimated band (floor size)
              const int j0 = first_even(c0, ox), ecols = (c1 - j0) / 2;
              const int ry0 = first_even(lo, 0), erows = (hi - ry0) / 2;
              for2d(erows, 0, ecols, [&](int a, int e) {
                const int r = ry0 + 2 * a, j = j0 + 2 * e, x = ox + j;
                if (r >= y0 && r < y1 && x >= tx0 && x < tx0 + tw && r / 2 < bd.h[s.store] &&
                    x / 2 < bd.w[s.store])
                  store_band(bd, s.store, plane, r / 2, x / 2, pack(resize2_at(src, r, j), s.pk));
              });
            } else if (separable(s.op)) {
              // a kernel size without a strip: row pass over rows [lo - hy,
              // hi + hy) -> scratch, then column pass
              for2d(nr + 2 * hy, c0, c1, [&](int a, int j) {
                scratch[a * WWs + j] = row_pass(s.op, src(lo - hy + a) + j - hx, wts, s.kw);
              });
              __syncthreads();
              for2d(nr, c0, c1, [&](int a, int j) {
                const float v = col_pass(s.op, scratch + a * WWs + j, WWs, weights + s.wy,
                                         s.kh, wts[0]);
                put(dr, s.store, lo + a, j, pack(v, s.pk));
              });
            } else if (s.op == kSobel) {
              for2d(nr, c0, c1, [&](int a, int j) {
                float dx, dy;
                sobel_at(src, lo + a, j, dx, dy);
                put(dr, s.store, lo + a, j, dx);
                put(dr2, s.store2, lo + a, j, dy);
              });
            } else if (s.op == kWarp || s.op == kRemap) {
              // the source ring holds rows [lo - hy, hi + hy) and columns
              // [c0 - hx, c1 + hx); coordinates are absolute image ones
              const float* mx = bd.maps[2 * s.wx];
              const float* my = bd.maps[2 * s.wx + 1];
              for2d(nr, c0, c1, [&](int a, int j) {
                const int r = lo + a;
                float sy, sx;
                if (s.op == kWarp)
                  warp_coords(wts, r, ox + j, sy, sx);
                else
                  remap_coords(mx, my, bd.lh[s.ls], bd.lw[s.ls], r, ox + j, sy, sx);
                const float v =
                    bilinear_at(src, sy, sx, 0, ox, lo - hy, hi + hy, c0 - hx, c1 + hx);
                put(dr, s.store, r, j, pack(v, s.pk));
              });
            } else if (s.op == kFilter2d || s.op == kGrad) {
              for2d(nr, c0, c1, [&](int a, int j) {
                const int r = lo + a;
                const float v = s.op == kGrad ? grad_at(src, r, j)
                                              : filter2d_at(src, r - hy, j - hx, wts, s.kh, s.kw);
                put(dr, s.store, r, j, pack(v, s.pk));
              });
            } else if (s.op == kGradPair) {
              const RawRing sr2 = ring(s.src2, i);
              const Ring<float> src2 = sr2.as<float>();
              for2d(nr, c0, c1, [&](int a, int j) {
                const int r = lo + a;
                put(dr, s.store, r, j, pack(grad_pair(to_f32(src(r)[j]), src2(r)[j]), s.pk));
              });
            } else {
              for2d(nr, c0, c1, [&](int a, int j) {
                const int r = lo + a;
                put(dr, s.store, r, j, pack(pointwise(s.op, to_f32(src(r)[j]), wts), s.pk));
              });
            }
          };
          if (sr.u8)
            generic(static_cast<uint8_t*>(nullptr));
          else
            generic(static_cast<float*>(nullptr));
        }
        __syncthreads();
      }
      // without `ahead`, the next step's input rows start once the last
      // stage that reads stream 0 is done
      if (!ahead && si == sp.rd0 && i + 1 < n_last) issue(i + 1);
    }

    // output bands held in rings: store this step's rows inside the segment
    if (i >= 0) {
      const int lo = y0 + i * m, hi = min(lo + m, y1);
      bool any = false;
      for (int k = 0; k < sp.n_streams; ++k) {
        const Stream& st = streams[k];
        if (st.store < 0 || st.depth == 0) continue;
        any = true;
        const RawRing rr = ring(k, i);
        const int b = st.store;
        for (int r = lo; r < hi; ++r) {
          const size_t at = (size_t(plane) * bd.h[b] + r) * bd.w[b] + tx0;
          if (st.u8)
            store_row(static_cast<uint8_t*>(bd.out[b]) + at, rr.row(r) + pwT, tw);
          else
            store_row(static_cast<float*>(bd.out[b]) + at,
                      reinterpret_cast<const float*>(rr.row(r)) + pwT, tw);
        }
      }
      if (any) __syncthreads();
    }
    if (!ahead && sp.rd0 >= sp.n_steps && i + 1 < n_last) issue(i + 1);
  }
}

template <typename T>
int launch(const void* in, const Bands& bd, const void* prog, int prog_bytes, int n, int h, int w,
           int tile_w, int n_seg, int seg_rows, int smem_bytes, int threads, int ahead,
           cudaStream_t stream) {
  const int tiles_x = (w + tile_w - 1) / tile_w;
  // the kernel's attributes on this device, set when a launch needs more
  // shared memory than any before it there (setting them costs the host
  // microseconds a call)
  constexpr int kMaxDevices = 64;
  static int smem_set[kMaxDevices];
  int dev = 0;
  cudaError_t derr = cudaGetDevice(&dev);
  if (derr != cudaSuccess) return int(derr);
  int& set = smem_set[dev < kMaxDevices ? dev : 0];
  if (dev >= kMaxDevices || smem_bytes > set) {
    cudaError_t err = cudaFuncSetAttribute(
        stencil_stream_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return int(err);
    err = cudaFuncSetAttribute(stencil_stream_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               int(cudaSharedmemCarveoutMaxShared));
    if (err != cudaSuccess) return int(err);
    set = smem_bytes;
  }
  const long long blocks = (long long)n * tiles_x * n_seg;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  if (threads > kMaxThreads) return int(cudaErrorInvalidConfiguration);
  stencil_stream_kernel<T><<<unsigned(blocks), threads, smem_bytes, stream>>>(
      static_cast<const T*>(in), bd, static_cast<const int*>(prog), prog_bytes / 4, n, h, w,
      tile_w, tiles_x, n_seg, seg_rows, ahead);
  return int(cudaGetLastError());
}

}  // namespace

// The byte sizes of the program's header, step and stream records
// (exec_streaming.py checks them against its own).
extern "C" void stencil_stream_layout(int* out) {
  out[0] = int(sizeof(Header));
  out[1] = int(sizeof(StreamStep));
  out[2] = int(sizeof(Stream));
}

extern "C" int stencil_bands_bytes() { return int(sizeof(Bands)); }

// The kernel's static shared memory (none: the table and the ring offsets
// are dynamic, sized per chain); -1 on an error.
extern "C" int stencil_stream_static_bytes(int u8) {
  cudaFuncAttributes a;
  const cudaError_t err = u8 ? cudaFuncGetAttributes(&a, stencil_stream_kernel<uint8_t>)
                             : cudaFuncGetAttributes(&a, stencil_stream_kernel<float>);
  return err == cudaSuccess ? int(a.sharedSizeBytes) : -1;
}

// Launch on `stream` for u8 (u8 != 0) or f32 planes, the program of
// prog_bytes at `prog` (device memory), column tiles of tile_w input
// columns, n_seg segments of seg_rows rows (at the chain's last level) a
// plane, smem_bytes of table, rings and scratch a block, stream 0's rows
// loaded a step ahead when `ahead`; `bands` (host memory) names every output band's
// buffer, the remap stages' map planes and the levels' sizes.  Returns
// cudaGetLastError() after the launch (0 = ok).
extern "C" int stencil_stream_launch(const void* in, const void* bands, const void* prog,
                                     int prog_bytes, int n, int h, int w, int tile_w, int n_seg,
                                     int seg_rows, int smem_bytes, int threads, int u8, int ahead,
                                     void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const Bands& bd = *static_cast<const Bands*>(bands);
  if (u8)
    return launch<uint8_t>(in, bd, prog, prog_bytes, n, h, w, tile_w, n_seg, seg_rows, smem_bytes,
                           threads, ahead, st);
  return launch<float>(in, bd, prog, prog_bytes, n, h, w, tile_w, n_seg, seg_rows, smem_bytes,
                       threads, ahead, st);
}
