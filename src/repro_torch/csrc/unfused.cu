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
// seed_erode has the same shape of problem and the same design, on packed
// bytes.  One block of 128 threads per 16 x 128 output tile (512x512 is 128
// blocks: one wave on 132 SMs).  The window (the tile's rows +- r, clamped,
// by 16 columns either side for r <= 16, 32 for the generic body) is copied
// as 16-byte segments exactly as the blur's, every load issued before the
// first shared store; one barrier.  A thread then owns a 16-byte output
// strip: it takes the min over 2r+1 window rows of the strip's 4 words and
// ceil(r/4) halo words either side (__vminu4: 4 pixels an instruction),
// then the min over 2r+1 columns, each shift by s bytes formed from two
// neighbouring words by __byte_perm, and stores the strip as one 16-byte
// word where aligned and inside the plane (else byte by byte).  No
// division per element, no second barrier.  A kernel per r = 0..3, every
// loop unrolled; larger r share three generic bodies that read r at run
// time, their window and loops sized for r <= 8, 16 or 32 (steps outside
// [-r, r] predicated off).  Static shared memory: 16 x 128 B at r = 0,
// (16 + 2r) x 160 B at r = 1..3 (3,520 B at r = 3), 32 x 160 and 48 x 160
// B for the bodies of r <= 8 and 16, 80 x 192 = 15,360 B for r <= 32, so
// no launch sets a dynamic-memory attribute.  At 128 threads a block an SM
// holds 16 blocks by threads; ptxas gives 32-44 registers to r = 0..3 (a
// block 5.6 K of the SM's 64 K), 56 to the r <= 32 body, whose shared
// memory allows 14.  Bound: bytes, 2 x 262,144 B at 3.35 TB/s = 0.000157 ms
// for 512x512, far below a launch.
//
// seed_threshold: 16 pixels a thread, one 16-byte load, __vcmpgtu4 on each
// word against t8 in every byte (0xFF where x > t8, unsigned), ANDed with
// maxval8 in every byte, one 16-byte store: 256 threads a block, 64 blocks
// at 512x512 (one wave).  The plane is split at the input's 16-byte
// boundaries (a plane may be a view at any byte offset): the head before
// the first and the tail after the last whole vector go byte by byte, by
// the block's first threads, in the same launch; where the output's
// alignment differs from the input's, the vector's bytes are stored as 4
// words or 16 bytes.  Same bound as the erode.
//
// Arithmetic, which the plain versions (kernels/unfused.py) repeat bit for
// bit: the blur widens to f32, runs the row pass (taps left to right), then
// the column pass (taps top to bottom), each product and sum rounded on its
// own (the order of stencil_ops.cuh's row_pass / col_pass, shared with the
// fused kernels), then rounds half to even (rintf, as jnp.round) and
// saturates to [0, 255].  Erosion is a min over 2r+1 rows, then over 2r+1
// columns, on u8 (a min is exact, so the packed order gives the same bytes).  The threshold compares the u8 value with `thresh` cast
// to u8 on the host (truncated toward zero, then wrapped modulo 256, as XLA
// casts it): it does not share the fused threshold stage's f32 compare.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "stencil_ops.cuh"

namespace {

// seed_erode's block (kernels/unfused.py ERODE_ROWS, ERODE_COLS,
// ERODE_THREADS, ERODE_MAX_R): output rows and columns of a tile, threads
// (one 16-byte output strip each), the largest radius
constexpr int kErodeRows = 16;
constexpr int kErodeCols = 128;
constexpr int kErodeThreads = 128;
constexpr int kErodeMaxR = 32;
constexpr int kErodeStrips = kErodeCols / 16;  // 16-byte strips of a tile row
// seed_threshold's block (kernels/unfused.py THRESH_THREADS): one uint4 a thread
constexpr int kThreshThreads = 256;
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

// The 16 bytes of a window segment: one 16-byte load where the segment lies
// inside the plane at a 16-byte aligned address, else byte by byte with the
// columns clamped to the plane (the edge-replicate border).
__device__ __forceinline__ uint4 load_segment(const uint8_t* __restrict__ row, int gx, int w) {
  if (gx >= 0 && gx + 16 <= w && (reinterpret_cast<uintptr_t>(row + gx) & 15) == 0)
    return *reinterpret_cast<const uint4*>(row + gx);
  uint32_t v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[q] = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) v[q] |= uint32_t(row[clampi(gx + 4 * q + b, 0, w - 1)]) << (8 * b);
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// Words -HW .. 3 + HW of a strip from one window row (p: the strip's first
// byte, 16-byte aligned), v[j + HW] = bytes 4j .. 4j + 3: whole segments as
// one 16-byte load, the edge words of a partial segment one by one.
template <int HW>
__device__ __forceinline__ void strip_words(const uint8_t* p, uint32_t (&v)[4 + 2 * HW]) {
  constexpr int S0 = -((HW + 3) / 4), S1 = (3 + HW) / 4;
#pragma unroll
  for (int s = S0; s <= S1; ++s) {
    if (4 * s >= -HW && 4 * s + 3 <= 3 + HW) {
      const uint4 q = *reinterpret_cast<const uint4*>(p + 16 * s);
      v[4 * s + HW] = q.x;
      v[4 * s + HW + 1] = q.y;
      v[4 * s + HW + 2] = q.z;
      v[4 * s + HW + 3] = q.w;
    } else {
#pragma unroll
      for (int o = 0; o < 4; ++o)
        if (4 * s + o >= -HW && 4 * s + o <= 3 + HW)
          v[4 * s + o + HW] = *reinterpret_cast<const uint32_t*>(p + 16 * s + 4 * o);
    }
  }
}

// One block per kErodeRows x kErodeCols output tile.  R >= 0: the radius,
// every loop unrolled; R < 0: a generic body, r (<= RM) read at run time,
// its window and loops sized for RM.  The window (the tile's rows +- r, clamped, by PAD columns
// either side in whole 16-byte segments) goes to shared memory, then one
// barrier; a thread owns a 16-byte output strip: the min over 2r+1 rows of
// the strip's words and HW halo words either side (__vminu4, 4 pixels an
// instruction), then over 2r+1 columns, each shift by s bytes formed from
// two neighbouring words by __byte_perm, and one 16-byte store.
template <int R, int RM = R>
__global__ void __launch_bounds__(kErodeThreads)
    seed_erode_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int h, int w,
                      int r_arg) {
  static_assert((R >= 0 && RM == R) || (R < 0 && RM > 0 && RM <= kErodeMaxR), "radius");
  constexpr int PAD = (RM + 15) / 16 * 16;     // window columns either side of the tile
  constexpr int HW = (RM + 3) / 4;             // halo words either side of a strip
  constexpr int NW = 4 + 2 * HW;
  constexpr int WW = kErodeCols + 2 * PAD;     // bytes of a window row
  constexpr int NSEG = WW / 16;                // 16-byte segments of a window row
  constexpr int WHM = kErodeRows + 2 * RM;     // window rows, at most
  constexpr int LOADS = (WHM * NSEG + kErodeThreads - 1) / kErodeThreads;
  __shared__ __align__(16) uint8_t win[WHM * WW];  // window byte (i, x0 - PAD + j)
  const int r = R >= 0 ? R : r_arg;
  const int n_seg = (kErodeRows + 2 * r) * NSEG;
  const int y0 = blockIdx.y * kErodeRows, x0 = blockIdx.x * kErodeCols;
  uint4 seg[LOADS];  // every load in flight before the first shared store
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const int e = threadIdx.x + k * kErodeThreads;
    if (e < n_seg) {
      const int i = e / NSEG, sg = e - i * NSEG;
      seg[k] = load_segment(in + size_t(clampi(y0 - r + i, 0, h - 1)) * w, x0 - PAD + 16 * sg, w);
    }
  }
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const int e = threadIdx.x + k * kErodeThreads;
    if (e < n_seg) *reinterpret_cast<uint4*>(win + 16 * e) = seg[k];  // row e / NSEG, segment e % NSEG
  }
  __syncthreads();
  const int i = threadIdx.x / kErodeStrips, c = 16 * (threadIdx.x % kErodeStrips);
  const int y = y0 + i, x = x0 + c;
  if (y >= h || x >= w) return;
  // column direction: col[j + HW] = min over window rows i .. i + 2r of word j
  const uint8_t* p = win + i * WW + PAD + c;
  uint32_t col[NW], v[NW];
  strip_words<HW>(p, col);
  if constexpr (R >= 0) {
#pragma unroll
    for (int q = 1; q <= 2 * R; ++q) {
      strip_words<HW>(p + q * WW, v);
#pragma unroll
      for (int j = 0; j < NW; ++j) col[j] = __vminu4(col[j], v[j]);
    }
  } else {
    for (int q = 1; q <= 2 * r; ++q) {
      strip_words<HW>(p + q * WW, v);
#pragma unroll
      for (int j = 0; j < NW; ++j) col[j] = __vminu4(col[j], v[j]);
    }
  }
  // row direction: output word k is the min over s in [-r, r] of the word at
  // byte 4k + s, i.e. word k + d shifted down by b bytes (s = 4d + b)
  uint32_t res[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t m = col[k + HW];
#pragma unroll
    for (int d = -HW; d <= HW; ++d) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int s = 4 * d + b;
        if (s == 0 || (d == HW && b > 0) || s < -r || s > r) continue;
        const uint32_t lo = col[k + d + HW];
        // hi is read only for b > 0; the clamp keeps the index in range at b = 0
        const uint32_t hi = col[min(k + d + HW + 1, NW - 1)];
        m = __vminu4(m, b == 0 ? lo : __byte_perm(lo, hi, 0x3210 + 0x1111 * b));
      }
    }
    res[k] = m;
  }
  uint8_t* dst = out + size_t(y) * w + x;
  if (x + 16 <= w && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(res[0], res[1], res[2], res[3]);
  } else {
#pragma unroll
    for (int o = 0; o < 16; ++o)
      if (x + o < w) dst[o] = uint8_t(res[o >> 2] >> (8 * (o & 3)));
  }
}

// THRESH_BINARY on u8 with the threshold already cast to u8.  The plane is
// split at the input's 16-byte boundaries: `head` bytes before the first,
// `nvec` whole 16-byte vectors, `tail` bytes after.  Thread g takes vector
// g (one 16-byte load, __vcmpgtu4 on each word: 0xFF per byte where x > t8,
// unsigned, ANDed with maxval; one store of 16, 4 x 4 or 16 x 1 bytes as
// the output's alignment allows, `store` 0 / 1 / 2), and threads g < head
// and g < tail also take head byte g and tail byte g.
__global__ void __launch_bounds__(kThreshThreads)
    seed_threshold_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int head,
                          long long nvec, int tail, int store, uint32_t t8, uint32_t maxval8) {
  const long long g = (long long)blockIdx.x * kThreshThreads + threadIdx.x;
  if (g < head) out[g] = in[g] > t8 ? uint8_t(maxval8) : uint8_t(0);
  if (g < tail) {
    const long long e = head + 16 * nvec + g;
    out[e] = in[e] > t8 ? uint8_t(maxval8) : uint8_t(0);
  }
  const uint32_t t4 = t8 * 0x01010101u, m4 = maxval8 * 0x01010101u;
  const long long stride = (long long)gridDim.x * kThreshThreads;
  for (long long v = g; v < nvec; v += stride) {
    const uint4 x = *reinterpret_cast<const uint4*>(in + head + 16 * v);
    const uint4 y = make_uint4(__vcmpgtu4(x.x, t4) & m4, __vcmpgtu4(x.y, t4) & m4,
                               __vcmpgtu4(x.z, t4) & m4, __vcmpgtu4(x.w, t4) & m4);
    uint8_t* dst = out + head + 16 * v;
    if (store == 0) {
      *reinterpret_cast<uint4*>(dst) = y;
    } else if (store == 1) {
      uint32_t* d4 = reinterpret_cast<uint32_t*>(dst);
      d4[0] = y.x;
      d4[1] = y.y;
      d4[2] = y.z;
      d4[3] = y.w;
    } else {
      const uint32_t yw[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int o = 0; o < 16; ++o) dst[o] = uint8_t(yw[o >> 2] >> (8 * (o & 3)));
    }
  }
}

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

template <int R, int RM = R>
int launch_erode(const void* in, void* out, int h, int w, int r, cudaStream_t stream) {
  const dim3 grid((w + kErodeCols - 1) / kErodeCols, (h + kErodeRows - 1) / kErodeRows);
  seed_erode_kernel<R, RM><<<grid, kErodeThreads, 0, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), h, w, r);
  return int(cudaGetLastError());
}

extern "C" int seed_erode_launch(const void* in, void* out, int h, int w, int r, void* stream) {
  if (h == 0 || w == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 0: return launch_erode<0>(in, out, h, w, r, st);
    case 1: return launch_erode<1>(in, out, h, w, r, st);
    case 2: return launch_erode<2>(in, out, h, w, r, st);
    case 3: return launch_erode<3>(in, out, h, w, r, st);
    default:  // the generic bodies, by the radius their window is sized for
      if (r < 0 || r > kErodeMaxR) return int(cudaErrorInvalidValue);
      if (r <= 8) return launch_erode<-1, 8>(in, out, h, w, r, st);
      if (r <= 16) return launch_erode<-1, 16>(in, out, h, w, r, st);
      return launch_erode<-1, 32>(in, out, h, w, r, st);
  }
}

// The head / vector / tail split is taken from the input's address, the
// store width from the output's (a plane may be a view at any byte offset).
extern "C" int seed_threshold_launch(const void* in, void* out, int h, int w, int t8, int maxval8,
                                     void* stream) {
  const long long n = (long long)h * w;
  if (n == 0) return 0;
  const long long head = std::min<long long>(n, (16 - (reinterpret_cast<uintptr_t>(in) & 15)) & 15);
  const long long nvec = (n - head) / 16, tail = n - head - 16 * nvec;
  const uintptr_t o = reinterpret_cast<uintptr_t>(out) + head;
  const int store = (o & 15) == 0 ? 0 : (o & 3) == 0 ? 1 : 2;
  const long long blocks = std::max<long long>(1, (nvec + kThreshThreads - 1) / kThreshThreads);
  seed_threshold_kernel<<<unsigned(std::min<long long>(blocks, 1 << 20)), kThreshThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), int(head), nvec, int(tail), store,
      uint32_t(t8), uint32_t(maxval8));
  return int(cudaGetLastError());
}
