// stencil_ops.cuh: the stage bodies and the carrier's load / pack, shared by
// the two chain kernels (stencil_chain.cu, stencil_stream.cu), so that both
// compute every stage with the same arithmetic.
//
// Arithmetic contract, which the plain PyTorch version (kernels/ref.py
// `chain_ref_planes`) repeats: every product and sum is rounded on its own
// (__fmul_rn, __fadd_rn; no FMA contraction), in the JAX body's index order;
// separable stages run a row pass, then a column pass; pyrDown is the 5-tap
// separable Gaussian computed at image-even rows and columns only (the row
// pass at even columns, the column pass at even rows); resize2 is the 2x2
// mean at image-even rows and columns; pyrUp is, per axis, the even phase
// ((a + 6 b) + c) * 0.125 and the odd phase (b + c) * 0.5 of the three
// source values a, b, c around the output's source coordinate, rows first,
// then columns, the row phases not packed; sqrt is the correctly rounded
// __fsqrt_rn; a gather takes floor and frac of the *global* f32 source
// coordinate (the window-local one would round the frac apart by an ulp
// and flip u8 .5 ties).  Bands are held in f32.  Each stage's result is
// packed back to its band's dtype: on u8 rintf (half to even) and a clamp
// to [0, 255], exactly what OpenCV's saturate_cast and the JAX oracle's
// `_saturate` do; a Sobel pair stays f32 whatever the carrier.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace stencil {

// op codes; kernels/stencil/exec_window.py `OP_CODES` mirrors them
enum Op : int {
  kSep = 0,        // separable filter: row taps at wx, column taps at wy
  kErode = 1,      // separable min over a (kh, kw) rectangle
  kGrad = 2,       // single-band central-difference gradient magnitude
  kStore = 3,      // window kernel only: store the input band as it is
  kFilter2d = 4,   // direct correlation, kh*kw taps at wx (row-major)
  kDilate = 5,     // separable max
  kBox = 6,        // separable sum, then * weights[wx] (= 1 / (kh*kw))
  kThreshold = 7,  // weights[wx] < x ? weights[wx + 1] : 0
  kAffine = 8,     // x * weights[wx] + weights[wx + 1]
  kPyrDown = 9,    // kSep with the 5 taps [1,4,6,4,1]/16 both ways, then 2x decimation
  kSobel = 10,     // emit: the f32 (dx, dy) pair of the last band, two destinations
  kGradPair = 11,  // reduce: sqrt(a^2 + b^2) of the last two bands
  kResize2 = 12,   // 2x2 mean at image-even rows and columns, floor size
  kWarp = 13,      // bilinear gather at M (6 weights at wx) applied to (x, y)
  kRemap = 14,     // bilinear gather at (map_x, map_y) = Bands::maps[2wx], [2wx + 1]
  kPyrUp = 15,     // 2x upsample: the even / odd phases per axis, rows then columns
};

// sizes of the per-launch tables below (kernels/stencil/exec_window.py
// MAX_BANDS, MAX_MAPS, MAX_LEVELS): 1,792 bytes of kernel parameters
constexpr int kMaxBands = 64;
constexpr int kMaxMaps = 16;
constexpr int kMaxLevels = 16;

// The output bands of a launch, the remap stages' map planes and the
// chain's levels, passed to the kernel by value: band b is an (n, h[b],
// w[b]) array at out[b], u8 when u8[b] else f32; map planes are f32, the
// size of the image at their stage's level.  Level l (the input's, then one
// per resolution change) holds an (lh[l], lw[l]) image, and a block's tile
// there is th[l] x tw[l] (the input tile, halved through each stride,
// doubled through each upsample).  kernels/stencil/exec_window.py `Bands`
// mirrors it.
struct Bands {
  void* out[kMaxBands];
  const float* maps[2 * kMaxMaps];
  int u8[kMaxBands];
  int h[kMaxBands];
  int w[kMaxBands];
  int lh[kMaxLevels];
  int lw[kMaxLevels];
  int th[kMaxLevels];
  int tw[kMaxLevels];
};

// Write v (already packed to the band's dtype) to band b, plane p, (y, x).
__device__ __forceinline__ void store_band(const Bands& bd, int b, int p, int y, int x, float v) {
  const size_t i = (size_t(p) * bd.h[b] + y) * bd.w[b] + x;
  if (bd.u8[b])
    static_cast<uint8_t*>(bd.out[b])[i] = uint8_t(v);
  else
    static_cast<float*>(bd.out[b])[i] = v;
}

__device__ __forceinline__ bool separable(int op) {
  return op == kSep || op == kErode || op == kDilate || op == kBox || op == kPyrDown;
}

// pyrDown keeps the rows and columns that are even in image coordinates
// (OpenCV's alignment): the first index >= i whose image coordinate
// (origin + index) is even.  The planners align every origin, so this is
// i rounded up to even in practice; it is exact for any origin.
__device__ __forceinline__ int first_even(int i, int origin) { return i + ((origin + i) & 1); }

// floor(v / 2) for any sign: the source coordinate of an upsampled one, or
// the level-down coordinate of an image-even one
__device__ __forceinline__ int floor2(int v) { return (v - (v & 1)) / 2; }

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const uint8_t* p) { return float(*p); }

__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
// v already holds a packed carrier value (an integer in [0, 255])
__device__ __forceinline__ void store_val(uint8_t* p, float v) { *p = uint8_t(v); }

__device__ __forceinline__ float pack(float v, bool u8) {
  return u8 ? fminf(fmaxf(rintf(v), 0.0f), 255.0f) : v;
}

// Row pass of a separable stage over the kw contiguous values at x (f32, or
// a u8 ring's values, each converted to f32 exactly).
template <typename E>
__device__ __forceinline__ float row_pass(int op, const E* x, const float* kx, int kw) {
  float acc;
  if (op == kSep || op == kPyrDown) {
    acc = __fmul_rn(kx[0], x[0]);
    for (int q = 1; q < kw; ++q) acc = __fadd_rn(acc, __fmul_rn(kx[q], x[q]));
  } else if (op == kBox) {
    acc = x[0];
    for (int q = 1; q < kw; ++q) acc = __fadd_rn(acc, x[q]);
  } else if (op == kErode) {
    acc = x[0];
    for (int q = 1; q < kw; ++q) acc = fminf(acc, x[q]);
  } else {
    acc = x[0];
    for (int q = 1; q < kw; ++q) acc = fmaxf(acc, x[q]);
  }
  return acc;
}

// Column pass of a separable stage over kh values at stride ld from x; box
// multiplies the sum by `scale` after it.
__device__ __forceinline__ float col_pass(int op, const float* x, int ld, const float* ky, int kh,
                                          float scale) {
  float acc;
  if (op == kSep || op == kPyrDown) {
    acc = __fmul_rn(ky[0], x[0]);
    for (int q = 1; q < kh; ++q) acc = __fadd_rn(acc, __fmul_rn(ky[q], x[q * ld]));
  } else if (op == kBox) {
    acc = x[0];
    for (int q = 1; q < kh; ++q) acc = __fadd_rn(acc, x[q * ld]);
    acc = __fmul_rn(acc, scale);
  } else if (op == kErode) {
    acc = x[0];
    for (int q = 1; q < kh; ++q) acc = fminf(acc, x[q * ld]);
  } else {
    acc = x[0];
    for (int q = 1; q < kh; ++q) acc = fmaxf(acc, x[q * ld]);
  }
  return acc;
}

// Row access for the bodies that read several rows.  `Rows::at(i)` names
// source row i, `next(q)` the row below q and `ptr(q)` its first value, so
// a ring finds its slot once per output, not once per tap row.  The values
// may be f32 or u8 (stencil_stream.cu's rings in the data's own dtype); a
// u8 value converts to f32 exactly.
struct LinRows {
  const float* p;
  int ld;
  __device__ __forceinline__ int at(int i) const { return i; }
  __device__ __forceinline__ int next(int q) const { return q + 1; }
  __device__ __forceinline__ const float* ptr(int q) const { return p + q * ld; }
};

// Direct correlation of the (kh, kw) window whose top-left value is source
// row i, column j; taps run row-major.
template <class Rows>
__device__ __forceinline__ float filter2d_at(const Rows& rows, int i, int j, const float* k,
                                             int kh, int kw) {
  int q = rows.at(i);
  const auto* x = rows.ptr(q) + j;
  float acc = __fmul_rn(k[0], x[0]);
  for (int b = 1; b < kw; ++b) acc = __fadd_rn(acc, __fmul_rn(k[b], x[b]));
  for (int a = 1; a < kh; ++a) {
    q = rows.next(q);
    x = rows.ptr(q) + j;
    for (int b = 0; b < kw; ++b) acc = __fadd_rn(acc, __fmul_rn(k[a * kw + b], x[b]));
  }
  return acc;
}

// Central differences around (i, j): sqrt(dx^2 + dy^2), halo 1.
template <class Rows>
__device__ __forceinline__ float grad_at(const Rows& rows, int i, int j) {
  const int q0 = rows.at(i - 1), q1 = rows.next(q0), q2 = rows.next(q1);
  const float dy = __fmul_rn(__fsub_rn(rows.ptr(q2)[j], rows.ptr(q0)[j]), 0.5f);
  const auto* c = rows.ptr(q1);
  const float dx = __fmul_rn(__fsub_rn(c[j + 1], c[j - 1]), 0.5f);
  return __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
}

// Sobel ksize=3 at (i, j), halo 1: per row the column difference cd =
// x[j+1] - x[j-1] and sum cs = (x[j-1] + x[j+1]) + 2 x[j]; then dx = (cd[i-1]
// + 2 cd[i]) + cd[i+1] and dy = cs[i+1] - cs[i-1].
template <class Rows>
__device__ __forceinline__ void sobel_at(const Rows& rows, int i, int j, float& dx, float& dy) {
  const int q0 = rows.at(i - 1), q1 = rows.next(q0), q2 = rows.next(q1);
  const auto* a = rows.ptr(q0) + j;
  const auto* b = rows.ptr(q1) + j;
  const auto* c = rows.ptr(q2) + j;
  const float cd0 = __fsub_rn(a[1], a[-1]), cd1 = __fsub_rn(b[1], b[-1]), cd2 = __fsub_rn(c[1], c[-1]);
  const float cs0 = __fadd_rn(__fadd_rn(a[-1], a[1]), __fmul_rn(2.0f, a[0]));
  const float cs2 = __fadd_rn(__fadd_rn(c[-1], c[1]), __fmul_rn(2.0f, c[0]));
  dx = __fadd_rn(__fadd_rn(cd0, __fmul_rn(2.0f, cd1)), cd2);
  dy = __fsub_rn(cs2, cs0);
}

// The pair reduction: sqrt(a^2 + b^2), to be packed to the carrier.
__device__ __forceinline__ float grad_pair(float a, float b) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)));
}

// resize2 of the 2x2 block whose top-left value is row i, column j:
// ((x00 + x10) + (x01 + x11)) * 0.25.
template <class Rows>
__device__ __forceinline__ float resize2_at(const Rows& rows, int i, int j) {
  const int q0 = rows.at(i);
  const auto* a = rows.ptr(q0) + j;
  const auto* b = rows.ptr(rows.next(q0)) + j;
  return __fmul_rn(__fadd_rn(__fadd_rn(a[0], b[0]), __fadd_rn(a[1], b[1])), 0.25f);
}

// pyrUp's two phases over three source values a, b, c (b the source row or
// column of the output, c the one after): even ((a + 6 b) + c) * 0.125, odd
// (b + c) * 0.5, every product and sum rounded on its own.
__device__ __forceinline__ float pyr_up_even(float a, float b, float c) {
  return __fmul_rn(__fadd_rn(__fadd_rn(a, __fmul_rn(6.0f, b)), c), 0.125f);
}

__device__ __forceinline__ float pyr_up_odd(float b, float c) {
  return __fmul_rn(__fadd_rn(b, c), 0.5f);
}

// Source coordinates of an inverse-map affine at image (y, x): m holds M00,
// M01, M02, M10, M11, M12 (f32); two rounded products, two rounded sums.
__device__ __forceinline__ void warp_coords(const float* m, int y, int x, float& sy, float& sx) {
  const float yf = float(y), xf = float(x);
  sx = __fadd_rn(__fadd_rn(__fmul_rn(xf, m[0]), __fmul_rn(yf, m[1])), m[2]);
  sy = __fadd_rn(__fadd_rn(__fmul_rn(xf, m[3]), __fmul_rn(yf, m[4])), m[5]);
}

// remap's source coordinates at image (y, x), clamped to the map's edge.
__device__ __forceinline__ void remap_coords(const float* mx, const float* my, int h, int w, int y,
                                             int x, float& sy, float& sx) {
  const size_t i = size_t(min(max(y, 0), h - 1)) * w + min(max(x, 0), w - 1);
  sy = my[i];
  sx = mx[i];
}

// Bilinear sample of a band whose local row r, column c sits at image (r +
// oy, c + ox), at image coordinates (sy, sx): floor and frac of the global
// coordinate, the taps' local row clamped to [rlo, rhi - 2] and column to
// [clo, chi - 2] (the rows and columns the band holds), then top = v00 +
// (v01 - v00) fx, bot likewise, top + (bot - top) fy.
template <class Rows>
__device__ __forceinline__ float bilinear_at(const Rows& rows, float sy, float sx, int oy, int ox,
                                             int rlo, int rhi, int clo, int chi) {
  const float iy = floorf(sy), ix = floorf(sx);
  const float fy = __fsub_rn(sy, iy), fx = __fsub_rn(sx, ix);
  const int ly = min(max(int(iy) - oy, rlo), rhi - 2);
  const int lx = min(max(int(ix) - ox, clo), chi - 2);
  const int q = rows.at(ly);
  const auto* a = rows.ptr(q) + lx;
  const auto* b = rows.ptr(rows.next(q)) + lx;
  const float top = __fadd_rn(a[0], __fmul_rn(__fsub_rn(a[1], a[0]), fx));
  const float bot = __fadd_rn(b[0], __fmul_rn(__fsub_rn(b[1], b[0]), fx));
  return __fadd_rn(top, __fmul_rn(__fsub_rn(bot, top), fy));
}

// Pointwise stages: threshold compares in f32; `hi` is maxval as the
// carrier holds it.  Affine rounds the product, then the sum.
__device__ __forceinline__ float pointwise(int op, float x, const float* w) {
  if (op == kThreshold) return x > w[0] ? w[1] : 0.0f;
  return __fadd_rn(__fmul_rn(x, w[0]), w[1]);
}

}  // namespace stencil
