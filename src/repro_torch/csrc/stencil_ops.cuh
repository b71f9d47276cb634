// stencil_ops.cuh: the stage bodies and the carrier's load / pack, shared by
// the two chain kernels (stencil_chain.cu, stencil_stream.cu), so that both
// compute every stage with the same arithmetic.
//
// Arithmetic contract, which the plain PyTorch version (kernels/ref.py
// `chain_ref_planes`) repeats: every product and sum is rounded on its own
// (__fmul_rn, __fadd_rn; no FMA contraction), in the JAX body's index order;
// separable stages run a row pass, then a column pass; pyrDown is the 5-tap
// separable Gaussian computed at image-even rows and columns only (the row
// pass at even columns, the column pass at even rows); sqrt is the correctly
// rounded __fsqrt_rn.  Bands are held in f32.  On a u8 carrier each stage's
// result is packed back (rintf, half to even, and a clamp to [0, 255]),
// exactly what OpenCV's saturate_cast and the JAX oracle's `_saturate` do.

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
};

__device__ __forceinline__ bool separable(int op) {
  return op == kSep || op == kErode || op == kDilate || op == kBox || op == kPyrDown;
}

// pyrDown keeps the rows and columns that are even in image coordinates
// (OpenCV's alignment): the first index >= i whose image coordinate
// (origin + index) is even.  The planners align every origin, so this is
// i rounded up to even in practice; it is exact for any origin.
__device__ __forceinline__ int first_even(int i, int origin) { return i + ((origin + i) & 1); }

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const uint8_t* p) { return float(*p); }

__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
// v already holds a packed carrier value (an integer in [0, 255])
__device__ __forceinline__ void store_val(uint8_t* p, float v) { *p = uint8_t(v); }

__device__ __forceinline__ float pack(float v, bool u8) {
  return u8 ? fminf(fmaxf(rintf(v), 0.0f), 255.0f) : v;
}

// Row pass of a separable stage over the kw contiguous values at x.
__device__ __forceinline__ float row_pass(int op, const float* x, const float* kx, int kw) {
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
// a ring pays its modulo once per output, not once per tap row.
struct LinRows {
  const float* p;
  int ld;
  __device__ __forceinline__ int at(int i) const { return i; }
  __device__ __forceinline__ int next(int q) const { return q + 1; }
  __device__ __forceinline__ const float* ptr(int q) const { return p + q * ld; }
};

struct RingRows {
  float* p;
  int depth, ld;
  __device__ __forceinline__ int at(int i) const {
    int q = i % depth;
    return q < 0 ? q + depth : q;
  }
  __device__ __forceinline__ int next(int q) const { return q + 1 == depth ? 0 : q + 1; }
  __device__ __forceinline__ float* ptr(int q) const { return p + q * ld; }
  __device__ __forceinline__ float* operator()(int i) const { return ptr(at(i)); }
};

// Direct correlation of the (kh, kw) window whose top-left value is source
// row i, column j; taps run row-major.
template <class Rows>
__device__ __forceinline__ float filter2d_at(const Rows& rows, int i, int j, const float* k,
                                             int kh, int kw) {
  int q = rows.at(i);
  const float* x = rows.ptr(q) + j;
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
  const float* c = rows.ptr(q1);
  const float dx = __fmul_rn(__fsub_rn(c[j + 1], c[j - 1]), 0.5f);
  return __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
}

// Pointwise stages: threshold compares in f32; `hi` is maxval as the
// carrier holds it.  Affine rounds the product, then the sum.
__device__ __forceinline__ float pointwise(int op, float x, const float* w) {
  if (op == kThreshold) return x > w[0] ? w[1] : 0.0f;
  return __fadd_rn(__fmul_rn(x, w[0]), w[1]);
}

}  // namespace stencil
