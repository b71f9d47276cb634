// The BoW kernels: nearest-word assignment for training, and the classifier
// tail (quantize + histogram, then the linear SVM score).
//
// bow_assign replaces src/repro/kernels/bow.py `_bow_kernel` (via
// `bow_assign`).  Bound on an H100: operations.  At the training shape
// (N = 32000 descriptors of D = 128 against K = 250 words) it does
// 2*N*K*D = 2.05 GFLOP of fp32 and moves ~16.8 MB.  Design: the nearest-word
// search of bow_quantize_hist (below), over the flattened descriptor rows,
// writing each descriptor's word index and min + |d|^2 instead of adding
// into a histogram; the (N, K) score matrix never reaches device memory.
//
// bow_quantize_hist replaces src/repro/kernels/bow.py `_hist_kernel` (via
// `bow_quantize_hist`).  Bound on an H100: operations.  At the predict
// batch (B*N = 32768 descriptors of D = 128 against K = 250 words) it does
// 2*B*N*K*D = 2.1 GFLOP of fp32 on CUDA cores and moves ~17 MB, so the dot
// products, not the bytes, set its floor.  Design: one block per (image,
// block of descriptors).  The descriptors stay in shared memory while the
// codebook streams through it in tiles; each of a descriptor's `lanes`
// threads keeps a running argmin over its strided share of the words, and a
// warp-shuffle merge picks the minimum with ties to the lower word index.
// The (N, K) score matrix and the word indices never reach device memory:
// each descriptor's valid weight is added to its image's histogram row with
// atomicAdd (sums of {0, 1} weights are exact in any order).
//
// linear_score replaces src/repro/kernels/bow.py `_score_kernel` (via
// `linear_score`).  Bound on an H100: latency; (B, K) x (C, K)^T is ~1.3
// MFLOP and ~0.1 MB at the predict batch.  Design: one block per tile of 16
// images and 32 classes (16 blocks for a request of 256), the tile's rows
// of h and w staged into shared memory with coalesced loads, each thread one
// (image, class) output walking K in ascending order from shared memory,
// then adding the bias; each sum is ~K dependent adds (~0.5 us at K = 250).
//
// Arithmetic (every kernel here): fp32 on CUDA cores, no tensor cores, no TF32;
// every product and sum is rounded on its own (__fmul_rn / __fadd_rn, no
// FMA contraction), in ascending index order, as the plain PyTorch
// versions in kernels/bow.py compute them.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math_constants.h>

namespace {

// Loads the block's descriptors (rows row0 .. row0 + n_valid - 1 of a
// row-major (rows, D) matrix; bn slots, zero past n_valid) into shared
// memory and finds each one's nearest word: the minimum over k of
// s = -2 d.c_k + |c_k|^2, ties to the lowest k.  Every thread of the block
// must call it; on return, every lane of descriptor slot `i` holds the
// slot's minimum and word.  Returns the slot's descriptor row in shared
// memory.
__device__ const float* nearest_words(const float* __restrict__ descs,
                                      const float* __restrict__ cents, size_t row0,
                                      int n_valid, int D, int K, int bn, int tk, int i, int lane,
                                      int lanes, float& best, int& best_k) {
  extern __shared__ float sm[];
  const int ds = D + 1;  // padded row: a warp's lanes read distinct banks
  float* d_s = sm;                // bn x ds descriptors
  float* c_s = d_s + bn * ds;     // tk x ds codebook tile
  float* c2_s = c_s + tk * ds;    // tk |c|^2, +inf past K

  for (int e = threadIdx.x; e < bn * D; e += blockDim.x) {
    const int r = e / D, q = e - r * D;
    d_s[r * ds + q] = r < n_valid ? descs[(row0 + r) * D + q] : 0.f;
  }

  best = CUDART_INF_F;
  best_k = 0;
  for (int k0 = 0; k0 < K; k0 += tk) {
    __syncthreads();  // the previous tile is consumed (and d_s is loaded)
    for (int e = threadIdx.x; e < tk * D; e += blockDim.x) {
      const int r = e / D, q = e - r * D, k = k0 + r;
      c_s[r * ds + q] = k < K ? cents[size_t(k) * D + q] : 0.f;
    }
    __syncthreads();
    for (int r = threadIdx.x; r < tk; r += blockDim.x) {
      const float* c = c_s + r * ds;
      float a = __fmul_rn(c[0], c[0]);
      for (int q = 1; q < D; ++q) a = __fadd_rn(a, __fmul_rn(c[q], c[q]));
      c2_s[r] = k0 + r < K ? a : CUDART_INF_F;
    }
    __syncthreads();
    const float* d = d_s + i * ds;
    for (int r = lane; r < tk; r += lanes) {
      const float* c = c_s + r * ds;
      float acc = __fmul_rn(d[0], c[0]);
      for (int q = 1; q < D; ++q) acc = __fadd_rn(acc, __fmul_rn(d[q], c[q]));
      const float s = __fadd_rn(__fmul_rn(-2.f, acc), c2_s[r]);
      if (s < best) {  // strict: ascending k keeps the lowest index on ties
        best = s;
        best_k = k0 + r;
      }
    }
  }
  // merge the descriptor's lanes (consecutive threads of one warp)
  for (int off = lanes / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int ok = __shfl_xor_sync(0xffffffffu, best_k, off);
    if (ov < best || (ov == best && ok < best_k)) {
      best = ov;
      best_k = ok;
    }
  }
  return d_s + i * ds;
}

__global__ void quantize_hist_kernel(const float* __restrict__ descs,
                                     const float* __restrict__ valids,
                                     const float* __restrict__ cents, float* __restrict__ hist,
                                     int N, int D, int K, int bn, int tk, int n_blocks) {
  const int b = blockIdx.x / n_blocks;
  const int n0 = (blockIdx.x - b * n_blocks) * bn;
  const int lanes = blockDim.x / bn;
  const int i = threadIdx.x / lanes, lane = threadIdx.x - i * lanes;
  float best;
  int best_k;
  nearest_words(descs, cents, size_t(b) * N + n0, N - n0, D, K, bn, tk, i, lane, lanes, best,
                best_k);
  const int n = n0 + i;
  if (lane == 0 && n < N) {
    const float wv = valids[size_t(b) * N + n];
    if (wv != 0.f) atomicAdd(hist + size_t(b) * K + best_k, wv);
  }
}

__global__ void bow_assign_kernel(const float* __restrict__ descs,
                                  const float* __restrict__ cents, int* __restrict__ idx,
                                  float* __restrict__ d2, int N, int D, int K, int bn, int tk) {
  const int n0 = blockIdx.x * bn;
  const int lanes = blockDim.x / bn;
  const int i = threadIdx.x / lanes, lane = threadIdx.x - i * lanes;
  float best;
  int best_k;
  const float* d = nearest_words(descs, cents, size_t(n0), N - n0, D, K, bn, tk, i, lane, lanes,
                                 best, best_k);
  const int n = n0 + i;
  if (lane == 0 && n < N) {
    float dd = __fmul_rn(d[0], d[0]);
    for (int q = 1; q < D; ++q) dd = __fadd_rn(dd, __fmul_rn(d[q], d[q]));
    idx[n] = best_k;
    d2[n] = __fadd_rn(best, dd);
  }
}

// linear_score: a block scores a tile of kScoreRows images against
// kScoreClasses classes.  K is walked in chunks of `kc` columns: the tile's
// rows of h and of w are staged into shared memory (16-byte loads where the
// rows are contiguous and aligned), then each thread walks its outputs'
// products in ascending k from shared memory and keeps the running sum in
// `acc_s` from chunk to chunk.
constexpr int kScoreRows = 16;
constexpr int kScoreClasses = 32;

// Copy rows [0, n) x columns [k0, k0 + kn) of a row-major (., K) array at
// `src` into `dst` with row stride `ld`.
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* __restrict__ src,
                                           int n, int K, int k0, int kn) {
  const int total = n * kn;
  if (kn == K && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    // the rows are one contiguous, aligned run of n*K floats
    const int n4 = total / 4;
    for (int e = threadIdx.x; e < n4; e += blockDim.x) {
      const float4 v = reinterpret_cast<const float4*>(src)[e];
      int r = 4 * e / K, k = 4 * e - r * K;
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dst[r * ld + k] = vs[q];
        if (++k == K) k = 0, ++r;
      }
    }
    for (int e = 4 * n4 + threadIdx.x; e < total; e += blockDim.x) {
      const int r = e / K;
      dst[r * ld + e - r * K] = src[e];
    }
  } else {
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int r = e / kn, k = e - r * kn;
      dst[r * ld + k] = src[size_t(r) * K + k0 + k];
    }
  }
}

__global__ void linear_score_kernel(const float* __restrict__ h, const float* __restrict__ w,
                                    const float* __restrict__ bias, float* __restrict__ out,
                                    int B, int K, int C, int kc) {
  extern __shared__ float sm[];
  const int b0 = blockIdx.x * kScoreRows, c0 = blockIdx.y * kScoreClasses;
  const int nb = min(kScoreRows, B - b0), nc = min(kScoreClasses, C - c0);
  const int ld = kc | 1;  // odd: the rows a warp reads at one k fall in distinct banks
  float* acc_s = sm;      // one running sum per output of the tile
  float* hs = acc_s + kScoreRows * kScoreClasses;
  float* ws = hs + kScoreRows * ld;
  const int n_out = nb * nc;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) acc_s[o] = K > 0 ? -0.0f : 0.0f;
  for (int k0 = 0; k0 < K; k0 += kc) {
    const int kn = min(kc, K - k0);
    __syncthreads();  // the previous chunk's reads are done
    stage_rows(hs, ld, h + size_t(b0) * K, nb, K, k0, kn);
    stage_rows(ws, ld, w + size_t(c0) * K, nc, K, k0, kn);
    __syncthreads();
    for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
      const int i = o / nc, c = o - i * nc;
      const float* hr = hs + i * ld;
      const float* wr = ws + c * ld;
      // -0 + p = p exactly, so the first product starts the sum as it is
      float acc = acc_s[o];
#pragma unroll 8
      for (int k = 0; k < kn; ++k) acc = __fadd_rn(acc, __fmul_rn(hr[k], wr[k]));
      acc_s[o] = acc;
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    const int i = o / nc, c = o - i * nc;
    out[size_t(b0 + i) * C + c0 + c] = __fadd_rn(acc_s[o], bias[c0 + c]);
  }
}

}  // namespace

static size_t nearest_words_smem(int D, int bn, int tk) {
  return (size_t(bn + tk) * (D + 1) + tk) * sizeof(float);
}

// hist (B, K) must be zeroed by the caller.  Returns cudaGetLastError().
extern "C" int quantize_hist_launch(const float* descs, const float* valids, const float* cents,
                                    float* hist, int B, int N, int D, int K, int bn, int tk,
                                    int threads, void* stream) {
  const int n_blocks = (N + bn - 1) / bn;
  const long long blocks = (long long)B * n_blocks;
  if (blocks == 0 || K == 0) return 0;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  const size_t smem = nearest_words_smem(D, bn, tk);
  cudaError_t err = cudaFuncSetAttribute(
      quantize_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  quantize_hist_kernel<<<unsigned(blocks), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      descs, valids, cents, hist, N, D, K, bn, tk, n_blocks);
  return int(cudaGetLastError());
}

// idx (N,) i32 and d2 (N,) f32 are written for every row.  Returns
// cudaGetLastError().
extern "C" int bow_assign_launch(const float* descs, const float* cents, int* idx, float* d2,
                                 int N, int D, int K, int bn, int tk, int threads, void* stream) {
  const long long blocks = (N + (long long)bn - 1) / bn;
  if (blocks == 0 || K == 0) return 0;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  const size_t smem = nearest_words_smem(D, bn, tk);
  cudaError_t err = cudaFuncSetAttribute(
      bow_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  bow_assign_kernel<<<unsigned(blocks), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      descs, cents, idx, d2, N, D, K, bn, tk);
  return int(cudaGetLastError());
}

// The shared memory of a linear_score block: the tile's running sums, its
// kScoreRows rows of h and min(C, kScoreClasses) rows of w, kc columns each
// (row stride kc | 1).
extern "C" int linear_score_smem_bytes(int kc, int C) {
  const int nc = C < kScoreClasses ? C : kScoreClasses;
  return int((kScoreRows * kScoreClasses + (kScoreRows + nc) * (kc | 1)) * sizeof(float));
}

// out (B, C) = h (B, K) . w (C, K)^T + bias, K walked in chunks of kc
// columns (kernels/bow.py `score_geometry`, which keeps a block within the
// 48 KB of shared memory a launch may take without opting in).  Returns
// cudaGetLastError().
extern "C" int linear_score_launch(const float* h, const float* w, const float* bias, float* out,
                                   int B, int K, int C, int kc, int threads, void* stream) {
  if (B == 0 || C == 0) return 0;
  const dim3 grid((B + kScoreRows - 1) / kScoreRows, (C + kScoreClasses - 1) / kScoreClasses);
  linear_score_kernel<<<grid, threads, linear_score_smem_bytes(kc, C),
                        static_cast<cudaStream_t>(stream)>>>(h, w, bias, out, B, K, C, kc);
  return int(cudaGetLastError());
}
