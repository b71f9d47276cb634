// The BoW kernels: nearest-word assignment for training, and the classifier
// tail (quantize + histogram, then the linear SVM score).
//
// bow_assign replaces src/repro/kernels/bow.py `_bow_kernel` (via
// `bow_assign`).  Bound on an H100: operations.  At the training shape
// (N = 32000 descriptors of D = 128 against K = 250 words) it does
// 2*N*K*D = 2.05 GFLOP of fp32 and moves ~16.8 MB.  The products and sums
// may not be contracted into FMAs (every one is rounded on its own, in
// ascending q, as the plain version computes them), and tensor cores round
// otherwise, so the attainable floor is about twice the 67 TFLOP/s bound.
//
// bow_quantize_hist replaces src/repro/kernels/bow.py `_hist_kernel` (via
// `bow_quantize_hist`).  Bound on an H100: operations, 2*B*N*K*D = 2.1
// GFLOP at the predict batch (B*N = 32768 rows) against ~17 MB moved.
//
// Both run one nearest-word search (`nearest_words`) over flattened
// descriptor rows: a block takes kTileN = 64 rows and walks the codebook in
// tiles of kTileK = 64 words; each of its 256 threads owns a 4 x 4 register
// micro-tile (4 rows by 4 words), so every shared-memory value it loads
// feeds 4 products.  Rows and words are staged in q-major layout (a 16-byte
// load gives a thread 4 rows' or 4 words' q-th value), kChunk values of q
// at a time, with cp.async double-buffering: the next chunk's copies fly
// while this one computes.  Every dot product is one ascending-q chain of
// __fmul_rn / __fadd_rn, kept in registers from chunk to chunk; s = -2 d.c
// + |c|^2 is compared as the old one-lane-per-word search did, and a
// running argmin per (row, thread) takes its words in ascending k with a
// strict <, so ties keep the lower word; the 16 threads of a row then merge
// by shuffles, ties to the lower word.  |c|^2 of a tile's words (+inf past
// K, so pad words never win) and, for bow_assign, |d|^2 of the rows are
// summed in the same ascending order inside the chunk loop, one word or row
// a thread, instead of in a serial pass.  The (N, K) score matrix never
// reaches device memory: bow_assign writes each row's word index and min +
// |d|^2; bow_quantize_hist adds each valid row's weight to its own image's
// histogram row with atomicAdd (sums of {0, 1} weights are exact in any
// order).
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

// kernels/bow.py SEARCH_ROWS, SEARCH_WORDS, SEARCH_CHUNK, SEARCH_THREADS
constexpr int kTileN = 64;    // rows a block searches
constexpr int kTileK = 64;    // words a tile of the codebook holds
constexpr int kChunk = 32;    // values of q staged at a time
constexpr int kLd = kTileN + 4;  // q-major row stride: 16-byte aligned
constexpr int kThreads = 256;   // 16 x 16 threads of 4 x 4 outputs
constexpr int kMicro = 4;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage values q0 .. q0 + kChunk - 1 of `n` rows of a row-major (., D)
// matrix starting at row `r0` into dst[q][r] (q-major, stride kLd), one
// 4-byte cp.async a value: thread t copies value q = t % kChunk of rows t /
// kChunk + i * (kThreads / kChunk), so a warp reads runs of kChunk
// consecutive values.  Rows past `n` and values past D are zero (they are
// never read as real data: a row past n is not stored, a word past K scores
// +inf, and q past D is not summed).
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, size_t r0, int n,
                                      int D, int q0) {
  constexpr int kRowsPass = kThreads / kChunk;
  const int q = threadIdx.x % kChunk, rb = threadIdx.x / kChunk;
  const bool in_q = q0 + q < D;
  const float* s = src + (r0 + rb) * size_t(D) + q0 + q;
#pragma unroll
  for (int i = 0; i < kTileN / kRowsPass; ++i) {
    const int r = rb + i * kRowsPass;
    float* d = dst + q * kLd + r;
    if (r < n && in_q)
      cp_async4(d, s + size_t(i) * kRowsPass * D);
    else
      *d = 0.0f;
  }
}

// The nearest word of each of the block's rows (row0 .. row0 + n - 1 of a
// row-major (rows, D) matrix): the minimum over k of s = -2 d.c_k +
// |c_k|^2, ties to the lowest k.  Every thread of the block calls it; on
// return the thread with tx == 0 of each ty holds, for rows 4 ty + i, the
// minimum best[i] and its word best_k[i]; with `dd`, d2_s[r] holds |d_r|^2.
__device__ void nearest_words(const float* __restrict__ descs, const float* __restrict__ cents,
                              size_t row0, int n, int D, int K, bool dd,
                              float (&best)[kMicro], int (&best_k)[kMicro], float*& d2_out) {
  extern __shared__ __align__(16) float sm[];
  float* ds = sm;                               // [2][kChunk][kLd] rows
  float* cs = ds + 2 * kChunk * kLd;            // [2][kChunk][kLd] words
  float* c2_s = cs + 2 * kChunk * kLd;          // [kTileK] |c|^2 of the tile's words
  float* d2_s = c2_s + kTileK;                  // [kTileN] |d|^2 of the rows
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n_chunks = (D + kChunk - 1) / kChunk, n_tiles = (K + kTileK - 1) / kTileK;
  const int total = n_chunks * n_tiles;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    best[i] = CUDART_INF_F;
    best_k[i] = 0;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = -0.0f;
  }
  float c2 = -0.0f, d2 = -0.0f;  // thread tid < 64: word tid; 64 <= tid < 128: row tid - 64

  stage(ds, descs, row0, n, D, 0);
  stage(cs, cents, 0, K, D, 0);
  cp_async_commit();
  int ch = 0, k0 = 0;
  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    if (it + 1 < total) {  // the next chunk flies while this one computes
      const int nch = ch + 1 == n_chunks ? 0 : ch + 1, nk0 = ch + 1 == n_chunks ? k0 + kTileK : k0;
      stage(ds + (buf ^ 1) * kChunk * kLd, descs, row0, n, D, nch * kChunk);
      stage(cs + (buf ^ 1) * kChunk * kLd, cents, nk0, K - nk0, D, nch * kChunk);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const float* dq = ds + buf * kChunk * kLd;
    const float* cq = cs + buf * kChunk * kLd;
    const int nq = min(kChunk, D - ch * kChunk);
#pragma unroll 4
    for (int q = 0; q < nq; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(dq + q * kLd + kMicro * ty);
      const float4 b = *reinterpret_cast<const float4*>(cq + q * kLd + kMicro * tx);
      const float av[kMicro] = {a.x, a.y, a.z, a.w}, bv[kMicro] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(av[i], bv[j]));
      if (tid < kTileK) {
        const float c = cq[q * kLd + tid];
        c2 = __fadd_rn(c2, __fmul_rn(c, c));
      } else if (dd && k0 == 0 && tid < kTileK + kTileN) {
        const float d = dq[q * kLd + tid - kTileK];
        d2 = __fadd_rn(d2, __fmul_rn(d, d));
      }
    }
    if (ch + 1 == n_chunks) {  // the tile's sums are whole: score its words
      if (tid < kTileK) c2_s[tid] = k0 + tid < K ? c2 : CUDART_INF_F;
      if (dd && k0 == 0 && tid >= kTileK && tid < kTileK + kTileN) d2_s[tid - kTileK] = d2;
      c2 = -0.0f;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        const float cj = c2_s[kMicro * tx + j];
#pragma unroll
        for (int i = 0; i < kMicro; ++i) {
          const float s = __fadd_rn(__fmul_rn(-2.f, acc[i][j]), cj);
          if (s < best[i]) {  // strict: ascending k keeps the lowest word on ties
            best[i] = s;
            best_k[i] = k0 + kMicro * tx + j;
          }
          acc[i][j] = -0.0f;
        }
      }
      ch = 0;
      k0 += kTileK;
    } else {
      ++ch;
    }
    __syncthreads();  // this chunk is consumed before its buffer is staged again
  }
  // merge the 16 threads of each row group (lanes of one half-warp)
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int ok = __shfl_xor_sync(0xffffffffu, best_k[i], off);
      if (ov < best[i] || (ov == best[i] && ok < best_k[i])) {
        best[i] = ov;
        best_k[i] = ok;
      }
    }
  }
  d2_out = d2_s;
}

// A request's 8,192 rows are 128 blocks, under one an SM: no register cap
// (a 64-register one spills).
__global__ void __launch_bounds__(kThreads, 2)
    quantize_hist_kernel(const float* __restrict__ descs, const float* __restrict__ valids,
                         const float* __restrict__ cents, float* __restrict__ hist, int rows,
                         int N, int D, int K) {
  const size_t row0 = size_t(blockIdx.x) * kTileN;
  float best[kMicro], *d2_s;
  int best_k[kMicro];
  nearest_words(descs, cents, row0, min(kTileN, int(rows - row0)), D, K, false, best, best_k,
                d2_s);
  if (threadIdx.x % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const size_t r = row0 + kMicro * (threadIdx.x / 16) + i;
      if (r < size_t(rows)) {
        const float wv = valids[r];
        if (wv != 0.f) atomicAdd(hist + (r / N) * K + best_k[i], wv);
      }
    }
  }
}

// Four blocks an SM (64 registers a thread): the 500 blocks of a training
// assignment (32,000 rows) run in one wave on 132 SMs.
__global__ void __launch_bounds__(kThreads, 4)
    bow_assign_kernel(const float* __restrict__ descs, const float* __restrict__ cents,
                      int* __restrict__ idx, float* __restrict__ d2, int N, int D, int K) {
  const size_t row0 = size_t(blockIdx.x) * kTileN;
  float best[kMicro], *d2_s;
  int best_k[kMicro];
  nearest_words(descs, cents, row0, min(kTileN, int(N - row0)), D, K, true, best, best_k, d2_s);
  if (threadIdx.x % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int r = kMicro * (threadIdx.x / 16) + i;
      if (row0 + r < size_t(N)) {
        idx[row0 + r] = best_k[i];
        d2[row0 + r] = __fadd_rn(best[i], d2_s[r]);
      }
    }
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

// The search's shared memory: two chunks of rows and of words, the tile's
// |c|^2 and the rows' |d|^2.
extern "C" int nearest_words_smem_bytes() {
  return int((4 * kChunk * kLd + kTileK + kTileN) * sizeof(float));
}

// hist (B, K) must be zeroed by the caller; the B*N rows are searched as
// one flattened matrix.  Returns cudaGetLastError().
extern "C" int quantize_hist_launch(const float* descs, const float* valids, const float* cents,
                                    float* hist, int B, int N, int D, int K, void* stream) {
  const long long rows = (long long)B * N;
  const long long blocks = (rows + kTileN - 1) / kTileN;
  if (blocks == 0 || K == 0) return 0;
  if (blocks > 0x7fffffffLL || rows > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  quantize_hist_kernel<<<unsigned(blocks), kThreads, nearest_words_smem_bytes(),
                         static_cast<cudaStream_t>(stream)>>>(descs, valids, cents, hist,
                                                              int(rows), N, D, K);
  return int(cudaGetLastError());
}

// idx (N,) i32 and d2 (N,) f32 are written for every row.  Returns
// cudaGetLastError().
extern "C" int bow_assign_launch(const float* descs, const float* cents, int* idx, float* d2,
                                 int N, int D, int K, void* stream) {
  const long long blocks = (N + (long long)kTileN - 1) / kTileN;
  if (blocks == 0 || K == 0) return 0;
  bow_assign_kernel<<<unsigned(blocks), kThreads, nearest_words_smem_bytes(),
                      static_cast<cudaStream_t>(stream)>>>(descs, cents, idx, d2, N, D, K);
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
