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
// `bow_quantize_hist`).  Bound on an H100: operations, 2*B*N*K*D = 0.52
// GFLOP at the predict request (B = 256 images of N = 32 rows, K = 250),
// 7.8 us at 67 TFLOP/s (~15.7 us without FMA contraction), against ~4.3 MB
// moved.
//
// Both run one nearest-word search (`nearest_words`): a block takes a tile
// of rows and walks codebook tiles of words; each thread owns a register
// micro-tile (4 rows by 4 or 8 words), so every shared-memory value it loads
// feeds 4 or more products.  Rows and words are staged in q-major layout (a
// 16-byte load gives a thread 4 rows' or 4 words' q-th value), a chunk of q
// at a time, with cp.async double-buffering: the next chunk's copies fly
// while this one computes.  Every dot product is one ascending-q chain of
// __fmul_rn / __fadd_rn, kept in registers from chunk to chunk; s = -2 d.c +
// |c|^2 is compared as the old one-lane-per-word search did, and a running
// argmin per (row, thread) takes its words in ascending k with a strict <,
// so ties keep the lower word; the threads of a row then merge by shuffles,
// ties to the lower word.  |c|^2 of a tile's words (+inf past K, so pad
// words never win) and, for bow_assign, |d|^2 of the rows are summed in the
// same ascending order inside the chunk loop, one word or row a thread.
// The (N, K) score matrix never reaches device memory.
//
// bow_assign: blocks of 256 threads (4 x 4 micro-tiles) take 64 rows of the
// flattened (N, D) matrix against every 64-word tile in turn and write each
// row's word index and min + |d|^2; four blocks an SM at 64 registers, so
// the 500 blocks of a training assignment run in one wave.
//
// bow_quantize_hist: blocks own images, and a thread-block cluster splits
// the codebook.  A cluster of S = min(ceil(K / 128), 8) CTAs of 128 threads
// (4 x 8 micro-tiles) serves one image; rank r searches word tiles r, r +
// S, ... of 128 words against the image's rows, 32 rows at a time (at the
// predict request: 256 clusters of 2, 512 CTAs, about four an SM, in one
// wave).  Each rank writes its rows' (min, word) pairs into rank 0's shared
// memory (distributed shared memory) and the cluster syncs; rank 0 merges
// them on (value, then word), so ties go to the lower word whatever the
// rank order, and the result is the plain argmin bit for bit.  Rank 0 then
// adds each row's weight to its word in ascending n (one thread a word,
// carried across the image's row tiles), sums the image's total weight in
// ascending n, divides with __fdiv_rn and writes its image's row: no
// atomics (the histogram is the same from run to run, also for fractional
// weights), no memset (every output is written) and no cast (valids are
// read in their own dtype, bool / u8 or f32): one launch a call.  The
// cluster size depends on K, so it launches through cudaLaunchKernelEx.
// What holds it on the H100 (scripts/torch_bow_sweep.py): the separately
// rounded products and sums, which no tile shape tried took past ~16e12 a
// second (half the card's 33.5e12 fp32 lanes a second; bow_assign's loop
// runs at the same rate); 64-word tiles of 4 x 4 (1,024 CTAs) took 0.051
// ms a request, 128-word tiles of 4 x 8 0.037.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

// bow_assign's block (kernels/bow.py SEARCH_ROWS, SEARCH_WORDS,
// SEARCH_CHUNK, SEARCH_THREADS, SEARCH_MICRO)
constexpr int kTileN = 64;    // rows a block searches
constexpr int kTileK = 64;    // words a tile of the codebook holds
constexpr int kChunk = 32;    // values of q staged at a time
constexpr int kThreads = 256;   // 16 x 16 threads of 4 x 4 outputs
constexpr int kMicro = 4;
// bow_quantize_hist's CTA (kernels/bow.py HIST_ROWS, HIST_WORDS,
// HIST_THREADS, HIST_CHUNK, HIST_MICRO_ROWS, HIST_MICRO_WORDS,
// HIST_MIN_BLOCKS, HIST_MAX_RANKS): rows of an image a CTA walks at a time,
// words of a codebook tile, threads, values of q staged at a time, each
// thread's micro-tile (rows x words), CTAs an SM its launch bounds ask
// for, CTAs a cluster may hold (the portable limit)
constexpr int kHistRows = 32;
constexpr int kHistWords = 128;
constexpr int kHistThreads = 128;
constexpr int kHistChunk = 16;
constexpr int kHistMicroRows = 4;
constexpr int kHistMicroWords = 8;
constexpr int kHistMinBlocks = 4;
constexpr int kHistMaxRanks = 8;

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

// A search block's geometry: kRows rows against codebook tiles of kWords
// words, kThr threads, each a kMR x kMW micro-tile (rows x words): kTx =
// kWords / kMW threads of a row group (adjacent lanes) by kRows / kMR row
// groups; thread (tx, ty) takes rows kMR ty + i and words 4 tx + 4 kTx g +
// e (g < kMW / 4, e < 4), so each 16-byte load of a warp's words reads
// adjacent float4s (no bank conflicts); kCh values of q staged at a time;
// q-major row strides 16-byte aligned.
template <int kRows, int kWords, int kThr, int kCh, int kMR, int kMW>
struct Search {
  static constexpr int kTx = kWords / kMW;
  static_assert(kMR % 4 == 0 && kMW % 4 == 0, "micro-tiles of whole float4s");
  static_assert(kTx <= 32 && 32 % kTx == 0, "a row group's threads are lanes of one warp");
  static_assert((kRows / kMR) * kTx == kThr, "one micro-tile a thread");
  static_assert(kThr % kCh == 0 && kRows % (kThr / kCh) == 0 && kWords % (kThr / kCh) == 0,
                "whole staging passes");
  static constexpr int kLdR = kRows + 4;   // q-major row stride of the rows
  static constexpr int kLdW = kWords + 4;  // q-major row stride of the words
  static constexpr int kC2 = (kWords + kThr - 1) / kThr;  // words whose |c|^2 a thread sums
  // shared memory: two chunks of rows and of words, the tile's |c|^2 and
  // the rows' |d|^2, in floats
  static constexpr int kFloats = 2 * kCh * kLdR + 2 * kCh * kLdW + kWords + kRows;
};

// Stage values q0 .. q0 + kCh - 1 of `n` rows of a row-major (., D) matrix
// starting at row `r0` into dst[q][r] (q-major, stride kLd), one 4-byte
// cp.async a value: thread t copies value q = t % kCh of rows t / kCh + i *
// (kThr / kCh), so a warp reads runs of kCh consecutive values.  Rows past
// `n` and values past D are zero (they are never read as real data: a row
// past n is not stored, a word past K scores +inf, and q past D is not
// summed).
template <int kN, int kLd, int kThr, int kCh>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, size_t r0, int n,
                                      int D, int q0) {
  constexpr int kRowsPass = kThr / kCh;
  const int q = threadIdx.x % kCh, rb = threadIdx.x / kCh;
  const bool in_q = q0 + q < D;
  const float* s = src + (r0 + rb) * size_t(D) + q0 + q;
#pragma unroll
  for (int i = 0; i < kN / kRowsPass; ++i) {
    const int r = rb + i * kRowsPass;
    float* d = dst + q * kLd + r;
    if (r < n && in_q)
      cp_async4(d, s + size_t(i) * kRowsPass * D);
    else
      *d = 0.0f;
  }
}

// The nearest word of each of the block's rows (row0 .. row0 + n - 1 of a
// row-major (rows, D) matrix) among the words of codebook tiles tile0,
// tile0 + step, ...: the minimum over those k of s = -2 d.c_k + |c_k|^2,
// ties to the lowest k.  Every thread of the block calls it, with `sm` the
// block's Search::kFloats floats of shared memory; on return the thread
// with tx == 0 of each ty holds, for rows kMR ty + i, the minimum best[i]
// and its word best_k[i]; with kDD, d2_s[r] holds |d_r|^2.
template <int kRows, int kWords, int kThr, int kCh, int kMR, int kMW, bool kDD>
__device__ void nearest_words(const float* __restrict__ descs, const float* __restrict__ cents,
                              size_t row0, int n, int D, int K, int tile0, int step, float* sm,
                              float (&best)[kMR], int (&best_k)[kMR], float*& d2_out) {
  using G = Search<kRows, kWords, kThr, kCh, kMR, kMW>;
  static_assert(!kDD || kThr >= kWords + kRows, "a thread a row's |d|^2");
  float* ds = sm;                               // [2][kCh][kLdR] rows
  float* cs = ds + 2 * kCh * G::kLdR;           // [2][kCh][kLdW] words
  float* c2_s = cs + 2 * kCh * G::kLdW;         // [kWords] |c|^2 of the tile's words
  float* d2_s = c2_s + kWords;                  // [kRows] |d|^2 of the rows
  const int tid = threadIdx.x, tx = tid % G::kTx, ty = tid / G::kTx;
  const int n_chunks = (D + kCh - 1) / kCh;
  const int n_tiles = ((K + kWords - 1) / kWords - tile0 + step - 1) / step;
  const int total = n_chunks * n_tiles;

  float acc[kMR][kMW];
#pragma unroll
  for (int i = 0; i < kMR; ++i) {
    best[i] = CUDART_INF_F;
    best_k[i] = 0;
#pragma unroll
    for (int j = 0; j < kMW; ++j) acc[i][j] = -0.0f;
  }
  // word tid + j kThr's |c|^2; with kDD, thread kWords + r sums row r's |d|^2
  float c2[G::kC2], d2 = -0.0f;
#pragma unroll
  for (int j = 0; j < G::kC2; ++j) c2[j] = -0.0f;

  int k0 = tile0 * kWords;
  stage<kRows, G::kLdR, kThr, kCh>(ds, descs, row0, n, D, 0);
  stage<kWords, G::kLdW, kThr, kCh>(cs, cents, k0, K - k0, D, 0);
  cp_async_commit();
  int ch = 0;
  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    if (it + 1 < total) {  // the next chunk flies while this one computes
      const int nch = ch + 1 == n_chunks ? 0 : ch + 1;
      const int nk0 = ch + 1 == n_chunks ? k0 + step * kWords : k0;
      stage<kRows, G::kLdR, kThr, kCh>(ds + (buf ^ 1) * kCh * G::kLdR, descs, row0, n, D,
                                       nch * kCh);
      stage<kWords, G::kLdW, kThr, kCh>(cs + (buf ^ 1) * kCh * G::kLdW, cents, nk0, K - nk0, D,
                                        nch * kCh);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const float* dq = ds + buf * kCh * G::kLdR;
    const float* cq = cs + buf * kCh * G::kLdW;
    const int nq = min(kCh, D - ch * kCh);
#pragma unroll 4
    for (int q = 0; q < nq; ++q) {
      float av[kMR], bv[kMW];
#pragma unroll
      for (int i = 0; i < kMR; i += 4) {
        const float4 a = *reinterpret_cast<const float4*>(dq + q * G::kLdR + kMR * ty + i);
        av[i] = a.x, av[i + 1] = a.y, av[i + 2] = a.z, av[i + 3] = a.w;
      }
#pragma unroll
      for (int j = 0; j < kMW; j += 4) {
        const float4 b =
            *reinterpret_cast<const float4*>(cq + q * G::kLdW + 4 * tx + G::kTx * j);
        bv[j] = b.x, bv[j + 1] = b.y, bv[j + 2] = b.z, bv[j + 3] = b.w;
      }
#pragma unroll
      for (int i = 0; i < kMR; ++i)
#pragma unroll
        for (int j = 0; j < kMW; ++j) acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(av[i], bv[j]));
#pragma unroll
      for (int j = 0; j < G::kC2; ++j) {
        if (tid + j * kThr < kWords) {
          const float c = cq[q * G::kLdW + tid + j * kThr];
          c2[j] = __fadd_rn(c2[j], __fmul_rn(c, c));
        } else if (kDD && j == 0 && k0 == 0 && tid < kWords + kRows) {
          const float d = dq[q * G::kLdR + tid - kWords];
          d2 = __fadd_rn(d2, __fmul_rn(d, d));
        }
      }
    }
    if (ch + 1 == n_chunks) {  // the tile's sums are whole: score its words
#pragma unroll
      for (int j = 0; j < G::kC2; ++j) {
        const int w = tid + j * kThr;
        if (w < kWords) c2_s[w] = k0 + w < K ? c2[j] : CUDART_INF_F;
        c2[j] = -0.0f;
      }
      if (kDD && k0 == 0 && tid >= kWords && tid < kWords + kRows) d2_s[tid - kWords] = d2;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kMW; ++j) {
        const int w = 4 * tx + G::kTx * (j & ~3) + (j & 3);  // ascending in j
        const float cj = c2_s[w];
#pragma unroll
        for (int i = 0; i < kMR; ++i) {
          const float s = __fadd_rn(__fmul_rn(-2.f, acc[i][j]), cj);
          if (s < best[i]) {  // strict: ascending k keeps the lowest word on ties
            best[i] = s;
            best_k[i] = k0 + w;
          }
          acc[i][j] = -0.0f;
        }
      }
      ch = 0;
      k0 += step * kWords;
    } else {
      ++ch;
    }
    __syncthreads();  // this chunk is consumed before its buffer is staged again
  }
  // merge the kTx threads of each row group (adjacent lanes of one warp)
#pragma unroll
  for (int i = 0; i < kMR; ++i) {
    for (int off = G::kTx / 2; off > 0; off >>= 1) {
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

using AssignSearch = Search<kTileN, kTileK, kThreads, kChunk, kMicro, kMicro>;
using HistSearch =
    Search<kHistRows, kHistWords, kHistThreads, kHistChunk, kHistMicroRows, kHistMicroWords>;

// bow_quantize_hist's shared memory beyond the search's, in 4-byte words:
// rank 0's weights and merged words of the tile's rows, and the (min, word)
// pair of each rank and row, double-buffered by the parity of the row tile
// (rank r writes tile t + 1's pairs while rank 0 may still read tile t's).
constexpr int kHistExtra = 2 * kHistRows + 2 * 2 * kHistMaxRanks * kHistRows;

__device__ __forceinline__ float weight(const void* __restrict__ valids, int vbytes, size_t i) {
  return vbytes == 1 ? float(static_cast<const uint8_t*>(valids)[i])
                     : static_cast<const float*>(valids)[i];
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

static_assert(kHistThreads >= kHistRows, "a thread a row's weight");

// One cluster of S CTAs an image (1-D clusters: image blockIdx.x / S, rank
// blockIdx.x % S).  valids are (B, N) of vbytes 1 (bool / u8) or 4 (f32);
// hist (B, K) is written whole by rank 0.
__global__ void __launch_bounds__(kHistThreads, kHistMinBlocks)
    quantize_hist_kernel(const float* __restrict__ descs, const void* __restrict__ valids,
                         int vbytes, const float* __restrict__ cents, float* __restrict__ hist,
                         int N, int D, int K, int S, int normalize) {
  extern __shared__ __align__(16) float sm[];
  float* w_s = sm + HistSearch::kFloats;               // [kHistRows] (rank 0)
  int* win_s = reinterpret_cast<int*>(w_s + kHistRows);  // [kHistRows] (rank 0)
  float* cand_v = w_s + 2 * kHistRows;                  // [2][kHistMaxRanks][kHistRows]
  int* cand_k = reinterpret_cast<int*>(cand_v + 2 * kHistMaxRanks * kHistRows);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const size_t b = blockIdx.x / unsigned(S);
  const int tid = threadIdx.x;
  float* cand_v0 = cluster.map_shared_rank(cand_v, 0);
  int* cand_k0 = cluster.map_shared_rank(cand_k, 0);
  float* hrow = hist + b * K;
  float total = 0.0f;  // rank 0: the image's weights summed in ascending n
  cluster_arrive_relaxed();  // this CTA runs: the others may write its shared memory

  for (int n0 = 0, t = 0; n0 < N; n0 += kHistRows, ++t) {
    const int nr = min(kHistRows, N - n0);
    // rank 0's weights of the tile's rows, loaded before the search hides
    // their latency and stored after it (the search's barriers order the
    // store after the previous tile's histogram read w_s)
    const float w = rank == 0 && tid < nr ? weight(valids, vbytes, b * N + n0 + tid) : 0.0f;
    float best[kHistMicroRows], *unused;
    int best_k[kHistMicroRows];
    nearest_words<kHistRows, kHistWords, kHistThreads, kHistChunk, kHistMicroRows,
                  kHistMicroWords, false>(descs, cents, b * N + n0, nr, D, K, rank, S, sm, best,
                                          best_k, unused);
    if (rank == 0 && tid < kHistRows) w_s[tid] = w;
    if (t == 0) cluster_wait();  // every rank of the cluster runs
    const int p = (t & 1) * kHistMaxRanks * kHistRows + rank * kHistRows;
    if (tid % HistSearch::kTx == 0) {
#pragma unroll
      for (int i = 0; i < kHistMicroRows; ++i) {
        const int r = kHistMicroRows * (tid / HistSearch::kTx) + i;
        cand_v0[p + r] = best[i];
        cand_k0[p + r] = best_k[i];
      }
    }
    cluster.sync();  // every rank's pairs of this tile are in rank 0's shared memory
    if (rank != 0) continue;
    for (int r = tid; r < kHistRows; r += kHistThreads) {  // merge on (value, word), ascending rank
      const int q = (t & 1) * kHistMaxRanks * kHistRows + r;
      float v = cand_v[q];
      int k = cand_k[q];
      for (int o = 1; o < S; ++o) {
        const float ov = cand_v[q + o * kHistRows];
        const int ok = cand_k[q + o * kHistRows];
        if (ov < v || (ov == v && ok < k)) {
          v = ov;
          k = ok;
        }
      }
      win_s[r] = k;
    }
    __syncthreads();
    for (int r = 0; r < nr; ++r) total = __fadd_rn(total, w_s[r]);
    const bool last = n0 + kHistRows >= N;
    const float den = fmaxf(total, 1e-6f);
    for (int k = tid; k < K; k += kHistThreads) {
      float h = t == 0 ? 0.0f : hrow[k];  // this thread's own partial sum of the last tile
      for (int r = 0; r < nr; ++r)
        if (win_s[r] == k) h = __fadd_rn(h, w_s[r]);
      hrow[k] = last && normalize ? __fdiv_rn(h, den) : h;
    }
  }
}

// Four blocks an SM (64 registers a thread): the 500 blocks of a training
// assignment (32,000 rows) run in one wave on 132 SMs.
__global__ void __launch_bounds__(kThreads, 4)
    bow_assign_kernel(const float* __restrict__ descs, const float* __restrict__ cents,
                      int* __restrict__ idx, float* __restrict__ d2, int N, int D, int K) {
  extern __shared__ __align__(16) float sm[];
  const size_t row0 = size_t(blockIdx.x) * kTileN;
  float best[kMicro], *d2_s;
  int best_k[kMicro];
  nearest_words<kTileN, kTileK, kThreads, kChunk, kMicro, kMicro, true>(
      descs, cents, row0, min(kTileN, int(N - row0)), D, K, 0, 1, sm, best, best_k, d2_s);
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

// bow_assign's shared memory: two chunks of rows and of words, the tile's
// |c|^2 and the rows' |d|^2.
extern "C" int nearest_words_smem_bytes() { return int(AssignSearch::kFloats * sizeof(float)); }

// A bow_quantize_hist CTA's shared memory: its search's, then rank 0's
// weights, merged words and the ranks' (min, word) pairs.
extern "C" int quantize_hist_smem_bytes() {
  return int((HistSearch::kFloats + kHistExtra) * sizeof(float));
}

// The CTAs of one image's cluster: one a codebook tile of kHistWords
// words, at most kHistMaxRanks.
extern "C" int quantize_hist_ranks(int K) {
  const int tiles = (K + kHistWords - 1) / kHistWords;
  return tiles < kHistMaxRanks ? tiles : kHistMaxRanks;
}

// How many clusters of quantize_hist_ranks(K) CTAs the card holds at once
// (cudaOccupancyMaxActiveClusters), or a negative cudaError_t.
extern "C" int quantize_hist_max_clusters(int K) {
  const int S = quantize_hist_ranks(K);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(S) * 1024u);
  cfg.blockDim = dim3(kHistThreads);
  cfg.dynamicSmemBytes = size_t(quantize_hist_smem_bytes());
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(S);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, quantize_hist_kernel, &cfg);
  return err == cudaSuccess ? n : -int(err);
}

// hist (B, K) is written whole (normalised when `normalize`): it needs no
// zeroing.  valids (B, N) hold vbytes = 1 (bool / u8) or 4 (f32) a value.
// B, N or K = 0 launches nothing.  Returns the launch's cudaError_t, else
// cudaGetLastError().
extern "C" int quantize_hist_launch(const float* descs, const void* valids, int vbytes,
                                    const float* cents, float* hist, int B, int N, int D, int K,
                                    int normalize, void* stream) {
  if (B == 0 || N == 0 || K == 0) return 0;
  if (vbytes != 1 && vbytes != 4) return int(cudaErrorInvalidValue);
  const int S = quantize_hist_ranks(K);
  if ((long long)B * S > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(B * S));
  cfg.blockDim = dim3(kHistThreads);
  cfg.dynamicSmemBytes = size_t(quantize_hist_smem_bytes());
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(S);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, quantize_hist_kernel, descs, valids, vbytes,
                                             cents, hist, N, D, K, S, normalize);
  if (err != cudaSuccess) return int(err);
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
