// The oblivious-tree GBDT head: leaf indices and ensemble scores.
//
// gbdt_score replaces src/repro/kernels/gbdt.py `_gbdt_kernel` (via
// `gbdt_score`).  Bound on an H100: bytes, and below a launch's latency.
// At the predict request (B = 256 histograms of F = 250 words, 16 trees of
// depth 3, 10 classes) it reads ~0.26 MB and does ~0.05 M compares and adds,
// ~0.08 us at 3.35 TB/s.  Design: the TPU kernel turns the gathers into four
// one-hot matmuls because the TPU has no fast gather; here the gathers are
// direct.  A block stages feat, thr and the leaf table (T * 2^depth * C
// floats: 5 KB at the default model) in shared memory.  One thread per
// (row, tree) compares x[feat[t, l]] > thr[t, l] (strict: x == thr goes
// left) and packs level l as bit 2^l; then one thread per (row, class) sums
// leaf[t, li_t, c] over ascending t and adds base[c] last.
//
// Arithmetic: fp32 on CUDA cores, every sum rounded on its own (__fadd_rn),
// in the order of gbdt_score_plain in kernels/gbdt.py, so the two agree bit
// for bit.  A feature index outside [0, F) is never read: that tree's leaf
// index is -1 and the row's scores are NaN.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__global__ void gbdt_score_kernel(const float* __restrict__ x, const int* __restrict__ feat,
                                  const float* __restrict__ thr, const float* __restrict__ leaf,
                                  const float* __restrict__ base, float* __restrict__ scores,
                                  int* __restrict__ lidx, int B, int F, int T, int depth, int C,
                                  int rows) {
  extern __shared__ float sm[];
  const int L = 1 << depth;
  const int TD = T * depth;
  float* leaf_s = sm;                                          // T * L * C
  float* thr_s = leaf_s + T * L * C;                           // T * depth
  int* feat_s = reinterpret_cast<int*>(thr_s + TD);            // T * depth
  int* li_s = feat_s + TD;                                     // rows * T
  for (int e = threadIdx.x; e < T * L * C; e += blockDim.x) leaf_s[e] = leaf[e];
  for (int e = threadIdx.x; e < TD; e += blockDim.x) {
    thr_s[e] = thr[e];
    feat_s[e] = feat[e];
  }
  __syncthreads();

  const int r0 = blockIdx.x * rows;
  for (int e = threadIdx.x; e < rows * T; e += blockDim.x) {
    const int r = e / T, t = e - r * T, row = r0 + r;
    if (row >= B) continue;
    const float* xr = x + size_t(row) * F;
    int li = 0;
    for (int l = 0; l < depth; ++l) {
      const int f = feat_s[t * depth + l];
      if (f < 0 || f >= F) {
        li = -1;
        break;
      }
      if (xr[f] > thr_s[t * depth + l]) li |= 1 << l;
    }
    li_s[e] = li;
    lidx[size_t(row) * T + t] = li;
  }
  __syncthreads();

  for (int e = threadIdx.x; e < rows * C; e += blockDim.x) {
    const int r = e / C, c = e - r * C, row = r0 + r;
    if (row >= B) continue;
    float acc = 0.f;
    for (int t = 0; t < T; ++t) {
      const int li = li_s[r * T + t];
      const float v = li < 0 ? CUDART_NAN_F : leaf_s[(t * L + li) * C + c];
      acc = t == 0 ? v : __fadd_rn(acc, v);
    }
    scores[size_t(row) * C + c] = __fadd_rn(acc, base[c]);
  }
}

}  // namespace

// Returns cudaGetLastError().  smem_max bounds the block's shared memory
// (model tables + the block's leaf indices); a model that does not fit is
// refused with cudaErrorInvalidValue before anything launches.
extern "C" int gbdt_score_launch(const float* x, const int* feat, const float* thr,
                                 const float* leaf, const float* base, float* scores, int* lidx,
                                 int B, int F, int T, int depth, int C, int rows, int threads,
                                 int smem_max, void* stream) {
  const long long blocks = (B + (long long)rows - 1) / rows;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  const size_t smem =
      (size_t(T) * (size_t(1) << depth) * C + 2 * size_t(T) * depth + size_t(rows) * T) * 4;
  if (smem > size_t(smem_max)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      gbdt_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  gbdt_score_kernel<<<unsigned(blocks), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, feat, thr, leaf, base, scores, lidx, B, F, T, depth, C, rows);
  return int(cudaGetLastError());
}
