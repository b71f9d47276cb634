// The oblivious-tree GBDT head: leaf indices and ensemble scores.
//
// gbdt_score replaces src/repro/kernels/gbdt.py `_gbdt_kernel` (via
// `gbdt_score`).  Bound on an H100: bytes, and below a launch's latency.
// At the predict request (B = 256 histograms of F = 250 words, 16 trees of
// depth 3, 10 classes) it reads ~0.26 MB and does ~0.05 M compares and adds,
// ~0.08 us at 3.35 TB/s.  The TPU kernel turns the gathers into four one-hot
// matmuls because the TPU has no fast gather; here the gathers are direct.
//
// Design: one warp a row, kWarps rows a block (64 blocks at B = 256, one
// wave on 132 SMs).  Nothing is staged: feat, thr, leaf and base are read
// through the read-only path, so there is no shared memory, no barrier and
// no limit on the model's size.  For each chunk of 32 trees, lane t computes
// tree t0 + t's leaf index: it issues the loads of feat and thr, then the
// gathers of x[row, feat[t, l]], for kLevels levels at a time before it
// compares any (strict: x == thr goes left; level l is bit 2^l).  Then lane
// c of each chunk of 32 classes takes tree j's leaf index from lane j by
// __shfl_sync, issues kLeaves loads of leaf[t, li_t, c] at a time (a warp
// reads 32 consecutive floats of one leaf) and only then adds them in
// ascending t.  More than 32 classes repeat the tree walk for each class
// chunk; only the first writes the leaf indices.
//
// What the time follows (scripts/torch_gbdt_sweep.py on an H100): the
// instructions a warp issues, not the dependent load round trips.  Every
// unrolled slot issues its shuffle and its predicated load whether or not a
// tree or level fills it, so the constants are small: kLevels = 4 covers the
// predict head's depth 3, and kLeaves = 16 its 16 trees in one round.

// Arithmetic: fp32 on CUDA cores, every sum rounded on its own (__fadd_rn),
// the first tree's value as the start, the base added last: the order of
// gbdt_score_plain in kernels/gbdt.py, so the two agree bit for bit.  A
// feature index outside [0, F) is never read: that tree's leaf index is -1
// and the row's scores are NaN.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 4;   // rows a block, one warp each
constexpr int kLevels = 4;  // levels whose gathers are in flight before their compares
constexpr int kLeaves = 16;  // leaf loads in flight before their adds

__global__ void __launch_bounds__(kWarps * 32)
    gbdt_score_kernel(const float* __restrict__ x, const int* __restrict__ feat,
                      const float* __restrict__ thr, const float* __restrict__ leaf,
                      const float* __restrict__ base, float* __restrict__ scores,
                      int* __restrict__ lidx, int B, int F, int T, int depth, int C) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B) return;  // the whole warp: row is the same on every lane
  const float* xr = x + size_t(row) * F;
  const size_t L = size_t(1) << depth;
  const int class_chunks = C > 32 ? (C + 31) / 32 : 1;  // one pass also when C == 0

  for (int cc = 0; cc < class_chunks; ++cc) {
    const int c = cc * 32 + lane;
    const bool has_c = c < C;
    const float bc = has_c ? __ldg(base + c) : 0.f;
    float acc = 0.f;
    for (int t0 = 0; t0 < T; t0 += 32) {
      const int t = t0 + lane;
      int li = 0;
      if (t < T) {
        const int* ft = feat + size_t(t) * depth;
        const float* th = thr + size_t(t) * depth;
        bool bad = false;
        for (int l0 = 0; l0 < depth; l0 += kLevels) {
          int f[kLevels];
          float tv[kLevels], xv[kLevels];
#pragma unroll
          for (int u = 0; u < kLevels; ++u) {
            f[u] = l0 + u < depth ? __ldg(ft + l0 + u) : 0;
            tv[u] = l0 + u < depth ? __ldg(th + l0 + u) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kLevels; ++u) {
            const bool ok = f[u] >= 0 && f[u] < F;
            bad |= l0 + u < depth && !ok;
            xv[u] = l0 + u < depth && ok ? __ldg(xr + f[u]) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kLevels; ++u)
            if (l0 + u < depth && xv[u] > tv[u]) li |= 1 << (l0 + u);
        }
        if (bad) li = -1;
        if (cc == 0) lidx[size_t(row) * T + t] = li;
      }
      const int nt = min(32, T - t0);  // the same on every lane
      for (int j0 = 0; j0 < nt; j0 += kLeaves) {
        float v[kLeaves];
#pragma unroll
        for (int u = 0; u < kLeaves; ++u) {
          const int j = j0 + u;
          const int lj = __shfl_sync(0xffffffffu, li, j & 31);
          v[u] = CUDART_NAN_F;
          if (j < nt && has_c && lj >= 0) v[u] = __ldg(leaf + (size_t(t0 + j) * L + lj) * C + c);
        }
#pragma unroll
        for (int u = 0; u < kLeaves; ++u)
          if (j0 + u < nt) acc = t0 + j0 + u == 0 ? v[u] : __fadd_rn(acc, v[u]);
      }
    }
    if (has_c) scores[size_t(row) * C + c] = __fadd_rn(acc, bc);
  }
}

}  // namespace

// Returns cudaGetLastError().  No dynamic shared memory, so any model size
// launches.
extern "C" int gbdt_score_launch(const float* x, const int* feat, const float* thr,
                                 const float* leaf, const float* base, float* scores, int* lidx,
                                 int B, int F, int T, int depth, int C, void* stream) {
  const long long blocks = (B + (long long)kWarps - 1) / kWarps;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  gbdt_score_kernel<<<unsigned(blocks), kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      x, feat, thr, leaf, base, scores, lidx, B, F, T, depth, C);
  return int(cudaGetLastError());
}
