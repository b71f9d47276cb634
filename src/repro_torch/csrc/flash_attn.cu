// Flash attention forward: online-softmax attention of q (B, S, H, hd) over
// k / v (B, T, H, hd), one head of q per head of k / v.
//
// flash_attn replaces src/repro/kernels/attention.py `_flash_kernel` (via
// `flash_attention`, l.70).  Bound on an H100: operations.  At gemma-7b's
// prefill (B = 8, S = T = 1024, 16 heads of 256, causal, bf16) it does
// 34.4 GFLOP of products and sums in q.k and as many in p.v (the causal
// half).  q.k multiplies bf16 operands, exact in f32, so the card could run
// it on its tensor cores at 989 TFLOP/s (~0.035 ms); p.v takes f32
// probabilities and needs f32 arithmetic at 67 TFLOP/s (~0.51 ms): ~0.55 ms
// in all.  It moves ~268 MB (q, k, v read once, o written once), ~0.08 ms at
// 3.35 TB/s.
//
// Design: the TPU kernel runs a sequential grid axis over KV blocks and
// carries (m, l, acc) in VMEM scratch from step to step; here one block of
// 256 threads owns one (batch, head, 64-row query tile) and loops over the
// 64-row KV tiles itself, so nothing is carried between blocks.  q, k and v
// are read in place in their (B, S, H, hd) layout (a head's rows are H * hd
// apart) and staged in shared memory in their own dtype, as 32-bit words,
// with 16-byte loads: at hd 256 in bf16 the q, k and v tiles take 98 KB and
// the scores 16 KB, which f32 staging (4 x 64 KB) would not fit.  Rows of q
// and k are padded by one word so that the 16 threads reading 16 different
// key rows hit 16 different banks.  Each thread computes a 4 x 4 block of the
// score tile (rows ty*4+r, keys tx+16c), then four threads per row run the
// online softmax (max and sum by shuffles), then each thread accumulates
// p.v for its 4 rows and its words tx+16c of the head dimension in
// registers.  Under `causal`, KV tiles that lie wholly above the tile's last
// query row are skipped (every entry there is masked), and the blocks of the
// longest rows start first.  No tensor cores: the arithmetic is f32 FMAs,
// as the TPU kernel casts q, k and v to f32 (wgmma is for a later PR).
//
// Arithmetic, as `_flash_kernel`: s = (q.k) * scale with scale = 1/sqrt(hd);
// entries with ki >= T, or ki > qi under causal, are NEG = -1e30; m_new =
// max(m, max s); m_safe = 0 while m_new <= NEG/2 (the row is masked so far);
// p = exp(s - m_safe); corr = 0 while m <= NEG/2, else exp(m - m_safe);
// l = l*corr + sum p; acc = acc*corr + p.v; out = acc / max(l, 1e-30),
// rounded to q's dtype.  Dot products are summed in index order, one FMA at
// a time; `flash_attention_plain` sums them in PyTorch's order, so the two
// agree to rounding, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // key / value rows per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int TR = 4;         // rows per thread (BQ / 16)
constexpr int TC = 4;         // score columns per thread (BKV / 16)
constexpr int PS = BKV + 1;   // row stride of the score tile, in floats
constexpr float NEG = -1e30f;

// A 32-bit word of shared memory holds PER_WORD elements of T.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int PER_WORD = 1;
  __device__ static void unpack(uint32_t w, float* f) { f[0] = __uint_as_float(w); }
  __device__ static uint32_t pack(const float* f) { return __float_as_uint(f[0]); }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int PER_WORD = 2;
  __device__ static void unpack(uint32_t w, float* f) {  // element 0 is the low half
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static uint32_t pack(const float* f) {
    __nv_bfloat162 h = __floats2bfloat162_rn(f[0], f[1]);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

template <>
struct Elem<__half> {
  static constexpr int PER_WORD = 2;
  __device__ static void unpack(uint32_t w, float* f) {
    const float2 v = __half22float2(*reinterpret_cast<const __half2*>(&w));
    f[0] = v.x;
    f[1] = v.y;
  }
  __device__ static uint32_t pack(const float* f) {
    __half2 h = __floats2half2_rn(f[0], f[1]);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

// Rows r0 .. r0 + BQ-or-BKV of one head into shared memory (row stride ds
// words), 16 bytes at a time; rows at or past `valid` are zeros.
template <int ROWS>
__device__ void stage_rows(uint32_t* dst, int ds, const uint32_t* src, size_t rs, int r0, int valid,
                           int W) {
  const int W4 = W >> 2;
  for (int e = threadIdx.x; e < ROWS * W4; e += THREADS) {
    const int r = e / W4, c = (e - r * W4) * 4;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < valid) val = *reinterpret_cast<const uint4*>(src + size_t(r0 + r) * rs + c);
    uint32_t* d = dst + r * ds + c;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

// CPW: head-dimension words per thread in the p.v product (16 * CPW >= W).
template <typename T, int CPW>
__global__ void __launch_bounds__(THREADS)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, int S, int Tk, int H, int hd, int causal, float scale,
                      int n_qt, int BH) {
  using E = Elem<T>;
  constexpr int PW = E::PER_WORD;
  const int W = hd / PW;  // words per row
  const int WS = W + 1;   // padded stride of the q and k tiles
  extern __shared__ uint32_t smem[];
  uint32_t* q_s = smem;                                     // BQ * WS
  uint32_t* k_s = q_s + BQ * WS;                            // BKV * WS
  uint32_t* v_s = k_s + BKV * WS;                           // BKV * W
  float* p_s = reinterpret_cast<float*>(v_s + BKV * W);     // BQ * PS
  float* m_s = p_s + BQ * PS;                               // BQ
  float* l_s = m_s + BQ;                                    // BQ
  float* c_s = l_s + BQ;                                    // BQ

  const int qt = n_qt - 1 - int(blockIdx.x / unsigned(BH));  // longest causal rows first
  const int bh = int(blockIdx.x % unsigned(BH));
  const int b = bh / H, h = bh - b * H;
  const int q0 = qt * BQ;
  const size_t rs = size_t(H) * W;  // words between two rows of one head
  const uint32_t* qg = reinterpret_cast<const uint32_t*>(q) + (size_t(b) * S * H + h) * W;
  const uint32_t* kg = reinterpret_cast<const uint32_t*>(k) + (size_t(b) * Tk * H + h) * W;
  const uint32_t* vg = reinterpret_cast<const uint32_t*>(v) + (size_t(b) * Tk * H + h) * W;
  uint32_t* og = reinterpret_cast<uint32_t*>(o) + (size_t(b) * S * H + h) * W;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  float acc[TR][CPW * PW];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int i = 0; i < CPW * PW; ++i) acc[r][i] = 0.f;
  if (tid < BQ) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  stage_rows<BQ>(q_s, WS, qg, rs, q0, S, W);

  // under causal, keys past the tile's last query row are masked for all rows
  const int kv_end = causal ? min(Tk, min(q0 + BQ, S)) : Tk;
  const int n_kv = (kv_end + BKV - 1) / BKV;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // the previous tile's readers are done
    stage_rows<BKV>(k_s, WS, kg, rs, k0, Tk, W);
    stage_rows<BKV>(v_s, W, vg, rs, k0, Tk, W);
    __syncthreads();

    // scores: rows ty*4 + r, keys tx + 16c
    float s[TR][TC];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < TC; ++c) s[r][c] = 0.f;
#pragma unroll 2
    for (int w = 0; w < W; ++w) {
      float qf[TR][PW], kf[TC][PW];
#pragma unroll
      for (int r = 0; r < TR; ++r) E::unpack(q_s[(ty * TR + r) * WS + w], qf[r]);
#pragma unroll
      for (int c = 0; c < TC; ++c) E::unpack(k_s[(tx + 16 * c) * WS + w], kf[c]);
#pragma unroll
      for (int e = 0; e < PW; ++e)
#pragma unroll
        for (int r = 0; r < TR; ++r)
#pragma unroll
          for (int c = 0; c < TC; ++c) s[r][c] = fmaf(qf[r][e], kf[c][e], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int qi = q0 + ty * TR + r;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int ki = k0 + tx + 16 * c;
        const bool ok = ki < Tk && (!causal || ki <= qi);
        p_s[(ty * TR + r) * PS + tx + 16 * c] = ok ? s[r][c] * scale : NEG;
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes per row, 16 entries each
    {
      const int row = tid >> 2, part = tid & 3;
      float* pr = p_s + row * PS;
      float mx = NEG;
#pragma unroll
      for (int j = part; j < BKV; j += 4) mx = fmaxf(mx, pr[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = m_new <= NEG * 0.5f ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = part; j < BKV; j += 4) {
        const float p = expf(pr[j] - m_safe);
        pr[j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = m_prev <= NEG * 0.5f ? 0.f : expf(m_prev - m_safe);
        l_s[row] = l_s[row] * corr + sum;
        m_s[row] = m_new;
        c_s[row] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p.v over the tile's real keys (p is 0 past them)
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const float corr = c_s[ty * TR + r];
#pragma unroll
      for (int i = 0; i < CPW * PW; ++i) acc[r][i] *= corr;
    }
    const int jn = min(BKV, Tk - k0);
    for (int j = 0; j < jn; ++j) {
      float pj[TR];
#pragma unroll
      for (int r = 0; r < TR; ++r) pj[r] = p_s[(ty * TR + r) * PS + j];
#pragma unroll
      for (int c = 0; c < CPW; ++c) {
        const int w = tx + 16 * c;
        if (w < W) {
          float vf[PW];
          E::unpack(v_s[j * W + w], vf);
#pragma unroll
          for (int e = 0; e < PW; ++e)
#pragma unroll
            for (int r = 0; r < TR; ++r)
              acc[r][c * PW + e] = fmaf(pj[r], vf[e], acc[r][c * PW + e]);
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int row = q0 + ty * TR + r;
    if (row >= S) continue;
    const float den = fmaxf(l_s[ty * TR + r], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPW; ++c) {
      const int w = tx + 16 * c;
      if (w < W) {
        float f[PW];
#pragma unroll
        for (int e = 0; e < PW; ++e) f[e] = acc[r][c * PW + e] / den;
        og[size_t(row) * rs + w] = E::pack(f);
      }
    }
  }
}

size_t smem_bytes(int W) {
  return 4 * (size_t(BQ + BKV) * (W + 1) + size_t(BKV) * W + size_t(BQ) * PS + 3 * BQ);
}

template <typename T, int CPW>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int Tk, int H,
           int hd, int causal, size_t smem, cudaStream_t stream) {
  const int n_qt = (S + BQ - 1) / BQ;
  const long long blocks = (long long)n_qt * B * H;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(flash_attn_kernel<T, CPW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const float scale = float(1.0 / sqrt(double(hd)));
  flash_attn_kernel<T, CPW><<<unsigned(blocks), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, Tk, H, hd, causal, scale, n_qt, B * H);
  return int(cudaGetLastError());
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, void* o, int B, int S, int Tk,
                 int H, int hd, int causal, int smem_max, cudaStream_t stream) {
  const int W = hd * int(sizeof(T)) / 4;
  const size_t smem = smem_bytes(W);
  if (smem > size_t(smem_max)) return int(cudaErrorInvalidValue);
  const int need = (W + 15) / 16;
  if (need <= 1) return launch<T, 1>(q, k, v, o, B, S, Tk, H, hd, causal, smem, stream);
  if (need <= 2) return launch<T, 2>(q, k, v, o, B, S, Tk, H, hd, causal, smem, stream);
  if (need <= 4) return launch<T, 4>(q, k, v, o, B, S, Tk, H, hd, causal, smem, stream);
  if (need <= 8) return launch<T, 8>(q, k, v, o, B, S, Tk, H, hd, causal, smem, stream);
  return launch<T, 16>(q, k, v, o, B, S, Tk, H, hd, causal, smem, stream);
}

}  // namespace

// Returns cudaGetLastError().  dtype: 0 f32, 1 f16, 2 bf16.  q and o are
// contiguous (B, S, H, hd), k and v (B, T, H, hd), 16-byte aligned, with
// hd a multiple of 8 in [8, 256]; anything else, or a block's shared memory
// above smem_max, is refused with cudaErrorInvalidValue before a launch.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* o, int B,
                                 int S, int Tk, int H, int hd, int dtype, int causal, int smem_max,
                                 void* stream) {
  if (hd < 8 || hd > 256 || hd % 8 != 0) return int(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dtype<float>(q, k, v, o, B, S, Tk, H, hd, causal, smem_max, st);
    case 1:
      return launch_dtype<__half>(q, k, v, o, B, S, Tk, H, hd, causal, smem_max, st);
    case 2:
      return launch_dtype<__nv_bfloat16>(q, k, v, o, B, S, Tk, H, hd, causal, smem_max, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}
