// Flash attention forward: online-softmax attention of q (B, S, H, hd) over
// k / v (B, T, Hkv, hd) with H % Hkv == 0: query head h reads KV head
// h / (H / Hkv), one group of H / Hkv query heads per KV head (GQA; MHA at
// Hkv == H, MQA at Hkv == 1).  No KV is repeated: the blocks of one group
// lie next to each other in the grid (adjacent heads, adjacent blocks), so
// they read the same K and V tiles while those sit in L2.  Repeating K and V
// instead would write and read ~0.27 GB a layer at qwen2-72b's 8 x 1024
// prefill (64 query heads over 8), ~0.16 ms at 3.35 TB/s.
//
// flash_attn replaces src/repro/kernels/attention.py `_flash_kernel` (via
// `flash_attention`, l.70).  Bound on an H100: operations.  At gemma-7b's
// prefill (B = 8, S = T = 1024, 16 heads of 256, causal, bf16) the causal
// half of q.k is 34.4 GFLOP of products and sums, and p.v as many.  It moves
// ~268 MB (q, k, v read once, o written once), ~0.08 ms at 3.35 TB/s.
//
// Arithmetic, as `_flash_kernel`: s = (q.k) * scale with scale = 1/sqrt(hd);
// entries with ki >= T, or ki > qi under causal, are NEG = -1e30, where query
// row i stands at position qi = q_off + i (a slice of a longer sequence's
// queries; q_off = 0 by default and changes nothing but the mask); m_new =
// max(m, max s); m_safe = 0 while m_new <= NEG/2 (the row is masked so far);
// p = exp(s - m_safe); corr = 0 while m <= NEG/2, else exp(m - m_safe);
// l = l*corr + sum p; acc = acc*corr + p.v; out = acc / max(l, 1e-30),
// rounded to q's dtype.  When asked (lse not null), each query row's
// log-sum-exp over the keys it sees is written too, in f32, (B, H, S):
// lse = m_safe + logf(l) in natural-log units of the scaled scores, NEG for
// a row that sees no key (l == 0).  A split-K decode merges the normalised
// outputs of slices of the keys by these weights.  The stores of o are the
// same with or without it.  `flash_attention_plain` sums in PyTorch's order, so
// the two agree to rounding, not bit for bit.
//
// f16 / bf16 (the serving path): flash_attn_wgmma_kernel, on the tensor
// cores.  q.k multiplies 16-bit operands, each product exact in f32, so
// `wgmma` with f32 accumulation computes the same sums.  p.v takes f32
// probabilities: each p is split into p_hi = T(p) and p_lo = T(p - p_hi) in
// q's dtype, and two `wgmma`s accumulate p_hi.v + p_lo.v in f32, within
// ~2^-16 of f32 p.v (v is exact in its own dtype).  The tensor work is q.k
// plus two p.v passes, 103.2 GFLOP at the gemma shape: ~0.104 ms at 989
// TFLOP/s, above the ~0.080 ms of its bytes.  p's exp is __expf
// (ex2.approx) and the final division a product with __fdividef(1, l): each
// within a few f32 ulps, far inside the one rounding to q's dtype.
//
// Design: one block of three warpgroups per (batch, head, 128-row query
// tile), the longest causal rows first.  Warpgroup 2 is the producer: one
// thread issues TMA loads of the q tile (once) and of a 2-stage ring of
// 64-row K and V tiles, each stage guarded by "full" mbarriers and by
// separate K and V "empty" ones (a K tile is free once q.k has read it, a
// V tile once p.v has); it gives up registers (setmaxnreg 24) so that the
// consumers may hold 240.  Warpgroups 0 and 1 own 64 query rows each.  The
// tensor maps are 4-D (hd, heads, S or T, B) over q, k and v as they lie in
// memory (k and v over their Hkv heads: the producer loads the tiles of its
// block's KV head), with a box of 64 channels x 1 head x rows x 1 and
// 128-byte swizzle, so a row of hd 256 is four 128-byte boxes and nothing
// is transposed or copied; TMA fills rows past S or T, and channels past hd,
// with zeros.  Per KV tile a consumer issues m64n64k16 `wgmma`s over the
// channels (q and k both from swizzled shared memory) and keeps the 64 x 64
// score tile in registers (32 a thread; a row lies on a quad of threads, so
// its max and sum take two shuffles each), runs the online softmax there
// while p.v of the previous tile runs, then rescales its 64 x hd f32
// accumulator by corr and writes p_hi and p_lo as two swizzled 64 x 64
// tiles of its own in shared memory, which the next tile's m64n(hd)k16
// `wgmma`s read against the V stage (MN-major, the transpose bit set).
// p goes through shared memory rather than registers (`wgmma` allows A from
// registers) because the register A fragments of p_hi and p_lo, beside the
// 128 accumulators, made ptxas spill more (PERF.md).  Under `causal`
// KV tiles wholly above the block's last row are not loaded, and only tiles
// that cross the diagonal or T are masked.  The epilogue divides by max(l,
// 1e-30), rounds once to q's dtype and stores in place.  Shared memory at hd
// 256: q 64 KB + 2 stages x (K 32 KB + V 32 KB) + p 32 KB = 224 KB; one
// block an SM.  Head dims below 256 are padded to 64, 128 or 256 channels:
// TMA fills the channels past hd with zeros (hd 120: channels 120-127 of
// each row), which add nothing to q.k or p.v, and the epilogue stores
// channels below hd only.
//
// f32: flash_attn_simt_kernel, f32 FMAs (its 2e-4 tolerance rules out
// 16-bit splits of q and k).  One block of 256 threads owns one (batch,
// head, 64-row query tile) and loops over the 64-row KV tiles itself; q, k
// and v are read in place and staged in shared memory with 16-byte loads,
// rows of q and k padded by one word so that the 16 threads reading 16
// different key rows hit 16 different banks.  Each thread computes a 4 x 4
// block of the score tile (rows ty*4+r, keys tx+16c), then four threads per
// row run the online softmax (max and sum by shuffles), then each thread
// accumulates p.v for its 4 rows and its words tx+16c of the head dimension
// in registers; dot products are summed in index order, one FMA at a time.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG = -1e30f;

// ---------------------------------------------------------------------------
// f32: the SIMT body
// ---------------------------------------------------------------------------

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // key / value rows per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int TR = 4;         // rows per thread (BQ / 16)
constexpr int TC = 4;         // score columns per thread (BKV / 16)
constexpr int PS = BKV + 1;   // row stride of the score tile, in floats

// A 32-bit word of shared memory holds PER_WORD elements of T.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int PER_WORD = 1;
  __device__ static void unpack(uint32_t w, float* f) { f[0] = __uint_as_float(w); }
  __device__ static uint32_t pack(const float* f) { return __float_as_uint(f[0]); }
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
// LSE: the log-sum-exp is written (a body of its own, so that the launch
// without it runs the same code as before it existed).
template <typename T, int CPW, bool LSE>
__global__ void __launch_bounds__(THREADS)
    flash_attn_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           float* __restrict__ lse, int S, int Tk, int H, int group, int hd,
                           int causal, int q_off, float scale, int n_qt, int BH) {
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
  const int Hkv = H / group, kvh = h / group;  // this query head's KV head
  const int q0 = qt * BQ;
  const size_t rs = size_t(H) * W;       // words between two rows of one head of q
  const size_t rs_kv = size_t(Hkv) * W;  // ... of k and v
  const uint32_t* qg = reinterpret_cast<const uint32_t*>(q) + (size_t(b) * S * H + h) * W;
  const uint32_t* kg = reinterpret_cast<const uint32_t*>(k) + (size_t(b) * Tk * Hkv + kvh) * W;
  const uint32_t* vg = reinterpret_cast<const uint32_t*>(v) + (size_t(b) * Tk * Hkv + kvh) * W;
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

  // under causal, keys past the tile's last query position are masked for all
  // rows (query row i stands at position q_off + i)
  const int kv_end = causal ? min(Tk, min(q0 + BQ, S) + q_off) : Tk;
  const int n_kv = (kv_end + BKV - 1) / BKV;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // the previous tile's readers are done
    stage_rows<BKV>(k_s, WS, kg, rs_kv, k0, Tk, W);
    stage_rows<BKV>(v_s, W, vg, rs_kv, k0, Tk, W);
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
      const int qi = q_off + q0 + ty * TR + r;
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
    if (LSE && tx == 0) {
      const float l = l_s[ty * TR + r], m = m_s[ty * TR + r];
      lse[(size_t(b) * H + h) * S + row] = l > 0.f ? (m <= NEG * 0.5f ? 0.f : m) + logf(l) : NEG;
    }
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

size_t simt_smem_bytes(int W) {
  return 4 * (size_t(BQ + BKV) * (W + 1) + size_t(BKV) * W + size_t(BQ) * PS + 3 * BQ);
}

template <int CPW>
int launch_simt(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                int Tk, int H, int Hkv, int hd, int causal, int q_off, size_t smem,
                cudaStream_t stream) {
  const int n_qt = (S + BQ - 1) / BQ;
  const long long blocks = (long long)n_qt * B * H;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  auto kernel = lse != nullptr ? flash_attn_simt_kernel<float, CPW, true>
                                : flash_attn_simt_kernel<float, CPW, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const float scale = float(1.0 / sqrt(double(hd)));
  kernel<<<unsigned(blocks), THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, S, Tk, H, H / Hkv, hd, causal, q_off, scale, n_qt, B * H);
  return int(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
               int Tk, int H, int Hkv, int hd, int causal, int q_off, int smem_max,
               cudaStream_t stream) {
  const int W = hd;
  const size_t smem = simt_smem_bytes(W);
  if (smem > size_t(smem_max)) return int(cudaErrorInvalidValue);
  const int need = (W + 15) / 16;
  if (need <= 1)
    return launch_simt<1>(q, k, v, o, lse, B, S, Tk, H, Hkv, hd, causal, q_off, smem,
                           stream);
  if (need <= 2)
    return launch_simt<2>(q, k, v, o, lse, B, S, Tk, H, Hkv, hd, causal, q_off, smem,
                           stream);
  if (need <= 4)
    return launch_simt<4>(q, k, v, o, lse, B, S, Tk, H, Hkv, hd, causal, q_off, smem,
                           stream);
  if (need <= 8)
    return launch_simt<8>(q, k, v, o, lse, B, S, Tk, H, Hkv, hd, causal, q_off, smem,
                           stream);
  return launch_simt<16>(q, k, v, o, lse, B, S, Tk, H, Hkv, hd, causal, q_off, smem,
                           stream);
}

// ---------------------------------------------------------------------------
// f16 / bf16: wgmma on the tensor cores, TMA loads, a warp-specialised block
// ---------------------------------------------------------------------------

constexpr int WQ = 128;                   // query rows per block (two consumer warpgroups)
constexpr int WKV = 64;                   // keys per KV tile
constexpr int W_THREADS = 384;            // warpgroups 0-1 consume, 2 produces
constexpr int CHUNK = 64;                 // channels per 128-byte swizzled row
constexpr int STAGES = 2;                 // K / V ring
constexpr int Q_CHUNK = WQ * 128;         // bytes of 64 channels of the q tile
constexpr int KV_CHUNK = WKV * 128;       // bytes of 64 channels of a K or V tile
constexpr int P_TILE = 64 * 128;         // bytes of a warpgroup's p_hi or p_lo tile
constexpr int N_BARS = 1 + 4 * STAGES;    // q full; K / V full, K / V empty per stage
constexpr int ALIGN = 1024;               // a 128-byte swizzle repeats every 8 rows
constexpr int PRODUCER_REGS = 24;         // 168 at entry (384 threads, one block an SM):
constexpr int CONSUMER_REGS = 240;        // 128 x (168 - 24) = 256 x (240 - 168)

size_t wgmma_smem_bytes(int nc) {
  return size_t(nc) * (Q_CHUNK + 2 * STAGES * KV_CHUNK) + 4 * P_TILE + ALIGN + 8 * N_BARS;
}

// 64-channel chunks a head dim is padded to: 1, 2 or 4
int wgmma_chunks(int hd) { return hd <= CHUNK ? 1 : hd <= 2 * CHUNK ? 2 : 4; }

// 16-bit element types: round a float, pack two floats (the first in the low half)
template <typename T>
struct Half;

template <>
struct Half<__nv_bfloat16> {
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
  __device__ static uint32_t pack(float a, float b) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

template <>
struct Half<__half> {
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  __device__ static float round(float x) { return __half2float(__float2half_rn(x)); }
  __device__ static uint32_t pack(float a, float b) {
    __half2 h = __floats2half2_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return uint32_t(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// spin until the phase of `bar` with this parity has completed; a wait that
// never ends (a fault in the ring's bookkeeping) traps, so the launch fails
// instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing `bytes` of `bar`'s transaction count
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma matrix descriptor of a 128-byte-swizzled tile in shared memory:
// start address, leading and stride byte offsets (16-byte units), layout 1
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFFu) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// wait until at most N committed groups of this warpgroup's wgmmas are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// the p tiles a warpgroup wrote are visible to its wgmma (the async proxy)
// once all its 128 threads have fenced (named barrier 1 + cw)
__device__ __forceinline__ void p_written(int cw) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
}

// keep the compiler from touching accumulator registers across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FA_OUT8(d, i)                                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define FA_COMMA ,
#define FA_OUT32(d, i) FA_OUT8(d, i), FA_OUT8(d, i + 8), FA_OUT8(d, i + 16), FA_OUT8(d, i + 24)
#define FA_REGS32                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "       \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define FA_REGS64                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "       \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define FA_REGS128                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "         \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "         \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "         \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "         \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "         \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "   \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, " \
  "%126, %127}"

// s (64 x 64, f32) += q (64 x 16) . k (64 x 16)^T, both K-major in shared memory
#define FA_QK(TY)                                                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                              \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " FA_REGS32    \
               ", %32, %33, p, 1, 1, 0, 0;\n}\n"                                         \
               : FA_OUT32(d, 0)                                                          \
               : "l"(a), "l"(b), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t a, uint64_t b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    FA_QK("bf16");
  else
    FA_QK("f16");
}

// acc (64 x N, f32) += p (64 x 16, K-major) . v (16 x N, MN-major), both in
// shared memory
#define FA_PV(TY, N, REGS, OUTS, A, B, SC)                                          \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" SC ", 0;\n"                     \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " " REGS  \
               ", %" A ", %" B ", p, 1, 1, 0, 1;\n}\n"                              \
               : OUTS                                                               \
               : "l"(a), "l"(b), "r"(1))

template <typename T, int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], uint64_t a, uint64_t b) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (N == 64) {
    if constexpr (BF)
      FA_PV("bf16", "64", FA_REGS32, FA_OUT32(d, 0), "32", "33", "34");
    else
      FA_PV("f16", "64", FA_REGS32, FA_OUT32(d, 0), "32", "33", "34");
  } else if constexpr (N == 128) {
    if constexpr (BF)
      FA_PV("bf16", "128", FA_REGS64, FA_OUT32(d, 0) FA_COMMA FA_OUT32(d, 32), "64", "65", "66");
    else
      FA_PV("f16", "128", FA_REGS64, FA_OUT32(d, 0) FA_COMMA FA_OUT32(d, 32), "64", "65", "66");
  } else {
    static_assert(N == 256, "p.v widths: 64, 128, 256");
    if constexpr (BF)
      FA_PV("bf16", "256", FA_REGS128,
            FA_OUT32(d, 0) FA_COMMA FA_OUT32(d, 32) FA_COMMA FA_OUT32(d, 64) FA_COMMA
                FA_OUT32(d, 96),
            "128", "129", "130");
    else
      FA_PV("f16", "256", FA_REGS128,
            FA_OUT32(d, 0) FA_COMMA FA_OUT32(d, 32) FA_COMMA FA_OUT32(d, 64) FA_COMMA
                FA_OUT32(d, 96),
            "128", "129", "130");
  }
}

// x, which the compiler cannot see through: values derived from it inside
// the KV loop are computed there, so that the compiler does not hoist dozens
// of loop-invariant addresses and offsets into registers that the 128
// accumulators need
template <typename I>
__device__ __forceinline__ I opaque(I x) {
  asm volatile("" : "+r"(x));
  return x;
}

// descriptors of a warpgroup's 64 rows of the q tile and of its p tiles
// (K-major, 128-byte swizzle)
__device__ __forceinline__ uint64_t q_desc(uint32_t qa_s) {
  return sw128_desc(opaque(qa_s), 16, 1024);
}
__device__ __forceinline__ uint64_t p_desc(uint32_t p_tile) {
  return sw128_desc(opaque(p_tile), 16, 1024);
}

// s (64 x 64, f32) = q (64 x hd) . k (64 x hd)^T: NC x 4 steps of 16
// channels; descriptors step by 16-byte units (32 B a step, a chunk further)
template <typename T, int NC>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint64_t qd, uint64_t kd) {
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_qk<T>(sc, qd + (c * Q_CHUNK + 32 * kk) / 16, kd + (c * KV_CHUNK + 32 * kk) / 16);
}

// acc (64 x N, f32) += p_hi.v + p_lo.v: 4 steps of 16 keys, 32 B apart in
// the p tiles, 2048 B apart in v
template <typename T, int N>
__device__ __forceinline__ void issue_pv(float (&acc)[N / 2], uint64_t hi_d, uint64_t lo_d,
                                         uint64_t vd) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_pv<T, N>(acc, hi_d + 32 * kk / 16, vd + kk * 16 * 128 / 16);
    wgmma_pv<T, N>(acc, lo_d + 32 * kk / 16, vd + kk * 16 * 128 / 16);
  }
}

// The online softmax of one 64 x 64 score tile.  This thread holds rows qi0
// (sc[4j + e]) and qi1 (sc[4j + 2 + e]) at keys k0 + 8j + col + e, and each
// row's other 48 entries lie on the three other lanes of its quad.  p
// replaces s in place (the next wgmma into sc follows a wgmma.fence); m and
// l are updated and corr returned.  Masking (ki >= T, or ki > qi under
// causal) only where the tile crosses T or the diagonal.
__device__ __forceinline__ void online_softmax(float (&sc)[32], float scale,
                                               bool masked, int k0, int Tk, int causal, int qi0,
                                               int qi1, int col, float& m0, float& m1, float& l0,
                                               float& l1, float& corr0, float& corr1) {
  float mx0 = NEG, mx1 = NEG;
  const int kc = opaque(k0 + col);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ki = kc + 8 * j + e;
      const bool out0 = masked && (ki >= Tk || (causal && ki > qi0));
      const bool out1 = masked && (ki >= Tk || (causal && ki > qi1));
      const float s0 = out0 ? NEG : sc[4 * j + e] * scale;
      const float s1 = out1 ? NEG : sc[4 * j + 2 + e] * scale;
      sc[4 * j + e] = s0;
      sc[4 * j + 2 + e] = s1;
      mx0 = fmaxf(mx0, s0);
      mx1 = fmaxf(mx1, s1);
    }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float ms0 = mn0 <= NEG * 0.5f ? 0.f : mn0;
  const float ms1 = mn1 <= NEG * 0.5f ? 0.f : mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float p0 = __expf(sc[4 * j + e] - ms0), p1 = __expf(sc[4 * j + 2 + e] - ms1);
      sc[4 * j + e] = p0;
      sc[4 * j + 2 + e] = p1;
      sum0 += p0;
      sum1 += p1;
    }
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
  corr0 = m0 <= NEG * 0.5f ? 0.f : expf(m0 - ms0);
  corr1 = m1 <= NEG * 0.5f ? 0.f : expf(m1 - ms1);
  l0 = l0 * corr0 + sum0;
  l1 = l1 * corr1 + sum1;
  m0 = mn0;
  m1 = mn1;
}

// p_hi = T(p) and p_lo = T(p - p_hi) into this warpgroup's two 64 x 64 p
// tiles (K-major, 128-byte swizzle: row r's 16-byte chunk j at r * 128 +
// ((j ^ (r % 8)) << 4)); this thread holds rows r0 and r0 + 8, keys 8j + col
// and + 1 of every chunk j, a 4-byte word each.  Each warp writes the 16
// rows that its own wgmma reads.
template <typename T>
__device__ __forceinline__ void store_p(const float (&pf)[32], uint32_t hi_s, uint32_t lo_s, int r0,
                                        int lane) {
  using P = Half<T>;
  const uint32_t row = opaque(r0 * 128 + 4 * (lane & 3)), sw = opaque(r0 & 7);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows r0, r0 + 8 (r % 8 is the same)
      const uint32_t off = row + 1024 * h + ((j ^ sw) << 4);
      const float a = pf[4 * j + 2 * h], c = pf[4 * j + 2 * h + 1];
      const float ha = P::round(a), hc = P::round(c);
      st_shared(hi_s + off, P::pack(ha, hc));
      st_shared(lo_s + off, P::pack(a - ha, c - hc));
    }
}

// NC: 64-channel chunks of the head dimension (hd padded to NC * 64 with zeros);
// LSE: the log-sum-exp is written (a body of its own, as the SIMT kernel's)
template <typename T, int NC, bool LSE>
__global__ void __launch_bounds__(W_THREADS, 1)
    flash_attn_wgmma_kernel(__grid_constant__ const CUtensorMap q_map,
                            __grid_constant__ const CUtensorMap k_map,
                            __grid_constant__ const CUtensorMap v_map, T* __restrict__ o,
                            float* __restrict__ lse, int S, int Tk, int H, int group, int hd,
                            int causal, int q_off, float scale, int n_qt, int BH) {
  constexpr int N = NC * CHUNK;  // width of the p.v product
  using P = Half<T>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + ALIGN - 1) & ~uint32_t(ALIGN - 1);
  const uint32_t q_s = base;                              // [chunk] 128 rows x 128 B
  const uint32_t k_s = q_s + NC * Q_CHUNK;                // [stage][chunk] 64 rows x 128 B
  const uint32_t v_s = k_s + STAGES * NC * KV_CHUNK;      // [stage][chunk]
  const uint32_t p_s = v_s + STAGES * NC * KV_CHUNK;       // [warpgroup][hi, lo] 64 x 128 B
  const uint32_t bars = p_s + 4 * P_TILE;
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8;                       // + 8 * stage
  const uint32_t v_full = k_full + 8 * STAGES;
  const uint32_t k_empty = v_full + 8 * STAGES;
  const uint32_t v_empty = k_empty + 8 * STAGES;

  const int qt = n_qt - 1 - int(blockIdx.x / unsigned(BH));  // longest causal rows first
  const int bh = int(blockIdx.x % unsigned(BH));
  const int b = bh / H, h = bh - b * H;
  const int q0 = qt * WQ;
  // under causal, keys past the tile's last query position are masked for all
  // rows (query row i stands at position q_off + i)
  const int kv_end = causal ? min(Tk, min(q0 + WQ, S) + q_off) : Tk;
  // at least one tile, so that no wgmma lies on a branch (with no keys its
  // every entry is masked: out = 0)
  const int n_kv = max(1, (kv_end + WKV - 1) / WKV);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);  // lane 0 of each consumer warp
      mbar_init(v_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (tid == 256) {
      const int kv_head = h / group;  // the KV head of this query head's group
      mbar_expect_tx(q_full, NC * Q_CHUNK);
#pragma unroll
      for (int c = 0; c < NC; ++c) tma_load(q_s + c * Q_CHUNK, &q_map, q_full, c * CHUNK, h, q0, b);
      for (int kt = 0; kt < n_kv; ++kt) {
        const int s = kt % STAGES;
        // the stage's previous K (then V) tile, kt - STAGES, has been read
        const uint32_t parity = ((kt / STAGES) & 1) ^ 1;
        if (kt >= STAGES) mbar_wait(k_empty + 8 * s, parity);
        mbar_expect_tx(k_full + 8 * s, NC * KV_CHUNK);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(k_s + (s * NC + c) * KV_CHUNK, &k_map, k_full + 8 * s, c * CHUNK, kv_head,
                   kt * WKV, b);
        if (kt >= STAGES) mbar_wait(v_empty + 8 * s, parity);
        mbar_expect_tx(v_full + 8 * s, NC * KV_CHUNK);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(v_s + (s * NC + c) * KV_CHUNK, &v_map, v_full + 8 * s, c * CHUNK, kv_head,
                   kt * WKV, b);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns query rows qa .. qa + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int cw = tid >> 7, lt = tid & 127;
    const int warp = lt >> 5, lane = lt & 31;
    const int qa = q0 + 64 * cw;
    // this thread's two rows (fragment rows r and r + 8 of its warp's 16)
    const int qi0 = qa + 16 * warp + (lane >> 2), qi1 = qi0 + 8;
    // their positions and the warpgroup's first, which the causal mask reads
    const int pa = qa + q_off, pi0 = qi0 + q_off, pi1 = qi1 + q_off;
    const int col = 2 * (lane & 3);  // its first column in every 8-column block
    const uint32_t qa_s = q_s + cw * (64 * 128);

    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f, corr0, corr1;
    float sc[32];
    const int r0 = 16 * warp + (lane >> 2);  // this thread's first row in the warpgroup
    const uint32_t hi_s = p_s + cw * 2 * P_TILE, lo_s = hi_s + P_TILE;
    // v MN-major: 8-key groups 1024 B apart (SBO), chunks KV_CHUNK apart (LBO)
    const uint32_t v_lbo = KV_CHUNK;

    // Tile kt: (1) issue q.k of tile kt and p.v of tile kt - 1, and wait for
    // q.k; (2) the online softmax of tile kt while p.v of kt - 1 runs on;
    // (3) once p.v is done, rescale acc by corr and write p's two tiles.
    // Both warpgroups walk all n_kv tiles (a tile above a warpgroup's rows
    // is masked whole: p = 0, corr = 1), and the two overlap each other's
    // softmax with their products.  No wgmma lies on a branch.
    mbar_wait(q_full, 0);
    {
      mbar_wait(k_full, 0);
      wg_fence();
      issue_qk<T, NC>(sc, q_desc(qa_s), sw128_desc(k_s, 16, 1024));
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(k_empty);
      online_softmax(sc, scale, WKV > Tk || (causal && WKV - 1 > pa), 0, Tk, causal, pi0,
                     pi1, col, m0, m1, l0, l1, corr0, corr1);
      store_p<T>(sc, hi_s, lo_s, r0, lane);
      p_written(cw);
    }
    for (int kt = 1; kt < n_kv; ++kt) {
      const int s = kt % STAGES, ps = (kt - 1) % STAGES;
      const int k0 = kt * WKV;
      mbar_wait(k_full + 8 * s, (kt / STAGES) & 1);
      mbar_wait(v_full + 8 * ps, ((kt - 1) / STAGES) & 1);
      wg_fence();
      issue_qk<T, NC>(sc, q_desc(qa_s), sw128_desc(k_s + s * NC * KV_CHUNK, 16, 1024));
      wg_commit();
      issue_pv<T, N>(acc, p_desc(hi_s), p_desc(lo_s),
                     sw128_desc(v_s + ps * NC * KV_CHUNK, v_lbo, 1024));
      wg_commit();
      wg_wait<1>();  // q.k done, p.v runs on
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(k_empty + 8 * s);
      online_softmax(sc, scale, k0 + WKV > Tk || (causal && k0 + WKV - 1 > pa), k0, Tk,
                     causal, pi0, pi1, col, m0, m1, l0, l1, corr0, corr1);
      wg_wait<0>();  // p.v of tile kt - 1 done: its V stage and the p tiles are free
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty + 8 * ps);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        acc[4 * j] *= corr0;
        acc[4 * j + 1] *= corr0;
        acc[4 * j + 2] *= corr1;
        acc[4 * j + 3] *= corr1;
      }
      store_p<T>(sc, hi_s, lo_s, r0, lane);
      p_written(cw);
    }
    {  // p.v of the last tile
      const int ps = (n_kv - 1) % STAGES;
      mbar_wait(v_full + 8 * ps, ((n_kv - 1) / STAGES) & 1);
      wg_fence();
      issue_pv<T, N>(acc, p_desc(hi_s), p_desc(lo_s),
                     sw128_desc(v_s + ps * NC * KV_CHUNK, v_lbo, 1024));
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
    }

    // out = acc / max(l, 1e-30), rounded once to T, stored in place; the
    // division is a product with __fdividef(1, max(l, 1e-30)), within 2 ulp
    // of f32 division and far inside the one rounding to T
    const size_t rs = size_t(H) * hd;  // elements between two rows of one head
    T* og = o + (size_t(b) * S * H + h) * hd;
    const float inv0 = __fdividef(1.f, fmaxf(l0, 1e-30f));
    const float inv1 = __fdividef(1.f, fmaxf(l1, 1e-30f));
    if (LSE && (lane & 3) == 0) {  // a row's m and l are its quad's
      float* lg = lse + (size_t(b) * H + h) * S;
      if (qi0 < S) lg[qi0] = l0 > 0.f ? (m0 <= NEG * 0.5f ? 0.f : m0) + logf(l0) : NEG;
      if (qi1 < S) lg[qi1] = l1 > 0.f ? (m1 <= NEG * 0.5f ? 0.f : m1) + logf(l1) : NEG;
    }
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      if (8 * j >= hd) break;
      const int ch = 8 * j + col;
      if (qi0 < S)
        *reinterpret_cast<uint32_t*>(og + size_t(qi0) * rs + ch) =
            P::pack(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      if (qi1 < S)
        *reinterpret_cast<uint32_t*>(og + size_t(qi1) * rs + ch) =
            P::pack(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call: fetched through the runtime,
// so the library needs no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// 4-D map (hd, H, rows, B) over a contiguous (B, rows, H, hd) tensor; box of
// 64 channels x 1 head x box_rows x 1, 128-byte swizzle, zeros out of bounds
template <typename T>
bool encode_map(CUtensorMap* map, const void* ptr, int B, int rows, int H, int hd, int box_rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(H), cuuint64_t(rows), cuuint64_t(B)};
  const cuuint64_t strides[3] = {e * hd, e * hd * H, e * hd * H * rows};
  const cuuint32_t box[4] = {CHUNK, 1, cuuint32_t(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, Half<T>::MAP, 4, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int NC>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                 int Tk, int H, int Hkv, int hd, int causal, int q_off, size_t smem,
                 cudaStream_t stream) {
  const int n_qt = (S + WQ - 1) / WQ;
  const long long blocks = (long long)n_qt * B * H;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  CUtensorMap q_map, k_map, v_map;
  // with no keys no K / V tile is loaded: map one row of q in their place
  const void* kp = Tk > 0 ? k : q;
  const void* vp = Tk > 0 ? v : q;
  const int rows = Tk > 0 ? Tk : 1;
  if (!encode_map<T>(&q_map, q, B, S, H, hd, WQ) ||
      !encode_map<T>(&k_map, kp, B, rows, Hkv, hd, WKV) ||
      !encode_map<T>(&v_map, vp, B, rows, Hkv, hd, WKV))
    return int(cudaErrorInvalidValue);
  auto kernel = lse != nullptr ? flash_attn_wgmma_kernel<T, NC, true>
                                : flash_attn_wgmma_kernel<T, NC, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const float scale = float(1.0 / sqrt(double(hd)));
  kernel<<<unsigned(blocks), W_THREADS, smem, stream>>>(q_map, k_map, v_map, static_cast<T*>(o),
                                                        lse, S, Tk, H, H / Hkv, hd, causal, q_off,
                                                        scale, n_qt, B * H);
  return int(cudaGetLastError());
}

template <typename T>
int launch_16bit(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                 int Tk, int H, int Hkv, int hd, int causal, int q_off, int smem_max,
                 cudaStream_t stream) {
  const int nc = wgmma_chunks(hd);
  const size_t smem = wgmma_smem_bytes(nc);
  if (smem > size_t(smem_max)) return int(cudaErrorInvalidValue);
  if (nc == 1)
    return launch_wgmma<T, 1>(q, k, v, o, lse, B, S, Tk, H, Hkv, hd, causal, q_off, smem,
                                 stream);
  if (nc == 2)
    return launch_wgmma<T, 2>(q, k, v, o, lse, B, S, Tk, H, Hkv, hd, causal, q_off, smem,
                                 stream);
  return launch_wgmma<T, 4>(q, k, v, o, lse, B, S, Tk, H, Hkv, hd, causal, q_off, smem,
                                 stream);
}

}  // namespace

// Returns cudaGetLastError().  dtype: 0 f32 (the SIMT body), 1 f16, 2 bf16
// (the wgmma body).  q and o are contiguous (B, S, H, hd), k and v
// (B, T, Hkv, hd) with Hkv dividing H, 16-byte aligned, with hd a multiple
// of 8 in [8, 256]; query row i stands at position q_off + i (>= 0) for the
// causal mask; lse is null or a contiguous f32 (B, H, S) that takes each
// row's log-sum-exp; anything else, or a block's shared memory above
// smem_max, is refused with cudaErrorInvalidValue before a launch.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* o, float* lse,
                                 int B, int S, int Tk, int H, int Hkv, int hd, int dtype,
                                 int causal, int q_off, int smem_max, void* stream) {
  if (hd < 8 || hd > 256 || hd % 8 != 0 || q_off < 0) return int(cudaErrorInvalidValue);
  if (Hkv < 1 || H % Hkv != 0) return int(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_f32(q, k, v, o, lse, B, S, Tk, H, Hkv, hd, causal, q_off, smem_max, st);
    case 1:
      return launch_16bit<__half>(q, k, v, o, lse, B, S, Tk, H, Hkv, hd, causal, q_off,
                                  smem_max, st);
    case 2:
      return launch_16bit<__nv_bfloat16>(q, k, v, o, lse, B, S, Tk, H, Hkv, hd, causal, q_off,
                                         smem_max, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// Shared memory of one block of the body that flash_attn_launch runs at head
// dim hd and dtype (as there): the wrapper's own figure is held to this one.
extern "C" long long flash_attn_smem_bytes(int hd, int dtype) {
  return (long long)(dtype == 0 ? simt_smem_bytes(hd) : wgmma_smem_bytes(wgmma_chunks(hd)));
}
