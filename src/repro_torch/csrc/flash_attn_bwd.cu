// Backward pass of causal GQA flash attention for the H100 (sm_90a): dQ, dK
// and dV of repro_torch/kernels/flash_attn/ref.py:mha, for every input the
// forward kernels (csrc/flash_attn.cu) take, on three routes
// (kernels/flash_attn/kernel.py:route_bwd): with D <= 192 and Dv <= 128
// (every head of the repo's models, DeepSeek-V3's MLA at Dk 192 / Dv 128
// among them), bf16 on the tensor cores (wgmma + TMA) and float32 on the
// tensor cores at float32 accuracy (three bf16 parts of each operand, six
// products); wider heads on the float32 CUDA cores.
//
// It replaces no TPU kernel.  The reference's training step reaches the
// Pallas kernel repro/kernels/flash_attn/kernel.py:flash_attention (def at
// :72, pallas_call at :103) on its accelerator, and JAX cannot differentiate
// that kernel (src/repro/kernels has no custom_vjp): this is the gradient
// the port's training path needs for its attention kernel.
//
// With P = softmax(scale * Q K^T) over the visible keys (t < Sk and, when
// causal, t <= i + (Sk - Sq)) and O = P V:
//
//   dV = P^T dO,   dP = dO V^T,   dS = P * (dP - rowsum(dO * O)),
//   dQ = scale * dS K,   dK = scale * dS^T Q,
//
// with dK and dV summed over the query heads of a KV head's group (GQA).
// rowsum(dO * O) equals rowsum(P * dP) (FlashAttention-2's identity); it is
// taken from the forward's output.  A causal row at a negative position
// (Sq > Sk) sees no key: in the reference every logit of its row is -1e30,
// so P is 1/Sk on every key and its output the mean of v.  Such a row sends
// dO / Sk to every dV row and, the mask's gradient being zero, nothing to
// dQ or dK.  Both routes find these rows by their index, never by their
// log-sum-exp (in float32 -1e30 absorbs log2(Sk), and P computed from it
// would read 1).  Every gradient element is written by exactly one block,
// each sum runs in a fixed order and no atomics are used, so reruns are
// bitwise equal (the training restart check depends on it).  Inputs are
// read through (batch, head, position) element strides with a contiguous
// last axis, strides multiples of 8 elements and 16-byte aligned data, as
// the forward takes them; dq, dk and dv are written through their own
// strides (their inputs' layouts).
//
// Bound on the H100 SXM: at Yi-6B's training shape (B, Hq, Hkv, S, D) = (1,
// 32, 4, 4096, 128), causal, bf16, the five products of the backward (S
// again, dP, dV, dQ, dK) are 2.5 times the forward's 2 x 2 x B x Hq x
// S (S + 1) / 2 x D = 137 GFLOP, 344 GFLOP: 0.35 ms at 989 TFLOP/s on the
// tensor cores; its bytes (q, k, v, out, dout read once, dq, dk, dv written
// once: 151 MB) take 0.045 ms.  Operations bound it.  In float32 the same
// 344 GFLOP take 5.13 ms on the CUDA cores (67 TFLOP/s) and 2.09 ms at the
// float32-accurate tensor-core rate (989 / 6 = 165 TFLOP/s); bytes 0.090.
//
// bf16 route (D <= 192, Dv <= 128: Yi-6B, Qwen3-MoE, Phi-3, Zamba2,
// Whisper, DeepSeek-V3's MLA), four launches, FlashAttention-2's
// deterministic split:
//   1. attn_bwd_delta_kernel: delta = rowsum(dO * O) in float32, a warp a
//      row.  The rows' log-sum-exp comes from the forward, which writes it
//      when autograd asks (ops.FlashAttention; log2 domain).
//   2. attn_bwd_dkv_wgmma_kernel, a CTA per (key tile of 128, query head,
//      batch), key tiles heaviest first: K and V stay in shared memory; a
//      producer warpgroup (one warp of it works) streams, by TMA into a
//      two-stage ring, the Q and dO tiles of 64 queries (32 at D = 192)
//      that reach the key tile (and writes their lse and delta beside
//      them); two consumer
//      warpgroups of 64 keys each run
//        S^T = K Q^T (wgmma, both from shared memory),
//        P^T = exp2(S^T scale log2(e) - lse) (bf16 in registers),
//        dV += P^T dO (wgmma, P^T from registers),
//        dP^T = V dO^T (wgmma),  dS^T = P^T (dP^T - delta) (bf16),
//        dK += dS^T Q (wgmma, dS^T from registers),
//      and write dK (times scale) and dV as float32 partials of the head.
//   3. attn_bwd_dq_wgmma_kernel, a CTA per (query tile of 128, query head,
//      batch), the tiles that see most keys first: Q and dO stay in shared
//      memory; the producer streams K and V tiles of 64 keys (32 at D =
//      192); each consumer warpgroup (64 rows) runs S = Q K^T and dP = dO
//      V^T (wgmma), dS in registers, dQ += dS K (wgmma), and stores dQ
//      times scale in bf16.
//   4. attn_bwd_dkv_reduce_kernel: dK and dV, each the sum of its group's
//      float32 partials in head order, stored in bf16.  At D = 192 a group
//      of one query head (MLA) has no sum to take: the dK/dV kernel stores
//      dK and dV itself and this launch, and the partials' float32 round
//      trip through device memory, are left out (three launches).  The
//      instances up to D = 128 keep the sum (their design is unchanged).
// Seven products where the bound counts five (S and dP twice), and no
// atomics.  GQA: a CTA per (key tile, KV head) would give Yi-6B's
// microbatch 128 CTAs for 132 SMs, and under the causal mask the first key
// tile's CTA walks 32 times the query tiles of the last one's; a CTA per
// (key tile, query head) gives 1,024 CTAs whose work the heaviest-first
// order spreads evenly, at the price of the float32 partials (2 x 67 MB
// written and read at that shape, ~0.08 ms).  Tiles wholly above the
// diagonal are skipped; the masks run only on tiles that cross it, hold
// rows that see no key, or end past Sk or Sq (TMA fills rows past Sk or Sq
// and columns past D or Dv with zeros; rows past Sq get lse = +inf, so P =
// 0 there).  Head dims round up to 64-column chunks (DPC = ceil(D / 64),
// NVC = ceil(Dv / 64)).  Shared memory at D = Dv = 128: 130 KB (dK/dV),
// 129 KB (dQ).  Each dK/dV consumer thread holds 64 + 64 float32
// accumulators of dK and dV beside 32 of S^T or dP^T (one at a time) and 16
// registers of P^T or dS^T in bf16 (dS takes P from its bf16 copy, the
// operand dV took): more than the 168 registers a thread of a 288- or
// 384-thread CTA gets (a sub-partition's 16,384 over its warps), which
// spilled ~1 KB a thread and serialized the wgmmas (ptxas C7512).  So the
// dK/dV CTA has 384 threads and the producer warpgroup hands its
// registers to the consumers (setmaxnreg: 40 and 232 a thread), as FA3
// does; the dQ kernel (64 accumulators) keeps 288 threads and 168.
// At DeepSeek-V3's MLA heads (Dk 192, Dv 128; DPC = 3) a dK/dV consumer
// thread holds 96 + 64 accumulators of dK and dV: beside them, a 64-query
// tile's S^T or dP^T (32 registers) and P^T (16) would need 208 of the
// 232, and the dQ kernel's 96 accumulators beside S, dP (32 each) and dS
// (16) 176 of its 168.  So at DPC = 3 both kernels stream tiles of 32
// rows (stream_rows): S^T and dP^T are m64n32 products, 16 registers each,
// and dV's and dK's products two k-steps of 16 queries a tile (dK an
// m64n192 product from registers).  Shared memory at (192, 128): 121 KB
// (dK/dV), 121 KB (dQ).  At its prefill shape, (1, 128, 128, 511, 511),
// causal, the backward's five products are 27.9 GFLOP (0.028 ms at 989
// TFLOP/s) and its bytes 167 MB (0.050 ms): bytes bound it.  Heads past
// (192, 128) (D = 256: dK and dV alone would take 256 registers) take the
// CUDA-core route.
// Not yet done: overlapping the products with the softmax (ping-pong
// consumers, the next tile's S^T issued before this one's dS^T), dQ in the
// same pass (FA3's semaphore-ordered dQ accumulation), a persistent grid.
//
// float32 route (D <= 192, Dv <= 128): csrc/flash_attn_bwd_f32.cu, a
// library of its own (so that nvcc builds it beside this one) with the four
// launches on the float32 tensor-core arithmetic; it shares delta and the
// group's sum with this file (attn_bwd.cuh).
//
// CUDA-core route (heads past D = 192 or Dv = 128, float32 and bf16),
// three launches, each a grid of blocks of 256 threads (a 16 x 16 grid; a
// thread holds a 4 x 4 patch of a 64 x 64 tile of logits):
//   1. attn_bwd_stats_kernel, a block per (query tile of 64, query head,
//      batch): rowsum(dO * O), and each row's log-sum-exp (log2 domain)
//      recomputed by the online softmax over the visible key tiles.
//   2. attn_bwd_dq_kernel, a block per (query tile, column tile of 128 of
//      dQ, query head, batch): for each visible key tile, S = Q K^T and
//      dP = dO V^T (depth in chunks of 128 staged transposed in shared
//      memory), P = exp2(S * scale * log2(e) - lse), dS, then dQ += dS K.
//   3. attn_bwd_dkv_kernel, a block per (key tile of 64, column tile of 128
//      of dK or of dV, KV head, batch): for each query head of the group and
//      each query tile that sees a key of the tile, S^T, P^T (and dP^T and
//      dS^T for dK), then dV += P^T dO or dK += dS^T Q.  Key tiles are
//      scheduled first-to-last, the heaviest first under the causal mask.
// S is computed in the same order in all three launches, so P is the same
// number in each.  Everything is read and accumulated in float32 (bf16
// inputs are widened on load) and each gradient is stored in the inputs'
// type.  It recomputes S three times and dP twice (nine products) on the
// float32 CUDA cores (67 TFLOP/s).

#include <math.h>

#include "hopper.cuh"   // mbarriers, TMA, wgmma (shared with the forward)
#include "attn_bwd.cuh" // strides, delta, the group's sum (shared with the
                        // float32 route)

namespace {

constexpr float NEG = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 64;          // queries per tile
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // a 16 x 16 grid: tr = row group, tc = column
constexpr int DC = 128;         // columns of a depth chunk and of an output tile
constexpr int NJ = DC / 16;     // output columns per thread
constexpr int QS = BQ + 4;      // row stride (floats) of a transposed tile
constexpr int KS = BK + 4;
static_assert(BQ == BK, "the tiles are square");

__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// The n elements at p (n may be <= 0), zeros after them up to 8; a full
// chunk is one 16-byte-aligned load.
template <typename T>
__device__ __forceinline__ void load_upto8(const T* p, int n, float* x) {
  if (n >= 8) {
    load8(p, x);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = e < n ? load1(p + e) : 0.f;
}

__host__ __device__ __forceinline__ int pad8(int n) { return (n + 7) & ~7; }

// Bytes of shared memory of the dQ and dK/dV kernels: a transposed tile of
// wa depth columns ([wa][QS]), a buffer of the other transposed operand
// ([wa][KS]) that also holds 64 rows of the output tile's operand ([BK][cw]),
// and the transposed P or dS tile ([BK][QS]).
__host__ __device__ __forceinline__ int buf_floats(int wa, int cw) {
  return wa * KS > BK * cw ? wa * KS : BK * cw;
}
__host__ __device__ __forceinline__ size_t smem_bytes(int wa, int cw) {
  return sizeof(float) *
         ((size_t)wa * QS + buf_floats(wa, cw) + (size_t)BK * QS);
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o, 16));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o, 16);
  return x;
}

// Columns [c0, c0 + n) of the rows [r0, r0 + 64) of src (rows past n_rows
// and columns past n as zeros), transposed into dst[col][ds].
template <typename T>
__device__ __forceinline__ void stage_t(const T* src, long long rs, int r0,
                                        int n_rows, int c0, int n, float* dst,
                                        int ds) {
  const int nch = (n + 7) >> 3;
  for (int idx = threadIdx.x; idx < BQ * nch; idx += THREADS) {
    const int r = idx % BQ, ch = idx / BQ;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r0 + r < n_rows)
      load_upto8(src + (long long)(r0 + r) * rs + c0 + ch * 8, n - ch * 8, x);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[(ch * 8 + e) * ds + r] = x[e];
  }
}

// Columns [c0, c0 + n) of the rows [r0, r0 + 64) of src, row-major into
// dst[row][wp] (wp = pad8(n); rows past n_rows and columns past n as zeros).
template <typename T>
__device__ __forceinline__ void stage_rows(const T* src, long long rs, int r0,
                                           int n_rows, int c0, int n, int wp,
                                           float* dst) {
  const int nch = wp >> 3;
  for (int idx = threadIdx.x; idx < BQ * nch; idx += THREADS) {
    const int r = idx / nch, ch = idx % nch;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r0 + r < n_rows)
      load_upto8(src + (long long)(r0 + r) * rs + c0 + ch * 8, n - ch * 8, x);
    float4* d = reinterpret_cast<float4*>(dst + r * wp + ch * 8);
    d[0] = make_float4(x[0], x[1], x[2], x[3]);
    d[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
}

// s[i][j] += sum_d A[d][ra + i] * Bt[d][cb + j] over d < dnp.
__device__ __forceinline__ void tile_dot(const float* A, const float* Bt,
                                         int ra, int cb, int dnp,
                                         float (&s)[4][4]) {
#pragma unroll 4
  for (int d = 0; d < dnp; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(A + d * QS + ra);
    const float4 b = *reinterpret_cast<const float4*>(Bt + d * KS + cb);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][j] += sum_c Pt[c][ra + i] * R[c][tc + 16 j] over the 64 rows c of
// R ([64][wp], its first w columns wanted).
__device__ __forceinline__ void tile_acc(const float* Pt, const float* R,
                                         int wp, int w, int ra, int tc,
                                         float (&acc)[4][NJ]) {
#pragma unroll 4
  for (int c = 0; c < BK; ++c) {
    const float4 pa = *reinterpret_cast<const float4*>(Pt + c * QS + ra);
    const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
    const float* rr = R + c * wp;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = tc + 16 * j;
      if (n < w) {
        const float x = rr[n];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], x, acc[i][j]);
      }
    }
  }
}

// S = Q K^T of the query tile at q0 and the key tile at k0 (q rows on tr,
// keys on tc), depth in chunks of DC through A and Bt.
template <typename T>
__device__ __forceinline__ void logits_qk(const T* qb, long long qss,
                                          const T* kb, long long kss, int q0,
                                          int k0, int Sq, int Sk, int D,
                                          float* A, float* Bt,
                                          float (&s)[4][4]) {
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  for (int d0 = 0; d0 < D; d0 += DC) {
    const int dn = min(DC, D - d0);
    __syncthreads();
    stage_t(qb, qss, q0, Sq, d0, dn, A, QS);
    stage_t(kb, kss, k0, Sk, d0, dn, Bt, KS);
    __syncthreads();
    tile_dot(A, Bt, tr * 4, tc * 4, pad8(dn), s);
  }
}

// ---------------------------------------------------------------------------
// 1. Row statistics
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
attn_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ lse, float* __restrict__ dlt,
                      int group, int Sq, int Sk, int D, int Dv, Strides st,
                      float scale_log2, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int wp = pad8(min(D, DC));
  float* Qt = smem;             // [wp][QS]
  float* Kt = Qt + wp * QS;     // [wp][KS]
  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  const int h = blockIdx.y, b = blockIdx.z, Hq = gridDim.y;
  const int q0 = blockIdx.x * BQ;
  const long long row0 = ((long long)b * Hq + h) * Sq;

  {  // rowsum(dO * O): four lanes a row
    const int r = tid >> 2, part = tid & 3;
    float acc = 0.f;
    if (q0 + r < Sq) {
      const T* orow = o + b * st.s[SO] + h * st.s[SO + 1] +
                      (long long)(q0 + r) * st.s[SO + 2];
      const T* drow = dout + b * st.s[SDO] + h * st.s[SDO + 1] +
                      (long long)(q0 + r) * st.s[SDO + 2];
      for (int c = part; c < Dv; c += 4)
        acc = fmaf(load1(drow + c), load1(orow + c), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0 && q0 + r < Sq) dlt[row0 + q0 + r] = acc;
  }

  const T* qb = q + b * st.s[SQ] + h * st.s[SQ + 1];
  const T* kb = k + b * st.s[SKK] + (h / group) * st.s[SKK + 1];
  const int q_first = (Sk - Sq) + q0;
  int n_kt = (Sk + BK - 1) / BK;
  if (causal) {
    const int q_last = (Sk - Sq) + min(q0 + BQ, Sq) - 1;
    n_kt = q_last < 0 ? 0 : min(n_kt, q_last / BK + 1);
  }
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    float s[4][4] = {};
    logits_qk(qb, st.s[SQ + 2], kb, st.s[SKK + 2], q0, k0, Sq, Sk, D, Qt, Kt,
              s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_first + tr * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tc * 4 + j;
        const bool vis = kpos < Sk && (!causal || kpos <= qpos);
        s[i][j] = vis ? s[i][j] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) rs += exp2f(s[i][j] - m_new);
      l[i] = l[i] * exp2f(m[i] - m_new) + row_sum16(rs);
      m[i] = m_new;
    }
  }
  if (tc == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + tr * 4 + i;
      // a row that sees no key never reads its lse
      if (r < Sq) lse[row0 + r] = l[i] > 0.f ? m[i] + log2f(l[i]) : INFINITY;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dQ
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dlt, T* __restrict__ dq,
                   int group, int Sq, int Sk, int D, int Dv, int n_ct,
                   Strides st, float scale_log2, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int wa = pad8(max(min(D, DC), min(Dv, DC)));
  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  const int qt = gridDim.x / n_ct - 1 - blockIdx.x / n_ct;  // heaviest first
  const int c0 = (blockIdx.x % n_ct) * DC;
  const int cw = min(DC, D - c0), cwp = pad8(cw);
  float* A = smem;                          // [wa][QS]
  float* Bt = A + wa * QS;                  // [wa][KS], or [BK][cwp]
  float* Pt = Bt + buf_floats(wa, cwp);     // [BK][QS]: dS^T
  const int h = blockIdx.y, b = blockIdx.z, Hq = gridDim.y;
  const int q0 = qt * BQ;
  const int q_first = (Sk - Sq) + q0;
  const long long row0 = ((long long)b * Hq + h) * Sq;

  const T* qb = q + b * st.s[SQ] + h * st.s[SQ + 1];
  const T* kb = k + b * st.s[SKK] + (h / group) * st.s[SKK + 1];
  const T* vb = v + b * st.s[SV] + (h / group) * st.s[SV + 1];
  const T* db = dout + b * st.s[SDO] + h * st.s[SDO + 1];

  float lse_r[4], dl_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + tr * 4 + i;
    lse_r[i] = r < Sq ? lse[row0 + r] : INFINITY;
    dl_r[i] = r < Sq ? dlt[row0 + r] : 0.f;
  }
  int n_kt = (Sk + BK - 1) / BK;
  if (causal) {
    const int q_last = (Sk - Sq) + min(q0 + BQ, Sq) - 1;
    n_kt = q_last < 0 ? 0 : min(n_kt, q_last / BK + 1);
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    float s[4][4] = {}, dp[4][4] = {};
    logits_qk(qb, st.s[SQ + 2], kb, st.s[SKK + 2], q0, k0, Sq, Sk, D, A, Bt,
              s);
    logits_qk(db, st.s[SDO + 2], vb, st.s[SV + 2], q0, k0, Sq, Sk, Dv, A, Bt,
              dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_first + tr * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tc * 4 + j;
        const bool vis = q0 + tr * 4 + i < Sq && kpos < Sk &&
                         (!causal || kpos <= qpos);
        const float p = vis ? exp2f(s[i][j] * scale_log2 - lse_r[i]) : 0.f;
        s[i][j] = p * (dp[i][j] - dl_r[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (tc * 4 + j) * QS + tr * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();   // Bt fully read; dS^T written
    stage_rows(kb, st.s[SKK + 2], k0, Sk, c0, cw, cwp, Bt);
    __syncthreads();
    tile_acc(Pt, Bt, cwp, cw, tr * 4, tc, acc);
  }

  T* ob = dq + b * st.s[SDQ] + h * st.s[SDQ + 1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + tr * 4 + i;
    if (r < Sq) {
      T* orow = ob + (long long)r * st.s[SDQ + 2] + c0;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = tc + 16 * j;
        if (n < cw) store1(orow + n, acc[i][j] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dK and dV
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dlt, T* __restrict__ dk,
                    T* __restrict__ dv, int group, int Sq, int Sk, int D,
                    int Dv, int n_ctk, int n_ctv, Strides st,
                    float scale_log2, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int wa = pad8(max(min(D, DC), min(Dv, DC)));
  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  const int kt = blockIdx.x / (n_ctk + n_ctv);
  const int ct = blockIdx.x % (n_ctk + n_ctv);
  const bool want_dk = ct < n_ctk;          // uniform over the block
  const int c0 = (want_dk ? ct : ct - n_ctk) * DC;
  const int cw = min(DC, (want_dk ? D : Dv) - c0), cwp = pad8(cw);
  float* A = smem;                          // [wa][QS]: K^T or V^T
  float* Bt = A + wa * QS;                  // [wa][KS]: Q^T or dO^T; rows
  float* Pt = Bt + buf_floats(wa, cwp);     // [BQ][QS]: P or dS, query-major
  const int hk = blockIdx.y, b = blockIdx.z, Hq = gridDim.y * group;
  const int k0 = kt * BK;
  const int off = Sk - Sq;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const float inv_sk = 1.0f / (float)Sk;
  // The first query tile holding a query that sees a key of this tile; in
  // dV, rows that see no key (causal, Sq > Sk) weigh every key.
  int qt0 = 0;
  if (causal && !(off < 0 && !want_dk))
    qt0 = min(n_qt, max(0, k0 - off) / BQ);

  const T* kb = k + b * st.s[SKK] + hk * st.s[SKK + 1];
  const T* vb = v + b * st.s[SV] + hk * st.s[SV + 1];
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = q + b * st.s[SQ] + h * st.s[SQ + 1];
    const T* db = dout + b * st.s[SDO] + h * st.s[SDO + 1];
    const long long row0 = ((long long)b * Hq + h) * Sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      float s[4][4] = {}, dp[4][4] = {};
      // S^T and dP^T: keys on tr, queries on tc
      logits_qk(kb, st.s[SKK + 2], qb, st.s[SQ + 2], k0, q0, Sk, Sq, D, A,
                Bt, s);
      if (want_dk)
        logits_qk(vb, st.s[SV + 2], db, st.s[SDO + 2], k0, q0, Sk, Sq, Dv, A,
                  Bt, dp);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = q0 + tc * 4 + j;
        const bool q_ok = qi < Sq;
        const int qpos = qi + off;
        const float lse_j = q_ok ? lse[row0 + qi] : INFINITY;
        const float dl_j = q_ok ? dlt[row0 + qi] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kpos = k0 + tr * 4 + i;
          float x;
          if (causal && qpos < 0) {   // sees no key: 1/Sk on each, no dS
            x = (!want_dk && q_ok && kpos < Sk) ? inv_sk : 0.f;
          } else {
            const bool vis = q_ok && kpos < Sk && (!causal || kpos <= qpos);
            const float p = vis ? exp2f(s[i][j] * scale_log2 - lse_j) : 0.f;
            x = want_dk ? p * (dp[i][j] - dl_j) : p;
          }
          s[i][j] = x;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(Pt + (tc * 4 + j) * QS + tr * 4) =
            make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      __syncthreads();   // Bt fully read; P^T or dS^T written
      if (want_dk)
        stage_rows(qb, st.s[SQ + 2], q0, Sq, c0, cw, cwp, Bt);
      else
        stage_rows(db, st.s[SDO + 2], q0, Sq, c0, cw, cwp, Bt);
      __syncthreads();
      tile_acc(Pt, Bt, cwp, cw, tr * 4, tc, acc);
    }
  }

  T* out = want_dk ? dk + b * st.s[SDK] + hk * st.s[SDK + 1]
                   : dv + b * st.s[SDV] + hk * st.s[SDV + 1];
  const long long ors = want_dk ? st.s[SDK + 2] : st.s[SDV + 2];
  const float mul = want_dk ? scale : 1.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + tr * 4 + i;
    if (r < Sk) {
      T* orow = out + (long long)r * ors + c0;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = tc + 16 * j;
        if (n < cw) store1(orow + n, acc[i][j] * mul);
      }
    }
  }
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, void* dq, void* dk, void* dv, float* lse,
               float* dlt, int B, int Hq, int Hkv, int Sq, int Sk, int D,
               int Dv, const long long* strides, float scale, int causal,
               cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const int most = (int)smem_bytes(DC, DC);
    cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        most);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_bwd_dq_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_bwd_dkv_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  Strides st;
  for (int i = 0; i < 24; ++i) st.s[i] = strides[i];
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* op = static_cast<const T*>(o);
  const T* dop = static_cast<const T*>(dout);
  const int group = Hq / Hkv;
  const int n_qt = (Sq + BQ - 1) / BQ, n_kt = (Sk + BK - 1) / BK;
  const int wa = pad8(max(min(D, DC), min(Dv, DC)));
  const float scale_log2 = scale * LOG2E;

  const int wq = pad8(min(D, DC));
  attn_bwd_stats_kernel<T><<<dim3(n_qt, Hq, B), THREADS,
                             sizeof(float) * (size_t)wq * (QS + KS), stream>>>(
      qp, kp, op, dop, lse, dlt, group, Sq, Sk, D, Dv, st, scale_log2, causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n_ctq = (D + DC - 1) / DC;
  attn_bwd_dq_kernel<T><<<dim3(n_qt * n_ctq, Hq, B), THREADS,
                          smem_bytes(wa, wq), stream>>>(
      qp, kp, vp, dop, lse, dlt, static_cast<T*>(dq), group, Sq, Sk, D, Dv,
      n_ctq, st, scale_log2, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n_ctv = (Dv + DC - 1) / DC;
  attn_bwd_dkv_kernel<T><<<dim3(n_kt * (n_ctq + n_ctv), Hkv, B), THREADS,
                           smem_bytes(wa, wa), stream>>>(
      qp, kp, vp, dop, lse, dlt, static_cast<T*>(dk), static_cast<T*>(dv),
      group, Sq, Sk, D, Dv, n_ctq, n_ctv, st, scale_log2, scale, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 tensor-core route (wgmma + TMA), D and Dv <= 128
// ---------------------------------------------------------------------------

constexpr int WG_THREADS = 288;   // two consumer warpgroups + a producer warp
// dK/dV: two consumer warpgroups + a producer warpgroup, whose registers go
// to the consumers (setmaxnreg): 384 threads start at 168 registers each
// (a sub-partition's 16,384 over its three warps), the producer's drop to
// 40 and the consumers' rise to 232, room for dK, dV, S^T or dP^T and P^T.
constexpr int KV_THREADS = 384;
constexpr int KV_PRODUCER_REGS = 40;
constexpr int KV_CONSUMER_REGS = 232;
constexpr int WG_STAGES = 2;
constexpr int KV_ROWS = 128;      // dK/dV: keys a CTA, 64 a warpgroup
constexpr int DQ_ROWS = 128;      // dQ: queries a CTA, 64 a warpgroup
// Rows of the streamed tiles (queries of the dK/dV kernel, keys of the dQ
// kernel): 64 up to D = 128, 32 at D = 192 (DPC = 3), where the
// accumulators of dK (96 registers a thread) and dQ (96) leave room only
// for half the tile's S and dP fragments.
__host__ __device__ constexpr int stream_rows(int dpc) {
  return dpc <= 2 ? 64 : 32;
}

struct WgArgs {
  const float* lse;   // (B, Hq, Sq), log2 domain, from the forward
  const float* dlt;   // (B, Hq, Sq): rowsum(dO * O)
  float* wk;          // (B, Hq, Sk, 64 DPC) float32: scale dS^T Q of a head
  float* wv;          // (B, Hq, Sk, 64 NVC) float32: P^T dO of a head
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;  // written here at DPC = 3 with group == 1, else by
                      // the sum
  __nv_bfloat16* dv;
  long long dqsb, dqsh, dqss, dksb, dksh, dkss, dvsb, dvsh, dvss;
  int Hq, group, Sq, Sk, D, Dv;
  float scale_log2, scale;
  int causal;
  int pair;           // even D and dq strides, 4-byte aligned dq: bf16x2 stores
  int pair_kv;        // the same of dk and dv (and an even Dv)
};

template <int DPC, int NVC>
struct DkvShape {
  static constexpr int QT = stream_rows(DPC);   // queries a streamed tile
  static constexpr int K_BYTES = DPC * KV_ROWS * BOX_BYTES_PER_ROW;
  static constexpr int V_BYTES = NVC * KV_ROWS * BOX_BYTES_PER_ROW;
  static constexpr int Q_BYTES = DPC * QT * BOX_BYTES_PER_ROW;
  static constexpr int O_BYTES = NVC * QT * BOX_BYTES_PER_ROW;  // dO
  static constexpr int STAGE = Q_BYTES + O_BYTES;
  static constexpr int ROW_OFF = K_BYTES + V_BYTES + WG_STAGES * STAGE;
  // each stage's lse and delta: 2 x QT floats
  static constexpr int BAR_OFF = ROW_OFF + WG_STAGES * 2 * QT * 4;
  static constexpr int SMEM = BAR_OFF + 64 + 1024;   // + barriers, alignment
};

template <int DPC, int NVC>
struct DqShape {
  static constexpr int KT = stream_rows(DPC);   // keys a streamed tile
  static constexpr int Q_BYTES = DPC * DQ_ROWS * BOX_BYTES_PER_ROW;
  static constexpr int O_BYTES = NVC * DQ_ROWS * BOX_BYTES_PER_ROW;
  static constexpr int K_BYTES = DPC * KT * BOX_BYTES_PER_ROW;
  static constexpr int V_BYTES = NVC * KT * BOX_BYTES_PER_ROW;
  static constexpr int STAGE = K_BYTES + V_BYTES;
  static constexpr int BAR_OFF = Q_BYTES + O_BYTES + WG_STAGES * STAGE;
  static constexpr int SMEM = BAR_OFF + 64 + 1024;
};

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// dK and dV of one query head's contribution to a key tile of 128 (a CTA
// per (key tile, query head, batch); key tiles heaviest first).  The keys'
// K and V stay in shared memory; the producer streams the (Q, dO) tiles of
// the query rows that reach the tile, with their lse and delta, through a
// two-stage ring.  Each consumer warpgroup owns 64 keys.
template <int DPC, int NVC>
__global__ void __launch_bounds__(KV_THREADS, 1)
attn_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const WgArgs a) {
  using S = DkvShape<DPC, NVC>;
  constexpr int DK = DPC * 64, DV = NVC * 64, KV_QT = S::QT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base_ptr =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(base_ptr);
  const uint32_t sK = base, sV = base + S::K_BYTES;
  const uint32_t sQ = sV + S::V_BYTES;     // stage s: + s STAGE; dO + Q_BYTES
  float* rows = reinterpret_cast<float*>(base_ptr + S::ROW_OFF);
  const uint32_t bar = base + S::BAR_OFF;
  // kv_full = bar; full[s] = bar + 8 (1 + s); empty[s] = bar + 8 (3 + s)

  const int per = gridDim.x / ((a.Sk + KV_ROWS - 1) / KV_ROWS);   // Hq x B
  const int kt = blockIdx.x / per;
  const int h = (blockIdx.x % per) % a.Hq, b = (blockIdx.x % per) / a.Hq;
  const int hk = h / a.group;
  const int k0 = kt * KV_ROWS;
  const int off = a.Sk - a.Sq;            // query i sits at position i + off
  const int n_qt = (a.Sq + KV_QT - 1) / KV_QT;
  // The query tiles that reach the tile: [0, blind_qt) hold the rows that
  // see no key (causal Sq > Sk; they weigh every key in dV), [lo, n_qt) the
  // rows whose last visible key is at or past k0.
  const int blind_qt = a.causal ? (max(0, -off) + KV_QT - 1) / KV_QT : 0;
  const int lo = a.causal ? max(blind_qt, min(n_qt, max(0, k0 - off) / KV_QT))
                          : 0;
  const int n_it = blind_qt + n_qt - lo;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(bar + 8 * (1 + s), 32);   // the producer's lanes
      mbar_init(bar + 8 * (3 + s), 8);    // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 256) {
    // Producer warpgroup: it hands its registers over, and its first warp
    // works: lane 0 issues the TMA loads; every lane writes two rows' lse
    // and delta of the stage (lse +inf and delta 0 past Sq, so that P = 0
    // there), then arrives.
    regs_down<KV_PRODUCER_REGS>();
    if (threadIdx.x >= 288) return;
    if (lane == 0) {
      mbar_expect_tx(bar, S::K_BYTES + S::V_BYTES);
      for (int c = 0; c < DPC; ++c)
        tma_load(sK + c * KV_ROWS * BOX_BYTES_PER_ROW, &tk, bar, c * 64, k0,
                 hk, b);
      for (int c = 0; c < NVC; ++c)
        tma_load(sV + c * KV_ROWS * BOX_BYTES_PER_ROW, &tv, bar, c * 64, k0,
                 hk, b);
    }
    const long long row0 = ((long long)b * a.Hq + h) * a.Sq;
    for (int it = 0; it < n_it; ++it) {
      const int s = it % WG_STAGES, round = it / WG_STAGES;
      if (round > 0) mbar_wait(bar + 8 * (3 + s), (round - 1) & 1);
      const int q0 = (it < blind_qt ? it : lo + it - blind_qt) * KV_QT;
      float* rl = rows + s * 2 * KV_QT;
      for (int j = lane; j < KV_QT; j += 32) {
        const bool ok = q0 + j < a.Sq;
        rl[j] = ok ? a.lse[row0 + q0 + j] : INFINITY;
        rl[KV_QT + j] = ok ? a.dlt[row0 + q0 + j] : 0.f;
      }
      const uint32_t full = bar + 8 * (1 + s);
      if (lane == 0) {
        const uint32_t st = sQ + s * S::STAGE;
        mbar_expect_tx(full, S::STAGE);
        for (int c = 0; c < DPC; ++c)
          tma_load(st + c * KV_QT * BOX_BYTES_PER_ROW, &tq, full, c * 64, q0,
                   h, b);
        for (int c = 0; c < NVC; ++c)
          tma_load(st + S::Q_BYTES + c * KV_QT * BOX_BYTES_PER_ROW, &tdo,
                   full, c * 64, q0, h, b);
      } else {
        mbar_arrive(full);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns keys [k0 + 64 wg, k0 + 64 wg + 64); a
  // thread holds the rows (keys) key_lo and key_lo + 8 of its warp's 16,
  // and columns (queries) 8 n + 2 q4 + j of each tile.
  regs_up<KV_CONSUMER_REGS>();
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, q4 = lane & 3;
  const int kw0 = k0 + wg * 64;
  const int key_lo = kw0 + warp * 16 + g;
  const float inv_sk = 1.f / (float)a.Sk;
  float dk[DK / 2], dv[DV / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dv[i] = 0.f;

  mbar_wait(bar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % WG_STAGES, phase = (it / WG_STAGES) & 1;
    const int q0 = (it < blind_qt ? it : lo + it - blind_qt) * KV_QT;
    const uint32_t stQ = sQ + s * S::STAGE, stO = stQ + S::Q_BYTES;
    const float* rl = rows + s * 2 * KV_QT;
    mbar_wait(bar + 8 * (1 + s), phase);

    // S^T = K Q^T (64 keys x KV_QT queries)
    float sc[KV_QT / 2];
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int c = 0; c < DPC; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<KV_QT>(
            sc,
            sw128_desc(sK + (c * KV_ROWS + wg * 64) * BOX_BYTES_PER_ROW +
                           kk * 32, 16, 1024),
            sw128_desc(stQ + c * KV_QT * BOX_BYTES_PER_ROW + kk * 32, 16,
                       1024),
            (c | kk) ? 1 : 0);
    wg_commit();
    wg_wait0();
    fence_regs(sc);

    // P^T = exp2(S^T scale log2(e) - lse), in bf16: sc[4 n + 2 i + j] is
    // key key_lo + 8 i, query q0 + 8 n + 2 q4 + j.  The masks only where
    // the tile crosses the diagonal, holds rows that see no key (P = 1/Sk
    // on every key: the gradient of the reference's mean of v) or ends
    // past Sk.
    const bool edge =
        kw0 + 64 > a.Sk || (a.causal && kw0 + 63 > q0 + off);
#pragma unroll
    for (int n = 0; n < KV_QT / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 8 * n + 2 * q4 + j;
          float p = exp2f(sc[4 * n + 2 * i + j] * a.scale_log2 - rl[col]);
          if (edge) {
            const int key = key_lo + 8 * i, qpos = q0 + col + off;
            if (a.causal && qpos < 0)
              p = key < a.Sk ? inv_sk : 0.f;
            else if (key >= a.Sk || (a.causal && key > qpos))
              p = 0.f;
          }
          sc[4 * n + 2 * i + j] = p;
        }
    uint32_t pb[KV_QT / 16][4];
#pragma unroll
    for (int kb = 0; kb < KV_QT / 16; ++kb)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pb[kb][r] = pack_bf16(sc[8 * kb + 2 * r], sc[8 * kb + 2 * r + 1]);

    // dV += P^T dO (P^T from registers, dO N-major) and dP^T = V dO^T
    float dp[KV_QT / 2];
    fence_regs(dv);
    fence_regs(dp);
    wg_fence();
#pragma unroll
    for (int kb = 0; kb < KV_QT / 16; ++kb)
      wgmma_rs<DV>(dv, pb[kb],
                   sw128_desc(stO + kb * 2048, KV_QT * BOX_BYTES_PER_ROW,
                              1024));
#pragma unroll
    for (int c = 0; c < NVC; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<KV_QT>(
            dp,
            sw128_desc(sV + (c * KV_ROWS + wg * 64) * BOX_BYTES_PER_ROW +
                           kk * 32, 16, 1024),
            sw128_desc(stO + c * KV_QT * BOX_BYTES_PER_ROW + kk * 32, 16,
                       1024),
            (c | kk) ? 1 : 0);
    wg_commit();
    wg_wait0();
    fence_regs(dv);
    fence_regs(dp);

    // dS^T = P^T (dP^T - delta), from the bf16 P^T (the operand dV took);
    // zero on the rows that see no key.  Element e = 8 kb + 2 r of the
    // fragment is query column 8 (2 kb + r / 2) + 2 q4.
#pragma unroll
    for (int kb = 0; kb < KV_QT / 16; ++kb)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 8 * kb + 2 * r;
        const int col = 16 * kb + 8 * (r >> 1) + 2 * q4;
        const float2 p = unpack_bf16(pb[kb][r]);
        float d0 = p.x * (dp[e] - rl[KV_QT + col]);
        float d1 = p.y * (dp[e + 1] - rl[KV_QT + col + 1]);
        if (edge && a.causal) {
          if (q0 + col + off < 0) d0 = 0.f;
          if (q0 + col + 1 + off < 0) d1 = 0.f;
        }
        pb[kb][r] = pack_bf16(d0, d1);
      }

    // dK += dS^T Q (Q N-major)
    fence_regs(dk);
    wg_fence();
#pragma unroll
    for (int kb = 0; kb < KV_QT / 16; ++kb)
      wgmma_rs<DK>(dk, pb[kb],
                   sw128_desc(stQ + kb * 2048, KV_QT * BOX_BYTES_PER_ROW,
                              1024));
    wg_commit();
    wg_wait0();
    fence_regs(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar + 8 * (3 + s));
  }

  if constexpr (DPC == 3) {
    if (a.group == 1) {
      // A group of one query head (MLA): dK and dV themselves, in bf16,
      // where the group's sum would add this head's partial to zero.
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = key_lo + 8 * i;
        if (key >= a.Sk) continue;
        store_frag_row<DK>(a.dk + b * a.dksb + h * a.dksh + key * a.dkss,
                           dk, i, q4, a.D, a.scale, a.pair_kv);
        store_frag_row<DV>(a.dv + b * a.dvsb + h * a.dvsh + key * a.dvss,
                           dv, i, q4, a.Dv, 1.f, a.pair_kv);
      }
      return;
    }
  }
  // This head's float32 partials, all 64 DPC (64 NVC) columns.
  const long long prow = ((long long)b * a.Hq + h) * a.Sk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key_lo + 8 * i;
    if (key >= a.Sk) continue;
    float* wkr = a.wk + (prow + key) * DK;
    float* wvr = a.wv + (prow + key) * DV;
#pragma unroll
    for (int n = 0; n < DK / 8; ++n)
      *reinterpret_cast<float2*>(wkr + 8 * n + 2 * q4) = make_float2(
          dk[4 * n + 2 * i] * a.scale, dk[4 * n + 2 * i + 1] * a.scale);
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
      *reinterpret_cast<float2*>(wvr + 8 * n + 2 * q4) =
          make_float2(dv[4 * n + 2 * i], dv[4 * n + 2 * i + 1]);
  }
}

// dS = P (dP - delta) of a tile of the dQ kernel in place of S (sc), P =
// exp2(S scale log2(e) - lse); with EDGE, keys past Sk or, causal, past a
// row's position give 0.  sc[4 n + 2 i + j] is row i's key k0 + 8 n + 2 q4
// + j.
template <bool EDGE, int KT>
__device__ __forceinline__ void dq_ds(float (&sc)[KT / 2],
                                      const float (&dp)[KT / 2],
                                      const float (&lse)[2],
                                      const float (&dl)[2],
                                      const int (&qpos)[2], int k0, int q4,
                                      float scale_log2, int Sk, int causal) {
#pragma unroll
  for (int n = 0; n < KT / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 4 * n + 2 * i + j;
        float p = exp2f(sc[e] * scale_log2 - lse[i]);
        if constexpr (EDGE) {
          const int key = k0 + 8 * n + 2 * q4 + j;
          if (key >= Sk || (causal && key > qpos[i])) p = 0.f;
        }
        sc[e] = p * (dp[e] - dl[i]);
      }
}

// dQ of a query tile of 128 rows of one head (a CTA per (query tile, query
// head, batch); the last tiles, which see the most keys, first).  Q and dO
// stay in shared memory; the producer streams K and V tiles of 64 keys.
// Each consumer warpgroup owns 64 query rows.
template <int DPC, int NVC>
__global__ void __launch_bounds__(WG_THREADS, 1)
attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const WgArgs a) {
  using S = DqShape<DPC, NVC>;
  constexpr int DK = DPC * 64, DQ_KT = S::KT;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sO = base + S::Q_BYTES;
  const uint32_t sK = sO + S::O_BYTES;     // stage s: + s STAGE; V + K_BYTES
  const uint32_t bar = base + S::BAR_OFF;
  // qo_full = bar; full[s] = bar + 8 (1 + s); empty[s] = bar + 8 (3 + s)

  const int n_qt = (a.Sq + DQ_ROWS - 1) / DQ_ROWS;
  const int per = gridDim.x / n_qt;         // Hq x B
  const int qt = n_qt - 1 - blockIdx.x / per;
  const int h = (blockIdx.x % per) % a.Hq, b = (blockIdx.x % per) / a.Hq;
  const int hk = h / a.group;
  const int q0 = qt * DQ_ROWS;
  const int off = a.Sk - a.Sq;
  int n_kt = (a.Sk + DQ_KT - 1) / DQ_KT;
  if (a.causal) {   // up to the last key a row of the tile sees
    const int q_last = off + min(q0 + DQ_ROWS, a.Sq) - 1;
    n_kt = q_last < 0 ? 0 : min(n_kt, q_last / DQ_KT + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(bar + 8 * (1 + s), 1);
      mbar_init(bar + 8 * (3 + s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    if (threadIdx.x != 256) return;
    mbar_expect_tx(bar, S::Q_BYTES + S::O_BYTES);
    for (int c = 0; c < DPC; ++c)
      tma_load(sQ + c * DQ_ROWS * BOX_BYTES_PER_ROW, &tq, bar, c * 64, q0, h,
               b);
    for (int c = 0; c < NVC; ++c)
      tma_load(sO + c * DQ_ROWS * BOX_BYTES_PER_ROW, &tdo, bar, c * 64, q0,
               h, b);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % WG_STAGES, round = kt / WG_STAGES;
      if (round > 0) mbar_wait(bar + 8 * (3 + s), (round - 1) & 1);
      const uint32_t full = bar + 8 * (1 + s), st = sK + s * S::STAGE;
      mbar_expect_tx(full, S::STAGE);
      for (int c = 0; c < DPC; ++c)
        tma_load(st + c * DQ_KT * BOX_BYTES_PER_ROW, &tk, full, c * 64,
                 kt * DQ_KT, hk, b);
      for (int c = 0; c < NVC; ++c)
        tma_load(st + S::K_BYTES + c * DQ_KT * BOX_BYTES_PER_ROW, &tv, full,
                 c * 64, kt * DQ_KT, hk, b);
    }
    return;
  }

  // Consumers: a thread holds rows r_lo and r_lo + 8 and, of each key
  // tile, keys k0 + 8 n + 2 q4 + j.
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, q4 = lane & 3;
  const int r_lo = q0 + wg * 64 + warp * 16 + g;
  const int wg_first = off + q0 + wg * 64;   // position of its first row
  const long long row0 = ((long long)b * a.Hq + h) * a.Sq;
  float lse[2], dl[2];
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    lse[i] = r < a.Sq ? a.lse[row0 + r] : INFINITY;
    dl[i] = r < a.Sq ? a.dlt[row0 + r] : 0.f;
    qpos[i] = r + off;
  }
  float dq[DK / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) dq[i] = 0.f;

  mbar_wait(bar, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % WG_STAGES, phase = (kt / WG_STAGES) & 1;
    const int k0 = kt * DQ_KT;
    const uint32_t stK = sK + s * S::STAGE, stV = stK + S::K_BYTES;
    mbar_wait(bar + 8 * (1 + s), phase);

    // S = Q K^T and dP = dO V^T (64 rows x 64 keys each)
    float sc[DQ_KT / 2], dp[DQ_KT / 2];
    fence_regs(sc);
    fence_regs(dp);
    wg_fence();
#pragma unroll
    for (int c = 0; c < DPC; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<DQ_KT>(
            sc,
            sw128_desc(sQ + (c * DQ_ROWS + wg * 64) * BOX_BYTES_PER_ROW +
                           kk * 32, 16, 1024),
            sw128_desc(stK + c * DQ_KT * BOX_BYTES_PER_ROW + kk * 32, 16,
                       1024),
            (c | kk) ? 1 : 0);
#pragma unroll
    for (int c = 0; c < NVC; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<DQ_KT>(
            dp,
            sw128_desc(sO + (c * DQ_ROWS + wg * 64) * BOX_BYTES_PER_ROW +
                           kk * 32, 16, 1024),
            sw128_desc(stV + c * DQ_KT * BOX_BYTES_PER_ROW + kk * 32, 16,
                       1024),
            (c | kk) ? 1 : 0);
    wg_commit();
    wg_wait0();
    fence_regs(sc);
    fence_regs(dp);

    // dS = P (dP - delta), P = exp2(S scale log2(e) - lse); masked keys
    // (past the diagonal, past Sk, and every key of a row that sees none)
    // give 0.  The masked and the unmasked loop are written out apart, so
    // that the unmasked one carries no test whatever the compiler decides
    // (left to it, a build kept the tests in the loop, and the D = 128
    // instance's dQ kernel ran slower on the card).
    if (k0 + DQ_KT > a.Sk || (a.causal && k0 + DQ_KT - 1 > wg_first))
      dq_ds<true, DQ_KT>(sc, dp, lse, dl, qpos, k0, q4, a.scale_log2, a.Sk,
                         a.causal);
    else
      dq_ds<false, DQ_KT>(sc, dp, lse, dl, qpos, k0, q4, a.scale_log2, a.Sk,
                          a.causal);
    uint32_t ds[DQ_KT / 16][4];
#pragma unroll
    for (int kb = 0; kb < DQ_KT / 16; ++kb)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        ds[kb][r] = pack_bf16(sc[8 * kb + 2 * r], sc[8 * kb + 2 * r + 1]);

    // dQ += dS K (K N-major)
    fence_regs(dq);
    wg_fence();
#pragma unroll
    for (int kb = 0; kb < DQ_KT / 16; ++kb)
      wgmma_rs<DK>(dq, ds[kb],
                   sw128_desc(stK + kb * 2048, DQ_KT * BOX_BYTES_PER_ROW,
                              1024));
    wg_commit();
    wg_wait0();
    fence_regs(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar + 8 * (3 + s));
  }

  __nv_bfloat16* ob = a.dq + b * a.dqsb + h * a.dqsh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    if (r >= a.Sq) continue;
    __nv_bfloat16* orow = ob + (long long)r * a.dqss;
#pragma unroll
    for (int n = 0; n < DK / 8; ++n) {
      const int col = 8 * n + 2 * q4;
      const float x0 = dq[4 * n + 2 * i] * a.scale;
      const float x1 = dq[4 * n + 2 * i + 1] * a.scale;
      if (a.pair && col < a.D) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < a.D) orow[col] = __float2bfloat16_rn(x0);
        if (col + 1 < a.D) orow[col + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

template <int DPC, int NVC>
int launch_bwd_wgmma(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     void* dq, void* dk, void* dv, float* dlt, float* wk,
                     float* wv, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                     int Dv, const long long* strides, float scale,
                     int causal, cudaStream_t stream) {
  using SK = DkvShape<DPC, NVC>;
  using SQ_ = DqShape<DPC, NVC>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_dkv_wgmma_kernel<DPC, NVC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SK::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_bwd_dq_wgmma_kernel<DPC, NVC>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SQ_::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  Strides st;
  for (int i = 0; i < 24; ++i) st.s[i] = strides[i];
  // Tensor maps: the dK/dV kernel's K and V boxes of 128 rows and Q and dO
  // boxes of 64, the dQ kernel's the other way round.
  CUtensorMap kq, kk, kv, kdo, qq, qk, qv, qdo;
  if (!encode(&kq, q, B, Hq, Sq, D, strides + SQ, SK::QT) ||
      !encode(&kk, k, B, Hkv, Sk, D, strides + SKK, KV_ROWS) ||
      !encode(&kv, v, B, Hkv, Sk, Dv, strides + SV, KV_ROWS) ||
      !encode(&kdo, dout, B, Hq, Sq, Dv, strides + SDO, SK::QT) ||
      !encode(&qq, q, B, Hq, Sq, D, strides + SQ, DQ_ROWS) ||
      !encode(&qk, k, B, Hkv, Sk, D, strides + SKK, SQ_::KT) ||
      !encode(&qv, v, B, Hkv, Sk, Dv, strides + SV, SQ_::KT) ||
      !encode(&qdo, dout, B, Hq, Sq, Dv, strides + SDO, DQ_ROWS))
    return (int)cudaErrorInvalidValue;
  WgArgs a;
  a.lse = lse;
  a.dlt = dlt;
  a.wk = wk;
  a.wv = wv;
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.dqsb = strides[SDQ]; a.dqsh = strides[SDQ + 1]; a.dqss = strides[SDQ + 2];
  a.dksb = strides[SDK]; a.dksh = strides[SDK + 1]; a.dkss = strides[SDK + 2];
  a.dvsb = strides[SDV]; a.dvsh = strides[SDV + 1]; a.dvss = strides[SDV + 2];
  a.Hq = Hq; a.group = Hq / Hkv; a.Sq = Sq; a.Sk = Sk; a.D = D; a.Dv = Dv;
  a.scale_log2 = scale * LOG2E;
  a.scale = scale;
  a.causal = causal;
  a.pair = D % 2 == 0 && strides[SDQ] % 2 == 0 &&
           strides[SDQ + 1] % 2 == 0 && strides[SDQ + 2] % 2 == 0 &&
           reinterpret_cast<uintptr_t>(dq) % 4 == 0;
  a.pair_kv = D % 2 == 0 && Dv % 2 == 0 &&
              reinterpret_cast<uintptr_t>(dk) % 4 == 0 &&
              reinterpret_cast<uintptr_t>(dv) % 4 == 0;
  for (int i = SDK; i < SDV + 3; ++i) a.pair_kv &= strides[i] % 2 == 0;

  const long long rows = (long long)B * Hq * Sq;
  attn_bwd_delta_kernel<__nv_bfloat16>
      <<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), dlt, Hq, Sq, Dv, st, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n_kt = (Sk + KV_ROWS - 1) / KV_ROWS;
  attn_bwd_dkv_wgmma_kernel<DPC, NVC>
      <<<n_kt * Hq * B, KV_THREADS, SK::SMEM, stream>>>(kq, kk, kv, kdo, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n_qt = (Sq + DQ_ROWS - 1) / DQ_ROWS;
  attn_bwd_dq_wgmma_kernel<DPC, NVC>
      <<<n_qt * Hq * B, WG_THREADS, SQ_::SMEM, stream>>>(qq, qk, qv, qdo, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || (DPC == 3 && Hq == Hkv)) return (int)err;

  const long long total = (long long)B * Hkv * Sk * (D + Dv);
  attn_bwd_dkv_reduce_kernel<__nv_bfloat16>
      <<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      wk, wv, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Hkv, Hq / Hkv, Sk, D, Dv, DPC * 64,
      NVC * 64, st, total);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hq, Sq, D), k (B, Hkv, Sk, D), v (B, Hkv, Sk, Dv), o and dout (B,
// Hq, Sq, Dv), and the outputs dq, dk, dv of q's, k's and v's shapes, all of
// one type (dtype 0: float32, 1: bfloat16); strides holds 24 element
// strides, (batch, head, position) of q, k, v, o, dout, dq, dk and dv.  lse
// and dlt are float32 workspaces of B * Hq * Sq elements.  Returns
// cudaGetLastError() after the launches (0 on success); the checks of
// shapes, strides and alignment are the Python wrapper's.
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, float* lse, float* dlt, int B,
                                   int Hq, int Hkv, int Sq, int Sk, int D,
                                   int Dv, const long long* strides,
                                   float scale, int causal, void* stream) {
  if (!(B > 0 && D > 0 && Dv > 0 && Hkv > 0 && Hq % Hkv == 0 && Sq > 0 &&
        Sk > 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(q, k, v, o, dout, dq, dk, dv, lse, dlt, B, Hq,
                             Hkv, Sq, Sk, D, Dv, strides, scale, causal, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse, dlt,
                                     B, Hq, Hkv, Sq, Sk, D, Dv, strides,
                                     scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// The bf16 route: q (B, Hq, Sq, D), k (B, Hkv, Sk, D), v (B, Hkv, Sk, Dv),
// o and dout (B, Hq, Sq, Dv), dq, dk, dv of q's, k's and v's shapes, all
// bfloat16, D in [1, 192] and Dv in [1, 128]; strides as above; lse the
// forward's (B, Hq, Sq) float32 log-sum-exp (log2 domain); dlt a float32
// workspace of B * Hq * Sq elements, wk and wv float32 workspaces of B *
// Hq * Sk * 64 * ceil(D / 64) and 64 * ceil(Dv / 64) elements (unread when
// D > 128 and Hq == Hkv).  Returns cudaGetLastError() after the launches
// (0 on success).
extern "C" int flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* dlt, float* wk, float* wv, int B, int Hq, int Hkv, int Sq, int Sk,
    int D, int Dv, const long long* strides, float scale, int causal,
    void* stream) {
  if (!(B > 0 && D > 0 && Dv > 0 && Hkv > 0 && Hq % Hkv == 0 && Sq > 0 &&
        Sk > 0 && D <= 192 && Dv <= 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dpc = (D + 63) / 64, nvc = (Dv + 63) / 64;
#define FA_BWD_WGMMA(DPC_, NVC_)                                            \
  if (dpc == DPC_ && nvc == NVC_)                                           \
    return launch_bwd_wgmma<DPC_, NVC_>(q, k, v, o, dout, lse, dq, dk, dv,  \
                                        dlt, wk, wv, B, Hq, Hkv, Sq, Sk, D, \
                                        Dv, strides, scale, causal, s);
  FA_BWD_WGMMA(1, 1) FA_BWD_WGMMA(1, 2) FA_BWD_WGMMA(2, 1) FA_BWD_WGMMA(2, 2)
  FA_BWD_WGMMA(3, 1) FA_BWD_WGMMA(3, 2)
#undef FA_BWD_WGMMA
  return (int)cudaErrorInvalidValue;
}

