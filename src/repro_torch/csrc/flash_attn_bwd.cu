// Backward pass of causal GQA flash attention for the H100 (sm_90a), on the
// float32 CUDA cores: dQ, dK and dV of
// repro_torch/kernels/flash_attn/ref.py:mha, for every input the forward
// kernels (csrc/flash_attn.cu) take.
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
// dQ or dK.
//
// Three launches, each a grid of blocks of 256 threads (a 16 x 16 grid; a
// thread holds a 4 x 4 patch of a 64 x 64 tile of logits):
//   1. attn_bwd_stats_kernel, a block per (query tile of 64, query head,
//      batch): rowsum(dO * O), and each row's log-sum-exp (log2 domain)
//      recomputed by the online softmax over the visible key tiles.  The
//      forward kernels do not emit it and stay as they are.
//   2. attn_bwd_dq_kernel, a block per (query tile, column tile of 128 of
//      dQ, query head, batch): for each visible key tile, S = Q K^T and
//      dP = dO V^T (depth in chunks of 128 staged transposed in shared
//      memory), P = exp2(S * scale * log2(e) - lse), dS, then dQ += dS K.
//   3. attn_bwd_dkv_kernel, a block per (key tile of 64, column tile of 128
//      of dK or of dV, KV head, batch): for each query head of the group and
//      each query tile that sees a key of the tile, S^T, P^T (and dP^T and
//      dS^T for dK), then dV += P^T dO or dK += dS^T Q.  Key tiles are
//      scheduled first-to-last, the heaviest first under the causal mask.
// Every gradient element is written by exactly one block, each sum runs in a
// fixed order and no atomics are used, so reruns are bitwise equal.  S is
// computed in the same order in all three launches, so P is the same number
// in each.  Everything is read and accumulated in float32 (bf16 inputs are
// widened on load) and each gradient is stored in the inputs' type.
//
// Bound on the H100 SXM: at Yi-6B's training shape (B, Hq, Hkv, S, D) = (1,
// 32, 4, 4096, 128), causal, bf16, the five products of the backward (S
// again, dP, dV, dQ, dK) are 2.5 times the forward's 2 x 2 x B x Hq x
// S (S + 1) / 2 x D = 137 GFLOP, 344 GFLOP: 0.35 ms at 989 TFLOP/s on the
// tensor cores, 5.1 ms at 67 TFLOP/s on the float32 CUDA cores this kernel
// runs on; its bytes (q, k, v, out, dout read once, dq, dk, dv written
// once: 151 MB) take 0.045 ms.  Operations bound it.  This design
// recomputes S three times and dP twice (nine products, not five) and stays
// off the tensor cores: it is the simple, right version, and a fast one
// (wgmma, TMA, the forward emitting its log-sum-exp) is later work.
//
// Inputs are read through (batch, head, position) element strides with a
// contiguous last axis, strides multiples of 8 elements and 16-byte aligned
// data, as the forward takes them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
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

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
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

// The strides of the eight tensors, (batch, head, position) each, in the
// order q, k, v, o, dout, dq, dk, dv.
struct Strides {
  long long s[24];
};
enum { SQ = 0, SKK = 3, SV = 6, SO = 9, SDO = 12, SDQ = 15, SDK = 18,
       SDV = 21 };

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
