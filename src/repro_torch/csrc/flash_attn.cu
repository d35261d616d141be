// Causal GQA flash attention (forward) for the H100 (sm_90a), CUDA cores.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attn/kernel.py:
// flash_attention (def at :72, pallas_call at :103, body _attn_kernel at
// :30-69).  It computes repro_torch/kernels/flash_attn/ref.py:mha:
//
//   out[b, h, i] = softmax_t(scale * q[b, h, i] . k[b, h / group, t]) v[...]
//
// over the keys t visible to query i: t < Sk and, when causal,
// t <= i + (Sk - Sq) (queries are the last Sq positions of the context, the
// KV-cache alignment of the reference).  Masked logits are -1e30 and the
// denominator is floored at 1e-30, as in the reference.  Unlike the Pallas
// kernel (which refuses Sk % block_k != 0), the ragged last key tile is
// masked here, so any Sk >= 1 works (causal needs Sq <= Sk).
//
// Design: one block of 256 threads per (query tile of 64, query head,
// batch); the KV head is h / group (GQA), so the group's query heads read
// the same K/V tiles, which the 50 MB L2 keeps.  The query tile lives in
// shared memory as float, transposed; a loop walks 64-key tiles: K is
// staged transposed, each thread computes a 4 x 4 patch of the 64 x 64
// logits with float4 shared loads, the online softmax (m, l, acc) runs in
// float32 in the log2 domain (16-lane shuffles per row), P is staged
// transposed, then V is staged into the same buffer as K and each thread
// accumulates a 4-row x (D / 16)-column patch of the output.  The causal
// loop stops at the last key tile any query of the block can see (the
// reference's causal tile skip, kernel.py:36-41), and query tiles are
// scheduled heaviest first.  Shared memory is 87,040 bytes at D = 128, so
// two blocks fit on an SM; cudaFuncAttributeMaxDynamicSharedMemorySize is
// raised above the 48 KB default.
//
// The kernel takes element strides for (batch, head, position) of q, k, v
// and out (the last axis must be contiguous, strides multiples of 8 and
// base pointers 16-byte aligned): the model passes its (B, S, H, D)
// projections as (B, H, S, D) views, with no transposing copy.
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense tensor cores, 3.35 TB/s):
// at (B, Hq, Hkv, S, D) = (1, 32, 4, 2048, 128) bf16, causal, the inputs and
// output are 37.7 MB (0.011 ms) and the two products 34.4 GFLOP (0.035 ms),
// so operations bound it.  This kernel uses the float32 CUDA cores (67
// TFLOP/s peak) with no tensor cores, TMA or copy/compute overlap: a
// wgmma/TMA (FA3-style) kernel is later work.  Types: float32 and bf16 in,
// q's type out; head dim D <= 128, a multiple of 8.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // queries per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // a 16 x 16 grid: tr = row group, tc = column
constexpr int DMAX = 128;
constexpr int NJ = DMAX / 16;   // output columns per thread
constexpr int QS = BQ + 4;      // row stride (floats) of the Q^T and P^T tiles
constexpr int KS = BK + 4;      // row stride (floats) of the K^T tile
constexpr float NEG = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;

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

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__host__ __device__ __forceinline__ int kv_floats(int D) {
  return D * KS > BK * D ? D * KS : BK * D;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)D * QS + kv_floats(D) + (size_t)BK * QS);
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

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int group, int Sq, int Sk, int D,
                       long long qsb, long long qsh, long long qss,
                       long long ksb, long long ksh, long long kss,
                       long long vsb, long long vsh, long long vss,
                       long long osb, long long osh, long long oss,
                       float scale_log2, int causal) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                    // [D][QS]: Q^T
  float* KV = Qt + D * QS;             // [D][KS]: K^T, then [BK][D]: V
  float* Pt = KV + kv_floats(D);       // [BK][QS]: P^T

  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest query tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int q_offset = Sk - Sq;
  const int nch = D >> 3;                      // 8-element chunks of a row

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + (h / group) * ksh;
  const T* vb = v + b * vsb + (h / group) * vsh;
  T* ob = o + b * osb + h * osh;

  for (int idx = tid; idx < BQ * nch; idx += THREADS) {
    const int r = idx % BQ, ch = idx / BQ;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q0 + r < Sq) load8(qb + (long long)(q0 + r) * qss + ch * 8, x);
#pragma unroll
    for (int e = 0; e < 8; ++e) Qt[(ch * 8 + e) * QS + r] = x[e];
  }

  int n_kt = (Sk + BK - 1) / BK;
  if (causal) {
    const int q_last = q_offset + min(q0 + BQ, Sq) - 1;  // >= 0: Sq <= Sk
    n_kt = min(n_kt, q_last / BK + 1);
  }
  const int q_first = q_offset + q0;   // the block's earliest query position

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's V and P are no longer read
    for (int idx = tid; idx < BK * nch; idx += THREADS) {
      const int c = idx % BK, ch = idx / BK;
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k0 + c < Sk) load8(kb + (long long)(k0 + c) * kss + ch * 8, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) KV[(ch * 8 + e) * KS + c] = x[e];
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(Qt + d * QS + tr * 4);
      const float4 ka = *reinterpret_cast<const float4*>(KV + d * KS + tc * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Only the ragged last tile and the tiles that cross the causal
    // diagonal of this block need the mask.
    const bool edge = (k0 + BK > Sk) || (causal && k0 + BK - 1 > q_first);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_first + tr * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale_log2;
        if (edge) {
          const int kpos = k0 + tc * 4 + j;
          if (kpos >= Sk || (causal && kpos > qpos)) x = NEG;
        }
        s[i][j] = x;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mx = row_max16(fmaxf(fmaxf(s[i][0], s[i][1]),
                                       fmaxf(s[i][2], s[i][3])));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        s[i][j] = p;
        rs += p;
      }
      rs = row_sum16(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (tc * 4 + j) * QS + tr * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();   // K^T fully read; P^T written

    for (int idx = tid; idx < BK * nch; idx += THREADS) {
      const int c = idx / nch, ch = idx % nch;
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k0 + c < Sk) load8(vb + (long long)(k0 + c) * vss + ch * 8, x);
      float4* dst = reinterpret_cast<float4*>(KV + c * D + ch * 8);
      dst[0] = make_float4(x[0], x[1], x[2], x[3]);
      dst[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(Pt + c * QS + tr * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      const float* vr = KV + c * D;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = tc + 16 * j;
        if (n < D) {
          const float x = vr[n];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], x, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + tr * 4 + i;
    if (r < Sq) {
      const float den = fmaxf(l[i], 1e-30f);
      T* orow = ob + (long long)r * oss;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = tc + 16 * j;
        if (n < D) store1(orow + n, acc[i][j] / den);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Sk, int D, const long long* st,
           float scale, int causal, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(DMAX));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_attention_kernel<T><<<grid, THREADS, smem_bytes(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq / Hkv, Sq, Sk, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, (batch,
// head, position) of q, k, v and out.  Returns cudaGetLastError() after the
// launch (0 on success); the checks of shapes, strides and alignment are
// the Python wrapper's.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, int B, int Hq,
                                   int Hkv, int Sq, int Sk, int D,
                                   const long long* strides, float scale,
                                   int causal, void* stream) {
  if (D <= 0 || D > DMAX || D % 8 != 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Sq <= 0 || Sk <= 0 || (causal && Sq > Sk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, strides, scale,
                         causal, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, strides,
                                 scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
