// Pieces of the attention backward shared by its bf16 and CUDA-core routes
// (flash_attn_bwd.cu) and its float32 tensor-core route
// (flash_attn_bwd_f32.cu): element loads and stores in float32, the
// strides of the eight tensors, delta = rowsum(dO * O) and the group's
// fixed-order sum of the float32 dK and dV partials.  Each library that
// includes it is its own translation unit; kernels/_build.py hashes the
// header into the key of every library that includes it.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// Row i (0: the thread's row g, 1: g + 8) of a wgmma accumulator fragment
// of W columns (acc[4 n + 2 i + j] is column 8 n + 2 q4 + j), times mul,
// into row[0, n_cols); pair: the columns two at a time (n_cols even, the
// row aligned to two elements).
template <int W, typename T>
__device__ __forceinline__ void store_frag_row(T* row,
                                               const float (&acc)[W / 2],
                                               int i, int q4, int n_cols,
                                               float mul, int pair) {
#pragma unroll
  for (int n = 0; n < W / 8; ++n) {
    const int col = 8 * n + 2 * q4;
    const float x0 = acc[4 * n + 2 * i] * mul;
    const float x1 = acc[4 * n + 2 * i + 1] * mul;
    if (pair && col < n_cols) {
      store2(row + col, x0, x1);
    } else {
      if (col < n_cols) store1(row + col, x0);
      if (col + 1 < n_cols) store1(row + col + 1, x1);
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

// rowsum(dO * O) in float32, a warp a row (lanes over the columns, then a
// fixed shuffle tree: bitwise reruns); T is bf16 or float.
template <typename T>
__global__ void __launch_bounds__(256)
attn_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ dlt, int Hq, int Sq, int Dv,
                      Strides st, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int i = (int)(row % Sq);
  const long long bh = row / Sq;
  const int h = (int)(bh % Hq), b = (int)(bh / Hq);
  const T* orow =
      o + b * st.s[SO] + h * st.s[SO + 1] + (long long)i * st.s[SO + 2];
  const T* drow = dout + b * st.s[SDO] + h * st.s[SDO + 1] +
                  (long long)i * st.s[SDO + 2];
  float acc = 0.f;
  for (int c = lane; c < Dv; c += 32)
    acc = fmaf(load1(drow + c), load1(orow + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dlt[row] = acc;
}

// dK and dV: the sum of the group's query heads' partials in head order,
// stored as T (bf16 or float).  Not launched at D = 192 for a group of one
// head (MLA): the dK/dV kernels store dK and dV themselves.
template <typename T>
__global__ void __launch_bounds__(256)
attn_bwd_dkv_reduce_kernel(const float* __restrict__ wk,
                           const float* __restrict__ wv, T* __restrict__ dk,
                           T* __restrict__ dv, int Hkv,
                           int group, int Sk, int D, int Dv, int dkp,
                           int dvp, Strides st, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int W = D + Dv;
  const int c = (int)(idx % W);
  const long long rest = idx / W;
  const int t = (int)(rest % Sk);
  const long long bh = rest / Sk;
  const int hk = (int)(bh % Hkv), b = (int)(bh / Hkv);
  const bool is_k = c < D;
  const int col = is_k ? c : c - D, wp = is_k ? dkp : dvp;
  const float* w = (is_k ? wk : wv) +
                   (((long long)b * Hkv + hk) * group * Sk + t) * wp + col;
  float acc = 0.f;
  for (int gi = 0; gi < group; ++gi) acc += w[(long long)gi * Sk * wp];
  const int so = is_k ? SDK : SDV;
  T* out = (is_k ? dk : dv) + b * st.s[so] + hk * st.s[so + 1] +
           (long long)t * st.s[so + 2] + col;
  store1(out, acc);
}

}  // namespace
