// Launches 2 and 4 of the SSD scan's backward, shared by both of its routes
// (ssd_scan_bwd.cu on the CUDA cores, ssd_scan_bwd_wgmma.cu on the tensor
// cores): the carries of the chunk states and of their gradients across
// chunks, and the fixed-order sums of dB, dC and dA.  Both routes write the
// same float32 scratch: hs and ds (Bsz, H, nc, N, P), le (Bsz, H, nc), dBp
// and dCp (Bsz, L, nrun, N) with nrun runs of consecutive heads (H on the
// CUDA cores, a head a run), dAp (Bsz, H, nc) float64.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CARRY_THREADS = 256;
constexpr int CARRY_AHEAD = 8;          // chunks a thread loads before it walks

__device__ __forceinline__ void load4(const float* p, bool vec, int nv,
                                      float (&v)[4]) {
  if (vec) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < nv ? p[e] : 0.f;
  }
}

__device__ __forceinline__ void store4(float* p, bool vec, int nv,
                                       const float (&v)[4]) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < nv) p[e] = v[e];
  }
}

// A thread per 4 state elements (n, p) of a (batch, head), grid (ceil(np /
// 1024), H, Bsz) of CARRY_THREADS: the forward carry writes each chunk's
// start state h0 over its chunk state (h0 = 0, then h = e^{Lend} h + s),
// the reverse carry (from the final state's gradient dhf, or 0) each
// chunk's end gradient dh1 over its dh term.  Each thread loads
// CARRY_AHEAD chunks before it walks them: one element a thread and a
// dependent load a step made the carry latency-bound (1.65-1.66 ms device
// at Zamba2-2.7B's train shape on an NVIDIA H100 80GB HBM3 at 700 W, 39 %
// of the CUDA-core backward; tools/ssd_times.py).
__global__ void __launch_bounds__(CARRY_THREADS)
ssd_bwd_carry(float* hs, float* ds, const float* le, const float* dhf,
              int H, long long np, int nc) {
  const long long e = ((long long)blockIdx.x * CARRY_THREADS + threadIdx.x)
                      * 4;
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  if (e >= np) return;
  const int nv = (int)min(4LL, np - e);
  const bool vec = nv == 4 && (np & 3) == 0;
  hs += bh * nc * np + e;
  ds += bh * nc * np + e;
  le += bh * nc;
  float hc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < nc; c0 += CARRY_AHEAD) {
    float s[CARRY_AHEAD][4], ex[CARRY_AHEAD];
#pragma unroll
    for (int u = 0; u < CARRY_AHEAD; ++u)
      if (c0 + u < nc) {
        load4(hs + (c0 + u) * np, vec, nv, s[u]);
        ex[u] = expf(le[c0 + u]);
      }
#pragma unroll
    for (int u = 0; u < CARRY_AHEAD; ++u)
      if (c0 + u < nc) {
        store4(hs + (c0 + u) * np, vec, nv, hc);
#pragma unroll
        for (int v = 0; v < 4; ++v)
          hc[v] = __fadd_rn(__fmul_rn(ex[u], hc[v]), s[u][v]);
      }
  }
  float dh[4] = {0.f, 0.f, 0.f, 0.f};
  if (dhf != nullptr) load4(dhf + bh * np + e, vec, nv, dh);
  for (int c0 = nc - 1; c0 >= 0; c0 -= CARRY_AHEAD) {
    float u4[CARRY_AHEAD][4], ex[CARRY_AHEAD];
#pragma unroll
    for (int u = 0; u < CARRY_AHEAD; ++u)
      if (c0 - u >= 0) {
        load4(ds + (c0 - u) * np, vec, nv, u4[u]);
        ex[u] = expf(le[c0 - u]);
      }
#pragma unroll
    for (int u = 0; u < CARRY_AHEAD; ++u)
      if (c0 - u >= 0) {
        store4(ds + (c0 - u) * np, vec, nv, dh);
#pragma unroll
        for (int v = 0; v < 4; ++v)
          dh[v] = __fadd_rn(__fmul_rn(ex[u], dh[v]), u4[u][v]);
      }
  }
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Grid (ceil(max(Bsz L G N, H) / 256), 3) of 256 threads: blockIdx.y 0 and
// 1 sum dB and dC over a group's runs (nrun / G of them, in order, float64),
// 2 sums dA over batch, then chunks (float64).
template <typename T>
__global__ void __launch_bounds__(256)
ssd_bwd_reduce(const float* dBp, const float* dCp, const double* dAp, T* dB,
               T* dC, float* dA, int Bsz, int L, int H, int G, int N, int nc,
               int nrun) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (blockIdx.y == 2) {
    if (e >= H) return;
    double acc = 0.0;
    for (int b = 0; b < Bsz; ++b)
      for (int c = 0; c < nc; ++c)
        acc += dAp[((long long)b * H + e) * nc + c];
    dA[e] = (float)acc;
    return;
  }
  const long long total = (long long)Bsz * L * G * N;
  if (e >= total) return;
  const int rpg = nrun / G;
  const long long n = e % N, rest = e / N;
  const long long g = rest % G, bl = rest / G;
  const float* src = (blockIdx.y == 0 ? dBp : dCp) + (bl * nrun + g * rpg) * N
                     + n;
  double acc = 0.0;
  for (int r = 0; r < rpg; ++r) acc += src[(long long)r * N];
  store_out((blockIdx.y == 0 ? dB : dC) + e, (float)acc);
}

// Launch 2 of a backward (the carries) on `stream`.
cudaError_t launch_carry(float* hs, float* ds, const float* le,
                         const float* dhf, int Bsz, int H, int N, int P,
                         int nc, cudaStream_t stream) {
  const long long np = (long long)N * P;
  ssd_bwd_carry<<<dim3((unsigned)((np + 4 * CARRY_THREADS - 1) /
                                  (4 * CARRY_THREADS)), H, Bsz),
                  CARRY_THREADS, 0, stream>>>(hs, ds, le, dhf, H, np, nc);
  return cudaGetLastError();
}

// Launch 4 of a backward (the sums) on `stream`.
template <typename T>
cudaError_t launch_reduce(const float* dBp, const float* dCp,
                          const double* dAp, T* dB, T* dC, float* dA, int Bsz,
                          int L, int H, int G, int N, int nc, int nrun,
                          cudaStream_t stream) {
  long long total = (long long)Bsz * L * G * N;
  if (total < H) total = H;
  ssd_bwd_reduce<T><<<dim3((unsigned)((total + 255) / 256), 3), 256, 0,
                       stream>>>(dBp, dCp, dAp, dB, dC, dA, Bsz, L, H, G, N,
                                 nc, nrun);
  return cudaGetLastError();
}

}  // namespace
