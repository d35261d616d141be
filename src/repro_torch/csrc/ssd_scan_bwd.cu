// Mamba2 SSD chunked scan, backward, for the H100 (sm_90a), on CUDA cores:
// the route "cuda_cores" of kernels/ssd_scan/kernel.py:route_bwd, which
// takes float32 (float16 and mixed dtypes read in float32) and bf16 past N
// 128 or P 256; bf16 within those runs on the tensor cores
// (ssd_scan_bwd_wgmma.cu, route "wgmma").
//
// Replaces no Pallas kernel: the JAX package differentiates its chunked
// closed form (repro/kernels/ssd_scan/ref.py:ssd_chunked) with XLA and has
// no backward of the Pallas kernel repro/kernels/ssd_scan/kernel.py:ssd_scan
// (def at :66, pallas_call at :83).  This is the port's gradient of its
// forward kernels (ssd_scan.cu, ssd_scan_f32.cu); its plain version is
// repro_torch/kernels/ssd_scan/ref.py:ssd_vjp, torch.autograd of
// ref.ssd_chunked (and of ref.ssd_final_state for a final-state gradient).
//
// Per (batch, head) and chunk of Q rows (i, j in [0, Q)), lam_i = sum_{k<=i}
// A dt_k, Lend = lam_{Q-1}, h0 the chunk's start state (N x P), dh1 the
// gradient at its end state, the forward is
//   S_ij = (C_i.B_j) e^{lam_i - lam_j} dt_j (j <= i),  w_j = e^{Lend - lam_j} dt_j,
//   y_i = sum_j S_ij x_j + e^{lam_i} C_i^T h0,  h1 = e^{Lend} h0 + sum_j w_j B_j x_j^T,
// and, with dS_ij = dy_i.x_j, e_ij = e^{lam_i - lam_j}, dG = dS e dt_j,
// T = dS G e, R = T dt_j = dS S, v_j = dh1^T B_j, z_j = x_j.v_j:
//   dx_j = sum_{i>=j} S_ij dy_i + w_j v_j
//   dC_i = sum_j dG_ij B_j + e^{lam_i} h0 dy_i
//   dB_j = sum_i dG_ij C_i + w_j dh1 x_j
//   dh0  = e^{Lend} dh1 + sum_i e^{lam_i} C_i dy_i^T
//   ddt_j = sum_i T_ij + z_j e^{Lend - lam_j} + A sum_{i>=j} dlam_i
//   dlam_i = sum_j R_ij - sum_k R_ki + e^{lam_i} C_i.(h0 dy_i) - z_i w_i
//            (+ sum_j z_j w_j + e^{Lend} <h0, dh1> at the chunk's last row)
//   dA += sum_k dt_k sum_{i>=k} dlam_i,
// dB and dC summed over the heads of a group, dA over batch and chunks.
// The exponential is taken only for j <= i and of lam_i, Lend - lam_j and
// Lend, whose arguments are <= 0 when A dt <= 0 (the models' A < 0), so the
// gradient is finite at any decay, where jax.grad of the reference's
// ssd_chunked, which exponentiates lam_i - lam_j for j > i too, gives NaN
// once a chunk's decay passes ~88.  A ragged last chunk is masked: rows past
// L read as zeros with dt = 0 (lam stays at its last row's value, so Lend is
// lam at the last row), and nothing is written past L.  A requested chunk
// above 64 runs as chunks of 64 (the same function; only the order of the
// float32 sums changes), as the forward's CUDA-core route does.
//
// Four launches, float32 arithmetic for every dtype (x, B, C and dy read in
// bf16 or float32; the wrapper reads float16 and mixed dtypes in float32):
//   1. ssd_bwd_states, a block per (chunk, tile of 64 of P, head, batch):
//      lam, each chunk's state sum_j w_j B_j x_j^T and its term of dh,
//      sum_i e^{lam_i} C_i dy_i^T (two 64-deep products a tile of N);
//   2. ssd_bwd_carry (ssd_bwd_carry.cuh, shared with the wgmma route), a
//      thread per 4 state elements (n, p) of a (batch, head): the forward
//      carry writes each chunk's start state h0 over its chunk state, the
//      reverse carry (from the final state's gradient, or 0) each chunk's
//      end gradient dh1 over its dh term;
//   3. ssd_bwd_chunk, a block per (chunk, head, batch): the equations
//      above, P and N taken in tiles of 64; dx, ddt written, per-head dB and
//      dC to a float32 scratch (B, L, H, N), the chunk's share of dA to a
//      float64 scratch;
//   4. ssd_bwd_reduce (ssd_bwd_carry.cuh, a head a run): the fixed-order
//      sums of dB and dC over a group's heads and of dA over batch and
//      chunks (in float64).
// No atomics: every sum is taken in one fixed order, so reruns are bitwise
// equal.  A block's 256 threads each own a 4 x 4 patch of a 64 x 64 product
// (operands staged as float in shared memory, float4 reads, fmaf sums, as
// ssd_scan.cu's CUDA-core route); row and column sums of R and T, and the
// chunk's scalar tail (the suffix sums of dlam), run in float64.
//
// Bound on the H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 tensor cores, 67
// TFLOP/s float32 CUDA cores) at Zamba2-2.7B's training shape (B, L, H, P,
// G, N) = (1, 4,096, 80, 64, 1, 64), bf16: x, dy and dx are 42 MB each and
// B, C, dt, dB, dC and ddt 4.5 MB together, 131 MB (0.039 ms); the
// products (G, dS, S^T dy, dG B and dG^T C over the causal pairs, dh1^T B,
// h0 dy, dh1 x and the two chunk-state products a row) are 20 GFLOP, 0.020
// ms on tensor cores, so bytes bound it (chip_smoke.py computes both from
// the shapes).  This first design runs the products on the CUDA cores (0.3
// ms at their peak) and moves four float32 scratch tensors of (B, H, nc, N,
// P) or (B, L, H, N) (336 MB there) besides.
// Shared memory: 70,656 bytes (launch 1), 126,976 (launch 3), above the 48
// KB default via cudaFuncAttributeMaxDynamicSharedMemorySize.
// Domain: any L >= 1, P, N >= 1, G dividing H, chunk <= 64 (the wrapper
// passes min(chunk, 64)), strided x, dy, B, C and dt (the last axis of x,
// dy, B and C contiguous).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ssd_bwd_carry.cuh"   // launches 2 and 4, shared with the wgmma route

namespace {

constexpr int QT = 64;          // rows of a chunk tile (chunk <= QT)
constexpr int KT = 64;          // columns of P or N of a staged tile
constexpr int THREADS = 256;    // a 16 x 16 grid: tr = row group, tc = column
constexpr int TS = QT + 4;      // row stride (floats) of a staged tile
constexpr unsigned FULL_MASK = 0xffffffffu;

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* C;
  const void* dy;
  const float* dhf;   // (Bsz, H, N, P) gradient of the final state, or null
  void* dx;           // (Bsz, L, H, P)
  float* ddt;         // (Bsz, L, H)
  float* dA;          // (H,)
  void* dB;           // (Bsz, L, G, N)
  void* dC;
  float* hs;          // (Bsz, H, nc, N, P): chunk states, then start states
  float* ds;          // (Bsz, H, nc, N, P): dh terms, then end gradients dh1
  float* le;          // (Bsz, H, nc) lam at each chunk's last row
  float* dBp;         // (Bsz, L, H, N) per-head dB
  float* dCp;         // (Bsz, L, H, N) per-head dC
  double* dAp;        // (Bsz, H, nc) each chunk's share of dA
  int Bsz, L, H, G, P, N, Q, nc;
  long long xs0, xs1, xs2;      // x: batch, position, head strides
  long long ds0, ds1, ds2;      // dt
  long long bs0, bs1, bs2;      // B: batch, position, group
  long long cs0, cs1, cs2;      // C
  long long ys0, ys1, ys2;      // dy: batch, position, head
};

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr size_t TILE_FLOATS = (size_t)QT * TS;

__host__ __device__ constexpr size_t states_smem_bytes() {
  return sizeof(float) * (4 * TILE_FLOATS + 4 * QT);
}

__host__ __device__ constexpr size_t chunk_smem_bytes() {
  return sizeof(float) * (7 * TILE_FLOATS + 6 * QT) +
         sizeof(double) * (THREADS + 3 * QT);
}

// A 64 x 64 tile of a row-major source (element (r, c) at src[r * rs + c];
// rows < nr and columns < nc read, the rest 0), each row scaled by coef[r]
// if given, into dst as [r][c] or, transposed, [c][r] (row stride TS).
template <typename S>
__device__ __forceinline__ void stage(float* dst, const S* src, long long rs,
                                      int nr, int nc, bool transpose,
                                      const float* coef = nullptr) {
  for (int idx = threadIdx.x; idx < QT * KT; idx += THREADS) {
    const int r = idx / KT, c = idx % KT;
    float v = 0.f;
    if (r < nr && c < nc) {
      v = load1(src + r * rs + c);
      if (coef != nullptr) v = v * coef[r];
    }
    if (transpose)
      dst[c * TS + r] = v;
    else
      dst[r * TS + c] = v;
  }
}

// acc[a][b] += sum_{k < K} lt[k][4 tr + a] * rt[k][4 tc + b]: the thread's
// patch of a 64 x 64 product whose operands lie k-major in shared memory.
__device__ __forceinline__ void mma_patch(float (&acc)[4][4], const float* lt,
                                          const float* rt, int K, int tr,
                                          int tc) {
  for (int k = 0; k < K; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(lt + k * TS + tr * 4);
    const float4 bv = *reinterpret_cast<const float4*>(rt + k * TS + tc * 4);
    const float aq[4] = {av.x, av.y, av.z, av.w};
    const float bq[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(aq[i], bq[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// The sum over the 16 threads of a patch row (tc = 0..15: lanes of one
// half-warp), the same fixed tree in every lane.
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(FULL_MASK, v, off);
  return v;
}

// dt of the chunk's rows (0 past L) and lam, its running sum of A dt in row
// order (the forward's chunk_lam), by one thread.
__device__ __forceinline__ void chunk_lam(const Args& a, int b, int h, int t0,
                                          int rows, float* lam, float* dts) {
  for (int i = threadIdx.x; i < QT; i += THREADS)
    dts[i] = i < rows ? a.dt[b * a.ds0 + (long long)(t0 + i) * a.ds1 +
                             h * a.ds2]
                      : 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    const float A = a.A[h];
    float s = 0.f;
    for (int i = 0; i < QT; ++i) {
      s = __fadd_rn(s, __fmul_rn(A, dts[i]));
      lam[i] = s;
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_states(Args a) {
  extern __shared__ __align__(16) float sm[];
  float* Bw = sm;                     // [j][n]: w_j B_j
  float* X = Bw + TILE_FLOATS;        // [j][p]
  float* Cw = X + TILE_FLOATS;        // [i][n]: e^{lam_i} C_i
  float* DY = Cw + TILE_FLOATS;       // [i][p]
  float* lam = DY + TILE_FLOATS;
  float* dts = lam + QT;
  float* wv = dts + QT;
  float* el = wv + QT;
  const int npt = (a.P + KT - 1) / KT;
  const int c = blockIdx.x / npt, p0 = (blockIdx.x % npt) * KT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int t0 = c * a.Q, rows = min(a.Q, a.L - t0);
  const int pw = min(KT, a.P - p0);
  const int g = h / (a.H / a.G);
  const long long bh = (long long)b * a.H + h;
  const T* xb = static_cast<const T*>(a.x) + b * a.xs0 + h * a.xs2 +
                (long long)t0 * a.xs1 + p0;
  const T* yb = static_cast<const T*>(a.dy) + b * a.ys0 + h * a.ys2 +
                (long long)t0 * a.ys1 + p0;
  const T* bb = static_cast<const T*>(a.Bm) + b * a.bs0 + g * a.bs2 +
                (long long)t0 * a.bs1;
  const T* cb = static_cast<const T*>(a.C) + b * a.cs0 + g * a.cs2 +
                (long long)t0 * a.cs1;

  chunk_lam(a, b, h, t0, rows, lam, dts);
  const float lam_end = lam[QT - 1];
  if (tid < QT) {
    wv[tid] = tid < rows ? expf(lam_end - lam[tid]) * dts[tid] : 0.f;
    el[tid] = tid < rows ? expf(lam[tid]) : 0.f;
  }
  stage(X, xb, a.xs1, rows, pw, false);
  stage(DY, yb, a.ys1, rows, pw, false);
  const long long np = (long long)a.N * a.P;
  float* hs = a.hs + (bh * a.nc + c) * np + p0;
  float* ds = a.ds + (bh * a.nc + c) * np + p0;
  for (int n0 = 0; n0 < a.N; n0 += KT) {
    const int nw = min(KT, a.N - n0);
    __syncthreads();                  // wv, el written; the last tile read
    stage(Bw, bb + n0, a.bs1, rows, nw, false, wv);
    stage(Cw, cb + n0, a.cs1, rows, nw, false, el);
    __syncthreads();
    float st[4][4], du[4][4];
    zero(st);
    zero(du);
    mma_patch(st, Bw, X, rows, tr, tc);     // [n][p] += w_j B_jn x_jp
    mma_patch(du, Cw, DY, rows, tr, tc);    // [n][p] += e^{lam_i} C_in dy_ip
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = tr * 4 + i;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = tc * 4 + k;
        if (n < nw && p < pw) {
          hs[(long long)(n0 + n) * a.P + p] = st[i][k];
          ds[(long long)(n0 + n) * a.P + p] = du[i][k];
        }
      }
    }
  }
  if (tid == 0 && p0 == 0) a.le[bh * a.nc + c] = lam_end;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_chunk(Args a) {
  extern __shared__ __align__(16) float sm[];
  float* sS = sm;                     // S[i][j]; later a staging tile
  float* sdG = sS + TILE_FLOATS;      // dG[i][j]
  float* sdGt = sdG + TILE_FLOATS;    // dG[j][i]
  float* sR = sdGt + TILE_FLOATS;     // R[i][j]; later a staging tile
  float* sT = sR + TILE_FLOATS;       // T[i][j]; later a staging tile
  float* s0 = sT + TILE_FLOATS;       // staging tiles
  float* s1 = s0 + TILE_FLOATS;
  float* lam = s1 + TILE_FLOATS;
  float* dts = lam + QT;
  float* wv = dts + QT;               // w_j = e^{Lend - lam_j} dt_j
  float* el = wv + QT;                // e^{lam_i}
  float* zs = el + QT;                // z_j = x_j . (dh1^T B_j)
  float* cq = zs + QT;                // C_i . (h0 dy_i)
  double* red = reinterpret_cast<double*>(cq + QT);   // [THREADS]
  double* rowR = red + THREADS;       // sum_j R_ij
  double* colR = rowR + QT;           // sum_i R_ij
  double* colT = colR + QT;           // sum_i T_ij
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int t0 = c * a.Q, rows = min(a.Q, a.L - t0);
  const int g = h / (a.H / a.G);
  const long long bh = (long long)b * a.H + h;
  const T* xb = static_cast<const T*>(a.x) + b * a.xs0 + h * a.xs2 +
                (long long)t0 * a.xs1;
  const T* yb = static_cast<const T*>(a.dy) + b * a.ys0 + h * a.ys2 +
                (long long)t0 * a.ys1;
  const T* bb = static_cast<const T*>(a.Bm) + b * a.bs0 + g * a.bs2 +
                (long long)t0 * a.bs1;
  const T* cb = static_cast<const T*>(a.C) + b * a.cs0 + g * a.cs2 +
                (long long)t0 * a.cs1;
  const long long np = (long long)a.N * a.P;
  const float* h0 = a.hs + (bh * a.nc + c) * np;
  const float* dh1 = a.ds + (bh * a.nc + c) * np;

  chunk_lam(a, b, h, t0, rows, lam, dts);
  const float lam_end = lam[QT - 1];
  if (tid < QT) {
    wv[tid] = tid < rows ? expf(lam_end - lam[tid]) * dts[tid] : 0.f;
    el[tid] = tid < rows ? expf(lam[tid]) : 0.f;
    zs[tid] = 0.f;
    cq[tid] = 0.f;
  }

  // G = C B^T over tiles of N and dS = dy x^T over tiles of P (rows i,
  // columns j), then S, dG, R and T of the causal pairs.
  float G[4][4], dS[4][4];
  zero(G);
  zero(dS);
  for (int n0 = 0; n0 < a.N; n0 += KT) {
    const int nw = min(KT, a.N - n0);
    __syncthreads();
    stage(s0, cb + n0, a.cs1, rows, nw, true);
    stage(s1, bb + n0, a.bs1, rows, nw, true);
    __syncthreads();
    mma_patch(G, s0, s1, nw, tr, tc);
  }
  for (int p0 = 0; p0 < a.P; p0 += KT) {
    const int pw = min(KT, a.P - p0);
    __syncthreads();
    stage(s0, yb + p0, a.ys1, rows, pw, true);
    stage(s1, xb + p0, a.xs1, rows, pw, true);
    __syncthreads();
    mma_patch(dS, s0, s1, pw, tr, tc);
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = tr * 4 + ii;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = tc * 4 + jj;
      float s = 0.f, t = 0.f, dg = 0.f, r = 0.f;
      if (j <= i && i < rows) {
        const float e = expf(lam[i] - lam[j]);     // argument <= 0
        s = G[ii][jj] * e * dts[j];
        t = dS[ii][jj] * G[ii][jj] * e;
        dg = dS[ii][jj] * e * dts[j];
        r = t * dts[j];
      }
      sS[i * TS + j] = s;
      sdG[i * TS + j] = dg;
      sdGt[j * TS + i] = dg;
      sR[i * TS + j] = r;
      sT[i * TS + j] = t;
    }
  }
  __syncthreads();
  if (tid < QT) {
    double acc = 0.0;
    for (int j = 0; j < QT; ++j) acc += sR[tid * TS + j];
    rowR[tid] = acc;
  } else if (tid < 2 * QT) {
    const int k = tid - QT;
    double acc = 0.0;
    for (int i = 0; i < QT; ++i) acc += sR[i * TS + k];
    colR[k] = acc;
  } else if (tid < 3 * QT) {
    const int k = tid - 2 * QT;
    double acc = 0.0;
    for (int i = 0; i < QT; ++i) acc += sT[i * TS + k];
    colT[k] = acc;
  }

  // dx = S^T dy + w v with v_j = dh1^T B_j, and z_j = x_j . v_j, a tile of
  // P at a time (rows j, columns p).
  for (int p0 = 0; p0 < a.P; p0 += KT) {
    const int pw = min(KT, a.P - p0);
    __syncthreads();                  // the row and column sums are taken
    stage(s0, yb + p0, a.ys1, rows, pw, false);
    __syncthreads();
    float dx[4][4], v[4][4];
    zero(dx);
    zero(v);
    mma_patch(dx, sS, s0, rows, tr, tc);
    for (int n0 = 0; n0 < a.N; n0 += KT) {
      const int nw = min(KT, a.N - n0);
      __syncthreads();
      stage(s0, bb + n0, a.bs1, rows, nw, true);
      stage(s1, dh1 + (long long)n0 * a.P + p0, a.P, nw, pw, false);
      __syncthreads();
      mma_patch(v, s0, s1, nw, tr, tc);
    }
    T* dxo = static_cast<T*>(a.dx);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int j = tr * 4 + ii;
      float zp = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int p = tc * 4 + jj;
        if (j < rows && p < pw) {
          const float xv = load1(xb + (long long)j * a.xs1 + p0 + p);
          zp = fmaf(xv, v[ii][jj], zp);
          store1(dxo + (((long long)b * a.L + t0 + j) * a.H + h) * a.P + p0 +
                     p,
                 fmaf(wv[j], v[ii][jj], dx[ii][jj]));
        }
      }
      zp = row_sum16(zp);
      if (tc == 0) zs[j] += zp;
    }
  }

  // dC = dG B + e^{lam_i} q with q_i = h0 dy_i, and dB = dG^T C + w u with
  // u_j = dh1 x_j, a tile of N at a time; C_i . q_i and <h0, dh1> beside.
  double hd = 0.0;
  for (int n0 = 0; n0 < a.N; n0 += KT) {
    const int nw = min(KT, a.N - n0);
    __syncthreads();
    stage(s0, bb + n0, a.bs1, rows, nw, false);     // B [j][n]
    stage(s1, cb + n0, a.cs1, rows, nw, false);     // C [i][n]
    __syncthreads();
    float acc[4][4], q[4][4];
    zero(acc);
    zero(q);
    mma_patch(acc, sdGt, s0, rows, tr, tc);         // [i][n] += dG_ij B_jn
    for (int p0 = 0; p0 < a.P; p0 += KT) {
      const int pw = min(KT, a.P - p0);
      __syncthreads();
      stage(sS, yb + p0, a.ys1, rows, pw, true);    // dy^T [p][i]
      stage(sR, h0 + (long long)n0 * a.P + p0, a.P, nw, pw, true);  // h0^T
      __syncthreads();
      mma_patch(q, sS, sR, pw, tr, tc);
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int i = tr * 4 + ii;
      float cp = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int n = tc * 4 + jj;
        cp = fmaf(s1[i * TS + n], q[ii][jj], cp);
        if (i < rows && n < nw)
          a.dCp[(((long long)b * a.L + t0 + i) * a.H + h) * a.N + n0 + n] =
              fmaf(el[i], q[ii][jj], acc[ii][jj]);
      }
      cp = row_sum16(cp);
      if (tc == 0) cq[i] += cp;
    }
    zero(acc);
    zero(q);                                        // q now holds u
    mma_patch(acc, sdG, s1, rows, tr, tc);          // [j][n] += dG_ij C_in
    for (int p0 = 0; p0 < a.P; p0 += KT) {
      const int pw = min(KT, a.P - p0);
      __syncthreads();                  // s0 (B) and the last tiles are read
      stage(sT, xb + p0, a.xs1, rows, pw, true);    // x^T [p][j]
      for (int idx = tid; idx < KT * KT; idx += THREADS) {   // dh1^T [p][n]
        const int r = idx / KT, cc = idx % KT;
        float dv = 0.f;
        if (r < nw && cc < pw) {
          const long long o = (long long)(n0 + r) * a.P + p0 + cc;
          dv = dh1[o];
          hd += (double)h0[o] * dv;
        }
        s0[cc * TS + r] = dv;
      }
      __syncthreads();
      mma_patch(q, sT, s0, pw, tr, tc);
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int j = tr * 4 + ii;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int n = tc * 4 + jj;
        if (j < rows && n < nw)
          a.dBp[(((long long)b * a.L + t0 + j) * a.H + h) * a.N + n0 + n] =
              fmaf(wv[j], q[ii][jj], acc[ii][jj]);
      }
    }
  }
  red[tid] = hd;
  __syncthreads();

  // dlam, its suffix sums, ddt and the chunk's share of dA (one thread, in
  // float64, rows in reverse order).
  if (tid == 0) {
    double hsum = 0.0, zw = 0.0;
    for (int t = 0; t < THREADS; ++t) hsum += red[t];
    for (int j = 0; j < rows; ++j) zw += (double)zs[j] * wv[j];
    const double A = a.A[h];
    double s = 0.0, dA = 0.0;
    for (int k = rows - 1; k >= 0; --k) {
      double dl = rowR[k] - colR[k] + (double)el[k] * cq[k] -
                  (double)zs[k] * wv[k];
      if (k == rows - 1) dl += zw + (double)expf(lam_end) * hsum;
      s += dl;
      a.ddt[((long long)b * a.L + t0 + k) * a.H + h] =
          (float)(colT[k] + (double)zs[k] * expf(lam_end - lam[k]) + A * s);
      dA += (double)dts[k] * s;
    }
    a.dAp[bh * a.nc + c] = dA;
  }
}

template <typename T>
int launch(Args& a, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd_states<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)states_smem_bytes());
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(ssd_bwd_chunk<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)chunk_smem_bytes());
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int npt = (a.P + KT - 1) / KT;
  ssd_bwd_states<T><<<dim3(a.nc * npt, a.H, a.Bsz), THREADS,
                      states_smem_bytes(), stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_carry(a.hs, a.ds, a.le, a.dhf, a.Bsz, a.H, a.N, a.P, a.nc,
                     stream);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_chunk<T><<<dim3(a.nc, a.H, a.Bsz), THREADS, chunk_smem_bytes(),
                     stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_reduce(a.dBp, a.dCp, a.dAp, static_cast<T*>(a.dB),
                            static_cast<T*>(a.dC), a.dA, a.Bsz, a.L, a.H,
                            a.G, a.N, a.nc, a.H, stream);
}

}  // namespace

// ssd_scan_bwd: the gradients (dx, ddt, dA, dB, dC) of the SSD scan along
// dy (and d final_state, or null).  dtype 0: x, B, C, dy, dx, dB, dC float32;
// 1: bf16.  dt, A float32.  strides: (batch, position, head or group) of x,
// dt, B, C and dy, in that order (their last axes contiguous).  Outputs
// contiguous: dx (Bsz, L, H, P), ddt (Bsz, L, H), dA (H,), dB and dC (Bsz,
// L, G, N).  Scratch: states and dstates Bsz * H * nc * N * P floats,
// lam_end Bsz * H * nc floats, dBp and dCp Bsz * L * H * N floats, dAp Bsz
// * H * nc doubles, with nc = ceil(L / chunk), chunk in [1, 64].
extern "C" int ssd_scan_bwd(int dtype, const void* x, const float* dt,
                            const float* A, const void* Bm, const void* C,
                            const void* dy, const float* dh_final, void* dx,
                            float* ddt, float* dA, void* dB, void* dC,
                            float* states, float* dstates, float* lam_end,
                            float* dBp, float* dCp, double* dAp, int Bsz,
                            int L, int H, int G, int P, int N, int chunk,
                            const long long* strides, void* stream) {
  if (Bsz <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      N <= 0 || chunk <= 0 || chunk > QT)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x; a.dt = dt; a.A = A; a.Bm = Bm; a.C = C; a.dy = dy;
  a.dhf = dh_final;
  a.dx = dx; a.ddt = ddt; a.dA = dA; a.dB = dB; a.dC = dC;
  a.hs = states; a.ds = dstates; a.le = lam_end;
  a.dBp = dBp; a.dCp = dCp; a.dAp = dAp;
  a.Bsz = Bsz; a.L = L; a.H = H; a.G = G; a.P = P; a.N = N; a.Q = chunk;
  a.nc = (L + chunk - 1) / chunk;
  a.xs0 = strides[0]; a.xs1 = strides[1]; a.xs2 = strides[2];
  a.ds0 = strides[3]; a.ds1 = strides[4]; a.ds2 = strides[5];
  a.bs0 = strides[6]; a.bs1 = strides[7]; a.bs2 = strides[8];
  a.cs0 = strides[9]; a.cs1 = strides[10]; a.cs2 = strides[11];
  a.ys0 = strides[12]; a.ys1 = strides[13]; a.ys2 = strides[14];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}
