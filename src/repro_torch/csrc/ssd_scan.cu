// Mamba2 SSD chunked scan (forward) for the H100 (sm_90a), CUDA cores.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan/kernel.py:ssd_scan
// (def at :66, pallas_call at :83, body _ssd_kernel at :26-63).  It computes
// repro_torch/kernels/ssd_scan/ref.py:ssd_chunked:
//
//   h_t = exp(A_h dt_t) h_{t-1} + dt_t (B_t outer x_t),   y_t = C_t . h_t
//
// for x (B, L, H, P), dt (B, L, H) float32, A (H,) float32 and grouped
// B/C (B, L, G, N) (head h reads group h / (H / G)), with float32
// accumulation; x, B and C are float32 or bf16 and y (B, L, H, P,
// contiguous) has x's type.
//
// Design.  The TPU kernel runs one program per (b, h) with the chunk loop
// inside, which at batch 1 gives 80 (Zamba2-2.7B) or 24 (Mamba2-130M)
// blocks for 132 SMs.  Here the chunked closed form runs as three launches
// (a "block per chunk" below is one per (chunk, tile of 64 of the P
// columns); the scan is separable over P):
//   1. ssd_chunk_state, one block per (chunk, head, batch): the chunk's
//      cumulative decay lam_i = sum_{j<=i} A dt_j and its state
//      sum_j exp(lam_end - lam_j) dt_j B_j x_j^T (N x P), written to a
//      float32 scratch with lam_end;
//   2. ssd_state_carry, one thread per state element (n, p) of a (b, h):
//      h_start[c] = h; h = exp(lam_end[c]) h + state[c], written over the
//      chunk states in place (the only sequential pass: nc steps);
//   3. ssd_chunk_out, one block per (chunk, head, batch): the intra-chunk
//      term sum_{j<=i} (C_i.B_j) exp(lam_i - lam_j) dt_j x_j plus the
//      inter-chunk term exp(lam_i) C_i . h_start, rounded once to y's type.
// A Zamba2 prefill of L = 2,048 gives 32 chunks x 80 heads = 2,560 blocks
// a launch.  Tiles are a 64-row chunk in shared memory as float; 256
// threads each own a 4 x 4 patch of a 64 x 64 product (C.B^T, then S.x
// and C.h_start), read with float4 shared loads, summed with fmaf.  The
// state width N is taken in tiles of 128 (B, C and the chunk-start state
// are staged a tile at a time), so any N works; a requested chunk above 64
// runs as chunks of 64, the same closed form over a finer cut.  The
// exponential of the intra-chunk decay is evaluated only for j <= i, where
// lam_i - lam_j <= 0: the Pallas kernel's exp(lam_i - lam_j) * mask
// (kernel.py:47) gives inf * 0 = NaN once a chunk's decay passes ~88, the
// reference's where (ref.py:71-73) and this kernel do not.  The S.x loop
// stops at the patch's diagonal.  A ragged last chunk is masked (rows past
// L load as zeros, which leave the state unchanged), so L needs no padding.
//
// Bound on the H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense tensor cores):
// at Zamba2's heads (H = 80, P = N = 64, G = 1) and L = 2,048, bf16, x, y,
// B, C and dt are 43.1 MB (12.9 us) and the four 64-deep products of each
// (chunk, head), counted over the causal pairs only, 4.0 GFLOP (4.1 us on
// tensor cores), so bytes bound it.
// This kernel uses float32 CUDA cores (67 TFLOP/s peak), no tensor cores,
// TMA or copy/compute overlap, and reads x, B and C twice (launches 1 and
// 3) plus 2 x 42 MB of float32 chunk states: a wgmma kernel that keeps the
// states on chip is later work.  Shared memory: 49,664 bytes (launch 1);
// 85,504 at N = 64 and 136,704 at N >= 128 (launch 3), above the 48 KB
// default via cudaFuncAttributeMaxDynamicSharedMemorySize.
// Domain: any P, N and L; the wrapper passes chunks of at most 64.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int QT = 64;          // rows of a chunk tile (chunk <= QT)
constexpr int PMAX = 64;        // P columns of a block
constexpr int NMAX = 128;       // state rows of a staged tile
constexpr int THREADS = 256;    // a 16 x 16 grid: tr = row group, tc = column
constexpr int TS = QT + 4;      // row stride (floats) of the transposed tiles

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* C;
  void* y;
  float* cs;          // (Bsz, H, nc, N, P) chunk states, then chunk-start states
  float* le;          // (Bsz, H, nc) lam at each chunk's last row
  int Bsz, L, H, G, P, N, Q, nc, npt;   // npt: tiles of PMAX columns of P
  long long xs0, xs1, xs2;      // x: batch, position, head strides
  long long ds0, ds1, ds2;      // dt
  long long bs0, bs1, bs2;      // B: batch, position, group
  long long cs0, cs1, cs2;      // C
};

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ __forceinline__ size_t state_smem_bytes() {
  return sizeof(float) * ((size_t)QT * (NMAX + PMAX) + 2 * QT);
}

__host__ __device__ __forceinline__ size_t out_smem_bytes(int N) {
  const size_t nr = round4(N);
  return sizeof(float) * (2 * nr * TS + (size_t)QT * PMAX + nr * PMAX +
                          (size_t)QT * TS + 2 * QT);
}

// dt of the chunk's rows (0 past L) and lam, its running sum of A dt in
// row order (the reference's cumsum), by one thread.
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
ssd_chunk_state(Args a) {
  extern __shared__ __align__(16) float sm[];
  float* Bw = sm;                  // [QT][NMAX]: exp(lam_end - lam_j) dt_j B_j
  float* X = Bw + QT * NMAX;       // [QT][PMAX]
  float* lam = X + QT * PMAX;      // [QT]
  float* dts = lam + QT;           // [QT]
  const int c = blockIdx.x / a.npt, p0 = (blockIdx.x % a.npt) * PMAX;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int t0 = c * a.Q;
  const int rows = min(a.Q, a.L - t0);
  const int pw = min(PMAX, a.P - p0);
  const int g = h / (a.H / a.G);
  const T* xb = static_cast<const T*>(a.x) + b * a.xs0 + h * a.xs2 + p0;
  const T* bb = static_cast<const T*>(a.Bm) + b * a.bs0 + g * a.bs2;

  chunk_lam(a, b, h, t0, rows, lam, dts);
  const float lam_end = lam[QT - 1];
  for (int idx = tid; idx < QT * PMAX; idx += THREADS) {
    const int i = idx / PMAX, p = idx % PMAX;
    X[idx] = (i < rows && p < pw)
                 ? load1(xb + (long long)(t0 + i) * a.xs1 + p) : 0.f;
  }

  float* out = a.cs + ((long long)(b * a.H + h) * a.nc + c) * a.N * a.P;
  for (int n0 = 0; n0 < a.N; n0 += NMAX) {
    const int nw = min(NMAX, a.N - n0);
    __syncthreads();               // the previous tile's Bw is read
    for (int idx = tid; idx < QT * NMAX; idx += THREADS) {
      const int j = idx / NMAX, n = idx % NMAX;
      float v = 0.f;
      if (j < rows && n < nw) {
        const float w = __fmul_rn(expf(__fsub_rn(lam_end, lam[j])), dts[j]);
        v = __fmul_rn(w, load1(bb + (long long)(t0 + j) * a.bs1 + n0 + n));
      }
      Bw[idx] = v;
    }
    __syncthreads();
    for (int nb = 0; nb < nw; nb += 64) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int j = 0; j < rows; ++j) {
        const float4 bv =
            *reinterpret_cast<const float4*>(Bw + j * NMAX + nb + tr * 4);
        const float4 xv =
            *reinterpret_cast<const float4*>(X + j * PMAX + tc * 4);
        const float bq[4] = {bv.x, bv.y, bv.z, bv.w};
        const float xq[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(bq[i], xq[k], acc[i][k]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = nb + tr * 4 + i;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = tc * 4 + k;
          if (n < nw && p < pw)
            out[(long long)(n0 + n) * a.P + p0 + p] = acc[i][k];
        }
      }
    }
  }
  if (tid == 0 && p0 == 0) a.le[(long long)(b * a.H + h) * a.nc + c] = lam_end;
}

__global__ void __launch_bounds__(THREADS)
ssd_state_carry(Args a) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long np = (long long)a.N * a.P;
  if (e >= np) return;
  float* st = a.cs + (long long)(b * a.H + h) * a.nc * np + e;
  const float* le = a.le + (long long)(b * a.H + h) * a.nc;
  float hc = 0.f;
  for (int c = 0; c < a.nc; ++c) {
    const float s = st[c * np];
    st[c * np] = hc;
    hc = __fadd_rn(__fmul_rn(expf(le[c]), hc), s);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_out(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int nr = round4(min(a.N, NMAX));
  float* Ct = sm;                  // [nr][TS]: C^T, a tile of NMAX states
  float* Bt = Ct + nr * TS;        // [nr][TS]: B^T
  float* X = Bt + nr * TS;         // [QT][PMAX]
  float* Hs = X + QT * PMAX;       // [nr][PMAX]: the chunk-start state
  float* St = Hs + nr * PMAX;      // [QT][TS]: S^T
  float* lam = St + QT * TS;       // [QT]
  float* dts = lam + QT;           // [QT]
  const int c = blockIdx.x / a.npt, p0 = (blockIdx.x % a.npt) * PMAX;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int t0 = c * a.Q;
  const int rows = min(a.Q, a.L - t0);
  const int pw = min(PMAX, a.P - p0);
  const int n_nt = (a.N + NMAX - 1) / NMAX;
  const int g = h / (a.H / a.G);
  const T* xb = static_cast<const T*>(a.x) + b * a.xs0 + h * a.xs2 + p0;
  const T* bb = static_cast<const T*>(a.Bm) + b * a.bs0 + g * a.bs2;
  const T* cb = static_cast<const T*>(a.C) + b * a.cs0 + g * a.cs2;
  const float* hs =
      a.cs + ((long long)(b * a.H + h) * a.nc + c) * a.N * a.P + p0;

  // Columns [n0, n0 + nw) of C (and of B) of the chunk's rows, transposed.
  auto stage_cb = [&](int n0, int nw, bool with_b) {
    for (int idx = tid; idx < QT * nr; idx += THREADS) {
      const int i = idx / nr, n = idx % nr;
      const bool ok = i < rows && n < nw;
      const long long r = (long long)(t0 + i);
      Ct[n * TS + i] = ok ? load1(cb + r * a.cs1 + n0 + n) : 0.f;
      if (with_b) Bt[n * TS + i] = ok ? load1(bb + r * a.bs1 + n0 + n) : 0.f;
    }
  };

  chunk_lam(a, b, h, t0, rows, lam, dts);
  for (int idx = tid; idx < QT * PMAX; idx += THREADS) {
    const int i = idx / PMAX, p = idx % PMAX;
    X[idx] = (i < rows && p < pw)
                 ? load1(xb + (long long)(t0 + i) * a.xs1 + p) : 0.f;
  }

  // S[i][j] = (C_i . B_j) exp(lam_i - lam_j) dt_j for j <= i, else 0;
  // the exponential is taken only where its argument is <= 0.
  {
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int t = 0; t < n_nt; ++t) {
      const int n0 = t * NMAX, nw = min(NMAX, a.N - n0);
      if (t > 0) __syncthreads();  // the previous tile is read
      stage_cb(n0, nw, true);
      __syncthreads();
      for (int n = 0; n < nw; ++n) {
        const float4 cv =
            *reinterpret_cast<const float4*>(Ct + n * TS + tr * 4);
        const float4 bv =
            *reinterpret_cast<const float4*>(Bt + n * TS + tc * 4);
        const float cq[4] = {cv.x, cv.y, cv.z, cv.w};
        const float bq[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cq[i], bq[j], s[i][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = tc * 4 + j;
      float col[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ii = tr * 4 + i;
        col[i] = jj <= ii
                     ? __fmul_rn(__fmul_rn(s[i][j],
                                           expf(__fsub_rn(lam[ii], lam[jj]))),
                                 dts[jj])
                     : 0.f;
      }
      *reinterpret_cast<float4*>(St + jj * TS + tr * 4) =
          make_float4(col[0], col[1], col[2], col[3]);
    }
  }
  __syncthreads();

  float yi[4][4], ye[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) yi[i][k] = ye[i][k] = 0.f;
  const int jmax = min(rows, tr * 4 + 4);     // S is 0 past the diagonal
  for (int j = 0; j < jmax; ++j) {
    const float4 sv = *reinterpret_cast<const float4*>(St + j * TS + tr * 4);
    const float4 xv = *reinterpret_cast<const float4*>(X + j * PMAX + tc * 4);
    const float sq[4] = {sv.x, sv.y, sv.z, sv.w};
    const float xq[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) yi[i][k] = fmaf(sq[i], xq[k], yi[i][k]);
  }
  if (c > 0) {                      // the first chunk starts from h = 0
    for (int t = 0; t < n_nt; ++t) {
      const int n0 = t * NMAX, nw = min(NMAX, a.N - n0);
      __syncthreads();              // the previous tile's C and state are read
      if (n_nt > 1) stage_cb(n0, nw, false);   // else C^T is still staged
      for (int idx = tid; idx < nr * PMAX; idx += THREADS) {
        const int n = idx / PMAX, p = idx % PMAX;
        Hs[idx] = (n < nw && p < pw) ? hs[(long long)(n0 + n) * a.P + p] : 0.f;
      }
      __syncthreads();
      for (int n = 0; n < nw; ++n) {
        const float4 cv =
            *reinterpret_cast<const float4*>(Ct + n * TS + tr * 4);
        const float4 hv =
            *reinterpret_cast<const float4*>(Hs + n * PMAX + tc * 4);
        const float cq[4] = {cv.x, cv.y, cv.z, cv.w};
        const float hq[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) ye[i][k] = fmaf(cq[i], hq[k], ye[i][k]);
      }
    }
  }
  T* yb = static_cast<T*>(a.y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ii = tr * 4 + i;
    if (ii >= rows) continue;
    const float decay = expf(lam[ii]);
    T* yrow = yb + (((long long)b * a.L + t0 + ii) * a.H + h) * a.P + p0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = tc * 4 + k;
      if (p < pw)
        store1(yrow + p, __fadd_rn(yi[i][k], __fmul_rn(decay, ye[i][k])));
    }
  }
}

template <typename T>
int launch(Args& a, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_state<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)state_smem_bytes());
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(ssd_chunk_out<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)out_smem_bytes(NMAX));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(a.nc * a.npt, a.H, a.Bsz);
  ssd_chunk_state<T><<<grid, THREADS, state_smem_bytes(), stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long np = (long long)a.N * a.P;
  const dim3 cgrid((unsigned)((np + THREADS - 1) / THREADS), a.H, a.Bsz);
  ssd_state_carry<<<cgrid, THREADS, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_out<T><<<grid, THREADS, out_smem_bytes(min(a.N, NMAX)),
                     stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt and A are float32;
// chunk <= 64 (the wrapper cuts a longer one into chunks of 64).
// strides: 12 element strides, (batch, position, head) of x and dt and
// (batch, position, group) of B and C; the last axis of x, B and C is
// contiguous.  scratch_states: Bsz * H * nc * N * P floats; scratch_lam:
// Bsz * H * nc floats, nc = ceil(L / chunk).  Returns cudaGetLastError()
// after the launches (0 on success); the checks of shapes, types and
// strides are the Python wrapper's.
extern "C" int ssd_scan_fwd(int dtype, const void* x, const float* dt,
                            const float* A, const void* Bm, const void* C,
                            void* y, float* scratch_states,
                            float* scratch_lam, int Bsz, int L, int H, int G,
                            int P, int N, int chunk, const long long* strides,
                            void* stream) {
  if (Bsz <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      N <= 0 || chunk <= 0 || chunk > QT)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x; a.dt = dt; a.A = A; a.Bm = Bm; a.C = C; a.y = y;
  a.cs = scratch_states; a.le = scratch_lam;
  a.Bsz = Bsz; a.L = L; a.H = H; a.G = G; a.P = P; a.N = N; a.Q = chunk;
  a.nc = (L + chunk - 1) / chunk;
  a.npt = (P + PMAX - 1) / PMAX;
  a.xs0 = strides[0]; a.xs1 = strides[1]; a.xs2 = strides[2];
  a.ds0 = strides[3]; a.ds1 = strides[4]; a.ds2 = strides[5];
  a.bs0 = strides[6]; a.bs1 = strides[7]; a.bs2 = strides[8];
  a.cs0 = strides[9]; a.cs1 = strides[10]; a.cs2 = strides[11];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}
