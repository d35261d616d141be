// Mamba2 SSD chunked scan (forward) for the H100 (sm_90a): a bf16
// tensor-core walk (wgmma + TMA, one launch) and a CUDA-core route; the
// float32 tensor-core walk is ssd_scan_f32.cu.  Both sources take their
// Hopper helpers (mbarriers, TMA, wgmma, descriptors) from hopper.cuh.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan/kernel.py:ssd_scan
// (def at :66, pallas_call at :83, body _ssd_kernel at :26-63).  Both routes
// compute repro_torch/kernels/ssd_scan/ref.py:ssd_chunked:
//
//   h_t = exp(A_h dt_t) h_{t-1} + dt_t (B_t outer x_t),   y_t = C_t . h_t
//
// for x (B, L, H, P), dt (B, L, H) float32, A (H,) float32 and grouped
// B/C (B, L, G, N) (head h reads group h / (H / G)), with float32
// accumulation, y (B, L, H, P, contiguous) in x's type, and, on request,
// the final state h_L (B, H, N, P) float32 (ref.py:ssd_final_state), which
// prefill hands to decode.  Per chunk of Q rows, with lam_i =
// sum_{j<=i} A dt_j:
//   y_i = exp(lam_i) C_i . h_start + sum_{j<=i} (C_i.B_j) exp(lam_i - lam_j)
//         dt_j x_j,     h_end = exp(lam_end) h_start + sum_j B_j w_j x_j^T,
//   w_j = exp(lam_end - lam_j) dt_j.
// The exponential of the intra-chunk decay is taken only for j <= i, where
// lam_i - lam_j <= 0: the Pallas kernel's exp(lam_i - lam_j) * mask
// (kernel.py:47) gives inf * 0 = NaN once a chunk's decay passes ~88, the
// reference's where (ref.py:71-73) and these kernels do not.  A ragged last
// chunk is masked (rows past L load as zeros and dt = 0 leaves the state
// unchanged), so L needs no padding.  The closed form is the same function
// for any cut of L into chunks (only the order of the float32 sums
// changes): the CUDA-core route runs a requested chunk above 64 as chunks
// of 64, and the tensor-core walk runs every chunk as chunks of 64 (its
// wgmma tiles are 64 rows; a shorter chunk would leave rows of each tile
// to the next chunk).
//
// Bound on the H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense tensor cores):
// at Zamba2's heads (H = 80, P = N = 64, G = 1) and L = 2,048, bf16, x, y,
// B, C and dt are 43.1 MB (12.9 us) and the four 64-deep products of each
// (chunk, head), counted over the causal pairs only, 4.0 GFLOP (4.1 us on
// tensor cores), so bytes bound it.
//
// ssd_wgmma_kernel (bf16, N <= 256): one CTA per (batch, head, tile of PT
// of the P columns; the scan is separable over P) walks the chunks in order
// -- a loop replaces the TPU's sequential grid axis -- and keeps the
// running state h (N x PT float32) in the registers of one consumer
// warpgroup as the accumulator of the state update.  No chunk state goes
// to device memory: x, B, C and dt are read once, y and h_L written once.
//   * One producer warp.  Lane 0 brings the chunk's C and B (64 rows x 64
//     state columns a box, 128-byte swizzle) and x (64 rows x PT columns,
//     128- or 64-byte swizzle) by TMA into a ring of up to 4 stages.  Lane
//     l owns rows 2l and 2l + 1: their dt (loaded a chunk ahead), the warp
//     scan of A dt for lam (float32, in row order), w = exp(lam_end - lam)
//     dt, and, once x has landed, w x beside it.
//   * Per chunk the consumer warpgroup issues, with wgmma m64nNk16 (bf16
//     in, float32 accumulate): G = C B^T (N deep) and C h (h^T in shared
//     memory, K-major); then S = mask(G) exp(lam_i - lam_j) dt_j in
//     registers (its accumulator layout is the A-fragment layout; exp2 of
//     log2-scaled lam, and no exponential for a warp's column blocks wholly
//     above its rows), y += S x, and h = exp(lam_end) h + B^T (w x), with B
//     read from its TMA tile as a transposed (MN-major) A operand and x and
//     w x as MN-major B operands.  y goes to a shared tile and out by a TMA
//     store (rows past L are not written), so the consumers make no global
//     store inside the walk and their proxy fences wait for shared memory
//     only.
//   * Precision: S, h and w x are not bf16 inputs but float32 values, and
//     one rounding to bf16 left y up to 0.125 from the plain version at
//     Zamba2's shape (a card run), past the 2e-2 tolerance.  Each is split
//     into a bf16 high part and the bf16 remainder, and its product runs
//     twice (hi + lo carries ~16 bits): the tensor cores have room to
//     spare, the chain of dependent steps a chunk is what costs.
//   * Every wgmma is issued on every chunk, on no branch: ptxas serializes
//     all of a kernel's wgmma (a wait after each) when one sits behind a
//     branch or its accumulators merge across one (C7520), which made the
//     first version 2-3x slower.
//   * P tiles: batch 1 gives 80 (Zamba2-2.7B) or 24 (Mamba2-130M) heads for
//     132 SMs.  A CTA's walk is a chain whose time barely depends on PT, so
//     tiles of 32 (G recomputed per tile) pay only while they fill idle
//     SMs; the wrapper takes 32 when those CTAs fit one an SM (Mamba2),
//     else 64 (Zamba2), and 32 where N > 128 (registers).  Registers hold
//     h as N / 64 accumulators of PT / 2 floats a thread.  Shared memory:
//     136 KB at N = 64, PT = 32 (4 stages); 190 KB at N = 256 (2 stages).
//
// ssd_scan_fwd, the CUDA-core route: float32 with N > 128 (past
// ssd_scan_f32.cu's walk; TF32 or bf16 operands would miss the 5e-5
// tolerance) and bf16 with N > 256.
// Three launches (a "block per chunk" is one per (chunk, tile of 64 of the
// P columns)):
//   1. ssd_chunk_state, one block per (chunk, head, batch): lam and the
//      chunk state sum_j w_j B_j x_j^T (N x P), written to a float32
//      scratch with lam_end;
//   2. ssd_state_carry, one thread per state element (n, p) of a (b, h):
//      h_start[c] = h; h = exp(lam_end[c]) h + state[c], written over the
//      chunk states in place (the only sequential pass: nc steps); the
//      last h is the final state;
//   3. ssd_chunk_out, one block per (chunk, head, batch): y from the
//      intra- and inter-chunk terms, rounded once to y's type.
// Tiles are a 64-row chunk in shared memory as float; 256 threads each own
// a 4 x 4 patch of a 64 x 64 product, read with float4 shared loads,
// summed with fmaf; N is taken in tiles of 128.  It reads x, B and C twice
// plus 2 x 42 MB of float32 chunk states at Zamba2's prefill shape.
// Shared memory: 49,664 bytes (launch 1); 85,504 at N = 64 and 136,704 at
// N >= 128 (launch 3), above the 48 KB default via
// cudaFuncAttributeMaxDynamicSharedMemorySize.
// Domain: any P, N and L; the wrapper passes chunks of at most 64.

#include "hopper.cuh"   // mbarriers, TMA loads, wgmma, descriptors

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
  float* hfin;        // (Bsz, H, N, P) final states, or null
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
  if (a.hfin != nullptr) a.hfin[(long long)(b * a.H + h) * np + e] = hc;
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

// ---------------------------------------------------------------------------
// bf16 tensor-core walk (wgmma + TMA): one launch, states on chip
// ---------------------------------------------------------------------------

constexpr int TC_CONSUMERS = 128;             // one consumer warpgroup
constexpr int TC_THREADS = TC_CONSUMERS + 32; // and one producer warp
constexpr int BOX_BYTES = QT * 128;           // 64 rows x 64 bf16 columns
constexpr unsigned FULL_MASK = 0xffffffffu;

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (2 ulp; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A box of shared memory into the 4-D tensor map (a bulk async store,
// rows and columns outside the tensor are not written), committed as one
// bulk group of the issuing thread.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Wait until at most N of the thread's bulk stores still read shared
// memory (N = 0 at exit: and until all have completed).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

struct TcArgs {
  const float* dt;
  const float* A;
  float* hfin;          // (Bsz, H, N, P) final states, or null
  int L, H, G, P, N, nc, npt;
  long long ds0, ds1, ds2;
};

constexpr int SMEM_MAX = 227 * 1024;

// NB: boxes of 64 state columns (N <= 64 NB); PT: P columns of a CTA.  A
// stage holds a chunk's C and B (K-major boxes of 64 state columns), x and
// (w x) as bf16 high and low parts (64 rows of PT columns, MN-major), and
// lam, dt and w; as many stages as fit, up to 4.  Beside them: h^T high and
// low parts and two y tiles for the TMA stores.
template <int NB, int PT>
struct TcShape {
  static constexpr int X_BYTES = QT * PT * 2;
  static constexpr int C_OFF = 0;
  static constexpr int B_OFF = NB * BOX_BYTES;
  static constexpr int X_OFF = 2 * NB * BOX_BYTES;
  static constexpr int WH_OFF = X_OFF + X_BYTES;
  static constexpr int WL_OFF = WH_OFF + X_BYTES;
  static constexpr int LAM_OFF = WL_OFF + X_BYTES;          // lam, dt, w
  static constexpr int STAGE = LAM_OFF + 1024;
  static constexpr int FIXED = 2 * NB * PT * 128 + 2 * X_BYTES + 128 + 1024;
  static constexpr int STAGES =
      (SMEM_MAX - FIXED) / STAGE >= 4 ? 4 : (SMEM_MAX - FIXED) / STAGE;
  static constexpr int H_OFF = STAGES * STAGE;              // h^T, high part
  static constexpr int HL_OFF = H_OFF + NB * PT * 128;      // and low part
  static constexpr int Y_OFF = HL_OFF + NB * PT * 128;      // two y tiles
  static constexpr int BAR_OFF = Y_OFF + 2 * X_BYTES;
  static constexpr int SMEM = BAR_OFF + 128 + 1024;        // + base slack
  static constexpr int TMA_BYTES = 2 * NB * BOX_BYTES + X_BYTES;
  static_assert(STAGES >= 2 && SMEM <= SMEM_MAX, "shared memory");
};

// (hi, lo) bf16 pairs of v0 and v1: hi = bf16(v), lo = bf16(v - hi), so
// hi + lo carries v to ~2^-16 of its size.
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(__fsub_rn(v0, hf.x), __fsub_rn(v1, hf.y));
}

template <int NB, int PT>
__global__ void __launch_bounds__(TC_THREADS, 1)
ssd_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tc,
                 const __grid_constant__ CUtensorMap ty, const TcArgs a) {
  using S = TcShape<NB, PT>;
  constexpr int NS = S::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base_ptr = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(base_ptr);
  // tma[s] = bar + 8 s: the stage's TMA bytes; ready[s] = bar + 8 (NS + s):
  // the producer lanes' lam, dt, w and w x; empty[s] = bar + 8 (2 NS + s):
  // the consumer warps are done with the stage.
  const uint32_t bar = base + S::BAR_OFF;
  const int pt = blockIdx.x % a.npt, h = (blockIdx.x / a.npt) % a.H;
  const int b = blockIdx.x / (a.npt * a.H);
  const int g = h / (a.H / a.G);
  const int p0 = pt * PT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar + 8 * s, 1);            // the TMA thread's, with bytes
      mbar_init(bar + 8 * (NS + s), 32);    // one arrival per producer lane
      mbar_init(bar + 8 * (2 * NS + s), 4); // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // Producer.  Lane 0 brings the chunk's C, B (64 rows x 64 state
    // columns a box) and x (64 rows x PT columns) by TMA; rows past L and
    // columns past N or P fill with zeros.  Lane l owns rows 2l and 2l + 1:
    // their dt (loaded a chunk ahead), the running sum lam of A dt (a warp
    // scan, in row order) and w = exp(lam_end - lam) dt.  Once x has
    // landed, the lanes write w x in high and low bf16 parts beside it.
    const float* db = a.dt + b * a.ds0 + h * a.ds2;
    const float Ah = a.A[h];
    float dr[2];
    auto load_dt = [&](int c) {
      const int t0 = c * QT, rows = min(QT, a.L - t0);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = 2 * lane + r;
        dr[r] = j < rows ? db[(long long)(t0 + j) * a.ds1] : 0.f;
      }
    };
    load_dt(0);
    for (int c = 0; c < a.nc; ++c) {
      const int s = c % NS, round = c / NS;
      if (round > 0) mbar_wait(bar + 8 * (2 * NS + s), (round - 1) & 1);
      const uint32_t stage = base + s * S::STAGE;
      if (lane == 0) {
        const uint32_t full = bar + 8 * s;
        mbar_expect_tx(full, S::TMA_BYTES);
        for (int kc = 0; kc < NB; ++kc) {
          tma_load(stage + S::C_OFF + kc * BOX_BYTES, &tc, full, kc * 64,
                   c * QT, g, b);
          tma_load(stage + S::B_OFF + kc * BOX_BYTES, &tb, full, kc * 64,
                   c * QT, g, b);
        }
        tma_load(stage + S::X_OFF, &tx, full, p0, h, c * QT, b);
      }
      const float d0 = dr[0], d1 = dr[1];
      if (c + 1 < a.nc) load_dt(c + 1);
      const float a0 = __fmul_rn(Ah, d0), a1 = __fmul_rn(Ah, d1);
      float incl = __fadd_rn(a0, a1);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(FULL_MASK, incl, o);
        if (lane >= o) incl = __fadd_rn(v, incl);
      }
      float excl = __shfl_up_sync(FULL_MASK, incl, 1);
      if (lane == 0) excl = 0.f;
      const float lam0 = __fadd_rn(excl, a0), lam1 = __fadd_rn(lam0, a1);
      const float lam_end = __shfl_sync(FULL_MASK, lam1, 31);
      float2* ld = reinterpret_cast<float2*>(base_ptr + s * S::STAGE +
                                             S::LAM_OFF);
      ld[lane] = make_float2(__fmul_rn(lam0, LOG2E),       // lam log2(e)
                             __fmul_rn(lam1, LOG2E));
      ld[QT / 2 + lane] = make_float2(d0, d1);             // dt
      ld[QT + lane] = make_float2(                         // w
          __fmul_rn(__expf(__fsub_rn(lam_end, lam0)), d0),
          __fmul_rn(__expf(__fsub_rn(lam_end, lam1)), d1));
      __syncwarp();
      // w x in x's own swizzled layout (a 16-byte chunk is 8 columns of
      // one row j).
      uint8_t* sp = base_ptr + s * S::STAGE;
      const float* wS = reinterpret_cast<const float*>(sp + S::LAM_OFF) + 2 * QT;
      mbar_wait(bar + 8 * s, round & 1);
#pragma unroll 4
      for (int q = lane; q < S::X_BYTES / 16; q += 32) {
        const float wj = wS[(16 * q) / (PT * 2)];
        const uint4 u = *reinterpret_cast<const uint4*>(sp + S::X_OFF + 16 * q);
        const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&u);
        uint4 hi, lo;
        uint32_t* hp = reinterpret_cast<uint32_t*>(&hi);
        uint32_t* lp = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(v[e]);
          split_bf16(__fmul_rn(f.x, wj), __fmul_rn(f.y, wj), hp[e], lp[e]);
        }
        *reinterpret_cast<uint4*>(sp + S::WH_OFF + 16 * q) = hi;
        *reinterpret_cast<uint4*>(sp + S::WL_OFF + 16 * q) = lo;
      }
      fence_async_smem();
      mbar_arrive(bar + 8 * (NS + s));
    }
    return;
  }

  // Consumers: thread (warp w, lane) holds rows 16 w + gq and 16 w + gq + 8
  // of each 64-row accumulator, columns 8 n + 2 q4 + {0, 1}.  They make no
  // generic global store inside the walk (y leaves by TMA), so the proxy
  // fences below wait for shared-memory writes only.
  const int gq = lane >> 2, q4 = lane & 3;
  const int r0 = 16 * warp + gq, r1 = r0 + 8;
  const uint32_t sH = base + S::H_OFF, sHL = base + S::HL_OFF;

  float hacc[NB][PT / 2];
#pragma unroll
  for (int m = 0; m < NB; ++m)
#pragma unroll
    for (int i = 0; i < PT / 2; ++i) hacc[m][i] = 0.f;
  // h^T starts at 0, so the first chunk's C h is 0: every wgmma of the walk
  // is issued on every chunk, on no divergent path (ptxas serializes wgmma
  // behind a branch or a merge of its accumulators).
  for (int q = tid; q < NB * PT * 128 * 2 / 16; q += TC_CONSUMERS)
    reinterpret_cast<uint4*>(base_ptr + S::H_OFF)[q] = make_uint4(0, 0, 0, 0);
  fence_async_smem();
  named_sync<1, TC_CONSUMERS>();

  for (int c = 0; c < a.nc; ++c) {
    const int s = c % NS;
    const uint32_t stage = base + s * S::STAGE;
    uint8_t* sp = base_ptr + s * S::STAGE;
    const float* lamS = reinterpret_cast<const float*>(sp + S::LAM_OFF);  // log2
    const float* dtS = lamS + QT;
    mbar_wait(bar + 8 * s, (c / NS) & 1);             // the TMA bytes
    mbar_wait(bar + 8 * (NS + s), (c / NS) & 1);      // lam, dt, w, w x

    // G = C B^T over the state columns, and C h (the state at the chunk's
    // start, high and low bf16 parts in shared memory).
    float gacc[32];
    float yacc[PT / 2];
    fence_regs(gacc);
    fence_regs(yacc);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < NB; ++kc)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64(gacc, kmajor(stage + S::C_OFF + kc * BOX_BYTES, kk),
                     kmajor(stage + S::B_OFF + kc * BOX_BYTES, kk),
                     (kc | kk) ? 1 : 0);
#pragma unroll
    for (int kc = 0; kc < NB; ++kc)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dc = kmajor(stage + S::C_OFF + kc * BOX_BYTES, kk);
        wgmma_ss<PT>(yacc, dc, kmajor(sH + kc * PT * 128, kk),
                     (kc | kk) ? 1 : 0);
        wgmma_ss<PT>(yacc, dc, kmajor(sHL + kc * PT * 128, kk), 1);
      }
    wg_commit();
    wg_wait0();
    fence_regs(gacc);
    fence_regs(yacc);

    // y = exp(lam_i) (C h)_i + (S x)_i with S_ij = G_ij exp(lam_i - lam_j)
    // dt_j for j <= i (the exponent <= 0 where it is taken) and 0 above;
    // S in high and low bf16 parts.  Warp w's rows end at 16 w + 15, so its
    // column blocks past 2 w + 1 are 0 without an exponential.
    const float lr0 = lamS[r0], lr1 = lamS[r1];
    const float er0 = ex2(lr0), er1 = ex2(lr1);
#pragma unroll
    for (int n = 0; n < PT / 8; ++n) {
      yacc[4 * n + 0] *= er0;
      yacc[4 * n + 1] *= er0;
      yacc[4 * n + 2] *= er1;
      yacc[4 * n + 3] *= er1;
    }
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float sv[4] = {0.f, 0.f, 0.f, 0.f};
      if (n <= 2 * warp + 1) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int col = 8 * n + 2 * q4 + jj;
          const float lc = lamS[col], dc = dtS[col];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float e = ex2((i ? r1 : r0) >= col
                                    ? __fsub_rn(i ? lr1 : lr0, lc)
                                    : -INFINITY);
            sv[2 * i + jj] =
                __fmul_rn(__fmul_rn(gacc[4 * n + 2 * i + jj], e), dc);
          }
        }
      }
      // accumulator n (columns 8n..8n+7) is half of the A fragment of
      // k-step n / 2: registers 0 and 1 for even n, 2 and 3 for odd n.
      split_bf16(sv[0], sv[1], ph[n >> 1][2 * (n & 1)], pl[n >> 1][2 * (n & 1)]);
      split_bf16(sv[2], sv[3], ph[n >> 1][2 * (n & 1) + 1],
                 pl[n >> 1][2 * (n & 1) + 1]);
    }

    // h <- exp(lam_end) h + B^T (w x): B read from its TMA tile as a
    // transposed (MN-major) A operand.
    const float eend = ex2(lamS[QT - 1]);
#pragma unroll
    for (int m = 0; m < NB; ++m)
#pragma unroll
      for (int i = 0; i < PT / 2; ++i) hacc[m][i] *= eend;
    fence_regs(yacc);
#pragma unroll
    for (int m = 0; m < NB; ++m) fence_regs(hacc[m]);
    wg_fence();
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      const uint64_t dx = mn_desc<PT>(stage + S::X_OFF, kb);
      wgmma_rs<PT>(yacc, ph[kb], dx);
      wgmma_rs<PT>(yacc, pl[kb], dx);
    }
#pragma unroll
    for (int m = 0; m < NB; ++m)
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        const uint64_t da = sw128_desc(
            stage + S::B_OFF + m * BOX_BYTES + kb * 2048, BOX_BYTES, 1024);
        wgmma_ss_mn<PT>(hacc[m], da, mn_desc<PT>(stage + S::WH_OFF, kb),
                        1);
        wgmma_ss_mn<PT>(hacc[m], da, mn_desc<PT>(stage + S::WL_OFF, kb),
                        1);
      }
    wg_commit();
    wg_wait0();
    fence_regs(yacc);
#pragma unroll
    for (int m = 0; m < NB; ++m) fence_regs(hacc[m]);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar + 8 * (2 * NS + s));   // the stage is read

    // The chunk's y (64 rows x PT columns, bf16) into a y tile, and h^T for
    // the next chunk's C h, high and low parts: row p, the state index n
    // contiguous (K-major), a box per 64 states.
    uint8_t* yt = base_ptr + S::Y_OFF + (c & 1) * S::X_BYTES;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < PT / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(
            yt + (i ? r1 : r0) * (PT * 2) + (8 * n + 2 * q4) * 2) =
            __floats2bfloat162_rn(yacc[4 * n + 2 * i], yacc[4 * n + 2 * i + 1]);
#pragma unroll
    for (int m = 0; m < NB; ++m)
#pragma unroll
      for (int n = 0; n < PT / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int p = 8 * n + 2 * q4 + jj;
            const float v = hacc[m][4 * n + 2 * i + jj];
            const __nv_bfloat16 hi = __float2bfloat16_rn(v);
            const uint32_t off = m * PT * 128 + swz(p, i ? r1 : r0);
            *reinterpret_cast<__nv_bfloat16*>(base_ptr + S::H_OFF + off) = hi;
            *reinterpret_cast<__nv_bfloat16*>(base_ptr + S::HL_OFF + off) =
                __float2bfloat16_rn(__fsub_rn(v, __bfloat162float(hi)));
          }
    fence_async_smem();
    named_sync<1, TC_CONSUMERS>();
    if (tid == 0) {
      // Rows past L and columns past P are not written.  The other y
      // tile's store (the chunk before) must have read its tile before
      // the next chunk writes it.
      tma_store(&ty, base + S::Y_OFF + (c & 1) * S::X_BYTES, p0, h, c * QT,
                b);
      bulk_wait_read<1>();
    }
  }
  if (tid == 0) bulk_wait_all();

  // The final state h (N x the CTA's P columns), float32.
  if (a.hfin != nullptr) {
    float* hb = a.hfin + ((long long)b * a.H + h) * a.N * a.P + p0;
#pragma unroll
    for (int m = 0; m < NB; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = 64 * m + (i ? r1 : r0);
        if (n >= a.N) continue;
#pragma unroll
        for (int k = 0; k < PT / 8; ++k)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int p = 8 * k + 2 * q4 + jj;
            if (p0 + p < a.P)
              hb[(long long)n * a.P + p] = hacc[m][4 * k + 2 * i + jj];
          }
      }
  }
}

// The tensor map of a 4-D bf16 operand: sizes dims (innermost first, that
// axis contiguous), element strides of the other three, a box of box0 x
// box1 x box2 x 1.  The stride of an axis of size 1 is never used; it is
// set to a valid one.
bool encode(CUtensorMap* map, const void* ptr, const int (&dims)[4],
            const long long (&st)[3], const int (&box)[3],
            CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return false;
  cuuint64_t bytes[3];
  cuuint64_t prev = ((cuuint64_t)dims[0] * 2 + 15) / 16 * 16;
  for (int i = 0; i < 3; ++i) {
    bytes[i] = dims[i + 1] == 1 ? prev : (cuuint64_t)st[i] * 2;
    prev = bytes[i] * dims[i + 1];
  }
  const cuuint64_t d[4] = {(cuuint64_t)dims[0], (cuuint64_t)dims[1],
                           (cuuint64_t)dims[2], (cuuint64_t)dims[3]};
  const cuuint32_t bx[4] = {(cuuint32_t)box[0], (cuuint32_t)box[1],
                            (cuuint32_t)box[2], 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            d, bytes, bx, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NB, int PT>
int launch_wgmma(const CUtensorMap& tx, const CUtensorMap& tb,
                 const CUtensorMap& tc, const CUtensorMap& ty, TcArgs a,
                 int Bsz, cudaStream_t stream) {
  using S = TcShape<NB, PT>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_wgmma_kernel<NB, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        S::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  a.npt = (a.P + PT - 1) / PT;
  const long long blocks = (long long)Bsz * a.H * a.npt;
  ssd_wgmma_kernel<NB, PT><<<(unsigned)blocks, TC_THREADS, S::SMEM, stream>>>(
      tx, tb, tc, ty, a);
  return (int)cudaGetLastError();
}

}  // namespace

// ssd_scan_fwd: the CUDA-core route.  dtype: 0 = float32, 1 = bfloat16 (x,
// B, C and y); dt and A are float32; chunk <= 64 (the wrapper cuts a longer
// one into chunks of 64).  strides: 12 element strides, (batch, position,
// head) of x and dt and (batch, position, group) of B and C; the last axis
// of x, B and C is contiguous.  scratch_states: Bsz * H * nc * N * P
// floats; scratch_lam: Bsz * H * nc floats, nc = ceil(L / chunk);
// final_state: Bsz * H * N * P floats, or null.  Returns cudaGetLastError()
// after the launches (0 on success); the checks of shapes, types and
// strides are the Python wrapper's.
extern "C" int ssd_scan_fwd(int dtype, const void* x, const float* dt,
                            const float* A, const void* Bm, const void* C,
                            void* y, float* scratch_states,
                            float* scratch_lam, float* final_state, int Bsz,
                            int L, int H, int G, int P, int N, int chunk,
                            const long long* strides, void* stream) {
  if (Bsz <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      N <= 0 || chunk <= 0 || chunk > QT)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x; a.dt = dt; a.A = A; a.Bm = Bm; a.C = C; a.y = y;
  a.cs = scratch_states; a.le = scratch_lam; a.hfin = final_state;
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

// ssd_scan_wgmma_fwd: the bf16 tensor-core walk, one launch.  x, B, C and
// y bf16, dt and A float32, N <= 256, chunks of 64; strides as above.  x, B
// and C: 16-byte aligned, their strides of an axis longer than 1 multiples
// of 8 elements (TMA reads them); y: contiguous (B, L, H, Py), Py >= P a
// multiple of 8, its first P columns written.  ptile: P columns of a CTA,
// 32 or 64 (64 needs N <= 128).  final_state: Bsz * H * N * P floats, or
// null.
extern "C" int ssd_scan_wgmma_fwd(const void* x, const float* dt,
                                  const float* A, const void* Bm,
                                  const void* C, void* y, int Py,
                                  float* final_state, int Bsz, int L, int H,
                                  int G, int P, int N, int ptile,
                                  const long long* strides, void* stream) {
  if (Bsz <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      N <= 0 || N > 256 || Py < P || Py % 8 ||
      (ptile != 32 && ptile != 64) || (ptile == 64 && N > 128))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tb, tc, ty;
  const int xdims[4] = {P, H, L, Bsz}, bdims[4] = {N, L, G, Bsz};
  const long long xst[3] = {strides[2], strides[1], strides[0]};
  const long long bst[3] = {strides[7], strides[8], strides[6]};
  const long long cst[3] = {strides[10], strides[11], strides[9]};
  const long long yst[3] = {Py, (long long)H * Py, (long long)L * H * Py};
  const int xbox[3] = {ptile, 1, QT}, bbox[3] = {64, QT, 1};
  const CUtensorMapSwizzle xsw =
      ptile == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  if (!encode(&tx, x, xdims, xst, xbox, xsw) ||
      !encode(&tb, Bm, bdims, bst, bbox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&tc, C, bdims, cst, bbox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&ty, y, xdims, yst, xbox, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  TcArgs a;
  a.dt = dt; a.A = A;
  a.hfin = final_state;
  a.L = L; a.H = H; a.G = G; a.P = P; a.N = N;
  a.nc = (L + QT - 1) / QT;
  a.npt = 1;
  a.ds0 = strides[3]; a.ds1 = strides[4]; a.ds2 = strides[5];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (N + 63) / 64;
#define SSD_WGMMA(NB_, PT_) \
  if (nb == NB_ && ptile == PT_) \
    return launch_wgmma<NB_, PT_>(tx, tb, tc, ty, a, Bsz, s);
  SSD_WGMMA(1, 32) SSD_WGMMA(1, 64) SSD_WGMMA(2, 32) SSD_WGMMA(2, 64)
  SSD_WGMMA(3, 32) SSD_WGMMA(4, 32)
#undef SSD_WGMMA
  return (int)cudaErrorInvalidValue;
}
