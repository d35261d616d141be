// Mamba2 SSD chunked scan (forward) in float32 for the H100 (sm_90a), on
// the bf16 tensor cores at float32 accuracy: the float32 route of
// repro_torch/kernels/ssd_scan/kernel.py:route (float32 with N <= 128;
// float16 and mixed dtypes are read in float32).  It computes what
// ssd_scan.cu's kernels compute (repro_torch/kernels/ssd_scan/ref.py:
// ssd_chunked and ssd_final_state: the same closed form, the exponential of
// the intra-chunk decay taken only where lam_i - lam_j <= 0, a ragged last
// chunk masked, any requested chunk run as chunks of 64), and with them
// replaces the Pallas TPU kernel repro/kernels/ssd_scan/kernel.py:ssd_scan
// (def at :66, pallas_call at :83, body _ssd_kernel at :26-63).  A library
// of its own, so that nvcc builds it beside ssd_scan.cu.
//
// Bound on the H100 SXM at Zamba2-2.7B's prefill, (B, L, H, P, G, N) =
// (1, 2048, 80, 64, 1, 64), y and the final state: 86.8 MB of float32
// inputs and outputs, 0.0259 ms at 3.35 TB/s; the four products of each
// (chunk, head) over the causal pairs, 3.9 GFLOP, 0.024 ms at the
// float32-accurate tensor-core rate (six bf16 products for one float32
// product: 989 / 6 = 165 TFLOP/s).  Bytes bound it, barely.
//
// ssd_wgmma_f32_kernel: the dataflow of ssd_scan.cu's bf16 walk, one launch
// and the state on chip, x, B, C and dt read once.  TF32 (10 bits of
// mantissa) would miss the 5e-5 tolerance; instead every float32 operand
// is split into three bf16 parts (hopper.cuh: split3_pair), x = hi + mid +
// lo, and each product is the six partial products hi hi, hi mid, mid hi,
// hi lo, mid mid, lo hi (split_a, split_b: small first; the dropped three
// are below 2^-24 relative), each exact in the float32 accumulator, as
// flash_attn_f32.cu takes attention's.  One CTA per (batch, head, tile of
// PT of the P columns) walks the chunks of 64 rows in order:
//   * A producer warpgroup (128 threads) loads a chunk's float32 B and C
//     (64 rows x N) and x (64 rows x PT) with 16-byte loads into registers,
//     all issued before it waits for a free buffer, splits each value into
//     three bf16 planes and stores them swizzled in the layouts the wgmma
//     descriptors read: B and C K-major in 64-column boxes with the
//     128-byte swizzle (kmajor), x MN-major with the 64- or 128-byte
//     swizzle (mn_desc).  Each of its warps scans A dt for lam itself (a
//     warp scan in row order, lane l owning rows 2l and 2l + 1) and takes
//     w = exp(lam_end - lam) dt, and the warpgroup splits w x (one float32
//     rounding of the product) into three planes beside x's; warp 0 leaves
//     lam and dt to the consumers.
//   * One consumer warpgroup issues, per chunk, each product as its six
//     partial products, with wgmma m64nNk16 (bf16 in, float32 accumulate):
//     G = C B^T (N deep) and C h (h^T's planes in shared memory), one
//     commit; then S = mask(G) exp(lam_i - lam_j) dt_j in registers (G's
//     accumulator layout is the A-fragment layout; split into three register
//     planes), S x (x's planes MN-major) and B^T (w x) (B read from its
//     planes as a transposed A operand), one commit.  Then
//     y = exp(lam_i) (C h) + S x and h = exp(lam_end) h + B^T (w x).
//   * Fresh accumulators: the tensor cores' float32 accumulation drops low
//     bits (on the card, attention drafts that summed every tile in one
//     accumulator drifted from float64), so each chunk's C h, S x and
//     B^T (w x) go into accumulators zeroed for the chunk, and are added to
//     y and to h in float32 registers: the state, carried through 32 chunks
//     at L = 2,048, is never an accumulator of the tensor cores.  h is then
//     split into h^T's three planes for the next chunk's C h.
//   * The exponentials are expf of natural-unit differences (lam_i - lam_j,
//     lam_end - lam_j, lam_i, lam_end: the reference's own arguments), not
//     ex2.approx of log2-scaled lam as in the bf16 walk: a rounding of each
//     lam x log2(e) would put ~|lam| 2^-24 into every decay.
//   * Every wgmma is issued on every chunk, on no branch (ptxas serializes
//     all of a kernel's wgmma when one sits behind a branch, C7520); the
//     first chunk's C h reads h^T = 0.
//   * Work a chunk at N = 64, PT = 32: 96 wgmma (24 a product), against the
//     bf16 walk's 28.
// Buffers and barriers (F32Shape): two stages of B, x and w x planes with
// lam and dt (R stages, freed once S x and B^T (w x) are read), C's planes
// apart (C stages, freed as soon as G and C h are read), and h^T's planes.
// Shared memory: at N = 64, PT = 32, 2 x 49 KB R + 2 x 24 KB C + 12 KB
// h^T = 159 KB; at N = 64, PT = 64, 2 x 73 + 2 x 24 + 24 = 219 KB; at
// N = 128, PT = 32, two C stages do not fit: 2 x 73 + 48 + 24 = 219 KB,
// and the producer refills the one C buffer while the consumers run S, S x
// and B^T (w x) of the chunk before.  Registers (one consumer thread):
// h N / 64 x PT / 2 floats, G 32, S's three planes 48, C h, S x and
// B^T (w x) PT / 2 each (x N / 64): PT = 64 only with N = 64.
// Built with multiply-add contraction (kernels/_build.py:CONTRACTED): the
// route is held to a tolerance, not bitwise, and a contracted y = e yc + ys
// or h = e h + hu rounds once, nearer float64; the roundings that define
// the split (the differences in split3_pair) and w x are explicit
// (__fsub_rn, __fmul_rn).
//
// The kernel takes element strides for (batch, position, head) of x and dt
// and (batch, position, group) of B and C (the last axis contiguous; x, B
// and C 16-byte aligned with strides of multiples of 4 elements along every
// axis longer than 1, which the wrapper ensures), and writes y contiguous
// (B, L, H, P) float32.

#include <math.h>

#include "hopper.cuh"   // mbarriers, wgmma, descriptors, the three-way split

namespace {

constexpr int FQ = 64;                  // rows of a chunk
constexpr int F_THREADS = 256;          // a consumer warpgroup, a producer one
constexpr int F_BOX = FQ * 128;         // a 64-row box of 64 bf16 columns
constexpr int F_SMEM_MAX = 232448;      // a CTA's shared memory
constexpr unsigned F_FULL = 0xffffffffu;

struct F32Args {
  const float* x;
  const float* dt;
  const float* A;
  const float* Bm;
  const float* C;
  float* y;             // (Bsz, L, H, P) float32
  float* hfin;          // (Bsz, H, N, P) final states, or null
  int L, H, G, P, N, nc, npt, pair;     // pair: float2 stores of y
  long long xs0, xs1, xs2, ds0, ds1, ds2, bs0, bs1, bs2, cs0, cs1, cs2;
};

// NB: 64-column boxes of the state (N <= 64 NB); PT: P columns of a CTA.
// An R stage holds the three planes of B (K-major boxes), of x and of w x
// (MN-major), and lam and dt (floats); a C stage C's three planes.
template <int NB, int PT>
struct F32Shape {
  static constexpr int CB_PLANE = NB * F_BOX;       // one plane of C or B
  static constexpr int X_PLANE = FQ * PT * 2;       // one plane of x or w x
  static constexpr int HT_PLANE = NB * PT * 128;    // one plane of h^T
  static constexpr int R_B = 0;
  static constexpr int R_X = 3 * CB_PLANE;
  static constexpr int R_W = R_X + 3 * X_PLANE;
  static constexpr int R_LAM = R_W + 3 * X_PLANE;   // lam[64], dt[64]
  static constexpr int R_STAGE = R_LAM + 1024;
  static constexpr int C_STAGE = 3 * CB_PLANE;
  static constexpr int RS = 2;
  static constexpr int FIXED = RS * R_STAGE + 3 * HT_PLANE + 64 + 1024;
  static constexpr int CS = FIXED + 2 * C_STAGE <= F_SMEM_MAX ? 2 : 1;
  static constexpr int C_OFF = RS * R_STAGE;
  static constexpr int H_OFF = C_OFF + CS * C_STAGE;
  static constexpr int BAR_OFF = H_OFF + 3 * HT_PLANE;
  static constexpr int SMEM = BAR_OFF + 64 + 1024;  // + barriers, alignment
  static_assert(SMEM <= F_SMEM_MAX, "a CTA's shared memory");
};

// Rows [r0, r0 + 64) and columns [0, COLS) of a float32 matrix (row stride
// rs elements, rows 16-byte aligned) into registers: thread t of the
// producer's 128 holds the 8-float chunks t, t + 128, ...; rows past
// n_rows and columns past n_cols read as zeros.  (hopper.cuh's split_tile
// loads and stores in turns; the walk issues all of a chunk's loads before
// it waits for a free buffer, then stores: load_rows, store_kmajor.)
template <int COLS>
__device__ __forceinline__ void load_rows(float (&v)[FQ * COLS / 1024][8],
                                          const float* __restrict__ src,
                                          long long rs, int r0, int n_rows,
                                          int n_cols, int t) {
  constexpr int PER_ROW = COLS / 8;
#pragma unroll
  for (int u = 0; u < FQ * COLS / 1024; ++u) {
    const int idx = t + 128 * u;
    const int r = idx / PER_ROW, c0 = (idx % PER_ROW) * 8;
    const float* p = src + (long long)(r0 + r) * rs + c0;
    if (r0 + r < n_rows && c0 + 8 <= n_cols) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p));
      const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
      v[u][0] = a.x; v[u][1] = a.y; v[u][2] = a.z; v[u][3] = a.w;
      v[u][4] = b.x; v[u][5] = b.y; v[u][6] = b.z; v[u][7] = b.w;
    } else {
      const bool row_ok = r0 + r < n_rows;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[u][e] = row_ok && c0 + e < n_cols ? p[e] : 0.f;
    }
  }
}

// The three bf16 planes (plane bytes apart) of 8 float32 values into one
// 16-byte chunk of each.
__device__ __forceinline__ void store_split(uint8_t* d, int plane,
                                            const float (&v)[8]) {
  uint4 h, m, l;
  split3_pair(v[0], v[1], h.x, m.x, l.x);
  split3_pair(v[2], v[3], h.y, m.y, l.y);
  split3_pair(v[4], v[5], h.z, m.z, l.z);
  split3_pair(v[6], v[7], h.w, m.w, l.w);
  *reinterpret_cast<uint4*>(d) = h;
  *reinterpret_cast<uint4*>(d + plane) = m;
  *reinterpret_cast<uint4*>(d + 2 * plane) = l;
}

// load_rows' registers as three K-major planes (64-column boxes, the
// 128-byte swizzle: box c at c 64 128 bytes, the 16-byte chunk j of row r
// at r 128 + 16 (j ^ (r % 8))).
template <int COLS>
__device__ __forceinline__ void store_kmajor(uint8_t* dst, int plane,
                                             const float (&v)[FQ * COLS / 1024][8],
                                             int t) {
  constexpr int PER_ROW = COLS / 8;
#pragma unroll
  for (int u = 0; u < FQ * COLS / 1024; ++u) {
    const int idx = t + 128 * u;
    const int r = idx / PER_ROW, ch = idx % PER_ROW;
    store_split(dst + (ch >> 3) * F_BOX + r * 128 + (((ch & 7) ^ (r & 7)) << 4),
                plane, v[u]);
  }
}

// O = the SSD scan of one (batch, head, P tile) in float32 on the bf16
// tensor cores (see the header).  Threads 0-127: the consumer warpgroup;
// 128-255: the producer warpgroup.
template <int NB, int PT>
__global__ void __launch_bounds__(F_THREADS, 1)
ssd_wgmma_f32_kernel(const F32Args a) {
  using S = F32Shape<NB, PT>;
  constexpr int RS = S::RS, CS = S::CS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base_ptr =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(base_ptr);
  // full_r(s) = bar + 8 s: the producer's B, x, w x, lam and dt of R stage
  // s; empty_r(s) = bar + 16 + 8 s: the consumers are done with it;
  // full_c(s) = bar + 32 + 8 s, empty_c(s) = bar + 48 + 8 s: C stage s.
  const uint32_t bar = base + S::BAR_OFF;
  const int pt = blockIdx.x % a.npt, h = (blockIdx.x / a.npt) % a.H;
  const int b = blockIdx.x / (a.npt * a.H);
  const int g = h / (a.H / a.G);
  const int p0 = pt * PT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar + 8 * s, 128);         // every producer thread
      mbar_init(bar + 16 + 8 * s, 4);      // one arrival a consumer warp
      mbar_init(bar + 32 + 8 * s, 128);
      mbar_init(bar + 48 + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    // Producer.  All loads of a chunk are issued before its waits.
    const int t = tid - 128;
    const float* xb = a.x + b * a.xs0 + h * a.xs2 + p0;
    const float* bb = a.Bm + b * a.bs0 + g * a.bs2;
    const float* cb = a.C + b * a.cs0 + g * a.cs2;
    const float* db = a.dt + b * a.ds0 + h * a.ds2;
    const float Ah = a.A[h];
    const int pcols = min(PT, a.P - p0);
    for (int c = 0; c < a.nc; ++c) {
      const int t0 = c * FQ, rows = min(FQ, a.L - t0);
      const int rs = c % RS, cs = c % CS;
      float bv[NB * 4][8], cv[NB * 4][8], xv[PT / 16][8];
      load_rows<NB * 64>(bv, bb, a.bs1, t0, a.L, a.N, t);
      load_rows<PT>(xv, xb, a.xs1, t0, a.L, pcols, t);
      load_rows<NB * 64>(cv, cb, a.cs1, t0, a.L, a.N, t);
      // dt of rows 2 lane and 2 lane + 1 (0 past L), lam = the running sum
      // of A dt in row order (a warp scan), w = exp(lam_end - lam) dt.
      const float d0 = 2 * lane < rows ? db[(long long)(t0 + 2 * lane) * a.ds1]
                                       : 0.f;
      const float d1 = 2 * lane + 1 < rows
                           ? db[(long long)(t0 + 2 * lane + 1) * a.ds1]
                           : 0.f;
      const float a0 = __fmul_rn(Ah, d0), a1 = __fmul_rn(Ah, d1);
      float incl = __fadd_rn(a0, a1);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(F_FULL, incl, o);
        if (lane >= o) incl = __fadd_rn(v, incl);
      }
      float excl = __shfl_up_sync(F_FULL, incl, 1);
      if (lane == 0) excl = 0.f;
      const float lam0 = __fadd_rn(excl, a0), lam1 = __fadd_rn(lam0, a1);
      const float lam_end = __shfl_sync(F_FULL, lam1, 31);
      const float w0 = __fmul_rn(expf(__fsub_rn(lam_end, lam0)), d0);
      const float w1 = __fmul_rn(expf(__fsub_rn(lam_end, lam1)), d1);

      if (c >= RS) mbar_wait(bar + 16 + 8 * rs, ((c / RS) - 1) & 1);
      uint8_t* st = base_ptr + rs * S::R_STAGE;
      if (t < 32) {
        float2* ld = reinterpret_cast<float2*>(st + S::R_LAM);
        ld[lane] = make_float2(lam0, lam1);
        ld[FQ / 2 + lane] = make_float2(d0, d1);
      }
      store_kmajor<NB * 64>(st + S::R_B, S::CB_PLANE, bv, t);
      // x and w x, MN-major: a 16-byte chunk is 8 columns of one row j.
#pragma unroll
      for (int u = 0; u < PT / 16; ++u) {
        const int idx = t + 128 * u;
        const int r = idx / (PT / 8), ch = idx % (PT / 8);
        const float we = __shfl_sync(F_FULL, w0, r >> 1);
        const float wo = __shfl_sync(F_FULL, w1, r >> 1);
        const float wr = (r & 1) ? wo : we;
        float wx[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) wx[e] = __fmul_rn(wr, xv[u][e]);
        const uint32_t off = mn_chunk<PT>(r, ch);
        store_split(st + S::R_X + off, S::X_PLANE, xv[u]);
        store_split(st + S::R_W + off, S::X_PLANE, wx);
      }
      fence_async_smem();
      mbar_arrive(bar + 8 * rs);

      if (c >= CS) mbar_wait(bar + 48 + 8 * cs, ((c / CS) - 1) & 1);
      store_kmajor<NB * 64>(base_ptr + S::C_OFF + cs * S::C_STAGE,
                            S::CB_PLANE, cv, t);
      fence_async_smem();
      mbar_arrive(bar + 32 + 8 * cs);
    }
    return;
  }

  // Consumers: thread (warp w, lane) holds rows 16 w + gq and 16 w + gq + 8
  // of each 64-row accumulator, columns 8 n + 2 q4 + {0, 1}.
  const int gq = lane >> 2, q4 = lane & 3;
  const int r0 = 16 * warp + gq, r1 = r0 + 8;
  const uint32_t sH = base + S::H_OFF;

  float hs[NB][PT / 2];
#pragma unroll
  for (int m = 0; m < NB; ++m)
#pragma unroll
    for (int i = 0; i < PT / 2; ++i) hs[m][i] = 0.f;
  // h^T starts at 0, so the first chunk's C h is 0.
  for (int q = tid; q < 3 * S::HT_PLANE / 16; q += 128)
    reinterpret_cast<uint4*>(base_ptr + S::H_OFF)[q] = make_uint4(0, 0, 0, 0);
  fence_async_smem();
  named_sync<1, 128>();

  for (int c = 0; c < a.nc; ++c) {
    const int rs = c % RS, cs = c % CS;
    const int t0 = c * FQ;
    const uint32_t rst = base + rs * S::R_STAGE;
    const uint32_t cst = base + S::C_OFF + cs * S::C_STAGE;
    const float* lamS =
        reinterpret_cast<const float*>(base_ptr + rs * S::R_STAGE + S::R_LAM);
    const float* dtS = lamS + FQ;
    mbar_wait(bar + 8 * rs, (c / RS) & 1);
    mbar_wait(bar + 32 + 8 * cs, (c / CS) & 1);

    // G = C B^T over the state columns and C h (h^T's planes), each as the
    // six partial products, into accumulators zeroed for the chunk.
    float gacc[32], yc[PT / 2];
    fence_regs(gacc);
    fence_regs(yc);
    wg_fence();
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int kc = 0; kc < NB; ++kc)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n64(gacc,
                       kmajor(cst + split_a(i) * S::CB_PLANE + kc * F_BOX, kk),
                       kmajor(rst + S::R_B + split_b(i) * S::CB_PLANE +
                                  kc * F_BOX, kk),
                       (i | kc | kk) ? 1 : 0);
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int kc = 0; kc < NB; ++kc)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<PT>(yc,
                       kmajor(cst + split_a(i) * S::CB_PLANE + kc * F_BOX, kk),
                       kmajor(sH + split_b(i) * S::HT_PLANE + kc * PT * 128,
                              kk),
                       (i | kc | kk) ? 1 : 0);
    wg_commit();
    wg_wait0();
    fence_regs(gacc);
    fence_regs(yc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar + 48 + 8 * cs);   // C is read

    // S_ij = G_ij exp(lam_i - lam_j) dt_j for j <= i (the exponent <= 0
    // where it is taken), 0 above; warp w's rows end at 16 w + 15, so its
    // column blocks past 2 w + 1 are 0 without an exponential.  S's three
    // register planes: accumulator n (columns 8n..8n+7) is half of the A
    // fragment of k-step n / 2, registers 0 and 1 for even n, 2 and 3 for
    // odd n.
    const float lr0 = lamS[r0], lr1 = lamS[r1], lend = lamS[FQ - 1];
    uint32_t sp[3][4][4];
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
            const float e = (i ? r1 : r0) >= col
                                ? expf(__fsub_rn(i ? lr1 : lr0, lc)) : 0.f;
            sv[2 * i + jj] =
                __fmul_rn(__fmul_rn(gacc[4 * n + 2 * i + jj], e), dc);
          }
        }
      }
      const int k = n >> 1, reg = 2 * (n & 1);
      split3_pair(sv[0], sv[1], sp[0][k][reg], sp[1][k][reg], sp[2][k][reg]);
      split3_pair(sv[2], sv[3], sp[0][k][reg + 1], sp[1][k][reg + 1],
                  sp[2][k][reg + 1]);
    }

    // S x (x's planes MN-major) and B^T (w x) (B's planes as a transposed
    // A operand), each into accumulators zeroed for the chunk.
    float ys[PT / 2], hu[NB][PT / 2];
#pragma unroll
    for (int i = 0; i < PT / 2; ++i) ys[i] = 0.f;
    fence_regs(ys);
#pragma unroll
    for (int m = 0; m < NB; ++m) fence_regs(hu[m]);
    wg_fence();
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
        wgmma_rs<PT>(ys, sp[split_a(i)][kb],
                     mn_desc<PT>(rst + S::R_X + split_b(i) * S::X_PLANE, kb));
#pragma unroll
    for (int m = 0; m < NB; ++m)
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int kb = 0; kb < 4; ++kb)
          wgmma_ss_mn<PT>(
              hu[m],
              sw128_desc(rst + S::R_B + split_a(i) * S::CB_PLANE + m * F_BOX +
                             kb * 2048, F_BOX, 1024),
              mn_desc<PT>(rst + S::R_W + split_b(i) * S::X_PLANE, kb),
              (i | kb) ? 1 : 0);
    wg_commit();
    // While the tensor cores run: the decays of y's rows and of the state.
    const float er0 = expf(lr0), er1 = expf(lr1), eend = expf(lend);
    wg_wait0();
    fence_regs(ys);
#pragma unroll
    for (int m = 0; m < NB; ++m) fence_regs(hu[m]);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar + 16 + 8 * rs);   // the R stage is read

    // y = exp(lam_i) (C h)_i + (S x)_i, rows past L and columns past P not
    // written.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = t0 + (i ? r1 : r0);
      if (r >= a.L) continue;
      const float er = i ? er1 : er0;
      float* yrow = a.y + (((long long)b * a.L + r) * a.H + h) * a.P + p0;
#pragma unroll
      for (int n = 0; n < PT / 8; ++n) {
        const int col = 8 * n + 2 * q4;
        const float v0 = fmaf(er, yc[4 * n + 2 * i], ys[4 * n + 2 * i]);
        const float v1 =
            fmaf(er, yc[4 * n + 2 * i + 1], ys[4 * n + 2 * i + 1]);
        if (a.pair && p0 + col + 1 < a.P) {
          *reinterpret_cast<float2*>(yrow + col) = make_float2(v0, v1);
        } else {
          if (p0 + col < a.P) yrow[col] = v0;
          if (p0 + col + 1 < a.P) yrow[col + 1] = v1;
        }
      }
    }

    // h = exp(lam_end) h + B^T (w x) in float32, then h^T's three planes
    // for the next chunk's C h: row p, the state index n contiguous
    // (K-major), a box per 64 states.
#pragma unroll
    for (int m = 0; m < NB; ++m)
#pragma unroll
      for (int i = 0; i < PT / 2; ++i) hs[m][i] = fmaf(eend, hs[m][i], hu[m][i]);
#pragma unroll
    for (int m = 0; m < NB; ++m)
#pragma unroll
      for (int n = 0; n < PT / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t hi, mid, lo;
          split3_pair(hs[m][4 * n + 2 * i], hs[m][4 * n + 2 * i + 1], hi, mid,
                      lo);
          const int p = 8 * n + 2 * q4;
          const uint32_t off0 = m * PT * 128 + swz(p, i ? r1 : r0);
          const uint32_t off1 = m * PT * 128 + swz(p + 1, i ? r1 : r0);
          uint8_t* hp = base_ptr + S::H_OFF;
          *reinterpret_cast<uint16_t*>(hp + off0) = (uint16_t)hi;
          *reinterpret_cast<uint16_t*>(hp + off1) = (uint16_t)(hi >> 16);
          *reinterpret_cast<uint16_t*>(hp + S::HT_PLANE + off0) = (uint16_t)mid;
          *reinterpret_cast<uint16_t*>(hp + S::HT_PLANE + off1) =
              (uint16_t)(mid >> 16);
          *reinterpret_cast<uint16_t*>(hp + 2 * S::HT_PLANE + off0) =
              (uint16_t)lo;
          *reinterpret_cast<uint16_t*>(hp + 2 * S::HT_PLANE + off1) =
              (uint16_t)(lo >> 16);
        }
    fence_async_smem();
    named_sync<1, 128>();
  }

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
              hb[(long long)n * a.P + p] = hs[m][4 * k + 2 * i + jj];
          }
      }
  }
}

template <int NB, int PT>
int launch_f32(F32Args a, int Bsz, cudaStream_t stream) {
  using S = F32Shape<NB, PT>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_wgmma_f32_kernel<NB, PT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  a.npt = (a.P + PT - 1) / PT;
  const long long blocks = (long long)Bsz * a.H * a.npt;
  ssd_wgmma_f32_kernel<NB, PT>
      <<<(unsigned)blocks, F_THREADS, S::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ssd_scan_wgmma_f32_fwd: the float32 tensor-core walk, one launch.  x
// (Bsz, L, H, P), dt (Bsz, L, H), A (H,), B and C (Bsz, L, G, N), all
// float32, N <= 128, chunks of 64; strides: 12 element strides, (batch,
// position, head) of x and dt and (batch, position, group) of B and C (the
// last axis of x, B and C contiguous; x, B and C 16-byte aligned, their
// strides along every axis longer than 1 multiples of 4).  y: contiguous
// (Bsz, L, H, P) float32.  ptile: P columns of a CTA, 32 or 64 (64 needs
// N <= 64).  final_state: Bsz * H * N * P floats, or null.  Returns
// cudaGetLastError() after the launch (0 on success); the checks of shapes,
// types and strides are the Python wrapper's.
extern "C" int ssd_scan_wgmma_f32_fwd(const float* x, const float* dt,
                                      const float* A, const float* Bm,
                                      const float* C, float* y,
                                      float* final_state, int Bsz, int L,
                                      int H, int G, int P, int N, int ptile,
                                      const long long* strides,
                                      void* stream) {
  if (Bsz <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      N <= 0 || N > 128 || (ptile != 32 && ptile != 64) ||
      (ptile == 64 && N > 64))
    return (int)cudaErrorInvalidValue;
  F32Args a;
  a.x = x; a.dt = dt; a.A = A; a.Bm = Bm; a.C = C; a.y = y;
  a.hfin = final_state;
  a.L = L; a.H = H; a.G = G; a.P = P; a.N = N;
  a.nc = (L + FQ - 1) / FQ;
  a.npt = 1;
  a.pair = P % 2 == 0;
  a.xs0 = strides[0]; a.xs1 = strides[1]; a.xs2 = strides[2];
  a.ds0 = strides[3]; a.ds1 = strides[4]; a.ds2 = strides[5];
  a.bs0 = strides[6]; a.bs1 = strides[7]; a.bs2 = strides[8];
  a.cs0 = strides[9]; a.cs1 = strides[10]; a.cs2 = strides[11];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (N + 63) / 64;
  if (nb == 1 && ptile == 32) return launch_f32<1, 32>(a, Bsz, s);
  if (nb == 1 && ptile == 64) return launch_f32<1, 64>(a, Bsz, s);
  if (nb == 2 && ptile == 32) return launch_f32<2, 32>(a, Bsz, s);
  return (int)cudaErrorInvalidValue;
}
