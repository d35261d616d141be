// Mamba2 SSD chunked scan, backward, bf16, on the H100's tensor cores
// (sm_90a): wgmma + TMA.  The route "wgmma" of kernels/ssd_scan/kernel.py:
// route_bwd (bf16 x, B, C and dy, N <= 128, P <= 256); float32 and wider
// states keep the CUDA-core route of ssd_scan_bwd.cu.
//
// Replaces no Pallas kernel: the JAX package differentiates its chunked
// closed form (repro/kernels/ssd_scan/ref.py:ssd_chunked) with XLA and has
// no backward of the Pallas kernel repro/kernels/ssd_scan/kernel.py:ssd_scan
// (def at :66, pallas_call at :83).  Its plain version is
// repro_torch/kernels/ssd_scan/ref.py:ssd_vjp.  The equations are those of
// ssd_scan_bwd.cu's header: per (batch, head) and chunk, lam_i = sum_{k<=i}
// A dt_k, Lend = lam at the last row, e_ij = e^{lam_i - lam_j} (j <= i),
// w_j = e^{Lend - lam_j} dt_j, el_i = e^{lam_i}, h0 the chunk's start
// state and dh1 the gradient at its end state (N x P):
//   G = C B^T, dS = dy x^T, S = G e dt_j, dG = dS e dt_j, T = dS G e,
//   R = T dt_j;
//   dx = S^T dy + diag(w) B dh1,      z_j = x_j . (B dh1)_j
//   dC = dG B + diag(el) dy h0^T,     cq_i = dy_i . (C h0)_i
//   dB = dG^T C + diag(w) x dh1^T
//   dlam_i = sum_j R_ij - sum_k R_ki + el_i cq_i - z_i w_i
//            (+ sum_j z_j w_j + e^{Lend} <h0, dh1> at the chunk's last row)
//   ddt_j = sum_i T_ij + z_j e^{Lend - lam_j} + A sum_{i>=j} dlam_i,
//   dA += sum_k dt_k sum_{i>=k} dlam_i;
// the chunk states s = B^T (w x) and dh terms u = C^T (el dy) feed the
// carry of h0 forward and of dh1 backward.  Every chunk runs as a chunk of
// 64 rows (the function does not depend on the cut; only the order of the
// float32 sums does), a ragged last chunk masked (TMA fills rows past L
// with zeros and dt = 0 there).  The exponential is taken only where its
// argument is <= 0, so the gradient is finite at any decay.
//
// Four launches, the dataflow of ssd_scan_bwd.cu (states -> carry -> chunk
// -> fixed-order reduce; no atomics, reruns bitwise equal):
//   1. ssd_bwdw_states, a warpgroup per (chunk, P box of 64, head, batch):
//      TMA brings x, dy, B and C (128-byte swizzle); w x and el dy are
//      split into three bf16 parts (hi, mid, lo) beside them; s = B^T (w
//      x) and u = C^T (el dy) are wgmma m64n64k16 products, one a part,
//      with B and C read as transposed (MN-major) A operands, as
//      ssd_scan.cu's walk takes B^T (w x); written to float32 scratch (B,
//      H, nc, N, P) with Lend.
//   2. ssd_bwd_carry (ssd_bwd_carry.cuh, shared with ssd_scan_bwd.cu): h0
//      over the chunk states and dh1 over the dh terms, in place, a thread
//      loading 8 chunks of its 4 elements before it walks them.
//   3. ssd_bwdw_chunk, two warpgroups per (chunk, run of HPC consecutive
//      heads of one group, batch).  C and B come once a run (one group);
//      per head TMA brings x and dy (every P box), all 256 threads stage h0
//      and dh1 from the scratch as three bf16 planes each (hi, mid, lo;
//      [n][p], 128-byte swizzle, so one tile is the MN-major B operand of B
//      dh1 and the K-major one of x dh1^T), and one warp scans lam.
//        * Warpgroup 0: G = C B^T once a run; per head dS = dy x^T, then
//          S, dG, T and R in the accumulator registers (exp only for j <=
//          i), the row sums of R and the column sums of R and T in float64
//          (quad and column shuffles, then four warps in order), S in hi/lo
//          planes to shared memory and dG added to the run's sum in
//          registers; per P box v = B dh1 and C h0 (all three planes of
//          dh1 and h0), z and cq, then dx = w v + S^T dy (S hi + lo,
//          MN-major A), stored bf16.
//        * Warpgroup 1 keeps dB and dC of the run in registers: per head
//          and P box dB += (w x) dh1^T and dC += (el dy) h0^T, with w x
//          and el dy built in registers as A fragments and split in two,
//          against dh1's and h0's hi and mid planes (hi + mid is their
//          two-way split), three products each (hi hi, hi mid, lo hi);
//          after the last head, dC += dGs B and dB += dGs^T C with dGs
//          the run's sum of dG (the heads share B and C), hi + lo, then
//          the run's dB and dC go to float32 scratch (B, L, H / HPC, N).
//          One of its warps runs each head's scalar tail a head later (it
//          reads that head's sums from a buffer of two): dlam, its suffix
//          sums (a warp scan in float64), ddt and the chunk's share of dA
//          (float64).
//      Every wgmma is issued on no branch inside its warpgroup's code
//      (ptxas serializes a kernel's wgmma where one sits behind a branch,
//      C7520); each warpgroup's code is its own function after the split.
//   4. ssd_bwd_reduce (ssd_bwd_carry.cuh): dB and dC summed over a group's
//      runs, dA over batch and chunks, in float64, in a fixed order.
// Precision: x, dy, B and C are bf16 and exact in the tensor cores; every
// float32 operand (S, dG's sum, h0, dh1, w x, el dy) is split into a bf16
// high part and the bf16 remainder, its product taken on both (~16 bits:
// one rounding of S, h and w x left ssd_scan.cu's walk 0.125 from the plain
// version); the chunk states and the products v = B dh1 and C h0, whose
// errors reach ddt and dA (float32 outputs) through the carries, z and cq,
// take a third part (~24 bits).  Sums over the head run, of dlam and of dA
// are as in ssd_scan_bwd.cu: float32 for the products, float64 for R's and
// T's row and column sums, the dlam tail and dA.
//
// Bound on the H100 SXM (3.35 TB/s; 989 TFLOP/s bf16) at Zamba2-2.7B's
// train shape (B, L, H, P, G, N) = (1, 4,096, 80, 64, 1, 64): 131 MB of
// inputs and outputs (0.039 ms) against 20 GFLOP of products (0.020 ms):
// bytes bound it.  This design moves besides the 336 MB of float32 scratch
// of the chunk states and gradients (written by launch 1, read and
// rewritten by the carry, read by launch 3) and dB/dC partials cut by the
// run length HPC (8 at that shape: 2 x 10 MB).
// Shared memory (StatesShape, ChunkShape, with 1 KB of alignment slack):
// launch 1 84,032 bytes at N <= 64, 100,416 at N = 128; launch 3 111,808
// at N <= 64 and P <= 64, 160,960 at P = 256, 177,344 at N = 128 and P <=
// 64, 226,496 at N = 128 and P = 256 (the H100's limit is 232,448).
// Domain: any L >= 1; N <= 128; P <= 256 (x and dy of every P box stay
// resident a head); G dividing H; HPC dividing H / G; x, dy, B and C
// TMA-ready (16-byte aligned, strides of 16 bytes; the wrapper copies
// otherwise), their last axes contiguous; dt strided.

#include "hopper.cuh"   // mbarriers, TMA loads, wgmma, descriptors
#include "ssd_bwd_carry.cuh"   // launches 2 and 4, shared with ssd_scan_bwd.cu

namespace {

constexpr int QT = 64;                  // rows of a chunk
constexpr int BOX = QT * 128;           // 64 rows of 64 bf16, 128-byte swizzle
constexpr int WG = 128;                 // threads of a warpgroup
constexpr int CHUNK_THREADS = 2 * WG;
constexpr int MAX_PB = 4;               // P boxes of 64 columns (P <= 256)
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* dt;
  const float* A;
  const float* dhf;   // (Bsz, H, N, P) gradient of the final state, or null
  float* hs;          // (Bsz, H, nc, N, P): chunk states, then start states
  float* ds;          // (Bsz, H, nc, N, P): dh terms, then end gradients dh1
  float* le;          // (Bsz, H, nc) lam at each chunk's last row
  __nv_bfloat16* dx;  // (Bsz, L, H, P)
  float* ddt;         // (Bsz, L, H)
  float* dA;          // (H,)
  __nv_bfloat16* dB;  // (Bsz, L, G, N)
  __nv_bfloat16* dC;
  float* dBp;         // (Bsz, L, H / hpc, N): a run's dB
  float* dCp;
  double* dAp;        // (Bsz, H, nc): each chunk's share of dA
  int Bsz, L, H, G, P, N, nc, npb, hpc, nrun;
  long long ds0, ds1, ds2;      // dt: batch, position, head strides
};

// wgmma.mma_async m64nNk16, float32 += bf16 x bf16.  _ss: A and B from
// shared memory, TA / TB 1 for an MN-major (transposed) operand, acc = 0
// overwrites D; _rs: A from registers (the accumulator's fragment layout),
// TB as above, accumulating.
template <int TA, int TB>
__device__ __forceinline__ void mma_ss64(float (&d)[32], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void mma_rs64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_ss128(float (&d)[64], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void mma_rs128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

template <int NB, int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[32 * NB], uint64_t da,
                                       uint64_t db, int acc) {
  if constexpr (NB == 1) mma_ss64<TA, TB>(d, da, db, acc);
  else mma_ss128<TA, TB>(d, da, db, acc);
}

template <int NB, int TB>
__device__ __forceinline__ void mma_rs(float (&d)[32 * NB],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (NB == 1) mma_rs64<TB>(d, a, db);
  else mma_rs128<TB>(d, a, db);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// (hi, lo) bf16 pairs of v0 and v1: hi = bf16(v), lo = bf16(v - hi), so
// hi + lo carries v to ~2^-16 of its size (ssd_scan.cu's split_bf16).
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(__fsub_rn(v0, hf.x), __fsub_rn(v1, hf.y));
}

__device__ __forceinline__ float2 bf2(const uint8_t* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// 16 bytes (8 bf16) of a tile times s, split in three (hopper.cuh's
// split3_pair), into the same place of the hi, mid and lo planes.
__device__ __forceinline__ void scale_split16(const uint8_t* src, float s,
                                              uint8_t* hi, int plane) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&u);
  uint4 h, m, l;
  uint32_t* hp = reinterpret_cast<uint32_t*>(&h);
  uint32_t* mp = reinterpret_cast<uint32_t*>(&m);
  uint32_t* lp = reinterpret_cast<uint32_t*>(&l);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(v[e]);
    split3_pair(__fmul_rn(f.x, s), __fmul_rn(f.y, s), hp[e], mp[e], lp[e]);
  }
  *reinterpret_cast<uint4*>(hi) = h;
  *reinterpret_cast<uint4*>(hi + plane) = m;
  *reinterpret_cast<uint4*>(hi + 2 * plane) = l;
}

// One warp: dt of rows 2 lane and 2 lane + 1 (0 past the chunk's rows).
__device__ __forceinline__ float2 load_dt(const Args& a, int b, int h, int t0,
                                          int rows) {
  const int j0 = 2 * (threadIdx.x & 31), j1 = j0 + 1;
  const float* db = a.dt + b * a.ds0 + h * a.ds2;
  return make_float2(j0 < rows ? db[(long long)(t0 + j0) * a.ds1] : 0.f,
                     j1 < rows ? db[(long long)(t0 + j1) * a.ds1] : 0.f);
}

// One warp, from load_dt's d: lam (the running sum of A dt in row order, a
// warp scan), w = e^{Lend - lam} dt and el = e^{lam} (both 0 past the
// rows) into shared memory; returns Lend, lam at the chunk's last row (rows
// past L add 0).
__device__ __forceinline__ float chunk_terms(const Args& a, int h, int rows,
                                             float2 d, float* lam,
                                             float* dts, float* w,
                                             float* el) {
  const int lane = threadIdx.x & 31, j0 = 2 * lane, j1 = j0 + 1;
  const float d0 = d.x, d1 = d.y;
  const float Ah = a.A[h];
  const float a0 = __fmul_rn(Ah, d0), a1 = __fmul_rn(Ah, d1);
  float incl = __fadd_rn(a0, a1);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl = __fadd_rn(v, incl);
  }
  float excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = 0.f;
  const float lam0 = __fadd_rn(excl, a0), lam1 = __fadd_rn(lam0, a1);
  const float lend = __shfl_sync(FULL, lam1, 31);
  lam[j0] = lam0;
  lam[j1] = lam1;
  dts[j0] = d0;
  dts[j1] = d1;
  w[j0] = j0 < rows ? __fmul_rn(expf(__fsub_rn(lend, lam0)), d0) : 0.f;
  w[j1] = j1 < rows ? __fmul_rn(expf(__fsub_rn(lend, lam1)), d1) : 0.f;
  el[j0] = j0 < rows ? expf(lam0) : 0.f;
  el[j1] = j1 < rows ? expf(lam1) : 0.f;
  return lend;
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (2 ulp; 2^-inf = 0), as ssd_scan.cu's
// walk takes its decays.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void store_f2(float* p, float v0, float v1, int col,
                                         int n) {
  if (col + 1 < n && (n & 1) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (col < n) p[0] = v0;
    if (col + 1 < n) p[1] = v1;
  }
}

__device__ __forceinline__ void store_bf2(__nv_bfloat16* p, float v0, float v1,
                                          int col, int n) {
  if (col + 1 < n && (n & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (col < n) p[0] = __float2bfloat16_rn(v0);
    if (col + 1 < n) p[1] = __float2bfloat16_rn(v1);
  }
}

// ---------------------------------------------------------------------------
// Launch 1: chunk states s = B^T (w x) and dh terms u = C^T (el dy)
// ---------------------------------------------------------------------------

template <int NB>
struct StatesShape {
  static constexpr int C_OFF = 0;                  // C, NB boxes [i][n]
  static constexpr int B_OFF = NB * BOX;           // B, NB boxes [j][n]
  static constexpr int X_OFF = 2 * NB * BOX;       // x [j][p]
  static constexpr int Y_OFF = X_OFF + BOX;        // dy [i][p]
  static constexpr int W_OFF = Y_OFF + BOX;        // w x: hi, mid, lo planes
  static constexpr int E_OFF = W_OFF + 3 * BOX;    // el dy: hi, mid, lo
  static constexpr int F_OFF = E_OFF + 3 * BOX;    // lam, dt, w, el
  static constexpr int BAR_OFF = F_OFF + 4 * QT * 4;
  static constexpr int SMEM = BAR_OFF + 64 + 1024; // + base slack
  static constexpr int TMA_BYTES = 2 * NB * BOX + 2 * BOX;
};

template <int NB>
__global__ void __launch_bounds__(WG)
ssd_bwdw_states(const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tdy,
                const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap tc, const Args a) {
  using S = StatesShape<NB>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sp = align1024(smem_raw);
  const uint32_t base = smem_u32(sp), bar = base + S::BAR_OFF;
  const int pb = blockIdx.x % a.npb, c = blockIdx.x / a.npb;
  const int h = blockIdx.y, b = blockIdx.z, g = h / (a.H / a.G);
  const int t0 = c * QT, rows = min(QT, a.L - t0), p0 = pb * 64;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* lam = reinterpret_cast<float*>(sp + S::F_OFF);
  float* dts = lam + QT;
  float* w = dts + QT;
  float* el = w + QT;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, S::TMA_BYTES);
    for (int kc = 0; kc < NB; ++kc) {
      tma_load(base + S::C_OFF + kc * BOX, &tc, bar, kc * 64, t0, g, b);
      tma_load(base + S::B_OFF + kc * BOX, &tb, bar, kc * 64, t0, g, b);
    }
    tma_load(base + S::X_OFF, &tx, bar, p0, h, t0, b);
    tma_load(base + S::Y_OFF, &tdy, bar, p0, h, t0, b);
  }
  if (warp == 0) {
    const float lend =
        chunk_terms(a, h, rows, load_dt(a, b, h, t0, rows), lam, dts, w, el);
    if (lane == 0 && pb == 0)
      a.le[((long long)b * a.H + h) * a.nc + c] = lend;
  }
  __syncthreads();
  mbar_wait(bar, 0);
  // w x and el dy in x's swizzled layout (a 16-byte chunk is 8 columns of
  // one row j), in three parts each.
  for (int q = tid; q < BOX / 16; q += WG) {
    const int j = q >> 3;
    scale_split16(sp + S::X_OFF + 16 * q, w[j], sp + S::W_OFF + 16 * q, BOX);
    scale_split16(sp + S::Y_OFF + 16 * q, el[j], sp + S::E_OFF + 16 * q, BOX);
  }
  fence_async_smem();
  __syncthreads();

  // s[n][p] = sum_j B_jn (w x)_jp and u[n][p] = sum_i C_in (el dy)_ip: B
  // and C as MN-major A operands (64 states a box), w x and el dy as
  // MN-major B operands, each three times (lo, mid, hi): the states carry
  // into h0 and dh1, whose errors reach ddt and dA (float32 outputs)
  // through z and cq.
  float s[NB][32], u[NB][32];
#pragma unroll
  for (int m = 0; m < NB; ++m) {
    zero(s[m]);
    zero(u[m]);
    fence_regs(s[m]);
    fence_regs(u[m]);
  }
  wg_fence();
#pragma unroll
  for (int m = 0; m < NB; ++m)
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      const uint64_t dbm = mn_desc<64>(base + S::B_OFF + m * BOX, kb);
      const uint64_t dcm = mn_desc<64>(base + S::C_OFF + m * BOX, kb);
#pragma unroll
      for (int pl = 2; pl >= 0; --pl) {
        mma_ss64<1, 1>(s[m], dbm, mn_desc<64>(base + S::W_OFF + pl * BOX, kb),
                       1);
        mma_ss64<1, 1>(u[m], dcm, mn_desc<64>(base + S::E_OFF + pl * BOX, kb),
                       1);
      }
    }
  wg_commit();
  wg_wait0();
#pragma unroll
  for (int m = 0; m < NB; ++m) {
    fence_regs(s[m]);
    fence_regs(u[m]);
  }
  const long long np = (long long)a.N * a.P;
  const long long off = (((long long)b * a.H + h) * a.nc + c) * np;
  const int gq = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int m = 0; m < NB; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = 64 * m + 16 * warp + gq + 8 * i;
      if (n >= a.N) continue;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int p = p0 + 8 * k + 2 * q4;
        const long long o = off + (long long)n * a.P + p;
        store_f2(a.hs + o, s[m][4 * k + 2 * i], s[m][4 * k + 2 * i + 1], p,
                 a.P);
        store_f2(a.ds + o, u[m][4 * k + 2 * i], u[m][4 * k + 2 * i + 1], p,
                 a.P);
      }
    }
}

// ---------------------------------------------------------------------------
// Launch 3: a chunk of a run of heads, two warpgroups
// ---------------------------------------------------------------------------

// A head's sums, in a buffer of two (head parity): lam, dt, w, el, cq, z
// (float, 64 each), then the row sums of R, the four warps' column sums of
// R and of T, and the eight warps' shares of <h0, dh1> (float64).
constexpr int PAR_BYTES = 6 * QT * 4 + 8 * (QT + 2 * 4 * QT + 8);

struct Par {
  float *lam, *dts, *w, *el, *cq, *z;
  double *rowR, *colR, *colT, *hd;
};

__device__ __forceinline__ Par par_at(uint8_t* p) {
  Par r;
  float* f = reinterpret_cast<float*>(p);
  r.lam = f;
  r.dts = f + QT;
  r.w = f + 2 * QT;
  r.el = f + 3 * QT;
  r.cq = f + 4 * QT;
  r.z = f + 5 * QT;
  double* d = reinterpret_cast<double*>(p + 6 * QT * 4);
  r.rowR = d;
  r.colR = d + QT;
  r.colT = d + 5 * QT;
  r.hd = d + 9 * QT;
  return r;
}

// Byte offsets: C and B (NB boxes each, loaded once a run), x and dy (a box
// per 64 P columns), h0 and dh1 of one P box (hi and lo planes, [n][p], 64
// NB rows of 128 bytes), S (then the run's dG) hi and lo [i][j], the two
// head buffers, the mbarriers.
template <int NB>
struct ChunkShape {
  int C_OFF, B_OFF, X_OFF, Y_OFF, HH, HM, HL, DH, DM, DL, SH, SL, F_OFF,
      BAR_OFF, SMEM;
  __host__ __device__ explicit ChunkShape(int npb) {
    C_OFF = 0;
    B_OFF = NB * BOX;
    X_OFF = 2 * NB * BOX;
    Y_OFF = X_OFF + npb * BOX;
    HH = Y_OFF + npb * BOX;
    HM = HH + NB * BOX;
    HL = HM + NB * BOX;
    DH = HL + NB * BOX;
    DM = DH + NB * BOX;
    DL = DM + NB * BOX;
    SH = DL + NB * BOX;
    SL = SH + BOX;
    F_OFF = SL + BOX;
    BAR_OFF = F_OFF + 2 * PAR_BYTES;
    SMEM = BAR_OFF + 64 + 1024;
  }
};

struct Ctx {
  int c, run, b, h_first, g, t0, rows;
  uint32_t base, bar_cb, bar_x;
  uint8_t* sp;
};

// bar.sync over the CTA's 256 threads, reached from either warpgroup's code.
__device__ __forceinline__ void cta_sync() { named_sync<1, CHUNK_THREADS>(); }

// 8 floats from p (columns past avail, or the whole row if !ok, read as 0).
__device__ __forceinline__ void load8(const float* p, bool ok, int avail,
                                      bool vec, float (&v)[8]) {
  if (ok && vec && avail >= 8) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    const float4 y = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = ok && e < avail ? p[e] : 0.f;
  }
}

// h0 and dh1 of head h, P box pb, from the carry's scratch into three bf16
// planes each (hopper.cuh's split3_pair: hi, mid, lo; [n][p], the 128-byte
// swizzle TMA writes; rows past N and columns past P are 0), by all 256
// threads; returns this thread's share of <h0, dh1> (float64).  hi + mid
// is the two-way split (bf16(v), bf16(v - hi)).
template <int NB>
__device__ __forceinline__ double stage_states(const Args& a, const Ctx& k,
                                               const ChunkShape<NB>& S, int h,
                                               int pb) {
  const long long np = (long long)a.N * a.P;
  const long long off =
      (((long long)k.b * a.H + h) * a.nc + k.c) * np + pb * 64;
  const float* h0 = a.hs + off;
  const float* d1 = a.ds + off;
  const int pw = min(64, a.P - pb * 64);
  const bool vec = (a.P & 3) == 0;
  double hd = 0.0;
  constexpr int CH = 64 * NB * 8;           // 8-column chunks of a tile
#pragma unroll
  for (int it = 0; it < CH / CHUNK_THREADS; ++it) {
    const int idx = threadIdx.x + it * CHUNK_THREADS;
    const int n = idx >> 3, ch = idx & 7, e0 = ch * 8;
    float hv[8], dv[8];
    load8(h0 + (long long)n * a.P + e0, n < a.N, pw - e0, vec, hv);
    load8(d1 + (long long)n * a.P + e0, n < a.N, pw - e0, vec, dv);
#pragma unroll
    for (int e = 0; e < 8; ++e) hd += (double)hv[e] * dv[e];
    uint4 hh, hm, hl, dh, dm, dl;
    split3_pair(hv[0], hv[1], hh.x, hm.x, hl.x);
    split3_pair(hv[2], hv[3], hh.y, hm.y, hl.y);
    split3_pair(hv[4], hv[5], hh.z, hm.z, hl.z);
    split3_pair(hv[6], hv[7], hh.w, hm.w, hl.w);
    split3_pair(dv[0], dv[1], dh.x, dm.x, dl.x);
    split3_pair(dv[2], dv[3], dh.y, dm.y, dl.y);
    split3_pair(dv[4], dv[5], dh.z, dm.z, dl.z);
    split3_pair(dv[6], dv[7], dh.w, dm.w, dl.w);
    const int o = n * 128 + ((ch ^ (n & 7)) << 4);
    *reinterpret_cast<uint4*>(k.sp + S.HH + o) = hh;
    *reinterpret_cast<uint4*>(k.sp + S.HM + o) = hm;
    *reinterpret_cast<uint4*>(k.sp + S.HL + o) = hl;
    *reinterpret_cast<uint4*>(k.sp + S.DH + o) = dh;
    *reinterpret_cast<uint4*>(k.sp + S.DM + o) = dm;
    *reinterpret_cast<uint4*>(k.sp + S.DL + o) = dl;
  }
  return hd;
}

// Both warpgroups, at each head's start: TMA for x and dy (every P box),
// lam and its terms into the head's buffer (warp 5), h0 and dh1 of P box
// 0; returns this thread's share of <h0, dh1>.
template <int NB>
__device__ __forceinline__ double head_start(const Args& a, const Ctx& k,
                                             const ChunkShape<NB>& S,
                                             const CUtensorMap* tx,
                                             const CUtensorMap* tdy, int hh,
                                             const Par& pr) {
  const int h = k.h_first + hh;
  cta_sync();       // the last head's tiles are read, this buffer's tail run
  if (threadIdx.x == 0) {
    mbar_expect_tx(k.bar_x, 2 * a.npb * BOX);
    for (int pb = 0; pb < a.npb; ++pb) {
      tma_load(k.base + S.X_OFF + pb * BOX, tx, k.bar_x, pb * 64, h, k.t0,
               k.b);
      tma_load(k.base + S.Y_OFF + pb * BOX, tdy, k.bar_x, pb * 64, h, k.t0,
               k.b);
    }
  }
  const bool lam_warp = (threadIdx.x >> 5) == 5;
  float2 d;
  if (lam_warp) d = load_dt(a, k.b, h, k.t0, k.rows);   // beside the staging
  const double hd = stage_states<NB>(a, k, S, h, 0);
  if (lam_warp) chunk_terms(a, h, k.rows, d, pr.lam, pr.dts, pr.w, pr.el);
  fence_async_smem();
  cta_sync();
  return hd;
}

// Both warpgroups, before P box pb > 0: h0 and dh1 of that box.
template <int NB>
__device__ __forceinline__ double restage(const Args& a, const Ctx& k,
                                          const ChunkShape<NB>& S, int h,
                                          int pb) {
  cta_sync();
  const double hd = stage_states<NB>(a, k, S, h, pb);
  fence_async_smem();
  cta_sync();
  return hd;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// One warp: head h's scalar tail from its buffer, in float64 (lane l rows
// 2l and 2l + 1): dlam, its suffix sums (a warp scan from the last row),
// ddt, and the chunk's share of dA.
__device__ __forceinline__ void head_tail(const Args& a, const Ctx& k,
                                          const Par& pr, int h) {
  const int lane = threadIdx.x & 31, k0 = 2 * lane, k1 = k0 + 1;
  const int rows = k.rows;
  const float lend = pr.lam[QT - 1];
  auto col = [](const double* c4, int j) {
    return ((c4[j] + c4[QT + j]) + c4[2 * QT + j]) + c4[3 * QT + j];
  };
  double hsum = 0.0;
  for (int i = 0; i < 8; ++i) hsum += pr.hd[i];
  const double zw = warp_sum((double)pr.z[k0] * pr.w[k0] +
                             (double)pr.z[k1] * pr.w[k1]);
  auto dlam = [&](int r) {
    if (r >= rows) return 0.0;
    double d = pr.rowR[r] - col(pr.colR, r) + (double)pr.el[r] * pr.cq[r] -
               (double)pr.z[r] * pr.w[r];
    if (r == rows - 1) d += zw + (double)expf(lend) * hsum;
    return d;
  };
  const double d0 = dlam(k0), d1 = dlam(k1);
  double sfx = d0 + d1;                     // rows 2l.. to the end
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_down_sync(FULL, sfx, o);
    if (lane + o < 32) sfx += v;
  }
  double after = __shfl_down_sync(FULL, sfx, 1);
  if (lane == 31) after = 0.0;
  const double s1 = d1 + after, s0 = d0 + s1;
  const double Ah = a.A[h];
  float* ddt = a.ddt + ((long long)k.b * a.L + k.t0) * a.H + h;
  if (k0 < rows)
    ddt[(long long)k0 * a.H] =
        (float)(col(pr.colT, k0) + (double)pr.z[k0] * expf(lend - pr.lam[k0]) +
                Ah * s0);
  if (k1 < rows)
    ddt[(long long)k1 * a.H] =
        (float)(col(pr.colT, k1) + (double)pr.z[k1] * expf(lend - pr.lam[k1]) +
                Ah * s1);
  const double dA = warp_sum((double)pr.dts[k0] * s0 + (double)pr.dts[k1] * s1);
  if (lane == 0) a.dAp[((long long)k.b * a.H + h) * a.nc + k.c] = dA;
}

// Warpgroup 0: G once; per head dS, S, dG, the sums of R and T, then per P
// box v = B dh1 and C h0, z, cq and dx; after the run, the run's dG sum
// to shared memory for warpgroup 1.
template <int NB>
__device__ __forceinline__ void chunk_wg0(const Args& a, const Ctx& k,
                                          const ChunkShape<NB>& S,
                                          const CUtensorMap* tx,
                                          const CUtensorMap* tdy) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, q4 = lane & 3, r0 = 16 * warp + gq, r1 = r0 + 8;
  uint8_t* const sp = k.sp;
  const uint32_t base = k.base;
  float G[32], dGs[32];
  zero(G);
  zero(dGs);
  mbar_wait(k.bar_cb, 0);
  fence_regs(G);
  wg_fence();
#pragma unroll
  for (int kc = 0; kc < NB; ++kc)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_ss64<0, 0>(G, kmajor(base + S.C_OFF + kc * BOX, kk),
                     kmajor(base + S.B_OFF + kc * BOX, kk), 1);
  wg_commit();
  wg_wait0();
  fence_regs(G);

  for (int hh = 0; hh < a.hpc; ++hh) {
    const int h = k.h_first + hh;
    const Par pr = par_at(sp + S.F_OFF + (hh & 1) * PAR_BYTES);
    double hd = head_start<NB>(a, k, S, tx, tdy, hh, pr);
    mbar_wait(k.bar_x, hh & 1);

    // dS = dy x^T over the P boxes.
    float dS[32];
    zero(dS);
    for (int pb = 0; pb < a.npb; ++pb) {
      fence_regs(dS);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_ss64<0, 0>(dS, kmajor(base + S.Y_OFF + pb * BOX, kk),
                       kmajor(base + S.X_OFF + pb * BOX, kk), 1);
      wg_commit();
      wg_wait0();
      fence_regs(dS);
    }

    // S, dG, T and R of the causal pairs (rows past the chunk's rows 0);
    // S in hi/lo planes [i][j]; dG into the run's sum; the row sums of R
    // (a quad's four lanes) and the column sums of R and T over the warp's
    // 16 rows (lanes of one column), in float64.
    const float l0 = pr.lam[r0], l1 = pr.lam[r1];
    const int b0 = gq & 1, b1 = (gq >> 1) & 1;
    double rr0 = 0.0, rr1 = 0.0;
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
      // the column sums of two column blocks n = 2 n2, 2 n2 + 1: slot g =
      // 2 (n - 2 n2) + jj over the thread's two rows
      double cr[4], ct[4];
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const int n = 2 * n2 + nn;
        float sv[4], rv[4], tv[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int row = i ? r1 : r0, cl = 8 * n + 2 * q4 + jj;
            const int idx = 4 * n + 2 * i + jj;
            float s = 0.f, t = 0.f, dg = 0.f, r = 0.f;
            if (cl <= row && row < k.rows) {
              const float e =
                  ex2(__fmul_rn(__fsub_rn(i ? l1 : l0, pr.lam[cl]), LOG2E));
              const float dc = pr.dts[cl];
              s = __fmul_rn(__fmul_rn(G[idx], e), dc);
              t = __fmul_rn(__fmul_rn(dS[idx], G[idx]), e);
              dg = __fmul_rn(__fmul_rn(dS[idx], e), dc);
              r = __fmul_rn(t, dc);
            }
            sv[2 * i + jj] = s;
            tv[2 * i + jj] = t;
            rv[2 * i + jj] = r;
            dGs[idx] = __fadd_rn(dGs[idx], dg);
          }
        uint32_t hi, lo;
        split_bf16(sv[0], sv[1], hi, lo);
        *reinterpret_cast<uint32_t*>(sp + S.SH + swz(r0, 8 * n + 2 * q4)) = hi;
        *reinterpret_cast<uint32_t*>(sp + S.SL + swz(r0, 8 * n + 2 * q4)) = lo;
        split_bf16(sv[2], sv[3], hi, lo);
        *reinterpret_cast<uint32_t*>(sp + S.SH + swz(r1, 8 * n + 2 * q4)) = hi;
        *reinterpret_cast<uint32_t*>(sp + S.SL + swz(r1, 8 * n + 2 * q4)) = lo;
        rr0 += (double)rv[0];
        rr0 += (double)rv[1];
        rr1 += (double)rv[2];
        rr1 += (double)rv[3];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          cr[2 * nn + jj] = (double)rv[jj] + (double)rv[2 + jj];
          ct[2 * nn + jj] = (double)tv[jj] + (double)tv[2 + jj];
        }
      }
      // Over the 8 lanes of a column (gq), halving the slots a level: gq
      // bit 0 keeps slots 2 b0 and 2 b0 + 1, bit 1 slot b1 + 2 b0, bit 2
      // sums; lanes with gq < 4 hold column 8 (2 n2 + b0) + 2 q4 + b1.
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const double sr = __shfl_xor_sync(FULL, b0 ? cr[kk] : cr[kk + 2], 4);
        const double st = __shfl_xor_sync(FULL, b0 ? ct[kk] : ct[kk + 2], 4);
        cr[kk] = (b0 ? cr[kk + 2] : cr[kk]) + sr;
        ct[kk] = (b0 ? ct[kk + 2] : ct[kk]) + st;
      }
      double rs = __shfl_xor_sync(FULL, b1 ? cr[0] : cr[1], 8);
      double ts = __shfl_xor_sync(FULL, b1 ? ct[0] : ct[1], 8);
      rs += b1 ? cr[1] : cr[0];
      ts += b1 ? ct[1] : ct[0];
      rs += __shfl_xor_sync(FULL, rs, 16);
      ts += __shfl_xor_sync(FULL, ts, 16);
      if (gq < 4) {
        const int cl = 8 * (2 * n2 + b0) + 2 * q4 + b1;
        pr.colR[warp * QT + cl] = rs;
        pr.colT[warp * QT + cl] = ts;
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      rr0 += __shfl_xor_sync(FULL, rr0, o);
      rr1 += __shfl_xor_sync(FULL, rr1, o);
    }
    if (q4 == 0) {
      pr.rowR[r0] = rr0;
      pr.rowR[r1] = rr1;
    }
    fence_async_smem();
    named_sync<2, WG>();              // S is in shared memory

    float z0 = 0.f, z1 = 0.f, cq0 = 0.f, cq1 = 0.f;
    const float w0 = pr.w[r0], w1 = pr.w[r1];
    for (int pb = 0; pb < a.npb; ++pb) {
      if (pb > 0) hd += restage<NB>(a, k, S, h, pb);
      const uint8_t* xt = sp + S.X_OFF + pb * BOX;
      const uint8_t* yt = sp + S.Y_OFF + pb * BOX;
      // v = B dh1 and C h0 over the states (A: B and C K-major; B
      // operand: dh1 and h0 [n][p] MN-major, all three planes: z and cq
      // feed ddt and dA, float32 outputs).
      float v[32], yc[32];
      zero(v);
      zero(yc);
      fence_regs(v);
      fence_regs(yc);
      wg_fence();
#pragma unroll
      for (int kb = 0; kb < 4 * NB; ++kb) {
        const uint64_t db = kmajor(base + S.B_OFF + (kb >> 2) * BOX, kb & 3);
        const uint64_t dc = kmajor(base + S.C_OFF + (kb >> 2) * BOX, kb & 3);
        mma_ss64<0, 1>(v, db, mn_desc<64>(base + S.DL, kb), 1);
        mma_ss64<0, 1>(v, db, mn_desc<64>(base + S.DM, kb), 1);
        mma_ss64<0, 1>(v, db, mn_desc<64>(base + S.DH, kb), 1);
        mma_ss64<0, 1>(yc, dc, mn_desc<64>(base + S.HL, kb), 1);
        mma_ss64<0, 1>(yc, dc, mn_desc<64>(base + S.HM, kb), 1);
        mma_ss64<0, 1>(yc, dc, mn_desc<64>(base + S.HH, kb), 1);
      }
      wg_commit();
      wg_wait0();
      fence_regs(v);
      fence_regs(yc);
      // z_j += x_j . v_j and cq_i += dy_i . (C h0)_i over this box.
      float zp0 = 0.f, zp1 = 0.f, cp0 = 0.f, cp1 = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int cl = 8 * n + 2 * q4;
        const float2 x0 = bf2(xt + swz(r0, cl)), x1 = bf2(xt + swz(r1, cl));
        const float2 y0 = bf2(yt + swz(r0, cl)), y1 = bf2(yt + swz(r1, cl));
        zp0 = fmaf(x0.x, v[4 * n], zp0);
        zp0 = fmaf(x0.y, v[4 * n + 1], zp0);
        zp1 = fmaf(x1.x, v[4 * n + 2], zp1);
        zp1 = fmaf(x1.y, v[4 * n + 3], zp1);
        cp0 = fmaf(y0.x, yc[4 * n], cp0);
        cp0 = fmaf(y0.y, yc[4 * n + 1], cp0);
        cp1 = fmaf(y1.x, yc[4 * n + 2], cp1);
        cp1 = fmaf(y1.y, yc[4 * n + 3], cp1);
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        zp0 += __shfl_xor_sync(FULL, zp0, o);
        zp1 += __shfl_xor_sync(FULL, zp1, o);
        cp0 += __shfl_xor_sync(FULL, cp0, o);
        cp1 += __shfl_xor_sync(FULL, cp1, o);
      }
      z0 = __fadd_rn(z0, zp0);
      z1 = __fadd_rn(z1, zp1);
      cq0 = __fadd_rn(cq0, cp0);
      cq1 = __fadd_rn(cq1, cp1);
      // dx = w v + S^T dy (S hi and lo as MN-major A, dy MN-major).
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        v[4 * n] = __fmul_rn(v[4 * n], w0);
        v[4 * n + 1] = __fmul_rn(v[4 * n + 1], w0);
        v[4 * n + 2] = __fmul_rn(v[4 * n + 2], w1);
        v[4 * n + 3] = __fmul_rn(v[4 * n + 3], w1);
      }
      fence_regs(v);
      wg_fence();
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        const uint64_t dyb = mn_desc<64>(base + S.Y_OFF + pb * BOX, kb);
        mma_ss64<1, 1>(v, mn_desc<64>(base + S.SH, kb), dyb, 1);
        mma_ss64<1, 1>(v, mn_desc<64>(base + S.SL, kb), dyb, 1);
      }
      wg_commit();
      wg_wait0();
      fence_regs(v);
      __nv_bfloat16* dxb =
          a.dx + (((long long)k.b * a.L + k.t0) * a.H + h) * a.P;
      const long long rs = (long long)a.H * a.P;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int j = i ? r1 : r0, p = pb * 64 + 8 * n + 2 * q4;
          if (j < k.rows)
            store_bf2(dxb + j * rs + p, v[4 * n + 2 * i], v[4 * n + 2 * i + 1],
                      p, a.P);
        }
    }
    if (q4 == 0) {
      pr.z[r0] = z0;
      pr.z[r1] = z1;
      pr.cq[r0] = cq0;
      pr.cq[r1] = cq1;
    }
    hd = warp_sum(hd);
    if (lane == 0) pr.hd[warp] = hd;
  }

  cta_sync();             // every head's tiles are read: S's planes are free
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t hi, lo;
      split_bf16(dGs[4 * n + 2 * i], dGs[4 * n + 2 * i + 1], hi, lo);
      const uint32_t o = swz(i ? r1 : r0, 8 * n + 2 * q4);
      *reinterpret_cast<uint32_t*>(sp + S.SH + o) = hi;
      *reinterpret_cast<uint32_t*>(sp + S.SL + o) = lo;
    }
  fence_async_smem();
  cta_sync();
}

// dB or dC += (s x) t^T over one P box: s x (x the tile [r][p], s a row's
// scale) built in registers as A fragments, split into hi and lo; t the
// hi and mid planes of h0 or dh1 ([n][p]: K-major B operand of N = 64 NB
// columns); three products a k-step (lo hi, hi mid, hi hi), in two stages
// (the fragments of two k-steps live at a time: registers).
template <int NB>
__device__ __forceinline__ void rank_update(float (&acc)[32 * NB],
                                            const uint8_t* tile, float s0,
                                            float s1, uint32_t thi,
                                            uint32_t tlo, int r0, int r1,
                                            int q4) {
#pragma unroll
  for (int k2 = 0; k2 < 4; k2 += 2) {     // two stages of two k-steps
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int cl = 16 * (k2 + kk) + 8 * half + 2 * q4;
        const float2 a0 = bf2(tile + swz(r0, cl)), a1 = bf2(tile + swz(r1, cl));
        split_bf16(__fmul_rn(a0.x, s0), __fmul_rn(a0.y, s0), ah[kk][2 * half],
                   al[kk][2 * half]);
        split_bf16(__fmul_rn(a1.x, s1), __fmul_rn(a1.y, s1),
                   ah[kk][2 * half + 1], al[kk][2 * half + 1]);
      }
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      mma_rs<NB, 0>(acc, al[kk], kmajor(thi, k2 + kk));
      mma_rs<NB, 0>(acc, ah[kk], kmajor(tlo, k2 + kk));
      mma_rs<NB, 0>(acc, ah[kk], kmajor(thi, k2 + kk));
    }
    wg_commit();
    wg_wait0();
    fence_regs(acc);
  }
}

// Warpgroup 1: the run's dB and dC in registers, each head's tail a head
// later (warp 4), then dC += dGs B and dB += dGs^T C and the run's share
// to scratch.
template <int NB>
__device__ __forceinline__ void chunk_wg1(const Args& a, const Ctx& k,
                                          const ChunkShape<NB>& S,
                                          const CUtensorMap* tx,
                                          const CUtensorMap* tdy) {
  const int tid = threadIdx.x - WG, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, q4 = lane & 3, r0 = 16 * warp + gq, r1 = r0 + 8;
  uint8_t* const sp = k.sp;
  const uint32_t base = k.base;
  float dB[32 * NB], dC[32 * NB];
  zero(dB);
  zero(dC);
  for (int hh = 0; hh < a.hpc; ++hh) {
    const int h = k.h_first + hh;
    const Par pr = par_at(sp + S.F_OFF + (hh & 1) * PAR_BYTES);
    double hd = head_start<NB>(a, k, S, tx, tdy, hh, pr);
    if (hh > 0 && warp == 0)
      head_tail(a, k, par_at(sp + S.F_OFF + ((hh - 1) & 1) * PAR_BYTES),
                h - 1);
    mbar_wait(k.bar_x, hh & 1);
    const float w0 = pr.w[r0], w1 = pr.w[r1];
    const float e0 = pr.el[r0], e1 = pr.el[r1];
    for (int pb = 0; pb < a.npb; ++pb) {
      if (pb > 0) hd += restage<NB>(a, k, S, h, pb);
      rank_update<NB>(dB, sp + S.X_OFF + pb * BOX, w0, w1, base + S.DH,
                      base + S.DM, r0, r1, q4);
      rank_update<NB>(dC, sp + S.Y_OFF + pb * BOX, e0, e1, base + S.HH,
                      base + S.HM, r0, r1, q4);
    }
    hd = warp_sum(hd);
    if (lane == 0) pr.hd[4 + warp] = hd;
  }
  cta_sync();
  if (warp == 0)
    head_tail(a, k, par_at(sp + S.F_OFF + ((a.hpc - 1) & 1) * PAR_BYTES),
              k.h_first + a.hpc - 1);
  mbar_wait(k.bar_cb, 0);
  cta_sync();             // the run's dG sum is in shared memory
  fence_regs(dB);
  fence_regs(dC);
  wg_fence();
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    const uint64_t bt = mn_desc<64>(base + S.B_OFF, kb);
    const uint64_t ct = mn_desc<64>(base + S.C_OFF, kb);
    mma_ss<NB, 0, 1>(dC, kmajor(base + S.SL, kb), bt, 1);
    mma_ss<NB, 0, 1>(dC, kmajor(base + S.SH, kb), bt, 1);
    mma_ss<NB, 1, 1>(dB, mn_desc<64>(base + S.SL, kb), ct, 1);
    mma_ss<NB, 1, 1>(dB, mn_desc<64>(base + S.SH, kb), ct, 1);
  }
  wg_commit();
  wg_wait0();
  fence_regs(dB);
  fence_regs(dC);
  const long long rs = (long long)a.nrun * a.N;
  const long long off = (((long long)k.b * a.L + k.t0) * a.nrun + k.run) * a.N;
#pragma unroll
  for (int n = 0; n < 8 * NB; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = i ? r1 : r0, cl = 8 * n + 2 * q4;
      if (j >= k.rows) continue;
      store_f2(a.dBp + off + j * rs + cl, dB[4 * n + 2 * i],
               dB[4 * n + 2 * i + 1], cl, a.N);
      store_f2(a.dCp + off + j * rs + cl, dC[4 * n + 2 * i],
               dC[4 * n + 2 * i + 1], cl, a.N);
    }
}

template <int NB>
__global__ void __launch_bounds__(CHUNK_THREADS, 1)
ssd_bwdw_chunk(const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tdy,
               const __grid_constant__ CUtensorMap tb,
               const __grid_constant__ CUtensorMap tc, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  const ChunkShape<NB> S(a.npb);
  Ctx k;
  k.sp = align1024(smem_raw);
  k.base = smem_u32(k.sp);
  k.bar_cb = k.base + S.BAR_OFF;
  k.bar_x = k.bar_cb + 8;
  k.c = blockIdx.x;
  k.run = blockIdx.y;
  k.b = blockIdx.z;
  k.h_first = k.run * a.hpc;
  k.g = k.h_first / (a.H / a.G);
  k.t0 = k.c * QT;
  k.rows = min(QT, a.L - k.t0);
  if (threadIdx.x == 0) {
    mbar_init(k.bar_cb, 1);
    mbar_init(k.bar_x, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(k.bar_cb, 2 * NB * BOX);
    for (int kc = 0; kc < NB; ++kc) {
      tma_load(k.base + S.C_OFF + kc * BOX, &tc, k.bar_cb, kc * 64, k.t0, k.g,
               k.b);
      tma_load(k.base + S.B_OFF + kc * BOX, &tb, k.bar_cb, kc * 64, k.t0, k.g,
               k.b);
    }
  }
  if (threadIdx.x >= WG) {
    chunk_wg1<NB>(a, k, S, &tx, &tdy);
    return;
  }
  chunk_wg0<NB>(a, k, S, &tx, &tdy);
}

// The tensor map of a 4-D bf16 operand (ssd_scan.cu's encode, 128-byte
// swizzle): sizes dims (innermost first, that axis contiguous), element
// strides of the other three, a box of box0 x box1 x box2 x 1.  The stride
// of an axis of size 1 is never used; it is set to a valid one.
bool encode4(CUtensorMap* map, const void* ptr, const int (&dims)[4],
             const long long (&st)[3], const int (&box)[3]) {
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
            d, bytes, bx, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NB>
int launch(const CUtensorMap& tx, const CUtensorMap& tdy,
           const CUtensorMap& tb, const CUtensorMap& tc, const Args& a,
           cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_bwdw_states<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        StatesShape<NB>::SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(ssd_bwdw_chunk<NB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ChunkShape<NB>(MAX_PB).SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  ssd_bwdw_states<NB><<<dim3(a.nc * a.npb, a.H, a.Bsz), WG,
                        StatesShape<NB>::SMEM, s>>>(tx, tdy, tb, tc, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_carry(a.hs, a.ds, a.le, a.dhf, a.Bsz, a.H, a.N, a.P, a.nc, s);
  if (err != cudaSuccess) return (int)err;
  ssd_bwdw_chunk<NB><<<dim3(a.nc, a.nrun, a.Bsz), CHUNK_THREADS,
                       ChunkShape<NB>(a.npb).SMEM, s>>>(tx, tdy, tb, tc, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_reduce(a.dBp, a.dCp, a.dAp, a.dB, a.dC, a.dA, a.Bsz,
                            a.L, a.H, a.G, a.N, a.nc, a.nrun, s);
}

}  // namespace

// ssd_scan_bwd_wgmma: the gradients (dx, ddt, dA, dB, dC) of the SSD scan
// along dy (and d final_state, or null) on the tensor cores.  x, B, C, dy,
// dx, dB and dC bf16; dt, A, dh_final float32; N <= 128, P <= 256; hpc
// (heads a CTA) divides H / G.  strides: (batch, position, head or group)
// of x, dt, B, C and dy, in that order; x, dy, B and C 16-byte aligned with
// strides of 16 bytes (TMA reads them), their last axes contiguous.
// Outputs contiguous: dx (Bsz, L, H, P), ddt (Bsz, L, H), dA (H,), dB and
// dC (Bsz, L, G, N).  Scratch: states and dstates Bsz * H * nc * N * P
// floats, lam_end Bsz * H * nc floats, dBp and dCp Bsz * L * (H / hpc) * N
// floats, dAp Bsz * H * nc doubles, nc = ceil(L / 64).
extern "C" int ssd_scan_bwd_wgmma(
    const void* x, const float* dt, const float* A, const void* Bm,
    const void* C, const void* dy, const float* dh_final, void* dx,
    float* ddt, float* dA, void* dB, void* dC, float* states,
    float* dstates, float* lam_end, float* dBp, float* dCp, double* dAp,
    int Bsz, int L, int H, int G, int P, int N, int hpc,
    const long long* strides, void* stream) {
  if (Bsz <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      P > 64 * MAX_PB || N <= 0 || N > 128 || hpc <= 0 ||
      (H / G) % hpc != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tdy, tb, tc;
  const int xdims[4] = {P, H, L, Bsz}, bdims[4] = {N, L, G, Bsz};
  const long long xst[3] = {strides[2], strides[1], strides[0]};
  const long long yst[3] = {strides[14], strides[13], strides[12]};
  const long long bst[3] = {strides[7], strides[8], strides[6]};
  const long long cst[3] = {strides[10], strides[11], strides[9]};
  const int xbox[3] = {64, 1, QT}, bbox[3] = {64, QT, 1};
  if (!encode4(&tx, x, xdims, xst, xbox) ||
      !encode4(&tdy, dy, xdims, yst, xbox) ||
      !encode4(&tb, Bm, bdims, bst, bbox) ||
      !encode4(&tc, C, bdims, cst, bbox))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.dt = dt; a.A = A; a.dhf = dh_final;
  a.hs = states; a.ds = dstates; a.le = lam_end;
  a.dx = static_cast<__nv_bfloat16*>(dx); a.ddt = ddt; a.dA = dA;
  a.dB = static_cast<__nv_bfloat16*>(dB);
  a.dC = static_cast<__nv_bfloat16*>(dC);
  a.dBp = dBp; a.dCp = dCp; a.dAp = dAp;
  a.Bsz = Bsz; a.L = L; a.H = H; a.G = G; a.P = P; a.N = N;
  a.nc = (L + QT - 1) / QT;
  a.npb = (P + 63) / 64;
  a.hpc = hpc;
  a.nrun = H / hpc;
  a.ds0 = strides[3]; a.ds1 = strides[4]; a.ds2 = strides[5];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 64) return launch<1>(tx, tdy, tb, tc, a, s);
  return launch<2>(tx, tdy, tb, tc, a, s);
}
