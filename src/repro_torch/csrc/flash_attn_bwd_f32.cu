// Backward pass of causal GQA flash attention in float32 for the H100
// (sm_90a), on the bf16 tensor cores at float32 accuracy: dQ, dK and dV of
// repro_torch/kernels/flash_attn/ref.py:mha on the float32 route of
// repro_torch/kernels/flash_attn/kernel.py:route_bwd (D <= 192, Dv <= 128).
// The equations, the rows that see no key, the masks and the determinism
// (no atomics, fixed-order sums: bitwise reruns) are flash_attn_bwd.cu's;
// it replaces no TPU kernel (flash_attn_bwd.cu says why the port has it).
// A library of its own, so that nvcc builds it beside flash_attn_bwd.cu.
//
// Bound on the H100 SXM at (B, Hq, Hkv, S, D) = (1, 32, 4, 4096, 128),
// causal: the backward's five products are 344 GFLOP, 5.13 ms on the CUDA
// cores (67 TFLOP/s) and 2.09 ms at the float32-accurate tensor-core rate
// (989 / 6 = 165 TFLOP/s); its bytes 0.090 ms.  Operations bound it.  At
// DeepSeek-V3's MLA prefill, (1, 128, 128, 511, 511), Dk 192, Dv 128: 27.9
// GFLOP, 0.169 ms at 165 TFLOP/s, against 0.100 ms for its 335 MB.
//
// The bf16 route's four launches (float16 and mixed dtypes are read in
// float32) on the float32 tensor-core arithmetic of flash_attn_f32.cu:
// each float32 operand split into three bf16 parts (hopper.cuh: split_tile
// into swizzled shared-memory planes by a producer warpgroup, split3_pair
// into register planes for P and dS), each
// product the six partial products (small first) into a float32
// accumulator that sums only one tile's products before it is added to
// the running float32 sum (the tensor cores' own accumulation drops low
// bits).  delta and the group's sum as on the bf16 route (attn_bwd.cuh);
// then
//   2. attn_bwd_dkv_f32_kernel, a CTA per (key tile of 64, query head,
//      batch), heaviest first, 256 threads: a producer warpgroup splits the
//      keys' K and V once (resident, 48 KB each at D = Dv = 128) and then
//      Q and dO of each tile of 32 queries that reaches them into a
//      two-stage ring (2 x 48 KB; 193 KB in all); one consumer warpgroup
//      runs S^T = K Q^T and dP^T = V dO^T (m64n32, six products each), P^T
//      and dS^T in float32, dV += P^T dO and dK += dS^T Q in 64-column
//      chunks (m64n64, each chunk's six products into a fresh accumulator),
//      and writes float32 partials of the head.  Three planes take 6 bytes
//      an element against bf16's 2, so the bf16 route's 128-key CTA with
//      64-query stages does not fit; dK, dV (128 floats a thread), P's and
//      dS's planes and the chunk's accumulator fill the 255 registers a
//      thread of a 256-thread CTA may hold.
//   3. attn_bwd_dq_f32_kernel, a CTA per (query tile of 64, query head,
//      batch), last tiles first: Q and dO resident (their planes 48 KB
//      each), K and V of 32 keys streamed likewise; S = Q K^T, dP = dO V^T,
//      dS in float32, dQ += dS K into a fresh accumulator a tile.
// Seven products as on the bf16 route (482 GFLOP at the shape above, 2.9
// PFLOP of bf16 partial products: 2.9 ms at the bf16 peak), no atomics.
//
// Heads past 128 (MLA's Dk 192, Dv 128; DPC = 3): the streamed tiles stay
// at 32 rows, and the dQ kernel takes its product a 64-column chunk at a
// time.  At (192, 128) the resident planes of the dK/dV kernel (K 72 KB, V
// 48 KB) and of the dQ kernel (Q 72, dO 48) beside two stages of 32-row
// tiles (2 x 60 KB) would take 240 KB of the 227 a CTA may have.  The
// operand each kernel reads only in its first products -- dO in dP^T and
// dV of the dK/dV kernel, V in dP of the dQ kernel -- keeps one buffer,
// which the consumer frees as soon as those products are done, so that
// the producer splits the next tile's into it while the consumer runs the
// rest of the tile (dK; dS and dQ); the other operand keeps two stages:
// 218 KB and 217 KB.  (Two stages of 16-row tiles fit too, 181 KB, but
// were slower on the card: an m64n16 product reads the resident 64-row A
// operand from shared memory once per 16 queries or keys, and those reads
// bound it.)  The dK/dV consumer's 96 + 64 accumulators
// beside a 32-row tile's fragments (S^T and dP^T 16 registers each, P's
// or dS's planes 24, a chunk's fresh accumulator 32) pass the 255
// registers a thread may hold, and ptxas spills.  The dQ kernel's 96
// accumulators beside a fresh 192-column accumulator (96) would pass 255
// too: its fresh accumulator takes 64 columns (CW), three a tile.
// Splitting dK's and dV's columns over CTAs (each recomputing S^T and
// dP^T) or a dV pass and a dK pass would fit as well, at 1.3-1.5 times
// the products.  Heads past (192, 128) take the CUDA-core route of
// flash_attn_bwd.cu.

#include <math.h>

#include "hopper.cuh"   // mbarriers, wgmma, the three-way split
#include "attn_bwd.cuh" // strides, delta, the group's sum

namespace {

constexpr float LOG2E = 1.4426950408889634f;

constexpr int F3_THREADS = 256;   // a consumer warpgroup + a producer warpgroup
constexpr int F3_STAGES = 2;
constexpr int F3_KV_ROWS = 64;    // dK/dV: keys a CTA
constexpr int F3_KV_QT = 32;      // dK/dV: queries a streamed tile
constexpr int F3_DQ_ROWS = 64;    // dQ: queries a CTA
constexpr int F3_DQ_KT = 32;      // dQ: keys a streamed tile
constexpr int F3_SMEM_MAX = 232448;   // a CTA's shared memory on the H100

struct F3Args {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;   // (B, Hq, Sq), log2 domain, from the forward
  const float* dlt;   // (B, Hq, Sq): rowsum(dO * O)
  float* wk;          // (B, Hq, Sk, 64 DPC): scale dS^T Q of a head
  float* wv;          // (B, Hq, Sk, 64 NVC): P^T dO of a head
  float* dq;
  float* dk;          // written here at DPC = 3 with group == 1, else by
                      // the sum
  float* dv;
  Strides st;
  int Hq, group, Sq, Sk, D, Dv;
  float scale_log2, scale;
  int causal;
  int pair;           // even D and dq strides, 8-byte aligned dq: float2 stores
  int pair_kv;        // the same of dk and dv (and an even Dv)
};

// Shared memory of the dK/dV kernel: the three planes of its 64 keys' K and
// V, resident, and two stages of the three planes of 32 queries' Q with
// their lse and delta.  dO's planes ride with Q in each stage where two
// stages of both fit; at (192, 128) they do not (240 KB), and dO has one
// buffer of its own (O_BUFS = 1, 218 KB), which the consumer frees once
// dV is done, so that the producer splits the next tile's dO while the
// consumer runs dK.
template <int DPC, int NVC>
struct F3DkvShape {
  static constexpr int K_PLANE = DPC * F3_KV_ROWS * BOX_BYTES_PER_ROW;
  static constexpr int V_PLANE = NVC * F3_KV_ROWS * BOX_BYTES_PER_ROW;
  static constexpr int Q_PLANE = DPC * F3_KV_QT * BOX_BYTES_PER_ROW;
  static constexpr int O_PLANE = NVC * F3_KV_QT * BOX_BYTES_PER_ROW;
  static constexpr int V_OFF = 3 * K_PLANE;
  static constexpr int ST_OFF = V_OFF + 3 * V_PLANE;
  static constexpr int ROWS = F3_STAGES * 2 * F3_KV_QT * 4;
  static constexpr int O_BUFS =
      ST_OFF + F3_STAGES * 3 * (Q_PLANE + O_PLANE) + ROWS + 64 + 1024 <=
              F3_SMEM_MAX
          ? F3_STAGES : 1;
  // Q's planes, then (two buffers) dO's
  static constexpr int STAGE = 3 * (Q_PLANE + (O_BUFS > 1 ? O_PLANE : 0));
  static constexpr int O_ONE = ST_OFF + F3_STAGES * STAGE;   // one buffer
  static constexpr int ROW_OFF = O_ONE + (O_BUFS > 1 ? 0 : 3 * O_PLANE);
  static constexpr int BAR_OFF = ROW_OFF + ROWS;
  static constexpr int SMEM = BAR_OFF + 64 + 1024;
  static_assert(SMEM <= F3_SMEM_MAX, "a CTA's shared memory");
  // dO's planes of stage s
  __host__ __device__ static constexpr int o_off(int s) {
    return O_BUFS > 1 ? ST_OFF + s * STAGE + 3 * Q_PLANE : O_ONE;
  }
};

// Shared memory of the dQ kernel: the three planes of its 64 queries' Q and
// dO, resident, and two stages of the three planes of 32 keys' K.  V's
// planes ride with K where two stages of both fit; at (192, 128) V has one
// buffer (V_BUFS = 1, 217 KB), which the consumer frees once dP is done,
// so that the producer splits the next tile's V while the consumer runs
// dS and dQ.
template <int DPC, int NVC>
struct F3DqShape {
  static constexpr int Q_PLANE = DPC * F3_DQ_ROWS * BOX_BYTES_PER_ROW;
  static constexpr int O_PLANE = NVC * F3_DQ_ROWS * BOX_BYTES_PER_ROW;
  static constexpr int K_PLANE = DPC * F3_DQ_KT * BOX_BYTES_PER_ROW;
  static constexpr int V_PLANE = NVC * F3_DQ_KT * BOX_BYTES_PER_ROW;
  static constexpr int O_OFF = 3 * Q_PLANE;
  static constexpr int ST_OFF = O_OFF + 3 * O_PLANE;
  static constexpr int V_BUFS =
      ST_OFF + F3_STAGES * 3 * (K_PLANE + V_PLANE) + 64 + 1024 <= F3_SMEM_MAX
          ? F3_STAGES : 1;
  // K's planes, then (two buffers) V's
  static constexpr int STAGE = 3 * (K_PLANE + (V_BUFS > 1 ? V_PLANE : 0));
  static constexpr int V_ONE = ST_OFF + F3_STAGES * STAGE;   // one buffer
  static constexpr int BAR_OFF = V_ONE + (V_BUFS > 1 ? 0 : 3 * V_PLANE);
  static constexpr int SMEM = BAR_OFF + 64 + 1024;
  static_assert(SMEM <= F3_SMEM_MAX, "a CTA's shared memory");
  // V's planes of stage s
  __host__ __device__ static constexpr int v_off(int s) {
    return V_BUFS > 1 ? ST_OFF + s * STAGE + 3 * K_PLANE : V_ONE;
  }
};

// The six partial products of a 64-row A (three K-major planes at a, plane
// stride pa) times B^T (32 rows, three K-major planes at b, stride pb),
// over NC 64-column chunks of depth (boxes ra and 32 rows apart), into d.
template <int NC>
__device__ __forceinline__ void six_ss_n32(float (&d)[16], uint32_t a,
                                           int pa, int ra, uint32_t b,
                                           int pb) {
#pragma unroll
  for (int pr = 0; pr < 6; ++pr)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<32>(
            d,
            sw128_desc(a + split_a(pr) * pa + c * ra * BOX_BYTES_PER_ROW +
                           kk * 32, 16, 1024),
            sw128_desc(b + split_b(pr) * pb + c * 32 * BOX_BYTES_PER_ROW +
                           kk * 32, 16, 1024),
            (pr | c | kk) ? 1 : 0);
}

// t = the six partial products of a 64 x 32 A in three register planes (two
// k-steps of 16) times the 32-row, 64-column chunk of a B held N-major in
// three planes at b (stride pb; 8-row groups 1,024 bytes apart), into a
// fresh accumulator: the caller adds t to its float32 sum.
__device__ __forceinline__ void six_rs_n64(float (&t)[32],
                                           const uint32_t (&a)[3][2][4],
                                           uint32_t b, int pb) {
#pragma unroll
  for (int i = 0; i < 32; ++i) t[i] = 0.f;
  fence_regs(t);
  wg_fence();
#pragma unroll
  for (int pr = 0; pr < 6; ++pr)
#pragma unroll
    for (int kb = 0; kb < 2; ++kb)
      wgmma_rs<64>(t, a[split_a(pr)][kb],
                   sw128_desc(b + split_b(pr) * pb + kb * 2048,
                              32 * BOX_BYTES_PER_ROW, 1024));
  wg_commit();
  wg_wait0();
  fence_regs(t);
}

// dK and dV of one query head's contribution to a key tile of 64 (a CTA
// per (key tile, query head, batch); key tiles heaviest first), in
// float32 on the tensor cores.  The producer warpgroup splits K and V into
// their planes once and then, for each tile of 32 queries that reaches
// the keys, Q and dO (with their lse and delta) into a two-stage ring (dO
// into a buffer of its own at (192, 128): F3DkvShape).
// The consumer warpgroup runs S^T = K Q^T and dP^T = V dO^T (six products
// each), P^T and dS^T in float32, each split into three register planes,
// and dV += P^T dO and dK += dS^T Q in 64-column chunks, each chunk's six
// products into a fresh accumulator added to dV or dK in float32 (the
// tensor cores' own accumulation drops low bits: flash_attn.cu).
template <int DPC, int NVC>
__global__ void __launch_bounds__(F3_THREADS, 1)
attn_bwd_dkv_f32_kernel(const F3Args a) {
  using S = F3DkvShape<DPC, NVC>;
  constexpr int DK = DPC * 64, DV = NVC * 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base_ptr =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(base_ptr);
  const uint32_t sK = base, sV = base + S::V_OFF;
  const uint32_t sQ = base + S::ST_OFF;    // stage s: + s STAGE; dO o_off(s)
  float* rows = reinterpret_cast<float*>(base_ptr + S::ROW_OFF);
  const uint32_t bar = base + S::BAR_OFF;
  // kv_full = bar; full[s] = bar + 8 (1 + s); empty[s] = bar + 8 (3 + s);
  // with one dO buffer, o_full = bar + 40 and o_empty = bar + 48
  constexpr bool ONE_O = S::O_BUFS == 1;

  const int per = gridDim.x / ((a.Sk + F3_KV_ROWS - 1) / F3_KV_ROWS);
  const int kt = blockIdx.x / per;
  const int h = (blockIdx.x % per) % a.Hq, b = (blockIdx.x % per) / a.Hq;
  const int hk = h / a.group;
  const int k0 = kt * F3_KV_ROWS;
  const int off = a.Sk - a.Sq;            // query i sits at position i + off
  const int n_qt = (a.Sq + F3_KV_QT - 1) / F3_KV_QT;
  // The query tiles that reach the keys: [0, blind_qt) hold the rows that
  // see no key (causal Sq > Sk; they weigh every key in dV), [lo, n_qt)
  // the rows whose last visible key is at or past k0.
  const int blind_qt =
      a.causal ? (max(0, -off) + F3_KV_QT - 1) / F3_KV_QT : 0;
  const int lo = a.causal
                     ? max(blind_qt, min(n_qt, max(0, k0 - off) / F3_KV_QT))
                     : 0;
  const int n_it = blind_qt + n_qt - lo;

  if (threadIdx.x == 0) {
    mbar_init(bar, 128);
    for (int s = 0; s < F3_STAGES; ++s) {
      mbar_init(bar + 8 * (1 + s), 128);   // the producer's threads
      mbar_init(bar + 8 * (3 + s), 4);     // the consumer warps
    }
    mbar_init(bar + 40, 128);
    mbar_init(bar + 48, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 128) {
    // Producer warpgroup: every thread splits, writes and arrives; the
    // first 32 also write the stage's lse and delta (+inf and 0 past Sq,
    // so that P = 0 there).  With one dO buffer, a tile's dO follows its
    // Q once the consumer has freed the buffer (after the last tile's dV).
    const int t = threadIdx.x - 128;
    split_tile<F3_KV_ROWS, DPC, 128>(
        base_ptr, S::K_PLANE,
        a.k + b * a.st.s[SKK] + hk * a.st.s[SKK + 1], a.st.s[SKK + 2], k0,
        a.Sk, a.D, t);
    split_tile<F3_KV_ROWS, NVC, 128>(
        base_ptr + S::V_OFF, S::V_PLANE,
        a.v + b * a.st.s[SV] + hk * a.st.s[SV + 1], a.st.s[SV + 2], k0, a.Sk,
        a.Dv, t);
    fence_async_smem();
    mbar_arrive(bar);
    const float* qb = a.q + b * a.st.s[SQ] + h * a.st.s[SQ + 1];
    const float* ob = a.dout + b * a.st.s[SDO] + h * a.st.s[SDO + 1];
    const long long row0 = ((long long)b * a.Hq + h) * a.Sq;
    for (int it = 0; it < n_it; ++it) {
      const int s = it % F3_STAGES, round = it / F3_STAGES;
      if (round > 0) mbar_wait(bar + 8 * (3 + s), (round - 1) & 1);
      const int q0 = (it < blind_qt ? it : lo + it - blind_qt) * F3_KV_QT;
      uint8_t* st = base_ptr + S::ST_OFF + s * S::STAGE;
      split_tile<F3_KV_QT, DPC, 128>(st, S::Q_PLANE, qb, a.st.s[SQ + 2], q0,
                                     a.Sq, a.D, t);
      if constexpr (!ONE_O)
        split_tile<F3_KV_QT, NVC, 128>(base_ptr + S::o_off(s), S::O_PLANE,
                                       ob, a.st.s[SDO + 2], q0, a.Sq, a.Dv,
                                       t);
      if (t < F3_KV_QT) {
        float* rl = rows + s * 2 * F3_KV_QT;
        const bool ok = q0 + t < a.Sq;
        rl[t] = ok ? a.lse[row0 + q0 + t] : INFINITY;
        rl[F3_KV_QT + t] = ok ? a.dlt[row0 + q0 + t] : 0.f;
      }
      fence_async_smem();
      mbar_arrive(bar + 8 * (1 + s));
      if constexpr (ONE_O) {
        if (it > 0) mbar_wait(bar + 48, (it - 1) & 1);
        split_tile<F3_KV_QT, NVC, 128>(base_ptr + S::O_ONE, S::O_PLANE, ob,
                                       a.st.s[SDO + 2], q0, a.Sq, a.Dv, t);
        fence_async_smem();
        mbar_arrive(bar + 40);
      }
    }
    return;
  }

  // Consumer warpgroup: a thread holds the rows (keys) key_lo and key_lo +
  // 8 of its warp's 16, and columns (queries) 8 n + 2 q4 + j of each tile.
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const int key_lo = k0 + warp * 16 + g;
  const float inv_sk = 1.f / (float)a.Sk;
  float dk[DK / 2], dv[DV / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dv[i] = 0.f;

  mbar_wait(bar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % F3_STAGES, phase = (it / F3_STAGES) & 1;
    const int q0 = (it < blind_qt ? it : lo + it - blind_qt) * F3_KV_QT;
    const uint32_t stQ = sQ + s * S::STAGE, stO = base + S::o_off(s);
    const float* rl = rows + s * 2 * F3_KV_QT;
    mbar_wait(bar + 8 * (1 + s), phase);
    if constexpr (ONE_O) mbar_wait(bar + 40, it & 1);

    // S^T = K Q^T and dP^T = V dO^T (64 keys x 32 queries each)
    float sc[16], dp[16];
    fence_regs(sc);
    fence_regs(dp);
    wg_fence();
    six_ss_n32<DPC>(sc, sK, S::K_PLANE, F3_KV_ROWS, stQ, S::Q_PLANE);
    six_ss_n32<NVC>(dp, sV, S::V_PLANE, F3_KV_ROWS, stO, S::O_PLANE);
    wg_commit();
    wg_wait0();
    fence_regs(sc);
    fence_regs(dp);

    // P^T = exp2(S^T scale log2(e) - lse) and dS^T = P^T (dP^T - delta):
    // sc[4 n + 2 i + j] is key key_lo + 8 i, query q0 + 8 n + 2 q4 + j.
    // The masks only where the tile crosses the diagonal, holds rows that
    // see no key (P = 1/Sk on every key, dS = 0) or ends past Sk.
    const bool edge =
        k0 + F3_KV_ROWS > a.Sk || (a.causal && k0 + F3_KV_ROWS - 1 > q0 + off);
#pragma unroll
    for (int n = 0; n < F3_KV_QT / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 4 * n + 2 * i + j, col = 8 * n + 2 * q4 + j;
          float p = exp2f(sc[e] * a.scale_log2 - rl[col]);
          float ds = p * (dp[e] - rl[F3_KV_QT + col]);
          if (edge) {
            const int key = key_lo + 8 * i, qpos = q0 + col + off;
            if (a.causal && qpos < 0) {
              p = key < a.Sk ? inv_sk : 0.f;
              ds = 0.f;
            } else if (key >= a.Sk || (a.causal && key > qpos)) {
              p = 0.f;
              ds = 0.f;
            }
          }
          sc[e] = p;
          dp[e] = ds;
        }
    // P^T's three register planes (the accumulator fragment of queries
    // [16 kb, 16 kb + 16) is the A fragment of the k-step kb), then dV +=
    // P^T dO (dO N-major), a 64-column chunk at a time; dS^T's planes only
    // after that, so that the two sets of planes are never live together.
    uint32_t pp[3][2][4];
#pragma unroll
    for (int kb = 0; kb < 2; ++kb)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split3_pair(sc[8 * kb + 2 * r], sc[8 * kb + 2 * r + 1], pp[0][kb][r],
                    pp[1][kb][r], pp[2][kb][r]);
#pragma unroll
    for (int c = 0; c < NVC; ++c) {
      float t[32];
      six_rs_n64(t, pp, stO + c * F3_KV_QT * BOX_BYTES_PER_ROW, S::O_PLANE);
#pragma unroll
      for (int i = 0; i < 32; ++i) dv[32 * c + i] += t[i];
    }
    if constexpr (ONE_O) {   // dO read for the last time: free its buffer
      __syncwarp();
      if (lane == 0) mbar_arrive(bar + 48);
    }
    // dK += dS^T Q (Q N-major)
    uint32_t dd[3][2][4];
#pragma unroll
    for (int kb = 0; kb < 2; ++kb)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split3_pair(dp[8 * kb + 2 * r], dp[8 * kb + 2 * r + 1], dd[0][kb][r],
                    dd[1][kb][r], dd[2][kb][r]);
#pragma unroll
    for (int c = 0; c < DPC; ++c) {
      float t[32];
      six_rs_n64(t, dd, stQ + c * F3_KV_QT * BOX_BYTES_PER_ROW, S::Q_PLANE);
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[32 * c + i] += t[i];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar + 8 * (3 + s));
  }

  if constexpr (DPC == 3) {
    if (a.group == 1) {
      // A group of one query head (MLA): dK and dV themselves, where the
      // group's sum would add this head's partial to zero.
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = key_lo + 8 * i;
        if (key >= a.Sk) continue;
        store_frag_row<DK>(a.dk + b * a.st.s[SDK] + h * a.st.s[SDK + 1] +
                               key * a.st.s[SDK + 2],
                           dk, i, q4, a.D, a.scale, a.pair_kv);
        store_frag_row<DV>(a.dv + b * a.st.s[SDV] + h * a.st.s[SDV + 1] +
                               key * a.st.s[SDV + 2],
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

// dQ of a query tile of 64 rows of one head (a CTA per (query tile, query
// head, batch); the tiles that see most keys first), in float32 on the
// tensor cores.  The producer warpgroup splits Q and dO into their planes
// once, then K and V of each tile of 32 keys the rows see into a two-stage
// ring (V into a buffer of its own at (192, 128): F3DqShape).  The
// consumer warpgroup runs S = Q K^T and dP = dO V^T (six products each),
// dS = P (dP - delta) in float32, split into three register planes, and
// dQ += dS K (K N-major), the six products into a fresh accumulator added
// to dQ in float32.
template <int DPC, int NVC>
__global__ void __launch_bounds__(F3_THREADS, 1)
attn_bwd_dq_f32_kernel(const F3Args a) {
  using S = F3DqShape<DPC, NVC>;
  constexpr int DK = DPC * 64;
  // Columns of dQ a fresh accumulator takes: all of them up to D = 128, a
  // 64-column chunk at a time at D = 192 (96 accumulators of dQ beside 96
  // of a whole-width product would pass 255 registers).
  constexpr int CW = DPC <= 2 ? DK : 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base_ptr =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(base_ptr);
  const uint32_t sQ = base, sO = base + S::O_OFF;
  const uint32_t sK = base + S::ST_OFF;    // stage s: + s STAGE; V v_off(s)
  const uint32_t bar = base + S::BAR_OFF;
  // qo_full = bar; full[s] = bar + 8 (1 + s); empty[s] = bar + 8 (3 + s);
  // with one V buffer, v_full = bar + 40 and v_empty = bar + 48
  constexpr bool ONE_V = S::V_BUFS == 1;

  const int n_qt = (a.Sq + F3_DQ_ROWS - 1) / F3_DQ_ROWS;
  const int per = gridDim.x / n_qt;         // Hq x B
  const int qt = n_qt - 1 - blockIdx.x / per;
  const int h = (blockIdx.x % per) % a.Hq, b = (blockIdx.x % per) / a.Hq;
  const int hk = h / a.group;
  const int q0 = qt * F3_DQ_ROWS;
  const int off = a.Sk - a.Sq;
  int n_kt = (a.Sk + F3_DQ_KT - 1) / F3_DQ_KT;
  if (a.causal) {   // up to the last key a row of the tile sees
    const int q_last = off + min(q0 + F3_DQ_ROWS, a.Sq) - 1;
    n_kt = q_last < 0 ? 0 : min(n_kt, q_last / F3_DQ_KT + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(bar, 128);
    for (int s = 0; s < F3_STAGES; ++s) {
      mbar_init(bar + 8 * (1 + s), 128);
      mbar_init(bar + 8 * (3 + s), 4);
    }
    mbar_init(bar + 40, 128);
    mbar_init(bar + 48, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // Producer warpgroup; with one V buffer, a tile's V follows its K once
    // the consumer has freed the buffer (after the last tile's dP).
    const int t = threadIdx.x - 128;
    split_tile<F3_DQ_ROWS, DPC, 128>(
        base_ptr, S::Q_PLANE, a.q + b * a.st.s[SQ] + h * a.st.s[SQ + 1],
        a.st.s[SQ + 2], q0, a.Sq, a.D, t);
    split_tile<F3_DQ_ROWS, NVC, 128>(
        base_ptr + S::O_OFF, S::O_PLANE,
        a.dout + b * a.st.s[SDO] + h * a.st.s[SDO + 1], a.st.s[SDO + 2], q0,
        a.Sq, a.Dv, t);
    fence_async_smem();
    mbar_arrive(bar);
    const float* kb = a.k + b * a.st.s[SKK] + hk * a.st.s[SKK + 1];
    const float* vb = a.v + b * a.st.s[SV] + hk * a.st.s[SV + 1];
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % F3_STAGES, round = kt / F3_STAGES;
      if (round > 0) mbar_wait(bar + 8 * (3 + s), (round - 1) & 1);
      uint8_t* st = base_ptr + S::ST_OFF + s * S::STAGE;
      split_tile<F3_DQ_KT, DPC, 128>(st, S::K_PLANE, kb, a.st.s[SKK + 2],
                                     kt * F3_DQ_KT, a.Sk, a.D, t);
      if constexpr (!ONE_V)
        split_tile<F3_DQ_KT, NVC, 128>(base_ptr + S::v_off(s), S::V_PLANE, vb,
                                       a.st.s[SV + 2], kt * F3_DQ_KT, a.Sk,
                                       a.Dv, t);
      fence_async_smem();
      mbar_arrive(bar + 8 * (1 + s));
      if constexpr (ONE_V) {
        if (kt > 0) mbar_wait(bar + 48, (kt - 1) & 1);
        split_tile<F3_DQ_KT, NVC, 128>(base_ptr + S::V_ONE, S::V_PLANE, vb,
                                       a.st.s[SV + 2], kt * F3_DQ_KT, a.Sk,
                                       a.Dv, t);
        fence_async_smem();
        mbar_arrive(bar + 40);
      }
    }
    return;
  }

  // Consumers: a thread holds rows r_lo and r_lo + 8 and, of each key
  // tile, keys k0 + 8 n + 2 q4 + j.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, q4 = lane & 3;
  const int r_lo = q0 + warp * 16 + g;
  const int first = off + q0;               // position of the tile's first row
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
    const int s = kt % F3_STAGES, phase = (kt / F3_STAGES) & 1;
    const int k0 = kt * F3_DQ_KT;
    const uint32_t stK = sK + s * S::STAGE, stV = base + S::v_off(s);
    mbar_wait(bar + 8 * (1 + s), phase);
    if constexpr (ONE_V) mbar_wait(bar + 40, kt & 1);

    // S = Q K^T and dP = dO V^T (64 rows x 32 keys each)
    float sc[16], dp[16];
    fence_regs(sc);
    fence_regs(dp);
    wg_fence();
    six_ss_n32<DPC>(sc, sQ, S::Q_PLANE, F3_DQ_ROWS, stK, S::K_PLANE);
    six_ss_n32<NVC>(dp, sO, S::O_PLANE, F3_DQ_ROWS, stV, S::V_PLANE);
    wg_commit();
    wg_wait0();
    fence_regs(sc);
    fence_regs(dp);
    if constexpr (ONE_V) {   // V read for the last time: free its buffer
      __syncwarp();
      if (lane == 0) mbar_arrive(bar + 48);
    }

    // dS = P (dP - delta), P = exp2(S scale log2(e) - lse); masked keys
    // (past the diagonal, past Sk, and every key of a row that sees none)
    // give 0.
    const bool edge =
        k0 + F3_DQ_KT > a.Sk || (a.causal && k0 + F3_DQ_KT - 1 > first);
#pragma unroll
    for (int n = 0; n < F3_DQ_KT / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 4 * n + 2 * i + j;
          float p = exp2f(sc[e] * a.scale_log2 - lse[i]);
          if (edge) {
            const int key = k0 + 8 * n + 2 * q4 + j;
            if (key >= a.Sk || (a.causal && key > qpos[i])) p = 0.f;
          }
          sc[e] = p * (dp[e] - dl[i]);
        }
    uint32_t dd[3][2][4];
#pragma unroll
    for (int kb = 0; kb < 2; ++kb)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split3_pair(sc[8 * kb + 2 * r], sc[8 * kb + 2 * r + 1], dd[0][kb][r],
                    dd[1][kb][r], dd[2][kb][r]);

    // dQ += dS K (K N-major: 8-key groups 1,024 bytes apart, 64-column
    // chunks F3_DQ_KT x 128 bytes apart), CW columns at a time, each into a
    // fresh accumulator
#pragma unroll
    for (int c0 = 0; c0 < DK; c0 += CW) {
      float t[CW / 2];
#pragma unroll
      for (int i = 0; i < CW / 2; ++i) t[i] = 0.f;
      fence_regs(t);
      wg_fence();
#pragma unroll
      for (int pr = 0; pr < 6; ++pr)
#pragma unroll
        for (int kb = 0; kb < 2; ++kb)
          wgmma_rs<CW>(
              t, dd[split_a(pr)][kb],
              sw128_desc(stK + split_b(pr) * S::K_PLANE +
                             (c0 / 64) * F3_DQ_KT * BOX_BYTES_PER_ROW +
                             kb * 2048,
                         F3_DQ_KT * BOX_BYTES_PER_ROW, 1024));
      wg_commit();
      wg_wait0();
      fence_regs(t);
#pragma unroll
      for (int i = 0; i < CW / 2; ++i) dq[c0 / 2 + i] += t[i];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar + 8 * (3 + s));
  }

  float* ob = a.dq + b * a.st.s[SDQ] + h * a.st.s[SDQ + 1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    if (r >= a.Sq) continue;
    float* orow = ob + (long long)r * a.st.s[SDQ + 2];
#pragma unroll
    for (int n = 0; n < DK / 8; ++n) {
      const int col = 8 * n + 2 * q4;
      const float x0 = dq[4 * n + 2 * i] * a.scale;
      const float x1 = dq[4 * n + 2 * i + 1] * a.scale;
      if (a.pair && col < a.D) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
      } else {
        if (col < a.D) orow[col] = x0;
        if (col + 1 < a.D) orow[col + 1] = x1;
      }
    }
  }
}

template <int DPC, int NVC>
int launch_bwd_f32(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   void* dq, void* dk, void* dv, float* dlt, float* wk,
                   float* wv, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                   int Dv, const long long* strides, float scale, int causal,
                   cudaStream_t stream) {
  using SK = F3DkvShape<DPC, NVC>;
  using SQ_ = F3DqShape<DPC, NVC>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_dkv_f32_kernel<DPC, NVC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SK::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_bwd_dq_f32_kernel<DPC, NVC>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SQ_::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  F3Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.lse = lse;
  a.dlt = dlt;
  a.wk = wk;
  a.wv = wv;
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  for (int i = 0; i < 24; ++i) a.st.s[i] = strides[i];
  a.Hq = Hq; a.group = Hq / Hkv; a.Sq = Sq; a.Sk = Sk; a.D = D; a.Dv = Dv;
  a.scale_log2 = scale * LOG2E;
  a.scale = scale;
  a.causal = causal;
  a.pair = D % 2 == 0 && strides[SDQ] % 2 == 0 &&
           strides[SDQ + 1] % 2 == 0 && strides[SDQ + 2] % 2 == 0 &&
           reinterpret_cast<uintptr_t>(dq) % 8 == 0;
  a.pair_kv = D % 2 == 0 && Dv % 2 == 0 &&
              reinterpret_cast<uintptr_t>(dk) % 8 == 0 &&
              reinterpret_cast<uintptr_t>(dv) % 8 == 0;
  for (int i = SDK; i < SDV + 3; ++i) a.pair_kv &= strides[i] % 2 == 0;

  const long long rows = (long long)B * Hq * Sq;
  attn_bwd_delta_kernel<float><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), dlt, Hq,
      Sq, Dv, a.st, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n_kt = (Sk + F3_KV_ROWS - 1) / F3_KV_ROWS;
  attn_bwd_dkv_f32_kernel<DPC, NVC>
      <<<n_kt * Hq * B, F3_THREADS, SK::SMEM, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n_qt = (Sq + F3_DQ_ROWS - 1) / F3_DQ_ROWS;
  attn_bwd_dq_f32_kernel<DPC, NVC>
      <<<n_qt * Hq * B, F3_THREADS, SQ_::SMEM, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || (DPC == 3 && Hq == Hkv)) return (int)err;

  const long long total = (long long)B * Hkv * Sk * (D + Dv);
  attn_bwd_dkv_reduce_kernel<float>
      <<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
          wk, wv, static_cast<float*>(dk), static_cast<float*>(dv), Hkv,
          Hq / Hkv, Sk, D, Dv, DPC * 64, NVC * 64, a.st, total);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hq, Sq, D), k (B, Hkv, Sk, D), v (B, Hkv, Sk, Dv), o and dout (B,
// Hq, Sq, Dv), dq, dk, dv of q's, k's and v's shapes, all float32, D in
// [1, 192] and Dv in [1, 128]; strides holds 24 element strides, (batch,
// head, position) of q, k, v, o, dout, dq, dk and dv; lse the forward's
// (B, Hq, Sq) float32 log-sum-exp (log2 domain); dlt a float32 workspace
// of B * Hq * Sq elements, wk and wv float32 workspaces of B * Hq * Sk *
// 64 * ceil(D / 64) and 64 * ceil(Dv / 64) elements (unread when D > 128
// and Hq == Hkv).  Returns cudaGetLastError() after the launches (0 on
// success).
extern "C" int flash_attention_bwd_f32(
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
#define FA_BWD_F32(DPC_, NVC_)                                              \
  if (dpc == DPC_ && nvc == NVC_)                                           \
    return launch_bwd_f32<DPC_, NVC_>(q, k, v, o, dout, lse, dq, dk, dv,    \
                                      dlt, wk, wv, B, Hq, Hkv, Sq, Sk, D,   \
                                      Dv, strides, scale, causal, s);
  FA_BWD_F32(1, 1) FA_BWD_F32(1, 2) FA_BWD_F32(2, 1) FA_BWD_F32(2, 2)
  FA_BWD_F32(3, 1) FA_BWD_F32(3, 2)
#undef FA_BWD_F32
  return (int)cudaErrorInvalidValue;
}
