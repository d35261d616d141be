// Causal GQA flash attention (forward) in float32 for the H100 (sm_90a), on
// the bf16 tensor cores at float32 accuracy: the float32 route of
// repro_torch/kernels/flash_attn/kernel.py:route (float32 with D <= 192 and
// Dv <= 128; float16 and mixed dtypes are read in float32).  It computes
// what flash_attn.cu's kernels compute (repro_torch/kernels/flash_attn/
// ref.py:mha: the same masks, rows that see no key, log2-domain online
// softmax and log-sum-exp), and with them replaces the Pallas TPU kernel
// repro/kernels/flash_attn/kernel.py:flash_attention (def at :72,
// pallas_call at :103).  A library of its own, so that nvcc builds it
// beside flash_attn.cu.
//
// Bound on the H100 SXM at (B, Hq, Hkv, S, D) = (1, 32, 4, 2048, 128),
// causal: 75.5 MB of float32 inputs and output (0.023 ms at 3.35 TB/s) and
// 34.4 GFLOP, 0.513 ms on the CUDA cores' 67 TFLOP/s and 0.209 ms at the
// float32-accurate tensor-core rate (six bf16 products for one float32
// product: 989 / 6 = 165 TFLOP/s).  Operations bound it.  At DeepSeek-V3's
// MLA prefill, (1, 128, 128, 511, 511), Dk 192, Dv 128: 10.7 GFLOP, 0.065
// ms at 165 TFLOP/s, against 0.050 ms for its 167 MB.
//
// flash_attention_f32_kernel: float32 with D <= 192 and Dv <= 128 (every
// float32 path of the repo, MLA's Dk of 192 among them).  TF32 (10 bits
// of mantissa) would miss the goldens' 2e-5, and TF32 wgmma takes only
// K-major operands; instead each float32 operand is split into three bf16
// parts (hopper.cuh: split_tile, split3_pair), x = hi + mid + lo, which
// carry its 24 bits, and each product is the six partial products hi hi,
// hi mid, mid hi, hi lo, mid mid, lo hi (the dropped three are below
// 2^-24 relative), issued small first, each exact in the float32
// accumulator.  The bf16 layouts and descriptors of flash_attn.cu's
// tensor-core kernel carry over: S's accumulator layout is P's register
// A-operand layout (P splits into three register planes), V's planes are
// read N-major.  The tensor cores' float32 accumulation drops low bits (on
// the card, a draft that summed every key tile into O itself drifted from
// a float64 reference as the keys grew), so P V of each tile goes into a
// fresh accumulator that is added to O in float32; S sums one tile's six
// products and is not carried.  chip_smoke.py's timing rows measure this
// kernel's distance from float64 beside the plain version's (f64_err).
//   * One CTA per (query tile of 128, query head, batch), heaviest first:
//     a producer warpgroup and two consumer warpgroups of 64 query rows
//     (384 threads; setmaxnreg gives the consumers 224 registers and the
//     producer 56).  The producer loads float32 rows with 16-byte loads,
//     splits them in registers and stores the three planes in TMA's
//     128-byte-swizzled layout (no landing buffer): Q once, then K and V
//     of each tile of KB keys into one buffer each, K of the next tile
//     while the consumers run the softmax and P V, V while they run S.
//   * Shared memory: three planes of Q (128 rows), of K and of V (KB keys).
//     Up to D = Dv = 128, KB = 64 (S = Q K^T an m64n64 product): 96 + 48 +
//     48 = 193 KB (two stages of K and V would pass 227 KB).  At D = 192
//     (DPC = 3) Q's planes alone take 144 KB, and 64-key tiles of K (72 KB)
//     and V (48 KB) would make 264 KB: KB = 32 keys, 144 + 36 + 24 = 205
//     KB, S an m64n32 product, P V two k-steps a tile.  The 128-row CTA
//     keeps two consumer warpgroups, which overlap one's softmax with the
//     other's products (64 rows and one warpgroup would fit 64-key tiles,
//     but leave the tensor cores idle during each softmax).
//   * Per 64-key tile a consumer warpgroup issues 48 wgmma for S (6
//     products x 8 k-steps) and 24 for P V at D = 128.  The same 34.4
//     GFLOP are 206 GFLOP of bf16 products: 0.209 ms at the bf16 peak.
// D > 192 or Dv > 128 in float32 takes flash_attn.cu's CUDA-core kernel.
//
// The kernel takes element strides for (batch, head, position) of q, k, v
// and out (the last axis contiguous, strides multiples of 8 elements, base
// pointers 16-byte aligned), as flash_attn.cu's do.

#include <math.h>

#include "hopper.cuh"   // mbarriers, wgmma, the three-way split

namespace {

constexpr float NEG = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;

constexpr int F3_QROWS = 128;     // query rows of a CTA, 64 a consumer warpgroup
constexpr int F3_THREADS = 384;   // two consumer warpgroups + a producer warpgroup
constexpr int F3_PRODUCER_REGS = 56;
constexpr int F3_CONSUMER_REGS = 224;

struct F3Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;          // (B, Hq, Sq) log-sum-exp (log2 domain), or null
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  int group, Sq, Sk, D, Dv;
  float scale_log2;
  int causal;
  int pair;            // even Dv and strides, 8-byte aligned out: float2 stores
};

// DPC, NVC: 64-column chunks of the depth (<= 3) and of the output (<= 2);
// KB: keys a tile (64, or 32 at DPC = 3).  Shared memory: the three planes
// of the CTA's Q (128 rows), of one K tile and of one V tile, each plane in
// TMA's 128-byte-swizzled boxes.
template <int DPC, int NVC, int KB>
struct F3Shape {
  static constexpr int Q_PLANE = DPC * F3_QROWS * BOX_BYTES_PER_ROW;
  static constexpr int K_PLANE = DPC * KB * BOX_BYTES_PER_ROW;
  static constexpr int V_PLANE = NVC * KB * BOX_BYTES_PER_ROW;
  static constexpr int K_OFF = 3 * Q_PLANE;
  static constexpr int V_OFF = K_OFF + 3 * K_PLANE;
  static constexpr int BAR_OFF = V_OFF + 3 * V_PLANE;
  static constexpr int SMEM = BAR_OFF + 64 + 1024;   // + barriers, alignment
  static_assert(SMEM <= 232448, "a CTA's shared memory");
};

// O = softmax(scale Q K^T) V in float32 on the bf16 tensor cores.  A CTA
// per (query tile of 128, query head, batch), heaviest first.  The producer
// warpgroup loads Q once and then, for each key tile, K and V in float32,
// splits each into three bf16 planes (split_tile) and stores them
// swizzled: one buffer of K and one of V, so that K of tile t + 1 is split
// while the consumers run the softmax and P V of tile t, and V of tile
// t + 1 while they run S of tile t + 1.  Each consumer warpgroup owns 64
// query rows: S = sum of the six partial products of Q K^T (wgmma, both
// from shared memory), the online softmax in float32, P split into three
// register planes (the accumulator layout of S is the A-operand layout),
// and the six partial products of P V (V's planes N-major) into a fresh
// float32 accumulator, which is added to O (rescaled by alpha) in float32,
// so that the tensor cores' accumulation only ever sums one tile's
// products.
template <int DPC, int NVC, int KB>
__global__ void __launch_bounds__(F3_THREADS, 1)
flash_attention_f32_kernel(const F3Args a) {
  using S = F3Shape<DPC, NVC, KB>;
  constexpr int DV = NVC * 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base_ptr =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(base_ptr);
  const uint32_t sQ = base, sK = base + S::K_OFF, sV = base + S::V_OFF;
  const uint32_t bar = base + S::BAR_OFF;
  // q_full = bar, k_full = bar + 8, v_full = bar + 16, k_empty = bar + 24,
  // v_empty = bar + 32

  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - blockIdx.x;              // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.group;
  const int q0 = qt * F3_QROWS;
  const int q_offset = a.Sk - a.Sq;
  int n_kt = (a.Sk + KB - 1) / KB;
  if (a.causal && q_offset + q0 >= 0) {   // else a row sees no key: walk all
    const int q_last = q_offset + min(q0 + F3_QROWS, a.Sq) - 1;
    n_kt = min(n_kt, q_last / KB + 1);
  }

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i, 128);  // producer threads
    mbar_init(bar + 24, 8);                                    // consumer warps
    mbar_init(bar + 32, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // Producer warpgroup: Q once, then K and V of each tile, each split
    // into its three planes by all 128 threads, which then arrive.
    regs_down<F3_PRODUCER_REGS>();
    const int t = threadIdx.x - 256;
    split_tile<F3_QROWS, DPC, 128>(base_ptr, S::Q_PLANE,
                                   a.q + b * a.qsb + h * a.qsh, a.qss, q0,
                                   a.Sq, a.D, t);
    fence_async_smem();
    mbar_arrive(bar);
    const float* kb = a.k + b * a.ksb + hk * a.ksh;
    const float* vb = a.v + b * a.vsb + hk * a.vsh;
    for (int kt = 0; kt < n_kt; ++kt) {
      if (kt > 0) mbar_wait(bar + 24, (kt - 1) & 1);
      split_tile<KB, DPC, 128>(base_ptr + S::K_OFF, S::K_PLANE, kb, a.kss,
                               kt * KB, a.Sk, a.D, t);
      fence_async_smem();
      mbar_arrive(bar + 8);
      if (kt > 0) mbar_wait(bar + 32, (kt - 1) & 1);
      split_tile<KB, NVC, 128>(base_ptr + S::V_OFF, S::V_PLANE, vb, a.vss,
                               kt * KB, a.Sk, a.Dv, t);
      fence_async_smem();
      mbar_arrive(bar + 16);
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows [q0 + 64 wg, q0 + 64 wg + 64);
  // a thread holds rows r_lo and r_lo + 8 of its warp's 16.
  regs_up<F3_CONSUMER_REGS>();
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, q4 = lane & 3;
  const int r_lo = q0 + wg * 64 + warp * 16 + g;
  const int qpos_lo = q_offset + r_lo, qpos_hi = qpos_lo + 8;
  const int wg_first = q_offset + q0 + wg * 64;
  const int wg_last = q_offset + min(q0 + wg * 64 + 63, a.Sq - 1);

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m_lo = NEG, m_hi = NEG, l_lo = 0.f, l_hi = 0.f;

  mbar_wait(bar, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int phase = kt & 1;
    const int k0 = kt * KB;
    // A warpgroup above its diagonal skips the tile but still waits for
    // each buffer before it releases it: its arrivals never run ahead of
    // the producer.
    const bool skip = a.causal && wg_first >= 0 && k0 > wg_last;
    float sc[KB / 2];
    mbar_wait(bar + 8, phase);
    if (!skip) {
      fence_regs(sc);
      wg_fence();
#pragma unroll
      for (int pr = 0; pr < 6; ++pr)
#pragma unroll
        for (int c = 0; c < DPC; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<KB>(
                sc,
                sw128_desc(sQ + split_a(pr) * S::Q_PLANE +
                               (c * F3_QROWS + wg * 64) * BOX_BYTES_PER_ROW +
                               kk * 32, 16, 1024),
                sw128_desc(sK + split_b(pr) * S::K_PLANE +
                               c * KB * BOX_BYTES_PER_ROW + kk * 32, 16,
                           1024),
                (pr | c | kk) ? 1 : 0);
      wg_commit();
      wg_wait0();
      fence_regs(sc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar + 24);

    uint32_t pa[3][KB / 16][4];
    float al_lo = 1.f, al_hi = 1.f;
    if (!skip) {
      // Scale to the log2 domain and mask: sc[4n + 2i + j] is row
      // r_lo + 8i, key k0 + 8n + 2 q4 + j.
      const bool edge =
          (k0 + KB > a.Sk) || (a.causal && k0 + KB - 1 > wg_first);
      float mx_lo = NEG, mx_hi = NEG;
#pragma unroll
      for (int n = 0; n < KB / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float x = sc[4 * n + 2 * i + j] * a.scale_log2;
            if (edge) {
              const int key = k0 + 8 * n + 2 * q4 + j;
              if (key >= a.Sk)
                x = -INFINITY;
              else if (a.causal && key > (i ? qpos_hi : qpos_lo))
                x = NEG;
            }
            sc[4 * n + 2 * i + j] = x;
            if (i) mx_hi = fmaxf(mx_hi, x);
            else mx_lo = fmaxf(mx_lo, x);
          }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      al_lo = exp2f(m_lo - mn_lo);
      al_hi = exp2f(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
      for (int n = 0; n < KB / 8; ++n) {
        sc[4 * n + 0] = exp2f(sc[4 * n + 0] - mn_lo);
        sc[4 * n + 1] = exp2f(sc[4 * n + 1] - mn_lo);
        sc[4 * n + 2] = exp2f(sc[4 * n + 2] - mn_hi);
        sc[4 * n + 3] = exp2f(sc[4 * n + 3] - mn_hi);
        rs_lo += sc[4 * n + 0] + sc[4 * n + 1];
        rs_hi += sc[4 * n + 2] + sc[4 * n + 3];
      }
      l_lo = l_lo * al_lo + rs_lo;   // this thread's columns; summed at the end
      l_hi = l_hi * al_hi + rs_hi;
      // P's three planes: the accumulator fragment of keys [16 kb, 16 kb +
      // 16) is the A fragment of the k-step kb.
#pragma unroll
      for (int kb = 0; kb < KB / 16; ++kb)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split3_pair(sc[8 * kb + 2 * r], sc[8 * kb + 2 * r + 1],
                      pa[0][kb][r], pa[1][kb][r], pa[2][kb][r]);
    }

    mbar_wait(bar + 16, phase);
    if (!skip) {
      // V: 8-key groups 1,024 bytes apart (SBO), 64-column chunks KB x
      // 128 bytes apart (LBO); a k-step is 16 keys.
      {
        float t[DV / 2];
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) t[i] = 0.f;
        fence_regs(t);
        wg_fence();
#pragma unroll
        for (int pr = 0; pr < 6; ++pr)
#pragma unroll
          for (int kb = 0; kb < KB / 16; ++kb)
            wgmma_rs<DV>(t, pa[split_a(pr)][kb],
                         sw128_desc(sV + split_b(pr) * S::V_PLANE + kb * 2048,
                                    KB * BOX_BYTES_PER_ROW, 1024));
        wg_commit();
        wg_wait0();
        fence_regs(t);
#pragma unroll
        for (int n = 0; n < DV / 8; ++n) {
          o[4 * n + 0] = fmaf(o[4 * n + 0], al_lo, t[4 * n + 0]);
          o[4 * n + 1] = fmaf(o[4 * n + 1], al_lo, t[4 * n + 1]);
          o[4 * n + 2] = fmaf(o[4 * n + 2], al_hi, t[4 * n + 2]);
          o[4 * n + 3] = fmaf(o[4 * n + 3], al_hi, t[4 * n + 3]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar + 32);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  if (a.lse != nullptr && q4 == 0) {
    float* lrow = a.lse + ((long long)b * gridDim.y + h) * a.Sq;
    if (r_lo < a.Sq) lrow[r_lo] = m_lo + log2f(l_lo);
    if (r_lo + 8 < a.Sq) lrow[r_lo + 8] = m_hi + log2f(l_hi);
  }
  float* ob = a.o + b * a.osb + h * a.osh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    if (r >= a.Sq) continue;
    float* orow = ob + (long long)r * a.oss;
    const float inv = i ? inv_hi : inv_lo;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      const int col = 8 * n + 2 * q4;
      const float x0 = o[4 * n + 2 * i] * inv, x1 = o[4 * n + 2 * i + 1] * inv;
      if (a.pair && col < a.Dv) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
      } else {
        if (col < a.Dv) orow[col] = x0;
        if (col + 1 < a.Dv) orow[col + 1] = x1;
      }
    }
  }
}

template <int DPC, int NVC, int KB>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int D,
               int Dv, const long long* st, float scale, int causal,
               cudaStream_t stream) {
  using S = F3Shape<DPC, NVC, KB>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_f32_kernel<DPC, NVC, KB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  F3Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<float*>(o);
  a.lse = lse;
  a.qsb = st[0]; a.qsh = st[1]; a.qss = st[2];
  a.ksb = st[3]; a.ksh = st[4]; a.kss = st[5];
  a.vsb = st[6]; a.vsh = st[7]; a.vss = st[8];
  a.osb = st[9]; a.osh = st[10]; a.oss = st[11];
  a.group = Hq / Hkv; a.Sq = Sq; a.Sk = Sk; a.D = D; a.Dv = Dv;
  a.scale_log2 = scale * LOG2E;
  a.causal = causal;
  a.pair = Dv % 2 == 0 && st[9] % 2 == 0 && st[10] % 2 == 0 &&
           st[11] % 2 == 0 && reinterpret_cast<uintptr_t>(o) % 8 == 0;
  const dim3 grid((Sq + F3_QROWS - 1) / F3_QROWS, Hq, B);
  flash_attention_f32_kernel<DPC, NVC, KB>
      <<<grid, F3_THREADS, S::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hq, Sq, D), k (B, Hkv, Sk, D), v (B, Hkv, Sk, Dv), out (B, Hq, Sq,
// Dv), all float32, 1 <= D <= 192 and 1 <= Dv <= 128 (the instance: DPC =
// ceil(D / 64), NVC = ceil(Dv / 64); 64-key tiles up to DPC = 2, 32-key
// tiles at DPC = 3); strides are 12 element strides, (batch, head,
// position) of q, k, v and out; lse null, or B * Hq * Sq floats that
// receive each row's log-sum-exp of the scaled logits in the log2 domain
// (the backward's input).  Returns cudaGetLastError() after the launch (0
// on success); the checks of shapes, strides and alignment are the Python
// wrapper's.
extern "C" int flash_attention_f32_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Sk, int D, int Dv, const long long* strides,
    float scale, int causal, float* lse, void* stream) {
  if (!(B > 0 && D > 0 && Dv > 0 && Hkv > 0 && Hq % Hkv == 0 && Sq > 0 &&
        Sk > 0 && D <= 192 && Dv <= 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dpc = (D + 63) / 64, nvc = (Dv + 63) / 64;
#define FA_F32(DPC_, NVC_, KB_)                                             \
  if (dpc == DPC_ && nvc == NVC_)                                           \
    return launch_f32<DPC_, NVC_, KB_>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, \
                                       D, Dv, strides, scale, causal, s);
  FA_F32(1, 1, 64) FA_F32(1, 2, 64) FA_F32(2, 1, 64) FA_F32(2, 2, 64)
  FA_F32(3, 1, 32) FA_F32(3, 2, 32)
#undef FA_F32
  return (int)cudaErrorInvalidValue;
}
