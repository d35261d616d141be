// Causal GQA flash attention (forward) for the H100 (sm_90a): a bf16
// tensor-core kernel (wgmma + TMA) and a CUDA-core kernel for float32.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attn/kernel.py:
// flash_attention (def at :72, pallas_call at :103, body _attn_kernel at
// :30-69).  Both kernels compute repro_torch/kernels/flash_attn/ref.py:mha:
//
//   out[b, h, i] = softmax_t(scale * q[b, h, i] . k[b, h / group, t]) v[...]
//
// over the keys t visible to query i: t < Sk and, when causal,
// t <= i + (Sk - Sq) (queries are the last Sq positions of the context, the
// KV-cache alignment of the reference).  Masked logits are -1e30 and the
// denominator is floored at 1e-30, as in the reference; the online softmax
// runs in float32 in the log2 domain.  Unlike the Pallas kernel (which
// refuses Sk % block_k != 0), the ragged last key tile is masked (its
// padding at -inf, so it weighs nothing in any row), so any Sk >= 1 works,
// with any depth D >= 1 of q and k and any width Dv >= 1 of v and the output
// (MLA's Dv != D).  Causal with Sq > Sk puts the first Sq - Sk queries at
// negative positions: they see no key, every logit of their row is -1e30,
// and, as in the reference, their output is the mean of v over all Sk keys.
// The causal loop stops at the last key tile any query of the block can see
// (the reference's causal tile skip, kernel.py:36-41), except in a block
// holding such a query, which walks every key tile; query tiles are
// scheduled heaviest first, and the KV head is h / group (GQA), so the
// group's query heads read the same K/V tiles, which the 50 MB L2 keeps.
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense tensor cores, 3.35 TB/s):
// at (B, Hq, Hkv, S, D) = (1, 32, 4, 2048, 128) bf16, causal, the inputs and
// output are 37.7 MB (0.011 ms) and the two products 34.4 GFLOP (0.035 ms),
// so operations bound it: only the tensor cores come near.
//
// flash_attention_wgmma_kernel: bf16, D <= 256 (every model of the repo).
// One CTA per (query tile of 128, column tile of the output, query head,
// batch) holds one producer warp and two consumer warpgroups of 64 query
// rows each (288 threads, one CTA an SM).
//   * Loads.  One thread of the producer warp issues TMA loads
//     (cp.async.bulk.tensor, 128-byte swizzle) of the Q tile once and of K
//     and V tiles of BK keys into a two-stage ring, each stage with a full
//     barrier for K, one for V and an empty barrier that the eight consumer
//     warps arrive on.  A tile is cut into boxes of 64 columns (the swizzle
//     span); the tensor maps are encoded on the host per call over the
//     strided (B, H, S, D) views (cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint, so the library needs no -lcuda).  TMA fills
//     rows past Sk and columns past D with zeros: the ragged key tail is then
//     masked, and the zero columns change no dot product.
//   * S = Q K^T: wgmma m64nBKk16 with both operands in shared memory (K-major
//     128-byte-swizzled descriptors), float32 accumulators in registers.
//   * Softmax in registers: each thread holds two rows of S; row maxima are
//     reduced over the four threads of a row.  The mask is applied only on
//     the ragged last tile and on tiles that cross the diagonal; tiles above
//     a warpgroup's diagonal are skipped.
//   * O += P V: P is rounded to bf16 in registers, where the accumulator
//     layout of S is already the register A-operand layout of wgmma, and V
//     is read from shared memory as an N-major (transposed) B operand.
//   * Head dims: Dp = D rounded up to 64.  Dp <= 128 uses BK = 128 keys;
//     Dp = 192 and 256 use BK = 64 to fit shared memory.  The output columns
//     of a CTA are at most 128, or 192 at Dp = 192 (the registers of its
//     accumulator): a wider Dv takes several CTAs, and each computes the
//     logits.
//   * Shared memory: Q 16 KB per 64 columns, each stage BK x (Dp + the CTA's
//     output columns) x 2 bytes: 160 KB at D = 128.
// Not yet done: FA3's scheduling (a producer warpgroup that hands its
// registers to the consumers by setmaxnreg -- a 288-thread CTA caps a
// thread at 168 -- so that Q K^T of the next tile can overlap the softmax,
// and ping-pong barriers between the two consumer warpgroups), a
// persistent grid, and fp8.
//
// flash_attention_kernel: float32 (the goldens' type, where TF32 would miss
// the 2e-5 tolerance) and bf16 with D > 256, on the float32 CUDA cores (67
// TFLOP/s peak).  One block of 256 threads per (query tile of 64, column
// tile of 128, query head, batch).  The logits are summed over D in chunks
// of 128 columns: the query chunk lives in shared memory as float,
// transposed (loaded once when D <= 128, else per key tile), K is staged
// transposed, each thread computes a 4 x 4 patch of the 64 x 64 logits with
// float4 shared loads; the online softmax uses 16-lane shuffles per row, P
// is staged transposed, then the block's 128 output columns of V are staged
// into the buffer of K and each thread accumulates a 4-row x 8-column patch.
// Columns past D load as zeros.  Shared memory is 87,040 bytes at
// D >= 128, two blocks an SM.
//
// Both kernels take element strides for (batch, head, position) of q, k, v
// and out (the last axis contiguous, strides multiples of 8 elements, base
// pointers 16-byte aligned; TMA needs 16-byte strides): the model passes its
// (B, S, H, D) projections as (B, H, S, D) views, with no transposing copy.

#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int BQ = 64;          // queries per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // a 16 x 16 grid: tr = row group, tc = column
constexpr int DC = 128;         // columns of a logit chunk and of an output tile
constexpr int NJ = DC / 16;     // output columns per thread
constexpr int QS = BQ + 4;      // row stride (floats) of the Q^T and P^T tiles
constexpr int KS = BK + 4;      // row stride (floats) of the K^T tile

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

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// The n (<= 8) elements at p, zeros after them; a full chunk is one 16-byte
// load (8-element aligned: the strides are multiples of 8 elements).
template <typename T>
__device__ __forceinline__ void load_upto8(const T* p, int n, float* x) {
  if (n >= 8) {
    load8(p, x);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = e < n ? load1(p + e) : 0.f;
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// The buffer of K^T (w rows) and of V (vw columns).
__host__ __device__ __forceinline__ int kv_floats(int w, int vw) {
  return w * KS > BK * vw ? w * KS : BK * vw;
}

// w = min(D, DC) and vw = min(Dv, DC), each rounded up to 8: the widest
// chunk of the logits' depth and of the output columns.
__host__ __device__ __forceinline__ size_t smem_bytes(int w, int vw) {
  return sizeof(float) *
         ((size_t)w * QS + kv_floats(w, vw) + (size_t)BK * QS);
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

// Columns [c0, c0 + n) of the rows [r0, r0 + BQ) of src (rows past n_rows
// and columns past n as zeros), transposed into dst[col][QS or KS]; it
// stages query and key tiles alike.
static_assert(BQ == BK, "stage_t stages tiles of BQ rows");
template <typename T>
__device__ __forceinline__ void stage_t(const T* src, long long rs, int r0,
                                        int n_rows, int c0, int n, float* dst,
                                        int ds) {
  const int nch = (n + 7) >> 3;
  for (int idx = threadIdx.x; idx < BQ * nch; idx += THREADS) {
    const int r = idx % BQ, ch = idx / BQ;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r0 + r < n_rows)
      load_upto8(src + (long long)(r0 + r) * rs + c0 + ch * 8, n - ch * 8, x);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[(ch * 8 + e) * ds + r] = x[e];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int group, int Sq, int Sk, int D, int Dv, int n_ct,
                       long long qsb, long long qsh, long long qss,
                       long long ksb, long long ksh, long long kss,
                       long long vsb, long long vsh, long long vss,
                       long long osb, long long osh, long long oss,
                       float scale_log2, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int wp = (min(D, DC) + 7) & ~7;
  float* Qt = smem;                    // [wp][QS]: a chunk of Q^T
  float* KV = Qt + wp * QS;            // [wp][KS]: K^T, then [BK][vwp]: V
  float* Pt = KV + kv_floats(wp, (min(Dv, DC) + 7) & ~7);  // [BK][QS]: P^T

  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  const int qt = gridDim.x / n_ct - 1 - blockIdx.x / n_ct;  // heaviest first
  const int c0 = (blockIdx.x % n_ct) * DC;     // the block's output columns
  const int vw = min(DC, Dv - c0);
  const int vwp = (vw + 7) & ~7;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int q_offset = Sk - Sq;
  const int n_dc = (D + DC - 1) / DC;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + (h / group) * ksh;
  const T* vb = v + b * vsb + (h / group) * vsh;
  T* ob = o + b * osb + h * osh;

  if (n_dc == 1) stage_t(qb, qss, q0, Sq, 0, D, Qt, QS);

  const int q_first = q_offset + q0;   // the block's earliest query position
  int n_kt = (Sk + BK - 1) / BK;
  if (causal && q_first >= 0) {        // else a row sees no key: walk all
    const int q_last = q_offset + min(q0 + BQ, Sq) - 1;
    n_kt = min(n_kt, q_last / BK + 1);
  }

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
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int dc = 0; dc < n_dc; ++dc) {
      const int d0 = dc * DC, dn = min(DC, D - d0);
      __syncthreads();   // the previous chunk's (or tile's V and P) reads
      if (n_dc > 1) stage_t(qb, qss, q0, Sq, d0, dn, Qt, QS);
      stage_t(kb, kss, k0, Sk, d0, dn, KV, KS);
      __syncthreads();
      const int dnp = (dn + 7) & ~7;
#pragma unroll 4
      for (int d = 0; d < dnp; ++d) {
        const float4 qa =
            *reinterpret_cast<const float4*>(Qt + d * QS + tr * 4);
        const float4 ka =
            *reinterpret_cast<const float4*>(KV + d * KS + tc * 4);
        const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
        const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
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
          if (kpos >= Sk) x = -INFINITY;
          else if (causal && kpos > qpos) x = NEG;
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

    const int nch = vwp >> 3;
    for (int idx = tid; idx < BK * nch; idx += THREADS) {
      const int c = idx / nch, ch = idx % nch;
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k0 + c < Sk)
        load_upto8(vb + (long long)(k0 + c) * vss + c0 + ch * 8,
                   vw - ch * 8, x);
      float4* dst = reinterpret_cast<float4*>(KV + c * vwp + ch * 8);
      dst[0] = make_float4(x[0], x[1], x[2], x[3]);
      dst[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(Pt + c * QS + tr * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      const float* vr = KV + c * vwp;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = tc + 16 * j;
        if (n < vw) {
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
      T* orow = ob + (long long)r * oss + c0;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = tc + 16 * j;
        if (n < vw) store1(orow + n, acc[i][j] / den);
      }
    }
  }
}

template <typename T>
int launch_cuda_cores(const void* q, const void* k, const void* v, void* o,
                      int B, int Hq, int Hkv, int Sq, int Sk, int D, int Dv,
                      const long long* st, float scale, int causal,
                      cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(DC, DC));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int n_ct = (Dv + DC - 1) / DC;
  const dim3 grid(((Sq + BQ - 1) / BQ) * n_ct, Hq, B);
  const size_t smem =
      smem_bytes((min(D, DC) + 7) & ~7, (min(Dv, DC) + 7) & ~7);
  flash_attention_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq / Hkv, Sq, Sk, D, Dv,
      n_ct,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core kernel: PTX helpers
// ---------------------------------------------------------------------------

constexpr int TC_QROWS = 128;                 // query rows of a CTA
constexpr int TC_THREADS = 288;               // two consumer warpgroups + a warp
constexpr int TC_STAGES = 2;
constexpr int BOX_BYTES_PER_ROW = 128;        // 64 bf16 columns: the swizzle span

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// A box of the 4-D tensor map (coordinates innermost first: column,
// position, head, batch) into shared memory; completion counts on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// wgmma.mma_async m64nNk16, float32 += bf16 x bf16: _ss reads A and B from
// shared memory (both K-major; acc = 0 overwrites D), _rs reads A from
// registers and B N-major (transposed) from shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int acc) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, acc);
  else wgmma_ss_n128(d, da, db, acc);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n192(d, a, db);
}

// ---------------------------------------------------------------------------
// Tensor-core kernel
// ---------------------------------------------------------------------------

struct TcArgs {
  __nv_bfloat16* o;
  long long osb, osh, oss;
  int group, Sq, Sk, Dv, n_ct;   // Dv: columns of v and the output
  float scale_log2;
  int causal;
  int pair;            // even Dv and strides, 4-byte aligned out: bf16x2 stores
};

// DPC: 64-column chunks of the logits' depth (Dp / 64); NVC: 64-column
// chunks of the CTA's output columns; KB: keys a tile.
template <int DPC, int NVC, int KB>
struct TcShape {
  static constexpr int Q_BYTES = DPC * TC_QROWS * BOX_BYTES_PER_ROW;
  static constexpr int K_BYTES = DPC * KB * BOX_BYTES_PER_ROW;
  static constexpr int V_BYTES = NVC * KB * BOX_BYTES_PER_ROW;
  static constexpr int BAR_OFF = Q_BYTES + TC_STAGES * (K_BYTES + V_BYTES);
  // 1,024 bytes of slack to align the base for the swizzle, 64 of barriers.
  static constexpr int SMEM = BAR_OFF + 64 + 1024;
};

template <int DPC, int NVC, int KB>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const TcArgs a) {
  using S = TcShape<DPC, NVC, KB>;
  constexpr int DV = NVC * 64;                 // the CTA's output columns
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = base + S::Q_BYTES;                      // + stage
  const uint32_t sV = sK + TC_STAGES * S::K_BYTES;            // + stage
  const uint32_t bar = base + S::BAR_OFF;
  const uint32_t q_full = bar;
  // k_full[s] = bar + 8 (1 + s), v_full[s] = bar + 8 (3 + s),
  // empty[s] = bar + 8 (5 + s).

  const int n_qt = gridDim.x / a.n_ct;
  const int qt = n_qt - 1 - blockIdx.x / a.n_ct;   // heaviest first
  const int ct = blockIdx.x % a.n_ct;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.group;
  const int q0 = qt * TC_QROWS;
  const int q_offset = a.Sk - a.Sq;
  int n_kt = (a.Sk + KB - 1) / KB;
  if (a.causal && q_offset + q0 >= 0) {   // else a row sees no key: walk all
    const int q_last = q_offset + min(q0 + TC_QROWS, a.Sq) - 1;
    n_kt = min(n_kt, q_last / KB + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(bar + 8 * (1 + s), 1);
      mbar_init(bar + 8 * (3 + s), 1);
      mbar_init(bar + 8 * (5 + s), 8);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // Producer: one thread issues every TMA load of the CTA.
    if (threadIdx.x != 256) return;
    mbar_expect_tx(q_full, S::Q_BYTES);
    for (int c = 0; c < DPC; ++c)
      tma_load(sQ + c * TC_QROWS * BOX_BYTES_PER_ROW, &tq, q_full, c * 64,
               q0, h, b);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % TC_STAGES, round = kt / TC_STAGES;
      if (round > 0) mbar_wait(bar + 8 * (5 + s), (round - 1) & 1);
      const uint32_t kf = bar + 8 * (1 + s), vf = bar + 8 * (3 + s);
      mbar_expect_tx(kf, S::K_BYTES);
      for (int c = 0; c < DPC; ++c)
        tma_load(sK + s * S::K_BYTES + c * KB * BOX_BYTES_PER_ROW, &tk, kf,
                 c * 64, kt * KB, hk, b);
      mbar_expect_tx(vf, S::V_BYTES);
      for (int c = 0; c < NVC; ++c)
        tma_load(sV + s * S::V_BYTES + c * KB * BOX_BYTES_PER_ROW, &tv, vf,
                 (ct * NVC + c) * 64, kt * KB, hk, b);
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows [q0 + 64 wg, q0 + 64 wg + 64);
  // a thread holds rows r_lo and r_lo + 8 of its warp's 16.
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

  mbar_wait(q_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % TC_STAGES, phase = (kt / TC_STAGES) & 1;
    const int k0 = kt * KB;
    // Every warpgroup waits for each stage's K, also where it skips the tile
    // (above its diagonal): its arrivals on the empty barrier then never run
    // ahead of the producer into the stage's next round.
    mbar_wait(bar + 8 * (1 + s), phase);
    if (!(a.causal && wg_first >= 0 && k0 > wg_last)) {
      float sc[KB / 2];
      fence_regs(sc);
      wg_fence();
#pragma unroll
      for (int c = 0; c < DPC; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = sw128_desc(
              sQ + (c * TC_QROWS + wg * 64) * BOX_BYTES_PER_ROW + kk * 32,
              16, 1024);
          const uint64_t db = sw128_desc(
              sK + s * S::K_BYTES + c * KB * BOX_BYTES_PER_ROW + kk * 32, 16,
              1024);
          wgmma_ss<KB>(sc, da, db, (c | kk) ? 1 : 0);
        }
      wg_commit();
      wg_wait0();
      fence_regs(sc);

      // Scale to the log2 domain and mask: sc[4n + 2i + j] is row
      // r_lo + 8i, key k0 + 8n + 2 q4 + j.
      const bool edge = (k0 + KB > a.Sk) || (a.causal && k0 + KB - 1 > wg_first);
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
      const float al_lo = exp2f(m_lo - mn_lo), al_hi = exp2f(m_hi - mn_hi);
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
      l_lo = l_lo * al_lo + rs_lo;     // this thread's columns; summed at the end
      l_hi = l_hi * al_hi + rs_hi;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        o[4 * n + 0] *= al_lo;
        o[4 * n + 1] *= al_lo;
        o[4 * n + 2] *= al_hi;
        o[4 * n + 3] *= al_hi;
      }
      // P in bf16: the accumulator fragment of keys [16 kb, 16 kb + 16) is
      // the A fragment of the k-step kb.
      uint32_t pa[KB / 16][4];
#pragma unroll
      for (int kb = 0; kb < KB / 16; ++kb)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kb][r] = pack_bf16(sc[8 * kb + 2 * r], sc[8 * kb + 2 * r + 1]);

      mbar_wait(bar + 8 * (3 + s), phase);
      fence_regs(o);
      wg_fence();
#pragma unroll
      for (int kb = 0; kb < KB / 16; ++kb) {
        // V: 8-key groups 1,024 bytes apart (SBO), 64-column chunks
        // KB x 128 bytes apart (LBO); a k-step is 16 keys.
        const uint64_t db = sw128_desc(sV + s * S::V_BYTES + kb * 2048,
                                       KB * BOX_BYTES_PER_ROW, 1024);
        wgmma_rs<DV>(o, pa[kb], db);
      }
      wg_commit();
      wg_wait0();
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar + 8 * (5 + s));
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  __nv_bfloat16* ob = a.o + b * a.osb + h * a.osh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    if (r >= a.Sq) continue;
    __nv_bfloat16* orow = ob + (long long)r * a.oss;
    const float inv = i ? inv_hi : inv_lo;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      const int col = ct * DV + 8 * n + 2 * q4;
      const float x0 = o[4 * n + 2 * i] * inv, x1 = o[4 * n + 2 * i + 1] * inv;
      if (a.pair && col < a.Dv) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < a.Dv) orow[col] = __float2bfloat16_rn(x0);
        if (col + 1 < a.Dv) orow[col + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The tensor map of a (B, H, S, D) bf16 view with element strides st
// (batch, head, position), in boxes of 64 columns x rows positions.
bool encode(CUtensorMap* map, const void* ptr, int B, int H, int S, int D,
            const long long* st, int rows) {
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DPC, int NVC, int KB>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int Hq, int Hkv, int Sq, int Sk, int D, int Dv,
                 const long long* st, float scale, int causal,
                 cudaStream_t stream) {
  using S = TcShape<DPC, NVC, KB>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_wgmma_kernel<DPC, NVC, KB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, B, Hq, Sq, D, st, TC_QROWS) ||
      !encode(&tk, k, B, Hkv, Sk, D, st + 3, KB) ||
      !encode(&tv, v, B, Hkv, Sk, Dv, st + 6, KB))
    return (int)cudaErrorInvalidValue;
  TcArgs a;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.osb = st[9]; a.osh = st[10]; a.oss = st[11];
  a.group = Hq / Hkv; a.Sq = Sq; a.Sk = Sk; a.Dv = Dv;
  a.n_ct = ((Dv + 63) / 64 + NVC - 1) / NVC;
  a.scale_log2 = scale * LOG2E;
  a.causal = causal;
  a.pair = Dv % 2 == 0 && st[9] % 2 == 0 && st[10] % 2 == 0 &&
           st[11] % 2 == 0 && reinterpret_cast<uintptr_t>(o) % 4 == 0;
  const dim3 grid(((Sq + TC_QROWS - 1) / TC_QROWS) * a.n_ct, Hq, B);
  flash_attention_wgmma_kernel<DPC, NVC, KB>
      <<<grid, TC_THREADS, S::SMEM, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

bool args_ok(int B, int Hq, int Hkv, int Sq, int Sk, int D, int Dv) {
  return B > 0 && D > 0 && Dv > 0 && Hkv > 0 && Hq % Hkv == 0 && Sq > 0 &&
         Sk > 0;
}

}  // namespace

// Both entry points: q (B, Hq, Sq, D), k (B, Hkv, Sk, D), v (B, Hkv, Sk,
// Dv), out (B, Hq, Sq, Dv); strides are 12 element strides, (batch, head,
// position) of q, k, v and out.  They return cudaGetLastError() after the
// launch (0 on success); the checks of shapes, strides and alignment are
// the Python wrapper's.
//
// dtype: 0 = float32, 1 = bfloat16; any D, Dv >= 1.
extern "C" int flash_attention_cuda_cores_fwd(
    int dtype, const void* q, const void* k, const void* v, void* o, int B,
    int Hq, int Hkv, int Sq, int Sk, int D, int Dv, const long long* strides,
    float scale, int causal, void* stream) {
  if (!args_ok(B, Hq, Hkv, Sq, Sk, D, Dv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_cuda_cores<float>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, Dv,
                                    strides, scale, causal, s);
  if (dtype == 1)
    return launch_cuda_cores<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D,
                                            Dv, strides, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// bfloat16, 1 <= D <= 256, any Dv >= 1.  The instance: DPC = ceil(D / 64)
// chunks of depth; the CTA's output chunks NVC = ceil(Dv / 64), at most 2
// (3 at DPC = 3, where 3 x 64 columns fit the registers beside 64 keys).
extern "C" int flash_attention_wgmma_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Sk, int D, int Dv, const long long* strides,
    float scale, int causal, void* stream) {
  if (!args_ok(B, Hq, Hkv, Sq, Sk, D, Dv) || D > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dpc = (D + 63) / 64;
  const int nvc = min((Dv + 63) / 64, dpc == 3 ? 3 : 2);
#define FA_WGMMA(DPC_, NVC_, KB_)                                          \
  if (dpc == DPC_ && nvc == NVC_)                                          \
    return launch_wgmma<DPC_, NVC_, KB_>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, \
                                         Dv, strides, scale, causal, s);
  FA_WGMMA(1, 1, 128) FA_WGMMA(1, 2, 128)
  FA_WGMMA(2, 1, 128) FA_WGMMA(2, 2, 128)
  FA_WGMMA(3, 1, 64) FA_WGMMA(3, 2, 64) FA_WGMMA(3, 3, 64)
  FA_WGMMA(4, 1, 64) FA_WGMMA(4, 2, 64)
#undef FA_WGMMA
  return (int)cudaErrorInvalidValue;
}
