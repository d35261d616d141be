// Per-switch JSQ arbitration scan of the fast fabric engine, for Hopper
// (sm_90a).
//
// Replaces the lax.scan inside repro/net/fastsim.py:_jsq_layer (:224-243).
// That scan is not a Pallas kernel on the TPU (XLA compiles it); in eager
// PyTorch it would be a Python loop of `pad` steps of about a dozen
// launches each, so the port needs it as a kernel.
//
// Each (batch row, switch) walks its arrivals in rank order.  One warp
// serves one switch; lane l serves ports l, l + 32, l + 64, ... (any h).
// The ports' last departures d_last live in registers for the first 32
// ports (one a lane) and in shared memory past them, h - 32 floats a warp;
// h <= 32 compiles to a variant with no shared memory and no port loop.
// Per step:
//   1. qlen = ceil(max(d_last - t, 0)) on every port;
//   2. the score: fmaf(nz, 1e-3f, qlen) for JSQ -- one rounding, as XLA
//      contracts `qlen + nz * 1e-3` -- or, for quantized JSQ, the number of
//      bin edges below qlen plus nz * 0.5 (exact either way);
//   3. plus the row's padded-port penalty (a separate rounding);
//   4. a first-occurrence argmin on (score, port): each lane keeps the first
//      minimum of its ports (strict <, ports in increasing order), then the
//      warp combines the lanes, ties going to the lower port;
//   5. the winner's d_last becomes max(t, d_last) + 1 when the cell holds a
//      packet.
// The file is built with --fmad=false and the adds are written as __fadd_rn,
// so no other multiply-add is contracted.
//
// Bound: the chain of `pad` dependent steps per switch, each a few shuffle
// rounds; the bytes (read t, ok, h noise values, write port, departure,
// occupancy per cell) would take far less time at 3.35 TB/s.  The next
// step's t, ok and first-port noise are loaded one step ahead to keep the
// loads off the chain.  Shared memory: 4 (h - 32) floats a block (h <=
// 14,560 on the H100's 227 KB).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS_PER_BLOCK = 4;
constexpr float NEG = -1.0e9f;
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory of a block

// The score of one port (steps 2-3) at queue length qlen.
__device__ __forceinline__ float port_score(float qlen, float nz, float pen,
                                            int nq, const float* thresholds) {
  float score;
  if (nq == 0) {
    score = fmaf(nz, 1e-3f, qlen);
  } else {
    int bins = 0;
    for (int q = 0; q < nq; ++q) bins += qlen > thresholds[q];
    score = __fadd_rn((float)bins, __fmul_rn(nz, 0.5f));
  }
  return __fadd_rn(score, pen);
}

__device__ __forceinline__ float queue_len(float d, float t) {
  return ceilf(fmaxf(__fsub_rn(d, t), 0.0f));
}

// WIDE = false: h <= 32, one port a lane, all state in registers (the
// winner's state comes by shuffle).  WIDE = true: any h, ports past 32 in
// shared memory.  Both give the same bits.
template <bool WIDE>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
jsq_scan_kernel(const float* __restrict__ t_grid,
                const uint8_t* __restrict__ ok_grid,
                const float* __restrict__ noise,
                const float* __restrict__ port_pen,
                const float* __restrict__ thresholds, int nq,
                int64_t n_rows, int n_switches, int pad, int h,
                int32_t* __restrict__ port_out, float* __restrict__ dep_out,
                float* __restrict__ occ_out) {
  extern __shared__ float s_dlast[];   // [WARPS_PER_BLOCK][h - 32]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * WARPS_PER_BLOCK + warp;
  if (row >= n_rows) return;  // uniform across the warp
  const int n_ext = WIDE ? h - 32 : 0;
  float* d_ext = s_dlast + (int64_t)warp * n_ext;   // ports 32, 33, ...
  if (WIDE) {
    for (int p = lane; p < n_ext; p += 32) d_ext[p] = NEG;
    __syncwarp();
  }
  float d_last = NEG;               // port `lane`
  const bool live = lane < h;
  const int64_t b = row / n_switches;
  const float* pen_row = port_pen + b * h;
  const float pen0 = live ? pen_row[lane] : 0.0f;
  const float* t_row = t_grid + row * pad;
  const uint8_t* ok_row = ok_grid + row * pad;
  const float* nz_row = noise + row * pad * h;

  float t_next = t_row[0];
  bool ok_next = ok_row[0] != 0;
  float nz_next = live ? nz_row[lane] : 0.0f;
  for (int j = 0; j < pad; ++j) {
    const float t = t_next;
    const bool ok = ok_next;
    const float nz = nz_next;
    if (j + 1 < pad) {
      t_next = t_row[j + 1];
      ok_next = ok_row[j + 1] != 0;
      nz_next = live ? nz_row[(int64_t)(j + 1) * h + lane] : 0.0f;
    }
    const float qlen = queue_len(d_last, t);
    const float sc0 = port_score(qlen, nz, pen0, nq, thresholds);
    float best = live ? sc0 : INFINITY;
    int arg = lane;
    if constexpr (WIDE) {
      const float* nz_cell = nz_row + (int64_t)j * h;
      for (int p = lane + 32; p < h; p += 32) {
        const float sc = port_score(queue_len(d_ext[p - 32], t), nz_cell[p],
                                    pen_row[p], nq, thresholds);
        if (sc < best) {            // ports in increasing order: the first
          best = sc;
          arg = p;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(FULL, best, off);
      const int oa = __shfl_xor_sync(FULL, arg, off);
      if (ob < best || (ob == best && oa < arg)) {
        best = ob;
        arg = oa;
      }
    }
    const int owner = WIDE ? arg & 31 : arg;
    float d_p = __shfl_sync(FULL, d_last, owner);
    float q_p = __shfl_sync(FULL, qlen, owner);
    if (WIDE && arg >= 32) {        // every lane's arg is a port of its own
      d_p = d_ext[arg - 32];
      q_p = queue_len(d_p, t);
    }
    const float d_new = __fadd_rn(fmaxf(t, d_p), 1.0f);
    if constexpr (WIDE) {
      __syncwarp();                 // every lane has read d_ext[arg - 32]
      if (ok && lane == owner) {
        if (arg < 32) d_last = d_new;
        else d_ext[arg - 32] = d_new;
      }
      __syncwarp();                 // the store is seen by the next step
    } else {
      if (ok && lane == arg) d_last = d_new;
    }
    if (lane == 0) {
      const int64_t cell = row * pad + j;
      port_out[cell] = arg;
      dep_out[cell] = ok ? d_new : t;
      occ_out[cell] = q_p;
    }
  }
}

}  // namespace

extern "C" {

// Grids are (n_rows = batch * n_switches, pad); noise is (n_rows, pad, h);
// port_pen is (batch, h); thresholds holds nq floats (nq = 0: plain JSQ).
// Returns cudaGetLastError() after the launch.
int jsq_scan(const void* t_grid, const void* ok_grid, const void* noise,
             const void* port_pen, const void* thresholds, int nq,
             int64_t n_rows, int n_switches, int pad, int h, void* port_out,
             void* dep_out, void* occ_out, void* stream) {
  const bool wide = h > 32;
  const int64_t smem = wide ? (int64_t)WARPS_PER_BLOCK * (h - 32) * 4 : 0;
  if (h < 1 || smem > SMEM_LIMIT || pad < 1 || n_rows < 1 || n_switches < 1)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        jsq_scan_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks = (n_rows + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  auto kernel = wide ? jsq_scan_kernel<true> : jsq_scan_kernel<false>;
  kernel<<<(unsigned)blocks, WARPS_PER_BLOCK * 32, (size_t)smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t_grid), static_cast<const uint8_t*>(ok_grid),
      static_cast<const float*>(noise), static_cast<const float*>(port_pen),
      static_cast<const float*>(thresholds), nq, n_rows, n_switches, pad, h,
      static_cast<int32_t*>(port_out), static_cast<float*>(dep_out),
      static_cast<float*>(occ_out));
  return (int)cudaGetLastError();
}

}  // extern "C"
