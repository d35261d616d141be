// Per-switch JSQ arbitration scan of the fast fabric engine, for Hopper
// (sm_90a).
//
// Replaces the lax.scan inside repro/net/fastsim.py:_jsq_layer (:224-243).
// That scan is not a Pallas kernel on the TPU (XLA compiles it); in eager
// PyTorch it would be a Python loop of `pad` steps of about a dozen
// launches each, so the port needs it as a kernel.
//
// Each (batch row, switch) walks its arrivals in rank order.  One warp
// serves one switch and one lane one output port (h <= 32).  Per step:
//   1. qlen = ceil(max(d_last - t, 0)) on every port;
//   2. the score: fmaf(nz, 1e-3f, qlen) for JSQ -- one rounding, as XLA
//      contracts `qlen + nz * 1e-3` -- or, for quantized JSQ, the number of
//      bin edges below qlen plus nz * 0.5 (exact either way);
//   3. plus the row's padded-port penalty (a separate rounding);
//   4. a first-occurrence argmin over lanes on (score, lane);
//   5. the winner's d_last becomes max(t, d_last) + 1 when the cell holds a
//      packet.
// The file is built with --fmad=false and the adds are written as __fadd_rn,
// so no other multiply-add is contracted.
//
// Bound: the chain of `pad` dependent steps per switch, each a few shuffle
// rounds; the bytes (read t, ok, h noise values, write port, departure,
// occupancy per cell) would take far less time at 3.35 TB/s.  The next
// step's inputs are loaded one step ahead to keep the loads off the chain.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS_PER_BLOCK = 4;
constexpr float NEG = -1.0e9f;

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
jsq_scan_kernel(const float* __restrict__ t_grid,
                const uint8_t* __restrict__ ok_grid,
                const float* __restrict__ noise,
                const float* __restrict__ port_pen,
                const float* __restrict__ thresholds, int nq,
                int64_t n_rows, int n_switches, int pad, int h,
                int32_t* __restrict__ port_out, float* __restrict__ dep_out,
                float* __restrict__ occ_out) {
  const int64_t row =
      (int64_t)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // uniform across the warp
  const bool live = lane < h;
  const int64_t b = row / n_switches;
  const float pen = live ? port_pen[b * h + lane] : 0.0f;
  const float* t_row = t_grid + row * pad;
  const uint8_t* ok_row = ok_grid + row * pad;
  const float* nz_row = noise + row * pad * h;

  float d_last = NEG;
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
    const float qlen = ceilf(fmaxf(__fsub_rn(d_last, t), 0.0f));
    float score;
    if (nq == 0) {
      score = fmaf(nz, 1e-3f, qlen);
    } else {
      int bins = 0;
      for (int q = 0; q < nq; ++q) bins += qlen > thresholds[q];
      score = __fadd_rn((float)bins, __fmul_rn(nz, 0.5f));
    }
    float best = live ? __fadd_rn(score, pen) : INFINITY;
    int arg = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(FULL, best, off);
      const int oa = __shfl_xor_sync(FULL, arg, off);
      if (ob < best || (ob == best && oa < arg)) {
        best = ob;
        arg = oa;
      }
    }
    const float d_p = __shfl_sync(FULL, d_last, arg);
    const float q_p = __shfl_sync(FULL, qlen, arg);
    const float d_new = __fadd_rn(fmaxf(t, d_p), 1.0f);
    if (ok && lane == arg) d_last = d_new;
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
  if (h < 1 || h > 32 || pad < 1 || n_rows < 1 || n_switches < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n_rows + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  jsq_scan_kernel<<<(unsigned)blocks, WARPS_PER_BLOCK * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t_grid), static_cast<const uint8_t*>(ok_grid),
      static_cast<const float*>(noise), static_cast<const float*>(port_pen),
      static_cast<const float*>(thresholds), nq, n_rows, n_switches, pad, h,
      static_cast<int32_t*>(port_out), static_cast<float*>(dep_out),
      static_cast<float*>(occ_out));
  return (int)cudaGetLastError();
}

}  // extern "C"
