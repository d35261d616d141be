// Segmented running maximum (the Lindley max-plus scan) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/lindley/kernel.py
// (segmented_cummax, pallas_call at :61).  out[i] is the running maximum of
// v that restarts at every i whose flag is nonzero.  The fast fabric engine
// calls it for every FIFO queueing layer and every rank computation.
//
// The TPU kernel walks its grid in order and carries the open segment's max
// in SMEM from block to block.  Hopper's blocks run in no order, so the scan
// here is three launches over tiles of TILE elements:
//   1. tile_aggregate: each block reduces its tile to one (max since the
//      tile's last flag, has-flag) pair;
//   2. scan_aggregates: one block scans the tile pairs and writes each
//      tile's carry-in;
//   3. tile_apply: each block rescans its tile from its carry-in and writes
//      the output.
// Inside a tile each thread scans ITEMS consecutive elements, warps combine
// thread totals with shuffles, and the block combines warp totals through
// shared memory.  The combine (a, b) -> (b.f ? b.v : max(a.v, b.v), a.f|b.f)
// is associative and max is exact, so every scan tree gives the same bits
// as the sequential recursion.  max propagates NaN, as the reference's
// jnp.maximum does: a NaN holds from its position to the segment's end.
//
// Bound: memory.  The function reads v (4 B) and a flag (1 B as uint8, 4 B
// as int32) and writes out (4 B) per element: 9 B an element with uint8
// flags, about 17 us for 6.2 M elements at 3.35 TB/s.  This design reads
// the inputs twice (phases 1 and 3); a single pass with decoupled look-back
// would read them once.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;
constexpr unsigned FULL = 0xffffffffu;

struct Seg {
  float v;
  int f;
};

__device__ __forceinline__ Seg identity() { return Seg{-INFINITY, 0}; }

// max as jnp.maximum and torch.maximum take it: NaN if either operand is
// NaN (fmaxf alone would return the other operand).  NaN stays absorbing,
// so the combine below stays associative and order-insensitive.  One
// instruction (PTX max.NaN, sm_80 and later, giving the canonical NaN): the
// two isnan tests and selects it replaces cost the scan 18 % of its time
// on the card (tools/cummax_times.py).
__device__ __forceinline__ float nan_max(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// a precedes b.
__device__ __forceinline__ Seg combine(Seg a, Seg b) {
  return Seg{b.f ? b.v : nan_max(a.v, b.v), a.f | b.f};
}

// Inclusive scan of the block's THREADS * N items, N consecutive items per
// thread, after `carry` (the aggregate of everything before the block).
// Returns the block total, carry included.
template <int N>
__device__ Seg block_scan(Seg (&x)[N], Seg carry) {
  __shared__ Seg warp_total[THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 1; i < N; ++i) x[i] = combine(x[i - 1], x[i]);
  Seg t = x[N - 1];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    Seg o{__shfl_up_sync(FULL, t.v, off), __shfl_up_sync(FULL, t.f, off)};
    if (lane >= off) t = combine(o, t);
  }
  Seg before{__shfl_up_sync(FULL, t.v, 1), __shfl_up_sync(FULL, t.f, 1)};
  if (lane == 31) warp_total[warp] = t;
  __syncthreads();
  Seg pre = carry;
  Seg total = carry;
  for (int w = 0; w < THREADS / 32; ++w) {
    if (w < warp) pre = combine(pre, warp_total[w]);
    total = combine(total, warp_total[w]);
  }
  if (lane > 0) pre = combine(pre, before);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = combine(pre, x[i]);
  __syncthreads();  // warp_total may be reused by the next call
  return total;
}

template <typename F>
__device__ __forceinline__ void load_tile(const float* v, const F* flags,
                                          int64_t n, int64_t base,
                                          Seg (&x)[ITEMS]) {
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int64_t j = base + i;
    x[i] = j < n ? Seg{v[j], flags[j] != 0} : identity();
  }
}

template <typename F>
__global__ void __launch_bounds__(THREADS)
tile_aggregate(const float* v, const F* flags, int64_t n, Seg* agg) {
  Seg x[ITEMS];
  load_tile(v, flags, n, (int64_t)blockIdx.x * TILE + threadIdx.x * ITEMS, x);
  const Seg total = block_scan<ITEMS>(x, identity());
  if (threadIdx.x == 0) agg[blockIdx.x] = total;
}

// One block: carry_in[t] = aggregate of tiles 0..t-1.
__global__ void __launch_bounds__(THREADS)
scan_aggregates(const Seg* agg, int64_t n_tiles, Seg* carry_in) {
  Seg carry = identity();
  if (threadIdx.x == 0) carry_in[0] = identity();
  for (int64_t base = 0; base < n_tiles; base += TILE) {
    Seg x[ITEMS];
    const int64_t first = base + threadIdx.x * ITEMS;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      x[i] = first + i < n_tiles ? agg[first + i] : identity();
    carry = block_scan<ITEMS>(x, carry);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)
      if (first + i + 1 < n_tiles) carry_in[first + i + 1] = x[i];
  }
}

template <typename F>
__global__ void __launch_bounds__(THREADS)
tile_apply(const float* v, const F* flags, int64_t n, const Seg* carry_in,
           float* out) {
  Seg x[ITEMS];
  const int64_t base = (int64_t)blockIdx.x * TILE + threadIdx.x * ITEMS;
  load_tile(v, flags, n, base, x);
  block_scan<ITEMS>(x, carry_in[blockIdx.x]);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    if (base + i < n) out[base + i] = x[i].v;
}

template <typename F>
int launch(const float* v, const F* flags, int64_t n, float* out,
           void* scratch, cudaStream_t stream) {
  const int64_t n_tiles = (n + TILE - 1) / TILE;
  Seg* agg = static_cast<Seg*>(scratch);
  Seg* carry_in = agg + n_tiles;
  tile_aggregate<F><<<(unsigned)n_tiles, THREADS, 0, stream>>>(v, flags, n, agg);
  scan_aggregates<<<1, THREADS, 0, stream>>>(agg, n_tiles, carry_in);
  tile_apply<F><<<(unsigned)n_tiles, THREADS, 0, stream>>>(v, flags, n,
                                                           carry_in, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch bytes the caller allocates for n elements.
int64_t lindley_scratch_bytes(int64_t n) {
  return 2 * ((n + TILE - 1) / TILE) * (int64_t)sizeof(Seg);
}

int64_t lindley_tile() { return TILE; }

// flag_bytes: 1 (uint8 / bool flags) or 4 (int32 flags).  n > 0.
// Returns cudaGetLastError() after the launches.
int lindley_segmented_cummax(const void* v, const void* flags, int flag_bytes,
                             int64_t n, void* out, void* scratch,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* vf = static_cast<const float*>(v);
  float* o = static_cast<float*>(out);
  if (flag_bytes == 1)
    return launch(vf, static_cast<const uint8_t*>(flags), n, o, scratch, s);
  if (flag_bytes == 4)
    return launch(vf, static_cast<const int32_t*>(flags), n, o, scratch, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
