// Per-switch JSQ arbitration scan of the fast fabric engine, for Hopper
// (sm_90a).
//
// Replaces the lax.scan inside repro/net/fastsim.py:_jsq_layer (:224-243).
// That scan is not a Pallas kernel on the TPU (XLA compiles it); in eager
// PyTorch it would be a Python loop of `pad` steps of about a dozen
// launches each, so the port needs it as a kernel.
//
// Each (batch row, switch) walks its arrivals in rank order.  Per cell:
//   1. qlen = ceil(max(d_last - t, 0)) on every port;
//   2. the score: fmaf(nz, 1e-3f, qlen) for JSQ -- one rounding, as XLA
//      contracts `qlen + nz * 1e-3` -- or, for quantized JSQ, the number of
//      bin edges below qlen plus nz * 0.5 (exact either way);
//   3. plus the row's padded-port penalty (a separate rounding);
//   4. a first-occurrence argmin on (score, port);
//   5. the winner's d_last becomes max(t, d_last) + 1 when the cell holds a
//      packet (ok); the cell's outputs are the port, ok ? that departure : t,
//      and the winner's qlen.
// The file is built with --fmad=false and the adds are written as __fadd_rn,
// so no other multiply-add is contracted.
//
// Bound: bytes -- t, ok and h noise values read and port, departure and
// occupancy written per cell, 0.036 ms at the k=8 all-to-all's (2, 32,
// 57,408) grids of 4 ports at 3.35 TB/s.  What holds the kernel back is the
// chain of dependent steps (one a walked cell), not the bytes.  A port's
// d_last changes only on an occupied cell, so the chain ends at the
// row's last occupied cell J: every cell after J sees the frozen d_last and
// depends on nothing but its own t and noise.  The engine pads a switch's
// rank axis to 4x the mean load of its ports (fastsim.py:661), so about 75 %
// of a row lies after J.  The design:
//   * one CTA per row (512 threads; 64 CTAs at k=8 all-to-all);
//   * the block reduces J over its ok row first (no extra launch);
//   * warp 0 walks cells 0..J in order, interior empty cells included
//     (nothing assumes that occupied cells form a prefix);
//   * warps 1-3 stage the walk's t, ok and (for h <= 32) noise into a ring
//     of STAGES chunks of CHUNK cells in shared memory (cp.async, 4 bytes a
//     copy, any alignment), up to STAGES chunks ahead of the walk, each chunk
//     signalled by a `full` mbarrier; the walker buffers each chunk's three
//     outputs in the same stage and releases it through an `empty` mbarrier,
//     after which the stagers write them out in coalesced bursts and refill
//     the stage.  No load sits on the chain;
//   * the walk's step: for h <= 8 ports and <= 8 bin edges every lane holds
//     all the ports (`registers`: the scores, the bin counts and a tree
//     argmin in registers, the d_last update as selects; one instance per
//     4 or 8 ports and 0, 4 or 8 edges, so the step has no branch);
//     otherwise a lane group of the next power of two >= h lanes holds one
//     port a lane and reduces with width-limited __shfl_xor_sync (`lanes`;
//     at 32 lanes the ports past 32 stay in shared memory, read by the
//     lanes in turn, and their noise is read from device memory), any h up
//     to MAX_PORTS.  The whole walking warp runs the step, every lane (or
//     lane group) the same walk, so it stays converged: a branch in the
//     step, or lanes parked at the block barrier, made it several times
//     slower on the card;
//   * then the whole CTA computes the cells after J in parallel from the
//     frozen d_last (a thread a cell for h <= 32, a warp a cell past it).
// Shared memory: 8 h + 4 nq bytes and STAGES x CHUNK x (17 + 4 s) bytes, s
// the noise values staged a cell (the registers walk's 4 or 8 ports, the
// lanes walk's h up to 32, else none).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 512;        // warp 0 walks, warps 1-3 stage
constexpr int WARPS = THREADS / 32;
constexpr int STAGERS = 96;         // warps 1-3
constexpr int CHUNK = 256;          // cells a stage
constexpr int STAGES = 4;
constexpr float NEG = -1.0e9f;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of a block
constexpr int REG_PORTS = 8;        // the registers walk holds up to 8 ports
constexpr int REG_EDGES = 8;        // bin edges held in registers

enum Walk { REGISTERS, LANES };

// The quantization bin edges: the first REG_EDGES in registers (+inf past
// the last), all of them in shared memory.
struct Edges {
  float r[REG_EDGES];
  const float* s;
  int n;
  __device__ Edges(const float* s_thr, int nq) : s(s_thr), n(nq) {
#pragma unroll
    for (int q = 0; q < REG_EDGES; ++q) r[q] = q < nq ? s_thr[q] : INFINITY;
  }
};

// The score of one port (steps 2-3) at queue length qlen.
__device__ __forceinline__ float port_score(float qlen, float nz, float pen,
                                            const Edges& e) {
  float score;
  if (e.n == 0) {
    score = fmaf(nz, 1e-3f, qlen);
  } else {
    int bins = 0;
#pragma unroll
    for (int q = 0; q < REG_EDGES; ++q) bins += qlen > e.r[q];
    for (int q = REG_EDGES; q < e.n; ++q) bins += qlen > e.s[q];
    score = __fadd_rn((float)bins, __fmul_rn(nz, 0.5f));
  }
  return __fadd_rn(score, pen);
}

// port_score without a branch, for the registers walk: plain JSQ for NE =
// 0, else NE bin edges (padded with +inf), counted as a tree.
template <int NE>
__device__ __forceinline__ float port_score_regs(float qlen, float nz,
                                                 float pen,
                                                 const float (&thr)[NE + 1]) {
  if constexpr (NE == 0) {
    return __fadd_rn(fmaf(nz, 1e-3f, qlen), pen);
  } else {
    int c[NE];
#pragma unroll
    for (int q = 0; q < NE; ++q) c[q] = qlen > thr[q];
#pragma unroll
    for (int w = 1; w < NE; w <<= 1) {
#pragma unroll
      for (int i = 0; i + w < NE; i += 2 * w) c[i] += c[i + w];
    }
    return __fadd_rn(__fadd_rn((float)c[0], __fmul_rn(nz, 0.5f)), pen);
  }
}

__device__ __forceinline__ float queue_len(float d, float t) {
  return ceilf(fmaxf(__fsub_rn(d, t), 0.0f));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try(bar, parity)) {
  }
}

// The stagers run chunks ahead of the walk, so they wait asleep rather
// than poll the barrier.
__device__ __forceinline__ void mbar_wait_idle(uint64_t* bar,
                                               uint32_t parity) {
  while (!mbar_try(bar, parity)) __nanosleep(256);
}

// 4 bytes from device memory into shared memory, asynchronously.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}

// An arrival on bar once this thread's earlier cp.async copies have landed
// (counted in the barrier's expected arrivals: .noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

__host__ __device__ __forceinline__ int up16(int x) { return (x + 15) & ~15; }

// Noise values staged per cell: the registers walk's HP (ports past h
// zero), the lanes walk's h up to 32, none past (read from device memory).
__host__ __device__ __forceinline__ int staged_ports(int kind, int w, int h) {
  return kind == REGISTERS ? w : h <= 32 ? h : 0;
}

// Byte offsets of the dynamic shared memory.
struct Layout {
  int bars, red, d, pen, thr, stage0, stage;   // stage: bytes a stage
  int t, dep, occ, port, nz, ok;               // offsets inside a stage
  int hs, total;
  __host__ __device__ Layout(int h, int nq, int hs_) : hs(hs_) {
    bars = 0;
    red = 2 * STAGES * 8;
    d = up16(red + WARPS * 4);
    pen = up16(d + 4 * h);
    thr = up16(pen + 4 * h);
    stage0 = up16(thr + 4 * nq);
    t = 0;
    dep = t + 4 * CHUNK;
    occ = dep + 4 * CHUNK;
    port = occ + 4 * CHUNK;
    nz = port + 4 * CHUNK;
    ok = nz + 4 * CHUNK * hs;
    stage = up16(ok + CHUNK);
    total = stage0 + STAGES * stage;
  }
};

struct ScanArgs {
  const float* t;
  const uint8_t* ok;
  const float* noise;
  const float* port_pen;
  const float* thresholds;
  int nq, n_switches, pad, h;
  int32_t* port;
  float* dep;
  float* occ;
};

// A stage's arrays.
struct Stage {
  float* t;
  float* dep;
  float* occ;
  int32_t* port;
  float* nz;
  uint8_t* ok;
  __device__ Stage(unsigned char* smem, const Layout& L, int s) {
    unsigned char* base = smem + L.stage0 + s * L.stage;
    t = reinterpret_cast<float*>(base + L.t);
    dep = reinterpret_cast<float*>(base + L.dep);
    occ = reinterpret_cast<float*>(base + L.occ);
    port = reinterpret_cast<int32_t*>(base + L.port);
    nz = reinterpret_cast<float*>(base + L.nz);
    ok = base + L.ok;
  }
};

// The `registers` walk: HP >= h ports in each thread's registers, and NE
// >= nq bin edges (0: plain JSQ).  The whole warp runs it, every lane the
// same walk (converged, its shared loads broadcast, its stores to one
// address), and its step has no branch.  Ports past h get an infinite
// penalty and zero noise, so they never win.
template <int HP, int NE>
__device__ void walk_registers(unsigned char* smem, const Layout& L,
                               uint64_t* full, uint64_t* empty,
                               const ScanArgs& a, int n_walk) {
  const int h = a.h;
  const float* s_pen = reinterpret_cast<const float*>(smem + L.pen);
  const float* s_thr = reinterpret_cast<const float*>(smem + L.thr);
  float d[HP], pen[HP], thr[NE + 1];
#pragma unroll
  for (int p = 0; p < HP; ++p) {
    d[p] = NEG;
    pen[p] = p < h ? s_pen[p] : INFINITY;
  }
#pragma unroll
  for (int q = 0; q < NE; ++q) thr[q] = q < a.nq ? s_thr[q] : INFINITY;
  const int n_chunks = (n_walk + CHUNK - 1) / CHUNK;
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % STAGES;
    mbar_wait(&full[s], (c / STAGES) & 1);
    const Stage st(smem, L, s);
    const int n = min(CHUNK, n_walk - c * CHUNK);
    auto load_z = [&](int j, float (&z)[HP]) {   // HP / 4 16-byte loads
      const float4* v = reinterpret_cast<const float4*>(st.nz + j * HP);
#pragma unroll
      for (int i = 0; i < HP / 4; ++i) {
        const float4 x = v[i];
        z[4 * i] = x.x;
        z[4 * i + 1] = x.y;
        z[4 * i + 2] = x.z;
        z[4 * i + 3] = x.w;
      }
    };
    float t_n = st.t[0], z_n[HP];
    bool ok_n = st.ok[0] != 0;
    load_z(0, z_n);
    for (int j = 0; j < n; ++j) {
      const float t = t_n;
      const bool ok = ok_n;
      float z[HP];
#pragma unroll
      for (int p = 0; p < HP; ++p) z[p] = z_n[p];
      const int jn = min(j + 1, n - 1);   // the next cell's inputs, early
      t_n = st.t[jn];
      ok_n = st.ok[jn] != 0;
      load_z(jn, z_n);
      float sc[HP], q[HP], dd[HP];
      int ar[HP];
#pragma unroll
      for (int p = 0; p < HP; ++p) {
        q[p] = queue_len(d[p], t);
        sc[p] = port_score_regs<NE>(q[p], z[p], pen[p], thr);
        dd[p] = d[p];
        ar[p] = p;
      }
      // A tree argmin: the left half holds the lower ports and keeps ties,
      // so the first minimum wins.
#pragma unroll
      for (int w = 1; w < HP; w <<= 1) {
#pragma unroll
        for (int i = 0; i + w < HP; i += 2 * w) {
          const bool r = sc[i + w] < sc[i];
          sc[i] = r ? sc[i + w] : sc[i];
          ar[i] = r ? ar[i + w] : ar[i];
          q[i] = r ? q[i + w] : q[i];
          dd[i] = r ? dd[i + w] : dd[i];
        }
      }
      const float d_new = __fadd_rn(fmaxf(t, dd[0]), 1.0f);
#pragma unroll
      for (int p = 0; p < HP; ++p) d[p] = ok && ar[0] == p ? d_new : d[p];
      st.port[j] = ar[0];
      st.dep[j] = ok ? d_new : t;
      st.occ[j] = q[0];
    }
    mbar_arrive(&empty[s]);         // each lane: its reads are done
  }
  float* s_d = reinterpret_cast<float*>(smem + L.d);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < HP; ++p)
    if (p < h && lane == 0) s_d[p] = d[p];
}

// The `lanes` walk: groups of W lanes (a power of two), port l on lane l
// of a group; at W = 32 ports l + 32, l + 64, ... too, their d_last in
// shared memory.  Every group of the warp runs the same walk (the warp
// stays converged), and lane 0 writes.
template <int W>
__device__ void walk_lanes(unsigned char* smem, const Layout& L,
                           uint64_t* full, uint64_t* empty,
                           const ScanArgs& a, int64_t row, int n_walk) {
  const int lane = threadIdx.x & 31, pl = lane & (W - 1), h = a.h;
  const bool live = pl < h, ext = W == 32 && h > 32, staged = !ext;
  float* s_d = reinterpret_cast<float*>(smem + L.d);   // ports 32, ... too
  const float* s_pen = reinterpret_cast<const float*>(smem + L.pen);
  const Edges e(reinterpret_cast<const float*>(smem + L.thr), a.nq);
  const float* nz_row = a.noise + row * a.pad * (int64_t)h;
  float d_last = NEG;
  const float pen0 = live ? s_pen[pl] : 0.0f;
  const int n_chunks = (n_walk + CHUNK - 1) / CHUNK;
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % STAGES;
    mbar_wait(&full[s], (c / STAGES) & 1);
    const Stage st(smem, L, s);
    const int j0 = c * CHUNK;
    const int n = min(CHUNK, n_walk - j0);
    auto noise = [&](int j) {
      return !live ? 0.0f
             : staged ? st.nz[j * h + pl]
                      : nz_row[(int64_t)(j0 + j) * h + pl];
    };
    float t_n = st.t[0], nz_n = noise(0);
    bool ok_n = st.ok[0] != 0;
    for (int j = 0; j < n; ++j) {
      const float t = t_n, nz = nz_n;
      const bool ok = ok_n;
      const int jn = min(j + 1, n - 1);   // the next cell's inputs, early
      t_n = st.t[jn];
      ok_n = st.ok[jn] != 0;
      nz_n = noise(jn);
      const float qlen = queue_len(d_last, t);
      float best = live ? port_score(qlen, nz, pen0, e) : INFINITY;
      int arg = pl;
      if (ext) {
        const float* nz_cell = nz_row + (int64_t)(j0 + j) * h;
        for (int p = lane + 32; p < h; p += 32) {
          const float sc = port_score(queue_len(s_d[p], t), nz_cell[p],
                                      s_pen[p], e);
          if (sc < best) {          // ports in increasing order: the first
            best = sc;
            arg = p;
          }
        }
      }
#pragma unroll
      for (int off = W / 2; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(FULL, best, off, W);
        const int oa = __shfl_xor_sync(FULL, arg, off, W);
        if (ob < best || (ob == best && oa < arg)) {
          best = ob;
          arg = oa;
        }
      }
      const int owner = arg & 31;
      float d_p = __shfl_sync(FULL, d_last, owner, W);
      float q_p = __shfl_sync(FULL, qlen, owner, W);
      if (W == 32 && arg >= 32) {   // every lane's arg is the same port
        d_p = s_d[arg];
        q_p = queue_len(d_p, t);
      }
      const float d_new = __fadd_rn(fmaxf(t, d_p), 1.0f);
      if (ext) {
        __syncwarp();               // every lane has read s_d[arg]
        if (ok && lane == owner) {
          if (arg < 32) d_last = d_new;
          else s_d[arg] = d_new;
        }
        __syncwarp();               // the store is seen by the next step
      } else {
        d_last = ok && pl == arg ? d_new : d_last;
      }
      st.port[j] = arg;             // the same values on every lane
      st.dep[j] = ok ? d_new : t;
      st.occ[j] = q_p;
    }
    mbar_arrive(&empty[s]);         // each lane: its reads are done
  }
  if (live && lane == pl) s_d[pl] = d_last;
}

// Warps 1-3: stage the walk's chunks and write its outputs back.
__device__ void stage_walk(unsigned char* smem, const Layout& L,
                           uint64_t* full, uint64_t* empty,
                           const ScanArgs& a, int64_t row, int n_walk) {
  const int pt = threadIdx.x - 32, h = a.h, hs = L.hs;
  const int64_t cell0 = row * a.pad;
  const float* t_row = a.t + cell0;
  const uint8_t* ok_row = a.ok + cell0;
  const float* nz_row = a.noise + cell0 * h;
  auto flush = [&](const Stage& st, int j0, int n) {
    for (int e = pt; e < n; e += STAGERS) {
      a.port[cell0 + j0 + e] = st.port[e];
      a.dep[cell0 + j0 + e] = st.dep[e];
      a.occ[cell0 + j0 + e] = st.occ[e];
    }
  };
  const int n_chunks = (n_walk + CHUNK - 1) / CHUNK;
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % STAGES, k = c / STAGES;
    const Stage st(smem, L, s);
    if (k > 0) {                    // the walk is done with chunk c - STAGES
      mbar_wait_idle(&empty[s], (k - 1) & 1);
      flush(st, (c - STAGES) * CHUNK, CHUNK);
    }
    const int j0 = c * CHUNK;
    const int n = min(CHUNK, n_walk - j0);
    for (int e = pt; e < n; e += STAGERS) {
      cp_async4(st.t + e, t_row + j0 + e);
      st.ok[e] = ok_row[j0 + e];
    }
    const float* src = nz_row + (int64_t)j0 * h;
    for (int e = pt; e < n * hs; e += STAGERS) {
      const int j = e / hs, p = e - j * hs;
      if (p < h) cp_async4(st.nz + e, src + j * h + p);
      else st.nz[e] = 0.0f;
    }
    cp_async_arrive(&full[s]);
    mbar_arrive(&full[s]);
  }
  for (int c = max(0, n_chunks - STAGES); c < n_chunks; ++c) {
    const int s = c % STAGES;
    mbar_wait_idle(&empty[s], (c / STAGES) & 1);
    flush(Stage(smem, L, s), c * CHUNK, min(CHUNK, n_walk - c * CHUNK));
  }
}

// KIND REGISTERS: W is the ports a thread holds (4 or 8) and NE the bin
// edges (0, 4 or 8); LANES: W the lanes of the group (4, 8, 16 or 32).
template <int KIND, int W, int NE = 0>
__global__ void __launch_bounds__(THREADS)
jsq_scan_kernel(const ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(a.h, a.nq, staged_ports(KIND, W, a.h));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + STAGES;
  int* s_red = reinterpret_cast<int*>(smem + L.red);
  float* s_d = reinterpret_cast<float*>(smem + L.d);
  float* s_pen = reinterpret_cast<float*>(smem + L.pen);
  float* s_thr = reinterpret_cast<float*>(smem + L.thr);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row = blockIdx.x;
  const int h = a.h, pad = a.pad;
  const int64_t cell0 = row * pad;
  const float* t_row = a.t + cell0;
  const uint8_t* ok_row = a.ok + cell0;
  const float* nz_row = a.noise + cell0 * h;
  const float* pen_row = a.port_pen + (row / a.n_switches) * h;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 2 * STAGERS);
      mbar_init(&empty[s], 32);     // the walking warp's lanes
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int p = tid; p < h; p += THREADS) {
    s_pen[p] = pen_row[p];
    s_d[p] = NEG;
  }
  for (int q = tid; q < a.nq; q += THREADS) s_thr[q] = a.thresholds[q];
  // J, the row's last occupied cell (-1 if none): 16-byte vectors over the
  // aligned middle of the ok row.
  int last = -1;
  const uintptr_t oa = reinterpret_cast<uintptr_t>(ok_row);
  const int head = min((int)((16 - (oa & 15)) & 15), pad);
  const int nv = (pad - head) >> 4;
  const uint4* ov = reinterpret_cast<const uint4*>(ok_row + head);
  for (int j = tid; j < head; j += THREADS)
    if (ok_row[j]) last = max(last, j);
#pragma unroll 4
  for (int v = tid; v < nv; v += THREADS) {
    const uint4 x = ov[v];
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (w[i])
        last = max(last, head + 16 * v + 4 * i + (31 - __clz(w[i])) / 8);
  }
  for (int j = head + 16 * nv + tid; j < pad; j += THREADS)
    if (ok_row[j]) last = max(last, j);
  last = __reduce_max_sync(FULL, last);
  if (lane == 0) s_red[warp] = last;
  __syncthreads();
  int n_walk = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) n_walk = max(n_walk, s_red[w] + 1);

  // Each warp takes its role whole: the barriers below see converged warps.
  if (warp == 0) {
    if constexpr (KIND == REGISTERS)
      walk_registers<W, NE>(smem, L, full, empty, a, n_walk);
    else
      walk_lanes<W>(smem, L, full, empty, a, row, n_walk);
  } else if (warp <= 3) {
    stage_walk(smem, L, full, empty, a, row, n_walk);
  }
  __syncthreads();

  // The cells after J: no packet, so d_last is frozen and dep = t.
  const Edges e(s_thr, a.nq);
  if (h <= 32) {
    for (int j = n_walk + tid; j < pad; j += THREADS) {
      const float t = t_row[j];
      const float* z = nz_row + (int64_t)j * h;
      float best = 0.0f, qb = 0.0f;
      int arg = 0;
      for (int p = 0; p < h; ++p) {
        const float q = queue_len(s_d[p], t);
        const float sc = port_score(q, z[p], s_pen[p], e);
        if (p == 0 || sc < best) {
          best = sc;
          arg = p;
          qb = q;
        }
      }
      a.port[cell0 + j] = arg;
      a.dep[cell0 + j] = t;
      a.occ[cell0 + j] = qb;
    }
  } else {
    for (int j = n_walk + warp; j < pad; j += WARPS) {
      const float t = t_row[j];
      const float* z = nz_row + (int64_t)j * h;
      float best = INFINITY;
      int arg = lane;
      for (int p = lane; p < h; p += 32) {
        const float sc = port_score(queue_len(s_d[p], t), z[p], s_pen[p], e);
        if (p == lane || sc < best) {
          best = sc;
          arg = p;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(FULL, best, off);
        const int oa2 = __shfl_xor_sync(FULL, arg, off);
        if (ob < best || (ob == best && oa2 < arg)) {
          best = ob;
          arg = oa2;
        }
      }
      if (lane == 0) {
        a.port[cell0 + j] = arg;
        a.dep[cell0 + j] = t;
        a.occ[cell0 + j] = queue_len(s_d[arg], t);
      }
    }
  }
}

template <int KIND, int W, int NE = 0>
int launch(const ScanArgs& a, int64_t n_rows, cudaStream_t stream) {
  const int smem = Layout(a.h, a.nq, staged_ports(KIND, W, a.h)).total;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        jsq_scan_kernel<KIND, W, NE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  jsq_scan_kernel<KIND, W, NE><<<(unsigned)n_rows, THREADS, smem, stream>>>(
      a);
  return (int)cudaGetLastError();
}

// The registers walk's instance for h <= 8 ports and nq <= 8 edges.
int launch_registers(const ScanArgs& a, int64_t n_rows, cudaStream_t s) {
  if (a.h <= 4) {
    if (a.nq == 0) return launch<REGISTERS, 4, 0>(a, n_rows, s);
    return a.nq <= 4 ? launch<REGISTERS, 4, 4>(a, n_rows, s)
                     : launch<REGISTERS, 4, 8>(a, n_rows, s);
  }
  if (a.nq == 0) return launch<REGISTERS, 8, 0>(a, n_rows, s);
  return a.nq <= 4 ? launch<REGISTERS, 8, 4>(a, n_rows, s)
                   : launch<REGISTERS, 8, 8>(a, n_rows, s);
}

}  // namespace

extern "C" {

// Grids are (n_rows = batch * n_switches, pad); noise is (n_rows, pad, h);
// port_pen is (batch, h); thresholds holds nq floats (nq = 0: plain JSQ).
// The registers walk takes h <= 8 ports and nq <= 8 edges, the lanes walk
// the rest.  Returns cudaGetLastError() after the launch.
int jsq_scan(const void* t_grid, const void* ok_grid, const void* noise,
             const void* port_pen, const void* thresholds, int nq,
             int64_t n_rows, int n_switches, int pad, int h,
             void* port_out, void* dep_out, void* occ_out, void* stream) {
  if (h < 1 || nq < 0 || pad < 1 || n_rows < 1 || n_rows > INT_MAX ||
      n_switches < 1)
    return (int)cudaErrorInvalidValue;
  ScanArgs a;
  a.t = static_cast<const float*>(t_grid);
  a.ok = static_cast<const uint8_t*>(ok_grid);
  a.noise = static_cast<const float*>(noise);
  a.port_pen = static_cast<const float*>(port_pen);
  a.thresholds = static_cast<const float*>(thresholds);
  a.nq = nq;
  a.n_switches = n_switches;
  a.pad = pad;
  a.h = h;
  a.port = static_cast<int32_t*>(port_out);
  a.dep = static_cast<float*>(dep_out);
  a.occ = static_cast<float*>(occ_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h <= REG_PORTS && nq <= REG_EDGES)
    return launch_registers(a, n_rows, s);
  if (h <= 4) return launch<LANES, 4>(a, n_rows, s);
  if (h <= 8) return launch<LANES, 8>(a, n_rows, s);
  if (h <= 16) return launch<LANES, 16>(a, n_rows, s);
  return launch<LANES, 32>(a, n_rows, s);
}

}  // extern "C"
