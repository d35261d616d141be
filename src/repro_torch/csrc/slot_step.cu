// Slot-step kernels of the slotted feedback engine, for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of repro/kernels/slot_step/kernel.py:
//   slot_jsq_pick        <- jsq_pick         (kernel.py:126)
//   slot_enqueue         <- enqueue          (kernel.py:203)
//   slot_agg_jsq_enqueue <- agg_jsq_enqueue  (kernel.py:240)
//   slot_sack_update_scan <- sack_update_scan (kernel.py:281)
//   slot_sack_advance    <- sack_advance     (kernel.py:320)
// Every operand carries a leading row axis B (the fused megabatch); the
// plain versions are repro_torch/kernels/slot_step/ref.py.
//
// jsq_pick: one thread per (row, chooser), a loop over its h ports.  Per
// port: the queue length, Threefry-2x32 (20 rounds, native uint32) keyed
// k0 = seed_lo, k1 = seed_hi ^ ((site << 16) ^ lane), counter c0 = t,
// c1 = id, the uniform (x0 >> 8) * 2^-24, and the score
//   JSQ:       fmaf(nz, 1e-3f, len)  -- one rounding, as XLA:CPU contracts
//              `lens + nz * 1e-3` in the reference's engine;
//   quantized: #{edges < len} + nz * 0.5 (exact either way);
// then + pad_pen and + (dead ? 1e9 : 0), each rounded on its own
// (__fadd_rn; the file is built with --fmad=false).  A strict `<` keeps the
// first minimum, as jnp.argmin does.
// Bound: bytes -- per chooser the h queue lengths and dead flags read and
// one int written; the 20-round PRF per port is ~200 integer operations.
//
// Index rules of the enqueue (both kernels, as the reference's scatters):
// a lane reads the queue clip(aq, 0, nq - 1) (occupancy, head, alive) and
// ranks among the earlier enqueue-trying lanes of the same raw aq; its ring
// write and occupancy add go to tgt = aq, a negative aq wrapping once
// (aq + nq, JAX's index rule), and are dropped if tgt is still outside
// [0, nq); where two lanes write one cell (targets q and q - nq) the later
// lane wins (XLA's sequential scatter).  The engine's arrivals always
// target [0, nq).
//
// enqueue: one CTA per (row, tile of ENQ_QB = 16 queues), so the k=8
// slot's 6 rows of 640 queues give 240 CTAs on 132 SMs.  Bound: bytes --
// the row's ring buffers copied out of place (nq * cap ints read and
// written; 6 x 640 x 195 x 4 B = 3.0 MB each way at k=8) plus the lanes.
// One block per row (as agg_jsq_enqueue below) would leave 6 SMs to stream
// those 6 MB and rank each lane with a loop over all earlier lanes (O(M^2)).
// Here each CTA owns its queues' ring cells, occupancy and the per-lane
// outputs of the lanes whose clip(aq) it owns:
//   * it copies its queues' cells as one contiguous run of ENQ_QB * cap ints
//     (16-byte vectors over the aligned middle: cap = 195 leaves a queue's
//     own run unaligned), so the outputs are new tensors and a frozen row
//     comes out bitwise unchanged (the engine selects frozen rows with
//     torch.where);
//   * it walks the row's lanes in rounds of 256: each thread flags its
//     lane if it tries to enqueue into an owned queue (avalid and the
//     queue alive), a block prefix of per-warp ballots compacts the flagged
//     lanes in lane order, and one warp ranks them 32 at a time:
//     __match_any_sync on the raw aq groups equal keys, the rank is a
//     per-key counter plus the popcount of earlier peers, and the group's
//     first lane advances the counter.  Counters of owned keys (and of the
//     negative keys that wrap into owned queues) live in shared memory; a
//     key outside [0, nq) that wraps into no owned queue (only the first
//     and last tiles see them) is counted in an open-addressing hash table
//     in a global scratch, cleared by the CTA when it first needs it.  The
//     rank is O(M) work per CTA, and no result depends on the order of
//     atomics: the counters advance in lane order, and a shared-memory
//     atomicAdd only sums the ring writes of an owned queue;
//   * the ring writes land in owned cells only (the lanes of a negative
//     key that wraps into an owned queue are ranked by this CTA too, from
//     queue 0's occupancy and head), the later lane winning a shared cell
//     (__match_any_sync on the cell); qcnt' = qcnt + the writes counted.
// No grid sync, second launch or global atomic is needed.
//
// agg_jsq_enqueue: one block per row, lanes strided over the block, so any
// M works (M = 5,120 at k=16).  The block first copies the row's ring
// buffers and occupancy to the outputs (out of place, as above), then
// picks each lane's core sub-link with the jsq_pick body (ids = max(apk,
// 0), qbase = off1 + asw * h) from the start-of-slot occupancy, rewrites
// the target of agg-bound lanes and stages each lane's target queue and
// enqueue-try flag in shared memory.  A lane's rank is the count of earlier
// lanes that try the same queue -- the stable order by lane of the
// reference, an O(M^2) masked count, never the order of atomics.  Room,
// ring position (qhead + qcnt + rank) mod cap, the ring write, occupancy-
// after and the ECN mark are per lane; the occupancy add is an integer
// atomicAdd, whose result does not depend on order.  Where a negative
// target wraps onto a queue that other lanes also target, a lane skips its
// ring write if the colliding lane of the other key comes later (found by
// its rank; only rows with such a lane pay for the search).
// Bound: the row copy (NQ * cap ints read and written) by bytes, or the
// M^2 / 2 rank comparisons by operations at large M; a row runs on one SM.
//
// sack_update_scan: one block per row.  The block copies the row's receiver
// bitmap to the output (out of place, as above), sets out[pk] = 1 for every
// delivering lane (duplicate targets all write 1, so the order of the
// writes cannot matter), then gives each flow one warp: lane l holds the
// window entries w = l and w = l + 32, cand_w = min(cum + w, fsize - 1),
// and two ballots find the first entry not received.  The result is that
// entry's candidate, or cand_0 when all 64 are received (argmin's first
// occurrence).  A zero-size flow gives -1 without reading the bitmap.
// sack_advance: one thread per (row, flow), two rounds of the 4-wide
// running product of received bits, masked to cum + w < fsize.  Both are
// integer-only, without atomics.
// Bound: bytes -- the bitmap row read and written once, the lanes and the
// per-flow counters; a few integer operations per window entry.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t PARITY = 0x1BD11BDAu;
constexpr int PICK_THREADS = 128;
constexpr int ROW_THREADS = 512;
constexpr int MAX_EDGES = 8;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// First output word of Threefry-2x32 with 20 rounds.
__device__ __forceinline__ uint32_t threefry_x0(uint32_t k0, uint32_t k1,
                                                uint32_t c0, uint32_t c1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ PARITY};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
#pragma unroll
  for (int b = 0; b < 5; ++b) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl32(x1, rot[b & 1][i]) ^ x0;
    }
    x0 += ks[(b + 1) % 3];
    x1 += ks[(b + 2) % 3] + (uint32_t)(b + 1);
  }
  return x0;
}

struct PickArgs {
  const float* edges;  // quantization bin edges (nq of them)
  int nq;
  uint32_t site_key;   // site << 16
  uint32_t t;
  int h;
};

// Port of least score for one chooser (first occurrence on ties).
__device__ int pick_port(const int32_t* qcnt_row, int qbase, uint32_t id,
                         const uint8_t* dead, const float* pen,
                         uint32_t k0, uint32_t k1_site, const PickArgs& a) {
  float best = 0.0f;
  int arg = 0;
  for (int l = 0; l < a.h; ++l) {
    const float len = (float)qcnt_row[qbase + l];
    const uint32_t u = threefry_x0(k0, k1_site ^ (uint32_t)l, a.t, id);
    const float nz = __fmul_rn((float)(u >> 8), 5.9604644775390625e-08f);
    float score;
    if (a.nq == 0) {
      score = fmaf(nz, 1e-3f, len);
    } else {
      int bins = 0;
      for (int q = 0; q < a.nq; ++q) bins += len > a.edges[q];
      score = __fadd_rn((float)bins, __fmul_rn(nz, 0.5f));
    }
    score = __fadd_rn(score, pen[l]);
    score = __fadd_rn(score, dead[l] ? 1e9f : 0.0f);
    if (l == 0 || score < best) {
      best = score;
      arg = l;
    }
  }
  return arg;
}

__global__ void __launch_bounds__(PICK_THREADS)
jsq_pick_kernel(const int32_t* __restrict__ qcnt,
                const int32_t* __restrict__ qbase,
                const int32_t* __restrict__ ids,
                const uint8_t* __restrict__ dead,
                const float* __restrict__ pad_pen,
                const int32_t* __restrict__ seed_lo,
                const int32_t* __restrict__ seed_hi, PickArgs a, int rows,
                int m, int nq_queues, int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * PICK_THREADS + threadIdx.x;
  if (i >= (int64_t)rows * m) return;
  const int64_t b = i / m;
  out[i] = pick_port(qcnt + b * nq_queues, qbase[i], (uint32_t)ids[i],
                     dead + i * a.h, pad_pen + b * a.h, (uint32_t)seed_lo[b],
                     (uint32_t)seed_hi[b] ^ a.site_key, a);
}

// Copy one row's ring buffers and occupancy to the outputs.
__device__ void copy_row(const int32_t* qbuf, const int32_t* qcnt,
                         int64_t cells, int nq, int32_t* qbuf_out,
                         int32_t* qcnt_out) {
  for (int64_t c = threadIdx.x; c < cells; c += blockDim.x)
    qbuf_out[c] = qbuf[c];
  for (int q = threadIdx.x; q < nq; q += blockDim.x) qcnt_out[q] = qcnt[q];
}

// Floor modulo (torch.remainder, jnp's %) for cap >= 1.
__device__ __forceinline__ int floor_mod(int x, int cap) {
  const int r = x % cap;
  return r < 0 ? r + cap : r;
}

// The ring target of a lane's key: a negative key wraps once; -1 if still
// outside [0, nq).
__device__ __forceinline__ int ring_target(int key, int nq) {
  const int w = key < 0 ? key + nq : key;
  return w >= 0 && w < nq ? w : -1;
}

// The enqueue update of one row, after s_aq / s_try are staged and the row
// copied (callers __syncthreads() first; `alias` says whether a trying lane
// has a negative key that wraps into [0, nq)).
__device__ void enqueue_lanes(const int32_t* qhead, const int32_t* qcnt,
                              const int32_t* apk, const int32_t* s_aq,
                              const uint8_t* s_try, int m, int nq, int cap,
                              int ecn_thresh, bool alias, int32_t* qbuf_out,
                              int32_t* qcnt_out, uint8_t* enq_try,
                              uint8_t* do_enq, int32_t* occ_after,
                              uint8_t* marked) {
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int aq = s_aq[i];
    const bool tr = s_try[i] != 0;
    int rk = 0;
    if (tr) {
      for (int j = 0; j < i; ++j) rk += (s_try[j] != 0) & (s_aq[j] == aq);
    }
    const int aqc = min(max(aq, 0), nq - 1);
    const int qa = qcnt[aqc];
    const bool d = tr && (qa + rk < cap);
    const int tgt = ring_target(aq, nq);
    if (d && tgt >= 0) {
      const int pos = floor_mod(qhead[aqc] + qa + rk, cap);
      bool keep = true;
      if (alias) {
        // The other key writing queue tgt, and its rank that lands on pos.
        const int k2 = aq < 0 ? tgt : tgt - nq;
        const int c2 = min(max(k2, 0), nq - 1);
        const int r2 = floor_mod(pos - qhead[c2] - qcnt[c2], cap);
        if (qcnt[c2] + r2 < cap) {
          int seen = 0;
          for (int j = 0; j < m; ++j) {
            if (s_try[j] != 0 && s_aq[j] == k2) {
              if (seen == r2) {
                keep = j < i;
                break;
              }
              ++seen;
            }
          }
        }
      }
      if (keep) qbuf_out[(int64_t)tgt * cap + pos] = apk[i];
      atomicAdd(&qcnt_out[tgt], 1);
    }
    const int occ = qa + rk + 1;
    enq_try[i] = tr;
    do_enq[i] = d;
    occ_after[i] = occ;
    marked[i] = d && occ > ecn_thresh;
  }
}

constexpr int ENQ_THREADS = 256;
constexpr int ENQ_WARPS = ENQ_THREADS / 32;
constexpr int ENQ_QB = 16;      // queues an enqueue CTA owns
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Copy n ints; 16-byte vectors over the aligned middle when src and dst
// share their offset mod 16.
__device__ void copy_run(const int32_t* __restrict__ src,
                         int32_t* __restrict__ dst, int64_t n) {
  const uintptr_t sa = reinterpret_cast<uintptr_t>(src);
  if (((sa ^ reinterpret_cast<uintptr_t>(dst)) & 15) != 0) {
    for (int64_t c = threadIdx.x; c < n; c += blockDim.x) dst[c] = src[c];
    return;
  }
  const int64_t head = min((int64_t)(((16 - (sa & 15)) & 15) >> 2), n);
  const int64_t nv = (n - head) >> 2;
  const int4* sv = reinterpret_cast<const int4*>(src + head);
  int4* dv = reinterpret_cast<int4*>(dst + head);
#pragma unroll 4
  for (int64_t v = threadIdx.x; v < nv; v += blockDim.x) dv[v] = sv[v];
  for (int64_t c = threadIdx.x; c < head; c += blockDim.x) dst[c] = src[c];
  for (int64_t c = head + 4 * nv + threadIdx.x; c < n; c += blockDim.x)
    dst[c] = src[c];
}

// Slot of a key in an open-addressing table of `size` (a power of two)
// keys, 0 marking an empty slot (a hashed key is never 0).
__device__ int hash_slot(int32_t* keys, int size, int key) {
  unsigned h = ((unsigned)key * 2654435761u) & (unsigned)(size - 1);
  while (true) {
    const int cur = atomicCAS(&keys[h], 0, key);
    if (cur == 0 || cur == key) return (int)h;
    h = (h + 1) & (unsigned)(size - 1);
  }
}

struct EnqArgs {
  const int32_t* qbuf;
  const int32_t* qhead;
  const int32_t* qcnt;
  const uint8_t* alive;
  const int32_t* apk;
  const int32_t* aq;
  const uint8_t* avalid;
  int32_t* qbuf_out;
  int32_t* qcnt_out;
  uint8_t* enq_try;
  uint8_t* do_enq;
  int32_t* occ_after;
  uint8_t* marked;
  int32_t* hash;      // (rows, 2, 2 * hsize): keys, then counts
  int cap, ecn_thresh, m, nq, tiles, hsize;
};

__global__ void __launch_bounds__(ENQ_THREADS)
enqueue_kernel(const EnqArgs a) {
  __shared__ int32_t s_qa[ENQ_QB];       // occupancy of the owned queues
  __shared__ int32_t s_head[ENQ_QB];     // their ring heads
  __shared__ int32_t s_cnt[ENQ_QB];      // lanes ranked, key q0 + c
  __shared__ int32_t s_cntn[ENQ_QB];     // lanes ranked, key q0 + c - nq
  __shared__ int32_t s_hit[ENQ_QB];      // ring writes into q0 + c
  __shared__ int32_t s_lane[ENQ_THREADS];  // a round's lanes
  __shared__ int32_t s_key[ENQ_THREADS];   // and their keys
  __shared__ int32_t s_warp[2 * ENQ_WARPS];  // per-warp counts
  __shared__ uint8_t s_alive[ENQ_QB];

  const int nq = a.nq, m = a.m, cap = a.cap;
  const int64_t b = blockIdx.x / a.tiles;
  const int q0 = (int)(blockIdx.x % a.tiles) * ENQ_QB;
  const int nown = min(ENQ_QB, nq - q0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t* aq_b = a.aq + b * m;
  const uint8_t* av_b = a.avalid + b * m;
  // The first round's lanes load while the cells copy; each round loads
  // the next round's.
  int key_next = tid < m ? aq_b[tid] : 0;
  bool av_next = tid < m && av_b[tid] != 0;
  const int64_t cell0 = (b * nq + q0) * (int64_t)cap;
  copy_run(a.qbuf + cell0, a.qbuf_out + cell0, (int64_t)nown * cap);
  for (int c = tid; c < nown; c += ENQ_THREADS) {
    s_qa[c] = a.qcnt[b * nq + q0 + c];
    s_head[c] = a.qhead[b * nq + q0 + c];
    s_alive[c] = a.alive[b * nq + q0 + c];
    s_cnt[c] = s_cntn[c] = s_hit[c] = 0;
  }
  // Queue 0, which the lanes of a negative key read.
  const int qa0 = a.qcnt[b * nq], head0 = a.qhead[b * nq];
  const bool alive0 = a.alive[b * nq] != 0;
  int32_t* hkeys = a.hash + (b * 2 + (q0 == 0 ? 0 : 1)) * 2 * (int64_t)a.hsize;
  int32_t* hcnt = hkeys + a.hsize;
  bool hash_ready = false;
  __syncthreads();   // the copy is done before any ring write

  for (int base = 0; base < m; base += ENQ_THREADS) {
    const int i = base + tid;
    const int key = key_next;
    const bool av = av_next;
    if (i + ENQ_THREADS < m) {
      key_next = aq_b[i + ENQ_THREADS];
      av_next = av_b[i + ENQ_THREADS] != 0;
    }
    bool rel = false, hashed = false;
    if (i < m) {
      const int c = min(max(key, 0), nq - 1) - q0;
      const bool own = c >= 0 && c < nown;
      const int w = key < 0 ? key + nq : key;
      const bool wraps = key < 0 && w >= q0 && w < q0 + nown;
      if (own || wraps) {
        const bool tr = av && (own ? s_alive[c] != 0 : alive0);
        rel = tr;
        hashed = tr && !(key >= q0 && key < q0 + nown) && !wraps;
        if (own && !tr) {
          const int64_t li = b * m + i;
          a.enq_try[li] = 0;
          a.do_enq[li] = 0;
          a.occ_after[li] = s_qa[c] + 1;
          a.marked[li] = 0;
        }
      }
    }
    const unsigned bal = __ballot_sync(FULL, rel);
    const unsigned hb = __ballot_sync(FULL, hashed);
    if (lane == 0) {
      s_warp[warp] = __popc(bal);
      s_warp[ENQ_WARPS + warp] = __popc(hb);
    }
    __syncthreads();
    int off = 0, total = 0, n_hashed = 0;
#pragma unroll
    for (int w = 0; w < ENQ_WARPS; ++w) {
      off += w < warp ? s_warp[w] : 0;
      total += s_warp[w];
      n_hashed += s_warp[ENQ_WARPS + w];
    }
    if (rel) {
      const int k = off + __popc(bal & lanemask_lt());
      s_lane[k] = i;
      s_key[k] = key;
    }
    if (n_hashed > 0 && !hash_ready) {    // block-uniform
      for (int e = tid; e < 2 * a.hsize; e += ENQ_THREADS) hkeys[e] = 0;
      hash_ready = true;
    }
    __syncthreads();

    if (warp == 0) {
      for (int k0 = 0; k0 < total; k0 += 32) {
        const int k = k0 + lane;
        const unsigned vm = __ballot_sync(FULL, k < total);
        if (k < total) {
          const int li = s_lane[k], key = s_key[k];
          const unsigned peers = __match_any_sync(vm, key);
          const int leader = __ffs(peers) - 1;
          const int w = key < 0 ? key + nq : key;
          int* ctr;
          if (key >= q0 && key < q0 + nown) {
            ctr = &s_cnt[key - q0];
          } else if (key < 0 && w >= q0 && w < q0 + nown) {
            ctr = &s_cntn[w - q0];
          } else {
            int slot = 0;
            if (lane == leader) slot = hash_slot(hkeys, a.hsize, key);
            ctr = &hcnt[__shfl_sync(peers, slot, leader)];
          }
          const int before = __shfl_sync(peers, lane == leader ? *ctr : 0,
                                         leader);
          if (lane == leader) *ctr = before + __popc(peers);
          const int rk = before + __popc(peers & lanemask_lt());
          const int c = min(max(key, 0), nq - 1) - q0;
          const bool own = c >= 0 && c < nown;
          const int qa = own ? s_qa[c] : qa0;
          const bool d = qa + rk < cap;
          if (own) {
            const int64_t o = b * m + li;
            const int occ = qa + rk + 1;
            a.enq_try[o] = 1;
            a.do_enq[o] = d;
            a.occ_after[o] = occ;
            a.marked[o] = d && occ > a.ecn_thresh;
          }
          const bool wr = d && w >= q0 && w < q0 + nown;
          const unsigned wm = __ballot_sync(vm, wr);
          if (wr) {
            const int pos = floor_mod((own ? s_head[c] : head0) + qa + rk, cap);
            const long long cell = (long long)w * cap + pos;
            const unsigned same = __match_any_sync(wm, cell);
            if (lane == 31 - __clz(same))    // the later lane wins
              a.qbuf_out[b * nq * (int64_t)cap + cell] = a.apk[b * m + li];
            atomicAdd(&s_hit[w - q0], 1);
          }
        }
        __threadfence_block();
        __syncwarp();
      }
    }
    __syncthreads();   // s_lane, s_key and s_warp are reused
  }
  for (int c = tid; c < nown; c += ENQ_THREADS)
    a.qcnt_out[b * nq + q0 + c] = s_qa[c] + s_hit[c];
}

__global__ void __launch_bounds__(ROW_THREADS)
agg_jsq_enqueue_kernel(
    const int32_t* __restrict__ qbuf, const int32_t* __restrict__ qhead,
    const int32_t* __restrict__ qcnt, const uint8_t* __restrict__ alive,
    const int32_t* __restrict__ apk, const int32_t* __restrict__ aq,
    const uint8_t* __restrict__ to_agg, const int32_t* __restrict__ asw,
    const uint8_t* __restrict__ dead, const float* __restrict__ pad_pen,
    const int32_t* __restrict__ seed_lo, const int32_t* __restrict__ seed_hi,
    PickArgs a, int cap, int ecn_thresh, int off1, int m, int nq,
    int32_t* __restrict__ qbuf_out, int32_t* __restrict__ qcnt_out,
    int32_t* __restrict__ c_fin, uint8_t* __restrict__ enq_try,
    uint8_t* __restrict__ do_enq, int32_t* __restrict__ occ_after,
    uint8_t* __restrict__ marked) {
  extern __shared__ int32_t smem[];
  int32_t* s_aq = smem;
  uint8_t* s_try = reinterpret_cast<uint8_t*>(smem + m);
  const int64_t b = blockIdx.x;
  const int64_t cells = (int64_t)nq * cap;
  const int32_t* qcnt_b = qcnt + b * nq;
  const uint8_t* alive_b = alive + b * nq;
  const uint32_t k0 = (uint32_t)seed_lo[b];
  const uint32_t k1 = (uint32_t)seed_hi[b] ^ a.site_key;
  copy_row(qbuf + b * cells, qcnt_b, cells, nq, qbuf_out + b * cells,
           qcnt_out + b * nq);
  int alias = 0;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int64_t li = b * m + i;
    const int pk = apk[li];
    const int qb = off1 + asw[li] * a.h;
    const int c = pick_port(qcnt_b, qb, (uint32_t)max(pk, 0),
                            dead + li * a.h, pad_pen + b * a.h, k0, k1, a);
    c_fin[li] = c;
    const int tq = to_agg[li] ? qb + c : aq[li];
    const int aqc = min(max(tq, 0), nq - 1);
    s_aq[i] = tq;
    s_try[i] = (pk >= 0) && (alive_b[aqc] != 0);
    alias |= s_try[i] && tq < 0 && tq >= -nq;
  }
  const bool any_alias = __syncthreads_or(alias) != 0;
  enqueue_lanes(qhead + b * nq, qcnt_b, apk + b * m, s_aq, s_try, m, nq, cap,
                ecn_thresh, any_alias, qbuf_out + b * cells, qcnt_out + b * nq,
                enq_try + b * m, do_enq + b * m, occ_after + b * m,
                marked + b * m);
}

constexpr int SACK_THREADS = 512;
constexpr int SACK_WINDOW = 64;

__global__ void __launch_bounds__(SACK_THREADS)
sack_update_scan_kernel(const uint8_t* __restrict__ p_recv,
                        const int32_t* __restrict__ pk,
                        const uint8_t* __restrict__ deliv,
                        const int32_t* __restrict__ f_cum,
                        const int32_t* __restrict__ fsize,
                        const int32_t* __restrict__ pbase, int p, int m,
                        int f, uint8_t* __restrict__ out,
                        int32_t* __restrict__ fm) {
  const int64_t b = blockIdx.x;
  const uint8_t* src = p_recv + b * p;
  uint8_t* dst = out + b * p;
  for (int i = threadIdx.x; i < p; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int q = pk[b * m + i];
    if (deliv[b * m + i] && q >= 0 && q < p) dst[q] = 1;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int fl = threadIdx.x >> 5; fl < f; fl += n_warps) {
    const int64_t k = b * f + fl;
    const int cum = f_cum[k];
    const int fs = fsize[k];
    if (fs <= 0) {                 // every candidate is fsize - 1 = -1
      if (lane == 0) fm[k] = fs - 1;
      continue;
    }
    const int base = pbase[k];
    const int c_lo = min(cum + lane, fs - 1);
    const int c_hi = min(cum + lane + 32, fs - 1);
    const unsigned miss_lo =
        __ballot_sync(0xffffffffu, dst[base + c_lo] == 0);
    const unsigned miss_hi =
        __ballot_sync(0xffffffffu, dst[base + c_hi] == 0);
    if (lane == 0) {
      const int w = miss_lo ? __ffs(miss_lo) - 1
                  : miss_hi ? 32 + __ffs(miss_hi) - 1 : 0;
      fm[k] = min(cum + w, fs - 1);
    }
  }
}

__global__ void sack_advance_kernel(const uint8_t* __restrict__ p_recv,
                                    const int32_t* __restrict__ f_cum,
                                    const int32_t* __restrict__ fsize,
                                    const int32_t* __restrict__ pbase, int p,
                                    int f, int64_t n,
                                    int32_t* __restrict__ out) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const uint8_t* row = p_recv + (k / f) * p;
  const int fs = fsize[k];
  const int base = pbase[k];
  int cum = f_cum[k];
  for (int r = 0; r < 2; ++r) {
    int adv = 0;
    bool run = true;
    for (int w = 0; w < 4; ++w) {
      run = run && cum + w < fs && row[base + min(cum + w, fs - 1)] != 0;
      adv += run;
    }
    cum = min(cum + adv, fs);
  }
  out[k] = cum;
}

size_t row_smem(int m) { return (size_t)m * 4 + (size_t)m; }

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

PickArgs pick_args(const void* edges, int nq_edges, int site, int t, int h) {
  PickArgs a;
  a.edges = static_cast<const float*>(edges);
  a.nq = nq_edges;
  a.site_key = (uint32_t)site << 16;
  a.t = (uint32_t)t;
  a.h = h;
  return a;
}

}  // namespace

extern "C" {

// (rows, m) choosers; qcnt (rows, nq); dead (rows, m, h) uint8; pad_pen
// (rows, h); seeds (rows,) int32 bit patterns of the uint32 key words;
// edges holds nq_edges floats (0: plain JSQ).  Returns cudaGetLastError().
int slot_jsq_pick(const void* qcnt, const void* qbase, const void* ids,
                  const void* dead, const void* pad_pen, const void* seed_lo,
                  const void* seed_hi, int t, int site, const void* edges,
                  int nq_edges, int rows, int m, int nq, int h, void* out,
                  void* stream) {
  if (h < 1 || rows < 1 || m < 1 || nq < 1 || t < 0 ||
      nq_edges < 0 || nq_edges > MAX_EDGES)
    return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)rows * m;
  const int64_t blocks = (n + PICK_THREADS - 1) / PICK_THREADS;
  jsq_pick_kernel<<<(unsigned)blocks, PICK_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qcnt), static_cast<const int32_t*>(qbase),
      static_cast<const int32_t*>(ids), static_cast<const uint8_t*>(dead),
      static_cast<const float*>(pad_pen),
      static_cast<const int32_t*>(seed_lo),
      static_cast<const int32_t*>(seed_hi),
      pick_args(edges, nq_edges, site, t, h), rows, m, nq,
      static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

// qbuf (rows, nq, cap); qhead, qcnt, alive (rows, nq); apk, aq, avalid
// (rows, m).  Writes new qbuf/qcnt and the per-lane outputs.  hash: rows *
// 4 * hsize int32 scratch (hsize a power of two >= 2 m), which the kernel
// clears where it uses it.
int slot_enqueue(const void* qbuf, const void* qhead, const void* qcnt,
                 const void* alive, const void* apk, const void* aq,
                 const void* avalid, int cap, int ecn_thresh, int rows, int m,
                 int nq, void* hash, int hsize, void* qbuf_out,
                 void* qcnt_out, void* enq_try, void* do_enq, void* occ_after,
                 void* marked, void* stream) {
  if (rows < 1 || m < 0 || nq < 1 || cap < 1 || hsize < 1 ||
      (hsize & (hsize - 1)) != 0 || hsize < 2 * m)
    return (int)cudaErrorInvalidValue;
  EnqArgs e;
  e.qbuf = static_cast<const int32_t*>(qbuf);
  e.qhead = static_cast<const int32_t*>(qhead);
  e.qcnt = static_cast<const int32_t*>(qcnt);
  e.alive = static_cast<const uint8_t*>(alive);
  e.apk = static_cast<const int32_t*>(apk);
  e.aq = static_cast<const int32_t*>(aq);
  e.avalid = static_cast<const uint8_t*>(avalid);
  e.qbuf_out = static_cast<int32_t*>(qbuf_out);
  e.qcnt_out = static_cast<int32_t*>(qcnt_out);
  e.enq_try = static_cast<uint8_t*>(enq_try);
  e.do_enq = static_cast<uint8_t*>(do_enq);
  e.occ_after = static_cast<int32_t*>(occ_after);
  e.marked = static_cast<uint8_t*>(marked);
  e.hash = static_cast<int32_t*>(hash);
  e.cap = cap;
  e.ecn_thresh = ecn_thresh;
  e.m = m;
  e.nq = nq;
  e.tiles = (nq + ENQ_QB - 1) / ENQ_QB;
  e.hsize = hsize;
  const int64_t blocks = (int64_t)rows * e.tiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  enqueue_kernel<<<(unsigned)blocks, ENQ_THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(e);
  return (int)cudaGetLastError();
}

// slot_enqueue's operands plus to_agg (rows, m) uint8, asw (rows, m), dead
// (rows, m, h) uint8, pad_pen (rows, h), seeds and the pick's constants;
// also writes c_fin (rows, m).
int slot_agg_jsq_enqueue(const void* qbuf, const void* qhead,
                         const void* qcnt, const void* alive, const void* apk,
                         const void* aq, const void* to_agg, const void* asw,
                         const void* dead, const void* pad_pen,
                         const void* seed_lo, const void* seed_hi, int t,
                         int site, const void* edges, int nq_edges, int cap,
                         int ecn_thresh, int off1, int h, int rows, int m,
                         int nq, void* qbuf_out, void* qcnt_out, void* c_fin,
                         void* enq_try, void* do_enq, void* occ_after,
                         void* marked, void* stream) {
  if (h < 1 || rows < 1 || m < 1 || nq < 1 || cap < 1 || t < 0 ||
      nq_edges < 0 || nq_edges > MAX_EDGES)
    return (int)cudaErrorInvalidValue;
  const size_t smem = row_smem(m);
  int err = set_smem(agg_jsq_enqueue_kernel, smem);
  if (err != 0) return err;
  agg_jsq_enqueue_kernel<<<rows, ROW_THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qbuf), static_cast<const int32_t*>(qhead),
      static_cast<const int32_t*>(qcnt), static_cast<const uint8_t*>(alive),
      static_cast<const int32_t*>(apk), static_cast<const int32_t*>(aq),
      static_cast<const uint8_t*>(to_agg), static_cast<const int32_t*>(asw),
      static_cast<const uint8_t*>(dead), static_cast<const float*>(pad_pen),
      static_cast<const int32_t*>(seed_lo),
      static_cast<const int32_t*>(seed_hi),
      pick_args(edges, nq_edges, site, t, h), cap, ecn_thresh, off1, m, nq,
      static_cast<int32_t*>(qbuf_out), static_cast<int32_t*>(qcnt_out),
      static_cast<int32_t*>(c_fin), static_cast<uint8_t*>(enq_try),
      static_cast<uint8_t*>(do_enq), static_cast<int32_t*>(occ_after),
      static_cast<uint8_t*>(marked));
  return (int)cudaGetLastError();
}

// p_recv (rows, p) uint8 0/1; pk, deliv (rows, m) int32 / uint8; f_cum,
// fsize, pbase (rows, f) int32.  Writes the new bitmap (rows, p) and the
// first missing sequence fm (rows, f).  Delivering lanes target [0, p) and
// the windows of flows with fsize > 0 lie in the row.
int slot_sack_update_scan(const void* p_recv, const void* pk,
                          const void* deliv, const void* f_cum,
                          const void* fsize, const void* pbase, int rows,
                          int p, int m, int f, void* out, void* fm,
                          void* stream) {
  if (rows < 1 || p < 1 || m < 0 || f < 0) return (int)cudaErrorInvalidValue;
  sack_update_scan_kernel<<<rows, SACK_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(p_recv), static_cast<const int32_t*>(pk),
      static_cast<const uint8_t*>(deliv), static_cast<const int32_t*>(f_cum),
      static_cast<const int32_t*>(fsize), static_cast<const int32_t*>(pbase),
      p, m, f, static_cast<uint8_t*>(out), static_cast<int32_t*>(fm));
  return (int)cudaGetLastError();
}

// Operands as slot_sack_update_scan; writes the advanced f_cum (rows, f).
int slot_sack_advance(const void* p_recv, const void* f_cum,
                      const void* fsize, const void* pbase, int rows, int p,
                      int f, void* out, void* stream) {
  if (rows < 1 || p < 1 || f < 1) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)rows * f;
  const int threads = 128;
  sack_advance_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(p_recv), static_cast<const int32_t*>(f_cum),
      static_cast<const int32_t*>(fsize), static_cast<const int32_t*>(pbase),
      p, f, n, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
