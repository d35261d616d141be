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
// Index rules (the reference's, on every input it takes; the engine's own
// inputs never leave the rows):
//   * a gather (the pick's occupancy read qcnt[qbase + l], the SACK
//     windows' bitmap reads p_recv[pbase + cand]) wraps a negative index
//     once (+ the row length) and then clamps it to the row (gather_index);
//   * a scatter (the enqueue's ring write and occupancy add, the SACK
//     bitmap's p_recv[pk] = 1) wraps a negative index once and drops an
//     index still outside the row;
//   * the enqueue reads its queue at clip(aq, 0, nq - 1) (occupancy, head,
//     alive) and ranks a lane among the earlier enqueue-trying lanes of the
//     same raw aq; where two lanes write one ring cell (targets q and
//     q - nq) the later lane wins (XLA's sequential scatter).
//
// The JSQ score of a port (both picks): the queue length, Threefry-2x32
// (20 rounds, native uint32) keyed k0 = seed_lo, k1 = seed_hi ^ ((site <<
// 16) ^ port), counter c0 = t (the slot as uint32: a negative or >= 2^31
// slot wraps, as the plain version's _u32_torch does), c1 = id, the uniform
// (x0 >> 8) * 2^-24, and
//   JSQ:       fmaf(nz, 1e-3f, len)  -- one rounding, as XLA:CPU contracts
//              `lens + nz * 1e-3` in the reference's engine;
//   quantized: #{edges < len} + nz * 0.5 (exact either way), over any
//              number of edges (none at all is still quantized: nz * 0.5);
// then + pad_pen and + (dead ? 1e9 : 0), each rounded on its own
// (__fadd_rn; the file is built with --fmad=false).  The first EDGE_ARGS
// edges come by value in the kernel's arguments (+inf past the last), the
// rest are read from device memory (every scheme has 3).  The
// pick is the first minimum in torch.argmin's (and jnp.argmin's) order: the
// first NaN score if there is one, else the lowest port among equal minima
// (first_min, before).
//
// jsq_pick: one CTA per (row, tile of choosers), a group of G lanes a
// chooser, G the power of two >= min(h, 32).  Lane j scores ports j, j + G,
// ... (one port a lane for h <= 32), so a lane runs one Threefry chain, not
// h; a __shfl_xor_sync reduction over the group picks (score, port) by the
// rule above, and the group's first lane writes the pick.  A lane's loads
// (qbase, id, dead flag, penalty) and the occupancy gather it feeds
// (gather_index) come from device memory while its Threefry chain runs; no
// shared memory, no barrier.  The engine's (2 rows, 128 choosers, 4 ports,
// 640-queue rows) makes 2 x 4 CTAs of 128 threads.  (Staging the row in
// shared memory first tied or lost on the card: tools/slot_wrapper_times.py,
// PERF.md's PR 20 findings.)
// Bound: bytes -- per chooser the h dead flags, its qbase and id read and
// one int written, the row's queues and penalties; the 20-round PRF per
// port is ~125 integer operations.  At the engine's size the kernel is
// latency-bound: a launch, two dependent rounds of loads (qbase, then the
// gather) beside the chain, and a log2(G)-step shuffle.
//
// enqueue and agg_jsq_enqueue: one CTA per (row, tile of ENQ_QB = 16
// queues), owner-computes (enqueue_tile, shared by both kernels; they differ
// only in how a lane's key is found).  The k=8 slot's 6 rows of 640 queues
// give 240 CTAs on 132 SMs, its 2 agg rows 80.  Bound: bytes -- the row's
// ring buffers copied out of place (nq * cap ints read and written; 6 x 640
// x 195 x 4 B = 3.0 MB each way at k=8) plus the lanes.  One block per row
// would leave a few SMs to stream those bytes and rank each lane with a
// loop over all earlier lanes (O(M^2)).  Here each CTA owns its queues'
// ring cells, occupancy and the per-lane outputs of the lanes whose
// clip(key) it owns:
//   * it copies its queues' cells as one contiguous run of ENQ_QB * cap ints
//     (16-byte vectors over the aligned middle: cap = 195 leaves a queue's
//     own run unaligned), so the outputs are new tensors and a frozen row
//     comes out bitwise unchanged (the engine selects frozen rows with
//     torch.where);
//   * it walks the row's lanes in rounds of 256: each thread finds its
//     lane's key and flags the lane if it tries to enqueue into an owned
//     queue (valid and the queue alive), a block prefix of per-warp ballots
//     compacts the flagged lanes in lane order, and one warp ranks them 32
//     at a time: __match_any_sync on the raw key groups equal keys, the rank
//     is a per-key counter plus the popcount of earlier peers, and the
//     group's first lane advances the counter.  Counters of owned keys (and
//     of the negative keys that wrap into owned queues) live in shared
//     memory; a key outside [0, nq) that wraps into no owned queue (only the
//     first and last tiles see them) is counted in an open-addressing hash
//     table in a global scratch, cleared by the CTA when it first needs it.
//     The rank is O(M) work per CTA, and no result depends on the order of
//     atomics: the counters advance in lane order, and a shared-memory
//     atomicAdd only sums the ring writes of an owned queue;
//   * the ring writes land in owned cells only (the lanes of a negative
//     key that wraps into an owned queue are ranked by this CTA too, from
//     queue 0's occupancy and head), the later lane winning a shared cell
//     (__match_any_sync on the cell); qcnt' = qcnt + the writes counted.
// No grid sync, second launch or global atomic is needed.
// enqueue's key is aq, valid avalid.  agg_jsq_enqueue's valid is apk >= 0,
// and its key is aq for a lane that is not agg-bound, else qb + c, with qb =
// off1 + asw * h and c the lane's JSQ pick (ids = max(apk, 0)).  The pick
// reads only the start-of-slot occupancy, so any CTA can compute it: a CTA
// does when one of the lane's h candidate keys qb..qb + h - 1 clips into
// its tile or wraps into it (a few integer compares; for h <= 16 at most 2
// CTAs a lane), and for a lane that is not agg-bound when it owns clip(aq).
// c_fin is written once a lane, by the CTA that owns clip(key), which
// always has the pick.
// Bound of agg_jsq_enqueue: the enqueue's bytes plus the lanes' ports (the
// PRF's ~200 integer operations a port stay under it).
//
// sack_update_scan: a grid over the bitmap, one launch.  A row gets one CTA
// per tile of 2,048 bytes (P / 64 rounded up to 16 where that is more: at
// most 64 tiles), and more CTAs where its flows need them, one warp a flow
// (up to 64 CTAs; kernel.py:sack_layout).  The k=8 slot's 4 rows of 32,768
// packets and 128 flows give 16 CTAs a row, 64 in all.  (On the card at
// that shape, tools/sack_layout_times.py: 0.0025 ms; tiles of 4,096 bytes
// 0.0028, of 1,024 0.0029, of 512 0.0031; two flows a warp 0.0034.)  CTA
// t of a row
//   * copies tile t out of place, if the row has one (copy_run: 16-byte
//     vectors over the aligned middle, bytes at the ends, for a row
//     starting at any alignment);
//   * reads the row's M lanes (3.2 KB at k=8, shared by the row's CTAs
//     through L2) and writes out[w] = 1 in its own tile for each delivering
//     target w (pk wrapped once, the rest dropped; duplicates all write 1);
//   * puts the targets in the row's delivered set, in the form that clears
//     fewer ints: a bitset of the row, or an open-addressing table of keys
//     w + 1 (a power of two >= 2 M slots), in shared memory where it fits
//     48 KB, else the table in a global scratch of its own;
//   * scans flows 8 t .. 8 t + 7 of its row, then those 8 * ctas further
//     on, one warp a flow: lane l holds the window entries w = l
//     and w = l + 32, cand_w = min(cum + w, fsize - 1) with int32
//     wraparound (add_wrap), each tested against the source bitmap or the
//     set (= the new bitmap, which other CTAs may not have written yet);
//     two ballots find the first entry not received, and the result is its
//     candidate, or cand_0 when all 64 are received (argmin's first
//     occurrence).  Every flow reads its window, whatever its size.
// No CTA reads what another writes: no grid sync or second launch, and the
// set's atomics (atomicOr, atomicCAS) only insert, so no result depends on
// their order.
// Bound: bytes -- the bitmap row read and written once, the lanes and the
// per-flow counters (0.28 MB at k=8: 8.5e-5 ms at 3.35 TB/s).  At that size
// the kernel is latency-bound: a launch, one round of loads (tile, lanes,
// first flow), two barriers and one round of window reads.
// sack_advance: one thread per (row, flow).  Two rounds of the 4-wide
// running product of received bits (masked to cum + w < fsize) reach at
// most the entries cum .. cum + 7, so the thread issues those 8 reads at
// once, as independent loads, and takes their leading run of received
// entries (sack_advance_kernel says why that equals the two rounds).
// Bound: bytes -- the entries these inputs make it read and the per-flow
// counters; a few integer operations per entry.  Both kernels are
// integer-only.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr uint32_t PARITY = 0x1BD11BDAu;
constexpr int PICK_THREADS = 128;
constexpr int EDGE_ARGS = 8;          // bin edges passed by value
constexpr unsigned FULL = 0xffffffffu;

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

// The row index a gather reads: a negative index wraps once, then the
// index clamps to [0, n - 1].
__device__ __forceinline__ int gather_index(int r, int n) {
  const int w = r < 0 ? r + n : r;
  return min(max(w, 0), n - 1);
}

// a + b with int32 wraparound, as the reference's int32 index arithmetic.
__device__ __forceinline__ int add_wrap(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

struct PickArgs {
  float edge[EDGE_ARGS];  // the first bin edges, +inf past the last
  const float* tail;      // the others (n_tail), in device memory
  int n_tail;
  int quantized;          // 0: plain JSQ
  uint32_t site_key;      // site << 16
  uint32_t t;             // the slot, wrapped to uint32
  int h;
  int nq;                 // a row's queues
};

// The score of one port (the file header's formula), from its queue length,
// its Threefry word u, its dead flag and its pad penalty.
__device__ __forceinline__ float port_score(float len, uint32_t u, bool dead,
                                            float pen, const PickArgs& a) {
  const float nz = __fmul_rn((float)(u >> 8), 5.9604644775390625e-08f);
  float score;
  if (!a.quantized) {
    score = fmaf(nz, 1e-3f, len);
  } else {
    int bins = 0;
#pragma unroll
    for (int q = 0; q < EDGE_ARGS; ++q) bins += len > a.edge[q];
    for (int q = 0; q < a.n_tail; ++q) bins += len > a.tail[q];
    score = __fadd_rn((float)bins, __fmul_rn(nz, 0.5f));
  }
  score = __fadd_rn(score, pen);
  return __fadd_rn(score, dead ? 1e9f : 0.0f);
}

// Whether a later port's score s replaces the best so far: a first NaN
// does, then only a smaller score.
__device__ __forceinline__ bool first_min(float s, float best) {
  return isnan(s) ? !isnan(best) : s < best;
}

// Whether (s, l) comes before (bs, bl) in argmin's order: NaN first, then
// the smaller score, then the lower port.
__device__ __forceinline__ bool before(float s, int l, float bs, int bl) {
  if (isnan(s)) return !isnan(bs) || l < bl;
  return !isnan(bs) && (s < bs || (s == bs && l < bl));
}

constexpr int PICK_BATCH = 4;   // ports whose loads and PRFs overlap

// Port of least score for one chooser, one thread over all h ports (the
// agg kernel's pick).  Ports go in batches: a batch's loads are all issued
// first, and its PRF chains are independent, so neither a load nor a chain
// waits on another.
__device__ int pick_port(const int32_t* qcnt_row, int qbase, uint32_t id,
                         const uint8_t* dead, const float* pen,
                         uint32_t k0, uint32_t k1_site, const PickArgs& a) {
  float best = 0.0f;
  int arg = 0;
  for (int l0 = 0; l0 < a.h; l0 += PICK_BATCH) {
    float len[PICK_BATCH], pl[PICK_BATCH];
    bool dl[PICK_BATCH];
#pragma unroll
    for (int i = 0; i < PICK_BATCH; ++i) {
      const int l = min(l0 + i, a.h - 1);
      len[i] = (float)qcnt_row[gather_index(add_wrap(qbase, l), a.nq)];
      pl[i] = pen[l];
      dl[i] = dead[l] != 0;
    }
#pragma unroll
    for (int i = 0; i < PICK_BATCH; ++i) {
      const int l = l0 + i;
      const uint32_t u = threefry_x0(k0, k1_site ^ (uint32_t)l, a.t, id);
      const float score = port_score(len[i], u, dl[i], pl[i], a);
      if (l < a.h && (l == 0 || first_min(score, best))) {
        best = score;
        arg = l;
      }
    }
  }
  return arg;
}

// One CTA per (row, tile of PICK_THREADS >> glog choosers), 1 << glog
// lanes a chooser; the file header's scheme.
__global__ void __launch_bounds__(PICK_THREADS)
jsq_pick_kernel(const int32_t* __restrict__ qcnt,
                const int32_t* __restrict__ qbase,
                const int32_t* __restrict__ ids,
                const uint8_t* __restrict__ dead,
                const float* __restrict__ pad_pen,
                const int32_t* __restrict__ seed_lo,
                const int32_t* __restrict__ seed_hi, PickArgs a, int m,
                int tiles, int glog, int32_t* __restrict__ out) {
  const int64_t b = blockIdx.x / tiles;
  const int tid = threadIdx.x, g = 1 << glog, j = tid & (g - 1);
  const int i = (int)(blockIdx.x % tiles) * (PICK_THREADS >> glog) +
                (tid >> glog);
  const int h = a.h, nq = a.nq;
  const int32_t* occ = qcnt + b * nq;
  const int64_t li = b * m + (i < m ? i : 0);
  const int qb = qbase[li];
  const uint32_t id = (uint32_t)ids[li];
  const uint32_t k0 = (uint32_t)seed_lo[b];
  const uint32_t k1 = (uint32_t)seed_hi[b] ^ a.site_key;
  const uint8_t* dl = dead + li * h;
  const float* pl = pad_pen + b * h;
  // A lane without a port (j >= h) holds +inf at port h: any port's score
  // comes before it.  A lane's first port is taken whatever its score.
  float best = INFINITY;
  int arg = h;
  for (int l = j; l < h; l += g) {   // one port a lane for h <= 32
    const float s = port_score(
        (float)occ[gather_index(add_wrap(qb, l), nq)],
        threefry_x0(k0, k1 ^ (uint32_t)l, a.t, id), dl[l] != 0, pl[l], a);
    if (l == j || first_min(s, best)) {
      best = s;
      arg = l;
    }
  }
  for (int o = g >> 1; o > 0; o >>= 1) {
    const float s = __shfl_xor_sync(FULL, best, o);
    const int l = __shfl_xor_sync(FULL, arg, o);
    if (before(s, l, best, arg)) {
      best = s;
      arg = l;
    }
  }
  if (i < m && j == 0) out[li] = arg;
}

// Floor modulo (torch.remainder, jnp's %) for cap >= 1.
__device__ __forceinline__ int floor_mod(int x, int cap) {
  const int r = x % cap;
  return r < 0 ? r + cap : r;
}

constexpr int ENQ_THREADS = 256;
constexpr int ENQ_WARPS = ENQ_THREADS / 32;
constexpr int ENQ_QB = 16;      // queues an enqueue CTA owns

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Copy n elements; 16-byte vectors over the aligned middle when src and dst
// share their offset mod 16.
template <class T>
__device__ void copy_run(const T* __restrict__ src, T* __restrict__ dst,
                         int64_t n) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t sa = reinterpret_cast<uintptr_t>(src);
  if (((sa ^ reinterpret_cast<uintptr_t>(dst)) & 15) != 0) {
    for (int64_t c = threadIdx.x; c < n; c += blockDim.x) dst[c] = src[c];
    return;
  }
  const int64_t head =
      min((int64_t)(((16 - (sa & 15)) & 15) / sizeof(T)), n);
  const int64_t nv = (n - head) / V;
  const int4* sv = reinterpret_cast<const int4*>(src + head);
  int4* dv = reinterpret_cast<int4*>(dst + head);
#pragma unroll 4
  for (int64_t v = threadIdx.x; v < nv; v += blockDim.x) dv[v] = sv[v];
  for (int64_t c = threadIdx.x; c < head; c += blockDim.x) dst[c] = src[c];
  for (int64_t c = head + V * nv + threadIdx.x; c < n; c += blockDim.x)
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

// The operands and outputs of the enqueue both kernels share.
struct EnqArgs {
  const int32_t* qbuf;
  const int32_t* qhead;
  const int32_t* qcnt;
  const uint8_t* alive;
  const int32_t* apk;
  int32_t* qbuf_out;
  int32_t* qcnt_out;
  uint8_t* enq_try;
  uint8_t* do_enq;
  int32_t* occ_after;
  uint8_t* marked;
  int32_t* hash;      // (rows, 2, 2 * hsize): keys, then counts
  int cap, ecn_thresh, m, nq, tiles, hsize;
};

__device__ __forceinline__ bool in_tile(int q, int q0, int nown) {
  return q >= q0 && q < q0 + nown;
}

// enqueue's lanes: key aq, valid avalid.
struct PlainLanes {
  const int32_t* aq;
  const uint8_t* avalid;
  struct Raw {
    int aq;
    bool av;
  };
  __device__ Raw load(int64_t li) const { return {aq[li], avalid[li] != 0}; }
  // The lane's key and valid flag; false if the lane cannot concern the
  // tile (never here: enqueue_tile tests the key itself).
  __device__ bool key(const Raw& r, int64_t, int, int, int& k,
                      bool& av) const {
    k = r.aq;
    av = r.av;
    return true;
  }
};

// agg_jsq_enqueue's lanes (one row): valid apk >= 0, key aq or, for an
// agg-bound lane, qb + its JSQ pick; writes c_fin for the lanes whose
// clip(key) the tile owns.
struct AggLanes {
  const int32_t* apk;
  const int32_t* aq;
  const uint8_t* to_agg;
  const int32_t* asw;
  const uint8_t* dead;      // (rows, m, h)
  const float* pen;         // the row's pad penalty
  const int32_t* qcnt;      // the row's start-of-slot occupancy
  int32_t* c_fin;
  uint32_t k0, k1;          // the row's key words, k1 with the site
  PickArgs p;
  int off1;
  struct Raw {
    int pk, aq, asw;
    bool agg;
  };
  __device__ Raw load(int64_t li) const {
    return {apk[li], aq[li], asw[li], to_agg[li] != 0};
  }
  __device__ int pick(const Raw& r, int64_t li, int qb) const {
    return pick_port(qcnt, qb, (uint32_t)max(r.pk, 0), dead + li * p.h, pen,
                     k0, k1, p);
  }
  // Whether one of the keys qb..qb + h - 1 clips into the tile or wraps
  // into it (a key range that overflows int32 is taken as touching it).
  __device__ bool touches(int qb, int q0, int nown) const {
    const long long lo = qb, hi = lo + p.h - 1, nq = p.nq;
    if (hi > INT_MAX) return true;
    const long long t_hi = q0 + nown - 1;
    const long long c_lo = min(max(lo, 0LL), nq - 1);
    const long long c_hi = min(max(hi, 0LL), nq - 1);
    if (c_lo <= t_hi && c_hi >= q0) return true;
    return lo < 0 && lo + nq <= t_hi && min(hi, -1LL) + nq >= q0;
  }
  __device__ bool key(const Raw& r, int64_t li, int q0, int nown, int& k,
                      bool& av) const {
    av = r.pk >= 0;
    const int qb = add_wrap(off1, (int)((unsigned)r.asw * (unsigned)p.h));
    // The pick: for c_fin where the tile owns clip(aq), for the key where
    // an agg-bound lane's candidates touch the tile (one call site, so a
    // warp runs it once).
    const bool need = r.agg ? touches(qb, q0, nown)
                            : in_tile(min(max(r.aq, 0), p.nq - 1), q0, nown);
    if (r.agg && !need) return false;
    const int c = need ? pick(r, li, qb) : 0;
    k = r.agg ? add_wrap(qb, c) : r.aq;
    if (need && in_tile(min(max(k, 0), p.nq - 1), q0, nown)) c_fin[li] = c;
    return true;
  }
};

// The enqueue of row b's queues q0 .. q0 + ENQ_QB - 1 (the file header's
// scheme), its lanes' keys and valid flags from `lanes`.
template <class Lanes>
__device__ void enqueue_tile(const EnqArgs& a, const Lanes& lanes, int64_t b,
                             int q0) {
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
  const int nown = min(ENQ_QB, nq - q0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // The first round's lanes load while the cells copy; each round loads
  // the next round's.
  typename Lanes::Raw raw_next{};
  if (tid < m) raw_next = lanes.load(b * m + tid);
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
    const typename Lanes::Raw raw = raw_next;
    if (i + ENQ_THREADS < m) raw_next = lanes.load(b * m + i + ENQ_THREADS);
    bool rel = false, hashed = false;
    int key = 0;
    bool av = false;
    if (i < m && lanes.key(raw, b * m + i, q0, nown, key, av)) {
      const int c = min(max(key, 0), nq - 1) - q0;
      const bool own = c >= 0 && c < nown;
      const int w = key < 0 ? key + nq : key;
      const bool wraps = key < 0 && in_tile(w, q0, nown);
      if (own || wraps) {
        const bool tr = av && (own ? s_alive[c] != 0 : alive0);
        rel = tr;
        hashed = tr && !in_tile(key, q0, nown) && !wraps;
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
          if (in_tile(key, q0, nown)) {
            ctr = &s_cnt[key - q0];
          } else if (key < 0 && in_tile(w, q0, nown)) {
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
          const bool wr = d && in_tile(w, q0, nown);
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

__global__ void __launch_bounds__(ENQ_THREADS)
enqueue_kernel(const EnqArgs a, const PlainLanes lanes) {
  enqueue_tile(a, lanes, blockIdx.x / a.tiles,
               (int)(blockIdx.x % a.tiles) * ENQ_QB);
}

__global__ void __launch_bounds__(ENQ_THREADS)
agg_jsq_enqueue_kernel(const EnqArgs a, AggLanes lanes,
                       const int32_t* __restrict__ seed_lo,
                       const int32_t* __restrict__ seed_hi) {
  const int64_t b = blockIdx.x / a.tiles;
  lanes.pen += b * lanes.p.h;
  lanes.qcnt += b * a.nq;
  lanes.k0 = (uint32_t)seed_lo[b];
  lanes.k1 = (uint32_t)seed_hi[b] ^ lanes.p.site_key;
  enqueue_tile(a, lanes, b, (int)(blockIdx.x % a.tiles) * ENQ_QB);
}

constexpr int SACK_THREADS = 256;
constexpr int SACK_WARPS = SACK_THREADS / 32;
constexpr int SACK_LPT = 4;     // lanes a thread loads before the set clears
constexpr int SACK_SMEM = 48 * 1024;   // shared bytes the delivered set may take
constexpr int ADV_THREADS = 32;   // on the card 64 ran 1.5 % slower, 128 6 %
constexpr int ADV_REACH = 8;    // entries two rounds of a 4-wide window reach

// The set of a row's delivered targets, as the scan tests it: a bitset of
// the row (bit w of word w / 32) or an open-addressing table of keys w + 1
// (hash_slot's), in shared memory or in a global scratch.
struct SackSet {
  int32_t* s;
  int hsize;      // 0: a bitset
  __device__ void add(int w) const {
    if (hsize == 0)
      atomicOr(reinterpret_cast<unsigned*>(s) + (w >> 5), 1u << (w & 31));
    else
      hash_slot(s, hsize, w + 1);
  }
  __device__ bool has(int w) const {
    const volatile int32_t* v = s;   // written by this CTA's atomics
    if (hsize == 0) return ((unsigned)v[w >> 5] >> (w & 31)) & 1u;
    const int key = w + 1;
    unsigned h = ((unsigned)key * 2654435761u) & (unsigned)(hsize - 1);
    while (true) {
      const int cur = v[h];
      if (cur == key) return true;
      if (cur == 0) return false;
      h = (h + 1) & (unsigned)(hsize - 1);
    }
  }
};

struct SackArgs {
  const uint8_t* p_recv;
  const int32_t* pk;
  const uint8_t* deliv;
  const int32_t* f_cum;
  const int32_t* fsize;
  const int32_t* pbase;
  uint8_t* out;
  int32_t* fm;
  int32_t* scratch;   // (rows * ctas, hsize) when the table is global
  int64_t tile;       // bitmap bytes a CTA copies, a multiple of 16
  int p, m, f, ctas;  // ctas: CTAs a row
  int hsize;          // 0: bitset
  int set_words;      // ints of the set a CTA clears
  bool set_shared;
};

// CTA t of row b copies tile t of the row (nothing past its end) and scans
// flows 8 t .. 8 t + 7, 8 ctas further on, ...; the file header's scheme.
__global__ void __launch_bounds__(SACK_THREADS)
sack_update_scan_kernel(const SackArgs a) {
  extern __shared__ int32_t s_set[];
  const int64_t b = blockIdx.x / a.ctas;
  const int t = (int)(blockIdx.x % a.ctas);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = a.p, m = a.m;
  const uint8_t* src = a.p_recv + b * p;
  uint8_t* dst = a.out + b * p;
  const int64_t t0 = min(t * a.tile, (int64_t)p);
  const int64_t t1 = min(t0 + a.tile, (int64_t)p);
  const SackSet set{a.set_shared ? s_set
                                 : a.scratch + (int64_t)blockIdx.x * a.hsize,
                    a.hsize};
  // The first lanes and this warp's first flow load while the set clears
  // and the tile copies.
  int tgt[SACK_LPT];
#pragma unroll
  for (int j = 0; j < SACK_LPT; ++j) {
    const int i = tid + j * SACK_THREADS;
    tgt[j] = -1;
    if (i < m) {
      const int q = a.pk[b * m + i];
      const int w = q < 0 ? q + p : q;   // a negative target wraps once
      if (a.deliv[b * m + i] && w >= 0 && w < p) tgt[j] = w;
    }
  }
  const int fl0 = t * SACK_WARPS + warp;
  const int fstep = a.ctas * SACK_WARPS;
  int cum = 0, fs = 0, base = 0;
  if (fl0 < a.f) {
    cum = a.f_cum[b * a.f + fl0];
    fs = a.fsize[b * a.f + fl0];
    base = a.pbase[b * a.f + fl0];
  }
  const bool scans = t * SACK_WARPS < a.f;    // block-uniform
  if (scans)
    for (int i = tid; i < a.set_words; i += SACK_THREADS) set.s[i] = 0;
  copy_run(src + t0, dst + t0, t1 - t0);
  __syncthreads();   // the set is clear and the tile copied
#pragma unroll
  for (int j = 0; j < SACK_LPT; ++j) {
    const int w = tgt[j];
    if (w >= 0) {
      if (scans) set.add(w);
      if (w >= t0 && w < t1) dst[w] = 1;
    }
  }
  for (int i = tid + SACK_LPT * SACK_THREADS; i < m; i += SACK_THREADS) {
    const int q = a.pk[b * m + i];
    const int w = q < 0 ? q + p : q;
    if (a.deliv[b * m + i] && w >= 0 && w < p) {
      if (scans) set.add(w);
      if (w >= t0 && w < t1) dst[w] = 1;
    }
  }
  if (!scans) return;
  __syncthreads();   // the set is complete
  // Flows fl0, fl0 + fstep, ...: lane l tests the window entries l and
  // l + 32 against the source bitmap or the delivered set.
  for (int fl = fl0; fl < a.f; fl += fstep) {
    if (fl != fl0) {
      cum = a.f_cum[b * a.f + fl];
      fs = a.fsize[b * a.f + fl];
      base = a.pbase[b * a.f + fl];
    }
    const int last = add_wrap(fs, -1);
    const int i_lo = gather_index(add_wrap(base, min(add_wrap(cum, lane),
                                                     last)), p);
    const int i_hi = gather_index(add_wrap(base, min(add_wrap(cum, lane + 32),
                                                     last)), p);
    const bool got_lo = src[i_lo] != 0, got_hi = src[i_hi] != 0;
    const unsigned miss_lo = __ballot_sync(FULL, !(got_lo || set.has(i_lo)));
    const unsigned miss_hi = __ballot_sync(FULL, !(got_hi || set.has(i_hi)));
    if (lane == 0) {
      const int w = miss_lo ? __ffs(miss_lo) - 1
                  : miss_hi ? 32 + __ffs(miss_hi) - 1 : 0;
      a.fm[b * a.f + fl] = min(add_wrap(cum, w), last);
    }
  }
}

// One thread per (row, flow).  Two rounds of the 4-wide running product
// read at most the entries cum .. cum + 7 (the second round starts where
// the first stopped, and it adds only after a full first round), so the
// thread issues those 8 reads at once and takes the leading run of
// received entries, each masked to cum + j < fsize.  When f_cum >= fsize
// the first round adds nothing and clamps cum to fsize, and the second reads
// nothing: min(cum + 0, fsize) gives that too.
__global__ void __launch_bounds__(ADV_THREADS)
sack_advance_kernel(const uint8_t* __restrict__ p_recv,
                    const int32_t* __restrict__ f_cum,
                    const int32_t* __restrict__ fsize,
                    const int32_t* __restrict__ pbase, int p, int f, int64_t n,
                    int32_t* __restrict__ out) {
  const int64_t k = (int64_t)blockIdx.x * ADV_THREADS + threadIdx.x;
  if (k >= n) return;
  const uint8_t* row = p_recv + (k / f) * p;
  const int fs = fsize[k];
  const int base = pbase[k];
  const int cum = f_cum[k];
  const int last = add_wrap(fs, -1);
  bool got[ADV_REACH];
#pragma unroll
  for (int j = 0; j < ADV_REACH; ++j) {
    const int c = add_wrap(cum, j);
    const bool r = row[gather_index(add_wrap(base, min(c, last)), p)] != 0;
    got[j] = r & (c < fs);
  }
  int adv = 0;
  bool run = true;
#pragma unroll
  for (int j = 0; j < ADV_REACH; ++j) {
    run = run && got[j];
    adv += run;
  }
  out[k] = min(add_wrap(cum, adv), fs);
}

// The pick's constants: edges (host memory, n_edges floats) gives the
// first EDGE_ARGS by value, edges_dev (their device copy) the rest.
PickArgs pick_args(const void* edges, const void* edges_dev, int n_edges,
                   int quantized, int site, uint32_t t, int h, int nq) {
  PickArgs a;
  const float* e = static_cast<const float*>(edges);
  for (int q = 0; q < EDGE_ARGS; ++q)
    a.edge[q] = q < n_edges ? e[q] : INFINITY;
  a.n_tail = n_edges > EDGE_ARGS ? n_edges - EDGE_ARGS : 0;
  a.tail = a.n_tail > 0 ? static_cast<const float*>(edges_dev) + EDGE_ARGS
                        : nullptr;
  a.quantized = quantized != 0;
  a.site_key = (uint32_t)site << 16;
  a.t = t;
  a.h = h;
  a.nq = nq;
  return a;
}

// EnqArgs of the shared enqueue operands; 0 or an error code.
int enq_args(EnqArgs& e, const void* qbuf, const void* qhead,
             const void* qcnt, const void* alive, const void* apk, int cap,
             int ecn_thresh, int rows, int m, int nq, void* hash, int hsize,
             void* qbuf_out, void* qcnt_out, void* enq_try, void* do_enq,
             void* occ_after, void* marked) {
  if (rows < 1 || m < 0 || nq < 1 || cap < 1 || hsize < 1 ||
      (hsize & (hsize - 1)) != 0 || hsize < 2 * m)
    return (int)cudaErrorInvalidValue;
  e.qbuf = static_cast<const int32_t*>(qbuf);
  e.qhead = static_cast<const int32_t*>(qhead);
  e.qcnt = static_cast<const int32_t*>(qcnt);
  e.alive = static_cast<const uint8_t*>(alive);
  e.apk = static_cast<const int32_t*>(apk);
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
  if ((int64_t)rows * e.tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// (rows, m) choosers; qcnt (rows, nq); dead (rows, m, h) uint8; pad_pen
// (rows, h); seeds (rows,) int32 bit patterns of the uint32 key words; t
// the slot as uint32; edges n_edges floats in host memory and edges_dev
// their device copy (quantized 0: plain JSQ, the edges unused).  Returns
// cudaGetLastError().
int slot_jsq_pick(const void* qcnt, const void* qbase, const void* ids,
                  const void* dead, const void* pad_pen, const void* seed_lo,
                  const void* seed_hi, uint32_t t, int site, const void* edges,
                  const void* edges_dev, int n_edges, int quantized, int rows,
                  int m, int nq, int h, void* out, void* stream) {
  if (h < 1 || rows < 1 || m < 1 || nq < 1 || n_edges < 0 ||
      (n_edges > EDGE_ARGS && edges_dev == nullptr))
    return (int)cudaErrorInvalidValue;
  const PickArgs a =
      pick_args(edges, edges_dev, n_edges, quantized, site, t, h, nq);
  int glog = 0;
  while ((1 << glog) < min(h, 32)) ++glog;
  const int per = PICK_THREADS >> glog;     // choosers a CTA
  const int tiles = (m + per - 1) / per;
  if ((int64_t)rows * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  jsq_pick_kernel<<<(unsigned)((int64_t)rows * tiles), PICK_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qcnt), static_cast<const int32_t*>(qbase),
      static_cast<const int32_t*>(ids), static_cast<const uint8_t*>(dead),
      static_cast<const float*>(pad_pen),
      static_cast<const int32_t*>(seed_lo),
      static_cast<const int32_t*>(seed_hi), a, m, tiles, glog,
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
  EnqArgs e;
  const int err = enq_args(e, qbuf, qhead, qcnt, alive, apk, cap, ecn_thresh,
                           rows, m, nq, hash, hsize, qbuf_out, qcnt_out,
                           enq_try, do_enq, occ_after, marked);
  if (err != 0) return err;
  PlainLanes lanes;
  lanes.aq = static_cast<const int32_t*>(aq);
  lanes.avalid = static_cast<const uint8_t*>(avalid);
  enqueue_kernel<<<(unsigned)(rows * e.tiles), ENQ_THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(e, lanes);
  return (int)cudaGetLastError();
}

// slot_enqueue's operands (and scratch) plus to_agg (rows, m) uint8, asw
// (rows, m), dead (rows, m, h) uint8, pad_pen (rows, h), seeds and the
// pick's constants (as slot_jsq_pick's); also writes c_fin (rows, m).
int slot_agg_jsq_enqueue(const void* qbuf, const void* qhead,
                         const void* qcnt, const void* alive, const void* apk,
                         const void* aq, const void* to_agg, const void* asw,
                         const void* dead, const void* pad_pen,
                         const void* seed_lo, const void* seed_hi, uint32_t t,
                         int site, const void* edges, const void* edges_dev,
                         int n_edges, int quantized, int cap, int ecn_thresh,
                         int off1, int h, int rows, int m, int nq, void* hash,
                         int hsize, void* qbuf_out, void* qcnt_out,
                         void* c_fin, void* enq_try, void* do_enq,
                         void* occ_after, void* marked, void* stream) {
  if (h < 1 || m < 1 || n_edges < 0 ||
      (n_edges > EDGE_ARGS && edges_dev == nullptr))
    return (int)cudaErrorInvalidValue;
  EnqArgs e;
  const int err = enq_args(e, qbuf, qhead, qcnt, alive, apk, cap, ecn_thresh,
                           rows, m, nq, hash, hsize, qbuf_out, qcnt_out,
                           enq_try, do_enq, occ_after, marked);
  if (err != 0) return err;
  AggLanes lanes;
  lanes.apk = e.apk;
  lanes.aq = static_cast<const int32_t*>(aq);
  lanes.to_agg = static_cast<const uint8_t*>(to_agg);
  lanes.asw = static_cast<const int32_t*>(asw);
  lanes.dead = static_cast<const uint8_t*>(dead);
  lanes.pen = static_cast<const float*>(pad_pen);
  lanes.qcnt = e.qcnt;
  lanes.c_fin = static_cast<int32_t*>(c_fin);
  lanes.k0 = lanes.k1 = 0;
  lanes.p = pick_args(edges, edges_dev, n_edges, quantized, site, t, h, nq);
  lanes.off1 = off1;
  agg_jsq_enqueue_kernel<<<(unsigned)(rows * e.tiles), ENQ_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      e, lanes, static_cast<const int32_t*>(seed_lo),
      static_cast<const int32_t*>(seed_hi));
  return (int)cudaGetLastError();
}

// p_recv (rows, p) uint8 0/1; pk, deliv (rows, m) int32 / uint8; f_cum,
// fsize, pbase (rows, f) int32.  Writes the new bitmap (rows, p) and the
// first missing sequence fm (rows, f).  ctas CTAs a row, each copying
// `tile` bytes of it (a multiple of 16; ctas * tile >= p); the delivered set
// is a bitset of the row (hsize 0) or a table of hsize keys (a power of two
// >= 2 m), in shared memory (shared != 0; at most SACK_SMEM bytes) or in
// `scratch`, rows * ctas * hsize int32 that the kernel clears where it uses
// them (kernel.py:sack_layout chooses).
int slot_sack_update_scan(const void* p_recv, const void* pk,
                          const void* deliv, const void* f_cum,
                          const void* fsize, const void* pbase, int rows,
                          int p, int m, int f, long long tile, int ctas,
                          int hsize, int shared, void* scratch, void* out,
                          void* fm, void* stream) {
  if (rows < 1 || p < 1 || m < 0 || f < 0 || tile < 16 || tile % 16 != 0 ||
      ctas < (p + tile - 1) / tile ||
      hsize < 0 || (hsize & (hsize - 1)) != 0 ||
      (hsize > 0 && hsize < 2 * (long long)m) || (!shared && hsize == 0) ||
      (!shared && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  SackArgs a;
  a.p_recv = static_cast<const uint8_t*>(p_recv);
  a.pk = static_cast<const int32_t*>(pk);
  a.deliv = static_cast<const uint8_t*>(deliv);
  a.f_cum = static_cast<const int32_t*>(f_cum);
  a.fsize = static_cast<const int32_t*>(fsize);
  a.pbase = static_cast<const int32_t*>(pbase);
  a.out = static_cast<uint8_t*>(out);
  a.fm = static_cast<int32_t*>(fm);
  a.scratch = static_cast<int32_t*>(scratch);
  a.tile = tile;
  a.p = p;
  a.m = m;
  a.f = f;
  a.ctas = ctas;
  a.hsize = hsize;
  a.set_words = hsize == 0 ? (int)(((long long)p + 31) / 32) : hsize;
  a.set_shared = shared != 0;
  const size_t smem = a.set_shared ? (size_t)a.set_words * 4 : 0;
  if (smem > SACK_SMEM || (long long)rows * ctas > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  sack_update_scan_kernel<<<(unsigned)((long long)rows * ctas), SACK_THREADS,
                            smem,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Operands as slot_sack_update_scan; writes the advanced f_cum (rows, f).
int slot_sack_advance(const void* p_recv, const void* f_cum,
                      const void* fsize, const void* pbase, int rows, int p,
                      int f, void* out, void* stream) {
  if (rows < 1 || p < 1 || f < 1) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)rows * f;
  sack_advance_kernel<<<(unsigned)((n + ADV_THREADS - 1) / ADV_THREADS),
                        ADV_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(p_recv), static_cast<const int32_t*>(f_cum),
      static_cast<const int32_t*>(fsize), static_cast<const int32_t*>(pbase),
      p, f, n, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
