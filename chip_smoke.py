"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each timed on its own line; any failure exits non-zero:

1. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once), and read the SASS of the attention and SSD
   libraries with ``cuobjdump``: every instance of the bf16 attention
   kernel and of the bf16 SSD walk must hold ``HGMMA`` (Hopper's warpgroup
   tensor-core instruction);
2. hold each fabric kernel bitwise against its plain PyTorch version on the
   card: ``segmented_cummax`` on random inputs at the engine's sizes and
   flag densities, and with NaNs (which hold to their segment's end, as
   ``jnp.maximum`` gives them) and int64 flags, ``jsq_scan`` on the grids the k=8 points give it (the
   permutation's edge and agg layers and the all-to-all's edge layer,
   ``jsq`` and ``jsq_quant``; the largest all-to-all agg grid is held to
   the plain version in the timing phase; each grid's longest walked prefix
   is printed beside its ``pad``), on random grids of 33 and 64 ports (more
   than a warp has lanes), and on grids at the edges of the walk (an empty
   row, a full row, packets that are not a prefix, ``pad`` 1 and 400, 4, 8,
   33 and 64 ports, 0, 3 and 10 bin edges), each through both walks
   (``registers`` and ``lanes``) where both apply;
3. drive the fast engine's main path: on the paper's k=8 fat tree, the
   1 MB inter-pod permutation (32,768 packets) and the all-to-all at 32
   packets per destination (520,192 packets) through ``simulate_megabatch``
   for seeds 0-1 in four fused dispatches per workload ({flow_ecmp,
   host_pkt, host_dr}, switch_pkt, switch_pkt_ar, ofan), with the kernel
   launch counts set to 0 just before each dispatch and read just after.
   Every fused result must equal the port's serial ``simulate`` (seed 0)
   and a ``backend="torch"`` run (plain versions, seed 0) on the card
   bitwise, and seed 0 must match the JAX reference's digests in
   ``tests/torch_golden/fastsim_k8.json``;
4. hold the slotted engine's three slot-step kernels (``jsq_pick``,
   ``enqueue``, ``agg_jsq_enqueue``) bitwise against their plain versions:
   random operands at the k=8 sizes (640 lanes and queues, 195-packet
   buffers, 4 ports), the k=16 sizes (5,120 lanes, 8 ports), 33 and 64
   ports, ``enqueue`` at the edges of its domain (``tests/
   _torch_compare.py``'s cases at 640 lanes and queues: all lanes on one
   queue past ``cap``, targets -1, ``nq`` and beyond, dead queues, ``cap``
   13, 1,280 lanes, 140 rows, queue tiles no lane targets; and at their own
   12 and 17 queues, one tile a row and a one-queue last tile),
   ``agg_jsq_enqueue`` with lanes that are not agg-bound targeting keys
   outside ``[0, nq)``, on the same edge cases with about half the lanes
   agg-bound and at the k=16 sizes, both picks where the occupancy gather
   leaves the row (``qbase`` negative and past ``nq - h``; the reference's
   picks ``[0, 1, 3, 3]`` on its fault case), both picks at the edges of
   their domain (``PICK_CASES``: 0-1,100 bin edges, slots -1, -2**31 and
   2**31 + 5, NaN and +-inf scores, all ports tied or dead, 1-400 ports,
   rows of 2,000-12,300 queues), and operands recorded from
   engine calls at a few slots;
5. drive the slotted engine's main path on the k=8 fat tree: the 1 MB
   permutation ``permutation(tree, 256, default_rng(1))`` failure-free, and
   fig 3's point (1 % of links failed, ``rho = rho_max``, ``rto_slots=300``,
   G = infinity), through ``loopsim.simulate_megabatch`` for seeds 0-1, one
   fused dispatch per pipeline identity, with the launch counts set to 0
   just before each dispatch and read just after.  Every fused result must
   equal the port's serial ``simulate`` (seed 0) and an ``impl="torch"``
   run (plain versions) on the card bitwise, and seed 0 must match the JAX
   reference's digests in ``tests/torch_golden/loopsim_k8.json``;
6. hold the SACK kernels (``sack_update_scan``, ``sack_advance``) bitwise
   against their plain versions: random operands at the k=8 sizes (32,768
   packets, 128 flows, 640 lanes) and the k=16 sizes (262,144-packet rows,
   1,024 flows, 5,120 lanes) with empty flows, fully received windows and
   repeated delivery targets, outside the engine's domain (negative and
   out-of-range ``pk``, windows before the row's start and past its end,
   flows of size <= 0 whose windows start below ``fsize - 1``, acks past
   the flow's end and within 64 of INT_MAX), at the edges of
   ``sack_update_scan``'s grid (rows shorter than a tile, a tile and a
   byte, rows at every alignment mod 16, windows across tile boundaries,
   no lanes, no flows, each form of the delivered set), and operands
   recorded from engine calls;
7. drive the SACK main path on the k=8 fat tree, one fused dispatch per
   pipeline identity for seeds 0-1: the ``fig12`` preset's grid
   (``sack_thresh=32``) and fig 9's 20-packet buffers (``sack_thresh=8``,
   whose drops make the retransmit path run), with the same equalities as
   phase 5 against ``tests/torch_golden/sack_faults_phases_k8.json``;
8. drive both engines under a fault schedule: a link flap (down at slot
   64, up at 192; hosts react 16 slots later, switches 48) on the
   inter-pod 1 MB permutation, on the slotted engine (erasure,
   ``rto_slots=250``) for the ``flap`` preset's schemes and on the fast
   engine for host_pkt, switch_pkt and ofan, whose packets bind to all
   three epochs;
9. drive the fast engine on the ``train_iter`` preset's collective phases:
   DeepSeek-V3 671B at ep = dp = 8, two iterations, 8 and 16 packets per
   flow, for its four schemes;
10. ``campaign``: the campaign pipeline, through the port's CLI in this
    process (``repro_torch.sweep.__main__.main`` with an argv, on the
    card): ``run --preset table2 --k 8 --seeds 0,1`` (28 points, 8 fused
    fast-engine dispatches) and ``run --preset fig12 --k 8 --seeds 0`` (5
    SACK points, 4 fused slotted-engine dispatches), each with every
    kernel's launch count set to 0 just before and read just after (each
    kernel of its path must have launched).  ``results.jsonl`` must equal
    ``tests/torch_golden/sweep_k8.json`` (the JAX reference runner on CPU
    JAX) byte for byte and the trace its spans after ``strip_timing``,
    apart from the slot-step ``impl`` (``"cuda"`` here); a ``--resume`` of
    the same ``--out`` must keep the bytes and re-run nothing; ``report``
    must render.  Each campaign's wall seconds and dispatch seconds are
    printed;
11. ``attention_vs_plain``: hold both flash-attention kernels to their plain
    version (bf16: the tensor-core kernel at atol = rtol = 2e-2; float32:
    the CUDA-core kernel at 2e-5; the reference's own tolerances) at Yi-6B's
    heads (32 query heads, 4 KV heads, D = 128) for S = 1-2,048, two query
    tails, D = 32, 64, 96, Zamba2-2.7B's shared block (32 query and 32 KV
    heads of D = 80), D = 36, 136 and 256, v of another width than q
    and k (MLA's 192/128 among them), causal with more queries than keys
    (the first Sq - Sk rows see no key and give the mean of v) on both
    kernels, and float16 and mixed dtypes (read in float32, the CUDA-core
    kernel, at 2e-2);
12. ``serve_golden``: Yi-6B at full width, 2 layers, float32 (the float32
    attention kernel's path: its launch count is set to 0 just before this
    phase and phase 15 and read just after), with the
    numpy-drawn weights of ``tests/torch_golden/serve_yi6b_l2.json``; two
    prompts (37 and 256 tokens) decoded 4 greedy steps on the card must give
    the golden's tokens and its logits within 1e-3 (CPU JAX made it);
13. ``serve_main_path``: Yi-6B at full width and depth in bf16, random
    weights from a ``torch.Generator`` on the card.  A ``ContinuousBatcher``
    (4 slots of 2,304 positions) answers 8 requests of 13-2,048 prompt
    tokens and 16 new tokens each, and ``greedy_decode`` a batch of two
    100-token prompts, with the flash-attention launch count set to 0 just
    before and read just after (one launch a layer a prefill).  Each
    request's batcher run must match its solo decode, and the kernel
    path's the plain path's: prefill logits and every compared step's
    logits within 0.1, tokens equal; a differing token passes only where
    the reference run's top-2 margin is under twice that step's logit gap
    (printed);
14. ``ssd_vs_plain``: hold the SSD chunked-scan kernels (bf16: the
    tensor-core walk; float32: the CUDA-core route) to the plain
    ``ssd_chunked``, and the final state they return to the plain
    ``ssd_final_state``, at Zamba2-2.7B's heads (80 of P = 64, N = 64),
    Mamba2-130M's (24 of P = 64, N = 128) and the reference's grouped shape
    (8 heads over 4 groups) for L = 1, 37, 64, 100 and 2,048 at batch 1 and
    2 (float32 at the reference's 5e-5/5e-4, bf16 at 2e-2), requested
    chunks of 1, 16, 32 and 63 (the bf16 walk runs them as 64), a large-decay
    case per head shape (``A * dt`` summing past 100 within a chunk: finite
    and within tolerance), P = 100-128 and N = 200-256 at a requested chunk
    of 128, float16 and mixed dtypes of x, B and C (read in float32, the
    CUDA-core route, at 2e-2), and, at L <= 100 in float32, to the
    sequential ``ssd_scan`` too;
15. ``ssm_serve_golden``: Mamba2-130M at full size and Zamba2-2.7B at full
    width cut to 6 layers (one shared-block application), float32, numpy
    weights, held to ``tests/torch_golden/serve_ssm.json`` (CPU JAX) as
    phase 12 holds Yi-6B;
16. ``ssm_serve_main_path``: Zamba2-2.7B at full width and depth in bf16
    through phase 13's batcher mix, ``greedy_decode`` and checks, with the
    ``ssd_scan`` and ``flash_attention`` launch counts set to 0 just before
    and read just after (54 and 9 a prefill, every one on the tensor-core
    kernels); then Mamba2-130M at full size the same way with 4 requests
    (24 ``ssd_scan`` launches a prefill);
17. time each kernel and its plain version on the largest inputs the main
    paths gave it, beside the bound of the card (and, for flash attention,
    one ``scaled_dot_product_attention`` call as the library's time; no
    single PyTorch call computes the SSD scan); the float32 attention kernel
    and the float32 SSD route are timed on those inputs in float32, the SSD
    walk with 32 and with 64 P columns a CTA, and ``jsq_scan`` through both
    walks, beside its longest walked prefix and the device time a walked
    step; and the launch floor, one 1-element ``add_`` timed the same way;
18. ``serve_profile``: a decode step and a 2,048-token prefill of
    Yi-6B, Zamba2-2.7B and Mamba2-130M under ``torch.profiler``: wall
    time, device busy time, idle share, kernel launches, host
    synchronisations and the five device events with the most time (last,
    as a profiler session followed by long unprofiled work left later
    traces short of kernel events).

Every main-path run of phases 3, 5, 7-10, 13 and 16 sets the kernels'
launch counts to 0 just before it and reads them just after.

The last lines are the ``kernels`` JSON line, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN = ROOT / "tests" / "torch_golden" / "fastsim_k8.json"
LOOP_GOLDEN = ROOT / "tests" / "torch_golden" / "loopsim_k8.json"
SFP_GOLDEN = ROOT / "tests" / "torch_golden" / "sack_faults_phases_k8.json"
SERVE_GOLDEN = ROOT / "tests" / "torch_golden" / "serve_yi6b_l2.json"
SSM_GOLDEN = ROOT / "tests" / "torch_golden" / "serve_ssm.json"
SWEEP_GOLDEN = ROOT / "tests" / "torch_golden" / "sweep_k8.json"
CAMPAIGN_OUT = ROOT / "build" / "chip_smoke_campaign"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and non-tensor fp32.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

SCHEME_GROUPS = (("flow_ecmp", "host_pkt", "host_dr"), ("switch_pkt",),
                 ("switch_pkt_ar",), ("ofan",))
SEEDS = (0, 1)            # the fast engine's main path: seeds 0-1
LOOP_SEEDS = (0, 1)       # the slotted engine's main path: seeds 0-1
# The slotted engine's fused dispatches: one per pipeline identity.
LOOP_GROUPS = {
    "free": (("host_pkt", "flow_ecmp", "host_dr"), ("host_pkt_ar",),
             ("host_flowlet_ar",), ("switch_pkt",), ("switch_pkt_ar",),
             ("jsq",), ("ofan",)),
    "fig3": (("host_pkt",), ("switch_pkt",), ("host_pkt_ar",),
             ("switch_pkt_ar",), ("ofan",)),
}
LOOP_MAX_SLOTS = 60_000
SLOT_KERNELS = ("jsq_pick", "enqueue", "agg_jsq_enqueue")
SACK_KERNELS = ("sack_update_scan", "sack_advance")
# The SACK, fault-schedule and phase points (phases 7-9), one fused dispatch
# per pipeline identity; their JAX digests are in SFP_GOLDEN.
SACK_GROUPS = {"fig12": (("host_pkt", "host_dr"), ("switch_pkt_ar",),
                         ("host_pkt_ar",), ("ofan",)),
               "fig9": (("host_pkt",),)}
FLAP = dict(layer="ea", pod=0, i=0, j=1, t0=64, period=128, cycles=1,
            host_react=16, switch_react=48)
FLAP_LOOP_GROUPS = (("host_pkt_ar",), ("switch_pkt_ar",), ("ofan",))
FLAP_FAST_GROUPS = (("host_pkt",), ("switch_pkt",), ("ofan",))
TRAIN_GROUPS = (("flow_ecmp", "host_pkt", "host_dr"), ("ofan",))
TRAIN_LOADS = (8, 16)
TRAIN_PROP = 12.0            # the train_iter campaign's prop_slots
CUMMAX_SIZES = (0, 1, 1023, 1025, (1 << 20) + 3, 6_242_304)
DENSITIES = ("first", 1e-3, 0.5, "all")
# segmented_cummax with NaNs: the documented case ([1, 5, nan, 2, 7, 3, 0,
# 9], flags at 0 and 5) and random inputs of these sizes, about 1 % NaN,
# int64 flags of 0 or 7; each also as 4 rows.
CUMMAX_NAN_SIZES = (1 << 16, (1 << 20) + 4)
# The campaign phase: each campaign of the golden and the kernels its path
# must launch.
CAMPAIGN_KERNELS = {
    "table2": ("segmented_cummax", "jsq_scan"),
    "fig12": ("jsq_pick", "enqueue", "agg_jsq_enqueue", "sack_update_scan",
              "sack_advance"),
}


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def check(cond, msg: str):
    if not cond:
        fail(msg)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        print(f"== phase {self.name}", flush=True)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            print(f"phase {self.name}: {time.perf_counter() - self.t0:.2f} s",
                  flush=True)
        return False


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, kernel_re: str):
    """Mean device milliseconds per call of the CUDA kernels whose names
    match ``kernel_re``, from a ``torch.profiler`` trace of ``reps`` calls
    after one warm-up call (None when the trace holds no device time)."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    pat = re.compile(kernel_re)
    total_us = sum(getattr(e, "device_time_total", 0.0)
                   for e in prof.key_averages() if pat.search(e.key))
    return total_us / reps / 1e3 if total_us > 0 else None


def cuda_once(fn):
    """(result, milliseconds) of one call on the card."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def max_abs_err(a, b) -> float:
    import torch
    if torch.equal(a, b):
        return 0.0
    return float((a.double() - b.double()).abs().max())


class Recorder:
    """Wraps a kernel wrapper to keep the largest call's arguments, and with
    ``keep_every=k`` every k-th call's (the wrapped call and its launch
    count are unchanged)."""

    def __init__(self, module, name, size_of, keep_every=0):
        self.module, self.name, self.size_of = module, name, size_of
        self.keep_every = keep_every
        self.orig = getattr(module, name)
        self.calls = []
        self.n_calls = 0
        self.largest = None

    def __enter__(self):
        def rec(*args, **kw):
            if self.largest is None or (self.size_of(args)
                                        > self.size_of(self.largest[0])):
                self.largest = (args, kw)
            if self.keep_every and self.n_calls % self.keep_every == 0:
                self.calls.append((args, kw))
            self.n_calls += 1
            return self.orig(*args, **kw)
        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)
        return False


class HostTimer:
    """Sums the time a dispatch spends in its engine module's host-side
    preparation (``_prepare`` and ``_draw_seed_inputs``, numpy) by wrapping
    both for the duration of the block."""

    NAMES = ("_prepare", "_draw_seed_inputs")

    def __init__(self, module):
        self.module = module
        self.ms = 0.0

    def __enter__(self):
        self.orig = {n: getattr(self.module, n) for n in self.NAMES}

        def timed(fn):
            def call(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    self.ms += (time.perf_counter() - t0) * 1e3
            return call
        for n, fn in self.orig.items():
            setattr(self.module, n, timed(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.module, n, fn)
        return False


# The tensor-core kernels: (library, kernel name); every instance of each
# must hold HGMMA.
TC_KERNELS = (("flash_attn", "flash_attention_wgmma_kernel"),
              ("ssd_scan", "ssd_wgmma_kernel"))


def sass_check(build):
    """Every instance of each tensor-core kernel in its built library must
    hold HGMMA (wgmma, Hopper's warpgroup tensor-core instruction)."""
    import re
    tool = Path(build._nvcc()).parent / "cuobjdump"
    for lib, kernel in TC_KERNELS:
        sass = subprocess.run([str(tool), "-sass", str(build.lib_path(lib))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        funcs = re.split(r"\n\s*Function : ", sass)[1:]
        wg = [f for f in funcs if kernel in f.split("\n", 1)[0]]
        counts = [f.count("HGMMA") for f in wg]
        check(wg and all(counts), f"{lib}: the SASS of {kernel} holds no "
              f"HGMMA ({len(wg)} instances, HGMMA counts {counts})")
        print(f"{lib} SASS: {len(wg)} instances of {kernel}, each holding "
              f"HGMMA ({min(counts)}-{max(counts)} instructions): it runs on "
              f"wgmma; HMMA in the library: {sass.count('HMMA')}",
              flush=True)


def cummax_nan_inputs(case, gen, dev):
    """(v, int64 flags) on the card: the documented case, or ``case``
    random values with about 1 % NaN and flags of 0 or 7."""
    import torch
    if case == "documented":
        v = torch.tensor([1, 5, float("nan"), 2, 7, 3, 0, 9])
        f = torch.zeros(8, dtype=torch.int64)
        f[[0, 5]] = 1
        return v.to(dev), f.to(dev)
    v = torch.randn(case, generator=gen) * 100
    v[torch.rand(case, generator=gen) < 0.01] = float("nan")
    f = (torch.rand(case, generator=gen) < 0.02).to(torch.int64) * 7
    f[0] = 7
    return v.to(dev), f.to(dev)


def jsq_grid(B, S, pad, h, quanta, gen, dev):
    """Random operands of the JSQ scan: 80 % of cells hold a packet, arrival
    times in [0, pad / 2), row 1's last port padded."""
    import torch
    from repro_torch.net._batching import port_pad_penalty
    ok = torch.rand((B, S, pad), generator=gen) < 0.8
    t = (torch.randint(0, max(pad // 2, 1), (B, S, pad), generator=gen)
         + torch.rand((B, S, pad), generator=gen)).float()
    t = torch.where(ok, t, torch.tensor(-1e9))
    noise = torch.rand((B, S, pad, h), generator=gen)
    pen = port_pad_penalty(h, torch.tensor([h - (b % 2) for b in range(B)],
                                           dtype=torch.int32))
    thr = (None if quanta is None
           else (torch.tensor(quanta, dtype=torch.float32) * 40).to(dev))
    return t.to(dev), ok.to(dev), noise.to(dev), pen.to(dev), thr


def walked(ok_grid) -> int:
    """The longest walked prefix of a JSQ grid: the last occupied cell of
    any row, plus one."""
    import torch
    pad = ok_grid.shape[-1]
    idx = torch.arange(pad, device=ok_grid.device)
    return int(torch.where(ok_grid, idx, -1).amax().item()) + 1


def cummax_inputs(n, density, gen, dev):
    import torch
    v = torch.randn(n, generator=gen, device="cpu").mul_(100).to(dev)
    if density == "first":
        f = torch.zeros(n, dtype=torch.bool)
        f[:1] = True
    elif density == "all":
        f = torch.ones(n, dtype=torch.bool)
    else:
        f = torch.rand(n, generator=gen) < density
    return v, f.to(dev)


def same_results(a, b) -> bool:
    import numpy as np
    if not (np.array_equal(a.delivery, b.delivery)
            and np.array_equal(a.a_used, b.a_used)
            and np.array_equal(a.c_used, b.c_used)
            and np.array_equal(a.flow_completion, b.flow_completion)
            and a.cct == b.cct and a.max_queue == b.max_queue):
        return False
    return all(np.array_equal(la.counts, b.layers[k].counts)
               and la.max_queue == b.layers[k].max_queue
               and la.avg_wait == b.layers[k].avg_wait
               for k, la in a.layers.items())


def sane(res, wl, tree) -> bool:
    import numpy as np
    inter = tree.host_pod(wl.src) != tree.host_pod(wl.dst)
    return (res.delivery.shape == (wl.n_packets,)
            and np.isfinite(res.delivery).all()
            and int(res.layers["E->H"].counts.sum()) == wl.n_packets
            and int(res.layers["A->C"].counts.sum()) == int(inter.sum())
            and res.cct >= float(wl.t_release.max()))


def slot_operands(seed, B, M, cap, h, n_aggs, dev):
    """Random operands of the slot-step kernels at engine sizes (queues =
    lanes = M; few distinct target queues, so arrivals rank and overflow)."""
    import numpy as np
    import torch
    from repro_torch.net._batching import port_pad_penalty
    r = np.random.default_rng(seed)
    t = torch.from_numpy
    P = 32768
    o = dict(qcnt=t(r.integers(0, cap, (B, M)).astype(np.int32)),
             qbuf=t(r.integers(-1, P, (B, M, cap)).astype(np.int32)),
             qhead=t(r.integers(0, cap, (B, M)).astype(np.int32)),
             qbase=t(r.integers(0, M - h, (B, M)).astype(np.int32)),
             ids=t(r.integers(0, P, (B, M)).astype(np.int32)),
             dead=t(r.random((B, M, h)) < 0.2),
             pad_pen=port_pad_penalty(h, torch.tensor(
                 [h - (b % 2) for b in range(B)], dtype=torch.int32)),
             alive=t(r.random((B, M)) < 0.95),
             apk=t(np.where(r.random((B, M)) < 0.8,
                            r.integers(0, P, (B, M)), -1).astype(np.int32)),
             aq=t(r.integers(0, M // 4, (B, M)).astype(np.int32) * 4),
             asw=t(r.integers(0, n_aggs, (B, M)).astype(np.int32)),
             seed_lo=t(r.integers(0, 2**32, B).astype(np.int64)),
             seed_hi=t(r.integers(0, 2**32, B).astype(np.int64)))
    o["avalid"] = o["apk"] >= 0
    o["to_agg"] = o["avalid"] & t(r.random((B, M)) < 0.5)
    return {k: v.to(dev) for k, v in o.items()}


def same_loop(a, b) -> bool:
    import numpy as np
    return (all(np.array_equal(getattr(a, k), getattr(b, k))
                for k in ("delivered_slot", "flow_complete_slot",
                          "flow_data_done_slot"))
            and all(getattr(a, k) == getattr(b, k)
                    for k in ("cct_slots", "cct_acked_slots", "drops",
                              "retransmissions", "max_queue", "avg_queue",
                              "finished", "mean_cwnd")))


def loop_sane(res, wl, cfg) -> bool:
    import numpy as np
    d = res.delivered_slot
    # Erasure coding needs any fsize symbols of a flow, so a packet whose
    # copies were all dropped may stay undelivered (-1); SACK delivers every
    # packet, and completes a flow when its cumulative ack reaches the end,
    # which may come before the slot its last delivery is counted at.
    erasure = cfg.loss == "erasure"
    return (d.shape == (wl.n_packets,) and res.finished
            and d.min() >= (-1 if erasure else 0) and d.max() > 0
            and (res.flow_complete_slot >= 0).all() and res.cct_slots > 0
            and res.cct_acked_slots >= (res.cct_slots if erasure else 1)
            and np.isfinite(res.avg_queue) and res.max_queue > 0)


# Integer and float operations of one Threefry-2x32 draw and its score,
# per (chooser, port): 20 rounds of add, rotate (3 ops) and xor, 5 key
# injections, the counter set-up, the uniform and the score.
PRF_OPS = 125


def slot_timing(name, largest, err, launches):
    """The kernel's row of the ``kernels`` line, at the largest input the
    main path gave it: ms per launch, its plain version's, and the bound."""
    import torch
    from repro_torch.kernels.slot_step import ops as slot_ops
    args, kw = largest
    kw = {k: v for k, v in kw.items() if k != "backend"}
    fn = getattr(slot_ops, name)
    got = fn(*args, **kw)
    want = fn(*args, backend="torch", **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"{name}: kernel != plain on the main path's largest input")
    ms = cuda_ms(lambda: fn(*args, **kw), 50)
    dev_ms = device_ms(lambda: fn(*args, **kw), 50, rf"\b{name}_kernel\(")
    plain_ms = cuda_ms(lambda: fn(*args, backend="torch", **kw), 5)
    if name == "jsq_pick":
        qcnt, qbase, _, dead = args[:4]
        B, M = qbase.shape
        h = dead.shape[-1]
        nbytes = qcnt.numel() * 4 + B * M * (4 + 4 + h + 4) + B * h * 4
        ops = B * M * h * PRF_OPS
        shape = [B, M, h]
    else:
        qbuf, aq = args[0], args[5]
        B, NQ, cap = qbuf.shape
        M = aq.shape[1]
        # The rank: a per-key counter advanced once an enqueue-trying lane
        # (this input's lanes; a compare, an add and a write each).
        enq_try = want[3] if name == "agg_jsq_enqueue" else want[2]
        ops = 3 * int(enq_try.sum())
        nbytes = (2 * qbuf.numel() * 4 + B * NQ * (4 + 4 + 1 + 4)
                  + B * M * (4 + 4 + 1) + B * M * (1 + 1 + 4 + 1))
        shape = [B, NQ, cap, M]
        if name == "agg_jsq_enqueue":
            h = args[8].shape[-1]
            nbytes += B * M * (1 + 4 + h + 4) + B * h * 4
            ops += B * M * h * PRF_OPS
            shape.append(h)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return dict(
        name=name, route="cuda", source="src/repro_torch/csrc/slot_step.cu",
        replaces={"jsq_pick": "src/repro/kernels/slot_step/kernel.py:126",
                  "enqueue": "src/repro/kernels/slot_step/kernel.py:203",
                  "agg_jsq_enqueue":
                  "src/repro/kernels/slot_step/kernel.py:240"}[name],
        launches=launches, max_abs_err=err, ms=ms, device_ms=dev_ms,
        plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None, n=int(B * M), shape=shape)


def loop_phases(tree, dev, errs, launches, loop_golden):
    """The slotted engine's phases: its three slot-step kernels against
    their plain versions, then its main path (``LOOP_GROUPS`` at seeds
    ``LOOP_SEEDS``), with launches added to ``launches`` and errors to
    ``errs``.
    Returns the main path's slot-step launches and the recorders that kept
    each kernel's largest main-path input."""
    import numpy as np
    import torch
    from repro_torch.core import lb_schemes
    from repro_torch.kernels.slot_step import ops as slot_ops
    from repro_torch.net import loopsim, workloads
    from repro_torch.net.topology import LinkState, rho_max

    # ---- the slotted engine ------------------------------------------------
    for name in SLOT_KERNELS:
        errs[name] = 0.0
    kw_of = {
        "jsq_pick": lambda o, q: dict(site=3, quanta=q,
                                      cap=o["qbuf"].shape[2]),
        "enqueue": lambda o, q: dict(cap=o["qbuf"].shape[2], ecn_thresh=97),
        "agg_jsq_enqueue": lambda o, q: dict(
            site=4, quanta=q, cap=o["qbuf"].shape[2], ecn_thresh=97,
            off1=o["qbuf"].shape[1] // 5, h=o["pad_pen"].shape[1])}
    arg_keys = {
        "jsq_pick": ("qcnt", "qbase", "ids", "dead", "pad_pen", "seed_lo",
                     "seed_hi"),
        "enqueue": ("qbuf", "qhead", "qcnt", "alive", "apk", "aq", "avalid"),
        "agg_jsq_enqueue": ("qbuf", "qhead", "qcnt", "alive", "apk", "aq",
                            "to_agg", "asw", "dead", "pad_pen", "seed_lo",
                            "seed_hi")}

    def slot_check(name, args, kw, what):
        fn = getattr(slot_ops, name)
        kw = {k: v for k, v in kw.items() if k != "backend"}
        got = fn(*args, **kw)
        want = fn(*args, backend="torch", **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            err = max_abs_err(g, w)
            errs[name] = max(errs[name], err)
            check(g.dtype == w.dtype and torch.equal(g, w),
                  f"{name} {what}: kernel != plain (err {err})")

    quanta3 = (0.05, 0.10, 0.20)
    lwl = workloads.permutation(tree, 256, np.random.default_rng(1))
    links3 = LinkState.random_failures(tree, 0.01, seed=42)
    rho3 = float(rho_max(tree, links3, lwl.flow_src, lwl.flow_dst))
    check(rho3 == loop_golden["fig3"]["rho"], "fig 3 rho_max differs")
    loop_pts = {
        "free": (loopsim.LoopConfig(max_slots=LOOP_MAX_SLOTS), None),
        "fig3": (loopsim.LoopConfig(max_slots=LOOP_MAX_SLOTS, rho=rho3,
                                    rto_slots=300), links3)}

    with Phase("loop_kernels_vs_plain"):
        n_cases = 0
        for B, M, h, n_aggs in ((4, 640, 4, 32), (4, 5120, 8, 128),
                                (2, 640, 33, 8), (2, 1280, 64, 16)):
            for quanta in (None, quanta3):
                o = slot_operands(M + 10 * h + (quanta is None), B, M, 195, h,
                                  n_aggs, dev)
                for name in SLOT_KERNELS:
                    if name == "enqueue" and quanta is not None:
                        continue
                    args = [o[k] for k in arg_keys[name]]
                    if name != "enqueue":
                        args.append(77)
                    slot_check(name, args, kw_of[name](o, quanta),
                               f"random B={B} M={M} h={h} quanta={quanta}")
                    n_cases += 1
        # enqueue at the edges of its domain (tests/_torch_compare.py's
        # cases at the k=8 slot's 640 lanes and queues, and 140 rows): a hot
        # queue past cap, targets -1, nq and beyond (a negative target
        # wraps once; two lanes on one cell, the later wins), dead queues,
        # cap = 195 and 13, 1,280 lanes, tiles no lane targets; the cases
        # whose point is their queue count (one tile a row, a one-queue
        # last tile) and the wide row at their own sizes.
        from _torch_compare import (
            AGG_OOB_KW, AGG_PICK_OOB_KW, ENQUEUE_CASES, PICK_CASES,
            PICK_FAULT_KW, agg_case_operands, agg_oob_operands,
            agg_pick_case_operands, agg_pick_oob_operands, enqueue_operands,
            pick_case_operands, pick_fault_operands, pick_oob_operands,
            to_torch)

        def on_card(ops):
            return [to_torch(a).to(dev) for a in ops]

        for case in sorted(ENQUEUE_CASES):
            cap = ENQUEUE_CASES[case][3]
            own = case in ("wide_row", "one_tile", "tail_tile")
            size = None if own else (640, 640, 13 if cap == 13 else 195)
            for rows in ((None, 140) if case == "cap_195" else (None,)):
                ops, cap = enqueue_operands(case, seed=n_cases, rows=rows,
                                            size=size)
                args = [torch.from_numpy(a).to(dev) for a in ops]
                slot_check("enqueue", args,
                           dict(cap=cap, ecn_thresh=cap // 2),
                           f"{case} rows={args[0].shape[0]} lanes="
                           f"{args[5].shape[1]} cap={cap}")
                n_cases += 1
        # agg_jsq_enqueue: lanes that are not agg-bound on keys outside
        # [0, nq) (a negative key wraps once; two keys share a ring cell).
        for seed in (0, 1):
            *ops, t = agg_oob_operands(seed)
            slot_check("agg_jsq_enqueue", on_card(ops) + [t],
                       AGG_OOB_KW, f"out-of-range keys seed={seed}")
            n_cases += 1
        # agg_jsq_enqueue on the enqueue's edge cases, about half the valid
        # lanes agg-bound (at the sizes above), and at the k=16 slot's 5,120
        # lanes and queues with 8 ports.
        for case in sorted(ENQUEUE_CASES):
            cap = ENQUEUE_CASES[case][3]
            own = case in ("wide_row", "one_tile", "tail_tile")
            size = None if own else (640, 640, 13 if cap == 13 else 195)
            (*ops, t), kw = agg_case_operands(case, seed=n_cases, size=size)
            slot_check("agg_jsq_enqueue", on_card(ops) + [t],
                       kw, f"{case} lanes={ops[5].shape[1]} (agg)")
            n_cases += 1
        (*ops, t), kw = agg_case_operands("cap_195", seed=16,
                                          size=(5120, 5120, 195), h=8)
        slot_check("agg_jsq_enqueue", on_card(ops) + [t], kw,
                   "k=16 sizes (agg)")
        n_cases += 1
        # Both picks where the occupancy gather leaves the row (a negative
        # index wraps once, then clamps): qbase = [10, -1, -3, 17] of 12
        # queues, qbase anywhere in [-2 nq, 2 nq), and agg-bound lanes whose
        # first port off1 + asw * h lies outside [0, nq - h].
        *ops, t = pick_fault_operands()
        args = on_card(ops) + [t]
        slot_check("jsq_pick", args, PICK_FAULT_KW, "qbase [10, -1, -3, 17]")
        check(slot_ops.jsq_pick(*args, **PICK_FAULT_KW).tolist()
              == [[0, 1, 3, 3]], "jsq_pick: the fault case's picks differ "
              "from the reference's [0, 1, 3, 3]")
        n_cases += 1
        for seed in (0, 1):
            *ops, t = pick_oob_operands(seed)
            slot_check("jsq_pick", on_card(ops) + [t],
                       dict(site=3, quanta=quanta3 if seed else None, cap=12),
                       f"out-of-range qbase seed={seed}")
            *ops, t = agg_pick_oob_operands(seed)
            slot_check("agg_jsq_enqueue", on_card(ops) + [t],
                       AGG_PICK_OOB_KW, f"out-of-range qbase seed={seed}")
            n_cases += 2
        # Both picks at the edges of their domain (PICK_CASES): 0, 10, 16
        # and 1,100 bin edges, the slot -1, -2**31 and 2**31 + 5, NaN and
        # +-inf scores (the first NaN is the pick), all ports tied or dead,
        # h = 1-400, choosers not a multiple of a CTA's tile, and rows of
        # 2,000, 12,285 and 12,300 queues.
        for case in sorted(PICK_CASES):
            (*ops, t), kw = pick_case_operands(case)
            args = on_card(ops) + [t]
            slot_check("jsq_pick", args, kw, case)
            (*ops, _), akw = agg_pick_case_operands(case)
            slot_check("agg_jsq_enqueue", on_card(ops) + [t], akw,
                       f"{case} (agg)")
            n_cases += 2
            if case == "nan_score":
                check(slot_ops.jsq_pick(*args, **kw).tolist()
                      == [[1] * 64, [2] * 64, [3] * 64],
                      "jsq_pick: a NaN score's row does not pick its first "
                      "NaN")
        # Operands recorded from engine calls, every 100th slot.
        recs = [Recorder(slot_ops, name, lambda a: a[0].numel(),
                         keep_every=100) for name in SLOT_KERNELS]
        for r in recs:
            r.__enter__()
        try:
            for pname, scheme in (("free", "jsq"), ("fig3", "ofan"),
                                  ("fig3", "switch_pkt_ar")):
                cfg, links = loop_pts[pname]
                loopsim.simulate(tree, lwl, lb_schemes.by_name(scheme), cfg,
                                 seed=1, links=links)
        finally:
            for r in recs:
                r.__exit__()
        for r in recs:
            check(r.calls, f"{r.name}: no engine call recorded")
            for i, (args, kw) in enumerate(r.calls):
                slot_check(r.name, args, kw, f"engine call {i}")
                n_cases += 1
        print(f"slot-step kernels: {n_cases} cases bitwise equal to the plain "
              f"versions (tolerance: bitwise, max_abs_err 0)", flush=True)

    loop_launches = {name: 0 for name in SLOT_KERNELS + SACK_KERNELS}
    size_of = {"jsq_pick": lambda a: a[1].numel(),
               "enqueue": lambda a: a[0].numel() + a[5].numel(),
               "agg_jsq_enqueue": lambda a: a[0].numel() + a[5].numel()}
    recs = {name: Recorder(slot_ops, name, size_of[name])
            for name in SLOT_KERNELS}
    with Phase("loop_main_path"), recs["jsq_pick"], recs["enqueue"], \
            recs["agg_jsq_enqueue"]:
        for pname, groups in LOOP_GROUPS.items():
            cfg, links = loop_pts[pname]
            for group in groups:
                items = [(tree, lwl, lb_schemes.by_name(s), cfg,
                          list(LOOP_SEEDS), links, None, None)
                         for s in group]
                want = (("jsq_pick", "agg_jsq_enqueue")
                        if group[0] in ("jsq", "switch_pkt_ar")
                        else ("enqueue",))
                if group[0] in ("switch_pkt", "ofan"):
                    want += ("segmented_cummax",)
                loop_group(f"{pname}/{'+'.join(group)}", items,
                           loop_golden["points"], loop_launches, launches,
                           want)
        check(all(loop_launches[k] > 0 for k in SLOT_KERNELS),
              "a slot-step kernel of the main path was never launched")

    return loop_launches, recs


def sack_operands(seed, B, F, M, max_flow, dev):
    """Random SACK scoreboard operands: flows of 0..max_flow packets back to
    back (every 5th empty), some received whole (full 64-windows),
    cumulative acks anywhere in [0, fsize] (some at fsize - 1), deliveries
    with repeated targets."""
    import numpy as np
    import torch
    r = np.random.default_rng(seed)
    fsize = r.integers(1, max_flow + 1, (B, F)).astype(np.int32)
    fsize[:, ::5] = 0
    pbase = (np.cumsum(fsize, axis=1) - fsize).astype(np.int32)
    P = int(fsize.sum(axis=1).max()) + 3
    f_cum = (r.random((B, F)) * (fsize + 1)).astype(np.int32)
    f_cum[:, 1::6] = np.maximum(fsize[:, 1::6] - 1, 0)
    p_recv = r.random((B, P)) < 0.8
    for b in range(B):
        for f in range(3, F, 4):
            p_recv[b, pbase[b, f]:pbase[b, f] + fsize[b, f]] = True
    pk = r.integers(0, P, (B, M)).astype(np.int32)
    pk[:, 1::2] = pk[:, 0::2][:, :M // 2]
    deliv = r.random((B, M)) < 0.5
    pk = np.where(deliv | (r.random((B, M)) < 0.5), pk, -1)
    t = torch.from_numpy
    return {k: t(np.ascontiguousarray(v)).to(dev) for k, v in dict(
        p_recv=p_recv, pk=pk, deliv=deliv, f_cum=f_cum, fsize=fsize,
        pbase=pbase).items()}


SACK_ARGS = {"sack_update_scan": ("p_recv", "pk", "deliv", "f_cum", "fsize",
                                  "pbase"),
             "sack_advance": ("p_recv", "f_cum", "fsize", "pbase")}


def sack_reads(p_recv, f_cum, fsize, pbase):
    """Bitmap entries ``sack_advance`` must read on these inputs: per round,
    the window entries up to and including the first one not received."""
    import torch
    from repro_torch.kernels.slot_step import ref
    n = 0
    cum = f_cum
    for _ in range(2):
        ahead = cum[..., None] + torch.arange(4, device=cum.device)
        got = ref._window_bits(p_recv, pbase, torch.minimum(
            ahead, fsize[..., None] - 1)) & (ahead < fsize[..., None])
        run = torch.cumprod(got.to(torch.int32), dim=2)
        in_flow = (ahead < fsize[..., None]).to(torch.int32)
        # entry w is read when entries 0..w-1 were all received
        prev = torch.cat([torch.ones_like(run[..., :1]), run[..., :-1]], 2)
        n += int((prev * in_flow).sum())
        cum = ref.sack_advance(p_recv, cum, fsize, pbase, rounds=1)
    return n


def sack_timing(name, largest, err, launches):
    """The SACK kernel's row of the ``kernels`` line at the largest input
    the main path gave it."""
    import torch
    from repro_torch.kernels.slot_step import ops as slot_ops
    args, kw = largest
    kw = {k: v for k, v in kw.items() if k != "backend"}
    fn = getattr(slot_ops, name)
    got = fn(*args, **kw)
    want = fn(*args, backend="torch", **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"{name}: kernel != plain on the main path's largest input")
    ms = cuda_ms(lambda: fn(*args, **kw), 50)
    dev_ms = device_ms(lambda: fn(*args, **kw), 50, rf"\b{name}_kernel\(")
    plain_ms = cuda_ms(lambda: fn(*args, backend="torch", **kw), 5)
    p_recv = args[0]
    B, P = p_recv.shape
    if name == "sack_update_scan":
        M, F = args[1].shape[1], args[3].shape[1]
        # the bitmap row in and out, the lanes, three flow operands in and
        # one out; per flow 64 window entries (min, load, compare, ballot)
        nbytes = 2 * B * P + B * M * 5 + B * F * 16
        ops = B * F * 64 * 4 + B * M * 2
        shape = [B, P, M, F]
    else:
        F = args[1].shape[1]
        reads = sack_reads(*args[:4])
        nbytes = reads + B * F * 16
        ops = reads * 4 + B * F * 2 * 2
        shape = [B, P, F]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return dict(
        name=name, route="cuda", source="src/repro_torch/csrc/slot_step.cu",
        replaces={"sack_update_scan":
                  "src/repro/kernels/slot_step/kernel.py:281",
                  "sack_advance":
                  "src/repro/kernels/slot_step/kernel.py:320"}[name],
        launches=launches, max_abs_err=err, ms=ms, device_ms=dev_ms,
        plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None, n=int(B * F), shape=shape)


def loop_group(tag, items, golden, slot_launches, launches, want):
    """One fused slotted-engine dispatch of ``items`` (8-tuples, seeds
    ``LOOP_SEEDS``) with the launch counts set to 0 just before it and read
    just after; every kernel named in ``want`` must have launched.  Holds
    each result to the port's serial ``simulate`` (seed 0), to an
    ``impl="torch"`` run on the card and to the JAX digest
    ``golden[f"{point}/{scheme}"]``; returns the fused results."""
    from repro_torch.kernels.lindley import ops as lindley_ops
    from repro_torch.kernels.slot_step import ops as slot_ops
    from repro_torch.net import loopsim
    from repro_torch.obs.digest import loop_result_digest
    for name in slot_ops.LAUNCHES:
        slot_ops.LAUNCHES[name] = 0
    lindley_ops.LAUNCHES = 0
    loopsim.STEPS = 0
    t0 = time.perf_counter()
    with HostTimer(loopsim) as host:
        fused = loopsim.simulate_megabatch(items)
    ms = (time.perf_counter() - t0) * 1e3
    host_ms = host.ms
    counts = dict(slot_ops.LAUNCHES)
    counts["segmented_cummax"] = lindley_ops.LAUNCHES
    steps = loopsim.STEPS
    for name in slot_ops.LAUNCHES:
        slot_launches[name] += counts[name]
    launches["segmented_cummax"] += counts["segmented_cummax"]
    for name in want:
        check(counts[name] > 0, f"{tag}: {name} never launched")
    point = tag.split("/")[0]
    for (tr, w, scheme, c, seeds, l, g, fz), res in zip(items, fused):
        key = f"{point}/{scheme.name}"
        r0 = res[0]
        print(f"loop point {key} seeds={len(seeds)} "
              f"cct_acked_slots={r0.cct_acked_slots!r} "
              f"cct_slots={r0.cct_slots!r} drops={r0.drops} "
              f"rtx={r0.retransmissions} max_queue={r0.max_queue} "
              f"slots={steps} dispatch_ms={ms:.1f} host_prep_ms={host_ms:.1f} "
              f"launches={counts} (fused with {tag})", flush=True)
        check(all(loop_sane(r, w, c) for r in res),
              f"{key}: malformed result")
        check(loop_result_digest(r0) == golden[key],
              f"{key}: seed 0 differs from the JAX digests")
        serial = loopsim.simulate(tr, w, scheme, c, seed=0, links=l,
                                  g_converge=g, fault=fz)
        check(same_loop(serial, r0), f"{key}: fused != serial simulate")
    plain = loopsim.simulate_megabatch(
        [it[:3] + (dataclasses.replace(it[3], impl="torch"),) + it[4:]
         for it in items])
    for (_, _, scheme, *_), res, ref in zip(items, fused, plain):
        check(all(same_loop(a, b) for a, b in zip(res, ref)),
              f"{point}/{scheme.name}: kernels != plain versions")
    print(f"compared {tag}: fused == serial == impl='torch' == JAX digest",
          flush=True)
    return fused


def fast_group(tag, items, keys, golden, prop, launches, tree,
               want=("segmented_cummax",)):
    """One fused fast-engine dispatch of ``items`` (6-tuples) with the
    launch counts set to 0 just before it and read just after; every kernel
    named in ``want`` must have launched.  Seed 0 of each result is held to
    serial ``simulate``, to a ``backend="torch"`` run (plain versions; seed
    0 only, as the host-label all-to-all's per-seed host draws take ~10 s a
    seed) and to the JAX digest ``golden[keys[i]]``."""
    from repro_torch.kernels.jsq_scan import ops as jsq_ops
    from repro_torch.kernels.lindley import ops as lindley_ops
    from repro_torch.net import fastsim
    from repro_torch.obs.digest import result_digest
    lindley_ops.LAUNCHES = jsq_ops.LAUNCHES = 0
    t0 = time.perf_counter()
    with HostTimer(fastsim) as host:
        fused = fastsim.simulate_megabatch(items, prop_slots=prop)
    ms = (time.perf_counter() - t0) * 1e3
    host_ms = host.ms
    counts = {"segmented_cummax": lindley_ops.LAUNCHES,
              "jsq_scan": jsq_ops.LAUNCHES}
    for name, n in counts.items():
        launches[name] += n
    for name in want:
        check(counts[name] > 0, f"{tag}: {name} never launched")
    for (tr, w, scheme, seeds, l, fz), key, res in zip(items, keys, fused):
        r0 = res[0]
        layers = " ".join(f"{k}={v.max_queue:g}" for k, v in r0.layers.items())
        print(f"point {key} seeds={len(seeds)} cct={r0.cct!r} "
              f"max_queue[{layers}] packets={w.n_packets} "
              f"dispatch_ms={ms:.1f} host_prep_ms={host_ms:.1f} "
              f"launches={counts} (fused with {tag})", flush=True)
        check(all(sane(r, w, tree) for r in res), f"{key}: malformed result")
        check(result_digest(r0) == golden[key],
              f"{key}: seed 0 differs from the JAX digests")
        serial = fastsim.simulate(tr, w, scheme, seed=0, prop_slots=prop,
                                  links=l, fault=fz)
        check(same_results(serial, r0), f"{key}: fused != serial simulate")
    plain = fastsim.simulate_megabatch(
        [it[:3] + ([0],) + it[4:] for it in items], backend="torch",
        prop_slots=prop)
    for key, res, ref in zip(keys, fused, plain):
        check(same_results(res[0], ref[0]),
              f"{key}: kernels != plain versions")
    print(f"compared {tag}: fused == serial == backend='torch' == JAX digest",
          flush=True)
    return fused


def dynamic_phases(tree, dev, errs, launches, slot_launches, golden,
                   fast_prop):
    """Phases 6-9: the SACK kernels against their plain versions, then the
    SACK, fault-schedule and collective-phase main paths.  Launches are
    added to ``launches`` and ``slot_launches``, kernel errors to ``errs``.
    Returns the recorders that kept each SACK kernel's largest main-path
    input."""
    import numpy as np
    import torch
    from repro_torch.core import lb_schemes
    from repro_torch.faults import FaultSchedule
    from repro_torch.kernels.slot_step import ops as slot_ops
    from repro_torch.net import fastsim, loopsim, workloads
    from repro_torch.phases import PhaseSchedule

    pts = golden["points"]
    check(golden["flap"] == FLAP, "the flap differs from the golden file's")
    wl = workloads.permutation(tree, 256, np.random.default_rng(1))
    wl_inter = workloads.permutation(tree, 256, np.random.default_rng(1),
                                     inter_pod_only=True)
    sack_cfgs = {
        "fig12": loopsim.LoopConfig(loss="sack", sack_thresh=32,
                                    max_slots=LOOP_MAX_SLOTS),
        "fig9": loopsim.LoopConfig(loss="sack", sack_thresh=8,
                                   buffer_pkts=20, max_slots=LOOP_MAX_SLOTS)}

    def sack_check(name, args, what):
        fn = getattr(slot_ops, name)
        got = fn(*args)
        want = fn(*args, backend="torch")
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            err = max_abs_err(g, w)
            errs[name] = max(errs[name], err)
            check(g.dtype == w.dtype and torch.equal(g, w),
                  f"{name} {what}: kernel != plain (err {err})")

    with Phase("sack_kernels_vs_plain"):
        for name in SACK_KERNELS:
            errs[name] = 0.0
        n_cases = 0
        for B, F, M, max_flow in ((4, 128, 640, 512), (4, 1024, 5120, 512),
                                  (1, 1, 1, 3)):
            o = sack_operands(F + M, B, F, M, max_flow, dev)
            for name in SACK_KERNELS:
                sack_check(name, [o[k] for k in SACK_ARGS[name]],
                           f"random B={B} F={F} M={M}")
                n_cases += 1
        # Outside the engine's domain: delivering lanes at pk = -1, 3, -10,
        # -11 of a 10-packet row (two wrap once, -11 is dropped), pk in
        # [-P, -1], below -P and at or past P, and windows before the row's
        # start and past its end (tests/_torch_compare.py), also at the k=8
        # sizes; flows of size <= 0 whose windows start below fsize - 1,
        # acks past the flow's end and within 64 of INT_MAX; and the grid's
        # edges (SACK_TILE_CASES: rows shorter than a tile, a tile and a
        # byte, every alignment mod 16, windows across tile boundaries, no
        # lanes, no flows, each form of the delivered set).
        from _torch_compare import (SACK_EDGE_CASES, SACK_TILE_CASES,
                                    sack_edge_operands, sack_fault_operands,
                                    sack_oob_operands, sack_tile_operands)
        for what, ops in (
                ("pk [-1, 3, -10, -11]", sack_fault_operands()),
                ("out of range seed=0", sack_oob_operands(0)),
                ("out of range seed=1", sack_oob_operands(1)),
                ("out of range k=8 sizes", sack_oob_operands(
                    2, rows=4, f=128, m=640, max_flow=512)),
                *((f"counters {c}", sack_edge_operands(c))
                  for c in SACK_EDGE_CASES),
                ("counters int_max k=8 sizes", sack_edge_operands(
                    "int_max", seed=3, rows=4, f=128, m=640, p=32_768)),
                *((f"grid {c}", sack_tile_operands(c))
                  for c in SACK_TILE_CASES)):
            args = [torch.from_numpy(a).to(dev) for a in ops]
            sack_check("sack_update_scan", args, what)
            sack_check("sack_advance", [args[0]] + args[3:], what)
            n_cases += 2
        recs = [Recorder(slot_ops, name, lambda a: a[0].numel(),
                         keep_every=50) for name in SACK_KERNELS]
        for r in recs:
            r.__enter__()
        try:      # fig 9's first 600 slots: its buffers fill and drop early
            loopsim.simulate(tree, wl, lb_schemes.host_pkt(),
                             dataclasses.replace(sack_cfgs["fig9"],
                                                 max_slots=600), seed=1)
        finally:
            for r in recs:
                r.__exit__()
        for r in recs:
            check(r.calls, f"{r.name}: no engine call recorded")
            for i, (args, _) in enumerate(r.calls):
                sack_check(r.name, args, f"engine call {i}")
                n_cases += 1
        print(f"SACK kernels: {n_cases} cases bitwise equal to the plain "
              f"versions (tolerance: bitwise, max_abs_err 0)", flush=True)

    size_of = lambda a: a[0].numel()             # noqa: E731
    sack_recs = {name: Recorder(slot_ops, name, size_of)
                 for name in SACK_KERNELS}
    with Phase("sack_main_path"), sack_recs["sack_update_scan"], \
            sack_recs["sack_advance"]:
        for point, groups in SACK_GROUPS.items():
            cfg = sack_cfgs[point]
            for group in groups:
                items = [(tree, wl, lb_schemes.by_name(s), cfg,
                          list(LOOP_SEEDS), None, None, None) for s in group]
                want = SACK_KERNELS + (
                    ("jsq_pick", "agg_jsq_enqueue") if group[0] ==
                    "switch_pkt_ar" else ("enqueue",))
                fused = loop_group(f"{point}/{'+'.join(group)}", items, pts,
                                   slot_launches, launches, want)
                if point == "fig9":
                    check(all(r.retransmissions > 0 for r in fused[0]),
                          "fig9: the SACK retransmit path never ran")
        check(all(slot_launches[k] > 0 for k in SACK_KERNELS),
              "a SACK kernel of the main path was never launched")

    with Phase("fault_main_path"):
        flap = FaultSchedule.flap(**FLAP)
        cfg = loopsim.LoopConfig(rto_slots=250, max_slots=LOOP_MAX_SLOTS)
        for group in FLAP_LOOP_GROUPS:
            items = [(tree, wl_inter, lb_schemes.by_name(s), cfg,
                      list(LOOP_SEEDS), None, None, flap) for s in group]
            want = (("jsq_pick", "agg_jsq_enqueue")
                    if group[0] == "switch_pkt_ar" else ("enqueue",))
            loop_group(f"flap_loop/{'+'.join(group)}", items, pts,
                       slot_launches, launches, want)
        for group in FLAP_FAST_GROUPS:
            items = [(tree, wl_inter, lb_schemes.by_name(s),
                      list(LOOP_SEEDS), None, flap) for s in group]
            plan = fastsim._prepare(tree, wl_inter, items[0][2], fast_prop,
                                    None, "auto", 4.0, fault=flap)
            check(plan.ep_host.max() == plan.static_args["ep_sw"].max() == 2,
                  "the flap does not bind packets to all three epochs")
            fast_group(f"flap_fast/{'+'.join(group)}", items,
                       [f"flap_fast/{s}" for s in group], pts, fast_prop,
                       launches, tree)

    with Phase("phases_main_path"):
        sched = PhaseSchedule.from_model("deepseek-v3-671b", ep=8, dp=8,
                                         iterations=2)
        check(sched.label() == golden["train_schedule"],
              "the phase schedule differs from the golden file's")
        wls = {m: sched.compile(tree, m, rng_seed=golden["train_rng_seed"]
                                ).workload for m in TRAIN_LOADS}
        for group in TRAIN_GROUPS:
            items, keys = [], []
            for m, w in wls.items():
                for s in group:
                    items.append((tree, w, lb_schemes.by_name(s),
                                  list(LOOP_SEEDS), None, None))
                    keys.append(f"train_iter/{m}/{s}")
            fast_group(f"train_iter/{'+'.join(group)}", items, keys, pts,
                       TRAIN_PROP, launches, tree)

    return sack_recs


# ---------------------------------------------------------------------------
# The dense serving path (Yi-6B) and the flash-attention kernel
# ---------------------------------------------------------------------------

# attention_vs_plain shapes (B, Hq, Hkv, Sq, Sk, D): Yi-6B's heads at the
# prefill lengths of the main path, two query tails, smaller head dims, and
# Zamba2-2.7B's shared block (32 query and 32 KV heads of D = 80).
ATTN_SHAPES = ([(1, 32, 4, S, S, 128)
                for S in (1, 13, 64, 100, 128, 511, 1000, 1025, 2048)]
               + [(1, 32, 4, 1, 2048, 128), (2, 32, 4, 64, 1000, 128),
                  (2, 8, 2, 37, 37, 32), (1, 8, 2, 100, 130, 64),
                  (2, 6, 3, 65, 200, 96)]
               + [(1, 32, 32, S, S, 80) for S in (13, 100, 1025, 2048)]
               + [(1, 32, 32, 1, 2048, 80)]
               + [(1, 8, 2, 100, 100, 36), (2, 8, 2, 37, 37, 36),
                  (1, 8, 2, 300, 300, 136), (1, 8, 2, 1, 2048, 136),
                  (1, 8, 2, 2048, 2048, 256), (1, 4, 1, 77, 200, 256)])
# v of another width than q and k, (B, Hq, Hkv, Sq, Sk, D, Dv): MLA's
# 192/128, a narrower and two wider v (the last past one output tile).
ATTN_MIXED = ((1, 16, 16, 300, 300, 192, 128), (2, 4, 2, 37, 37, 48, 32),
              (1, 8, 2, 100, 130, 64, 192), (1, 4, 1, 64, 64, 32, 300))
# The reference's own tolerances (tests/test_kernels.py:88), atol = rtol.
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# The domain past the models' path: causal with more queries than keys
# (B, Hq, Hkv, Sq, Sk, D) on both kernels, and float16 and mixed dtypes of
# (q, k, v) at 2e-2 (read in float32, the CUDA-core kernel).
ATTN_BLIND = ((1, 2, 1, 160, 128, 16), (1, 32, 4, 300, 100, 128),
              (1, 8, 2, 1000, 999, 80))
HALF_MIXED = (("float16",) * 3, ("bfloat16", "float32", "float32"),
              ("float32", "bfloat16", "float16"))
ATTN_HALF_SHAPES = ((1, 4, 2, 128, 128, 16), (1, 32, 4, 100, 300, 128))
HALF_TOL = 2e-2
# serve_golden: the port in float32 on the card against CPU JAX.  Logits
# differ only by float32 sums taken in another order (widths up to
# 11,008); the golden's smallest top-2 margin is 0.0025, more than twice
# this tolerance, so equal tokens follow from it.
GOLDEN_ATOL = 1e-3
# serve_main_path: Yi-6B in bf16, each request's batcher run against its
# solo run, and the kernel path against the plain path (attn_backend=
# "torch"), all on the card.  Two runs sum in another order (the attention,
# or matrix products over another batch), so an activation can round to the
# neighbouring bf16 value, and 32 layers carry such steps into the logits.
# Every compared step's largest logit gap is held to BF16_LOGIT_ATOL, set
# from the card: the largest gap measured was 0.052 (prefill logits, kernel
# vs plain; chip runs of the serving phase).  A differing greedy token is a
# defect unless the reference run's top-2 margin at that step is under
# twice that step's measured gap: only then can two logits, each moved by
# at most the gap, swap.
BF16_LOGIT_ATOL = 0.1
SERVE_LENS = (13, 100, 128, 511, 1000, 1025, 2048, 37)
SERVE_NEW = 16
SERVE_SLOTS, SERVE_MAX_LEN = 4, 2304
GREEDY_BATCH = (2, 100)          # greedy_decode: 2 prompts of 100 tokens
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor cores
# Mamba2-130M's main path: fewer requests than Zamba2-2.7B's SERVE_LENS.
MAMBA_LENS = (13, 511, 2048, 37)


def _flash_wrapper():
    from repro_torch.kernels.flash_attn import ops
    return ops, "attention", lambda a: a[0].numel() * a[1].shape[2]


def _ssd_wrapper():
    from repro_torch.kernels.ssd_scan import ops
    return ops, "ssd", lambda a: a[0].numel()


# Each serving kernel's (ops module, wrapper name, size of a call's input),
# for the launch counts and the Recorder of a serving main path.
KERNEL_WRAPPERS = {"flash_attention": _flash_wrapper, "ssd_scan": _ssd_wrapper}

# ssd_vs_plain: (B, L, H, P, G, N) at Zamba2-2.7B's heads, Mamba2-130M's and
# the reference's grouped shape (tests/test_kernels.py), for the prefill
# lengths below; float32 at the reference's tolerance (tests/
# test_kernels.py:158), bf16 at atol = rtol = 2e-2: the output is rounded
# once to bf16 from float32 sums taken in another order, and a bf16 step is
# at most 2**-7 of the value, so the two can differ by one step.
SSD_HEADS = ((80, 64, 1, 64), (24, 64, 1, 128), (8, 64, 4, 32))
SSD_LENS = (1, 37, 64, 100, 2048)
SSD_TOL = {"float32": (5e-5, 5e-4), "bfloat16": (2e-2, 2e-2)}
SSD_DECAY = 100.0      # A scaled so that A * dt sums past 100 in a chunk
# Past the models' heads, (H, P, G, N) at a requested chunk of 128 (the
# kernel tiles P and N and runs chunks of 64), for L = 37 and 500.
SSD_WIDE = ((4, 128, 1, 256), (6, 100, 2, 200))
SSD_WIDE_CHUNK = 128
# Requested chunks below 64, which the bf16 walk runs as chunks of 64 (and
# the float32 route as asked), at Zamba2-2.7B's and the grouped heads, L =
# 301 (ragged), with and without the large decay.
SSD_SHORT_CHUNKS = (1, 16, 32, 63)
# float16 and mixed dtypes of (x, B, C), (B, L, H, P, G, N), at HALF_TOL.
SSD_HALF_SHAPES = ((1, 64, 2, 16, 1, 16), (1, 100, 80, 64, 1, 64))


class TimedModel:
    """A ``Model`` whose prefill and decode calls are timed on the host
    clock between two device synchronisations (the batcher and
    ``greedy_decode`` call only these, ``cache_shapes`` and
    ``cache_batch_axes``).  Each call's
    last-position logits are kept: with ``batcher`` set, per request id
    in ``steps`` (prefills are admitted in submission order, so the k-th
    prefill is request k; a decode call advances the batcher's active
    slots at its position), else per call in ``free``."""

    def __init__(self, model):
        self.model, self.cfg = model, model.cfg
        self.prefills, self.decodes = [], []
        self.batcher = None
        self.steps, self.free = {}, []

    def cache_shapes(self, batch, max_len):
        return self.model.cache_shapes(batch, max_len)

    def cache_batch_axes(self):
        return self.model.cache_batch_axes()

    def _timed(self, fn, log, size, *args):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        log.append((size, (time.perf_counter() - t0) * 1e3))
        return out

    def _keep(self, logits, rids):
        import torch
        # A copy, not a view: a view would hold the whole prefill logits.
        last = logits[:, -1].to(torch.float32, copy=True)
        if rids is None:
            self.free.append(last)
            return
        check(len(rids) == last.shape[0],
              "TimedModel: a decode group does not match the batcher's slots")
        for row, rid in enumerate(rids):
            self.steps.setdefault(rid, []).append(last[row])

    def prefill(self, params, batch, cache):
        logits, cache = self._timed(self.model.prefill, self.prefills,
                                    tuple(batch["tokens"].shape), params,
                                    batch, cache)
        self._keep(logits, None if self.batcher is None
                   else [len(self.steps)])
        return logits, cache

    def decode_step(self, params, tokens, cache, index):
        cb = self.batcher
        rids = None if cb is None else [
            cb.slot_req[s].rid for s in range(cb.n_slots)
            if cb.slot_req[s] is not None and cb.slot_pos[s] == index]
        logits, cache = self._timed(self.model.decode_step, self.decodes,
                                    tokens.shape[0], params, tokens, cache,
                                    index)
        self._keep(logits, rids)
        return logits, cache


def profile_window(fn, reps: int):
    """(wall ms, device-busy ms, kernel launches, host synchronisations,
    the five device events with the most time as [(name, ms)]) per call of
    ``fn``.  The wall time is the host clock around ``reps`` calls and a
    synchronise, without the profiler (which slows the host); the rest come
    from a ``torch.profiler`` trace (CPU and CUDA) of another ``reps``
    calls: busy time sums the device events (kernels, copies, fills) of the
    trace, on one stream, so they do not overlap."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    by_name = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / reps)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    launches = sum(e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                              "cuLaunchKernelEx") for e in events)
    syncs = sum(e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize")
                for e in events)
    return wall / reps, busy, launches / reps, syncs / reps, top


def decode_trace(model, params, prompt, n_new, dev):
    """Greedy decoding as ``serve_step.greedy_decode`` does it, keeping the
    prefill's logits at every position and each step's last-position
    logits: (tokens (B, n_new), prefill logits (B, S, V), [step logits
    (B, V)])."""
    import torch
    from repro_torch.serve import serve_step
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int32)
    B, S = prompt.shape
    cache = serve_step.zero_cache(model, B, S + n_new, dev)
    full, cache = model.prefill(params, {"tokens": prompt}, cache)
    steps = [full[:, -1].to(torch.float32, copy=True)]
    toks = [steps[-1].argmax(-1, keepdim=True).to(torch.int32)]
    for i in range(n_new - 1):
        logits, cache = model.decode_step(params, toks[-1], cache, S + i)
        steps.append(logits[:, -1].to(torch.float32, copy=True))
        toks.append(steps[-1].argmax(-1, keepdim=True).to(torch.int32))
    return torch.cat(toks, dim=1), full, steps


def top2_margin(logits) -> float:
    top = logits.float().topk(2, dim=-1).values
    return float((top[..., 0] - top[..., 1]).min())


def same_tokens(tag, got, want, got_steps, want_steps):
    """Compare two greedy runs step by step.  Each step's largest logit gap
    between the runs must be within BF16_LOGIT_ATOL; a differing token
    passes only where ``want``'s top-2 margin is under twice that step's
    gap (printed; the rest of the row is then not compared, as the runs'
    inputs differ from there).  Returns (steps compared, largest gap)."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        gap = max_abs_err(got_steps[i], want_steps[i])
        worst = max(worst, gap)
        check(gap <= BF16_LOGIT_ATOL,
              f"{tag}: step {i} logits differ by {gap:.4f} > "
              f"{BF16_LOGIT_ATOL}")
        if a != b:
            margin = top2_margin(want_steps[i])
            check(margin < 2 * gap,
                  f"{tag}: token {i} differs ({a} != {b}) at top-2 margin "
                  f"{margin:.4f} >= 2 x the step's logit gap {gap:.4f}")
            print(f"{tag}: token {i} differs ({a} != {b}) at a near tie, "
                  f"top-2 margin {margin:.4f} < 2 x the step's logit gap "
                  f"{gap:.4f}; not compared further", flush=True)
            return i, worst
    return len(want), worst


def campaign_phase():
    """campaign: the port's CLI, in this process, on each campaign of
    SWEEP_GOLDEN (CPU JAX's reference runner); returns {kernel: launches}
    over both runs.  Every kernel's count is set to 0 just before a run and
    read just after."""
    import contextlib
    import hashlib
    import io
    import re
    import shutil
    from repro_torch.kernels.jsq_scan import ops as jsq_ops
    from repro_torch.kernels.lindley import ops as lindley_ops
    from repro_torch.kernels.slot_step import ops as slot_ops
    from repro_torch.obs import load_trace, strip_timing
    from repro_torch.sweep.__main__ import main as sweep_main

    def counts():
        return {"segmented_cummax": lindley_ops.LAUNCHES,
                "jsq_scan": jsq_ops.LAUNCHES, **slot_ops.LAUNCHES}

    def zero():
        lindley_ops.LAUNCHES = jsq_ops.LAUNCHES = 0
        for name in slot_ops.LAUNCHES:
            slot_ops.LAUNCHES[name] = 0

    def no_impl(spans):
        out = []
        for span in spans:
            span = {k: v for k, v in span.items() if k != "impl"}
            if "key" in span:
                span["key"] = re.sub(r"impl='[a-z]+'", "impl=_", span["key"])
            out.append(span)
        return out

    golden = json.loads(SWEEP_GOLDEN.read_text())["campaigns"]
    launches = {}
    with Phase("campaign"):
        for name, want in CAMPAIGN_KERNELS.items():
            g = golden[name]
            out = CAMPAIGN_OUT / name
            shutil.rmtree(out, ignore_errors=True)
            argv = [str(out) if a == "OUT" else a for a in g["argv"]
                    if a != "--quiet"] + ["--device", "cuda"]
            print(f"campaign {name}: python -m repro_torch.sweep "
                  f"{' '.join(argv)}", flush=True)
            zero()
            t0 = time.perf_counter()
            rc = sweep_main(argv)
            wall = time.perf_counter() - t0
            got = counts()
            check(rc == 0, f"campaign {name}: the CLI returned {rc}")
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
            for k in want:
                check(got[k] > 0, f"campaign {name}: {k} never launched")
            text = (out / "results.jsonl").read_text()
            sha = hashlib.sha256(text.encode()).hexdigest()
            check(text == g["results"] and sha == g["sha256"],
                  f"campaign {name}: results.jsonl differs from the golden "
                  f"(sha256 {sha}, golden {g['sha256']})")
            spans = load_trace(out / "trace.jsonl")
            disp = [sp for sp in spans if sp["kind"] == "dispatch"]
            check(no_impl([strip_timing(sp) for sp in spans])
                  == no_impl(g["trace"]),
                  f"campaign {name}: the trace differs from the golden's "
                  f"apart from impl")
            check(all(sp.get("impl", "cuda") == "cuda" for sp in disp),
                  f"campaign {name}: a loop dispatch ran the plain versions")
            print(f"campaign {name}: {text.count(chr(10))} records == golden "
                  f"(sha256 {sha[:16]}), trace == golden apart from impl; "
                  f"wall {wall:.2f} s, {len(disp)} dispatches "
                  f"{[round(sp['wall_s'], 3) for sp in disp]} s; launches "
                  f"{got}", flush=True)
            zero()
            rc = sweep_main(argv + ["--resume"])
            check(rc == 0 and (out / "results.jsonl").read_text() == text,
                  f"campaign {name}: --resume changed results.jsonl")
            resume = [sp for sp in load_trace(out / "trace.jsonl")
                      if sp["kind"] == "resume"]
            check(len(resume) == 1
                  and resume[0]["dispatches_kept"] == len(disp)
                  and sum(counts().values()) == 0,
                  f"campaign {name}: --resume re-ran a dispatch")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = sweep_main(["report", "--trace", str(out / "trace.jsonl"),
                                 "--results", str(out / "results.jsonl")])
            rep = buf.getvalue()
            check(rc == 0 and f"campaign '{name}'" in rep
                  and "dispatch timeline" in rep and "resume" in rep,
                  f"campaign {name}: report did not render")
            print(f"campaign {name}: --resume kept all {len(disp)} "
                  f"dispatches and the bytes; report rendered "
                  f"({rep.count(chr(10)) + 1} lines)", flush=True)
    return launches


def attention_phase(dev, errs):
    """attention_vs_plain: the kernel against its plain version on the
    card at ATTN_SHAPES, in float32 and bf16, causal (the path) and, at one
    shape, not causal."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as attn_kernel
    from repro_torch.kernels.flash_attn import ops as attn_ops
    with Phase("attention_vs_plain"):
        gen = torch.Generator().manual_seed(0)
        cases = [(s + (s[-1],), dt, True) for s in ATTN_SHAPES
                 for dt in ("float32", "bfloat16")]
        cases += [(s, dt, True) for s in ATTN_MIXED
                  for dt in ("float32", "bfloat16")]
        cases.append(((2, 8, 2, 37, 37, 32, 32), "bfloat16", False))
        for shape, dt, causal in cases:
            B, Hq, Hkv, Sq, Sk, D, Dv = shape
            q, k, v = (torch.randn(s, generator=gen).to(dev, getattr(torch,
                                                                     dt))
                       for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D),
                                 (B, Hkv, Sk, Dv)))
            got = attn_ops.attention(q, k, v, causal=causal)
            want = attn_ops.attention(q, k, v, causal=causal,
                                      backend="torch")
            torch.cuda.synchronize()
            err = max_abs_err(got.float(), want.float())
            key = ("flash_attention" if dt == "bfloat16"
                   else "flash_attention_f32")
            errs[key] = max(errs[key], err)
            tol = ATTN_TOL[dt]
            check(got.dtype == q.dtype and got.shape == (B, Hq, Sq, Dv)
                  and torch.allclose(got.float(), want.float(), atol=tol,
                                     rtol=tol),
                  f"flash_attention {shape} {dt} causal={causal}: kernel != "
                  f"plain (max_abs_err {err})")
            print(f"flash_attention {shape} {dt} causal={causal} "
                  f"({attn_kernel.route(q.dtype, D)}): max_abs_err "
                  f"{err:.3g} (tolerance atol=rtol={tol})", flush=True)
        cases = [(s, (dt,) * 3) for s in ATTN_BLIND
                 for dt in ("float32", "bfloat16")]
        cases += [(s, dts) for s in ATTN_HALF_SHAPES for dts in HALF_MIXED]
        for (B, Hq, Hkv, Sq, Sk, D), dts in cases:
            q, k, v = (torch.randn(s, generator=gen).to(dev, getattr(torch,
                                                                     dt))
                       for s, dt in zip(((B, Hq, Sq, D), (B, Hkv, Sk, D),
                                         (B, Hkv, Sk, D)), dts))
            cd = attn_kernel.compute_dtype(q, k, v)
            route = attn_kernel.route(cd, D)
            before = attn_ops.ROUTE_LAUNCHES[route]
            got = attn_ops.attention(q, k, v)
            want = attn_ops.attention(q, k, v, backend="torch")
            torch.cuda.synchronize()
            err = max_abs_err(got.float(), want.float())
            tol = ATTN_TOL[dts[0]] if len(set(dts)) == 1 and dts[0] in \
                ATTN_TOL else HALF_TOL
            blind = max(Sq - Sk, 0)
            mean_v = v.float().mean(dim=2, keepdim=True).repeat_interleave(
                Hq // Hkv, dim=1).expand(-1, -1, blind, -1)
            check(attn_ops.ROUTE_LAUNCHES[route] == before + 1
                  and got.dtype == q.dtype and got.shape == q.shape
                  and bool(torch.isfinite(got).all())
                  and torch.allclose(got.float(), want.float(), atol=tol,
                                     rtol=tol)
                  and torch.allclose(got[:, :, :blind].float(), mean_v,
                                     atol=tol, rtol=tol),
                  f"flash_attention {(B, Hq, Hkv, Sq, Sk, D)} {dts}: kernel "
                  f"!= plain (max_abs_err {err})")
            print(f"flash_attention {(B, Hq, Hkv, Sq, Sk, D)} {dts} causal "
                  f"({route}; {blind} rows see no key): max_abs_err "
                  f"{err:.3g} (tolerance atol=rtol={tol})", flush=True)


def golden_runs(tag, rec, model, params, dev):
    """Decode each of the golden record's prompts on the card: tokens equal
    to the golden's, its top-16 and 512 fixed logits within GOLDEN_ATOL at
    every step, and ``greedy_decode`` equal to the traced decode."""
    import numpy as np
    import torch
    from repro_torch.serve import serve_step
    ids = torch.tensor(rec["fixed_ids"], device=dev)
    worst = 0.0
    for run in rec["runs"]:
        prompt = np.asarray(run["prompt"], np.int32)[None]
        toks, _, steps = decode_trace(model, params, prompt, rec["n_new"],
                                      dev)
        toks = toks[0].tolist()
        for i, (st, step) in enumerate(zip(steps, run["steps"])):
            st = st[0]
            err = max(max_abs_err(st[ids].cpu(), torch.tensor(
                          step["fixed_logits"])),
                      max_abs_err(st[torch.tensor(step["top_ids"],
                                                  device=dev)].cpu(),
                                  torch.tensor(step["top_logits"])))
            worst = max(worst, err)
            check(err <= GOLDEN_ATOL,
                  f"{tag} prompt {prompt.shape[1]} step {i}: logits differ "
                  f"by {err} > {GOLDEN_ATOL}")
        check(toks == run["tokens"],
              f"{tag} prompt {prompt.shape[1]}: tokens {toks} != golden "
              f"{run['tokens']}")
        solo = serve_step.greedy_decode(model, params, prompt, rec["n_new"],
                                        device=dev)
        check(solo[0].tolist() == toks,
              f"{tag}: greedy_decode != the traced decode")
        print(f"{tag} prompt {prompt.shape[1]}: tokens {toks} == golden; "
              f"top-16 and 512 fixed logits within {GOLDEN_ATOL} (max_abs_err "
              f"{worst:.3g}); golden margins "
              f"{[round(s['margin'], 5) for s in run['steps']]}", flush=True)


def golden_model(rec, dev):
    """(model, parameters) of a golden record: its architecture cut to its
    layers and dtype, with ``numpy_reference_params(cfg, param_seed)``
    carried to the card."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.interop import (numpy_reference_params,
                                     params_from_reference)
    from repro_torch.models.registry import Model
    cfg = dc.replace(get_config(rec["arch"]), n_layers=rec["n_layers"],
                     dtype=rec["dtype"])
    t0 = time.perf_counter()
    params = params_from_reference(
        cfg, numpy_reference_params(cfg, rec["param_seed"]), dev)
    print(f"golden model: {cfg.name} d_model={cfg.d_model} "
          f"n_layers={cfg.n_layers} {cfg.dtype}, "
          f"{sum(p.numel() for p in params.parameters()):,} parameters drawn "
          f"and carried in {time.perf_counter() - t0:.1f} s", flush=True)
    return Model(cfg), params


def serve_golden_phase(dev):
    """serve_golden: Yi-6B at full width, 2 layers, float32, the weights
    of ``numpy_reference_params(cfg, 0)`` carried to the card, held to the
    CPU JAX golden (tokens equal, logits within GOLDEN_ATOL).  Returns the
    float32 attention kernel's launches, counted from 0."""
    import torch
    from repro_torch.kernels.flash_attn import ops as attn_ops
    golden = json.loads(SERVE_GOLDEN.read_text())
    with Phase("serve_golden"):
        model, params = golden_model(golden, dev)
        attn_ops.ROUTE_LAUNCHES["cuda_cores"] = 0
        golden_runs("serve_golden", golden, model, params, dev)
        n = attn_ops.ROUTE_LAUNCHES["cuda_cores"]
        check(n > 0, "serve_golden: the float32 attention kernel never ran")
        print(f"serve_golden: float32 attention kernel launched {n} times",
              flush=True)
        del params
        torch.cuda.empty_cache()
    return n


def ssm_golden_phase(dev):
    """ssm_serve_golden: Mamba2-130M at full size and Zamba2-2.7B at full
    width cut to 6 layers, float32, numpy weights, held to the CPU JAX
    golden ``serve_ssm.json`` as serve_golden holds Yi-6B.  Returns the
    float32 attention and SSD kernels' launches, counted from 0."""
    import torch
    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    golden = json.loads(SSM_GOLDEN.read_text())
    with Phase("ssm_serve_golden"):
        attn_ops.ROUTE_LAUNCHES["cuda_cores"] = 0
        ssd_ops.ROUTE_LAUNCHES["cuda_cores"] = 0
        for rec in golden["models"]:
            model, params = golden_model(rec, dev)
            golden_runs(f"ssm_serve_golden {rec['arch']}", rec, model,
                        params, dev)
            del params
            torch.cuda.empty_cache()
        n = attn_ops.ROUTE_LAUNCHES["cuda_cores"]
        n_ssd = ssd_ops.ROUTE_LAUNCHES["cuda_cores"]
        check(n_ssd > 0, "ssm_serve_golden: the float32 SSD route never ran")
        print(f"ssm_serve_golden: float32 attention kernel launched {n} "
              f"times, the float32 SSD route {n_ssd} times", flush=True)
    return n, n_ssd


def serve_main_phase(dev, phase, arch, lens, greedy_batch, kernels):
    """A serving main path: ``arch`` at full width and depth in its dtype,
    random weights from a torch.Generator on the card.  A ContinuousBatcher
    (SERVE_SLOTS slots of SERVE_MAX_LEN positions) answers one request a
    prompt length of ``lens`` (SERVE_NEW new tokens each) and
    greedy_decode a batch of ``greedy_batch`` prompts, with the launch
    counts of ``kernels`` ({name: launches per prefill}) set to 0 just
    before and read just after.  Then each request is decoded alone through
    the kernel path and through the plain path (``backend="torch"``).
    Returns (launches, {name: recorder of the wrapper's calls}, a function
    that profiles a decode step and the longest prefill; it holds the
    weights)."""
    import contextlib
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import Model
    from repro_torch.serve import batching, serve_step
    cfg = get_config(arch)
    wrappers = {name: KERNEL_WRAPPERS[name]() for name in kernels}
    with Phase(phase):
        model = Model(cfg)
        t0 = time.perf_counter()
        base = torch.cuda.memory_allocated(dev)
        params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                                   device=dev)
        torch.cuda.synchronize()
        print(f"{phase}: {cfg.name} {cfg.dtype}, "
              f"{sum(p.numel() for p in params.parameters()):,} parameters "
              f"drawn on the card in {time.perf_counter() - t0:.1f} s",
              flush=True)
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
                   for n in lens]
        pair = rng.integers(0, cfg.vocab, greedy_batch).astype(np.int32)
        timed = TimedModel(model)
        decode_trace(model, params, prompts[0][None], 2, dev)  # warm-up
        torch.cuda.reset_peak_memory_stats(dev)
        with contextlib.ExitStack() as stack:
            recs = {name: stack.enter_context(Recorder(mod, fn, size_of))
                    for name, (mod, fn, size_of) in wrappers.items()}
            for mod, _, _ in wrappers.values():
                mod.LAUNCHES = 0
            routes = {name: wrappers[name][0].ROUTE_LAUNCHES
                      for name in kernels}
            for r in routes.values():
                r.update({k: 0 for k in r})
            t0 = time.perf_counter()
            cb = batching.ContinuousBatcher(timed, params, SERVE_SLOTS,
                                            SERVE_MAX_LEN, device=dev)
            timed.batcher = cb
            for rid, p in enumerate(prompts):
                cb.submit(batching.Request(rid=rid, prompt=p,
                                           max_new_tokens=SERVE_NEW))
            done = cb.run_to_completion()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            n_batcher = len(timed.prefills)
            timed.batcher = None
            t1 = time.perf_counter()
            greedy = serve_step.greedy_decode(timed, params, pair, SERVE_NEW,
                                              device=dev)
            torch.cuda.synchronize()
            greedy_ms = (time.perf_counter() - t1) * 1e3
            launches = {name: wrappers[name][0].LAUNCHES for name in kernels}
            for name, r in routes.items():
                check(r["wgmma"] == launches[name],
                      f"{phase}: {name} launches {launches} did not all "
                      f"take the tensor-core kernel ({r})")
        peak = torch.cuda.max_memory_allocated(dev)
        n_prefill = len(prompts) + 1
        for name, per_prefill in kernels.items():
            check(launches[name] == per_prefill * n_prefill,
                  f"{phase}: {name} launched {launches[name]} times, "
                  f"expected {per_prefill} a prefill x {n_prefill}")
        check(sorted(done) == list(range(len(prompts)))
              and all(len(r.out) == SERVE_NEW for r in done.values()),
              f"{phase}: the batcher did not answer every request in full")
        tokens = sum(len(r.out) for r in done.values())
        dec = timed.decodes[:-(SERVE_NEW - 1)]
        dec_tokens = sum(g for g, _ in dec)
        dec_ms = sum(ms for _, ms in dec)
        for (shape, ms), n in zip(timed.prefills[:n_batcher], lens):
            print(f"{phase} prefill: {n} tokens {ms:.2f} ms", flush=True)
        print(f"{phase} batcher: {len(done)} requests, {tokens} tokens in "
              f"{wall_ms:.1f} ms ({tokens / wall_ms * 1e3:.1f} tok/s); "
              f"{len(dec)} decode steps, {dec_tokens} tokens, "
              f"{dec_ms / dec_tokens:.3f} ms per token, "
              f"{dec_ms / len(dec):.3f} ms per step (median "
              f"{sorted(ms for _, ms in dec)[len(dec) // 2]:.3f}); "
              f"greedy_decode batch {greedy_batch}: {greedy_ms:.1f} ms "
              f"(prefill {timed.prefills[-1][1]:.2f} ms, decode "
              f"{sum(ms for _, ms in timed.decodes[-(SERVE_NEW - 1):]) / (SERVE_NEW - 1):.3f} "
              f"ms per step); launches {launches}; max_memory_allocated "
              f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB over "
              f"the {base / 2**30:.2f} GiB allocated before the phase)",
              flush=True)

        # Held outside the counted run: each request alone on the kernel
        # path (== its batcher run) and on the plain path.
        plain_model = Model(cfg, backend="torch")
        worst = {"prefill": 0.0, "batcher": 0.0, "plain": 0.0}
        for rid, p in enumerate(prompts):
            toks, full, steps = decode_trace(model, params, p[None],
                                             SERVE_NEW, dev)
            ptoks, pfull, psteps = decode_trace(plain_model, params, p[None],
                                                SERVE_NEW, dev)
            err = max_abs_err(full, pfull)
            worst["prefill"] = max(worst["prefill"], err)
            check(bool(torch.isfinite(full).all()) and err <= BF16_LOGIT_ATOL,
                  f"{phase} request {rid} ({len(p)} tokens): prefill logits "
                  f"of the kernel path differ from the plain path by {err} > "
                  f"{BF16_LOGIT_ATOL}")
            del full, pfull
            toks, ptoks = toks[0].tolist(), ptoks[0].tolist()
            steps, psteps = [s[0] for s in steps], [s[0] for s in psteps]
            n_b, gap_b = same_tokens(f"{phase} request {rid} batcher vs solo",
                                     done[rid].out, toks, timed.steps[rid],
                                     steps)
            n_p, gap_p = same_tokens(f"{phase} request {rid} kernel vs plain",
                                     toks, ptoks, steps, psteps)
            worst["batcher"] = max(worst["batcher"], gap_b)
            worst["plain"] = max(worst["plain"], gap_p)
            print(f"{phase} request {rid} ({len(p)} tokens): prefill logits "
                  f"kernel vs plain max_abs_err {err:.4f}; batcher == solo on "
                  f"{n_b} tokens (step logits max gap {gap_b:.4f}), kernel == "
                  f"plain on {n_p} (max gap {gap_p:.4f}); tolerance "
                  f"{BF16_LOGIT_ATOL}; reference top-2 margins "
                  f"{min(top2_margin(s) for s in steps):.4f} at least",
                  flush=True)
        gt, _, gsteps = decode_trace(model, params, pair, SERVE_NEW, dev)
        for b in range(greedy_batch[0]):
            same_tokens(f"{phase} greedy_decode row {b}", greedy[b].tolist(),
                        gt[b].tolist(), [s[b] for s in timed.free],
                        [s[b] for s in gsteps])
        print(f"{phase}: largest logit gaps (tolerance {BF16_LOGIT_ATOL}): "
              f"prefill kernel vs plain {worst['prefill']:.4f}, batcher vs "
              f"solo steps {worst['batcher']:.4f}, kernel vs plain steps "
              f"{worst['plain']:.4f}", flush=True)

    def profile():
        """Where a step's time goes: one decode step against a batcher
        slot's SERVE_MAX_LEN-position cache and the longest prefill, under
        the profiler.  Run after the timing phase: a profiler session
        followed by long unprofiled work left later traces short of kernel
        events."""
        longest = int(np.argmax(lens))
        tok = torch.zeros((1, 1), dtype=torch.int32, device=dev)
        cache = serve_step.zero_cache(model, 1, SERVE_MAX_LEN, dev)
        ptoks = torch.as_tensor(prompts[longest][None], device=dev)
        for what, fn in (
                ("decode step", lambda: model.decode_step(
                    params, tok, cache, lens[longest])),
                (f"prefill of {lens[longest]} tokens",
                 lambda: model.prefill(params, {"tokens": ptoks}, cache))):
            wall, busy, n_launch, n_sync, top = profile_window(fn, 3)
            print(f"serve profile, {cfg.name} {what}: {wall:.2f} ms wall, "
                  f"device busy {busy:.2f} ms (idle share "
                  f"{1 - busy / wall:.3f}), {n_launch:.0f} kernel launches, "
                  f"{n_sync:.0f} host synchronisations; most device time: "
                  + "; ".join(f"{name[:60]} {ms:.2f} ms" for name, ms in top),
                  flush=True)
    return launches, recs, profile


def attention_timing(rec, errs, launches, f32_launches):
    """The flash-attention rows of the ``kernels`` line, at the largest
    input the serving main paths gave the kernel: the bf16 tensor-core
    kernel on it, and the float32 CUDA-core kernel on the same input in
    float32, each beside its plain version and one SDPA call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import ops as attn_ops
    (q, k, v), kw = rec.largest
    kw = {key: val for key, val in kw.items() if key != "backend"}
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    rows = []
    for name, kernel_re, dtype, err, n in (
            ("flash_attention", r"flash_attention_wgmma_kernel",
             torch.bfloat16, errs["flash_attention"], launches),
            ("flash_attention_f32", r"\bflash_attention_kernel<float>",
             torch.float32, errs["flash_attention_f32"], f32_launches)):
        q, k, v = (t.to(dtype) for t in (q, k, v))
        got = attn_ops.attention(q, k, v, **kw)
        want = attn_ops.attention(q, k, v, backend="torch", **kw)
        tol = ATTN_TOL[str(dtype).split(".")[-1]]
        err = max(err, max_abs_err(got.float(), want.float()))
        check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
              f"{name}: kernel != plain on the main path's largest input")
        ms = cuda_ms(lambda: attn_ops.attention(q, k, v, **kw), 20)
        dev_ms = device_ms(lambda: attn_ops.attention(q, k, v, **kw), 20,
                           kernel_re)
        plain_ms = cuda_ms(lambda: attn_ops.attention(
            q, k, v, backend="torch", **kw), 5)
        # One PyTorch call of the same function: SDPA aligns its causal
        # mask top-left, the same as bottom-right only when Sq == Sk.  In
        # float32 it is held at 1e-3: a yardstick, not an oracle.
        library_ms = None
        if Sq == Sk:
            qc = q.contiguous()
            kc = k.repeat_interleave(Hq // Hkv, dim=1).contiguous()
            vc = v.repeat_interleave(Hq // Hkv, dim=1).contiguous()
            lib = F.scaled_dot_product_attention(qc, kc, vc, is_causal=True)
            ltol = max(tol, 1e-3)
            check(torch.allclose(lib.float(), want.float(), atol=ltol,
                                 rtol=ltol),
                  "scaled_dot_product_attention disagrees with the plain "
                  "version")
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qc, kc, vc, is_causal=True), 20)
        esize = q.element_size()
        nbytes = esize * (2 * B * Hq * Sq * D + 2 * B * Hkv * Sk * D)
        # Visible (query, key) pairs of the causal mask, two products of D
        # multiply-adds each.
        pairs = sum(min(Sk, Sk - Sq + i + 1) for i in range(Sq))
        flops = 4 * B * Hq * D * pairs
        peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/flash_attn.cu",
            replaces="src/repro/kernels/flash_attn/kernel.py:72",
            launches=n, max_abs_err=err, ms=ms, device_ms=dev_ms,
            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=library_ms, n=int(B * Hq * Sq),
            shape=[B, Hq, Hkv, Sq, Sk, D]))
    return rows


def ssd_inputs(B, L, H, P, G, N, dtype, gen, dev, decay=1.0):
    """tests/test_kernels.py's SSD draws: x, B, C normal, dt in [0.01,
    0.21], A in -[0.5, 1.5] times ``decay``; x, B, C in ``dtype``."""
    import torch
    x = torch.randn(B, L, H, P, generator=gen)
    dt = 0.01 + torch.rand(B, L, H, generator=gen) * 0.2
    A = -(0.5 + torch.rand(H, generator=gen)) * decay
    Bm = torch.randn(B, L, G, N, generator=gen)
    C = torch.randn(B, L, G, N, generator=gen)
    return (x.to(dev, dtype), dt.to(dev), A.to(dev), Bm.to(dev, dtype),
            C.to(dev, dtype))


def ssd_phase(dev, errs):
    """ssd_vs_plain: the SSD kernel against the plain ``ssd_chunked`` on the
    card at SSD_HEADS x SSD_LENS x batch 1-2, float32 and bf16, with a
    large-decay case at each head shape, and against the sequential oracle
    ``ssd_scan`` at L <= 100 in float32."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    with Phase("ssd_vs_plain"):
        gen = torch.Generator().manual_seed(0)
        cases = [(B, L, H, P, G, N, dt, 1.0, 64) for H, P, G, N in SSD_HEADS
                 for L in SSD_LENS for B in (1, 2)
                 for dt in ("float32", "bfloat16")]
        cases += [(1, 256, H, P, G, N, dt, SSD_DECAY, 64)
                  for H, P, G, N in SSD_HEADS
                  for dt in ("float32", "bfloat16")]
        cases += [(1, L, H, P, G, N, dt, decay, SSD_WIDE_CHUNK)
                  for H, P, G, N in SSD_WIDE for L in (37, 500)
                  for dt in ("float32", "bfloat16")
                  for decay in (1.0, SSD_DECAY)]
        cases += [(1, 301, H, P, G, N, dt, decay, chunk)
                  for H, P, G, N in (SSD_HEADS[0], SSD_HEADS[2])
                  for chunk in SSD_SHORT_CHUNKS
                  for dt in ("float32", "bfloat16")
                  for decay in (1.0, SSD_DECAY)]
        n_seq = 0
        for B, L, H, P, G, N, dt, decay, chunk in cases:
            args = ssd_inputs(B, L, H, P, G, N, getattr(torch, dt), gen, dev,
                              decay)
            routes = dict(ssd_ops.ROUTE_LAUNCHES)
            got, got_h = ssd_ops.ssd(*args, chunk=chunk, final_state=True)
            want, want_h = ssd_ops.ssd(*args, chunk=chunk, backend="torch",
                                       final_state=True)
            torch.cuda.synchronize()
            which = ssd_kernel.route(args[0].dtype, N)
            check(which == ("wgmma" if dt == "bfloat16" and N <= 256
                            else "cuda_cores")
                  and ssd_ops.ROUTE_LAUNCHES[which] == routes[which] + 1,
                  f"ssd_scan {dt} N={N}: took the wrong route")
            err = max_abs_err(got.float(), want.float())
            herr = max_abs_err(got_h, want_h)
            key = "ssd_scan" if dt == "bfloat16" else "ssd_scan_f32"
            errs[key] = max(errs[key], err, herr)
            atol, rtol = SSD_TOL[dt]
            tag = (f"ssd_scan {(B, L, H, P, G, N)} {dt} decay {decay} "
                   f"chunk {chunk} ({which})")
            check(got.dtype == args[0].dtype and got.shape == args[0].shape
                  and bool(torch.isfinite(got).all())
                  and float(got.float().abs().max()) > 0
                  and torch.allclose(got.float(), want.float(), atol=atol,
                                     rtol=rtol),
                  f"{tag}: kernel != plain (max_abs_err {err})")
            check(got_h.shape == want_h.shape
                  and bool(torch.isfinite(got_h).all())
                  and torch.allclose(got_h, want_h, atol=atol, rtol=rtol),
                  f"{tag}: final state != ssd_final_state (max_abs_err "
                  f"{herr})")
            if (B, L, H, P, G, N) == cases[0][:6]:
                check(torch.equal(ssd_ops.ssd(*args, chunk=chunk), got),
                      f"{tag}: y differs without the final state")
            line = (f"{tag}: max_abs_err {err:.3g}, final state {herr:.3g} "
                    f"(tolerance atol={atol}, rtol={rtol})")
            if decay != 1.0:
                lam = (-args[2][None, None] * args[1])[:, :64].sum(1).min()
                line += f"; smallest chunk decay sum {float(lam):.1f}"
            if L <= 100 and dt == "float32" and decay == 1.0:
                seq = ssd_ref.ssd_scan(*args)
                serr = max_abs_err(got, seq)
                check(torch.allclose(got, seq, atol=atol, rtol=rtol),
                      f"{tag}: kernel != sequential scan (max_abs_err "
                      f"{serr})")
                line += f"; vs sequential scan {serr:.3g}"
                n_seq += 1
            print(line, flush=True)
        print(f"ssd_vs_plain: {len(cases)} cases (y and the final state), "
              f"{n_seq} also against the sequential scan; largest "
              f"max_abs_err bf16 {errs['ssd_scan']:.3g}, float32 "
              f"{errs['ssd_scan_f32']:.3g}", flush=True)
        for shape in SSD_HALF_SHAPES:
            for dts in HALF_MIXED:
                x, dt, A, Bm, C = ssd_inputs(*shape, torch.float32, gen, dev)
                x, Bm, C = (t.to(getattr(torch, d))
                            for t, d in zip((x, Bm, C), dts))
                before = ssd_ops.ROUTE_LAUNCHES["cuda_cores"]
                got = ssd_ops.ssd(x, dt, A, Bm, C)
                want = ssd_ops.ssd(x, dt, A, Bm, C, backend="torch")
                torch.cuda.synchronize()
                err = max_abs_err(got.float(), want.float())
                check(ssd_ops.ROUTE_LAUNCHES["cuda_cores"] == before + 1
                      and got.dtype == x.dtype
                      and bool(torch.isfinite(got).all())
                      and torch.allclose(got.float(), want.float(),
                                         atol=HALF_TOL, rtol=HALF_TOL),
                      f"ssd_scan {shape} {dts}: kernel != plain "
                      f"(max_abs_err {err})")
                print(f"ssd_scan {shape} {dts} (cuda_cores, read in "
                      f"float32): max_abs_err {err:.3g} (tolerance "
                      f"atol=rtol={HALF_TOL})", flush=True)


def ssd_timing(rec, errs, launches, f32_launches):
    """The ssd_scan rows of the ``kernels`` line, at the largest input the
    serving main paths gave the kernel (a prefill: y and the final state):
    the bf16 tensor-core walk on it (and its device time with 32 and with
    64 P columns a CTA), and the float32 CUDA-core route on the same input
    in float32, each beside its plain version."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    (x, dt, A, Bm, C), kw = rec.largest
    kw = {key: val for key, val in kw.items() if key != "backend"}
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    chunk = kw.get("chunk", 64)
    rows = []
    for name, kernel_re, dtype, n in (
            ("ssd_scan", r"\bssd_wgmma_kernel<", torch.bfloat16, launches),
            ("ssd_scan_f32", r"\bssd_(chunk_state|state_carry|chunk_out)",
             torch.float32, f32_launches)):
        x_, Bm_, C_ = (t.to(dtype) for t in (x, Bm, C))
        args = (x_, dt, A, Bm_, C_)
        got = ssd_ops.ssd(*args, **kw)
        want = ssd_ops.ssd(*args, backend="torch", **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        atol, rtol = SSD_TOL[str(dtype).split(".")[-1]]
        err = errs[name]
        for g, w in zip(got, want):
            err = max(err, max_abs_err(g.float(), w.float()))
            check(torch.allclose(g.float(), w.float(), atol=atol, rtol=rtol),
                  f"{name}: kernel != plain on the main path's largest "
                  f"input")
        ms = cuda_ms(lambda: ssd_ops.ssd(*args, **kw), 20)
        dev_ms = device_ms(lambda: ssd_ops.ssd(*args, **kw), 20, kernel_re)
        plain_ms = cuda_ms(lambda: ssd_ops.ssd(*args, backend="torch",
                                               **kw), 5)
        esize = x_.element_size()
        nbytes = (2 * Bsz * L * H * P * esize + 2 * Bsz * L * G * N * esize
                  + Bsz * L * H * dt.element_size() + H * 4)
        if kw.get("final_state"):
            nbytes += Bsz * H * N * P * 4
        # Per (batch, head) and chunk of r rows: C.B^T and S.x over the
        # r(r+1)/2 causal pairs, the chunk state over r rows, and the
        # inter-chunk term (after the first chunk), N- or P-deep
        # multiply-adds.
        flops = 0
        for c0 in range(0, L, chunk):
            r = min(chunk, L - c0)
            pairs = r * (r + 1) // 2
            flops += 2 * (pairs * (N + P) + r * N * P * (2 if c0 else 1))
        flops *= Bsz * H
        peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
        row = dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/ssd_scan.cu",
            replaces="src/repro/kernels/ssd_scan/kernel.py:66",
            launches=n, max_abs_err=err, ms=ms, device_ms=dev_ms,
            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, n=int(Bsz * L * H),
            shape=[Bsz, L, H, P, G, N])
        if dtype == torch.bfloat16:
            # The split walk (32 P columns a CTA) against the unsplit one.
            row["device_ms_by_ptile"] = {
                pt: device_ms(lambda: ssd_kernel.ssd_scan(
                    *args, chunk=chunk, final_state=True, ptile=pt), 20,
                    kernel_re)
                for pt in (32, 64) if pt == 32 or N <= 128}
        rows.append(row)
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not ((SRC / "repro_torch").is_dir() and GOLDEN.is_file()
            and LOOP_GOLDEN.is_file() and SFP_GOLDEN.is_file()
            and SERVE_GOLDEN.is_file() and SSM_GOLDEN.is_file()
            and SWEEP_GOLDEN.is_file()):
        print("chip_smoke: run from the root of a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    sys.path.insert(0, str(ROOT / "tests"))
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.kernels.lindley import ops as lindley_ops
    from repro_torch.kernels.jsq_scan import ops as jsq_ops
    from repro_torch.net import fastsim, workloads
    from repro_torch.net.topology import FatTree
    from repro_torch.core import lb_schemes

    dev = torch.device("cuda", 0)
    # Float32 results are compared on the card: no TF32 anywhere.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    golden = json.loads(GOLDEN.read_text())
    # theory.DEFAULT_NET.prop_slots: 0.5 us links, 4178-byte slots at 800 Gb/s
    prop_slots = 0.5e-6 / (4178 * 8 / 800e9)
    check(prop_slots == golden["prop_slots"], "prop_slots differs from golden")
    errs = {"segmented_cummax": 0.0, "jsq_scan": 0.0, "flash_attention": 0.0,
            "flash_attention_f32": 0.0, "ssd_scan": 0.0, "ssd_scan_f32": 0.0}

    with Phase("build"):
        for name, log in _build.build_all().items():
            lines = [l.strip() for l in log.splitlines()
                     if "registers" in l or "spill" in l]
            print(f"built {name}: " + (" | ".join(lines) or "(cached)"),
                  flush=True)
        sass_check(_build)

    tree = FatTree(8)
    wls = {"permutation": workloads.permutation(
               tree, 256, np.random.default_rng(1), inter_pod_only=True),
           "all_to_all": workloads.all_to_all(tree, 32)}

    with Phase("kernels_vs_plain"):
        gen = torch.Generator().manual_seed(0)
        for n in CUMMAX_SIZES:
            for density in DENSITIES:
                v, f = cummax_inputs(n, density, gen, dev)
                for flags in ((f, f.to(torch.int32)) if n == 1025 else (f,)):
                    got = lindley_ops.segmented_cummax(v, flags)
                    want = lindley_ops.segmented_cummax(v, flags,
                                                        backend="torch")
                    torch.cuda.synchronize()
                    err = max_abs_err(got, want)
                    errs["segmented_cummax"] = max(errs["segmented_cummax"],
                                                   err)
                    check(err == 0.0 and torch.equal(got, want),
                          f"segmented_cummax n={n} density={density} "
                          f"{flags.dtype}: kernel != plain (err {err})")
        print(f"segmented_cummax: {len(CUMMAX_SIZES) * len(DENSITIES) + 4} "
              f"cases bitwise equal (tolerance: bitwise, max_abs_err 0; max "
              f"is exact in any scan order)", flush=True)
        n_nan = 0
        for case in ("documented",) + CUMMAX_NAN_SIZES:
            v, f = cummax_nan_inputs(case, gen, dev)
            for vv, ff in ((v, f), (v.view(4, -1), f.view(4, -1))):
                got = lindley_ops.segmented_cummax(vv, ff)
                want = lindley_ops.segmented_cummax(vv, ff, backend="torch")
                torch.cuda.synchronize()
                nan = torch.isnan(want)
                check(bool(nan.any()) and torch.equal(torch.isnan(got), nan)
                      and torch.equal(got[~nan], want[~nan]),
                      f"segmented_cummax NaN case {case} {tuple(vv.shape)}: "
                      f"kernel != plain")
                n_nan += 1
            if case == "documented":
                one = lindley_ops.segmented_cummax(v, f).cpu()
                check(bool(torch.isnan(one[2:5]).all())
                      and one[:2].tolist() == [1, 5]
                      and one[5:].tolist() == [3, 3, 9],
                      f"segmented_cummax: documented NaN case gave {one}")
        print(f"segmented_cummax NaN: {n_nan} cases equal (NaN positions "
              f"and every other value bitwise; int64 flags)", flush=True)
        for wl_name, wl in wls.items():
            for scheme in ("jsq", "switch_pkt_ar"):
                with Recorder(jsq_ops, "jsq_scan", lambda a: a[0].numel(),
                              keep_every=1) as rec:
                    fastsim.simulate(tree, wl, lb_schemes.by_name(scheme),
                                     seed=0, prop_slots=prop_slots)
                check(len(rec.calls) == 2, "expected two JSQ layers")
                # The all-to-all's agg grid (57,408 arrival ranks) takes its
                # plain version ~22 s; the timing phase holds the largest
                # such grid to it.
                grids = list(zip(("edge", "agg"), rec.calls))
                if wl_name == "all_to_all":
                    grids = grids[:1]
                for layer, (args, kw) in grids:
                    got = jsq_ops.jsq_scan(*args[:5])
                    want = jsq_ops.jsq_scan(*args[:5], backend="torch")
                    torch.cuda.synchronize()
                    for g, w, what in zip(got, want,
                                          ("port", "dep", "occ")):
                        err = max_abs_err(g, w)
                        errs["jsq_scan"] = max(errs["jsq_scan"], err)
                        check(torch.equal(g, w),
                              f"jsq_scan {wl_name}/{scheme}/{layer} {what}: "
                              f"kernel != plain (err {err})")
                    print(f"jsq_scan {wl_name}/{scheme}/{layer} grid "
                          f"{tuple(args[0].shape)}: bitwise equal "
                          f"(tolerance: bitwise); walked prefix "
                          f"{walked(args[1])} of pad {args[0].shape[-1]}",
                          flush=True)
        for h in (33, 64):
            for quanta in (None, (0.05, 0.10, 0.20)):
                args = jsq_grid(2, 8, 400, h, quanta, gen, dev)
                got = jsq_ops.jsq_scan(*args)
                want = jsq_ops.jsq_scan(*args, backend="torch")
                torch.cuda.synchronize()
                for g, w, what in zip(got, want, ("port", "dep", "occ")):
                    err = max_abs_err(g, w)
                    errs["jsq_scan"] = max(errs["jsq_scan"], err)
                    check(torch.equal(g, w),
                          f"jsq_scan random h={h} quanta={quanta} {what}: "
                          f"kernel != plain (err {err})")
                check(int(got[0].max()) >= 32,
                      f"jsq_scan random h={h}: no port past the 32nd chosen")
                print(f"jsq_scan random grid {tuple(args[0].shape)} h={h} "
                      f"quanta={quanta}: bitwise equal (tolerance: bitwise)",
                      flush=True)
        # The walk's edges (tests/_torch_compare.py:jsq_walk_grid): an empty
        # row, a full row, packets that are not a prefix, finite times in
        # empty cells, pad = 1; up to 8 ports and 8 bin edges take the
        # registers walk, 10 edges the lanes walk.
        from _torch_compare import jsq_walk_grid
        n_walk = 0
        for h in (4, 8, 33, 64):
            for pad in (1, 400):
                for quanta in (None, (0.05, 0.10, 0.20),
                               tuple(0.05 * k for k in range(1, 11))):
                    grid = [None if a is None else a.to(dev)
                            for a in jsq_walk_grid(h + pad, 2, 4, pad, h,
                                                   quanta)]
                    want = jsq_ops.jsq_scan(*grid, backend="torch")
                    got = jsq_ops.jsq_scan(*grid)
                    torch.cuda.synchronize()
                    for g, w, what in zip(got, want, ("port", "dep", "occ")):
                        err = max_abs_err(g, w)
                        errs["jsq_scan"] = max(errs["jsq_scan"], err)
                        check(torch.equal(g, w),
                              f"jsq_scan walk grid h={h} pad={pad} "
                              f"quanta={quanta} {what}: kernel != plain "
                              f"(err {err})")
                    n_walk += 1
        print(f"jsq_scan walk edges: {n_walk} cases bitwise equal (empty "
              f"and full rows, packets not a prefix, pad 1 and 400, h 4, 8, "
              f"33, 64, 0, 3 and 10 bin edges, both walks; tolerance: "
              f"bitwise)", flush=True)

    launches = {"segmented_cummax": 0, "jsq_scan": 0}
    with Phase("main_path"), \
            Recorder(lindley_ops, "segmented_cummax",
                     lambda a: a[0].numel()) as rec_l, \
            Recorder(jsq_ops, "jsq_scan", lambda a: a[0].numel()) as rec_j:
        for wl_name, wl in wls.items():
            for group in SCHEME_GROUPS:
                items = [(tree, wl, lb_schemes.by_name(s), list(SEEDS), None,
                          None) for s in group]
                want = ("segmented_cummax",) + (
                    ("jsq_scan",) if group == ("switch_pkt_ar",) else ())
                fast_group(f"{wl_name}/{'+'.join(group)}", items,
                           [f"{wl_name}/{s}" for s in group],
                           golden["points"], prop_slots, launches, tree, want)
        check(launches["segmented_cummax"] > 0 and launches["jsq_scan"] > 0,
              "a kernel of the main path was never launched")

    loop_launches, recs = loop_phases(
        tree, dev, errs, launches, json.loads(LOOP_GOLDEN.read_text()))
    sack_recs = dynamic_phases(tree, dev, errs, launches, loop_launches,
                               json.loads(SFP_GOLDEN.read_text()), prop_slots)
    campaign_launches = campaign_phase()
    attention_phase(dev, errs)
    f32_launches = serve_golden_phase(dev)
    from repro_torch.configs import get_config
    yi_launches, yi_recs, yi_profile = serve_main_phase(
        dev, "serve_main_path", "yi-6b", SERVE_LENS, GREEDY_BATCH,
        {"flash_attention": get_config("yi-6b").n_layers})
    ssd_phase(dev, errs)
    n_attn, ssd_f32_launches = ssm_golden_phase(dev)
    f32_launches += n_attn
    zcfg, mcfg = get_config("zamba2-2.7b"), get_config("mamba2-130m")
    z_launches, z_recs, z_profile = serve_main_phase(
        dev, "ssm_serve_main_path zamba2-2.7b", zcfg.name, SERVE_LENS,
        GREEDY_BATCH, {"ssd_scan": zcfg.n_layers,
                       "flash_attention": zcfg.n_layers
                       // zcfg.shared_attn_every})
    m_launches, m_recs, m_profile = serve_main_phase(
        dev, "ssm_serve_main_path mamba2-130m", mcfg.name, MAMBA_LENS,
        GREEDY_BATCH, {"ssd_scan": mcfg.n_layers})
    torch.cuda.empty_cache()

    kernels = []
    with Phase("timing"):
        # The largest inputs the main path gave each kernel; the kernel is
        # held bitwise to its plain version on them too.
        args, _ = rec_l.largest
        v, flags = args[0], args[1]
        n = v.numel()
        got = lindley_ops.segmented_cummax(v, flags)
        want = lindley_ops.segmented_cummax(v, flags, backend="torch")
        check(torch.equal(got, want), "segmented_cummax: kernel != plain on "
              "the main path's largest input")
        ms = cuda_ms(lambda: lindley_ops.segmented_cummax(v, flags), 20)
        dev_ms = device_ms(lambda: lindley_ops.segmented_cummax(v, flags),
                           20, r"\b(tile_aggregate|scan_aggregates|"
                           r"tile_apply)\(")
        plain_ms = cuda_ms(lambda: lindley_ops.segmented_cummax(
            v, flags, backend="torch"), 3)
        nbytes = n * (4 + flags.element_size() + 4)
        kernels.append(dict(
            name="segmented_cummax", route="cuda",
            source="src/repro_torch/csrc/lindley.cu",
            replaces="src/repro/kernels/lindley/kernel.py:61",
            launches=launches["segmented_cummax"],
            max_abs_err=errs["segmented_cummax"], ms=ms, device_ms=dev_ms,
            plain_ms=plain_ms,
            bound_ms=max(nbytes / HBM_BYTES_PER_S, n / FP32_FLOP_PER_S) * 1e3,
            bound_by="bytes", library_ms=None, n=n,
            shape=list(v.shape)))
        args, _ = rec_j.largest
        t_grid, ok_grid, noise, port_pen, thresholds = args[:5]
        B, S, pad = t_grid.shape
        h = noise.shape[-1]
        cells = B * S * pad
        got = jsq_ops.jsq_scan(*args[:5])
        want, plain_ms = cuda_once(
            lambda: jsq_ops.jsq_scan(*args[:5], backend="torch"))
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              "jsq_scan: kernel != plain on the main path's largest grid")
        for _ in range(10):     # the card's clocks settle after the plain run
            jsq_ops.jsq_scan(*args[:5])
        ms = cuda_ms(lambda: jsq_ops.jsq_scan(*args[:5]), 5)
        dev_ms = device_ms(lambda: jsq_ops.jsq_scan(*args[:5]), 5,
                           r"\bjsq_scan_kernel\b")
        nq = 0 if thresholds is None else thresholds.numel()
        # The walk's step time: the same grid with the last cell of every
        # row occupied, so each row walks all pad cells and has no tail
        # (CUDA events: a launch is milliseconds long).
        ok_walk = ok_grid.clone()
        ok_walk[..., -1] = True
        walk_args = (t_grid, ok_walk) + tuple(args[2:5])
        got = jsq_ops.jsq_scan(*walk_args)
        want = jsq_ops.jsq_scan(*walk_args, backend="torch")
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              "jsq_scan: kernel != plain on the main grid with no tail")
        ms_no_tail = cuda_ms(lambda: jsq_ops.jsq_scan(*walk_args), 3)
        del got, want, ok_walk, walk_args
        walk = walked(ok_grid)
        nbytes = cells * (4 + 1 + 4 * h + 4 + 4 + 4) + B * h * 4 + nq * 4
        flops = cells * h * (6 + nq)
        kernels.append(dict(
            name="jsq_scan", route="cuda",
            source="src/repro_torch/csrc/jsq_scan.cu",
            replaces="src/repro/net/fastsim.py:224 (lax.scan, no Pallas "
                     "kernel)",
            launches=launches["jsq_scan"], max_abs_err=errs["jsq_scan"],
            ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
            bound_ms=max(nbytes / HBM_BYTES_PER_S,
                         flops / FP32_FLOP_PER_S) * 1e3,
            bound_by="bytes" if nbytes / HBM_BYTES_PER_S
            >= flops / FP32_FLOP_PER_S else "operations",
            library_ms=None, n=cells, shape=[B, S, pad, h], walked=walk,
            ms_no_tail=ms_no_tail, walk_ns_per_cell=ms_no_tail * 1e6 / pad))
        for name in SLOT_KERNELS:
            kernels.append(slot_timing(name, recs[name].largest, errs[name],
                                       loop_launches[name]))
        for name in SACK_KERNELS:
            kernels.append(sack_timing(name, sack_recs[name].largest,
                                       errs[name], loop_launches[name]))
        kernels += attention_timing(
            yi_recs["flash_attention"], errs,
            yi_launches["flash_attention"] + z_launches["flash_attention"],
            f32_launches)
        ssd_rec = max((z_recs["ssd_scan"], m_recs["ssd_scan"]),
                      key=lambda r: r.size_of(r.largest[0]))
        kernels += ssd_timing(
            ssd_rec, errs, z_launches["ssd_scan"] + m_launches["ssd_scan"],
            ssd_f32_launches)
        for k in kernels:
            if k["name"] in campaign_launches:
                k["campaign_launches"] = campaign_launches[k["name"]]
        for k in kernels:
            print(f"kernel {k['name']}: launches={k['launches']} "
                  f"shape={k['shape']} ms={k['ms']:.4f} "
                  f"device_ms={k['device_ms']} "
                  f"plain_ms={k['plain_ms']:.4f} bound_ms={k['bound_ms']:.4f} "
                  f"library_ms={k['library_ms']}"
                  + "".join(f" {x}={k[x]}" for x in (
                      "device_ms_by_ptile", "walked", "ms_no_tail",
                      "walk_ns_per_cell", "campaign_launches") if x in k),
                  flush=True)
        # The launch floor: one trivial PyTorch launch (a 1-element add_),
        # timed as the kernels are; a launch-bound kernel's device ms cannot
        # go below its device ms.
        one = torch.zeros(1, device=dev)
        floor_dev = device_ms(lambda: one.add_(1.0), 50,
                              r"elementwise_kernel")
        floor_ms = cuda_ms(lambda: one.add_(1.0), 50)
        print(f"launch floor: a 1-element add_ device_ms={floor_dev} "
              f"ms={floor_ms:.4f}", flush=True)

    with Phase("serve_profile"):
        yi_profile()
        z_profile()
        m_profile()
    del yi_profile, z_profile, m_profile
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
