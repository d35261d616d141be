"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each timed on its own line; any failure exits non-zero:

1. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once), and read the SASS of the attention and SSD
   libraries with ``cuobjdump``: every instance of the attention kernels on
   the tensor cores (the bf16 forward and backward, and the float32 forward
   and backward, which reach float32 accuracy on the bf16 tensor cores by
   a three-way bf16 split), of the bf16 and float32 SSD walks and of the
   bf16 SSD backward's two tensor-core launches must hold ``HGMMA``
   (Hopper's warpgroup tensor-core instruction);
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
   fused dispatch per pipeline identity (fig 3's point without
   switch_pkt), with the launch counts set to 0 just before each dispatch
   and read just after.  Every fused result must
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
11. ``attention_vs_plain``: hold the flash-attention kernels to their plain
    version (bf16: the tensor-core kernel at atol = rtol = 2e-2, the
    CUDA-core kernel past D = 256; float32: the float32 tensor-core kernel
    with q's head dim up to 192 and v's width up to 128, the CUDA-core
    kernel past them, at 2e-5; the reference's own tolerances) at Yi-6B's
    heads (32 query heads, 4 KV heads, D = 128) for S = 1-2,048, two query
    tails, D = 32, 64, 96, Zamba2-2.7B's shared block (32 query and 32 KV
    heads of D = 80), D = 36, 136, 256 and 288, v of another width than q
    and k (MLA's 192/128 among them), causal with more queries than keys
    (the first Sq - Sk rows see no key and give the mean of v) on both
    types, float16 and mixed dtypes (read in float32, a float32 route, at
    2e-2), and the zoo's shapes (``ATTN_ZOO``): MLA's prefill
    (128 heads, Dk 192, Dv 128), Whisper's encoder (1,500 ragged keys, not
    causal) and cross attention (1 and 37 queries against 1,500 keys, not
    causal), LLaVA-NeXT-34B's 2,980-position prefill, Qwen3-MoE's
    2,048-token prefill and Phi-3-mini's D = 96;
12. ``serve_golden``: Yi-6B at full width, 2 layers, float32 (the float32
    attention kernels' path: their launch counts by route,
    ``ops.ROUTE_LAUNCHES``, are set to 0 just before this phase, phase 15
    and each model of phase 19 and read just after: only the float32
    tensor-core route may have launched, MLA's golden (Dk 192) included),
    with the
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
    tensor-core walk up to N = 256; float32: the float32 tensor-core walk
    up to N = 128, each of its cases rerun bitwise; past those states the
    CUDA-core route, which a float32 and a bf16 case (N = 320) still take)
    to the plain ``ssd_chunked``, and the final state they return to the
    plain ``ssd_final_state``, at Zamba2-2.7B's heads (80 of P = 64, N = 64),
    Mamba2-130M's (24 of P = 64, N = 128) and the reference's grouped shape
    (8 heads over 4 groups) for L = 1, 37, 64, 100 and 2,048 at batch 1 and
    2 (float32 at the reference's 5e-5/5e-4, bf16 at 2e-2), requested
    chunks of 1, 16, 32 and 63 (both walks run them as 64), a large-decay
    case per head shape (``A * dt`` summing past 100 within a chunk: finite
    and within tolerance), P = 100-128 and N = 200-256 at a requested chunk
    of 128, float16 and mixed dtypes of x, B and C (read in float32, the
    float32 walk, at 2e-2), and, at L <= 100 in float32, to the
    sequential ``ssd_scan`` too;
15. ``ssm_serve_golden``: Mamba2-130M at full size and Zamba2-2.7B at full
    width cut to 6 layers (one shared-block application), float32, numpy
    weights, held to ``tests/torch_golden/serve_ssm.json`` (CPU JAX) as
    phase 12 holds Yi-6B, with the SSD launch counts by route set to 0
    just before and read just after: every one on the float32 tensor-core
    walk;
16. ``ssm_serve_main_path``: Zamba2-2.7B at full width and depth in bf16
    through phase 13's batcher mix, ``greedy_decode`` and checks, with the
    ``ssd_scan`` and ``flash_attention`` launch counts set to 0 just before
    and read just after (54 and 9 a prefill, every one on the tensor-core
    kernels); then Mamba2-130M at full size the same way with 4 requests
    (24 ``ssd_scan`` launches a prefill);
17. time each kernel and its plain version on the largest inputs the main
    paths gave it (the attention backward kernel at the training main
    path's shape, random inputs, in bf16 and float32, beside one SDPA
    backward), beside the bound of the card (and, for flash attention,
    one ``scaled_dot_product_attention`` call as the library's time; no
    single PyTorch call computes the SSD scan); the float32 SSD walk is
    timed at that shape on random float32 inputs beside its and its plain
    version's distance from float64, the float32 SSD's CUDA-core route at
    ``SSD_CUDA_CORE_SHAPE`` (N = 256), the float32 attention's tensor-core
    kernel at that shape on random float32 inputs, each float32 attention
    row beside its and its plain version's largest distance from float64
    (``f64_err``, ``plain_f64_err``), the float32 tensor-core kernels
    (forward and backward) and the bf16 backward at MLA's prefill (128
    heads, Dk 192, Dv 128, 511 positions: the widest heads of the main
    paths; the ``_wide`` rows), the CUDA-core kernels (forward and
    backward, float32) at ``CUDA_CORE_SHAPE`` (D = 256, past the
    tensor-core routes of float32 and of the backward), both SSD
    walks with 32 and with 64 P columns a CTA, and ``jsq_scan`` through both
    walks, beside its longest walked prefix and the device time a walked
    step; the launch floor, one 1-element ``add_`` timed the same way; and
    the bf16 attention kernel at each ``ATTN_ZOO`` shape (random inputs)
    beside its plain version, its bound and one SDPA call;
18. ``serve_profile``: a decode step and a 2,048-token prefill of
    Yi-6B, Zamba2-2.7B and Mamba2-130M under ``torch.profiler``: wall
    time, device busy time, idle share, kernel launches, host
    synchronisations and the five device events with the most time (last,
    as a profiler session followed by long unprofiled work left later
    traces short of kernel events).

19. ``zoo_serve_golden``: the rest of the zoo at full width in float32,
    numpy weights, held to the CPU JAX goldens of
    ``tests/torch_golden/make_zoo_golden.py`` as phase 12 holds Yi-6B:
    Qwen3-MoE-30B-A3B cut to 2 layers (128 experts, top 8, the dense
    oracle), DeepSeek-V3 cut to one MLA layer with the dense MLP,
    LLaVA-NeXT-34B cut to 2 layers after 2,880 vision embeds, and
    Whisper-small whole with 1,500 frames;
20. ``zoo_serve_main_path``: each of those families in bf16 at full width,
    random weights, through phase 13's batcher, ``greedy_decode`` and
    checks (kernel path vs plain path within 0.1, batcher == solo), with
    the flash-attention launch count set to 0 just before and read just
    after: Qwen3-MoE-30B-A3B cut to 12 of its 48 layers (``QWEN_LAYERS``;
    8.1 B parameters; ``SERVE_LENS``), DeepSeek-V3 cut to its 3 dense layers and 1 MoE layer
    (15.1 B parameters; prompts of 13-511 tokens), LLaVA-NeXT-34B cut to 20
    of its 60 layers (``greedy_decode`` with 2,880 vision embeds before
    100-token prompts, at the token embeddings' scale), Whisper-small whole
    (``greedy_decode`` with 1,500 frames; its cross attention launches the
    kernel each decode step); after LLaVA, ``zoo_vlm_float32_anchor``: the
    same 20 layers prefilled after 2,880 unit-normal vision embeds through
    the kernel path, the plain path and the plain path in float32 (the
    weights upcast), the kernel path no further from float32 than the plain
    path plus 0.1;
21. ``attention_grad_vs_plain``: hold the flash-attention backward kernel
    (``csrc/flash_attn_bwd.cu``, through ``ops.attention``'s autograd
    route) to its plain version ``ref.mha_vjp`` (bf16 at 2e-2, float32 at
    1e-4, each of a gradient's largest magnitude: ``ATTN_GRAD_TOL``) at
    Yi-6B's heads for S = 1-4,096, D = 64, 80, 96, 128, 256 and 288 (the
    last two on the CUDA-core route), MLA's 192/128 at 128 heads and with
    rows that see no key, D = 160 with Dv = 64, causal with more queries
    than keys, ragged keys,
    Whisper's encoder and cross attention (not causal), float16 and mixed
    dtypes; each shape twice, the reruns bitwise equal;
22. ``ssd_grad_vs_plain``: hold the SSD scan's backward kernels (bf16 with
    N <= 128 on the tensor cores, ``csrc/ssd_scan_bwd_wgmma.cu``; the rest,
    N 200 and 256 among them, on the CUDA cores, ``csrc/ssd_scan_bwd.cu``;
    each case's calls counted by route) to their plain version
    ``ref.ssd_vjp`` at
    Zamba2-2.7B's, Mamba2-130M's and the grouped heads for L = 1, 37, 64
    and 2,048 at batch 1 and 2, a large-decay case per head shape (every
    gradient finite), final-state gradients, requested chunks of 16 and
    128, P and N past a tile of 64, strided slices of x, B, C and dy,
    float16 and mixed dtypes; bf16 at 2e-2 of each gradient's largest
    magnitude, float32 no further from a float64 plain gradient than twice
    the float32 plain version (plus 4 ulps); every case rerun bitwise; and
    through ``ops.ssd``'s autograd route (``SSDScan``);
23. ``train_golden``: Yi-6B at full width, 2 layers, float32, numpy
    weights: two train steps (microbatch 2, a ``batch_for_step`` batch)
    with AdamW and with Adafactor, and Mamba2-130M at full width, 2
    layers, two AdamW steps (the SSD scan's float32 walk and its backward
    kernel), held to the CPU JAX goldens of
    ``tests/torch_golden/make_train_golden.py`` (losses, gradient norms and
    sampled parameters and optimizer state);
24. ``train_main_path``: Yi-6B at full width cut to 4 of its 32 layers,
    bf16, 4 sequences of 4,096 tokens a step (one a microbatch), AdamW,
    remat, through ``build_train_step`` and a ``ResilientLoop`` (a
    checkpoint every 2 steps under ``build/``) for 3 steps, with the
    attention's and the SSD scan's forward and backward launch counts set
    to 0 just before and read just after (4 layers x 4 microbatches x 2
    forwards, the pass and its remat, and 4 x 4 backwards a step); step
    1's loss and gradient norm held to a plain run (``backend="torch"``)
    from the same weights; then a crash after step 2's checkpoint: a
    second ``ResilientLoop`` restores it into zeroed state and runs step
    3, whose parameters must equal the uninterrupted run's bitwise
    (deterministic algorithms on).  Each step prints its wall ms, tokens
    per second, the device ms in each kernel and the peak memory;
25. ``train_ssm_main_path``: the same path for Mamba2-130M whole (24
    layers, 4 sequences of 2,048 tokens in 2 microbatches) and Zamba2-2.7B
    at full width cut to 12 of its 54 layers (two applications of the
    shared block; 4 sequences of 4,096 tokens in 4 microbatches), bf16:
    every SSD forward on the bf16 walk and every backward on the backward
    kernel's tensor-core route (``BWD_ROUTE_LAUNCHES["wgmma"]``), Zamba2's
    shared attention on the tensor-core kernels; step 1 against the plain
    path, the restart bitwise;
26. ``train_zoo_smoke``: one train step of each family that trains on the
    card (dense, MoE, MLA, VLM, enc-dec, SSM, hybrid) at its smoke config
    (float32), the kernel path against the plain path; then DeepSeek-V3's
    smoke config at its own head widths (rope 64 + nope 128 = Dk 192, Dv
    128), one float32 and one bf16 step, each kernel path against the plain
    path, the attention's forward and backward launches counted by route
    (all on the tensor cores);
27. ``train_cli``: ``repro_torch.launch.train.main`` on the card, Yi-6B's
    smoke config for 4 steps, then restarted to 6: it must resume at 4;
28. ``ssd_bwd_timing``: the SSD backward kernels' rows of the ``kernels``
    line (bf16 at Zamba2-2.7B's train shape on the tensor cores, beside the
    CUDA-core route's device ms by launch on the same inputs and both
    routes' distance from a float64 gradient of the same bf16 inputs;
    float32 at the SSM golden's and bf16 at N = 256 on the CUDA cores;
    random inputs, held to the plain version first), each with its device
    ms by launch, beside its plain version and the bound (no PyTorch call
    computes this gradient).

Every main-path run of phases 3, 5, 7-10, 13, 16, 20, 24 and 25 sets the
kernels' launch counts to 0 just before it and reads them just after.

The last lines are the ``kernels`` JSON line, the card's name and power
limit, and ``{"ok": true, "device": {...}}"""
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
# Float32-accurate products on the tensor cores: each float32 operand as
# three bf16 parts, a product as six bf16 partial products (the float32
# routes of csrc/flash_attn.cu and flash_attn_bwd.cu), so one float32
# operation costs six at the bf16 dense rate: 989 / 6 = 165 TFLOP/s, 2.5x
# the CUDA cores' 67.  The bound of a float32 kernel whose work is matrix
# products (attention, the SSD scan) is its operations at this rate.
FP32_SPLIT_FLOP_PER_S = 989e12 / 6

SCHEME_GROUPS = (("flow_ecmp", "host_pkt", "host_dr"), ("switch_pkt",),
                 ("switch_pkt_ar",), ("ofan",))
SEEDS = (0, 1)            # the fast engine's main path: seeds 0-1
LOOP_SEEDS = (0, 1)       # the slotted engine's main path: seeds 0-1
# The slotted engine's fused dispatches: one per pipeline identity.  The
# slot loop is launch-bound, and fig 3's switch_pkt runs 1,600 slots against
# its point's ~670, so that point left the main path to keep the script
# within its time (PERF.md §4); switch_pkt still runs on the free point here
# and on the fast engine's main path.
LOOP_GROUPS = {
    "free": (("host_pkt", "flow_ecmp", "host_dr"), ("host_pkt_ar",),
             ("host_flowlet_ar",), ("switch_pkt",), ("switch_pkt_ar",),
             ("jsq",), ("ofan",)),
    "fig3": (("host_pkt",), ("host_pkt_ar",), ("switch_pkt_ar",),
             ("ofan",)),
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


def device_ms(fn, reps: int, kernel_re: str, per_call: int = 0,
              split: bool = False):
    """Mean device milliseconds per call of the CUDA kernels whose names
    match ``kernel_re``, from a ``torch.profiler`` trace of ``reps`` calls
    after one warm-up call (None when the trace holds no device time).
    With ``per_call``, each trace follows a warm-up trace of one call, and
    one that holds other than ``per_call`` x ``reps`` launches of them is
    printed with its counts and taken again, up to three traces; if none
    holds them all, the mean over the calls the last one held (its launches
    over ``per_call``; traces on the card have come back short of launches
    from the first calls), which is printed too.  With ``split``, returns
    (that mean, {kernel: mean device ms per launch}) from the same trace,
    the match of ``kernel_re`` naming the kernel."""
    tries = 3
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    pat = re.compile(kernel_re)

    def result(ms):
        if not split:
            return ms
        us, n = {}, {}
        for e in hits:
            k = pat.search(e.key).group(0)
            us[k] = us.get(k, 0.0) + getattr(e, "device_time_total", 0.0)
            n[k] = n.get(k, 0) + e.count
        return ms, {k: us[k] / n[k] / 1e3 for k in us if n[k]}
    for attempt in range(tries if per_call else 1):
        if per_call:
            with profile(activities=[ProfilerActivity.CUDA]):
                fn()
                torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if pat.search(e.key)]
        total_us = sum(getattr(e, "device_time_total", 0.0) for e in hits)
        n = sum(e.count for e in hits)
        if not per_call or n == per_call * reps:
            return result(total_us / reps / 1e3 if total_us > 0 else None)
        print(f"device_ms: trace {attempt + 1} of {tries} held {n} of the "
              f"{per_call * reps} launches matching {kernel_re!r}: "
              + ", ".join(f"{e.key[:70]} x{e.count}" for e in hits),
              flush=True)
    if n < per_call or total_us <= 0:
        return result(None)
    print(f"device_ms: the mean over the {n / per_call:g} calls the last "
          f"trace held", flush=True)
    return result(total_us / (n / per_call) / 1e3)


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


def mha64(q, k, v, dout=None, *, causal=True, scale=None):
    """Attention as ``ref.mha`` defines it, computed in float64 one KV
    head's query group at a time: the output, or with ``dout`` the
    gradients (dq, dk, dv) along it.  The yardstick of the float32 rows'
    ``f64_err``."""
    import torch
    g = q.shape[1] // k.shape[1]
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    Sq, Sk = q.shape[2], k.shape[2]
    hidden = (torch.arange(Sk, device=q.device)[None, :]
              > torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq))
    parts = []
    for h in range(k.shape[1]):
        qs = slice(h * g, (h + 1) * g)
        with torch.enable_grad():
            qh, kh, vh = (t.detach().double().requires_grad_(dout is not None)
                          for t in (q[:, qs], k[:, h:h + 1], v[:, h:h + 1]))
            s = torch.einsum("bhqd,bhkd->bhqk", qh,
                             kh.expand(-1, g, -1, -1)) * scale
            if causal:
                s = s.masked_fill(hidden, -1e300)
            o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1),
                             vh.expand(-1, g, -1, -1))
            parts.append(o.detach() if dout is None else torch.autograd.grad(
                o, (qh, kh, vh), dout[:, qs].double()))
    if dout is None:
        return torch.cat(parts, 1)
    return tuple(torch.cat(x, 1) for x in zip(*parts))


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
              ("flash_attn_f32", "flash_attention_f32_kernel"),
              ("flash_attn_bwd", "attn_bwd_dkv_wgmma_kernel"),
              ("flash_attn_bwd", "attn_bwd_dq_wgmma_kernel"),
              ("flash_attn_bwd_f32", "attn_bwd_dkv_f32_kernel"),
              ("flash_attn_bwd_f32", "attn_bwd_dq_f32_kernel"),
              ("ssd_scan", "ssd_wgmma_kernel"),
              ("ssd_scan_f32", "ssd_wgmma_f32_kernel"),
              ("ssd_scan_bwd_wgmma", "ssd_bwdw_states"),
              ("ssd_scan_bwd_wgmma", "ssd_bwdw_chunk"))


def sass_check(build):
    """Every instance of each tensor-core kernel in its built library must
    hold HGMMA (wgmma, Hopper's warpgroup tensor-core instruction)."""
    import re
    tool = Path(build._nvcc()).parent / "cuobjdump"
    # one dump a library into a file beside it, all started together
    libs = list(dict.fromkeys(lib for lib, _ in TC_KERNELS))
    dumps = {lib: build.BUILD_DIR / f"{lib}.sass" for lib in libs}
    procs = {}
    for lib in libs:
        with open(dumps[lib], "w") as out:
            procs[lib] = subprocess.Popen(
                [str(tool), "-sass", str(build.lib_path(lib))], stdout=out)
    sasses = {}
    for lib, proc in procs.items():
        check(proc.wait(timeout=300) == 0, f"cuobjdump failed on {lib}")
        sasses[lib] = dumps[lib].read_text()
    for lib, kernel in TC_KERNELS:
        sass = sasses[lib]
        funcs = re.split(r"\n\s*Function : ", sass)[1:]
        wg = [f for f in funcs if kernel in f.split("\n", 1)[0]]
        counts = [f.count("HGMMA") for f in wg]
        check(wg and all(counts), f"{lib}: the SASS of {kernel} holds no "
              f"HGMMA ({len(wg)} instances, HGMMA counts {counts})")
        print(f"{lib} SASS: {len(wg)} instances of {kernel}, each holding "
              f"HGMMA ({min(counts)}-{max(counts)} instructions): it runs on "
              f"wgmma; HMMA in the library: {sass.count('HMMA')}",
              flush=True)


def reset_attn_routes():
    """Set the attention wrappers' launch counts by route (forward and
    backward, ``ops.ROUTE_LAUNCHES`` and ``ops.BWD_ROUTE_LAUNCHES``) to 0."""
    from repro_torch.kernels.flash_attn import ops as attn_ops
    for counts in (attn_ops.ROUTE_LAUNCHES, attn_ops.BWD_ROUTE_LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))


def f32_routes(tag, bwd=False):
    """The float32 attention launches since ``reset_attn_routes`` (the
    forward's, or with ``bwd`` (forward, backward)) of a float32 phase,
    every head of which is within the float32 tensor-core route's limits
    (MLA's Dk 192 / Dv 128 among them); fails unless they all took that
    route."""
    from repro_torch.kernels.flash_attn import ops as attn_ops
    got = [dict(attn_ops.ROUTE_LAUNCHES)]
    if bwd:
        got.append(dict(attn_ops.BWD_ROUTE_LAUNCHES))
    check(all(r["wgmma_f32"] > 0 and r["cuda_cores"] == 0 and r["wgmma"] == 0
              for r in got),
          f"{tag}: float32 attention launches by route {got}: all must take "
          f"the float32 tensor-core route")
    print(f"{tag}: float32 attention launches by route {got}", flush=True)
    n = [r["wgmma_f32"] for r in got]
    return tuple(n) if bwd else n[0]


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
# prefill lengths of the main path, two query tails, smaller head dims,
# Zamba2-2.7B's shared block (32 query and 32 KV heads of D = 80), and
# heads past the tensor-core routes (float32 past 192 / 128, bf16 past
# 256: D = 136, 256 and 288 keep the CUDA-core kernel held to the plain
# version).
ATTN_SHAPES = ([(1, 32, 4, S, S, 128)
                for S in (1, 13, 64, 100, 128, 511, 1000, 1025, 2048)]
               + [(1, 32, 4, 1, 2048, 128), (2, 32, 4, 64, 1000, 128),
                  (2, 8, 2, 37, 37, 32), (1, 8, 2, 100, 130, 64),
                  (2, 6, 3, 65, 200, 96)]
               + [(1, 32, 32, S, S, 80) for S in (13, 100, 1025, 2048)]
               + [(1, 32, 32, 1, 2048, 80)]
               + [(1, 8, 2, 100, 100, 36), (2, 8, 2, 37, 37, 36),
                  (1, 8, 2, 300, 300, 136), (1, 8, 2, 1, 2048, 136),
                  (1, 8, 2, 2048, 2048, 256), (1, 4, 1, 77, 200, 256),
                  (1, 4, 1, 77, 200, 288)])
# v of another width than q and k, (B, Hq, Hkv, Sq, Sk, D, Dv): MLA's
# 192/128, a narrower and two wider v (the last past one output tile).
ATTN_MIXED = ((1, 16, 16, 300, 300, 192, 128), (2, 4, 2, 37, 37, 48, 32),
              (1, 8, 2, 100, 130, 64, 192), (1, 4, 1, 64, 64, 32, 300))
# The reference's own tolerances (tests/test_kernels.py:88), atol = rtol.
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# The domain past the models' path: causal with more queries than keys
# (B, Hq, Hkv, Sq, Sk, D) on both kernels, and float16 and mixed dtypes of
# (q, k, v) at 2e-2 (read in float32: at these heads, up to 128, the
# float32 tensor-core kernels).
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
# The rest of the zoo (float32 goldens of tests/torch_golden/
# make_zoo_golden.py, then bf16 main paths at full width).  DeepSeek-V3
# keeps its prompts at 512 tokens or fewer (each MoE layer's dense oracle
# holds (T, 256, 7,168) outputs in float32) and its depth at its three
# dense layers and one MoE layer; LLaVA-NeXT-34B is cut to LLAVA_LAYERS of
# its 60 layers and takes its 2,880 vision embeds in greedy_decode;
# Whisper-small runs whole with its 1,500 frames in greedy_decode.
ZOO_GOLDENS = tuple(ROOT / "tests" / "torch_golden" / n for n in (
    "serve_moe_l2.json", "serve_mla_l1.json", "serve_vlm_l2.json",
    "serve_encdec.json"))
DEEPSEEK_LAYERS = 4
# Qwen3-MoE-30B-A3B's serving main path at full width, cut to 12 of its
# 48 layers to make room for the training phases within the script's time
# limit.
QWEN_LAYERS = 12
DEEPSEEK_LENS = (13, 100, 511, 37)
LLAVA_LAYERS = 20
ZOO_LENS = (13, 100, 511, 37)
# LLaVA's vision embeds in its bf16 main path are normals times
# vocab ** -0.5: projected by vision_proj (fan-in scaled), each position
# then enters the residual stream at the token embeddings' scale.  Unit
# normals, as the float32 golden draws them, put the 2,880 vision positions
# at about 50x the tokens' RMS, and bf16 rounding then moves the tokens'
# logits in both bf16 paths: that case is held to a float32 run of the
# same weights in phase zoo_vlm_float32_anchor.
# flash_attention at the zoo's shapes, (label, (B, Hq, Hkv, Sq, Sk, D, Dv),
# causal): held to the plain version in attention_vs_plain and timed in
# the timing phase.  MLA's prefill (128 heads, Dk 192, Dv 128), Whisper's
# encoder (1,500 ragged keys, not causal) and its cross attention (one
# decode query a row, and a 37-token prefill, against 1,500 keys),
# LLaVA's prefill after 2,880 vision embeds, Qwen3-MoE's 2,048-token
# prefill and Phi-3-mini's head dim of 96 (the dense config no main path
# runs).
ATTN_ZOO = (
    ("mla_prefill_511", (1, 128, 128, 511, 511, 192, 128), True),
    ("mla_prefill_13", (1, 128, 128, 13, 13, 192, 128), True),
    ("whisper_encoder", (1, 12, 12, 1500, 1500, 64, 64), False),
    ("whisper_cross_decode", (2, 12, 12, 1, 1500, 64, 64), False),
    ("whisper_cross_prefill", (1, 12, 12, 37, 1500, 64, 64), False),
    ("llava_prefill", (1, 56, 8, 2980, 2980, 128, 128), True),
    ("qwen3_moe_prefill", (1, 32, 4, 2048, 2048, 128, 128), True),
    ("phi3_d96_prefill", (1, 32, 32, 2048, 2048, 96, 96), True),
    ("phi3_d96_decode", (1, 32, 32, 1, 2048, 96, 96), True),
)


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
# bf16 past the bf16 walk's N (the CUDA-core route), (H, P, G, N), for L =
# 37 and 500 at a requested chunk of 64.
SSD_WIDE_BF16 = (2, 64, 1, 320)
# Requested chunks below 64, which both tensor-core walks run as chunks of
# 64, at Zamba2-2.7B's and the grouped heads, L = 301 (ragged), with and
# without the large decay.
SSD_SHORT_CHUNKS = (1, 16, 32, 63)
# The float32 CUDA-core route's timing row: Mamba2-130M's heads with a
# state past the float32 walk's N (no main path reaches it).
SSD_CUDA_CORE_SHAPE = (1, 2048, 24, 64, 1, 256)
# float16 and mixed dtypes of (x, B, C), (B, L, H, P, G, N), at HALF_TOL.
SSD_HALF_SHAPES = ((1, 64, 2, 16, 1, 16), (1, 100, 80, 64, 1, 64))


class RouteLog:
    """Records every MoE routing (``repro_torch.models.moe.route``) while
    active, in call order: (the experts it chose (T, k), the float32 router
    logits (T, E), the experts it used), kept on the card.  A model with n MoE layers routes n
    times a prefill or decode step.  With ``replay`` (another run's calls,
    in order) each call routes to that run's experts instead, gated by this
    run's own probabilities at them (renormalised as ``route`` does), and
    records the experts it would have chosen: two runs of one input then
    follow the same experts, so that a near tie in the top k, which bf16
    sums taken in another order can flip, does not turn a small difference
    into another expert's output."""

    def __init__(self, replay=None):
        self.replay = replay

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.calls, self.moe, self.real = [], moe, moe.route

        def recording(x2d, router, k):
            gates, own = self.real(x2d, router, k)
            logits = x2d.float() @ router
            if self.replay is None:
                self.calls.append((own.clone(), logits, own))
                return gates, own
            idx = self.replay[len(self.calls)][2]
            self.calls.append((own.clone(), logits, idx))
            gates = torch.softmax(logits, dim=-1).gather(1, idx)
            return gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), idx
        moe.route = recording
        return self

    def __exit__(self, *exc):
        self.moe.route = self.real
        return False


def moe_layers(cfg) -> int:
    from repro_torch.models import transformer
    if not cfg.n_experts:
        return 0
    return transformer.section_layers(cfg).get("moe", 0)


def replayed_ties(tag, replayed, own, n_moe, got_toks, want_toks):
    """Check every expert choice that a replaying run (RouteLog ``own``
    calls) would have made otherwise than the run it replayed
    (``replayed``): the choice must sit at a near tie, its k-th and
    (k+1)-th router logits in ``own`` closer than twice the most any of
    that token's router logits moved between the runs, and that move at
    most BF16_LOGIT_ATOL; else a defect.  A decode step of a batch row is
    checked only while both runs fed the row the same tokens (each row's
    greedy tokens in ``got_toks``/``want_toks``).  Returns the number of
    near ties replayed."""
    ties = 0
    for c, ((_, gl, gi), (wi, wl, _)) in enumerate(zip(replayed, own)):
        step, layer = divmod(c, n_moe)
        k, T = wi.shape[1], wi.shape[0]
        batch = len(got_toks)
        diff = (gi.sort(-1).values != wi.sort(-1).values).any(-1)
        for t in diff.nonzero().flatten().tolist():
            row, pos = divmod(t, T // batch)
            if list(got_toks[row][:step]) != list(want_toks[row][:step]):
                continue                      # fed other tokens
            top = wl[t].topk(k + 1).values
            gap = float(top[k - 1] - top[k])
            moved = float((gl[t] - wl[t]).abs().max())
            check(moved <= BF16_LOGIT_ATOL and gap < 2 * moved,
                  f"{tag}: step {step} row {row} position {pos} chose other "
                  f"experts in MoE layer {layer} at a router-logit gap of "
                  f"{gap:.5f} (logits moved by {moved:.5f}; a near tie needs "
                  f"gap < 2 x moved, moved <= {BF16_LOGIT_ATOL})")
            ties += 1
    return ties


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
        # MoE models: each request's routing, per call (RouteLog calls)
        self.n_moe = moe_layers(model.cfg)
        self.routes = {}

    def cache_shapes(self, batch, max_len):
        return self.model.cache_shapes(batch, max_len)

    def cache_batch_axes(self):
        return self.model.cache_batch_axes()

    def _timed(self, fn, log, size, *args):
        import contextlib
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (RouteLog() if self.n_moe and self.batcher is not None
              else contextlib.nullcontext()) as rl:
            out = fn(*args)
        torch.cuda.synchronize()
        log.append((size, (time.perf_counter() - t0) * 1e3))
        self.last_routes = rl.calls if rl is not None else []
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
            T = logits.shape[0] * logits.shape[1]
            n = T // len(rids)
            self.routes.setdefault(rid, []).extend(
                tuple(a[row * n:(row + 1) * n] for a in call)
                for call in self.last_routes)

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


def decode_trace(model, params, prompt, n_new, dev, extra=None):
    """Greedy decoding as ``serve_step.greedy_decode`` does it (``extra``
    its ``extra_batch``: vision embeds shift the cache and the decode index
    by their positions), keeping the prefill's logits at every position and
    each step's last-position logits: (tokens (B, n_new), prefill logits
    (B, S, V), [step logits (B, V)])."""
    import torch
    from repro_torch.serve import serve_step
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int32)
    B, S = prompt.shape
    n_front = 0
    if extra and "vision_embeds" in extra:
        n_front = extra["vision_embeds"].shape[1]
    cache = serve_step.zero_cache(model, B, n_front + S + n_new, dev)
    batch = {"tokens": prompt, **(extra or {})}
    full, cache = model.prefill(params, batch, cache)
    steps = [full[:, -1].to(torch.float32, copy=True)]
    toks = [steps[-1].argmax(-1, keepdim=True).to(torch.int32)]
    for i in range(n_new - 1):
        logits, cache = model.decode_step(params, toks[-1], cache,
                                          n_front + S + i)
        steps.append(logits[:, -1].to(torch.float32, copy=True))
        toks.append(steps[-1].argmax(-1, keepdim=True).to(torch.int32))
    return torch.cat(toks, dim=1), full, steps


def top2_margin(logits) -> float:
    top = logits.float().topk(2, dim=-1).values
    return float((top[..., 0] - top[..., 1]).min())


def same_tokens(tag, got, want, got_steps, want_steps, limit=None):
    """Compare two greedy runs step by step (the first ``limit`` steps:
    route_stops' stop).  Each step's largest logit gap between the runs
    must be within BF16_LOGIT_ATOL; a differing token passes only where
    ``want``'s top-2 margin is under twice that step's gap (printed; the
    rest of the row is then not compared, as the runs' inputs differ from
    there).  Returns (steps compared, largest gap)."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(got[:limit], want[:limit])):
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
    return len(want[:limit]), worst


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


def fwd_row(dtype, D, Dv):
    """The kernels line's row (and errs key) of the forward that takes
    (compute dtype, D, Dv): its route, and for the float32 tensor-core
    route the ``_wide`` row past D = 128 (MLA's Dk of 192).  The CUDA-core
    kernel's bf16 instance (past D = 256) has an errs key and no row."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as attn_kernel
    which = attn_kernel.route(dtype, D, Dv)
    if which == "wgmma":
        return "flash_attention"
    if which == "wgmma_f32":
        return "flash_attention_f32" + ("_wide" if D > 128 else "")
    return ("flash_attention_f32_cuda_cores" if dtype == torch.float32
            else "flash_attention_bf16_cuda_cores")


def bwd_row(route, D, dtype):
    """The kernels line's row (and errs key) of a backward on ``route``
    with q's head dim D in (compute) ``dtype``: the ``_wide`` rows of the
    tensor-core routes past D = 128.  The CUDA-core kernels' bf16 instance
    has an errs key and no row."""
    import torch
    wide = "_wide" if D > 128 else ""
    if route == "cuda_cores":
        return ("flash_attention_bwd_f32_cuda_cores" if dtype == torch.float32
                else "flash_attention_bwd_bf16_cuda_cores")
    return {"wgmma": "flash_attention_bwd" + wide,
            "wgmma_f32": "flash_attention_bwd_f32" + wide}[route]


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
            key = fwd_row(q.dtype, D, Dv)
            errs[key] = max(errs[key], err)
            tol = ATTN_TOL[dt]
            check(got.dtype == q.dtype and got.shape == (B, Hq, Sq, Dv)
                  and torch.allclose(got.float(), want.float(), atol=tol,
                                     rtol=tol),
                  f"flash_attention {shape} {dt} causal={causal}: kernel != "
                  f"plain (max_abs_err {err})")
            print(f"flash_attention {shape} {dt} causal={causal} "
                  f"({attn_kernel.route(q.dtype, D, Dv)}): max_abs_err "
                  f"{err:.3g} (tolerance atol=rtol={tol})", flush=True)
        for label, shape, causal in ATTN_ZOO:
            for dt in ("float32", "bfloat16"):
                B, Hq, Hkv, Sq, Sk, D, Dv = shape
                q, k, v = (torch.randn(sh, generator=gen).to(
                    dev, getattr(torch, dt)) for sh in (
                        (B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, Dv)))
                got = attn_ops.attention(q, k, v, causal=causal)
                want = attn_ops.attention(q, k, v, causal=causal,
                                          backend="torch")
                torch.cuda.synchronize()
                err = max_abs_err(got.float(), want.float())
                key = fwd_row(q.dtype, D, Dv)
                errs[key] = max(errs[key], err)
                tol = ATTN_TOL[dt]
                check(got.dtype == q.dtype and got.shape == (B, Hq, Sq, Dv)
                      and torch.allclose(got.float(), want.float(), atol=tol,
                                         rtol=tol),
                      f"flash_attention {label} {shape} {dt} causal="
                      f"{causal}: kernel != plain (max_abs_err {err})")
                print(f"flash_attention {label} {shape} {dt} causal={causal} "
                      f"({attn_kernel.route(q.dtype, D, Dv)}): max_abs_err "
                      f"{err:.3g} (tolerance atol=rtol={tol})", flush=True)
                del q, k, v, got, want
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
    extra = front_input(rec.get("front"), dev)
    for run in rec["runs"]:
        prompt = np.asarray(run["prompt"], np.int32)[None]
        toks, _, steps = decode_trace(model, params, prompt, rec["n_new"],
                                      dev, extra)
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
                                        device=dev, extra_batch=extra)
        check(solo[0].tolist() == toks,
              f"{tag}: greedy_decode != the traced decode")
        print(f"{tag} prompt {prompt.shape[1]}: tokens {toks} == golden; "
              f"top-16 and 512 fixed logits within {GOLDEN_ATOL} (max_abs_err "
              f"{worst:.3g}); golden margins "
              f"{[round(s['margin'], 5) for s in run['steps']]}", flush=True)


def front_input(spec, dev):
    """The frontend input of a golden record (``make_zoo_golden.py``:
    numpy normals from its seed, on the card) as an ``extra_batch``, or
    None."""
    import numpy as np
    import torch
    if spec is None:
        return None
    x = np.random.default_rng(spec["seed"]).standard_normal(
        (1, spec["n"], spec["width"]), dtype=np.float32)
    return {spec["key"]: torch.from_numpy(x).to(dev)}


def golden_model(rec, dev):
    """(model, parameters) of a golden record: its architecture cut to its
    layers (and the record's other ``cut`` fields) and dtype, with
    ``numpy_reference_params(cfg, param_seed)`` carried to the card."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.interop import (numpy_reference_params,
                                     params_from_reference)
    from repro_torch.models.registry import Model
    cut = rec.get("cut") or {"n_layers": rec["n_layers"]}
    cfg = dc.replace(get_config(rec["arch"]), dtype=rec["dtype"], **cut)
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
    float32 attention launches by route, counted from 0."""
    import torch
    golden = json.loads(SERVE_GOLDEN.read_text())
    with Phase("serve_golden"):
        model, params = golden_model(golden, dev)
        reset_attn_routes()
        golden_runs("serve_golden", golden, model, params, dev)
        n = f32_routes("serve_golden")
        del params
        torch.cuda.empty_cache()
    return n


def ssm_golden_phase(dev):
    """ssm_serve_golden: Mamba2-130M at full size and Zamba2-2.7B at full
    width cut to 6 layers, float32, numpy weights, held to the CPU JAX
    golden ``serve_ssm.json`` as serve_golden holds Yi-6B.  Every float32
    SSD launch (N = 64 and 128) must take the float32 tensor-core walk.
    Returns the float32 attention launches by route and the float32 SSD
    walk's launches, counted from 0."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    golden = json.loads(SSM_GOLDEN.read_text())
    with Phase("ssm_serve_golden"):
        routes = ssd_ops.ROUTE_LAUNCHES
        routes.update(dict.fromkeys(routes, 0))
        reset_attn_routes()
        for rec in golden["models"]:
            model, params = golden_model(rec, dev)
            golden_runs(f"ssm_serve_golden {rec['arch']}", rec, model,
                        params, dev)
            del params
            torch.cuda.empty_cache()
        n = f32_routes("ssm_serve_golden")
        n_ssd = routes["wgmma_f32"]
        check(n_ssd > 0 and routes["cuda_cores"] == 0
              and routes["wgmma"] == 0,
              f"ssm_serve_golden: SSD launches by route {dict(routes)}: "
              f"every one must take the float32 tensor-core walk")
        print(f"ssm_serve_golden: SSD launches by route {dict(routes)}",
              flush=True)
    return n, n_ssd


def zoo_golden_phase(dev):
    """zoo_serve_golden: the MoE, MLA, VLM and enc-dec goldens
    (ZOO_GOLDENS: Qwen3-MoE-30B-A3B at 2 layers, DeepSeek-V3 at one MLA
    layer with the dense MLP, LLaVA-NeXT-34B at 2 layers with 2,880 vision
    embeds, Whisper-small whole with 1,500 frames; full width, float32,
    numpy weights), held to CPU JAX as serve_golden holds Yi-6B.  Returns
    the float32 attention launches by row of the ``kernels`` line, counted
    from 0 for each model, all on the float32 tensor-core route (MLA's Dk
    of 192 on its ``_wide`` row)."""
    import torch
    n = {"flash_attention_f32": 0, "flash_attention_f32_wide": 0}
    with Phase("zoo_serve_golden"):
        for path in ZOO_GOLDENS:
            rec = json.loads(path.read_text())
            model, params = golden_model(rec, dev)
            tag = f"zoo_serve_golden {rec['arch']} {rec['cut']}"
            reset_attn_routes()
            golden_runs(tag, rec, model, params, dev)
            n["flash_attention_f32" + ("_wide" if model.cfg.mla else "")] \
                += f32_routes(tag)
            del params
            torch.cuda.empty_cache()
    return n


def zoo_phases(dev):
    """The rest of the zoo on the card: the float32 goldens, then each
    family's bf16 main path at full width (serve_main_phase).  Returns
    (float32 attention launches of the goldens by row, bf16 attention
    launches of the main paths)."""
    import torch
    from repro_torch.configs import get_config
    n_f32 = zoo_golden_phase(dev)
    qcfg, wcfg = get_config("qwen3-moe-30b-a3b"), get_config("whisper-small")
    lcfg = get_config("llava-next-34b")
    runs = (
        ("zoo_serve_main_path qwen3-moe-30b-a3b", qcfg.name, SERVE_LENS,
         {"flash_attention": QWEN_LAYERS}, {"n_layers": QWEN_LAYERS}, None),
        ("zoo_serve_main_path deepseek-v3-671b", "deepseek-v3-671b",
         DEEPSEEK_LENS, {"flash_attention": DEEPSEEK_LAYERS},
         {"n_layers": DEEPSEEK_LAYERS}, None),
        # Vision embeds at the token embeddings' scale (LLAVA_LAYERS' note).
        ("zoo_serve_main_path llava-next-34b", lcfg.name, ZOO_LENS,
         {"flash_attention": LLAVA_LAYERS}, {"n_layers": LLAVA_LAYERS},
         ("vision_embeds", lcfg.n_frontend_tokens, lcfg.vocab ** -0.5)),
        # Whisper: a prefill's decoder self-attention and cross attention
        # a layer, the encoder's a layer more with frames, the cross
        # attention a layer each decode step.
        ("zoo_serve_main_path whisper-small", wcfg.name, ZOO_LENS,
         {"flash_attention": (2 * wcfg.n_layers, wcfg.n_layers,
                              wcfg.n_encoder_layers)},
         None, ("frames", wcfg.n_frontend_tokens, 1.0)),
    )
    n_bf16 = 0
    for phase, arch, lens, kernels, cut, front in runs:
        # [0]: the profile function holds the weights; drop it at once
        launches = serve_main_phase(dev, phase, arch, lens, GREEDY_BATCH,
                                    kernels, cut, front)[0]
        torch.cuda.empty_cache()
        n_bf16 += launches["flash_attention"]
        if arch == lcfg.name:
            vlm_float32_anchor(dev)
            torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    return n_f32, n_bf16


def vlm_float32_anchor(dev):
    """zoo_vlm_float32_anchor: LLaVA-NeXT-34B at full width cut to
    LLAVA_LAYERS, the main path's bf16 random weights, prefilled with
    2,880 unit-normal vision embeds (rounded to bf16 for all three runs)
    before two 100-token prompts through the kernel path and the plain path,
    then through the plain path with the same weights upcast (exactly) to
    float32.  At the token positions each bf16 path's largest logit gap to
    the float32 run is printed, and the kernel path's may exceed the plain
    path's by at most BF16_LOGIT_ATOL: the kernel adds no more than the
    tolerance every phase holds it to."""
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import Model
    cfg = dc.replace(get_config("llava-next-34b"), n_layers=LLAVA_LAYERS)
    with Phase("zoo_vlm_float32_anchor"):
        params = Model(cfg).init_params(
            torch.Generator(device=dev).manual_seed(0), device=dev)
        rng = np.random.default_rng(4)
        pair = rng.integers(0, cfg.vocab, GREEDY_BATCH).astype(np.int32)
        n_front = cfg.n_frontend_tokens
        ve = torch.from_numpy(rng.standard_normal(
            (GREEDY_BATCH[0], n_front, cfg.frontend_dim), dtype=np.float32))
        extra = {"vision_embeds": ve.to(dev, torch.bfloat16).float()}
        logits = {}
        for name, c, backend in (("kernel", cfg, "auto"),
                                 ("plain", cfg, "torch"),
                                 ("float32", dc.replace(cfg, dtype="float32"),
                                  "torch")):
            if name == "float32":
                for t in params.parameters():
                    t.data = t.data.float()
                torch.cuda.empty_cache()
            _, full, _ = decode_trace(Model(c, backend=backend), params, pair,
                                      1, dev, extra)
            logits[name] = full[:, n_front:].float()
            check(bool(torch.isfinite(logits[name]).all()),
                  f"zoo_vlm_float32_anchor: non-finite {name} logits")
            del full
        del params
        err_k = max_abs_err(logits["kernel"], logits["float32"])
        err_p = max_abs_err(logits["plain"], logits["float32"])
        gap = max_abs_err(logits["kernel"], logits["plain"])
        print(f"zoo_vlm_float32_anchor: {cfg.name} n_layers={cfg.n_layers}, "
              f"{n_front} unit-normal vision embeds, prompts {GREEDY_BATCH}: "
              f"token logits' largest gap to float32: kernel path "
              f"{err_k:.4f}, plain path {err_p:.4f} (kernel vs plain "
              f"{gap:.4f}); logit RMS "
              f"{float(logits['float32'].pow(2).mean().sqrt()):.4f}",
              flush=True)
        check(err_k <= err_p + BF16_LOGIT_ATOL,
              f"zoo_vlm_float32_anchor: the kernel path is {err_k} from "
              f"float32, more than the plain path's {err_p} + "
              f"{BF16_LOGIT_ATOL}")


def attention_zoo_timing():
    """The bf16 tensor-core kernel at each ATTN_ZOO shape (random inputs):
    call ms, device ms, plain ms, the bound and one SDPA call (the library's
    time; GQA's K/V repeated to every head first), one dict a shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import ops as attn_ops
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(1)
    rows = []
    for label, (B, Hq, Hkv, Sq, Sk, D, Dv), causal in ATTN_ZOO:
        q, k, v = (torch.randn(sh, generator=gen).to(dev, torch.bfloat16)
                   for sh in ((B, Hq, Sq, D), (B, Hkv, Sk, D),
                              (B, Hkv, Sk, Dv)))

        def call():
            return attn_ops.attention(q, k, v, causal=causal)

        ms = cuda_ms(call, 20)
        dev_ms = device_ms(call, 20, r"flash_attention_wgmma_kernel")
        plain_ms = cuda_ms(lambda: attn_ops.attention(
            q, k, v, causal=causal, backend="torch"), 3)
        # SDPA aligns a causal mask top-left: the same function when
        # Sq == Sk, and with no mask when not causal or when one query,
        # aligned bottom-right, sees every key.
        library_ms = None
        lib_causal = causal and Sq > 1
        if not causal or Sq == Sk or Sq == 1:
            kc = k.repeat_interleave(Hq // Hkv, dim=1).contiguous()
            vc = v.repeat_interleave(Hq // Hkv, dim=1).contiguous()
            lib = F.scaled_dot_product_attention(q, kc, vc,
                                                 is_causal=lib_causal)
            check(torch.allclose(lib.float(), call().float(), atol=2e-2,
                                 rtol=2e-2),
                  f"scaled_dot_product_attention disagrees with the kernel "
                  f"at {label}")
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, kc, vc, is_causal=lib_causal), 20)
            del kc, vc, lib
        nbytes = 2 * B * (Hq * Sq * (D + Dv) + Hkv * Sk * (D + Dv))
        pairs = (sum(min(Sk, Sk - Sq + i + 1) for i in range(Sq)) if causal
                 else Sq * Sk)
        flops = 2 * B * Hq * pairs * (D + Dv)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
        rows.append(dict(label=label, shape=[B, Hq, Hkv, Sq, Sk, D, Dv],
                         causal=causal, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms,
                         bound_ms=max(t_bytes, t_ops) * 1e3,
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations", library_ms=library_ms))
        print(f"attention at {label}: {json.dumps(rows[-1])}", flush=True)
        del q, k, v
    return rows


def serve_main_phase(dev, phase, arch, lens, greedy_batch, kernels,
                     cut=None, front=None):
    """A serving main path: ``arch`` at full width, at full depth unless
    ``cut`` ({config field: value}) cuts it, in its dtype, random weights
    from a torch.Generator on the card.  A ContinuousBatcher (SERVE_SLOTS
    slots of SERVE_MAX_LEN positions) answers one request a prompt length
    of ``lens`` (SERVE_NEW new tokens each; tokens only, as the reference's
    batcher prefills) and greedy_decode a batch of ``greedy_batch`` prompts
    (with ``front`` = (batch key, positions, scale) of frontend input,
    numpy normals times the scale, as its ``extra_batch``), with the launch
    counts of ``kernels``
    set to 0 just before and read just after.  ``kernels`` gives each
    kernel's launches a prefill, or (a prefill, a decode step, more in a
    prefill with the frontend input).  Then each request, and the greedy
    batch, is decoded alone through the kernel path and through the plain
    path (``backend="torch"``).  Returns (launches, {name: recorder of the
    wrapper's calls}, a function that profiles a decode step and the
    longest prefill; it holds the weights)."""
    import contextlib
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import Model
    from repro_torch.serve import batching, serve_step
    cfg = dc.replace(get_config(arch), **(cut or {}))
    per = {name: (n, 0, 0) if isinstance(n, int) else n
           for name, n in kernels.items()}
    wrappers = {name: KERNEL_WRAPPERS[name]() for name in kernels}
    with Phase(phase):
        model = Model(cfg)
        t0 = time.perf_counter()
        base = torch.cuda.memory_allocated(dev)
        params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                                   device=dev)
        torch.cuda.synchronize()
        print(f"{phase}: {cfg.name} {cfg.dtype}, n_layers={cfg.n_layers}"
              f"{f' (cut: {cut})' if cut else ''}, "
              f"{sum(p.numel() for p in params.parameters()):,} parameters "
              f"drawn on the card in {time.perf_counter() - t0:.1f} s",
              flush=True)
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
                   for n in lens]
        pair = rng.integers(0, cfg.vocab, greedy_batch).astype(np.int32)
        extra = None
        if front is not None:
            key, n_front, scale = front
            extra = {key: torch.from_numpy(rng.standard_normal(
                (greedy_batch[0], n_front, cfg.frontend_dim or cfg.d_model),
                dtype=np.float32) * np.float32(scale)).to(dev)}
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
                                              device=dev, extra_batch=extra)
            torch.cuda.synchronize()
            greedy_ms = (time.perf_counter() - t1) * 1e3
            launches = {name: wrappers[name][0].LAUNCHES for name in kernels}
            for name, r in routes.items():
                check(r["wgmma"] == launches[name],
                      f"{phase}: {name} launches {launches} did not all "
                      f"take the tensor-core kernel ({r})")
        peak = torch.cuda.max_memory_allocated(dev)
        n_prefill = len(prompts) + 1
        for name, (n_pre, n_dec, n_front) in per.items():
            want = (n_pre * n_prefill + n_dec * len(timed.decodes)
                    + n_front * (extra is not None))
            check(launches[name] == want,
                  f"{phase}: {name} launched {launches[name]} times, "
                  f"expected {want} ({n_pre} a prefill x {n_prefill}, "
                  f"{n_dec} a decode step x {len(timed.decodes)}, "
                  f"{n_front} more with the frontend input)")
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
              f"greedy_decode batch {greedy_batch}"
              f"{f' with {front[1]} {front[0]}' if front else ''}: "
              f"{greedy_ms:.1f} ms "
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

        n_moe = moe_layers(cfg)

        def kernel_vs_plain(tag, prompt, extra, replay=None):
            """The kernel path's and the plain path's greedy decode of
            ``prompt``, the plain path on the kernel path's experts (and the
            kernel path on ``replay``'s, RouteLog): prefill logits at the
            token positions within BF16_LOGIT_ATOL, steps by
            ``same_tokens``.  Returns the kernel path's (tokens, steps,
            RouteLog calls) and the comparison's numbers."""
            with RouteLog(replay) as rk:
                toks, full, steps = decode_trace(model, params, prompt,
                                                 SERVE_NEW, dev, extra)
            with RouteLog(rk.calls) as rp:
                ptoks, pfull, psteps = decode_trace(
                    plain_model, params, prompt, SERVE_NEW, dev, extra)
            ties = (replayed_ties(f"{phase} {tag} plain vs kernel", rk.calls,
                                  rp.calls, n_moe, toks.tolist(),
                                  ptoks.tolist()) if n_moe else 0)
            check(bool(torch.isfinite(full).all()),
                  f"{phase} {tag}: non-finite prefill logits")
            # The frontend positions' logits (vision embeds) are no model
            # output: the reference's loss and decode read the tokens' only.
            n_front = full.shape[1] - prompt.shape[1]
            err = max_abs_err(full[:, n_front:], pfull[:, n_front:])
            front = (f"; at the {n_front} frontend positions (not held) "
                     f"{max_abs_err(full[:, :n_front], pfull[:, :n_front]):.4f}"
                     if n_front else "")
            worst["prefill"] = max(worst["prefill"], err)
            check(err <= BF16_LOGIT_ATOL,
                  f"{phase} {tag}: prefill logits of the kernel path differ "
                  f"from the plain path by {err} > {BF16_LOGIT_ATOL}{front}")
            del full, pfull
            for b in range(toks.shape[0]):
                n_p, gap_p = same_tokens(
                    f"{phase} {tag} row {b} kernel vs plain",
                    toks[b].tolist(), ptoks[b].tolist(),
                    [st[b] for st in steps], [st[b] for st in psteps])
                worst["plain"] = max(worst["plain"], gap_p)
            if ties or front:
                print(f"{phase} {tag}: {ties} expert choices at near ties "
                      f"replayed{front}", flush=True)
            return toks, steps, rk.calls, err, n_p, gap_p

        for rid, p in enumerate(prompts):
            tag = f"request {rid} ({len(p)} tokens)"
            toks, steps, routes, err, n_p, gap_p = kernel_vs_plain(
                tag, p[None], None, timed.routes.get(rid))
            toks, steps = toks[0].tolist(), [st[0] for st in steps]
            if n_moe:
                ties = replayed_ties(f"{phase} {tag} solo vs batcher",
                                     timed.routes[rid], routes, n_moe,
                                     [done[rid].out], [toks])
                if ties:
                    print(f"{phase} {tag} solo vs batcher: {ties} expert "
                          f"choices at near ties replayed", flush=True)
            n_b, gap_b = same_tokens(f"{phase} request {rid} batcher vs solo",
                                     done[rid].out, toks, timed.steps[rid],
                                     steps)
            worst["batcher"] = max(worst["batcher"], gap_b)
            print(f"{phase} {tag}: prefill logits kernel vs plain "
                  f"max_abs_err {err:.4f}; batcher == solo on {n_b} tokens "
                  f"(step logits max gap {gap_b:.4f}), kernel == plain on "
                  f"{n_p} (max gap {gap_p:.4f}); tolerance "
                  f"{BF16_LOGIT_ATOL}; reference top-2 margins "
                  f"{min(top2_margin(st) for st in steps):.4f} at least",
                  flush=True)
        gt, gsteps, _, err, _, _ = kernel_vs_plain("greedy_decode", pair,
                                                   extra)
        for b in range(greedy_batch[0]):
            same_tokens(f"{phase} greedy_decode row {b}", greedy[b].tolist(),
                        gt[b].tolist(), [st[b] for st in timed.free],
                        [st[b] for st in gsteps])
        print(f"{phase}: largest logit gaps (tolerance {BF16_LOGIT_ATOL}): "
              f"prefill kernel vs plain {worst['prefill']:.4f}, batcher vs "
              f"solo steps {worst['batcher']:.4f}, kernel vs plain steps "
              f"{worst['plain']:.4f}; greedy_decode == its traced decode, "
              f"kernel vs plain prefill {err:.4f}", flush=True)

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


# The widest heads of the main paths (B, Hq, Hkv, Sq, Sk, Dk, Dv): MLA's
# prefill, which its float32 golden, its train steps at Dk 192 and their
# gradients give the tensor-core kernels' wide instances (the ``_wide``
# rows).
MLA_F32_SHAPE = (1, 128, 128, 511, 511, 192, 128)
# The CUDA-core kernels' rows: D = Dv = 256 at MLA's prefill length, past
# the float32 routes' and the backward's tensor-core limits (192 / 128);
# no main path reaches them.
CUDA_CORE_SHAPE = (1, 16, 16, 511, 511, 256, 256)


def attention_timing(rec, errs, launches, f32_launches):
    """The flash-attention rows of the ``kernels`` line: at the largest
    input the serving main paths gave the kernel, the bf16 tensor-core
    kernel on it and the float32 tensor-core kernel at the same shape on
    random float32 inputs (bf16 values would leave the lower two of the
    three bf16 parts it splits each operand into zero); the float32
    tensor-core kernel at MLA_F32_SHAPE (``_wide``) and the float32
    CUDA-core kernel at CUDA_CORE_SHAPE (random inputs); each beside its
    plain version and one SDPA call.  ``f32_launches``: the float32
    tensor-core launches of the serving goldens (head dims up to 128; the
    other rows' launches are added after the zoo and training phases)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import ops as attn_ops
    (q0, k0, v0), kw = rec.largest
    kw = {key: val for key, val in kw.items() if key != "backend"}
    gen = torch.Generator().manual_seed(3)
    def draw(B, Hq, Hkv, Sq, Sk, D, Dv):
        return [torch.randn(sh, generator=gen).to(q0.device) for sh in (
            (B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, Dv))]
    mla = draw(*MLA_F32_SHAPE)
    f32 = [torch.randn(t.shape, generator=gen).to(t.device)
           for t in (q0, k0, v0)]
    cc = draw(*CUDA_CORE_SHAPE)
    rows = []
    for name, kernel_re, dtype, n, qkv in (
            ("flash_attention", r"flash_attention_wgmma_kernel",
             torch.bfloat16, launches, (q0, k0, v0)),
            ("flash_attention_f32", r"flash_attention_f32_kernel",
             torch.float32, f32_launches, f32),
            ("flash_attention_f32_wide", r"flash_attention_f32_kernel",
             torch.float32, 0, mla),
            ("flash_attention_f32_cuda_cores",
             r"\bflash_attention_kernel<float>", torch.float32, 0, cc)):
        q, k, v = (t.to(dtype) for t in qkv)
        B, Hq, Sq, D = q.shape
        Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[-1]
        check(fwd_row(dtype, D, Dv) == name,
              f"{name}: {tuple(q.shape)} takes the {fwd_row(dtype, D, Dv)} "
              f"row's kernel")
        got = attn_ops.attention(q, k, v, **kw)
        want = attn_ops.attention(q, k, v, backend="torch", **kw)
        tol = ATTN_TOL[str(dtype).split(".")[-1]]
        err = max(errs[name], max_abs_err(got.float(), want.float()))
        check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
              f"{name}: kernel != plain on the main path's largest input")
        ms = cuda_ms(lambda: attn_ops.attention(q, k, v, **kw), 20)
        dev_ms = device_ms(lambda: attn_ops.attention(q, k, v, **kw), 20,
                           kernel_re)
        plain_ms = cuda_ms(lambda: attn_ops.attention(
            q, k, v, backend="torch", **kw), 5)
        # One PyTorch call of the same function: SDPA aligns its causal
        # mask top-left, the same as bottom-right when Sq == Sk, and with
        # no mask when one query sees every key.  In float32 it is held at
        # 1e-3: a yardstick, not an oracle.
        library_ms = None
        if Sq == Sk or Sq == 1:
            qc = q.contiguous()
            kc = k.repeat_interleave(Hq // Hkv, dim=1).contiguous()
            vc = v.repeat_interleave(Hq // Hkv, dim=1).contiguous()
            lib = F.scaled_dot_product_attention(qc, kc, vc,
                                                 is_causal=Sq > 1)
            ltol = max(tol, 1e-3)
            check(torch.allclose(lib.float(), want.float(), atol=ltol,
                                 rtol=ltol),
                  "scaled_dot_product_attention disagrees with the plain "
                  "version")
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qc, kc, vc, is_causal=Sq > 1), 20)
            del qc, kc, vc, lib
        # float32: the kernel's and the plain version's distance from the
        # same function in float64
        f64 = {}
        if dtype == torch.float32:
            exact = mha64(q, k, v, **kw)
            f64 = dict(f64_err=max_abs_err(got, exact),
                       plain_f64_err=max_abs_err(want, exact))
            del exact
        esize = q.element_size()
        nbytes = esize * B * (Hq * Sq * (D + Dv) + Hkv * Sk * (D + Dv))
        # Visible (query, key) pairs of the causal mask, a multiply-add of
        # D (S) and of Dv (P V) each; float32 at the tensor cores'
        # float32-accurate rate (FP32_SPLIT_FLOP_PER_S).
        pairs = sum(min(Sk, Sk - Sq + i + 1) for i in range(Sq))
        flops = 2 * B * Hq * pairs * (D + Dv)
        peak = (BF16_FLOP_PER_S if dtype == torch.bfloat16
                else FP32_SPLIT_FLOP_PER_S)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/" + (
                "flash_attn.cu" if name in ("flash_attention",
                                            "flash_attention_f32_cuda_cores")
                else "flash_attn_f32.cu"),
            replaces="src/repro/kernels/flash_attn/kernel.py:72",
            launches=n, max_abs_err=err, ms=ms, device_ms=dev_ms,
            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=library_ms, n=int(B * Hq * Sq),
            shape=[B, Hq, Hkv, Sq, Sk, D] + ([Dv] if Dv != D else []),
            **f64))
        del q, k, v, got, want
    del mla, cc, f32
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


def ssd_expected_route(dtype: str, N: int) -> str:
    """The route an SSD case must take: the bf16 walk up to N = 256, the
    float32 walk up to N = 128, else the CUDA cores."""
    if dtype == "bfloat16":
        return "wgmma" if N <= 256 else "cuda_cores"
    return "wgmma_f32" if N <= 128 else "cuda_cores"


def ssd_expected_bwd_route(dtype: str, N: int, P: int) -> str:
    """The route an SSD backward case must take: the tensor cores for bf16
    up to N = 128 and P = 256, else the CUDA cores (float32, float16 and
    mixed dtypes too)."""
    return ("wgmma" if dtype == "bfloat16" and N <= 128 and P <= 256
            else "cuda_cores")


def ssd_phase(dev, errs):
    """ssd_vs_plain: the SSD kernels against the plain ``ssd_chunked`` on
    the card at SSD_HEADS x SSD_LENS x batch 1-2, float32 and bf16, with a
    large-decay case at each head shape, and against the sequential oracle
    ``ssd_scan`` at L <= 100 in float32; each case's route checked, every
    float32 walk's rerun bitwise equal."""
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
        cases += [(1, L, *SSD_WIDE_BF16, "bfloat16", decay, 64)
                  for L in (37, 500) for decay in (1.0, SSD_DECAY)]
        cases += [(1, 301, H, P, G, N, dt, decay, chunk)
                  for H, P, G, N in (SSD_HEADS[0], SSD_HEADS[2])
                  for chunk in SSD_SHORT_CHUNKS
                  for dt in ("float32", "bfloat16")
                  for decay in (1.0, SSD_DECAY)]
        n_seq = 0
        n_route = dict.fromkeys(ssd_ops.ROUTE_LAUNCHES, 0)
        for B, L, H, P, G, N, dt, decay, chunk in cases:
            args = ssd_inputs(B, L, H, P, G, N, getattr(torch, dt), gen, dev,
                              decay)
            routes = dict(ssd_ops.ROUTE_LAUNCHES)
            got, got_h = ssd_ops.ssd(*args, chunk=chunk, final_state=True)
            want, want_h = ssd_ops.ssd(*args, chunk=chunk, backend="torch",
                                       final_state=True)
            torch.cuda.synchronize()
            which = ssd_kernel.route(args[0].dtype, N)
            check(which == ssd_expected_route(dt, N)
                  and ssd_ops.ROUTE_LAUNCHES[which] == routes[which] + 1,
                  f"ssd_scan {dt} N={N}: took the wrong route")
            n_route[which] += 1
            err = max_abs_err(got.float(), want.float())
            herr = max_abs_err(got_h, want_h)
            key = {"wgmma": "ssd_scan", "wgmma_f32": "ssd_scan_f32"}.get(
                which, f"ssd_scan_{'f32' if dt == 'float32' else 'bf16'}"
                       f"_cuda_cores")
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
            if which == "wgmma_f32":
                again, again_h = ssd_ops.ssd(*args, chunk=chunk,
                                             final_state=True)
                check(torch.equal(again, got) and torch.equal(again_h, got_h),
                      f"{tag}: a rerun differs")
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
        check(all(n_route.values()), f"ssd_vs_plain: a route never ran: "
              f"{n_route}")
        print(f"ssd_vs_plain: {len(cases)} cases (y and the final state), "
              f"{n_seq} also against the sequential scan, by route "
              f"{n_route}; largest max_abs_err bf16 walk "
              f"{errs['ssd_scan']:.3g}, float32 walk "
              f"{errs['ssd_scan_f32']:.3g}, CUDA cores float32 "
              f"{errs['ssd_scan_f32_cuda_cores']:.3g} and bf16 "
              f"{errs['ssd_scan_bf16_cuda_cores']:.3g}", flush=True)
        for shape in SSD_HALF_SHAPES:
            for dts in HALF_MIXED:
                x, dt, A, Bm, C = ssd_inputs(*shape, torch.float32, gen, dev)
                x, Bm, C = (t.to(getattr(torch, d))
                            for t, d in zip((x, Bm, C), dts))
                before = ssd_ops.ROUTE_LAUNCHES["wgmma_f32"]
                got = ssd_ops.ssd(x, dt, A, Bm, C)
                want = ssd_ops.ssd(x, dt, A, Bm, C, backend="torch")
                torch.cuda.synchronize()
                err = max_abs_err(got.float(), want.float())
                check(ssd_ops.ROUTE_LAUNCHES["wgmma_f32"] == before + 1
                      and got.dtype == x.dtype
                      and bool(torch.isfinite(got).all())
                      and torch.allclose(got.float(), want.float(),
                                         atol=HALF_TOL, rtol=HALF_TOL),
                      f"ssd_scan {shape} {dts}: kernel != plain "
                      f"(max_abs_err {err})")
                print(f"ssd_scan {shape} {dts} (wgmma_f32, read in "
                      f"float32): max_abs_err {err:.3g} (tolerance "
                      f"atol=rtol={HALF_TOL})", flush=True)


def ssd64(x, dt, A, Bm, C):
    """(y, h_L): the SSD scan's plain chunked form (``ops.ssd``'s plain
    route, chunks of 64, and ``ref.ssd_final_state``) in float64 on the
    card, the plain versions keeping float64 inputs in float64.  The
    yardstick of the float32 rows' ``f64_err``."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return ssd_ops.ssd(*(t.double() for t in (x, dt, A, Bm, C)),
                       backend="torch", final_state=True)


def ssd_timing(rec, errs, launches, f32_launches):
    """The ssd_scan rows of the ``kernels`` line, at the largest input the
    serving main paths gave the kernel (a prefill: y and the final state):
    the bf16 tensor-core walk on it, the float32 tensor-core walk at the
    same shape on random float32 x, B and C (the recorded dt and A; bf16
    values would leave the lower two of the three bf16 parts it splits each
    operand into zero), each walk's device time with 32 and with 64 P
    columns a CTA, and the float32 CUDA-core route at SSD_CUDA_CORE_SHAPE
    (random inputs; no main path reaches it); each beside its plain
    version, the float32 rows beside their and the plain version's largest
    distance from float64 (``f64_err``, ``plain_f64_err``: ``ssd64``)."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    (x, dt, A, Bm, C), kw = rec.largest
    kw = {key: val for key, val in kw.items() if key != "backend"}
    chunk = kw.get("chunk", 64)
    gen = torch.Generator().manual_seed(5)
    f32 = [torch.randn(t.shape, generator=gen).to(t.device)
           for t in (x, Bm, C)]
    cc = ssd_inputs(*SSD_CUDA_CORE_SHAPE, torch.float32, gen, x.device)
    rows = []
    # (name, kernels' names, route, launches, inputs); a call launches one
    # kernel of a walk, three of the CUDA-core route, and a profiler trace
    # short of them is taken again (device_ms's per_call).
    for name, kernel_re, route, n, args in (
            ("ssd_scan", r"\bssd_wgmma_kernel<", "wgmma", launches,
             (x.bfloat16(), dt, A, Bm.bfloat16(), C.bfloat16())),
            ("ssd_scan_f32", r"\bssd_wgmma_f32_kernel<", "wgmma_f32",
             f32_launches, (f32[0], dt, A, f32[1], f32[2])),
            ("ssd_scan_f32_cuda_cores",
             r"\bssd_(chunk_state|state_carry|chunk_out)", "cuda_cores", 0,
             tuple(cc))):
        per_call = 3 if route == "cuda_cores" else 1
        x_, dt_, A_, Bm_, C_ = args
        Bsz, L, H, P = x_.shape
        G, N = Bm_.shape[2], Bm_.shape[3]
        dtype = x_.dtype
        check(ssd_kernel.route(dtype, N) == route,
              f"{name}: {tuple(x_.shape)} N={N} takes the "
              f"{ssd_kernel.route(dtype, N)} route")
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
        f64 = {}
        if dtype == torch.float32:
            exact = ssd64(*args)
            f64 = dict(f64_err=max(max_abs_err(g.double(), e)
                                   for g, e in zip(got, exact)),
                       plain_f64_err=max(max_abs_err(w.double(), e)
                                         for w, e in zip(want, exact)))
            del exact
        ms = cuda_ms(lambda: ssd_ops.ssd(*args, **kw), 20)
        dev_ms = device_ms(lambda: ssd_ops.ssd(*args, **kw), 20, kernel_re,
                           per_call)
        plain_ms = cuda_ms(lambda: ssd_ops.ssd(*args, backend="torch",
                                               **kw), 5)
        esize = x_.element_size()
        nbytes = (2 * Bsz * L * H * P * esize + 2 * Bsz * L * G * N * esize
                  + Bsz * L * H * dt_.element_size() + H * 4)
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
        # float32 at the tensor cores' float32-accurate rate (the bound of
        # a float32 scan made of matrix products: FP32_SPLIT_FLOP_PER_S)
        peak = (BF16_FLOP_PER_S if dtype == torch.bfloat16
                else FP32_SPLIT_FLOP_PER_S)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
        row = dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/" + (
                "ssd_scan_f32.cu" if route == "wgmma_f32" else "ssd_scan.cu"),
            replaces="src/repro/kernels/ssd_scan/kernel.py:66",
            launches=n, max_abs_err=err, ms=ms, device_ms=dev_ms,
            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, n=int(Bsz * L * H),
            shape=[Bsz, L, H, P, G, N], **f64)
        if route != "cuda_cores":
            # A walk with 32 and with 64 P columns a CTA (64: N <= 128 in
            # bf16, N <= 64 in float32).
            widest = 128 if route == "wgmma" else 64
            row["device_ms_by_ptile"] = {
                pt: device_ms(lambda: ssd_kernel.ssd_scan(
                    *args, chunk=chunk, final_state=True, ptile=pt), 20,
                    kernel_re, per_call)
                for pt in (32, 64) if pt == 32 or N <= widest}
        rows.append(row)
        del got, want
    del f32, cc
    return rows


# ---------------------------------------------------------------------------
# Training: the flash-attention backward kernel and the train step
# ---------------------------------------------------------------------------

TRAIN_GOLDEN = ROOT / "tests" / "torch_golden" / "train_yi6b_l2.json"
# Mamba2-130M at full width, 2 of its 24 layers, float32: the SSD scan's
# forward (the float32 tensor-core walk) and backward kernels in a train
# step held to CPU JAX, at the same tolerances as Yi-6B's.
TRAIN_SSM_GOLDEN = ROOT / "tests" / "torch_golden" / "train_mamba2_l2.json"
TRAIN_OUT = ROOT / "build" / "chip_smoke_train"
# attention_grad_vs_plain, (B, Hq, Hkv, Sq, Sk, Dk, Dv, causal): Yi-6B's
# heads for S = 1-4,096 (the main path's positions), D = 64, 80 (Zamba2's
# shared block), 96 (Phi-3-mini), MLA's 192/128 at DeepSeek-V3's 128 heads,
# causal with more queries than keys (rows that see no key), ragged keys,
# an odd depth, D = 256, Whisper's encoder and cross attention (not
# causal) and Dv != D without the mask, MLA's heads with rows that see no
# key, D = 160 with Dv = 64, and D = 288 (past the tensor-core routes, as
# D = 256 is); then float16 and mixed dtypes (HALF_MIXED) at two shapes.
# Both types with D <= 192 and Dv <= 128 take the backward's tensor-core
# routes, the rest its CUDA-core route (kernel.route_bwd).
ATTN_GRAD_SHAPES = (
    [(1, 32, 4, S, S, 128, 128, True) for S in (1, 13, 100, 1025, 4096)]
    + [(2, 8, 2, 300, 300, 64, 64, True),
       (1, 32, 32, 1025, 1025, 80, 80, True),
       (1, 32, 32, 513, 513, 96, 96, True),
       (1, 128, 128, 511, 511, 192, 128, True),
       (1, 2, 1, 160, 128, 16, 16, True),
       (1, 32, 4, 300, 100, 128, 128, True),
       (2, 6, 3, 65, 200, 96, 96, True),
       (1, 8, 2, 100, 130, 36, 36, True),
       (1, 4, 1, 77, 200, 256, 256, True),
       (1, 12, 12, 1500, 1500, 64, 64, False),
       (2, 12, 12, 1, 1500, 64, 64, False),
       (1, 12, 12, 37, 1500, 64, 64, False),
       (1, 8, 2, 200, 300, 96, 64, False),
       (1, 2, 1, 160, 128, 192, 128, True),
       (1, 4, 2, 77, 200, 160, 64, False),
       (1, 4, 1, 64, 64, 288, 128, True)])
ATTN_GRAD_HALF = ((1, 4, 2, 128, 128, 16, 16, True),
                  (1, 32, 4, 100, 300, 128, 128, True))
# Each gradient within atol = TOL x its largest magnitude and rtol = TOL of
# the plain version's (ref.mha_vjp).  bf16: the forward's 2e-2 (both round
# float32 sums to 8 bits of mantissa).  float32: 1e-4, five times the
# forward's 2e-5: the backward sums five products over up to 4,096 keys or
# queries and a group's heads in another order, and dS = P (dP - D)
# subtracts D = rowsum(dout * out), taken from the forward kernel's output
# (itself within 2e-5 of the plain version's).
ATTN_GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# train_golden: the port's two train steps of Yi-6B (2 layers, float32) on
# the card against CPU JAX (tests/torch_golden/make_train_golden.py).  The
# loss within 1e-4 and the gradient norm within 1e-4 relative (float32
# sums in another order; the serving golden's logits came within 1.5e-5);
# the sampled optimizer state within 1e-3 relative to the leaf's largest
# sampled magnitude (a moment is a gradient, or its square, whose sums over
# 256 tokens and widths up to 11,008 run in another order); parameters
# within 1e-6 relative plus 1e-7 absolute (an ulp of float32 at 1.0; a
# step moves a parameter by up to its step size, 3e-6 and 6e-6 here, so a
# missing or reversed update fails; the card came within 2e-9).  AdamW's
# update is lr * m / (sqrt(v) + eps), +-lr wherever g ~ 0 and the two
# gradients may differ in sign: where the golden's first moment after a
# step is near zero (below GOLDEN_MU_NEAR0 of its leaf's largest sampled
# magnitude, and not exactly zero as in an embedding row no token reached),
# that element may also differ by twice that step's size, for that step and
# every later one.
GOLDEN_LOSS_ATOL = 1e-4
GOLDEN_GNORM_RTOL = 1e-4
GOLDEN_STATE_RTOL = 1e-3
GOLDEN_PARAM_ATOL, GOLDEN_PARAM_RTOL = 1e-7, 1e-6
GOLDEN_MU_NEAR0 = 1e-3
# train_main_path: Yi-6B at full width cut to TRAIN_LAYERS of its 32 layers
# (the AdamW state of more does not fit the card beside the activations),
# bf16, train_4k's 4,096 positions with its global batch cut from 256 to
# TRAIN_BATCH, the config's 4 microbatches, AdamW and remat (policy
# "nothing"), TRAIN_STEPS steps through ResilientLoop with a checkpoint
# every 2 steps.  The batch is cut to 4, one sequence a microbatch (8 ran
# at 3.8 s a step), and the depth to 4 layers (8 until the SSM training
# paths came: PERF.md §4 has the seconds it saves), to keep the script
# within its time.
TRAIN_LAYERS = 4
TRAIN_SEQ = 4096
TRAIN_BATCH = 4
TRAIN_STEPS = 3
# Step 1's loss and gradient norm on the kernel path against the plain
# path (backend="torch") from the same bf16 weights: both round every
# activation to bf16 from float32 sums taken in another order (the
# attention kernels' tiles, the plain version's einsums), through 8 layers
# and 4 microbatches of 2 x 4,096 tokens.  The card gave a loss gap of
# 2.4e-5 (of ~11.6) and a relative gradient-norm gap of 3.6e-7: the loss
# is held within 1e-3 and the gradient norm within 1e-3 relative, on the
# SSM paths too (the SSD scan's kernels against the plain einsums).
TRAIN_LOSS_ATOL = 1e-3
TRAIN_GNORM_RTOL = 1e-3
# train_ssm_main_path, (arch, layers or None for all, seq, global batch):
# Mamba2-130M whole, 4 sequences of 2,048 tokens (the paper's training
# context) in its config's 2 microbatches; Zamba2-2.7B at full width cut to
# 12 of its 54 Mamba layers (two applications of the shared block: its
# 2.7 B parameters with float32 gradients and AdamW's two float32 moments
# come to ~38 GB before activations, PERF.md §4), 4 sequences of 4,096
# tokens in its config's 4 microbatches; bf16, AdamW, remat, through
# train_path.  Step 1 within TRAIN_LOSS_ATOL and TRAIN_GNORM_RTOL of the
# plain path, as Yi-6B's.
TRAIN_SSM = (("mamba2-130m", None, 2048, 4), ("zamba2-2.7b", 12, 4096, 4))
# ssd_grad_vs_plain: the backward kernel against ref.ssd_vjp at SSD_HEADS
# for these lengths (1, ragged, one chunk, 32 chunks).  bf16: each gradient
# within SSD_GRAD_TOL of its largest magnitude (the forward's 2e-2: both
# round float32 sums to 8 bits).  float32: each gradient no further from
# the float64 plain gradient (ref.ssd_vjp on float64 inputs) than twice the
# float32 plain version's distance, plus SSD_GRAD_F32_FLOOR of its largest
# magnitude (4 units in the last place of float32's 24 bits: the floor of
# any float32 result, where the plain version happens to round exactly).
SSD_GRAD_LENS = (1, 37, 64, 2048)
SSD_GRAD_TOL = 2e-2
SSD_GRAD_F32_FLOOR = 2.4e-7
SSD_GRAD_NAMES = ("dx", "ddt", "dA", "dB", "dC")
# bf16 heads (H, P, G, N) on the tensor-core backward at P other than 64: a
# P box masked below 64 columns, P boxes of 64 (2 to 4 a head) with a ragged
# last one, and N = 128 with P = 256, its largest shared memory.
SSD_BWD_P_HEADS = ((4, 32, 2, 64), (4, 100, 1, 128), (6, 128, 2, 64),
                   (2, 256, 1, 128))
# The backward's timing rows: bf16 at Zamba2-2.7B's train shape (a
# microbatch of one 4,096-token sequence), float32 at the SSM golden's
# (Mamba2-130M, a microbatch of 2 x 128 tokens); (B, L, H, P, G, N).
SSD_BWD_SHAPE = (1, 4096, 80, 64, 1, 64)
SSD_BWD_F32_SHAPE = (2, 128, 24, 64, 1, 128)
# The backward's four launches on either route in a profiler trace (launches
# 2 and 4, csrc/ssd_bwd_carry.cuh, are the two routes' shared kernels).
SSD_BWD_KERNELS = r"\bssd_bwdw?_\w+"
# train_zoo_smoke: one train step of each family that trains on the card,
# at its smoke config (float32), kernel path against plain path: the loss
# within 1e-5 and the gradient norm within 1e-4, relative.
TRAIN_ZOO = ("yi-6b", "qwen3-moe-30b-a3b", "deepseek-v3-671b",
             "llava-next-34b", "whisper-small", "mamba2-130m", "zamba2-2.7b")
ZOO_LOSS_RTOL, ZOO_GNORM_RTOL = 1e-5, 1e-4
# DeepSeek-V3's own attention heads (configs/deepseek_v3_671b.py: rope 64 +
# nope 128 = Dk 192, Dv 128) on its smoke config, whose heads are cut to
# 16 + 32 / 32: the MLA train steps of train_zoo_smoke at the widths that
# take the wide tensor-core instances.
ZOO_WIDE_HEADS = dict(rope_head_dim=64, nope_head_dim=128, v_head_dim=128)


class KernelClock:
    """While active, times each call of the kernel bindings named in
    ``KernelClock.BINDINGS`` (the attention's and the SSD scan's forward and
    backward, ``kernel.<name>``) with CUDA events on the current stream;
    ``take()`` returns the device ms and the calls of each since the last
    ``take()``."""

    BINDINGS = (("flash_attn", "flash_attention"),
                ("flash_attn", "flash_attention_bwd"),
                ("ssd_scan", "ssd_scan"), ("ssd_scan", "ssd_scan_bwd"))

    def __enter__(self):
        import importlib
        import torch
        self.mods = {n: importlib.import_module(
            f"repro_torch.kernels.{pkg}.kernel") for pkg, n in self.BINDINGS}
        self.orig = {n: getattr(self.mods[n], n) for n in self.mods}
        self.events = {n: [] for n in self.mods}

        def timed(name, fn):
            def call(*args, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kw)
                end.record()
                self.events[name].append((start, end))
                return out
            return call
        for n, fn in self.orig.items():
            setattr(self.mods[n], n, timed(n, fn))
        return self

    def take(self):
        import torch
        torch.cuda.synchronize()
        out = {n: sum(s.elapsed_time(e) for s, e in ev)
               for n, ev in self.events.items()}
        counts = {n: len(ev) for n, ev in self.events.items()}
        self.events = {n: [] for n in self.events}
        return out, counts

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.mods[n], n, fn)
        return False


def attention_grads(q, k, v, dout, causal, route):
    """(dq, dk, dv) of ``ops.attention`` through autograd; on CUDA tensors
    the backward kernel must have run once, on ``route``."""
    import torch
    from repro_torch.kernels.flash_attn import ops as attn_ops
    qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
    before = attn_ops.BWD_LAUNCHES, attn_ops.BWD_ROUTE_LAUNCHES[route]
    out = attn_ops.attention(qq, kk, vv, causal=causal)
    grads = torch.autograd.grad(out, (qq, kk, vv), dout)
    torch.cuda.synchronize()
    check(attn_ops.BWD_LAUNCHES == before[0] + 1
          and attn_ops.BWD_ROUTE_LAUNCHES[route] == before[1] + 1,
          f"the attention backward did not run on the {route} kernels")
    return grads


def grads_close(got, want, tol) -> bool:
    return all(g.dtype == w.dtype and g.shape == w.shape and torch_allclose(
        g, w, tol) for g, w in zip(got, want))


def torch_allclose(g, w, tol) -> bool:
    import torch
    w = w.float()
    scale = float(w.abs().max()) if w.numel() else 0.0
    return bool(torch.isfinite(g).all()) and torch.allclose(
        g.float(), w, atol=tol * (scale or 1.0), rtol=tol)


def attention_grad_phase(dev, errs):
    """attention_grad_vs_plain: the backward kernel (through
    ``ops.attention``'s autograd route) against ``ref.mha_vjp`` at
    ATTN_GRAD_SHAPES in float32 and bf16 and at ATTN_GRAD_HALF in float16
    and mixed dtypes; each shape run twice, the reruns bitwise equal."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as attn_kernel
    from repro_torch.kernels.flash_attn import ref as attn_ref
    with Phase("attention_grad_vs_plain"):
        gen = torch.Generator().manual_seed(1)
        cases = [(s, (dt,) * 3) for s in ATTN_GRAD_SHAPES
                 for dt in ("float32", "bfloat16")]
        cases += [(s, dts) for s in ATTN_GRAD_HALF for dts in HALF_MIXED]
        for shape, dts in cases:
            B, Hq, Hkv, Sq, Sk, D, Dv, causal = shape
            q, k, v = (torch.randn(s, generator=gen).to(dev, getattr(torch,
                                                                     dt))
                       for s, dt in zip(((B, Hq, Sq, D), (B, Hkv, Sk, D),
                                         (B, Hkv, Sk, Dv)), dts))
            dout = torch.randn((B, Hq, Sq, Dv), generator=gen).to(dev,
                                                                  q.dtype)
            route = attn_kernel.route_bwd(attn_kernel.compute_dtype(q, k, v),
                                          D, Dv)
            got = attention_grads(q, k, v, dout, causal, route)
            again = attention_grads(q, k, v, dout, causal, route)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            want = attn_ref.mha_vjp(q, k, v, dout, causal=causal)
            torch.cuda.synchronize()
            tol = (ATTN_GRAD_TOL[dts[0]] if len(set(dts)) == 1
                   and dts[0] in ATTN_GRAD_TOL else HALF_TOL)
            err = max(max_abs_err(g.float(), w.float())
                      for g, w in zip(got, want))
            if len(set(dts)) == 1 and dts[0] in ATTN_GRAD_TOL:
                key = bwd_row(route, D, q.dtype)
                errs[key] = max(errs[key], err)
            check(same, f"flash_attention_bwd {shape} {dts}: two runs differ")
            check(grads_close(got, want, tol),
                  f"flash_attention_bwd {shape} {dts}: kernel != plain "
                  f"(max_abs_err {err})")
            print(f"flash_attention_bwd {shape} {dts} ({route} route): "
                  f"dq/dk/dv max_abs_err "
                  f"{err:.3g} (tolerance atol = {tol} x max|grad|, rtol = "
                  f"{tol}); rerun bitwise equal; "
                  f"{max(Sq - Sk, 0) if causal else 0} rows see no key",
                  flush=True)
            del q, k, v, dout, got, again, want


def sample_state(state, path, idx, dev):
    """The values of the reference leaf ``path`` of the port's train state
    at flat indices ``idx`` of its stacked shape."""
    import torch
    from repro_torch.train import tree as T
    leaf = T.get(state, tuple(path.split("/")))
    t = torch.stack(leaf) if isinstance(leaf, list) else leaf
    return t.detach().reshape(-1)[torch.tensor(idx, device=t.device)].cpu()


def train_golden_check(rec, dev):
    """Two train steps of each of the golden's runs (AdamW, Adafactor) on
    ``dev`` from ``numpy_reference_params``, held to the golden record."""
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.interop import (numpy_reference_params,
                                     params_from_reference)
    from repro_torch.models.registry import Model
    from repro_torch.train import data as data_mod
    from repro_torch.train import train_step as ts
    for run in rec["runs"]:
        cfg = dc.replace(get_config(rec["arch"]), n_layers=rec["n_layers"],
                         dtype=rec["dtype"], optimizer=run["optimizer"])
        model = Model(cfg)
        params = params_from_reference(
            cfg, numpy_reference_params(cfg, rec["param_seed"]), dev)
        tcfg = ts.TrainConfig(microbatch=rec["microbatch"])
        state = ts.make_train_state(model, params, tcfg)
        step_fn = ts.build_train_step(model, tcfg)
        dcfg = data_mod.DataConfig(vocab=cfg.vocab, seq_len=rec["seq_len"],
                                   global_batch=rec["global_batch"])
        slack = {}              # params path -> per-element AdamW slack
        for s, want in enumerate(run["steps"]):
            batch = {"tokens": torch.from_numpy(
                data_mod.batch_for_step(dcfg, s)).to(dev)}
            state, m = step_fn(state, batch)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            check(abs(loss - want["loss"]) <= GOLDEN_LOSS_ATOL
                  and abs(gnorm - want["grad_norm"])
                  <= GOLDEN_GNORM_RTOL * want["grad_norm"],
                  f"train_golden {run['optimizer']} step {s}: loss {loss} "
                  f"grad_norm {gnorm}, golden {want['loss']} "
                  f"{want['grad_norm']}")
            sched = run["learning_rate"] * min(
                1.0, (s + 1) / run["warmup_steps"])
            worst, n_slack = {}, 0
            for path, leaf in want["state"].items():
                got = sample_state(state, path, leaf["idx"], dev).double()
                ref = torch.tensor(leaf["values"], dtype=torch.float64)
                if path.startswith("params/"):
                    atol = torch.full_like(ref, GOLDEN_PARAM_ATOL)
                    if run["optimizer"] == "adamw":
                        mu = want["state"].get(
                            "opt/mu/" + path[len("params/"):])
                        check(mu is not None and mu["idx"] == leaf["idx"],
                              f"train_golden: {path} has no first moment "
                              f"sampled at its indices")
                        mu = torch.tensor(mu["values"], dtype=torch.float64)
                        near0 = (mu != 0) & (
                            mu.abs() < GOLDEN_MU_NEAR0 * mu.abs().max())
                        slack[path] = (slack.get(path, 0.0)
                                       + 2 * sched * near0.double())
                        atol += slack[path]
                        n_slack += int((slack[path] > 0).sum())
                    rtol = GOLDEN_PARAM_RTOL
                else:
                    atol = torch.full_like(
                        ref, GOLDEN_STATE_RTOL * float(ref.abs().max()))
                    rtol = GOLDEN_STATE_RTOL
                diff, tol = (got - ref).abs(), atol + rtol * ref.abs()
                err = float(diff.max())
                kind = path.split("/")[0] + ("/" + path.split("/")[1]
                                             if path.startswith("opt") else "")
                worst[kind] = max(worst.get(kind, 0.0), err)
                bad = int((diff > tol).sum())
                check(bad == 0, f"train_golden {run['optimizer']} step {s} "
                                f"{path}: {bad} sampled values past their "
                                f"tolerance, max_abs_err {err}")
            print(f"train_golden {cfg.name} {run['optimizer']} step {s}: "
                  f"loss {loss:.6f} (golden {want['loss']:.6f}), grad_norm "
                  f"{gnorm:.6f} (golden {want['grad_norm']:.6f}); sampled "
                  f"state max_abs_err "
                  + ", ".join(f"{k} {v:.3g}" for k, v in sorted(
                      worst.items()))
                  + f"; {n_slack} sampled parameters near a zero first "
                    f"moment", flush=True)
        del state, params, step_fn


def train_golden_phase(dev):
    """train_golden: Yi-6B at full width, 2 layers, float32, numpy weights,
    two train steps on the card (AdamW, then Adafactor), and Mamba2-130M at
    full width, 2 layers, two AdamW steps, against the CPU JAX goldens,
    with the attention's and the SSD scan's launch counts set to 0 just
    before: every float32 attention launch on its tensor-core route, the
    SSD's forward on the float32 walk and its backward on the CUDA cores.
    Returns {kernel row: launches}."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    reset_train_counts()
    with Phase("train_golden"):
        for path in (TRAIN_GOLDEN, TRAIN_SSM_GOLDEN):
            train_golden_check(json.loads(path.read_text()), dev)
        out = dict(zip(("flash_attention_f32", "flash_attention_bwd_f32"),
                       f32_routes("train_golden", bwd=True)))
        routes = (dict(ssd_ops.ROUTE_LAUNCHES),
                  dict(ssd_ops.BWD_ROUTE_LAUNCHES))
        check(routes[0]["wgmma_f32"] == ssd_ops.LAUNCHES > 0
              and ssd_ops.BWD_LAUNCHES > 0,
              f"train_golden: SSD launches by route (forward, backward) "
              f"{routes}")
        out["ssd_scan_f32"] = ssd_ops.LAUNCHES
        out["ssd_scan_bwd_f32"] = ssd_ops.BWD_LAUNCHES
        print(f"train_golden: SSD launches by route (forward, backward) "
              f"{routes}", flush=True)
    torch.cuda.empty_cache()
    return out


def train_batches(cfg, seq_len, global_batch, dev):
    """``batches(step)`` of the synthetic stream (``batch_for_step``) on
    ``dev``, with the family's frontend input (numpy normals from the step)
    where it has one."""
    import numpy as np
    import torch
    from repro_torch.train import data as data_mod
    dcfg = data_mod.DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                               global_batch=global_batch)

    def batches(step):
        batch = {"tokens": torch.from_numpy(
            data_mod.batch_for_step(dcfg, step)).to(dev)}
        shape = None
        if cfg.family == "vlm":
            shape = ("vision_embeds", (global_batch, 8, cfg.frontend_dim))
        if cfg.family == "encdec":
            shape = ("frames", (global_batch, cfg.n_frontend_tokens,
                                cfg.frontend_dim))
        if shape:
            x = np.random.default_rng([7, step]).standard_normal(
                shape[1], dtype=np.float32)
            batch[shape[0]] = torch.from_numpy(x).to(dev)
        return batch
    return batches


def kernel_layers(cfg):
    """(attention layers, SSD layers) of a config's forward pass."""
    if cfg.family == "ssm":
        return 0, cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every, cfg.n_layers
    return cfg.n_layers, 0


def reset_train_counts():
    """Set the attention's and the SSD scan's launch counts (forward and
    backward, in all and by route) to 0."""
    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    for ops in (attn_ops, ssd_ops):
        ops.LAUNCHES = ops.BWD_LAUNCHES = 0
        for counts in (ops.ROUTE_LAUNCHES, ops.BWD_ROUTE_LAUNCHES):
            counts.update(dict.fromkeys(counts, 0))


def train_counts():
    """{kernel: (forward launches, backward launches, forward by route,
    backward by route)} of the attention and the SSD scan."""
    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {name: (ops.LAUNCHES, ops.BWD_LAUNCHES, dict(ops.ROUTE_LAUNCHES),
                   dict(ops.BWD_ROUTE_LAUNCHES))
            for name, ops in (("flash_attention", attn_ops),
                              ("ssd_scan", ssd_ops))}


def train_path(dev, phase, cfg, seq, batch):
    """A training main path of ``cfg`` (bf16, remat) at ``batch`` sequences
    of ``seq`` tokens a step in the config's microbatches, AdamW: first the
    plain path's step-1 loss and gradient norm from the initial weights (no
    update); then, with ``torch.use_deterministic_algorithms(True)``, the
    kernel path through ``build_train_step`` and a ResilientLoop for
    TRAIN_STEPS steps (checkpoints every 2 steps under build/), with the
    attention's and the SSD scan's launch counts set to 0 just before and
    read just after: each kernel a forward a layer a microbatch and its
    remat, and a backward, each on its ``wgmma`` route (every bf16 SSD
    backward on the tensor cores); step 1 within
    TRAIN_LOSS_ATOL and TRAIN_GNORM_RTOL of the plain path; then a crash
    after step 2's checkpoint: step 3's checkpoint removed, every state
    tensor zeroed, and a second ResilientLoop restores step 2 and runs step
    3, whose parameters must equal the uninterrupted run's bitwise.  Each
    step prints its wall ms, tokens per second, each kernel's device ms
    (CUDA events around its bindings: ``KernelClock``) and the peak memory.
    Returns ({kernel: (forward, backward launches)}, per-step records)."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.models.registry import Model
    from repro_torch.train import checkpoint as ckpt_mod
    from repro_torch.train import fault_tolerance as ft_mod
    from repro_torch.train import train_step as ts
    from repro_torch.train import tree as T
    model = Model(cfg)
    tcfg = ts.TrainConfig()
    n_micro = ts.micro_count(model, tcfg)
    batches = train_batches(cfg, seq, batch, dev)
    n_attn, n_ssd = kernel_layers(cfg)
    t0 = time.perf_counter()
    params = model.init_params(
        torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{phase}: {cfg.name} {cfg.dtype}, n_layers={cfg.n_layers}, "
          f"{n_params:,} parameters drawn in "
          f"{time.perf_counter() - t0:.1f} s; {batch} x {seq} tokens a step "
          f"in {n_micro} microbatches, {cfg.optimizer}, remat={cfg.remat} "
          f"({cfg.remat_policy})", flush=True)
    params.requires_grad_(True)
    t0 = time.perf_counter()
    plain_loss, grads = ts.loss_and_grads(
        Model(cfg, backend="torch"), params, batches(0), n_micro)
    plain_gnorm = float(ts.global_norm(grads))
    plain_loss = float(plain_loss)
    del grads
    torch.cuda.empty_cache()
    print(f"{phase} plain path (backend='torch'), step 1 without update: "
          f"loss {plain_loss:.6f} grad_norm {plain_gnorm:.6f} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    ckdir = TRAIN_OUT / "ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    ftc = ft_mod.FTConfig(ckpt_dir=str(ckdir), ckpt_every=2, keep_last=3)
    records = []
    clock = KernelClock()

    def metrics_cb(step, m, dt):
        ms, calls = clock.take()
        rec = {"step": step + 1, "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]), "wall_ms": dt * 1e3,
               "tokens_per_s": batch * seq / dt}
        rec.update({f"{n}_ms": v for n, v in ms.items() if calls[n]})
        rec["calls"] = {n: c for n, c in calls.items() if c}
        rec["max_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        records.append(rec)
        print(f"{phase} step {rec['step']}: "
              + " ".join(f"{k}={v:.6g}" if isinstance(v, float)
                         else f"{k}={v}" for k, v in rec.items()
                         if k != "step"), flush=True)

    torch.use_deterministic_algorithms(True)
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        state = ts.make_train_state(model, params, tcfg)
        step_fn = ts.build_train_step(model, tcfg)
        reset_train_counts()
        t0 = time.perf_counter()
        with clock:
            loop = ft_mod.ResilientLoop(step_fn, state, ftc, health_cb=print)
            loop.run(batches, TRAIN_STEPS, metrics_cb)
        counts = train_counts()
        print(f"{phase}: {TRAIN_STEPS} steps and their checkpoints in "
              f"{time.perf_counter() - t0:.1f} s; launches (forward, "
              f"backward, by route) {counts}", flush=True)
        for name, layers, fwd_route, bwd_route in (
                ("flash_attention", n_attn, "wgmma", "wgmma"),
                ("ssd_scan", n_ssd, "wgmma", "wgmma")):
            fwd, bwd, fr, br = counts[name]
            per_step = layers * n_micro
            check(fwd == TRAIN_STEPS * per_step * 2
                  and bwd == TRAIN_STEPS * per_step
                  and fr[fwd_route] == fwd and br[bwd_route] == bwd,
                  f"{phase}: {name} launches {fwd} forward, {bwd} backward "
                  f"(by route {fr}, {br}); expected "
                  f"{TRAIN_STEPS * per_step * 2} and {TRAIN_STEPS * per_step}"
                  f" (a forward and its remat, and a backward, a layer a "
                  f"microbatch), on the {fwd_route} and {bwd_route} routes")
        check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                  for r in records),
              f"{phase}: a loss or gradient norm is not finite")
        first = records[0]
        check(abs(first["loss"] - plain_loss) <= TRAIN_LOSS_ATOL
              and abs(first["grad_norm"] - plain_gnorm)
              <= TRAIN_GNORM_RTOL * plain_gnorm,
              f"{phase} step 1: kernel path loss {first['loss']} grad_norm "
              f"{first['grad_norm']}, plain path {plain_loss} {plain_gnorm}")
        print(f"{phase} step 1, kernel vs plain: loss {first['loss']:.6f} "
              f"vs {plain_loss:.6f} (|diff| "
              f"{abs(first['loss'] - plain_loss):.3g} <= {TRAIN_LOSS_ATOL}), "
              f"grad_norm {first['grad_norm']:.6f} vs {plain_gnorm:.6f} (rel "
              f"diff {abs(first['grad_norm'] - plain_gnorm) / plain_gnorm:.3g}"
              f" <= {TRAIN_GNORM_RTOL})", flush=True)
        final = [t.detach().clone() for t in params.parameters()]

        # a crash after step 2's checkpoint committed
        shutil.rmtree(ckdir / f"step_{TRAIN_STEPS:08d}")
        check(ckpt_mod.latest_step(str(ckdir)) == 2,
              f"{phase}: step 2's checkpoint is missing")
        with torch.no_grad():
            for _, leaf in T.items(state):
                for t in T.layers(leaf):
                    t.zero_()
        t0 = time.perf_counter()
        loop2 = ft_mod.ResilientLoop(step_fn, state, ftc, health_cb=print)
        restore_s = time.perf_counter() - t0
        check(loop2.start_step == 2, f"{phase}: the restart did not resume "
              f"at step 2 ({loop2.start_step})")
        n_before = len(records)
        with clock:
            loop2.run(batches, TRAIN_STEPS, metrics_cb)
        after = list(params.parameters())
        same = all(torch.equal(a, b) for a, b in zip(final, after))
        check(same and records[-1]["loss"] == records[n_before - 1]["loss"],
              f"{phase}: the restarted step 3 differs from the "
              f"uninterrupted run's")
        print(f"{phase} restart: restored step 2 in {restore_s:.1f} s; step "
              f"3's parameters bitwise equal to the uninterrupted run's "
              f"({len(after)} tensors, deterministic algorithms on)",
              flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
    del state, params, final, loop, loop2, step_fn
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return {n: c[:2] for n, c in counts.items()}, records


def train_main_phase(dev):
    """train_main_path: Yi-6B (see TRAIN_LAYERS) through ``train_path``.
    Returns (bf16 attention forward launches, backward launches,
    records)."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    cfg = dc.replace(get_config("yi-6b"), n_layers=TRAIN_LAYERS)
    with Phase("train_main_path"):
        counts, records = train_path(dev, "train_main_path", cfg, TRAIN_SEQ,
                                     TRAIN_BATCH)
    return (*counts["flash_attention"], records)


def train_ssm_phase(dev):
    """train_ssm_main_path: Mamba2-130M whole and Zamba2-2.7B at full width
    cut to ZAMBA_TRAIN_LAYERS (see TRAIN_SSM) through ``train_path``.
    Returns {kernel row: launches} of the bf16 kernels (the SSD scan's
    forward and backward, and Zamba2's attention forward and backward)."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    rows = {}
    with Phase("train_ssm_main_path"):
        for arch, layers, seq, batch in TRAIN_SSM:
            cfg = get_config(arch)
            cfg = dc.replace(cfg, n_layers=layers or cfg.n_layers)
            counts, _ = train_path(dev, f"train_ssm_main_path {arch}", cfg,
                                   seq, batch)
            for row, (kernel, i) in (
                    ("ssd_scan", ("ssd_scan", 0)),
                    ("ssd_scan_bwd", ("ssd_scan", 1)),
                    ("flash_attention", ("flash_attention", 0)),
                    ("flash_attention_bwd", ("flash_attention", 1))):
                rows[row] = rows.get(row, 0) + counts[kernel][i]
    return rows


def zoo_step(cfg, dev):
    """One train step of ``cfg`` (4 sequences of 64 tokens, the same
    weights) through the kernels and through the plain path: {backend:
    (loss, gradient norm, attention forward launches, attention backward
    launches, SSD forward launches, SSD backward launches)}."""
    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models.registry import Model
    from repro_torch.train import train_step as ts
    batches = train_batches(cfg, 64, 4, dev)
    out = {}
    counts = lambda: (attn_ops.LAUNCHES, attn_ops.BWD_LAUNCHES,
                      ssd_ops.LAUNCHES, ssd_ops.BWD_LAUNCHES)
    for backend in ("auto", "torch"):
        model = Model(cfg, backend=backend)
        params = model.init_params(0, device=dev)
        tcfg = ts.TrainConfig()
        state = ts.make_train_state(model, params, tcfg)
        before = counts()
        _, m = ts.build_train_step(model, tcfg)(state, batches(0))
        out[backend] = (float(m["loss"]), float(m["grad_norm"]),
                        *(a - b for a, b in zip(counts(), before)))
    return out


def train_zoo_phase(dev):
    """train_zoo_smoke: one train step of each family in TRAIN_ZOO at its
    smoke config (float32) through the kernels and through the plain path
    from the same weights; loss and gradient norm within ZOO_*_RTOL, and
    the forward and backward kernels of its layers launched (attention
    and SSD scan: ``kernel_layers``), the attention's and the SSD's forward
    all on their float32 tensor-core routes and the SSD's backward on its
    CUDA-core route.  Then DeepSeek-V3's smoke config at its own head
    widths (ZOO_WIDE_HEADS: Dk 192, Dv 128), one step in float32 (within
    ZOO_*_RTOL) and one in bf16 (within TRAIN_LOSS_ATOL and
    TRAIN_GNORM_RTOL, the bf16 main path's), each with its attention
    launches by route counted from 0: all on the tensor-core routes.
    Returns the attention's and the SSD scan's launches by row of the
    ``kernels`` line."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import ops as attn_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    rows = {}
    with Phase("train_zoo_smoke"):
        reset_train_counts()
        for arch in TRAIN_ZOO:
            cfg = get_config(arch, smoke=True)
            out = zoo_step(cfg, dev)
            (lk, gk, fk, bk, sk, sb), (lp, gp, *plain) = (out["auto"],
                                                          out["torch"])
            n_attn, n_ssd = kernel_layers(cfg)
            check((fk > 0) == (bk > 0) == (n_attn > 0)
                  and (sk > 0) == (sb > 0) == (n_ssd > 0) and not any(plain),
                  f"train_zoo_smoke {arch}: kernel launches (attention "
                  f"forward, backward, SSD forward, backward) "
                  f"{(fk, bk, sk, sb)}, plain {plain}")
            check(abs(lk - lp) <= ZOO_LOSS_RTOL * abs(lp)
                  and abs(gk - gp) <= ZOO_GNORM_RTOL * gp,
                  f"train_zoo_smoke {arch}: kernel loss {lk} grad_norm {gk}, "
                  f"plain {lp} {gp}")
            print(f"train_zoo_smoke {cfg.name} ({cfg.family}): loss {lk:.6f} "
                  f"vs plain {lp:.6f}, grad_norm {gk:.6f} vs {gp:.6f}; "
                  f"flash_attention forward {fk}, backward {bk} launches; "
                  f"ssd_scan forward {sk}, backward {sb}", flush=True)
        rows["flash_attention_f32"], rows["flash_attention_bwd_f32"] = \
            f32_routes("train_zoo_smoke", bwd=True)
        ssd_routes = (dict(ssd_ops.ROUTE_LAUNCHES),
                      dict(ssd_ops.BWD_ROUTE_LAUNCHES))
        check(ssd_routes[0]["wgmma_f32"] == ssd_ops.LAUNCHES > 0
              and ssd_ops.BWD_LAUNCHES > 0,
              f"train_zoo_smoke: SSD launches by route (forward, backward) "
              f"{ssd_routes}: the forward must take the float32 tensor-core "
              f"walk, and the backward must launch")
        rows["ssd_scan_f32"] = ssd_ops.LAUNCHES
        rows["ssd_scan_bwd_f32"] = ssd_ops.BWD_LAUNCHES
        t0 = time.perf_counter()
        wide = dataclasses.replace(get_config("deepseek-v3-671b", smoke=True),
                                   **ZOO_WIDE_HEADS)
        for dtype, route, ltol, grtol in (
                ("float32", "wgmma_f32", None, ZOO_GNORM_RTOL),
                ("bfloat16", "wgmma", TRAIN_LOSS_ATOL, TRAIN_GNORM_RTOL)):
            cfg = dataclasses.replace(wide, dtype=dtype)
            reset_attn_routes()
            out = zoo_step(cfg, dev)
            (lk, gk, fk, bk), (lp, gp, fp, bp) = (out["auto"][:4],
                                                  out["torch"][:4])
            got = (dict(attn_ops.ROUTE_LAUNCHES),
                   dict(attn_ops.BWD_ROUTE_LAUNCHES))
            check(all(r[route] > 0 and sum(r.values()) == r[route]
                      for r in got) and got[0][route] == fk
                  and got[1][route] == bk and fp == 0 and bp == 0,
                  f"train_zoo_smoke {cfg.name} Dk 192 {dtype}: attention "
                  f"launches by route {got} (kernel {fk}/{bk}, plain "
                  f"{fp}/{bp}); all must take the {route} route")
            loss_ok = (abs(lk - lp) <= ZOO_LOSS_RTOL * abs(lp)
                       if ltol is None else abs(lk - lp) <= ltol)
            check(loss_ok and abs(gk - gp) <= grtol * gp,
                  f"train_zoo_smoke {cfg.name} Dk 192 {dtype}: kernel loss "
                  f"{lk} grad_norm {gk}, plain {lp} {gp}")
            print(f"train_zoo_smoke {cfg.name} at Dk 192 / Dv 128, {dtype}: "
                  f"loss {lk:.6f} vs plain {lp:.6f}, grad_norm {gk:.6f} vs "
                  f"{gp:.6f}; flash_attention launches by route (forward, "
                  f"backward) {got}", flush=True)
            if dtype == "float32":
                rows["flash_attention_f32_wide"] = fk
                rows["flash_attention_bwd_f32_wide"] = bk
            else:
                rows["flash_attention"] = fk
                rows["flash_attention_bwd_wide"] = bk
        print(f"train_zoo_smoke: the two steps at Dk 192 in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return rows


def train_cli_phase():
    """train_cli: ``repro_torch.launch.train.main`` on the card (its
    default device), Yi-6B's smoke config for 4 steps with a checkpoint
    every 2, then again to 6 steps: it must resume at step 4."""
    import shutil
    import numpy as np
    from repro_torch.launch import train as launch_train
    from repro_torch.train import checkpoint as ckpt_mod
    with Phase("train_cli"):
        d = TRAIN_OUT / "cli"
        shutil.rmtree(d, ignore_errors=True)
        argv = ["--arch", "yi-6b", "--smoke", "--steps", "4", "--ckpt-dir",
                str(d), "--ckpt-every", "2", "--log-every", "1"]
        losses = launch_train.main(argv)
        check(len(losses) == 4 and all(np.isfinite(losses))
              and ckpt_mod.latest_step(str(d)) == 4,
              f"train_cli: losses {losses}")
        again = launch_train.main(argv[:4] + ["6"] + argv[5:])
        check(len(again) == 2 and all(np.isfinite(again))
              and ckpt_mod.latest_step(str(d)) == 6,
              f"train_cli: the restart ran {len(again)} steps")
        print(f"train_cli: 4 steps, losses {[round(x, 4) for x in losses]}; "
              f"the restart resumed at step 4 and ran 2 more "
              f"({[round(x, 4) for x in again]})", flush=True)
        shutil.rmtree(d, ignore_errors=True)


def attention_bwd_timing(errs, n_micro):
    """The backward kernel's rows of the ``kernels`` line, given the
    forward's log-sum-exp as autograd gives it: the bf16 and float32
    tensor-core routes at the training main path's shape and at
    MLA_F32_SHAPE (the ``_wide`` rows), and the float32 CUDA-core route at
    CUDA_CORE_SHAPE (random inputs): the wrapper's ms (CUDA events), the
    device ms of its launches (four on the tensor-core routes, three at D
    > 128 with a group of one head, as at MLA's, and on the CUDA-core route;
    profiler, None unless a trace holds all of them), the plain version
    (``ref.mha_vjp``), the backward of one SDPA call (the library's time),
    and the bound: the backward's five products (S and dP again, dV, dQ,
    dK) at the card's rate for the type (float32: FP32_SPLIT_FLOP_PER_S),
    or its bytes (q, k, v, out and dout read once, dq, dk, dv written once)
    at 3.35 TB/s."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import kernel as attn_kernel
    from repro_torch.kernels.flash_attn import ref as attn_ref
    B, Hq, Hkv, S, D = TRAIN_BATCH // n_micro, 32, 4, TRAIN_SEQ, 128
    gen = torch.Generator().manual_seed(2)
    rows = []
    train = [torch.randn(s, generator=gen) for s in (
        (B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D), (B, Hq, S, D))]
    def draw(B_, Hq_, Hkv_, S_, _, D_, Dv_):
        return [torch.randn(s, generator=gen) for s in (
            (B_, Hq_, S_, D_), (B_, Hkv_, S_, D_), (B_, Hkv_, S_, Dv_),
            (B_, Hq_, S_, Dv_))]
    mla = draw(*MLA_F32_SHAPE)
    cc = draw(*CUDA_CORE_SHAPE)
    for name, dtype, base in (
            ("flash_attention_bwd", torch.bfloat16, train),
            ("flash_attention_bwd_f32", torch.float32, train),
            ("flash_attention_bwd_wide", torch.bfloat16, mla),
            ("flash_attention_bwd_f32_wide", torch.float32, mla),
            ("flash_attention_bwd_f32_cuda_cores", torch.float32, cc)):
        q, k, v, dout = (t.to("cuda", dtype) for t in base)
        B, Hq, S, D = q.shape
        Hkv, Dv = k.shape[1], v.shape[-1]
        route = attn_kernel.route_bwd(dtype, D, Dv)
        check(bwd_row(route, D, dtype) == name,
              f"{name}: {tuple(q.shape)} takes the {route} route")
        out, lse = attn_kernel.flash_attention(q, k, v, causal=True,
                                               return_lse=True)
        got = attn_kernel.flash_attention_bwd(q, k, v, out, dout, lse)
        want = attn_ref.mha_vjp(q, k, v, dout)
        tol = ATTN_GRAD_TOL[str(dtype).split(".")[-1]]
        err = max(errs[name], max(max_abs_err(g.float(), w.float())
                                  for g, w in zip(got, want)))
        check(grads_close(got, want, tol),
              f"{name}: kernel != plain at the main path's shape")
        f64 = {}
        if dtype == torch.float32:
            exact = mha64(q, k, v, dout)
            f64 = dict(f64_err=max(map(max_abs_err, got, exact)),
                       plain_f64_err=max(map(max_abs_err, want, exact)))
            del exact
        del got, want

        def call():
            return attn_kernel.flash_attention_bwd(q, k, v, out, dout, lse)
        ms = cuda_ms(call, 5)
        # launches a call: delta, dK/dV, dQ and the group's sum of dK/dV
        # (tensor-core routes; no sum at D > 128 with a group of one query
        # head, MLA's); the row statistics, dQ, dK/dV (CUDA cores)
        dev_ms = device_ms(call, 5, r"attn_bwd_",
                           per_call=3 if route == "cuda_cores"
                           or (D > 128 and Hq == Hkv) else 4)
        plain_ms = cuda_ms(lambda: attn_ref.mha_vjp(q, k, v, dout), 2)
        qc, kc, vc = (t.detach().clone().requires_grad_(True) for t in (
            q, k.repeat_interleave(Hq // Hkv, dim=1),
            v.repeat_interleave(Hq // Hkv, dim=1)))
        lib_out = F.scaled_dot_product_attention(qc, kc, vc, is_causal=True)
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            lib_out, (qc, kc, vc), dout, retain_graph=True), 5)
        del lib_out, qc, kc, vc
        pairs = B * Hq * S * (S + 1) // 2
        flops = 2 * pairs * (3 * D + 2 * Dv)
        nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel()
                                     + 2 * v.numel() + 2 * out.numel())
        peak = (BF16_FLOP_PER_S if dtype == torch.bfloat16
                else FP32_SPLIT_FLOP_PER_S)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/" + (
                "flash_attn_bwd_f32.cu" if route == "wgmma_f32"
                else "flash_attn_bwd.cu"),
            replaces="none: the port's gradient of src/repro/kernels/"
                     "flash_attn/kernel.py:72, which JAX cannot "
                     "differentiate",
            launches=0, max_abs_err=err, ms=ms, device_ms=dev_ms,
            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=library_ms, n=int(B * Hq * S),
            shape=[B, Hq, Hkv, S, S, D] + ([Dv] if Dv != D else []),
            **f64))
        print(f"kernel {name} ({route} route): shape={rows[-1]['shape']} "
              f"ms={ms:.4f} device_ms={dev_ms} plain_ms={plain_ms:.4f} "
              f"bound_ms={rows[-1]['bound_ms']:.4f} ({rows[-1]['bound_by']}) "
              f"library_ms={library_ms:.4f} (one SDPA backward) {f64}",
              flush=True)
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    return rows


def ssd_grad_inputs(shape, dtype, gen, dev, decay=1.0, final=False,
                    strided=False):
    """``ssd_inputs`` with dy (x's dtype) and, with ``final``, the final
    state's gradient (float32); with ``strided``, x, B, C and dy are slices
    of wider tensors, as the model's projections give them."""
    import torch
    B, L, H, P, G, N = shape
    x, dt, A, Bm, C = ssd_inputs(B, L, H, P, G, N, dtype, gen, dev, decay)
    dy = torch.randn(B, L, H, P, generator=gen).to(dev, dtype)
    dh = (torch.randn(B, H, N, P, generator=gen).to(dev) if final
          else None)
    if strided:
        proj = torch.zeros(B, L, H * P + 2 * G * N + 8, dtype=dtype,
                           device=dev)
        parts = [x.reshape(B, L, -1), Bm.reshape(B, L, -1),
                 C.reshape(B, L, -1)]
        views, o = [], 0
        for t in parts:
            proj[..., o:o + t.shape[-1]] = t
            views.append(proj[..., o:o + t.shape[-1]])
            o += t.shape[-1]
        x = views[0].reshape(B, L, H, P)
        Bm, C = (v.reshape(B, L, G, N) for v in views[1:])
        wide = torch.zeros(B, L, H, P + 3, dtype=dtype, device=dev)
        wide[..., :P] = dy
        dy = wide[..., :P]
        check(not x.is_contiguous() and not dy.is_contiguous(),
              "ssd_grad_inputs: the strided inputs are contiguous")
    return (x, dt, A, Bm, C), dy, dh


def ssd_bwd_cuda_cores(args, dy, dh=None, chunk=64):
    """``kernel.ssd_scan_bwd`` on its CUDA-core route whatever ``route_bwd``
    names (``route_bwd`` held at ``"cuda_cores"`` for the call): the
    CUDA-core kernel on the tensor cores' inputs, the yardstick of the bf16
    timing row."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    orig = ssd_kernel.route_bwd
    ssd_kernel.route_bwd = lambda *a, **k: "cuda_cores"
    try:
        return ssd_kernel.ssd_scan_bwd(*args, dy, dh, chunk=chunk)
    finally:
        ssd_kernel.route_bwd = orig


def rel_errs(got, exact):
    """Each gradient's largest distance from ``exact`` over the largest
    magnitude of ``exact`` (over 1 where it is 0), as
    ``tools/ssd_bwd_rounding.py`` measures them."""
    return [max_abs_err(g.double(), e) / (float(e.abs().max()) or 1.0)
            for g, e in zip(got, exact)]


def ssd_grads_check(tag, args, dy, dh, chunk, errs, name, tol=None):
    """The backward kernel (``kernel.ssd_scan_bwd``) against ``ref.ssd_vjp``
    on ``args``: both calls launched on the route ``ssd_expected_bwd_route``
    names (the binding's ``BWD_ROUTE_LAUNCHES``), finite gradients of the inputs' shapes and dtypes, a
    rerun bitwise equal; bf16 (or ``tol``) each gradient within
    SSD_GRAD_TOL of its largest magnitude; float32 each no further from the
    float64 plain gradient than twice the float32 plain version's distance,
    plus SSD_GRAD_F32_FLOOR of its largest magnitude.  Returns the printed
    line's text, the kernel's gradients and, for float32, {"f64_err",
    "plain_f64_err"}: the kernel's and the float32 plain version's largest
    distance from the float64 gradients (else {})."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    x, _, _, Bm, C = args
    cd = str(ssd_kernel.compute_dtype(x, Bm, C)).split(".")[-1]
    route = ssd_expected_bwd_route(cd, Bm.shape[3], x.shape[3])
    before = dict(ssd_kernel.BWD_ROUTE_LAUNCHES)
    got = ssd_kernel.ssd_scan_bwd(*args, dy, dh, chunk=chunk)
    again = ssd_kernel.ssd_scan_bwd(*args, dy, dh, chunk=chunk)
    counts = {r: n - before[r]
              for r, n in ssd_kernel.BWD_ROUTE_LAUNCHES.items()}
    want = ssd_ref.ssd_vjp(*args, dy, chunk=chunk, dh_final=dh)
    torch.cuda.synchronize()
    check(counts[route] == 2 and sum(counts.values()) == 2,
          f"{tag}: backward launches by route {counts}, expected both on "
          f"{route}")
    check(all(torch.equal(g, a) for g, a in zip(got, again)),
          f"{tag}: a rerun differs")
    check(all(g.shape == t.shape and g.dtype == t.dtype
              and bool(torch.isfinite(g).all()) for g, t in zip(got, args)),
          f"{tag}: a gradient is not finite, or of another shape or dtype")
    err = max(max_abs_err(g.float(), w.float()) for g, w in zip(got, want))
    errs[name] = max(errs[name], err)
    line, f64 = f"{tag} ({route}): max_abs_err {err:.3g}", {}
    if args[0].dtype == torch.float32 and tol is None:
        exact = ssd_ref.ssd_vjp(*(t.double() for t in args), dy.double(),
                                chunk=chunk,
                                dh_final=None if dh is None else dh.double())
        ke, pe = [], []
        for g, w, e, what in zip(got, want, exact, SSD_GRAD_NAMES):
            k_err, p_err = max_abs_err(g.double(), e), max_abs_err(
                w.double(), e)
            floor = SSD_GRAD_F32_FLOOR * float(e.abs().max())
            check(k_err <= 2 * p_err + floor,
                  f"{tag} {what}: kernel {k_err:.3g} from float64, plain "
                  f"float32 {p_err:.3g} (floor {floor:.3g})")
            ke.append(k_err)
            pe.append(p_err)
        f64 = dict(f64_err=max(ke), plain_f64_err=max(pe))
        line += (f"; f64_err {['%.3g' % v for v in ke]} plain_f64_err "
                 f"{['%.3g' % v for v in pe]} (dx, ddt, dA, dB, dC; each <= "
                 f"2 x plain + {SSD_GRAD_F32_FLOOR} of its largest)")
    else:
        tol = SSD_GRAD_TOL if tol is None else tol
        for g, w, what in zip(got, want, SSD_GRAD_NAMES):
            scale = float(w.float().abs().max())
            e = max_abs_err(g.float(), w.float())
            check(e <= tol * scale,
                  f"{tag} {what}: max_abs_err {e:.3g} past {tol} of the "
                  f"largest magnitude {scale:.3g}")
        line += f" (tolerance {tol} of each gradient's largest magnitude)"
    return line, got, f64


def ssd_grad_phase(dev, errs):
    """ssd_grad_vs_plain: the SSD scan's backward kernel against its plain
    version ``ref.ssd_vjp`` on the card (``ssd_grads_check``) at SSD_HEADS
    x SSD_GRAD_LENS x batch 1-2 in bf16 and float32, a large-decay case per
    head shape (A dt summing past 100 in a chunk: every gradient finite),
    final-state gradients, requested chunks of 16 and 128, P and N past one
    tile of 64 (SSD_WIDE), bf16 heads of P 32 to 256 on the tensor cores
    (SSD_BWD_P_HEADS, ragged, with the final state), strided slices of x, B, C and dy, and float16 and
    mixed dtypes (read in float32); every case rerun bitwise.  Then through
    ``ops.ssd``'s autograd route (``SSDScan``), with and without the final
    state: the same gradients as the binding, and one ``BWD_LAUNCHES``
    each, on its route.  bf16 with N <= 128 takes the tensor cores
    (``ssd_expected_bwd_route``), the bf16 SSD_WIDE cases (N 200 and 256)
    and every float32 case the CUDA cores: each case's launches are counted
    by route (the binding's ``BWD_ROUTE_LAUNCHES``)."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    with Phase("ssd_grad_vs_plain"):
        gen = torch.Generator().manual_seed(3)
        cases = [((B, L, *hd), dt, 1.0, 64, False, False)
                 for hd in SSD_HEADS for L in SSD_GRAD_LENS for B in (1, 2)
                 for dt in ("float32", "bfloat16")]
        cases += [((1, 256, *hd), dt, SSD_DECAY, 64, fs, False)
                  for hd in SSD_HEADS for dt in ("float32", "bfloat16")
                  for fs in (False, True)]
        cases += [((2, 300, *SSD_HEADS[0]), dt, 1.0, 64, True, False)
                  for dt in ("float32", "bfloat16")]
        cases += [((1, 301, *SSD_HEADS[2]), dt, 1.0, chunk, False, False)
                  for chunk in (16, 128) for dt in ("float32", "bfloat16")]
        cases += [((1, 100, *hd), dt, 1.0, 64, True, False)
                  for hd in SSD_WIDE for dt in ("float32", "bfloat16")]
        cases += [((2, 100, *SSD_HEADS[1]), dt, 1.0, 64, False, True)
                  for dt in ("float32", "bfloat16")]
        cases += [((1, 301, *hd), "bfloat16", 1.0, 64, True, False)
                  for hd in SSD_BWD_P_HEADS]
        for shape, dt, decay, chunk, fs, strided in cases:
            args, dy, dh = ssd_grad_inputs(shape, getattr(torch, dt), gen,
                                           dev, decay, fs, strided)
            tag = (f"ssd_scan_bwd {shape} {dt} decay {decay} chunk {chunk}"
                   + (" final_state" if fs else "")
                   + (" strided" if strided else ""))
            route = ssd_expected_bwd_route(dt, shape[5], shape[3])
            name = ("ssd_scan_bwd_f32" if dt == "float32" else
                    "ssd_scan_bwd" if route == "wgmma" else
                    "ssd_scan_bwd_cuda_cores")
            line, _, _ = ssd_grads_check(tag, args, dy, dh, chunk, errs,
                                         name)
            print(line, flush=True)
        n_half, half_errs = 0, {"ssd_scan_bwd_f32": 0.0}
        for shape in SSD_HALF_SHAPES:
            for dts in HALF_MIXED:
                args, dy, _ = ssd_grad_inputs(shape, torch.float32, gen, dev)
                x, dt_, A, Bm, C = args
                x, Bm, C = (t.to(getattr(torch, d))
                            for t, d in zip((x, Bm, C), dts))
                line, _, _ = ssd_grads_check(
                    f"ssd_scan_bwd {shape} {dts}", (x, dt_, A, Bm, C),
                    dy.to(x.dtype), None, 64, half_errs, "ssd_scan_bwd_f32",
                    tol=HALF_TOL)
                print(line + " (read in float32)", flush=True)
                n_half += 1
        n_ops = 0
        for shape, dt, fs in (((1, 2048, *SSD_HEADS[0]), "bfloat16", False),
                              ((2, 100, *SSD_HEADS[2]), "float32", True)):
            args, dy, dh = ssd_grad_inputs(shape, getattr(torch, dt), gen,
                                           dev, final=fs)
            _, want, _ = ssd_grads_check(
                f"ssd_scan_bwd {shape} {dt} via ops", args, dy, dh, 64, errs,
                "ssd_scan_bwd" + ("_f32" if dt == "float32" else ""))
            ins = [t.detach().requires_grad_(True) for t in args]
            before = ssd_ops.BWD_LAUNCHES
            routes = dict(ssd_ops.BWD_ROUTE_LAUNCHES)
            route = ssd_expected_bwd_route(dt, shape[5], shape[3])
            out = ssd_ops.ssd(*ins, final_state=fs)
            outs, cots = ((out, (dy, dh)) if fs else ((out,), (dy,)))
            got = torch.autograd.grad(outs, ins, cots)
            check(ssd_ops.BWD_LAUNCHES == before + 1
                  and ssd_ops.BWD_ROUTE_LAUNCHES == {
                      **routes, route: routes[route] + 1}
                  and all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"ssd_scan_bwd {shape} {dt} final_state={fs}: ops.ssd's "
                  f"autograd route differs from the binding, or did not "
                  f"launch the backward once on {route} (by route "
                  f"{ssd_ops.BWD_ROUTE_LAUNCHES})")
            n_ops += 1
        print(f"ssd_grad_vs_plain: {len(cases)} cases, {n_half} float16 and "
              f"mixed, {n_ops} through ops.ssd's autograd route; every case "
              f"on its route, every rerun bitwise; largest max_abs_err bf16 "
              f"on the tensor cores {errs['ssd_scan_bwd']:.3g}, on the CUDA "
              f"cores {errs['ssd_scan_bwd_cuda_cores']:.3g}, float32 "
              f"{errs['ssd_scan_bwd_f32']:.3g}, float16 and mixed "
              f"{half_errs['ssd_scan_bwd_f32']:.3g}", flush=True)


def ssd_bwd_timing(errs, launches):
    """The backward kernel's rows of the ``kernels`` line (random inputs),
    each held to ``ref.ssd_vjp`` first (``ssd_grads_check``): bf16 at
    Zamba2-2.7B's train shape (SSD_BWD_SHAPE) on the tensor cores, float32
    at the SSM golden's (SSD_BWD_F32_SHAPE) and bf16 at N = 256
    (SSD_CUDA_CORE_SHAPE, launches 0: no main path reaches it) on the CUDA
    cores: the binding's ms (CUDA events), the device ms of its four
    launches (profiler) in all and by launch, the plain version's ms, and
    the bound: x, dy and dx, B, C, dB and dC, dt and ddt moved once at 3.35
    TB/s, or the products at the card's rate for the type (float32 at
    FP32_SPLIT_FLOP_PER_S): G, dS, S^T dy, dG B and dG^T C over the causal
    pairs, and per row dh1^T B, h0 dy, dh1 x and the two chunk-state
    products.  The bf16 tensor-core row also holds the CUDA-core route's
    device ms by launch on the same inputs (``ssd_bwd_cuda_cores``) and
    the float64 yardstick: ``ref.ssd_vjp`` in float64 on the same bf16
    inputs, ``f64_err`` (the tensor cores), ``cuda_cores_f64_err`` and
    ``plain_f64_err`` (the float32 plain version) the largest over the five
    gradients of ``rel_errs``, each also by gradient.  No single PyTorch
    call computes this gradient (library_ms None).  ``launches``: {row:
    launches on the main paths}."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    rows = []
    gen = torch.Generator().manual_seed(7)
    for name, shape, dtype in (
            ("ssd_scan_bwd", SSD_BWD_SHAPE, torch.bfloat16),
            ("ssd_scan_bwd_f32", SSD_BWD_F32_SHAPE, torch.float32),
            ("ssd_scan_bwd_cuda_cores", SSD_CUDA_CORE_SHAPE, torch.bfloat16)):
        args, dy, _ = ssd_grad_inputs(shape, dtype, gen, torch.device(
            "cuda", 0))
        line, got, f64 = ssd_grads_check(f"{name} {shape}", args, dy, None,
                                         64, errs, name)
        Bsz, L, H, P, G, N = shape
        route = ssd_expected_bwd_route(str(dtype).split(".")[-1], N, P)

        def call():
            return ssd_kernel.ssd_scan_bwd(*args, dy)
        ms = cuda_ms(call, 10)
        dev_ms, by_launch = device_ms(call, 10, SSD_BWD_KERNELS, per_call=4,
                                      split=True)
        extra = {}
        if route == "wgmma":
            extra["cuda_cores_device_ms_by_launch"] = device_ms(
                lambda: ssd_bwd_cuda_cores(args, dy), 10, SSD_BWD_KERNELS,
                per_call=4, split=True)[1]
            exact = ssd_ref.ssd_vjp(*(t.double() for t in args), dy.double())
            by = {"f64_err": rel_errs(got, exact),
                  "cuda_cores_f64_err": rel_errs(
                      ssd_bwd_cuda_cores(args, dy), exact),
                  "plain_f64_err": rel_errs(ssd_ref.ssd_vjp(*args, dy),
                                            exact)}
            del exact
            f64 = {k: max(v) for k, v in by.items()}
            f64.update({f"{k}_by_grad": dict(zip(SSD_GRAD_NAMES, v))
                        for k, v in by.items()})
        plain_ms = cuda_ms(lambda: ssd_ref.ssd_vjp(*args, dy), 3)
        es = args[0].element_size()
        nbytes = (3 * Bsz * L * H * P * es + 4 * Bsz * L * G * N * es
                  + 2 * Bsz * L * H * 4 + 2 * H * 4)
        flops = 0
        for c0 in range(0, L, 64):
            r = min(64, L - c0)
            flops += (2 * r * (r + 1) // 2 * (3 * N + 2 * P)
                      + 10 * r * N * P)
        flops *= Bsz * H
        peak = (BF16_FLOP_PER_S if dtype == torch.bfloat16
                else FP32_SPLIT_FLOP_PER_S)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/" + (
                "ssd_scan_bwd_wgmma.cu" if route == "wgmma"
                else "ssd_scan_bwd.cu"),
            replaces="none: the port's gradient of src/repro/kernels/"
                     "ssd_scan/kernel.py:66, whose reference JAX "
                     "differentiates through ref.ssd_chunked",
            launches=launches.get(name, 0), max_abs_err=errs[name], ms=ms,
            device_ms=dev_ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, n=int(Bsz * L * H), shape=list(shape),
            kernel_route=route, device_ms_by_launch=by_launch, **extra,
            **f64))
        print(f"kernel {name} ({route} route): {line}; ms={ms:.4f} "
              f"device_ms={dev_ms} by launch {by_launch} "
              f"plain_ms={plain_ms:.4f} "
              f"bound_ms={rows[-1]['bound_ms']:.4f} "
              f"({rows[-1]['bound_by']}) {extra} {f64}", flush=True)
        del args, dy, got
        torch.cuda.empty_cache()
    return rows


def training_phases(dev, errs):
    """The training phases, in order; returns the attention's and the SSD
    scan's launches on their main-path runs: {kernel row name: launches}
    (bf16: the training main paths and the wide bf16 zoo step; float32:
    the goldens and the zoo smoke steps, the attention all on its float32
    tensor-core route, the ``_wide`` rows at Dk 192)."""
    import torch
    attention_grad_phase(dev, errs)
    torch.cuda.empty_cache()
    ssd_grad_phase(dev, errs)
    torch.cuda.empty_cache()
    out = train_golden_phase(dev)
    fwd, bwd, _ = train_main_phase(dev)
    out["flash_attention"] = fwd
    out["flash_attention_bwd"] = bwd
    for phase in (train_ssm_phase, train_zoo_phase):
        for row, n in phase(dev).items():
            out[row] = out.get(row, 0) + n
    train_cli_phase()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import os
    # train_main_path runs with deterministic algorithms, which need cuBLAS
    # set up so before its first use
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not ((SRC / "repro_torch").is_dir() and GOLDEN.is_file()
            and LOOP_GOLDEN.is_file() and SFP_GOLDEN.is_file()
            and SERVE_GOLDEN.is_file() and SSM_GOLDEN.is_file()
            and all(p.is_file() for p in ZOO_GOLDENS)
            and SWEEP_GOLDEN.is_file() and TRAIN_GOLDEN.is_file()
            and TRAIN_SSM_GOLDEN.is_file()):
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
    # Float32 results are compared on the card: no TF32 in PyTorch's own
    # products (the plain versions); the float32 attention kernels reach
    # float32 accuracy on the bf16 tensor cores (three bf16 parts, six
    # products), not through TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    golden = json.loads(GOLDEN.read_text())
    # theory.DEFAULT_NET.prop_slots: 0.5 us links, 4178-byte slots at 800 Gb/s
    prop_slots = 0.5e-6 / (4178 * 8 / 800e9)
    check(prop_slots == golden["prop_slots"], "prop_slots differs from golden")
    errs = {"segmented_cummax": 0.0, "jsq_scan": 0.0, "flash_attention": 0.0,
            "flash_attention_f32": 0.0, "flash_attention_f32_wide": 0.0,
            "flash_attention_f32_cuda_cores": 0.0,
            "flash_attention_bf16_cuda_cores": 0.0, "ssd_scan": 0.0,
            "ssd_scan_f32": 0.0, "ssd_scan_f32_cuda_cores": 0.0,
            "ssd_scan_bf16_cuda_cores": 0.0, "flash_attention_bwd": 0.0,
            "flash_attention_bwd_f32": 0.0, "flash_attention_bwd_wide": 0.0,
            "flash_attention_bwd_f32_wide": 0.0,
            "flash_attention_bwd_f32_cuda_cores": 0.0,
            "flash_attention_bwd_bf16_cuda_cores": 0.0, "ssd_scan_bwd": 0.0,
            "ssd_scan_bwd_f32": 0.0, "ssd_scan_bwd_cuda_cores": 0.0}

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
                      "walk_ns_per_cell", "campaign_launches", "f64_err",
                      "plain_f64_err") if x in k),
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
        # The zoo's attention shapes and the attention backward at the
        # training main path's (random inputs), here: profiler traces taken
        # after serve_profile's came back short of kernel events.
        attention_zoo_timing()
        kernels += attention_bwd_timing(errs,
                                        get_config("yi-6b").microbatch)
        torch.cuda.empty_cache()

    with Phase("serve_profile"):
        yi_profile()
        z_profile()
        m_profile()
    del yi_profile, z_profile, m_profile, yi_recs, z_recs, m_recs, ssd_rec
    zoo_f32, zoo_bf16 = zoo_phases(dev)
    train = training_phases(dev, errs)
    zoo = {"flash_attention": zoo_bf16, **zoo_f32}
    for k in kernels:
        k["launches"] += zoo.get(k["name"], 0) + train.get(k["name"], 0)
        if k["name"].startswith("flash_attention_bwd"):
            k["max_abs_err"] = max(k["max_abs_err"], errs[k["name"]])
    print(f"flash_attention launches with the zoo's and training's: zoo "
          f"{zoo}, training {train}", flush=True)
    with Phase("ssd_bwd_timing"):
        kernels += ssd_bwd_timing(errs, train)
    # The float32 tensor-core kernels ran on the main paths (the goldens
    # and the float32 train steps), their wide instances too (MLA's golden
    # and the train steps at Dk 192), and the bf16 backward's wide instance
    # (the bf16 step at Dk 192); no main path reaches the CUDA-core kernels
    # (every head of the zoo is within the tensor-core routes), whose rows
    # are timed at CUDA_CORE_SHAPE all the same.
    launched = {k["name"]: k["launches"] for k in kernels}
    check(all(launched[n] > 0 for n in (
              "flash_attention_f32", "flash_attention_bwd_f32",
              "flash_attention_f32_wide", "flash_attention_bwd_f32_wide",
              "flash_attention_bwd_wide", "ssd_scan_bwd",
              "ssd_scan_bwd_f32")),
          f"an attention or SSD kernel never launched on a main path: "
          f"{launched}")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
