"""Card seconds of the work ``chip_smoke.py``'s depth cuts took out against
the work its SSD-gradient phases and the cut paths now run, in one process
in the order (now, cut, cut, now), so that a host that slows or speeds up
during the run weighs on both alike (the first part also pays the
process's warm-up, which weighs on ``now``).

    python3 tools/smoke_cuts_clock.py

The two arms, each through ``chip_smoke``'s own phase functions:

- ``cut``: the slotted engine's fig 3 point with ``switch_pkt`` (one fused
  dispatch, its serial run and its plain run; ``loop_group``), Qwen3-MoE-
  30B-A3B's serving main path at 24 layers and Yi-6B's training main path
  at 8 layers;
- ``now``: Qwen3-MoE at ``QWEN_LAYERS``, Yi-6B at ``TRAIN_LAYERS``, the
  Mamba2-130M train golden, ``ssd_grad_vs_plain``, ``train_ssm_main_path``
  and ``ssd_bwd_timing``.

The rest of ``chip_smoke.py`` runs the same work either way (the kernels'
build aside: one library more, built in parallel with the others).  It
prints each part's wall seconds, the card's name and power limit, then one
JSON line.  It needs a CUDA card and exits 2 without one.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CUT_QWEN_LAYERS = 24
CUT_TRAIN_LAYERS = 8


def main() -> int:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests"), str(ROOT)]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("smoke_cuts_clock: no CUDA device is visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import lb_schemes
    from repro_torch.kernels import _build
    from repro_torch.net import loopsim, workloads
    from repro_torch.net.topology import FatTree, LinkState, rho_max

    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    tree = FatTree(8)
    loop_golden = json.loads(cs.LOOP_GOLDEN.read_text())
    lwl = workloads.permutation(tree, 256, np.random.default_rng(1))
    links3 = LinkState.random_failures(tree, 0.01, seed=42)
    rho3 = float(rho_max(tree, links3, lwl.flow_src, lwl.flow_dst))
    cfg3 = loopsim.LoopConfig(max_slots=cs.LOOP_MAX_SLOTS, rho=rho3,
                              rto_slots=300)
    now_layers = cs.QWEN_LAYERS, cs.TRAIN_LAYERS

    def fig3_switch_pkt():
        items = [(tree, lwl, lb_schemes.by_name("switch_pkt"), cfg3,
                  list(cs.LOOP_SEEDS), links3, None, None)]
        slot = {name: 0 for name in cs.SLOT_KERNELS + cs.SACK_KERNELS}
        cs.loop_group("fig3/switch_pkt", items, loop_golden["points"], slot,
                      {"segmented_cummax": 0, "jsq_scan": 0},
                      ("enqueue", "segmented_cummax"))

    def qwen(layers):
        cs.serve_main_phase(
            dev, "zoo_serve_main_path qwen3-moe-30b-a3b", "qwen3-moe-30b-a3b",
            cs.SERVE_LENS, cs.GREEDY_BATCH, {"flash_attention": layers},
            {"n_layers": layers}, None)

    def yi(layers):
        cs.TRAIN_LAYERS = layers
        try:
            cs.train_main_phase(dev)
        finally:
            cs.TRAIN_LAYERS = now_layers[1]

    def ssd_gradient_phases():
        errs = {"ssd_scan_bwd": 0.0, "ssd_scan_bwd_f32": 0.0}
        cs.reset_train_counts()
        with cs.Phase("train_golden (Mamba2-130M)"):
            cs.train_golden_check(json.loads(cs.TRAIN_SSM_GOLDEN.read_text()),
                                  dev)
        cs.ssd_grad_phase(dev, errs)
        cs.train_ssm_phase(dev)
        with cs.Phase("ssd_bwd_timing"):
            cs.ssd_bwd_timing(errs, {})

    arms = {
        "cut": (("fig3/switch_pkt", fig3_switch_pkt),
                (f"qwen3-moe {CUT_QWEN_LAYERS} layers",
                 lambda: qwen(CUT_QWEN_LAYERS)),
                (f"yi-6b train {CUT_TRAIN_LAYERS} layers",
                 lambda: yi(CUT_TRAIN_LAYERS))),
        "now": ((f"qwen3-moe {now_layers[0]} layers",
                 lambda: qwen(now_layers[0])),
                (f"yi-6b train {now_layers[1]} layers",
                 lambda: yi(now_layers[1])),
                ("ssd gradient phases", ssd_gradient_phases)),
    }
    runs = []
    for arm in ("now", "cut", "cut", "now"):
        parts = {}
        for label, fn in arms[arm]:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            parts[label] = time.perf_counter() - t0
            print(f"smoke_cuts_clock {arm}: {label} {parts[label]:.2f} s",
                  flush=True)
        runs.append(dict(arm=arm, seconds=sum(parts.values()), parts=parts))
        print(f"smoke_cuts_clock {arm}: {runs[-1]['seconds']:.2f} s",
              flush=True)
    total = {a: sum(r["seconds"] for r in runs if r["arm"] == a)
             for a in arms}
    print(json.dumps({"smoke_cuts_clock": runs, "total": total}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
