"""Card time of the JSQ arbitration scan on the fast engine's largest grid,
for comparing two trees of the port on one card.

    python3 tools/jsq_scan_times.py [--src SRC] [--reps N] [--tag TAG]

SRC is a directory that holds ``repro_torch`` (default: this checkout's
``src``); its kernels are built from its own sources.  The grid is the
largest one that the k=8 fat tree's all-to-all (32 packets a pair,
``switch_pkt_ar``, seeds 0-1) hands ``jsq_scan``: (2, 32, 57,408) cells of
4 ports, the same in every tree whose engine is unchanged.  It measures, in
one process:

- ``call_ms``: CUDA events around N back-to-back calls, per call;
- ``device_ms``: profiler kernel time per call;
- ``no_tail_ms``: ``call_ms`` of the same grid with every row's last cell
  occupied, so that each row walks all its cells and has no tail;
- ``walked``: the longest walked prefix of the grid (its rows' last
  occupied cell, plus one).

Each result is held bitwise to the first call's.  It prints the card's
name and power limit, then one JSON line.  It needs a CUDA card and exits
2 without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("jsq_scan_times: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import lb_schemes
    from repro_torch.kernels.jsq_scan import ops as jsq_ops
    from repro_torch.net import fastsim, workloads
    from repro_torch.net.topology import FatTree
    dev = torch.device("cuda", 0)
    tree = FatTree(8)
    largest = []
    orig = jsq_ops.jsq_scan

    def record(*a, **kw):
        if not largest or a[0].numel() > largest[0][0].numel():
            largest[:] = [a]
        return orig(*a, **kw)

    jsq_ops.jsq_scan = record
    try:
        fastsim.simulate_batch(tree, workloads.all_to_all(tree, 32),
                               lb_schemes.by_name("switch_pkt_ar"), [0, 1],
                               prop_slots=0.5e-6 / (4178 * 8 / 800e9),
                               device=dev)
    finally:
        jsq_ops.jsq_scan = orig
    grid = [None if a is None else a.contiguous() for a in largest[0][:5]]
    ok_walk = grid[1].clone()
    ok_walk[..., -1] = True
    no_tail = [grid[0], ok_walk] + grid[2:]
    pad = grid[0].shape[-1]
    idx = torch.arange(pad, device=dev)
    walked = int(torch.where(grid[1], idx, -1).amax()) + 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    n = args.reps

    def call_ms(g):
        want = jsq_ops.jsq_scan(*g)
        for _ in range(3):
            jsq_ops.jsq_scan(*g)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            got = jsq_ops.jsq_scan(*g)
        end.record()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise RuntimeError("jsq_scan: two calls on one grid differ")
        return start.elapsed_time(end) / n

    ms = call_ms(grid)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            jsq_ops.jsq_scan(*grid)
        torch.cuda.synchronize()
    dev_us = sum(getattr(e, "device_time_total", 0.0)
                 for e in prof.key_averages() if "jsq_scan_kernel" in e.key)
    out = {"tag": args.tag, "src": args.src, "card": card,
           "shape": list(grid[2].shape), "walked": walked, "reps": n,
           "call_ms": ms, "device_ms": dev_us / n / 1e3,
           "no_tail_ms": call_ms(no_tail)}
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
