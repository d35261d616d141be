"""Card time of the segmented running max (``segmented_cummax``) at the fast
engine's largest input, for comparing two trees of the port on one card.

    python3 tools/cummax_times.py [--src SRC] [--reps N] [--tag TAG]

SRC is a directory that holds ``repro_torch`` (default: this checkout's
``src``); its kernel is built from its own sources.  The input has the
shape of the largest call the k=8 fat tree's all-to-all (32 packets a
pair, seeds 0-1, three schemes fused) makes: (6, 520,192) float32 values
from a seeded ``torch.Generator`` with bool flags at about 1 in 1,000
positions (the kernel's work does not depend on the values).  It measures,
in one process:

- ``call_ms``: CUDA events around N back-to-back calls, per call;
- ``device_ms``: profiler time of the scan's three kernels per call.

The result is held bitwise to the plain version's.  It prints the card's
name and power limit, then one JSON line.  It needs a CUDA card and exits
2 without one.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (6, 520_192)
KERNELS = re.compile(r"\b(tile_aggregate|scan_aggregates|tile_apply)\(")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("cummax_times: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.lindley import ops
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    v = (torch.randn(SHAPE, generator=g) * 100).to(dev)
    f = (torch.rand(SHAPE, generator=g) < 1e-3)
    f[:, 0] = True
    f = f.to(dev)
    want = ops.segmented_cummax(v, f, backend="torch")
    got = ops.segmented_cummax(v, f)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise RuntimeError("segmented_cummax: kernel != plain")
    n = args.reps
    for _ in range(5):
        ops.segmented_cummax(v, f)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        ops.segmented_cummax(v, f)
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / n
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            ops.segmented_cummax(v, f)
        torch.cuda.synchronize()
    dev_us = sum(getattr(e, "device_time_total", 0.0)
                 for e in prof.key_averages() if KERNELS.search(e.key))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    print(json.dumps({"tag": args.tag, "src": args.src, "card": card,
                      "shape": list(SHAPE), "reps": n, "call_ms": call_ms,
                      "device_ms": dev_us / n / 1e3}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
