"""Distance of the SSD scan's bf16 gradients from float64: the backward
kernel's, the plain version's (``ref.ssd_vjp``: a group's heads summed in
float32, one rounding to bf16) and the plain version's earlier form (B and
C repeated to every head in bf16 before the cast, so that each head's dB
and dC were rounded to bf16 before the group's sum).

    python3 tools/ssd_bwd_rounding.py [--device cuda|cpu] [--lens 1,37,2048]

Inputs are ``chip_smoke.ssd_grad_inputs``'s draws (seed 3) in bf16 at
Mamba2-130M's heads, (H, P, G, N) = (24, 64, 1, 128), and Zamba2-2.7B's,
(80, 64, 1, 64), batch 1, chunk 64.  The float64 gradient is ``ssd_vjp``
of the same bf16 values cast to float64.  For each case and gradient it
prints the largest distance from float64 over the float64 gradient's
largest magnitude (the scale of ``chip_smoke.py``'s 2e-2 tolerance), then
one JSON line of them all.  With ``--device cpu`` the kernel's column is
null (it runs on the card only).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HEADS = {"mamba2-130m": (24, 64, 1, 128), "zamba2-2.7b": (80, 64, 1, 64)}
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def per_head_vjp(x, dt, A, Bm, C, dy, chunk):
    """The plain gradient as the earlier ``ref._heads`` gave it: B and C
    repeated to every head in their own dtype, each head's gradient rounded
    to it, then summed over the group's heads."""
    from repro_torch.kernels.ssd_scan import ref
    G = Bm.shape[2]
    rep = x.shape[2] // G
    Be, Ce = (t.repeat_interleave(rep, dim=2) for t in (Bm, C))
    g = ref.ssd_vjp(x, dt, A, Be, Ce, dy, chunk=chunk)

    def group_sum(t):
        return t.reshape(*t.shape[:2], G, rep, t.shape[-1]).sum(3)
    return (*g[:3], group_sum(g[3]), group_sum(g[4]))


def rel_errs(got, exact):
    """Each gradient's largest distance from ``exact`` over the largest
    magnitude of ``exact`` (over 1 where it is 0: dA at L = 1)."""
    return [float((g.double() - e).abs().max()) / (float(e.abs().max())
                                                  or 1.0)
            for g, e in zip(got, exact)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--lens", default="1,37,2048")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    import chip_smoke
    from repro_torch.kernels.ssd_scan import kernel, ref
    if args.device == "cuda" and not torch.cuda.is_available():
        print("ssd_bwd_rounding: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device(args.device, 0) if args.device == "cuda" else \
        torch.device("cpu")
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    gen = torch.Generator().manual_seed(3)
    rows = []
    for model, (H, P, G, N) in HEADS.items():
        for L in map(int, args.lens.split(",")):
            shape = (1, L, H, P, G, N)
            ins, dy, _ = chip_smoke.ssd_grad_inputs(shape, torch.bfloat16,
                                                    gen, dev)
            exact = ref.ssd_vjp(*(t.double() for t in ins), dy.double())
            errs = {"plain": rel_errs(ref.ssd_vjp(*ins, dy), exact),
                    "plain_per_head": rel_errs(
                        per_head_vjp(*ins, dy, 64), exact),
                    "kernel": (rel_errs(kernel.ssd_scan_bwd(*ins, dy), exact)
                               if dev.type == "cuda" else None)}
            rows.append(dict(model=model, shape=list(shape), **{
                k: None if v is None else dict(zip(NAMES, v))
                for k, v in errs.items()}))
            for k, v in errs.items():
                if v is not None:
                    print(f"{model} {shape} {k}: " + ", ".join(
                        f"{n} {e:.3g}" for n, e in zip(NAMES, v)),
                        flush=True)
            del ins, dy, exact
    print(json.dumps({"ssd_bwd_rounding": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
