"""Card time of the flash-attention kernels (forward and backward) at the
shapes of ``chip_smoke.py``'s timing rows, for comparing two trees of the
port on one card.

    python3 tools/attn_times.py [--src SRC] [--reps N] [--tag TAG]

SRC is a directory that holds ``repro_torch`` (default: this checkout's
``src``); its kernels are built from its own sources.  Inputs are random
normals from a seeded ``torch.Generator``, causal, in two shapes:

- ``train``: Yi-6B's training microbatch, (B, Hq, Hkv, S, D) = (1, 32, 4,
  4,096, 128) for the backward and its first 2,048 positions for the
  forward (the serving rows' shape);
- ``mla``: DeepSeek-V3's MLA prefill, (1, 128, 128, 511, 511), Dk 192,
  Dv 128 (the ``_wide`` rows, or the CUDA-core route where the tree has no
  tensor-core instance for it).

For each shape, dtype (bf16, float32) and direction it measures, in one
process, ``device_ms``: the profiler time per call of the kernels the call
launches (the backward given the forward's log-sum-exp, as autograd gives
it), beside the route ``kernel.route`` or ``route_bwd`` names.  Each
result is held to the plain version first (bf16 2e-2, float32 2e-5
forward and 1e-4 backward, of each gradient's largest magnitude).  It
prints the card's name and power limit, then one JSON line.  It needs a
CUDA card and exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"train": (1, 32, 4, 4096, 128, 128),
          "mla": (1, 128, 128, 511, 192, 128)}
FWD_POSITIONS = {"train": 2048, "mla": 511}
TOL = {"fwd": {"float32": 2e-5, "bfloat16": 2e-2},
       "bwd": {"float32": 1e-4, "bfloat16": 2e-2}}


def device_ms(fn, reps):
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "device_time_total", 0.0)
               for e in prof.key_averages()) / reps / 1e3


def close(got, want, tol):
    import torch
    return all(torch.allclose(g.float(), w.float(), rtol=tol,
                              atol=tol * (float(w.float().abs().max()) or 1.0))
               for g, w in zip(got, want))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("attn_times: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.flash_attn import kernel, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    rows = []
    for label, (B, Hq, Hkv, S, D, Dv) in SHAPES.items():
        base = [torch.randn(s, generator=g) for s in (
            (B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, Dv), (B, Hq, S, Dv))]
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            q, k, v, do = (t.to("cuda", dtype) for t in base)
            n = FWD_POSITIONS[label]
            qf, kf, vf = q[:, :, :n], k[:, :, :n], v[:, :, :n]
            got = kernel.flash_attention(qf, kf, vf)
            if not close([got], [ref.mha(qf, kf, vf) if Dv == D else
                                 ref.mha_chunked(qf, kf, vf)],
                         TOL["fwd"][name]):
                raise RuntimeError(f"{label} {name} forward: kernel != plain")
            fwd = device_ms(lambda: kernel.flash_attention(qf, kf, vf),
                            args.reps)
            out, lse = kernel.flash_attention(q, k, v, return_lse=True)
            grads = kernel.flash_attention_bwd(q, k, v, out, do, lse)
            if not close(grads, ref.mha_vjp(q, k, v, do), TOL["bwd"][name]):
                raise RuntimeError(f"{label} {name} backward: kernel != "
                                   f"plain")
            bwd = device_ms(lambda: kernel.flash_attention_bwd(
                q, k, v, out, do, lse), args.reps)
            rows.append(dict(
                shape=label, dtype=name,
                fwd_route=kernel.route(dtype, D, Dv), fwd_device_ms=fwd,
                bwd_route=kernel.route_bwd(dtype, D, Dv),
                bwd_device_ms=bwd))
            del q, k, v, do, out, lse, grads, got
            torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    print(json.dumps({"tag": args.tag, "src": args.src, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
