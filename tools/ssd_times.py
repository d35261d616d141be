"""Card time of the SSD scan's routes at ``chip_smoke.py``'s timing shape
and of its backward's at the SSM train shapes, for comparing two trees of
the port on one card, and a bitwise check of the bf16 walk and of the
backward between two trees.

    python3 tools/ssd_times.py [--src SRC] [--reps N] [--tag TAG]
                               [--save FILE | --compare FILE]

SRC is a directory that holds ``repro_torch`` (default: this checkout's
``src``); its kernels are built from its own sources.  Inputs are random
normals from a seeded ``torch.Generator`` at Zamba2-2.7B's prefill, (B, L,
H, P, G, N) = (1, 2,048, 80, 64, 1, 64), dt in [0.01, 0.21] and A in
-[0.5, 1.5] (``chip_smoke.ssd_inputs``'s draws); each call returns y and
the final state.

It measures, in one process, ``device_ms``: the profiler time per call of
the kernels a call launches (one for a walk, three for the CUDA-core
route; a trace short of them is taken again, up to three times, else
null), for bf16 (the bf16 walk, 32 and 64 P columns a CTA) and float32
(the route ``kernel.route`` names for the tree: the float32 walk at 32 and
64 P columns, or the CUDA-core route), each result held to the plain
version first (bf16 2e-2; float32 5e-5 / 5e-4).  Then the backward
(``kernel.ssd_scan_bwd``, bf16, random dy) at Zamba2-2.7B's and
Mamba2-130M's train shapes, ``BWD_SHAPES``, on the route the tree takes
(named from the kernels in the trace), held to the plain ``ref.ssd_vjp``
at 2e-2 of each gradient's largest magnitude first: ``chip_smoke.
device_ms`` of its four launches, in all and by launch.  ``--save FILE``
writes the bf16 walk's outputs (y and the final state, both P tiles) at
three shapes (Zamba2-2.7B's, a ragged grouped one, Mamba2-130M's N = 128)
and the backward's at ``BWD_BITWISE`` (both routes), and ``--compare
FILE`` holds this tree's to a saved file bitwise.  It prints the card's
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
SHAPE = (1, 2048, 80, 64, 1, 64)
BITWISE_SHAPES = ((1, 2048, 80, 64, 1, 64), (2, 301, 8, 64, 2, 64),
                  (1, 2048, 24, 64, 1, 128))
KERNELS = {"wgmma": (r"\bssd_wgmma_kernel<", 1),
           "wgmma_f32": (r"\bssd_wgmma_f32_kernel<", 1),
           "cuda_cores": (r"\bssd_(chunk_state|state_carry|chunk_out)", 3)}
TOL = {"bfloat16": (2e-2, 2e-2), "float32": (5e-5, 5e-4)}
# (B, L, H, P, G, N): a microbatch of Zamba2-2.7B's and of Mamba2-130M's
# training main path.
BWD_SHAPES = ((1, 4096, 80, 64, 1, 64), (2, 2048, 24, 64, 1, 128))
# (B, L, H, P, G, N, dtype, final state) of the backward's bitwise check:
# bf16 on the tensor cores, bf16 past N = 128 and float32 on the CUDA cores.
BWD_BITWISE = ((1, 301, 8, 64, 2, 64, "bfloat16", True),
               (1, 301, 4, 100, 2, 200, "bfloat16", True),
               (2, 301, 8, 64, 2, 64, "float32", True))


def inputs(shape, dtype, seed):
    import torch
    B, L, H, P, G, N = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, L, H, P, generator=g)
    dt = 0.01 + torch.rand(B, L, H, generator=g) * 0.2
    A = -(0.5 + torch.rand(H, generator=g))
    Bm = torch.randn(B, L, G, N, generator=g)
    C = torch.randn(B, L, G, N, generator=g)
    return (x.to("cuda", dtype), dt.cuda(), A.cuda(), Bm.to("cuda", dtype),
            C.to("cuda", dtype))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tag", default="")
    ap.add_argument("--save")
    ap.add_argument("--compare")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssd_times: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import SSD_BWD_KERNELS, device_ms
    from repro_torch.kernels.ssd_scan import kernel, ops
    torch.backends.cuda.matmul.allow_tf32 = False
    N = SHAPE[5]
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        a = inputs(SHAPE, dtype, 0)
        route = kernel.route(dtype, N)
        tiles = (32, 64) if route != "cuda_cores" else (None,)
        for pt in tiles:
            def call():
                return kernel.ssd_scan(*a, final_state=True, ptile=pt)
            got = call()
            want = ops.ssd(*a, final_state=True, backend="torch")
            atol, rtol = TOL[name]
            if not all(torch.allclose(g.float(), w.float(), atol=atol,
                                      rtol=rtol) for g, w in zip(got, want)):
                raise RuntimeError(f"{name} {route} ptile {pt}: kernel != "
                                   f"plain")
            pat, per_call = KERNELS[route]
            rows.append(dict(dtype=name, route=route, ptile=pt,
                             device_ms=device_ms(call, args.reps, pat,
                                                 per_call=per_call)))
        del a
    from repro_torch.kernels.ssd_scan import ref
    for i, shape in enumerate(BWD_SHAPES):
        a = inputs(shape, torch.bfloat16, 200 + i)
        dy = torch.randn(a[0].shape, generator=torch.Generator().manual_seed(
            300 + i)).to("cuda", torch.bfloat16)

        def call():
            return kernel.ssd_scan_bwd(*a, dy)
        want = ref.ssd_vjp(*a, dy)
        for g, w in zip(call(), want):
            scale = float(w.float().abs().max())
            if float((g.float() - w.float()).abs().max()) > 2e-2 * scale:
                raise RuntimeError(f"backward {shape}: kernel != plain")
        total, by = device_ms(call, args.reps, SSD_BWD_KERNELS, per_call=4,
                              split=True)
        route = ("wgmma" if any(k.startswith("ssd_bwdw_") for k in by)
                 else "cuda_cores")
        rows.append(dict(dtype="bfloat16", route=f"bwd_{route}",
                         shape=list(shape), device_ms=total,
                         device_ms_by_launch=by))
        del a, dy, want
    bitwise = None
    if args.save or args.compare:
        outs = []
        for i, shape in enumerate(BITWISE_SHAPES):
            a = inputs(shape, torch.bfloat16, 100 + i)
            for pt in (32, 64):
                outs.append([t.cpu() for t in kernel.ssd_scan(
                    *a, final_state=True, ptile=pt)])
        for i, (*shape, dt, fs) in enumerate(BWD_BITWISE):
            a = inputs(shape, getattr(torch, dt), 400 + i)
            g = torch.Generator().manual_seed(500 + i)
            dy = torch.randn(a[0].shape, generator=g).to("cuda", a[0].dtype)
            dh = (torch.randn(shape[0], shape[2], shape[5], shape[3],
                              generator=g).cuda() if fs else None)
            outs.append([t.cpu() for t in kernel.ssd_scan_bwd(*a, dy, dh)])
        if args.save:
            torch.save(outs, args.save)
        else:
            saved = torch.load(args.compare)
            bitwise = len(saved) == len(outs) and all(
                torch.equal(g, w) for o, s in zip(outs, saved)
                for g, w in zip(o, s))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    print(json.dumps({"tag": args.tag, "src": args.src, "rows": rows,
                      "bitwise_to_saved": bitwise}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
