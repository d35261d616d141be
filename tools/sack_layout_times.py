"""Device time of the two SACK kernels under other launch shapes, for
choosing them on one card.

    python3 tools/sack_layout_times.py [--variants SPEC ...]

Each variant is ``TAG`` or ``TAG:NAME=VALUE,...``: a copy of this checkout's
``src`` under ``build/sack_layouts/TAG`` with the named constants changed:
``SACK_TILE`` and ``SACK_WARPS`` in ``kernels/slot_step/kernel.py`` (the
bitmap bytes a ``sack_update_scan`` CTA copies, and the flows a CTA is
given when ``sack_layout`` sizes the grid: 16 gives each warp of the
kernel's 8 two flows) or ``ADV_THREADS`` in ``csrc/slot_step.cu``
(``sack_advance``'s block).  Each copy builds its own kernels, all at
once.  The operands are ``tools/slot_wrapper_times.py``'s SACK scoreboard
(4 rows of 32,768 packets, 128 flows, 640 lanes).  The variants run in the
order given and then in reverse, each in a process of its own; a run holds
both kernels to their plain versions and prints one JSON line of device ms
(profiler, three windows of 300 calls).  It needs a CUDA card and exits 2
without one.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "sack_layouts"
FILES = {"SACK_TILE": "repro_torch/kernels/slot_step/kernel.py",
         "SACK_WARPS": "repro_torch/kernels/slot_step/kernel.py",
         "ADV_THREADS": "repro_torch/csrc/slot_step.cu"}
DEFAULT = ("base", "two_flows_a_warp:SACK_TILE=4096,SACK_WARPS=16",
           "tile_4096:SACK_TILE=4096", "tile_1024:SACK_TILE=1024",
           "tile_512:SACK_TILE=512", "adv_64:ADV_THREADS=64",
           "adv_128:ADV_THREADS=128")


def make_copy(spec: str) -> tuple:
    """(tag, src) of a variant: ``src`` copied and its constants set."""
    tag, _, sets = spec.partition(":")
    src = OUT / tag / "src"
    shutil.rmtree(OUT / tag, ignore_errors=True)
    shutil.copytree(ROOT / "src", src)
    for item in filter(None, sets.split(",")):
        name, value = item.split("=")
        path = src / FILES[name]
        text = path.read_text()
        pat = (rf"(constexpr int {name} = )\d+" if path.suffix == ".cu"
               else rf"(?m)^({name} = )\d+")
        text, n = re.subn(pat, rf"\g<1>{int(value)}", text)
        if n != 1:
            raise SystemExit(f"{name} not found once in {path}")
        path.write_text(text)
    return tag, src


def time_tree(src: str, tag: str) -> dict:
    """Device ms of both SACK wrappers of the tree at ``src``."""
    sys.path.insert(0, str(Path(src).resolve()))
    sys.path.insert(0, str(ROOT / "tools"))
    import torch
    from torch.profiler import ProfilerActivity, profile
    import slot_wrapper_times as w
    from repro_torch.kernels.slot_step import ops
    o = w.operands(torch.device("cuda", 0))
    out = {"tag": tag}
    for name in ("sack_update_scan", "sack_advance"):
        fn = getattr(ops, name)
        args = [o[k] for k in w.CALLS[name][0]]
        got, want = fn(*args), fn(*args, backend="torch")
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if not all(torch.equal(g, x) for g, x in zip(got, want)):
            raise SystemExit(f"{tag} {name}: kernel != plain")
        for _ in range(50):
            fn(*args)
        torch.cuda.synchronize()
        out[name] = []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(300):
                    fn(*args)
                torch.cuda.synchronize()
            out[name].append(sum(
                getattr(e, "device_time_total", 0.0)
                for e in prof.key_averages()
                if f"{name}_kernel" in e.key) / 300 / 1e3)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(DEFAULT))
    ap.add_argument("--time", nargs=2, metavar=("SRC", "TAG"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sack_layout_times: needs a CUDA card", file=sys.stderr)
        return 2
    if args.time:
        print(json.dumps(time_tree(*args.time)), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    copies = [make_copy(spec) for spec in args.variants]
    builds = [subprocess.Popen(
        [sys.executable, "-c", "from repro_torch.kernels import _build; "
         "_build.load('slot_step')"], cwd=src) for _, src in copies]
    if any(b.wait() != 0 for b in builds):
        return 1
    for tag, src in copies + copies[::-1]:
        run = subprocess.run([sys.executable, __file__, "--time", str(src),
                              tag], capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stderr[-2000:], file=sys.stderr)
            return 1
        print(run.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
