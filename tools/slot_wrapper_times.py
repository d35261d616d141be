"""Host and card time of one call of the slot-step wrappers, for comparing
two trees of the port on one card.

    python3 tools/slot_wrapper_times.py [--src SRC] [--reps N] [--tag TAG]

SRC is a directory that holds ``repro_torch`` (default: this checkout's
``src``); its kernels are built from its own sources.  The operands are the
k=8 slot's largest enqueue input (6 rows of 640 lanes and 640 queues,
195-packet buffers, 4 ports) and its SACK scoreboard (4 rows of 32,768
packets, 128 flows of 256, 640 lanes), drawn with numpy from a fixed seed,
so two trees get the same ones.  For each of ``enqueue``, ``jsq_pick``,
``agg_jsq_enqueue``, ``sack_update_scan`` and ``sack_advance`` (through
``ops``, as the engine calls them) it measures, in one process:

- ``call_ms``: CUDA events around N back-to-back calls, per call (the
  host's time where the kernel is shorter, as ``chip_smoke.py`` reports);
- ``host_us``: the host's wall time of N calls before the final
  synchronize, per call;
- ``python_us``: the same with the library call replaced by a stub that
  returns 0 (the wrapper's Python part: checks, output tensors, scratch);
- ``device_ms``: profiler kernel time per call;

and ``launch_floor_device_ms``, the profiler time of a 1-element ``add_``.
It prints the card's name and power limit, then one JSON line.  It needs a
CUDA card and exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def operands(dev, B=6, M=640, cap=195, h=4, n_aggs=32, seed=0):
    import numpy as np
    import torch
    r = np.random.default_rng(seed)
    t = torch.from_numpy
    P = 32768
    o = dict(qcnt=r.integers(0, cap, (B, M)).astype(np.int32),
             qbuf=r.integers(-1, P, (B, M, cap)).astype(np.int32),
             qhead=r.integers(0, cap, (B, M)).astype(np.int32),
             qbase=r.integers(0, M - h, (B, M)).astype(np.int32),
             ids=r.integers(0, P, (B, M)).astype(np.int32),
             dead=r.random((B, M, h)) < 0.2,
             pad_pen=np.zeros((B, h), np.float32),
             alive=r.random((B, M)) < 0.95,
             apk=np.where(r.random((B, M)) < 0.8,
                          r.integers(0, P, (B, M)), -1).astype(np.int32),
             aq=r.integers(0, M // 4, (B, M)).astype(np.int32) * 4,
             asw=r.integers(0, n_aggs, (B, M)).astype(np.int32),
             seed_lo=r.integers(0, 2**32, B).astype(np.int64),
             seed_hi=r.integers(0, 2**32, B).astype(np.int64))
    o["avalid"] = o["apk"] >= 0
    o["to_agg"] = o["avalid"] & (r.random((B, M)) < 0.5)
    # The SACK scoreboard: 4 rows of 128 flows of 256 packets back to back,
    # acks anywhere in [0, 256], every 4th flow received whole, 640 lanes
    # delivering half the time.
    SB, SF, fs = 4, 128, 256
    o["fsize"] = np.full((SB, SF), fs, np.int32)
    o["pbase"] = np.broadcast_to(np.arange(SF, dtype=np.int32) * fs,
                                 (SB, SF))
    o["f_cum"] = r.integers(0, fs + 1, (SB, SF)).astype(np.int32)
    o["p_recv"] = r.random((SB, SF * fs)) < 0.8
    o["p_recv"].reshape(SB, SF, fs)[:, ::4] = True
    o["spk"] = r.integers(0, SF * fs, (SB, M)).astype(np.int32)
    o["deliv"] = r.random((SB, M)) < 0.5
    return {k: t(np.ascontiguousarray(v)).to(dev) for k, v in o.items()}


CALLS = {
    "enqueue": (("qbuf", "qhead", "qcnt", "alive", "apk", "aq", "avalid"),
                (), dict(cap=195, ecn_thresh=97)),
    "jsq_pick": (("qcnt", "qbase", "ids", "dead", "pad_pen", "seed_lo",
                  "seed_hi"), (77,), dict(site=3, quanta=None, cap=195)),
    "agg_jsq_enqueue": (("qbuf", "qhead", "qcnt", "alive", "apk", "aq",
                         "to_agg", "asw", "dead", "pad_pen", "seed_lo",
                         "seed_hi"), (77,),
                        dict(site=4, quanta=None, cap=195, ecn_thresh=97,
                             off1=128, h=4)),
    "sack_update_scan": (("p_recv", "spk", "deliv", "f_cum", "fsize",
                          "pbase"), (), {}),
    "sack_advance": (("p_recv", "f_cum", "fsize", "pbase"), (), {}),
}


class _Stub:
    """Stands for the kernels' library: every entry point returns 0."""

    def __getattr__(self, name):
        return lambda *a: 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=2000)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("slot_wrapper_times: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.slot_step import kernel as slot_kernel
    from repro_torch.kernels.slot_step import ops as slot_ops
    dev = torch.device("cuda", 0)
    o = operands(dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    out = {"tag": args.tag, "src": args.src, "card": card,
           "shape": [6, 640, 640, 195], "sack_shape": [4, 32768, 640, 128],
           "reps": args.reps, "wrappers": {}}
    n = args.reps
    for name, (keys, extra, kw) in CALLS.items():
        fn = getattr(slot_ops, name)
        a = [o[k] for k in keys] + list(extra)

        def call():
            return fn(*a, **kw)

        for _ in range(20):
            call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        host = (time.perf_counter() - t0) / n * 1e6
        end.record()
        torch.cuda.synchronize()
        call_ms = start.elapsed_time(end) / n
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(200):
                call()
            torch.cuda.synchronize()
        dev_us = sum(getattr(e, "device_time_total", 0.0)
                     for e in prof.key_averages()
                     if f"{name}_kernel" in e.key)
        real = slot_kernel._lib
        slot_kernel._lib = lambda: _Stub()
        try:
            for _ in range(20):
                call()
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            python = (time.perf_counter() - t0) / n * 1e6
        finally:
            slot_kernel._lib = real
        torch.cuda.synchronize()
        out["wrappers"][name] = dict(call_ms=call_ms, host_us=host,
                                     python_us=python,
                                     device_ms=dev_us / 200 / 1e3)
    one = torch.zeros(1, device=dev)
    for _ in range(20):
        one.add_(1.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(200):
            one.add_(1.0)
        torch.cuda.synchronize()
    out["launch_floor_device_ms"] = sum(
        getattr(e, "device_time_total", 0.0) for e in prof.key_averages()
        if "elementwise_kernel" in e.key) / 200 / 1e3
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
