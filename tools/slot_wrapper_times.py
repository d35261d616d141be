"""Host and card time of one call of the slot-step wrappers, for comparing
two trees of the port on one card.

    python3 tools/slot_wrapper_times.py [--src SRC] [--reps N] [--tag TAG]
        [--only LABEL,...]

SRC is a directory that holds ``repro_torch`` (default: this checkout's
``src``); its kernels are built from its own sources.  The operands are the
k=8 slot's largest enqueue input (6 rows of 640 lanes and 640 queues,
195-packet buffers, 4 ports) and its SACK scoreboard (4 rows of 32,768
packets, 128 flows of 256, 640 lanes), drawn with numpy from a fixed seed,
so two trees get the same ones; ``jsq_pick@engine`` and
``agg_jsq_enqueue@engine`` are the picks at the engine's own largest calls
(the edge pick: 2 rows of 128 choosers, 4 ports, 640-queue rows; the agg
pick: the first 2 rows of the enqueue input); ``jsq_pick@k16`` a k=16
fabric's edge pick (2 rows of 1,024 choosers, 8 ports, 5,120-queue rows)
and ``jsq_pick@h64`` one of 64 ports (2 rows of 128 choosers, 1,024-queue
rows).  For each of ``enqueue``, ``jsq_pick``, ``agg_jsq_enqueue``,
``sack_update_scan``, ``sack_advance`` and the four ``@`` calls (through
``ops``, as the engine calls them; ``--only`` names some of them) it
measures, in one process:

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
    # The engine's edge pick: 2 rows of 128 choosers over 640-queue rows
    # (drawn last, so the operands above stay those of earlier versions).
    EB, EM = 2, 128
    o["e_qcnt"] = o["qcnt"][:EB]
    o["e_qbase"] = r.integers(0, M - h, (EB, EM)).astype(np.int32)
    o["e_ids"] = r.integers(0, P, (EB, EM)).astype(np.int32)
    o["e_dead"] = r.random((EB, EM, h)) < 0.2
    o["e_pad_pen"] = o["pad_pen"][:EB]
    o["e_seed_lo"], o["e_seed_hi"] = o["seed_lo"][:EB], o["seed_hi"][:EB]
    # The engine's agg pick: the first 2 rows of the enqueue input.
    for k in ("qbuf", "qhead", "qcnt", "alive", "apk", "aq", "to_agg", "asw",
              "dead", "pad_pen", "seed_lo", "seed_hi"):
        o["a_" + k] = o[k][:EB]
    # A k=16 fabric's edge pick: 2 rows of 1,024 choosers, 8 ports, rows
    # of 5,120 queues.
    KB, KM, KH, KQ = 2, 1024, 8, 5120
    o["k_qcnt"] = r.integers(0, cap, (KB, KQ)).astype(np.int32)
    o["k_qbase"] = r.integers(0, KQ - KH, (KB, KM)).astype(np.int32)
    o["k_ids"] = r.integers(0, P, (KB, KM)).astype(np.int32)
    o["k_dead"] = r.random((KB, KM, KH)) < 0.2
    o["k_pad_pen"] = np.zeros((KB, KH), np.float32)
    o["k_seed_lo"], o["k_seed_hi"] = o["seed_lo"][:KB], o["seed_hi"][:KB]
    # A pick of 64 ports (two a lane): 2 rows of 128 choosers over rows of
    # 1,024 queues.
    WB, WM, WH, WQ = 2, 128, 64, 1024
    o["w_qcnt"] = r.integers(0, cap, (WB, WQ)).astype(np.int32)
    o["w_qbase"] = r.integers(0, WQ - WH, (WB, WM)).astype(np.int32)
    o["w_ids"] = r.integers(0, P, (WB, WM)).astype(np.int32)
    o["w_dead"] = r.random((WB, WM, WH)) < 0.2
    o["w_pad_pen"] = np.zeros((WB, WH), np.float32)
    o["w_seed_lo"], o["w_seed_hi"] = o["seed_lo"][:WB], o["seed_hi"][:WB]
    return {k: t(np.ascontiguousarray(v)).to(dev) for k, v in o.items()}


PICK = ("qcnt", "qbase", "ids", "dead", "pad_pen", "seed_lo", "seed_hi")
AGG = ("qbuf", "qhead", "qcnt", "alive", "apk", "aq", "to_agg", "asw", "dead",
       "pad_pen", "seed_lo", "seed_hi")
PICK_KW = dict(site=3, quanta=None, cap=195)
AGG_KW = dict(site=4, quanta=None, cap=195, ecn_thresh=97, off1=128, h=4)
# label: (wrapper, operand keys, extra arguments, keywords)
CALLS = {
    "enqueue": ("enqueue", ("qbuf", "qhead", "qcnt", "alive", "apk", "aq",
                            "avalid"), (), dict(cap=195, ecn_thresh=97)),
    "jsq_pick": ("jsq_pick", PICK, (77,), PICK_KW),
    "agg_jsq_enqueue": ("agg_jsq_enqueue", AGG, (77,), AGG_KW),
    "sack_update_scan": ("sack_update_scan", ("p_recv", "spk", "deliv",
                                              "f_cum", "fsize", "pbase"),
                         (), {}),
    "sack_advance": ("sack_advance", ("p_recv", "f_cum", "fsize", "pbase"),
                     (), {}),
    "jsq_pick@engine": ("jsq_pick", tuple("e_" + k for k in PICK), (77,),
                        PICK_KW),
    "agg_jsq_enqueue@engine": ("agg_jsq_enqueue", tuple("a_" + k for k in AGG),
                               (77,), AGG_KW),
    "jsq_pick@k16": ("jsq_pick", tuple("k_" + k for k in PICK), (77,),
                     PICK_KW),
    "jsq_pick@h64": ("jsq_pick", tuple("w_" + k for k in PICK), (77,),
                     PICK_KW),
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
    ap.add_argument("--only", default="",
                    help="comma-separated labels of CALLS to time (all)")
    args = ap.parse_args()
    only = [k for k in args.only.split(",") if k]
    if any(k not in CALLS for k in only):
        ap.error(f"--only: labels are {', '.join(CALLS)}")
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
           "engine_pick_shape": [2, 128, 4, 640],
           "engine_agg_shape": [2, 640, 640, 195, 4],
           "k16_pick_shape": [2, 1024, 8, 5120],
           "h64_pick_shape": [2, 128, 64, 1024],
           "reps": args.reps, "wrappers": {}}
    n = args.reps
    for label, (name, keys, extra, kw) in CALLS.items():
        if only and label not in only:
            continue
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
        out["wrappers"][label] = dict(call_ms=call_ms, host_us=host,
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
