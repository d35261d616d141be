"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each timed on its own line; any failure exits non-zero:

1. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once);
2. hold each kernel bitwise against its plain PyTorch version on the card:
   ``segmented_cummax`` on random inputs at the engine's sizes and flag
   densities, ``jsq_scan`` on the grids the k=8 permutation and all-to-all
   points give it (edge and agg layers, ``jsq`` and ``jsq_quant``);
3. drive the fast engine's main path: on the paper's k=8 fat tree, the
   1 MB inter-pod permutation (32,768 packets) and the all-to-all at 32
   packets per destination (520,192 packets) through ``simulate_megabatch``
   for seeds 0-3 in four fused dispatches per workload ({flow_ecmp,
   host_pkt, host_dr}, switch_pkt, switch_pkt_ar, ofan), with the kernel
   launch counts set to 0 just before each dispatch and read just after.
   Every fused result must equal the port's serial ``simulate`` and a
   ``backend="torch"`` run (plain versions) on the card bitwise, and seed 0
   must match the JAX reference's digests in
   ``tests/torch_golden/fastsim_k8.json``;
4. time each kernel and its plain version on the largest inputs the main
   path gave it, beside the bound of the card.

The last lines are the ``kernels`` JSON line, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN = ROOT / "tests" / "torch_golden" / "fastsim_k8.json"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and non-tensor fp32.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

SCHEME_GROUPS = (("flow_ecmp", "host_pkt", "host_dr"), ("switch_pkt",),
                 ("switch_pkt_ar",), ("ofan",))
SEEDS = (0, 1, 2, 3)
CUMMAX_SIZES = (0, 1, 1023, 1025, (1 << 20) + 3, 6_242_304)
DENSITIES = ("first", 1e-3, 0.5, "all")


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


class Recorder:
    """Wraps a kernel wrapper to keep the largest call's arguments, and with
    ``keep_all`` every call's (the wrapped call and its launch count are
    unchanged)."""

    def __init__(self, module, name, size_of, keep_all=False):
        self.module, self.name, self.size_of = module, name, size_of
        self.keep_all = keep_all
        self.orig = getattr(module, name)
        self.calls = []
        self.largest = None

    def __enter__(self):
        def rec(*args, **kw):
            if self.largest is None or (self.size_of(args)
                                        > self.size_of(self.largest[0])):
                self.largest = (args, kw)
            if self.keep_all:
                self.calls.append((args, kw))
            return self.orig(*args, **kw)
        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)
        return False


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir() or not GOLDEN.is_file():
        print("chip_smoke: run from the root of a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.kernels.lindley import ops as lindley_ops
    from repro_torch.kernels.jsq_scan import ops as jsq_ops
    from repro_torch.net import fastsim, workloads
    from repro_torch.net.topology import FatTree
    from repro_torch.core import lb_schemes
    from repro_torch.obs.digest import result_digest

    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    golden = json.loads(GOLDEN.read_text())
    # theory.DEFAULT_NET.prop_slots: 0.5 us links, 4178-byte slots at 800 Gb/s
    prop_slots = 0.5e-6 / (4178 * 8 / 800e9)
    check(prop_slots == golden["prop_slots"], "prop_slots differs from golden")
    errs = {"segmented_cummax": 0.0, "jsq_scan": 0.0}

    with Phase("build"):
        for name, log in _build.build_all().items():
            lines = [l.strip() for l in log.splitlines()
                     if "registers" in l or "spill" in l]
            print(f"built {name}: " + (" | ".join(lines) or "(cached)"),
                  flush=True)

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
        for wl_name, wl in wls.items():
            for scheme in ("jsq", "switch_pkt_ar"):
                with Recorder(jsq_ops, "jsq_scan", lambda a: a[0].numel(),
                              keep_all=True) as rec:
                    fastsim.simulate(tree, wl, lb_schemes.by_name(scheme),
                                     seed=0, prop_slots=prop_slots)
                check(len(rec.calls) == 2, "expected two JSQ layers")
                for layer, (args, kw) in zip(("edge", "agg"), rec.calls):
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
                          f"(tolerance: bitwise)", flush=True)

    launches = {"segmented_cummax": 0, "jsq_scan": 0}
    with Phase("main_path"), \
            Recorder(lindley_ops, "segmented_cummax",
                     lambda a: a[0].numel()) as rec_l, \
            Recorder(jsq_ops, "jsq_scan", lambda a: a[0].numel()) as rec_j:
        for wl_name, wl in wls.items():
            for group in SCHEME_GROUPS:
                items = [(tree, wl, lb_schemes.by_name(s), list(SEEDS), None)
                         for s in group]
                lindley_ops.LAUNCHES = jsq_ops.LAUNCHES = 0
                t0 = time.perf_counter()
                fused = fastsim.simulate_megabatch(items,
                                                   prop_slots=prop_slots)
                ms = (time.perf_counter() - t0) * 1e3
                launches["segmented_cummax"] += lindley_ops.LAUNCHES
                launches["jsq_scan"] += jsq_ops.LAUNCHES
                check(lindley_ops.LAUNCHES > 0,
                      f"{wl_name}/{group}: segmented_cummax never launched")
                if group == ("switch_pkt_ar",):
                    check(jsq_ops.LAUNCHES > 0,
                          f"{wl_name}/{group}: jsq_scan never launched")
                # The dispatch's host-side numpy share: the entry point's own
                # preparation and per-seed draws, rerun alone.
                t0 = time.perf_counter()
                for tr, w, scheme, seeds, _ in items:
                    plan = fastsim._prepare(tr, w, scheme, prop_slots, None,
                                            "auto", 4.0)
                    for s in seeds:
                        fastsim._draw_seed_inputs(plan, s)
                host_ms = (time.perf_counter() - t0) * 1e3
                for (_, _, scheme, _, _), res in zip(items, fused):
                    key = f"{wl_name}/{scheme.name}"
                    r0 = res[0]
                    layers = " ".join(f"{k}={v.max_queue:g}"
                                      for k, v in r0.layers.items())
                    print(f"point {key} seeds={len(SEEDS)} cct={r0.cct!r} "
                          f"max_queue[{layers}] dispatch_ms={ms:.1f} "
                          f"host_prep_ms={host_ms:.1f} "
                          f"(fused with {'+'.join(group)})", flush=True)
                    check(all(sane(r, wl, tree) for r in res),
                          f"{key}: malformed result")
                    check(result_digest(r0) == golden["points"][key],
                          f"{key}: seed 0 differs from the JAX digests")
                    serial = fastsim.simulate(tree, wl, scheme, seed=0,
                                              prop_slots=prop_slots)
                    check(same_results(serial, r0),
                          f"{key}: fused != serial simulate")
                plain = fastsim.simulate_megabatch(items, backend="torch",
                                                   prop_slots=prop_slots)
                for (_, _, scheme, _, _), res, ref in zip(items, fused,
                                                          plain):
                    check(all(same_results(a, b) for a, b in zip(res, ref)),
                          f"{wl_name}/{scheme.name}: kernels != plain "
                          f"versions")
                print(f"compared {wl_name}/{'+'.join(group)}: fused == serial "
                      f"== backend='torch' == JAX digest", flush=True)
        check(launches["segmented_cummax"] > 0 and launches["jsq_scan"] > 0,
              "a kernel of the main path was never launched")

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
        plain_ms = cuda_ms(lambda: lindley_ops.segmented_cummax(
            v, flags, backend="torch"), 3)
        nbytes = n * (4 + flags.element_size() + 4)
        kernels.append(dict(
            name="segmented_cummax", route="cuda",
            source="src/repro_torch/csrc/lindley.cu",
            replaces="src/repro/kernels/lindley/kernel.py:61",
            launches=launches["segmented_cummax"],
            max_abs_err=errs["segmented_cummax"], ms=ms, plain_ms=plain_ms,
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
        del got, want
        ms = cuda_ms(lambda: jsq_ops.jsq_scan(*args[:5]), 3)
        nq = 0 if thresholds is None else thresholds.numel()
        nbytes = cells * (4 + 1 + 4 * h + 4 + 4 + 4) + B * h * 4 + nq * 4
        flops = cells * h * (6 + nq)
        kernels.append(dict(
            name="jsq_scan", route="cuda",
            source="src/repro_torch/csrc/jsq_scan.cu",
            replaces="src/repro/net/fastsim.py:224 (lax.scan, no Pallas "
                     "kernel)",
            launches=launches["jsq_scan"], max_abs_err=errs["jsq_scan"],
            ms=ms, plain_ms=plain_ms,
            bound_ms=max(nbytes / HBM_BYTES_PER_S,
                         flops / FP32_FLOP_PER_S) * 1e3,
            bound_by="bytes" if nbytes / HBM_BYTES_PER_S
            >= flops / FP32_FLOP_PER_S else "operations",
            library_ms=None, n=cells, shape=[B, S, pad, h]))
        for k in kernels:
            print(f"kernel {k['name']}: launches={k['launches']} "
                  f"shape={k['shape']} ms={k['ms']:.4f} "
                  f"plain_ms={k['plain_ms']:.4f} bound_ms={k['bound_ms']:.4f}",
                  flush=True)

    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
