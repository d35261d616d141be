"""Campaign CLI.

    python -m repro_torch.sweep run --preset table2 --k 8 --seeds 0,1 \
        --out runs/table2
    python -m repro_torch.sweep run --spec campaign.json --seeds 0:8
    python -m repro_torch.sweep run --preset layer_balance --k 4 \
        --device cpu --out runs/lb
    python -m repro_torch.sweep presets
    python -m repro_torch.sweep plan --preset theory --k 4 --seeds 0:2
    python -m repro_torch.sweep summarize --results runs/table2/results.jsonl
    python -m repro_torch.sweep report --trace runs/table2/trace.jsonl \
        --results runs/table2/results.jsonl

The JAX reference's CLI (``python -m repro.sweep``) with one more argument:
``run --device {cuda,cpu}`` (default ``cuda``, which raises when no card is
visible).  ``run`` writes ``<out>/results.jsonl`` (one record per grid
point, byte-identical to the reference's), ``<out>/summary.jsonl``
(seed-aggregated rows) and ``<out>/trace.jsonl`` (one span per fused
dispatch; see ``repro_torch.obs``) -- all byte-deterministic for a given
spec, the trace modulo its wall-clock/cache fields.  ``report`` renders a
trace (plus, optionally, probe-carrying results) into a human-readable cost
summary.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

from ..obs import ProbeSpec, SweepLogger, TraceWriter, load_trace, render_report
from .spec import Campaign, PRESETS, preset
from .planner import plan
from .results import ResultStore, summarize, write_summary
from .runner import run_campaign


def _parse_seeds(text: str):
    """'0:8' -> range(0, 8); '1,5,9' -> (1, 5, 9)."""
    if ":" in text:
        lo, hi = text.split(":")
        return tuple(range(int(lo), int(hi)))
    return tuple(int(s) for s in text.split(","))


def _parse_probes(text: str) -> ProbeSpec:
    """'64' -> ProbeSpec(stride=64); '64,128' -> ProbeSpec(64, 128)."""
    parts = [int(p) for p in text.split(",")]
    if len(parts) == 1:
        return ProbeSpec(stride=parts[0])
    if len(parts) == 2:
        return ProbeSpec(stride=parts[0], samples=parts[1])
    raise argparse.ArgumentTypeError(
        f"--probes expects STRIDE or STRIDE,SAMPLES, got {text!r}")


def _load_campaign(args) -> Campaign:
    if args.preset:
        c = preset(args.preset)
    else:
        with open(args.spec) as f:
            c = Campaign.from_dict(json.load(f))
    override = {}
    if args.seeds:
        override["seeds"] = _parse_seeds(args.seeds)
    if args.k:
        override["trees"] = tuple(int(k) for k in args.k.split(","))
    if args.backend:
        override["backend"] = args.backend
    if getattr(args, "shard", None):
        override["shard"] = args.shard
    if getattr(args, "probes", None):
        override["probes"] = _parse_probes(args.probes)
    # --plan-from-trace implies cost-modeled planning.
    if getattr(args, "plan", None):
        override["planner"] = args.plan
    elif getattr(args, "plan_from_trace", None):
        override["planner"] = "cost"
    return dataclasses.replace(c, **override) if override else c


def _cost_params(args):
    """The CostParams for a run/plan invocation: trace-calibrated with
    --plan-from-trace, else None (model defaults)."""
    if getattr(args, "plan_from_trace", None):
        from .costmodel import CostParams
        return CostParams.from_trace(args.plan_from_trace)
    return None


def cmd_run(args) -> int:
    c = _load_campaign(args)
    out = pathlib.Path(args.out) if args.out else None
    resume = args.resume
    if resume and not out:
        print("--resume requires --out (the checkpoint is the results "
              "JSONL)", file=sys.stderr)
        return 2
    store = ResultStore(out / "results.jsonl" if out else None,
                        overwrite=not resume)
    quiet = args.quiet
    level = "quiet" if quiet else ("debug" if args.verbose else "info")
    trace = TraceWriter(out / "trace.jsonl" if out else None,
                        overwrite=not resume)
    # Precedence: --no-compile-cache > --compile-cache > $REPRO_COMPILE_CACHE
    # (resolved inside compile_cache.enable) > the checkout's build
    # directory, which already persists across invocations.
    if args.no_compile_cache:
        cache_dir = False
    else:
        cache_dir = args.compile_cache
    run_campaign(
        c, store=store, compile_cache_dir=cache_dir,
        trace=trace, log=SweepLogger(level),
        timing_split=args.timing_split, profile_dir=args.profile,
        retry=args.retry, backoff_s=args.backoff, resume=resume,
        cost_params=_cost_params(args), device=args.device)
    store.close()
    trace.close()
    # Summarize the *store*, not just this invocation's new records: on
    # --resume the checkpointed prefix is part of the campaign too.
    rows = (write_summary(out / "summary.jsonl", store.records) if out
            else summarize(store.records))
    if not quiet:
        for row in rows:
            print(f"{row['scheme']:>16s} k={row['k']} {row['workload']:<22s} "
                  f"cct {row['cct_mean']:10.1f} +- {row['cct_std']:7.1f} "
                  f"(n={row['n_seeds']})  max_q {row['max_queue_max']:8.1f}")
        if out:
            print(f"wrote {out / 'results.jsonl'}, {out / 'summary.jsonl'} "
                  f"and {out / 'trace.jsonl'}")
    return 0


def cmd_plan(args) -> int:
    c = _load_campaign(args)
    p = plan(c, cost_params=_cost_params(args))
    print(p.describe())
    if p.policy is not None and p.cost is not None:
        pred = p.cost
        print(f"cost model: policy {p.policy.label!r} -- "
              f"{pred.pkt_rows_padded} padded pkt rows "
              f"(fill {pred.pkt_fill:.1%}), {pred.n_shapes} shapes, "
              f"total {pred.total:.0f} rows")
        for lbl, cost, fill in p.alternatives[:4]:
            print(f"  rejected: {lbl:<24s} cost {cost:.0f} rows "
                  f"(fill {fill:.1%})")
    for i, mega in enumerate(p.megabatches):
        print(f"dispatch {i}: engine={mega.engine} "
              f"{mega.n_points} points pad={mega.npk_pad}")
        for b in mega.members:
            fail = b.failure.label() if b.failure else "nofail"
            g = "" if b.g_converge is None else f" G={b.g_converge}"
            print(f"  {b.scheme:>16s} k={b.k} {b.load.label():<22s} "
                  f"{fail:<14s}{g} seeds={list(b.seeds)}")
    return 0


def cmd_presets(_args) -> int:
    for name in sorted(PRESETS):
        c = PRESETS[name]()
        print(f"{name:>14s}: {c.n_points:4d} points  engine={c.engine:<5s} "
              f"schemes={','.join(c.schemes)}")
    return 0


def cmd_summarize(args) -> int:
    store = ResultStore.load(args.results)
    for row in summarize(store.records):
        print(json.dumps(row, sort_keys=True))
    return 0


def cmd_report(args) -> int:
    spans = load_trace(args.trace)
    records = (ResultStore.load(args.results).records
               if args.results else None)
    bench = None
    if args.bench:
        with open(args.bench) as f:
            bench = json.load(f)
    text = render_report(spans, records, top=args.top, bench=bench)
    print(text)
    if args.out:
        p = pathlib.Path(args.out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text + "\n")
        print(f"wrote {p}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.sweep")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def _spec_args(p):
        g = p.add_mutually_exclusive_group(required=True)
        g.add_argument("--preset", choices=sorted(PRESETS))
        g.add_argument("--spec", help="path to a Campaign JSON file")
        p.add_argument("--seeds", help="override seeds: '0:8' or '1,5,9'")
        p.add_argument("--k", help="override tree sizes: '4,8'")
        p.add_argument("--backend", choices=["auto", "xla", "pallas"],
                       help="fast-engine kernels: 'auto' and 'pallas' "
                            "launch the CUDA kernels, 'xla' runs their "
                            "plain PyTorch versions")
        p.add_argument("--shard", choices=["auto", "off"],
                       help="shard fused dispatches across devices")
        p.add_argument("--plan", choices=["heuristic", "cost"],
                       help="bucket-policy planner: the fixed greedy-2x/"
                            "pow2 heuristic, or the per-campaign cost "
                            "model (repro_torch.sweep.costmodel)")
        p.add_argument("--plan-from-trace", metavar="TRACE",
                       help="calibrate the cost model's compile charge "
                            "from a measured trace.jsonl (spans written "
                            "under --timing-split); implies --plan cost")

    p_run = sub.add_parser("run", help="execute a campaign")
    _spec_args(p_run)
    p_run.add_argument("--out", help="output dir for results/summary/trace "
                                     "JSONL")
    p_run.add_argument("--compile-cache", metavar="DIR",
                       help="directory the CUDA kernels are built in and "
                            "loaded from (default: $REPRO_COMPILE_CACHE, "
                            "else the checkout's build/repro_torch_kernels)")
    p_run.add_argument("--no-compile-cache", action="store_true",
                       help="ignore $REPRO_COMPILE_CACHE")
    p_run.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                       help="where both engines run (default cuda: the "
                            "CUDA kernels; cpu: their plain versions)")
    p_run.add_argument("--quiet", action="store_true",
                       help="no progress output")
    p_run.add_argument("--verbose", "-v", action="store_true",
                       help="per-member timings and cache diagnostics "
                            "(default: one line per fused dispatch)")
    p_run.add_argument("--probes", metavar="STRIDE[,SAMPLES]",
                       help="record per-layer queue-occupancy time series "
                            "(repro_torch.obs.probes; default 256 "
                            "samples)")
    p_run.add_argument("--timing-split", action="store_true",
                       help="dispatch twice to split build vs execute "
                            "wall time in the trace")
    p_run.add_argument("--profile", metavar="DIR",
                       help="write a torch.profiler (Chrome) trace to DIR")
    p_run.add_argument("--retry", type=int, default=0, metavar="N",
                       help="extra attempts per dispatch before the "
                            "degradation ladder (megabatch -> per-member "
                            "-> serial) kicks in")
    p_run.add_argument("--backoff", type=float, default=0.5, metavar="S",
                       help="base retry backoff seconds, doubled per "
                            "attempt (default 0.5)")
    p_run.add_argument("--resume", action="store_true",
                       help="treat an existing <out>/results.jsonl as a "
                            "checkpoint: skip complete dispatches, re-run "
                            "the partial tail; the finished file is byte-"
                            "identical to an uninterrupted run")
    p_run.set_defaults(fn=cmd_run)

    p_plan = sub.add_parser("plan", help="show the batched execution plan")
    _spec_args(p_plan)
    p_plan.set_defaults(fn=cmd_plan)

    p_pre = sub.add_parser("presets", help="list named campaign presets")
    p_pre.set_defaults(fn=cmd_presets)

    p_sum = sub.add_parser("summarize", help="aggregate a results.jsonl")
    p_sum.add_argument("--results", required=True)
    p_sum.set_defaults(fn=cmd_summarize)

    p_rep = sub.add_parser("report", help="render a dispatch trace into a "
                                          "cost summary")
    p_rep.add_argument("--trace", required=True, help="path to trace.jsonl")
    p_rep.add_argument("--results", help="results.jsonl (enables queue-"
                                         "trajectory sparklines when the "
                                         "campaign ran with probes)")
    p_rep.add_argument("--top", type=int, default=3,
                       help="queue trajectories to show (default 3)")
    p_rep.add_argument("--bench", help="BENCH_sweep.json: render its "
                                       "speedup_vs_* samples (ratios below "
                                       "1.0 are labeled as slowdowns)")
    p_rep.add_argument("--out", help="also write the report to this file")
    p_rep.set_defaults(fn=cmd_report)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
