"""Render a campaign trace into a human-readable cost summary.

Backs ``python -m repro_torch.sweep report``: given the dispatch spans of one
campaign run (``trace.jsonl``) and optionally its ``results.jsonl``, emit

* the dispatch timeline (engine, fused schemes, padding fill, wall split,
  and -- for loop dispatches -- the resolved slot-step ``impl``);
* per-shape padding-waste accounting -- the measured costs the ROADMAP's
  cost-modeled planner consumes;
* loop-engine slot-budget utilization;
* with ``--bench BENCH_sweep.json``: every ``speedup_vs_*`` sample labeled
  honestly -- ratios below 1.0 render as slowdowns, not small speedups;
* a robustness section (retries, terminal dispatch errors, degradation-
  ladder splits, resume checkpoints) whenever the trace carries any of the
  runner's retry/error/degrade/resume spans -- the view that makes a
  *partial* campaign legible: which points are missing from results.jsonl
  and why;
* the top queue trajectories (sparkline per point) when the results carry
  probe series (``Campaign.probes``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

_BLOCKS = " ▁▂▃▄▅▆▇█"


def sparkline(vals, width: int = 60) -> str:
    """Downsample ``vals`` to <= ``width`` chars (max per chunk, so peaks
    survive) and render as unicode block heights."""
    vals = [float(v) for v in vals]
    if len(vals) > width:
        n = len(vals)
        vals = [max(vals[i * n // width:max((i + 1) * n // width,
                                            i * n // width + 1)])
                for i in range(width)]
    peak = max(vals) if vals else 0.0
    if peak <= 0:
        return _BLOCKS[0] * len(vals)
    return "".join(_BLOCKS[max(1, round(v / peak * 8))] if v > 0
                   else _BLOCKS[0] for v in vals)


def _fmt_s(x) -> str:
    return f"{x:8.2f}s" if isinstance(x, (int, float)) else " " * 9


def ratio_label(ratio: float) -> str:
    """Honest rendering of a wall-time ratio: values below 1.0 are
    *slowdowns*, not small speedups (a ``speedup_vs_warm`` of 0.49 means
    the fused path ran at half warm-serial throughput), and a non-finite
    or non-positive sample (a failed/aborted bench run writing 0.0, -1 or
    NaN) is labeled as bad data rather than rendered as an absurd
    "1000000000.0x slower"."""
    if not math.isfinite(ratio) or ratio <= 0.0:
        return "n/a (bad sample)"
    if ratio >= 1.0:
        return f"{ratio:.2f}x speedup"
    return (f"{ratio:.2f}x -- SLOWDOWN "
            f"({1.0 / ratio:.1f}x slower)")


def _bench_ratio_lines(bench: Dict) -> List[str]:
    """The speedup/slowdown summary of a ``BENCH_sweep.json`` dict: every
    ``speedup_vs_*`` sample in the top level and one section deep, labeled
    via :func:`ratio_label`."""
    lines: List[str] = []
    sections = [("", bench)] + [(f"{k}.", v) for k, v in bench.items()
                                if isinstance(v, dict)]
    for prefix, sec in sections:
        impl = sec.get("impl") if isinstance(sec, dict) else None
        for key, val in sec.items():
            if not key.startswith("speedup_vs_"):
                continue
            tag = f"  [impl={impl}]" if impl else ""
            lines.append(f"  {prefix + key:<32s} {ratio_label(float(val))}"
                         f"{tag}")
    return lines


def render_report(spans: List[Dict], records: Optional[List[Dict]] = None,
                  top: int = 3, bench: Optional[Dict] = None) -> str:
    """The ``python -m repro_torch.sweep report`` text body."""
    plan = next((s for s in spans if s.get("kind") == "plan"), None)
    disp = [s for s in spans if s.get("kind") == "dispatch"]
    end = next((s for s in spans if s.get("kind") == "campaign"), None)
    lines: List[str] = []

    name = (plan or end or {"campaign": "?"}).get("campaign", "?")
    schema = (spans[0].get("schema", "?")) if spans else "?"
    lines.append(f"campaign {name!r} -- trace schema {schema}, "
                 f"{len(disp)} dispatches")
    if plan:
        lines.append(f"  {plan.get('n_points', '?')} grid points, "
                     f"{plan.get('n_shapes', '?')} compiled shapes, "
                     f"{plan.get('devices', '?')} device(s)")
    if end and "wall_s" in end:
        emit = end.get("emit_s", 0.0)
        lines.append(f"  total wall {end['wall_s']:.2f}s "
                     f"(trace overhead {emit:.4f}s)")

    # ---- cost-modeled planner: predicted vs realized fill -----------------
    if plan and plan.get("policy"):
        lines.append("")
        lines.append(f"planner: cost-modeled policy {plan['policy']!r}"
                     + (f" (calibration: {plan['calibration']})"
                        if plan.get("calibration") else ""))
        pred = plan.get("predicted") or {}
        if pred:
            lines.append(
                f"  predicted: pkt_fill {pred.get('pkt_fill', 0):.1%} "
                f"({pred.get('pkt_rows_real', '?')} real rows in "
                f"{pred.get('pkt_rows_padded', '?')} padded, "
                f"{pred.get('n_shapes', '?')} shapes, model total "
                f"{pred.get('total', 0):.0f} rows)")
        if end and end.get("pkt_rows_padded"):
            lines.append(
                f"  realized:  pkt_fill {end.get('pkt_fill', 0):.1%} "
                f"({end.get('pkt_rows_real', '?')} real rows in "
                f"{end.get('pkt_rows_padded', '?')} padded)")
        alts = plan.get("alternatives") or []
        for a in alts[:4]:
            lines.append(f"  rejected: {a.get('policy', '?'):<24s} "
                         f"cost {a.get('cost', 0):.0f} rows "
                         f"(fill {a.get('pkt_fill', 0):.1%})")
        if len(alts) > 4:
            lines.append(f"  ... and {len(alts) - 4} more alternatives")

    # ---- dispatch timeline -------------------------------------------------
    if disp:
        lines.append("")
        lines.append("dispatch timeline:")
        lines.append("   #  eng  rows  fill  pkt_fill      wall   "
                     "compile  schemes")
        for s in disp:
            wall = _fmt_s(s.get("wall_s"))
            comp = _fmt_s(s.get("compile_s"))
            cached = "  [cached]" if s.get("cache") == "hit" else ""
            impl = f" impl={s['impl']}" if "impl" in s else ""
            lines.append(
                f"  {s['dispatch']:>2d} {s['engine']:>4s} "
                f"{s['n_points']:>5d}  {s.get('row_fill', 1.0):.2f}  "
                f"{s.get('pkt_fill', 0.0):8.2f} {wall} {comp}  "
                f"{','.join(s.get('schemes', []))}"
                f" k_pad={s.get('k_pad', '?')}{impl}{cached}")

    # ---- padding waste per shape ------------------------------------------
    if disp:
        real = sum(s.get("pkt_rows_real", 0) for s in disp)
        padded = sum(s.get("pkt_rows_padded", 0) for s in disp)
        lines.append("")
        if padded:
            worst = min(disp, key=lambda s: s.get("pkt_fill", 1.0))
            lines.append(
                f"padding: {real} real packet-rows in {padded} padded "
                f"({real / padded:.1%} fill); worst dispatch "
                f"#{worst['dispatch']} at {worst.get('pkt_fill', 0):.1%} "
                f"({','.join(worst.get('schemes', []))})")
        loop_disp = [s for s in disp if "slots_run" in s]
        for s in loop_disp:
            lines.append(
                f"slot budget (dispatch #{s['dispatch']}): ran "
                f"{s['slots_run']}/{s['slot_budget']} slots, per-row fill "
                f"{s.get('slot_fill', 0):.1%}")

    # ---- benchmark ratios (BENCH_sweep.json, --bench) ---------------------
    if bench:
        ratio_lines = _bench_ratio_lines(bench)
        if ratio_lines:
            lines.append("")
            lines.append("benchmark wall-time ratios (fused vs serial "
                         "baselines; below 1.0 the fused path is SLOWER):")
            lines.extend(ratio_lines)

    # ---- dispatch errors / retries / degraded -----------------------------
    retries = [s for s in spans if s.get("kind") == "retry"]
    errors = [s for s in spans if s.get("kind") == "error"]
    degrades = [s for s in spans if s.get("kind") == "degrade"]
    resumes = [s for s in spans if s.get("kind") == "resume"]
    if retries or errors or degrades or resumes:
        lines.append("")
        lines.append("robustness (dispatch errors / retries / degraded):")
        for s in resumes:
            lines.append(f"  resume: kept {s.get('dispatches_kept', '?')} "
                         f"complete dispatches "
                         f"({s.get('records_kept', '?')} records)")
        if retries:
            lines.append(f"  {len(retries)} retried attempt(s) across "
                         f"dispatches "
                         f"{sorted({s.get('dispatch') for s in retries})}")
        for s in degrades:
            extra = (f", {s['failed']} point(s) lost"
                     if s.get("failed") else "")
            lines.append(f"  dispatch #{s.get('dispatch', '?')} degraded to "
                         f"{s.get('stage', '?')}"
                         f" ({s.get('scheme', '?')}){extra}")
        terminal = [s for s in errors if s.get("stage") == "point"]
        whole = [s for s in errors if s.get("stage") != "point"]
        if whole:
            lines.append(f"  {len(whole)} exhausted-budget error(s) at "
                         f"stage(s) "
                         f"{sorted({s.get('stage') for s in whole})}")
        for s in terminal:
            lines.append(f"  LOST point: dispatch "
                         f"#{s.get('dispatch', '?')} "
                         f"{s.get('scheme', '?')} seed "
                         f"{s.get('seed', '?')} -- "
                         f"{s.get('error', '?')}")
        if terminal:
            lines.append("  (lost points have no rows in results.jsonl; "
                         "re-run with --resume after fixing the cause)")

    # ---- iteration time (collective-phase records) ------------------------
    phased = [r for r in (records or []) if r.get("iter_makespan")]
    if phased:
        groups: Dict[tuple, List[Dict]] = {}
        order: List[tuple] = []
        for r in phased:
            key = (r.get("scheme"), r.get("phases"))
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(r)
        lines.append("")
        lines.append("iteration time (collective-phase campaigns; slots, "
                     "mean over seeds/loads):")
        for scheme, ph in order:
            rs = groups[(scheme, ph)]
            n_it = max(len(r["iter_makespan"]) for r in rs)
            per_it = []
            for i in range(n_it):
                vals = [r["iter_makespan"][i] for r in rs
                        if len(r["iter_makespan"]) > i]
                per_it.append(sum(vals) / len(vals))
            mean = (sum(r.get("iter_time_mean", 0.0) for r in rs)
                    / len(rs))
            per = ", ".join(f"{v:.0f}" for v in per_it)
            lines.append(f"  {str(scheme):<16s} {str(ph):<32s} "
                         f"iter {mean:8.1f}  per-iter [{per}]  "
                         f"({len(rs)} point(s))")

    # ---- top queue trajectories (needs probe-carrying results) -------------
    probed = [r for r in (records or []) if r.get("probe_queue")]
    if probed:
        probed.sort(key=lambda r: r.get("max_queue", 0), reverse=True)
        lines.append("")
        lines.append(f"top queue trajectories (of {len(probed)} probed "
                     f"points; stride {probed[0].get('probe_stride')} "
                     f"slots/char bucket):")
        for r in probed[:max(top, 0)]:
            series = r["probe_queue"]
            peaks = [max(row) if row else 0 for row in series]
            li = peaks.index(max(peaks))
            label = (f"{r.get('scheme', '?')} k={r.get('k', '?')} "
                     f"s{r.get('seed', '?')} layer{li}")
            lines.append(f"  {label:<28s} {sparkline(series[li])} "
                         f"(max {max(peaks):g})")
    elif records is not None:
        lines.append("")
        lines.append("no probe series in results (run with Campaign.probes "
                     "/ --probes to record queue trajectories)")

    return "\n".join(lines)
