"""Megabatched scenario-campaign engine: the port of ``repro.sweep``.

Declarative sweeps over the paper's evaluation axes (LB scheme x load x
fat-tree size x replicate seeds x failure patterns x routing convergence)
executed with ONE fused dispatch per pipeline shape: every
scheme/load/failure/seed cell that lowers to the same pipeline stacks onto a
single batch axis of the engines' ``simulate_megabatch`` (cut into one
chunk per CUDA device when more than one is visible), instead of a Python
loop of per-point ``simulate`` calls.  The plans, records and traces are
the JAX reference's: ``results.jsonl`` is byte-identical to its.

    from repro_torch import sweep

    c = sweep.preset("theory", seeds=tuple(range(8)))
    records, _ = sweep.run_campaign(c, store=sweep.ResultStore("out.jsonl"))
    for row in sweep.summarize(records):
        print(row["scheme"], row["cct_mean"], row["cct_std"])

``run_campaign`` runs on CUDA unless ``device="cpu"`` is given.  CLI:
``python -m repro_torch.sweep run --preset table2 --k 8 --seeds 0,1 --out
runs/table2`` (``--device cpu`` for the plain versions on the CPU).

Observability (``repro_torch.obs``, re-exported here): ``run_campaign`` can
emit a versioned JSONL dispatch trace (``trace=TraceWriter(...)``), log one
line per fused dispatch (``log=SweepLogger(...)``), and -- with
``Campaign.probes=ProbeSpec(...)`` -- carry per-layer queue-occupancy time
series out of the engines.  ``python -m repro_torch.sweep report`` renders a
trace into a cost summary.
"""
from ..obs import (ProbeSpec, QueueProbe, SweepLogger, TraceWriter,
                   load_trace, render_report, strip_timing)
from .spec import (Campaign, FailureSpec, GridPoint, PRESETS, WorkloadSpec,
                   preset)
from .planner import MegaBatch, Plan, SeedBatch, bucket_packets, plan
from .costmodel import (BucketPolicy, CostParams, PlanCost,
                        candidate_policies, choose_policy, evaluate_policy)
from .results import (ResultStore, encode_record, loop_point_record,
                      point_record, summarize, write_summary)
from .runner import build_links, build_workload, run_campaign
from . import compile_cache

__all__ = [
    "Campaign", "FailureSpec", "GridPoint", "PRESETS", "WorkloadSpec",
    "preset", "MegaBatch", "Plan", "SeedBatch", "bucket_packets", "plan",
    "BucketPolicy", "CostParams", "PlanCost", "candidate_policies",
    "choose_policy", "evaluate_policy",
    "ResultStore", "encode_record", "loop_point_record", "point_record",
    "summarize", "write_summary", "build_links", "build_workload",
    "run_campaign", "compile_cache",
    "ProbeSpec", "QueueProbe", "SweepLogger", "TraceWriter",
    "load_trace", "render_report", "strip_timing",
]
