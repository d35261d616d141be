"""Campaign execution: one fused megabatch dispatch per compiled shape.

The runner walks the planner's megabatch list, memoizing topologies,
workloads and failure states across batches, and executes

  * fast-engine megabatches as a single ``fastsim.simulate_megabatch`` call:
    every member (scheme, load, failure, seed) cell stacks onto one fused
    batch axis -- padded to the megabatch's bucketed packet shape and, when
    several CUDA devices are visible (``Campaign.shard='auto'``), cut into
    one chunk per device;
  * loop-engine megabatches (ACK/ECN schemes) as a single
    ``loopsim.simulate_megabatch`` call: the scheme/load/failure/seed cells
    of one slotted-engine pipeline -- plus the ``g_converge`` and rho axes,
    which ride as per-row operands -- fuse the same way.

Both run on ``device`` (``None``: CUDA, raising when no card is visible;
the CPU tests pass ``"cpu"``).  Each grid point yields one record in the
:class:`~repro_torch.sweep.results.ResultStore`; per-point results are
bitwise-identical to standalone ``simulate`` calls with the same seeds, and
the records -- which carry no backend or device field -- byte-identical to
the JAX reference runner's.  Pass ``compile_cache_dir=<dir>`` (or set
``REPRO_COMPILE_CACHE``) to build the CUDA kernels there
(``sweep.compile_cache``).

Telemetry (``repro_torch.obs``): every run can emit a versioned JSONL
dispatch trace (``trace=TraceWriter(...)``) -- one span per fused dispatch
carrying the member population, padding-fill ratios, device fill, wall
seconds and compile-cache state -- and logs through a
:class:`~repro_torch.obs.log.SweepLogger` (default one line per dispatch).
Both are pure observers: with them off (the defaults) the runner's outputs
are byte-identical.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

import torch

from ..net.topology import FatTree, LinkState, rho_max
from ..net import workloads, fastsim, loopsim
from ..core import lb_schemes as lbs
from ..core.retry import retry_call
from ..faults import FaultSchedule
from ..kernels import _build
from ..kernels._common import resolve_device
from ..obs.log import SweepLogger, dispatch_line
from ..obs.probes import probe_shape
from ..obs.trace import TraceWriter
from . import compile_cache
from .planner import MegaBatch, SeedBatch, plan
from .results import ResultStore, loop_point_record, point_record
from .spec import (Campaign, FailureSpec, GridPoint, WorkloadSpec,
                   engine_backend)


def build_workload(tree: FatTree, load: WorkloadSpec):
    if load.kind == "permutation":
        return workloads.permutation(tree, load.msg_packets,
                                     np.random.default_rng(load.rng_seed),
                                     inter_pod_only=load.inter_pod_only)
    if load.kind == "all_to_all":
        return workloads.all_to_all(tree, load.msg_packets)
    if load.kind == "fsdp_rings":
        return workloads.fsdp_rings(tree, load.gpus_per_server,
                                    load.msg_packets,
                                    np.random.default_rng(load.rng_seed))
    raise ValueError(f"unknown workload kind {load.kind!r}")


def build_links(tree: FatTree,
                failure: Optional[FailureSpec]) -> Optional[LinkState]:
    """The campaign interpretation of a FailureSpec (None = all links up):
    counter-keyed draws by default, the old sequential ``np.random`` stream
    when the spec pins ``legacy_rng``."""
    if failure is None:
        return None
    if failure.legacy_rng:
        return LinkState.random_failures(
            tree, failure.p_fail, np.random.default_rng(failure.rng_seed))
    return LinkState.random_failures(tree, failure.p_fail,
                                     seed=failure.rng_seed)


class _Cache:
    """Memoized topology / workload / failure-state construction, and the
    device the dispatches run on."""

    def __init__(self, device: torch.device = torch.device("cpu")):
        self.device = device
        self.trees: Dict[int, FatTree] = {}
        self.wls: Dict[Tuple, object] = {}
        self.cps: Dict[Tuple, object] = {}
        self.links: Dict[Tuple, LinkState] = {}
        self.rhos: Dict[Tuple, float] = {}

    def tree(self, k: int) -> FatTree:
        if k not in self.trees:
            self.trees[k] = FatTree(k)
        return self.trees[k]

    def compiled_phases(self, k: int, load: WorkloadSpec, phase):
        """The ``repro_torch.phases.CompiledPhases`` of a phased point (its fused
        workload plus the per-phase bookkeeping the records need)."""
        key = (k, load, phase)
        if key not in self.cps:
            self.cps[key] = phase.compile(self.tree(k), load.msg_packets,
                                          rng_seed=load.rng_seed)
        return self.cps[key]

    def workload(self, k: int, load: WorkloadSpec, phase=None):
        if phase is not None:
            return self.compiled_phases(k, load, phase).workload
        key = (k, load)
        if key not in self.wls:
            self.wls[key] = build_workload(self.tree(k), load)
        return self.wls[key]

    def link_state(self, k: int,
                   failure: Optional[FailureSpec]) -> Optional[LinkState]:
        """Static link state for FailureSpec rows.  FaultSchedule rows get
        None: the engines compile the schedule's epoch stack themselves."""
        if failure is None or isinstance(failure, FaultSchedule):
            return None
        key = (k, failure)
        if key not in self.links:
            self.links[key] = build_links(self.tree(k), failure)
        return self.links[key]

    def rho_links(self, k: int, failure) -> Optional[LinkState]:
        """The link state ``rho='auto'`` resolves against.  For dynamic
        schedules this is deterministically the *epoch-0* pattern: the
        sending rate is fixed before the collective starts, when only the
        base failure state is observable."""
        if isinstance(failure, FaultSchedule):
            key = (k, failure, "ep0")
            if key not in self.links:
                self.links[key] = failure.compile(self.tree(k)).links[0]
            links = self.links[key]
            return links if links.any_failure() else None
        return self.link_state(k, failure)

    def rho_auto(self, k: int, load: WorkloadSpec, failure,
                 phase=None) -> float:
        key = (k, load, failure, phase)
        if key not in self.rhos:
            links = self.rho_links(k, failure)
            wl = self.workload(k, load, phase)
            self.rhos[key] = (rho_max(self.tree(k), links, wl.flow_src,
                                      wl.flow_dst)
                              if links is not None else 1.0)
        return self.rhos[key]


def _fault_of(b: SeedBatch):
    """The dynamic-schedule item field: the failure itself for FaultSchedule
    rows (the engines compile the epoch stack), None for static rows."""
    return b.failure if isinstance(b.failure, FaultSchedule) else None


def _run_fast_mega(mega: MegaBatch, campaign: Campaign, cache: _Cache):
    """One fused dispatch for all member batches; returns results per member."""
    items = [(cache.tree(b.k), cache.workload(b.k, b.load, b.phase),
              lbs.by_name(b.scheme), b.seeds,
              cache.link_state(b.k, b.failure), _fault_of(b))
             for b in mega.members]
    n_shards = "auto" if campaign.shard == "auto" else 1
    return fastsim.simulate_megabatch(items, prop_slots=campaign.prop_slots,
                                      backend=engine_backend(
                                          campaign.backend),
                                      npk_pad=mega.npk_pad,
                                      n_shards=n_shards, k_pad=mega.k_pad,
                                      probes=campaign.probes,
                                      device=cache.device)


def _run_loop_mega(mega: MegaBatch, campaign: Campaign, cache: _Cache):
    """One fused loop-engine dispatch for all member batches; rho (possibly
    rho_max under each member's failure pattern) and g_converge are per-row
    operands, so the whole grid slice shares one compiled engine.  Schedule
    rows carry ``g_converge=None`` from the grid (``Campaign.points``):
    their reaction delays come from the schedule itself."""
    rho_opt = campaign.loop_options().get("rho", 1.0)
    items = []
    for b in mega.members:
        rho = (cache.rho_auto(b.k, b.load, b.failure, b.phase)
               if rho_opt == "auto" else float(rho_opt))
        items.append((cache.tree(b.k), cache.workload(b.k, b.load, b.phase),
                      lbs.by_name(b.scheme),
                      campaign.loop_config(rho, timing=b.timing),
                      b.seeds, cache.link_state(b.k, b.failure),
                      b.g_converge, _fault_of(b)))
    n_shards = "auto" if campaign.shard == "auto" else 1
    return loopsim.simulate_megabatch(items, npk_pad=mega.npk_pad,
                                      n_shards=n_shards, k_pad=mega.k_pad,
                                      probes=campaign.probes,
                                      device=cache.device)


def _probe_field(campaign: Campaign):
    stride, samples = probe_shape(campaign.probes)
    return [stride, samples] if samples else None


def _compile_misses() -> int:
    """The ``nvcc`` runs of this process (``kernels._build.BUILDS``): the
    port compiles nothing per pipeline shape, so the delta around a
    dispatch is nonzero only where it built a CUDA kernel that no earlier
    run had left in the cache directory (never on the CPU)."""
    return _build.BUILDS


def _resolve_impl(impl: str, device: torch.device) -> str:
    """The slot-step path a loop dispatch runs: ``"cuda"`` (the kernels)
    for ``impl="auto"`` on a card, else ``"torch"`` (the plain versions)."""
    return "cuda" if impl == "auto" and device.type == "cuda" else "torch"


def _cache_files(cache_dir) -> int:
    if not cache_dir:
        return 0
    try:
        import pathlib
        return sum(1 for f in pathlib.Path(cache_dir).rglob("*")
                   if f.is_file())
    except OSError:
        return 0


def _dispatch_span(idx: int, mega: MegaBatch, campaign: Campaign,
                   n_shards_pol, devices: int,
                   device: torch.device = torch.device("cpu")) -> Dict:
    """The deterministic part of a dispatch span: member population and
    padding accounting, computable before execution."""
    rows = mega.n_points
    n_shards = (max(1, min(devices, rows))
                if n_shards_pol == "auto" else 1)
    rows_padded = -(-rows // n_shards) * n_shards
    pkt_rows_real = sum(b.n_packets(b.k) * len(b.seeds)
                        for b in mega.members)
    pkt_rows_padded = rows_padded * mega.npk_pad
    span = {
        "kind": "dispatch",
        "campaign": campaign.name,
        "dispatch": idx,
        "engine": mega.engine,
        "key": repr(mega.key),
        "n_members": len(mega.members),
        "n_points": rows,
        "schemes": sorted({b.scheme for b in mega.members}),
        "trees": sorted({b.k for b in mega.members}),
        "k_pad": mega.k_pad,
        "npk_pad": mega.npk_pad,
        "pkt_rows_real": pkt_rows_real,
        "pkt_rows_padded": pkt_rows_padded,
        "pkt_fill": pkt_rows_real / max(pkt_rows_padded, 1),
        "rows_padded": rows_padded,
        "row_fill": rows / max(rows_padded, 1),
        "n_shards": n_shards,
        "devices": devices,
        "probes": _probe_field(campaign),
    }
    if mega.engine == "loop":
        span["slot_budget"] = int(campaign.max_slots)
        span["impl"] = _resolve_impl(campaign.loop_config().impl, device)
    # Collective-phase members (only-when-set: phase-free campaigns keep
    # byte-identical spans): which schedules ride this dispatch and how
    # many of its fused points are phased.
    phased = [b for b in mega.members if b.phase is not None]
    if phased:
        span["phases"] = sorted({b.phase.label() for b in phased})
        span["phase_points"] = sum(len(b.seeds) for b in phased)
        span["phase_instances"] = max(b.phase.n_instances for b in phased)
    return span


def _point_key(point: GridPoint) -> Tuple:
    """Record-identity tuple of a grid point, matching :func:`_record_key`
    on the record the runner would write for it."""
    tm = point.timing if point.timing is not None else (None, None)
    return (point.campaign, point.k, point.load.label(),
            point.failure.label() if point.failure else None,
            point.scheme, point.seed, point.g_converge,
            int(tm[0]) if tm[0] is not None else None,
            int(tm[1]) if tm[1] is not None else None,
            point.phase.label() if point.phase is not None else None)


def _record_key(rec: Dict) -> Tuple:
    # Fast-engine records carry no g_converge field; .get(None) matches the
    # fast-campaign grid's g_converge=None axis value.  Likewise
    # prop_slots/ack_delay appear only on timing-axis loop records and
    # "phases" only on collective-phase records (pre-phase results.jsonl
    # files resume byte-identically).
    return (rec.get("campaign"), rec.get("k"), rec.get("workload"),
            rec.get("failure"), rec.get("scheme"), rec.get("seed"),
            rec.get("g_converge"), rec.get("prop_slots"),
            rec.get("ack_delay"), rec.get("phases"))


def _run_with_recovery(idx: int, mega: MegaBatch, campaign: Campaign,
                       cache: _Cache, run: Callable, *, retry: int,
                       backoff_s: float, sleep: Callable,
                       log: SweepLogger) -> Tuple[list, List[Dict]]:
    """Execute one fused dispatch with bounded retry and the degradation
    ladder: whole megabatch -> per-member dispatches -> serial per-point.

    Returns (per_member, spans): ``per_member`` aligns with
    ``mega.members``, each entry a per-seed result list in which points
    that failed terminally are None (they yield no records -- the error
    spans are their trace).  ``spans`` are the retry/error/degrade spans
    to emit, in event order.
    """
    spans: List[Dict] = []

    def _base(**kw) -> Dict:
        return {"campaign": campaign.name, "dispatch": idx, **kw}

    def _attempt(fn, stage, **ctx):
        """retry_call around one ladder rung; returns (value, ok)."""
        def on_retry(attempt, e, delay):
            spans.append(_base(kind="retry", stage=stage, attempt=attempt,
                               error=repr(e), backoff_s=delay, **ctx))
            log.info(f"dispatch {idx} [{stage}] attempt {attempt} failed: "
                     f"{e!r}; backing off {delay:.2f}s")
        try:
            return retry_call(fn, max_retries=retry, backoff_s=backoff_s,
                              sleep=sleep, on_retry=on_retry), True
        except Exception as e:  # noqa: BLE001 -- degrade, don't die
            spans.append(_base(kind="error", stage=stage, error=repr(e),
                               **ctx))
            log.info(f"dispatch {idx} [{stage}] failed terminally: {e!r}")
            return None, False

    out, ok = _attempt(lambda: run(mega, campaign, cache), "megabatch")
    if ok:
        return out, spans

    # Rung 2: one dispatch per member batch (halves the blast radius of a
    # compile/OOM failure: a poisoned member no longer sinks its siblings).
    per_member: list = []
    for m, b in enumerate(mega.members):
        sub = MegaBatch(key=mega.key, members=[b])
        out, ok = _attempt(lambda sub=sub: run(sub, campaign, cache)[0],
                           "member", member=m, scheme=b.scheme)
        if ok:
            spans.append(_base(kind="degrade", stage="member", member=m,
                               scheme=b.scheme))
            per_member.append(out)
            continue
        # Rung 3: serial per-point; surviving seeds still record.
        results = []
        for s in b.seeds:
            one = MegaBatch(key=mega.key,
                            members=[dataclasses.replace(b, seeds=(s,))])
            res, ok = _attempt(lambda one=one: run(one, campaign, cache)[0][0],
                               "point", member=m, scheme=b.scheme, seed=s)
            results.append(res if ok else None)
        spans.append(_base(kind="degrade", stage="serial", member=m,
                           scheme=b.scheme,
                           failed=sum(r is None for r in results)))
        per_member.append(results)
    return per_member, spans


def run_campaign(campaign: Campaign, store: Optional[ResultStore] = None,
                 keep_full: bool = False,
                 progress: Optional[Callable[[str], None]] = None,
                 compile_cache_dir: Optional[str] = None,
                 trace: Optional[TraceWriter] = None,
                 log: Optional[SweepLogger] = None,
                 timing_split: bool = False,
                 profile_dir: Optional[str] = None,
                 retry: int = 0, backoff_s: float = 0.5,
                 sleep: Callable[[float], None] = time.sleep,
                 resume: bool = False,
                 cost_params=None,
                 device=None):
    """Execute a campaign; returns (records, full_results).

    ``device`` is where both engines run: ``None`` (the default) is CUDA and
    raises when no card is visible; ``"cpu"`` runs the plain PyTorch
    versions of the kernels.

    ``records`` is the flat list of per-point dicts (also appended to
    ``store`` when given, in grid-plan order).  ``full_results`` maps
    ``GridPoint -> FastSimResult/LoopSimResult`` when ``keep_full=True``
    (tests and figure code that need raw delivery vectors), else ``{}``.
    ``compile_cache_dir`` (or the ``REPRO_COMPILE_CACHE`` env var) is where
    the CUDA kernels are built and loaded from (``sweep.compile_cache``);
    pass ``False`` to leave the default build directory in place even when
    the env var is set.

    Observability (all optional, all pure observers):

    * ``trace`` -- a :class:`~repro_torch.obs.trace.TraceWriter`; the runner emits
      one plan span, one span per fused dispatch and one campaign bookend.
    * ``log`` -- a :class:`~repro_torch.obs.log.SweepLogger`; defaults to quiet
      when neither ``log`` nor ``progress`` is given.  The legacy
      ``progress`` callable maps to a debug-level logger with ``progress``
      as its sink, reproducing the old per-member output verbatim.
    * ``timing_split`` -- dispatch twice (the second call finds the kernels
      built and loaded and returns identical results) and report
      ``compile_s`` / ``execute_s`` separately in the trace.
    * ``profile_dir`` -- wrap execution in ``torch.profiler`` (CPU and, on a
      card, CUDA activity) and write its Chrome trace into the directory
      (skipped with a log line if the profiler cannot start).

    Robustness:

    * ``retry`` / ``backoff_s`` -- each dispatch (and each rung of the
      degradation ladder below it) gets ``retry`` extra attempts with
      exponential backoff ``backoff_s * 2**attempt`` before degrading:
      whole megabatch -> per-member dispatches -> serial per-point.  Points
      that fail terminally yield error spans instead of records; the
      campaign keeps going.  ``sleep`` is injectable for tests.
    * ``resume`` -- treat ``store``'s existing records as a checkpoint:
      dispatches whose full record block is already present are skipped,
      a partially-recorded dispatch is truncated off and re-run whole.
      With a canonical JSONL store the finished file is byte-identical to
      an uninterrupted run's.
    * ``cost_params`` -- a ``sweep.costmodel.CostParams`` for cost-modeled
      campaigns (``Campaign.planner == 'cost'``), e.g. calibrated from a
      measured trace via ``CostParams.from_trace``; ``None`` uses the
      model defaults.  The chosen policy, its predicted cost/fill and the
      rejected alternatives land in the plan span; the campaign bookend
      span carries the realized padded-row fill to compare against.
    """
    device = resolve_device(device)
    if log is None:
        log = (SweepLogger("debug", sink=progress) if progress is not None
               else SweepLogger("quiet"))
    cache_dir = (None if compile_cache_dir is False
                 else compile_cache.enable(compile_cache_dir))
    devices = torch.cuda.device_count() if device.type == "cuda" else 1
    p = plan(campaign, cost_params=cost_params)
    log.info(p.describe())
    if cache_dir:
        log.info(f"persistent compile cache: {cache_dir}")
    if trace:
        span = {
            "kind": "plan", "campaign": campaign.name,
            "n_points": p.n_points, "n_dispatches": p.n_dispatches,
            "n_shapes": p.n_shapes, "devices": devices,
            "engine": campaign.engine, "shard": campaign.shard,
            "probes": _probe_field(campaign),
            "cache_dir": str(cache_dir) if cache_dir else None,
        }
        if any(ph is not None for ph in campaign.phases):
            span["phases"] = [ph.label() if ph is not None else None
                              for ph in campaign.phases]
        if p.policy is not None:
            # Cost-modeled planning: the chosen policy, its predicted
            # cost/fill, and the rejected alternatives -- the prediction
            # the campaign bookend's realized fill is compared against.
            span["planner"] = "cost"
            span["policy"] = p.policy.label
            span["kmap"] = [list(kv) for kv in p.policy.kmap]
            span["pkt_exact"] = list(p.policy.pkt_exact)
            if p.cost is not None:
                span["predicted"] = p.cost.as_dict()
            span["alternatives"] = [
                {"policy": lbl, "cost": c, "pkt_fill": f}
                for (lbl, c, f) in p.alternatives]
            if cost_params is not None:
                span["calibration"] = cost_params.source
        trace.emit(span)
    cache = _Cache(device)
    store = store if store is not None else ResultStore(None)
    n_before = len(store.records)   # store may be shared across campaigns
    full: Dict = {}

    done = 0                        # dispatches already complete on resume
    if resume:
        # The checkpoint region is this campaign's block of pre-existing
        # records (records of other campaigns sharing the store never match
        # _point_key, which carries the campaign name).  Walk dispatches in
        # plan order; a dispatch counts as complete only if the store holds
        # its *entire* record block, in order, at the expected offset.
        # Everything after the last complete dispatch is truncated off (a
        # partially-recorded dispatch re-runs whole), so the finished file
        # is byte-identical to an uninterrupted run's.
        pos = next((i for i, r in enumerate(store.records)
                    if r.get("campaign") == campaign.name),
                   len(store.records))
        for mega in p.megabatches:
            keys = [_point_key(pt) for b in mega.members
                    for pt in b.points()]
            nxt = pos + len(keys)
            if (nxt <= len(store.records)
                    and all(_record_key(store.records[pos + i]) == kk
                            for i, kk in enumerate(keys))):
                pos, done = nxt, done + 1
            else:
                break
        store.truncate(pos)
        n_before = len(store.records)   # kept prefix is not "new" records
        kept = sum(len(b.seeds) for m in p.megabatches[:done]
                   for b in m.members)
        if trace:
            trace.emit({"kind": "resume", "campaign": campaign.name,
                        "dispatches_kept": done, "records_kept": kept})
        log.info(f"resume: {done}/{p.n_dispatches} dispatches already "
                 f"complete ({len(store.records)} records kept)")

    prof = contextlib.nullcontext()
    if profile_dir:
        try:
            from torch.profiler import (ProfilerActivity, profile,
                                        tensorboard_trace_handler)
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            prof = profile(activities=acts, on_trace_ready=(
                tensorboard_trace_handler(str(profile_dir))))
        except Exception as e:          # profiler unavailable here
            log.info(f"torch.profiler unavailable ({e}); profiling skipped")

    cache_files0 = _cache_files(cache_dir)
    real_rows = padded_rows = 0     # realized padded-row fill this run
    t0 = time.perf_counter()
    with prof:
        for idx, mega in enumerate(p.megabatches):
            if idx < done:          # resume: records already on disk
                continue
            span = _dispatch_span(idx, mega, campaign, campaign.shard,
                                  devices, device)
            real_rows += span["pkt_rows_real"]
            padded_rows += span["pkt_rows_padded"]
            run = (_run_loop_mega if mega.engine == "loop"
                   else _run_fast_mega)
            to_record = (loop_point_record if mega.engine == "loop"
                         else point_record)
            misses0 = _compile_misses()
            tb = time.perf_counter()
            per_member, rspans = _run_with_recovery(
                idx, mega, campaign, cache, run, retry=retry,
                backoff_s=backoff_s, sleep=sleep, log=log)
            t1 = time.perf_counter()
            span["wall_s"] = secs = t1 - tb
            span["cache"] = ("hit" if _compile_misses() == misses0
                             else "miss")
            if timing_split and not rspans:
                # The second dispatch finds every kernel built and loaded,
                # so its wall time is pure execute; the first call's excess
                # is the build (+ first-use) cost.  Results are identical by
                # the megabatch determinism contract.
                per_member = run(mega, campaign, cache)
                t2 = time.perf_counter()
                span["execute_s"] = t2 - t1
                span["compile_s"] = max(0.0, (t1 - tb) - (t2 - t1))
            if mega.engine == "loop":
                slots = [float(r.cct_acked_slots)
                         for results in per_member for r in results
                         if r is not None]
                span["slots_run"] = int(max(slots)) if slots else 0
                span["slot_fill"] = (span["slots_run"]
                                     / max(span["slot_budget"], 1))
            if trace:
                for s in rspans:    # retry/error/degrade, in event order
                    trace.emit(s)
                trace.emit(span)
            log.info(dispatch_line(span, p.n_dispatches))
            for batch, results in zip(mega.members, per_member):
                cp = (cache.compiled_phases(batch.k, batch.load, batch.phase)
                      if batch.phase is not None else None)
                for point, res in zip(batch.points(), results):
                    if res is None:     # terminal failure: error span only
                        continue
                    store.append(to_record(point, res, phases=cp))
                    if keep_full:
                        full[point] = res
                # Apportion the fused dispatch's wall time over members by
                # their share of fused points, so per-scheme timing summaries
                # stay meaningful.
                store.timings.append((batch, secs * len(batch.seeds)
                                      / max(mega.n_points, 1)))
                log.debug(f"  {batch.scheme:>16s} k={batch.k} "
                          f"{batch.load.label():<22s} x{len(batch.seeds)} "
                          f"seeds: {store.timings[-1][1]:.2f}s")
    wall = time.perf_counter() - t0
    if trace:
        trace.emit({
            "kind": "campaign", "campaign": campaign.name,
            "n_points": p.n_points, "n_dispatches": p.n_dispatches,
            # Realized padded-row fill over the dispatches this run
            # executed (resume-skipped dispatches excluded): the
            # measurement the plan span's predicted fill is checked
            # against, and the input --plan-from-trace calibrates on.
            "pkt_rows_real": real_rows,
            "pkt_rows_padded": padded_rows,
            "pkt_fill": real_rows / max(padded_rows, 1),
            "wall_s": wall,
            "cache_entries_added": (_cache_files(cache_dir) - cache_files0
                                    if cache_dir else 0),
            "emit_s": trace.emit_s,
        })
    log.info(f"campaign {campaign.name!r} done in {wall:.2f}s "
             f"({p.n_points} points, {p.n_dispatches} dispatches, "
             f"{p.n_shapes} shapes)")
    return store.records[n_before:], full
