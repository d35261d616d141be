"""Declarative campaign specifications.

A :class:`Campaign` is a grid over the paper's evaluation axes -- scheme x
load x tree size x seeds x failure pattern -- plus fixed engine options.  It
is data, not code: specs round-trip through JSON (``to_dict``/``from_dict``)
so campaigns can live in files and be launched from the CLI
(``python -m repro_torch.sweep run --spec ...``), and the named presets
below cover the paper's standing experiments (Table 2 contenders, the §6.1
theory schemes, the Fig. 7 layer-balance study).

The grid expands to :class:`GridPoint` records; the planner
(``sweep.planner``) then groups points that share a pipeline shape and
batches replicate seeds into single batched executions.

The spec format is the JAX reference's, strings included: ``backend`` keeps
``'auto'``/``'xla'``/``'pallas'`` (they appear in the planner's fused keys,
and so in every trace span), and ``loop_opts`` may carry the reference's
``impl`` values ``'lax'``/``'pallas'``/``'auto'``.  They map to the
engines' ``{auto, torch}`` switch only where an engine is called
(:func:`engine_backend`, :meth:`Campaign.loop_config`).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Tuple, Union

from ..core import lb_schemes as lbs
from ..faults import FaultSchedule
from ..obs.probes import ProbeSpec
from ..phases import PhaseSchedule, phases_from_dict


# The reference's backend strings -> the engines' {auto, torch} switch.
BACKENDS = {"auto": "auto", "pallas": "auto", "xla": "torch"}
# The reference's LoopConfig.impl values, all one body in the port.
REFERENCE_IMPLS = ("lax", "pallas", "auto")


def engine_backend(backend: str) -> str:
    """The fast engine's ``backend`` for a campaign's: ``'auto'`` and
    ``'pallas'`` launch the CUDA kernels on CUDA tensors (their plain
    versions on CPU tensors), ``'xla'`` takes the plain versions."""
    try:
        return BACKENDS[backend]
    except KeyError:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{sorted(BACKENDS)}") from None


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One traffic-matrix axis value (see ``net.workloads``)."""
    kind: str = "permutation"        # 'permutation' | 'all_to_all' | 'fsdp_rings'
    msg_packets: int = 256           # packets per flow (per dest for all_to_all)
    inter_pod_only: bool = False     # permutation only
    gpus_per_server: int = 8         # fsdp_rings only
    rng_seed: int = 1                # traffic-matrix randomness (not replicate seed)

    def label(self) -> str:
        """Unique within a campaign: every field that changes the traffic
        matrix appears here, since result aggregation groups by this label."""
        bits = [self.kind, f"m{self.msg_packets}"]
        if self.inter_pod_only:
            bits.append("xpod")
        if self.kind == "fsdp_rings":
            bits.append(f"g{self.gpus_per_server}")
        bits.append(f"r{self.rng_seed}")
        return "-".join(bits)

    def n_packets(self, k: int) -> int:
        """Packet count of this workload on a fat-tree of size ``k``, without
        materializing it (the planner buckets megabatch shapes by this)."""
        n_hosts = k ** 3 // 4
        if self.kind == "permutation":
            return n_hosts * self.msg_packets
        if self.kind == "all_to_all":
            return n_hosts * (n_hosts - 1) * self.msg_packets
        if self.kind == "fsdp_rings":
            return n_hosts * self.msg_packets
        raise ValueError(f"unknown workload kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class FailureSpec:
    """Random bidirectional link failures (paper §5.2 model).

    Patterns are drawn from the counter-keyed entropy streams
    (``core.entropy``, site ``SITE_LINK_FAIL``) by default -- pure functions
    of (rng_seed, link id), so the same spec yields the same pattern
    regardless of tree-construction order.  ``legacy_rng=True`` keeps the
    old sequential ``np.random`` draws for comparing against result files
    produced before the rekey.
    """
    p_fail: float
    rng_seed: int = 42
    legacy_rng: bool = False

    def label(self) -> str:
        legacy = "-np" if self.legacy_rng else ""
        return f"fail{self.p_fail:g}-r{self.rng_seed}{legacy}"


# The failure axis accepts both models: a static FailureSpec or a dynamic
# repro_torch.faults.FaultSchedule (mid-run link flaps; rides the fused campaign
# axis exactly like the static patterns -- the planner keys seed batches on
# the frozen value and fused dispatches never split on it).
FailureLike = Union[FailureSpec, FaultSchedule]


@dataclasses.dataclass(frozen=True)
class GridPoint:
    """One fully-specified simulation: a single cell of the campaign grid."""
    campaign: str
    k: int
    load: WorkloadSpec
    failure: Optional[FailureLike]
    scheme: str
    seed: int
    g_converge: Optional[int] = None   # loop engine routing-convergence slot
    timing: Optional[Tuple[int, int]] = None  # (prop_slots, ack_delay) sweep
    # Collective-phase schedule (repro_torch.phases): when set, the point's
    # traffic is the schedule compiled on its tree (the load contributes
    # msg_packets scaling + traffic rng seed; its kind is ignored).
    phase: Optional[PhaseSchedule] = None

    def point_id(self) -> str:
        fail = self.failure.label() if self.failure else "nofail"
        g = "" if self.g_converge is None else f"G{self.g_converge}/"
        tm = ("" if self.timing is None
              else f"p{self.timing[0]}a{self.timing[1]}/")
        ph = "" if self.phase is None else f"{self.phase.label()}/"
        return (f"{self.campaign}/k{self.k}/{self.load.label()}/{ph}{fail}/"
                f"{g}{tm}{self.scheme}/s{self.seed}")

    def n_packets(self, k: Optional[int] = None) -> int:
        """Packet count of this point's (possibly phased) traffic on a
        fat-tree of size ``k`` (default: the point's own tree) without
        materializing it -- shared by the planner's shape bucketing, the
        cost model and the runner's fill accounting."""
        k = self.k if k is None else int(k)
        if self.phase is not None:
            return self.phase.n_packets(k, self.load.msg_packets)
        return self.load.n_packets(k)


@dataclasses.dataclass(frozen=True)
class Campaign:
    """A declarative sweep: the cartesian product of the axis tuples.

    ``engine`` selects the execution backend: ``'fast'`` (the max-plus
    engine, megabatched via one fused dispatch per pipeline shape) or
    ``'loop'`` (the slotted feedback engine -- required for ACK/ECN schemes
    like REPS and PLB).  ``backend`` is the fast engine's kernel switch:
    ``'auto'`` and ``'pallas'`` launch the CUDA kernels on a card (their
    plain versions on the CPU), ``'xla'`` runs the plain PyTorch versions
    (:func:`engine_backend`).  ``g_converge`` is a grid axis of
    routing-convergence slots for loop-engine points (None = never converge;
    fast-engine campaigns leave it at the default ``(None,)``).  Rows whose
    ``failures`` entry is a dynamic ``FaultSchedule`` ignore ``g_converge``
    entirely -- the schedule's own ``host_react``/``switch_react`` delays
    play its role, per epoch.
    ``max_slots`` is the loop-engine slot budget -- a first-class field: the
    batched engine takes it as a per-row *operand* (so differing budgets
    share one dispatch; the planner's fused keys carry only its
    power-of-two bucket), and legacy specs that carried it inside
    ``loop_opts`` auto-migrate.  ``loop_opts``
    carries the remaining ``net.loopsim.LoopConfig`` overrides plus the
    special key ``rho`` (sending rate; the string ``'auto'`` means rho_max
    under the point's failure pattern, Appendix A).
    ``shard`` controls device sharding of fused megabatch dispatches:
    ``'auto'`` cuts the fused axis into one chunk per visible CUDA device,
    ``'off'`` keeps it on one device.
    ``probes`` opts points into carrying a downsampled per-layer
    queue-occupancy time series out of the engines
    (``repro_torch.obs.probes``);
    ``None`` (the default) leaves every output bitwise-identical to a
    probe-free build.
    ``timings`` is a loop-engine grid axis of ``(prop_slots, ack_delay)``
    pairs (``None`` = the campaign's ``prop_slots`` field plus the
    ``loop_opts`` ``ack_delay``).  The engine buckets both constants to
    powers of two for its delay-ring *shapes* and indexes the rings modulo
    the real per-row values, so a timing sweep shares one compiled
    pipeline per bucket instead of compiling per point.
    ``planner`` selects the bucket policy: ``'heuristic'`` (greedy 2x
    k-buckets + pow2 packet buckets) or ``'cost'`` (the
    ``sweep.costmodel`` per-campaign cost model: candidate bucketings
    scored by padded packet rows + slot-budget waste + a per-new-shape
    compile charge, dispatches ordered largest-first).
    """
    name: str
    schemes: Tuple[str, ...]
    loads: Tuple[WorkloadSpec, ...]
    trees: Tuple[int, ...] = (8,)
    seeds: Tuple[int, ...] = (0,)
    failures: Tuple[Optional[FailureLike], ...] = (None,)
    g_converge: Tuple[Optional[int], ...] = (None,)
    prop_slots: float = 12.0
    backend: str = "auto"
    engine: str = "fast"
    shard: str = "auto"
    max_slots: int = 200_000           # loop-engine slot budget
    loop_opts: Tuple[Tuple[str, object], ...] = ()
    probes: Optional[ProbeSpec] = None  # opt-in queue time-series capture
    timings: Tuple[Optional[Tuple[int, int]], ...] = (None,)
    planner: str = "heuristic"         # 'heuristic' | 'cost'
    # Collective-phase axis (repro_torch.phases.PhaseSchedule): ``None`` rows are
    # the static workloads; schedule rows compile phased traffic from the
    # row's load (msg_packets scaling + rng seed) and ride the fused
    # campaign axis like any other grid dimension.
    phases: Tuple[Optional[PhaseSchedule], ...] = (None,)

    def __post_init__(self):
        for s in self.schemes:
            try:
                lbs.by_name(s)
            except KeyError:
                raise KeyError(
                    f"unknown scheme {s!r} in campaign {self.name!r}; "
                    f"see repro_torch.core.lb_schemes.by_name") from None
        if self.engine not in ("fast", "loop"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.shard not in ("auto", "off"):
            raise ValueError(f"unknown shard policy {self.shard!r}")
        if self.planner not in ("heuristic", "cost"):
            raise ValueError(f"unknown planner {self.planner!r}")
        for ph in self.phases:
            if ph is not None and not isinstance(ph, PhaseSchedule):
                raise ValueError(f"phases entries must be PhaseSchedule or "
                                 f"None, got {type(ph).__name__}")
        for tm in self.timings:
            if tm is None:
                continue
            if self.engine != "loop":
                raise ValueError("timings is a loop-engine axis; fast-"
                                 "engine campaigns must leave it at (None,)")
            if len(tm) != 2 or int(tm[0]) < 0 or int(tm[1]) < 0:
                raise ValueError(f"bad timings entry {tm!r}: expected "
                                 f"(prop_slots, ack_delay) with both >= 0")
        # Legacy spec migration: g_converge and max_slots used to live in
        # loop_opts; the spec layer is now their single source of truth.
        opts = dict(self.loop_opts)
        if "g_converge" in opts:
            g = opts.pop("g_converge")
            if self.g_converge == (None,):
                object.__setattr__(self, "g_converge", (g,))
        if "max_slots" in opts:
            m = opts.pop("max_slots")
            if self.max_slots == 200_000:
                object.__setattr__(self, "max_slots", int(m))
        if len(opts) != len(self.loop_opts):
            object.__setattr__(self, "loop_opts", tuple(sorted(opts.items())))

    @property
    def _uniq_trees(self) -> Tuple[int, ...]:
        """The tree axis with duplicates dropped (first occurrence wins):
        a repeated ``k`` would emit the exact same grid points twice."""
        return tuple(dict.fromkeys(int(k) for k in self.trees))

    @property
    def n_points(self) -> int:
        n_sched = sum(isinstance(f, FaultSchedule) for f in self.failures)
        fail_rows = ((len(self.failures) - n_sched) * len(self.g_converge)
                     + n_sched)
        return (len(self._uniq_trees) * len(self.loads) * len(self.phases)
                * fail_rows * len(self.timings) * len(self.schemes)
                * len(self.seeds))

    def loop_options(self) -> Dict:
        return dict(self.loop_opts)

    def loop_config(self, rho: float = 1.0,
                    timing: Optional[Tuple[int, int]] = None):
        """The ``net.loopsim.LoopConfig`` this campaign's loop-engine points
        run under (``rho`` is the one per-point field; 'auto' is resolved by
        the runner; ``timing`` is a grid point's ``timings`` axis value and
        overrides the ``prop_slots``/``ack_delay`` defaults).  The planner
        keys fused loop dispatches by its static part
        (``loopsim.static_config``), so this is the single place the
        spec-to-engine translation happens: a reference ``impl`` of
        ``'lax'``, ``'pallas'`` or ``'auto'`` becomes the port's ``'auto'``
        (the kernels on a card), as ``interop.from_reference`` maps a
        ``LoopConfig``."""
        from ..net import loopsim
        opts = self.loop_options()
        opts.pop("rho", None)
        if opts.get("impl") in REFERENCE_IMPLS:
            opts["impl"] = "auto"
        prop = int(round(self.prop_slots))
        if timing is not None:
            prop = int(timing[0])
            opts["ack_delay"] = int(timing[1])
        return loopsim.LoopConfig(prop_slots=prop,
                                  rho=float(rho), max_slots=self.max_slots,
                                  **opts)

    def points(self):
        """Expand the grid in a deterministic order (seeds innermost, so
        replicate runs of one point are adjacent for the planner)."""
        for k, load, phase, failure, g, tm, scheme, seed in itertools.product(
                self._uniq_trees, self.loads, self.phases, self.failures,
                self.g_converge, self.timings, self.schemes, self.seeds):
            if isinstance(failure, FaultSchedule):
                # Schedule rows ignore the g_converge axis (their reaction
                # delays live in the schedule): emit once, at g=None,
                # instead of duplicating the point per axis value.
                if g != self.g_converge[0]:
                    continue
                g = None
            yield GridPoint(campaign=self.name, k=k, load=load,
                            failure=failure, scheme=scheme, seed=seed,
                            g_converge=g, timing=tm, phase=phase)

    # ---- JSON round-trip ---------------------------------------------------
    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["loads"] = [dataclasses.asdict(l) for l in self.loads]
        # FaultSchedule dicts carry a "kind": "schedule" discriminator so
        # from_dict can tell the two failure models apart.
        d["failures"] = [f.to_dict() if isinstance(f, FaultSchedule)
                         else (dataclasses.asdict(f) if f else None)
                         for f in self.failures]
        d["loop_opts"] = dict(self.loop_opts)
        if self.probes is not None:
            d["probes"] = dataclasses.asdict(self.probes)
        # Only-when-set (the timings/records pattern): pre-phase specs
        # round-trip byte-identically.
        if all(p is None for p in self.phases):
            d.pop("phases")
        else:
            d["phases"] = [p.to_dict() if p is not None else None
                           for p in self.phases]
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "Campaign":
        d = dict(d)
        d["schemes"] = tuple(d["schemes"])
        d["loads"] = tuple(WorkloadSpec(**l) for l in d["loads"])
        d["trees"] = tuple(d.get("trees", (8,)))
        d["seeds"] = tuple(d.get("seeds", (0,)))
        d["failures"] = tuple(
            (FaultSchedule.from_dict(f) if f.get("kind") == "schedule"
             else FailureSpec(**f)) if f else None
            for f in d.get("failures", [None]))
        d["g_converge"] = tuple(d.get("g_converge", [None]))
        d["timings"] = tuple(
            tuple(int(x) for x in tm) if tm is not None else None
            for tm in d.get("timings", [None]))
        d["shard"] = d.get("shard", "auto")
        d["phases"] = tuple(phases_from_dict(p)
                            for p in d.get("phases", [None]))
        d["loop_opts"] = tuple(sorted(d.get("loop_opts", {}).items()))
        pr = d.get("probes")
        d["probes"] = ProbeSpec(**pr) if isinstance(pr, dict) else pr
        return cls(**d)


# ---------------------------------------------------------------------------
# Named presets: the paper's standing experiments.
# ---------------------------------------------------------------------------

def _table2(trees: Tuple[int, ...] = (8,),
            seeds: Tuple[int, ...] = (0, 1, 2, 3)) -> Campaign:
    """Fast-engine Table 2 contenders + DR schemes, permutation and
    all-to-all (the Fig. 1 comparison grid)."""
    return Campaign(
        name="table2",
        schemes=("flow_ecmp", "subflow_mptcp", "host_pkt", "switch_pkt",
                 "switch_pkt_ar", "host_dr", "ofan"),
        loads=(WorkloadSpec("permutation", 256),
               WorkloadSpec("all_to_all", 8)),
        trees=trees, seeds=seeds)


def _fig1(trees: Tuple[int, ...] = (4, 6, 8),
          seeds: Tuple[int, ...] = (0, 1)) -> Campaign:
    """The Fig. 1 contender comparison swept over fat-tree size: all three
    trees pad to one k-bucket, so the whole grid runs as ONE fused dispatch
    per compiled pipeline shape (4 shapes: pre/pre, rr_reset, jsq_quant,
    ofan) -- dispatch count does not scale with the number of tree sizes."""
    return Campaign(
        name="fig1",
        schemes=("flow_ecmp", "subflow_mptcp", "host_pkt", "switch_pkt",
                 "switch_pkt_ar", "host_dr", "ofan"),
        loads=(WorkloadSpec("permutation", 64),),
        trees=trees, seeds=seeds)


def _theory(trees: Tuple[int, ...] = (8,),
            seeds: Tuple[int, ...] = (0, 1, 2, 3)) -> Campaign:
    """§6.1 simplified theory schemes over the Table-3 message-size ladder
    (inter-pod permutations; the queue-scaling-law clusters)."""
    return Campaign(
        name="theory",
        schemes=("simple_rr", "jsq", "rsq", "host_pkt", "host_dr", "ofan"),
        loads=tuple(WorkloadSpec("permutation", m, inter_pod_only=True,
                                 rng_seed=2) for m in (64, 256, 1024)),
        trees=trees, seeds=seeds)


def _layer_balance(trees: Tuple[int, ...] = (8,),
                   seeds: Tuple[int, ...] = (5,)) -> Campaign:
    """Fig. 7 worst-case per-layer overload study."""
    return Campaign(
        name="layer_balance",
        schemes=("simple_rr", "jsq", "host_pkt", "host_dr", "ofan"),
        loads=(WorkloadSpec("permutation", 256, inter_pod_only=True,
                            rng_seed=4),),
        trees=trees, seeds=seeds)


def _failures(trees: Tuple[int, ...] = (4,),
              seeds: Tuple[int, ...] = (0,)) -> Campaign:
    """Loop-engine failure study skeleton (examples/simulate_fabric.py runs
    its G-convergence sweep by widening the g_converge axis)."""
    return Campaign(
        name="failures",
        schemes=("host_pkt_ar", "switch_pkt_ar", "ofan"),
        loads=(WorkloadSpec("permutation", 64, inter_pod_only=True),),
        trees=trees, seeds=seeds,
        failures=(FailureSpec(p_fail=0.08, rng_seed=42),),
        g_converge=(0,),
        engine="loop", max_slots=20000,
        loop_opts=(("rho", "auto"), ("rto_slots", 250)))


def _flap(trees: Tuple[int, ...] = (4,),
          seeds: Tuple[int, ...] = (0, 1)) -> Campaign:
    """Robustness study: clean rows, a static random-failure pattern and a
    3-epoch mid-run link flap (down at slot 256, back up at 768) share the
    failure axis -- all three fuse onto one dispatch per compiled shape, so
    ``n_dispatches == n_shapes`` exactly as for purely static campaigns.
    Schedule rows take their convergence semantics from the reaction
    delays (host schemes re-draw labels at +64, switch-local state
    converges at +192); the ``g_converge`` axis applies to the static
    FailureSpec row only."""
    return Campaign(
        name="flap",
        schemes=("host_pkt_ar", "switch_pkt_ar", "ofan"),
        loads=(WorkloadSpec("permutation", 48, inter_pod_only=True),),
        trees=trees, seeds=seeds,
        failures=(None,
                  FailureSpec(p_fail=0.08, rng_seed=42),
                  FaultSchedule.flap(layer="ea", pod=0, i=0, j=1, t0=256,
                                     period=512, cycles=1, host_react=64,
                                     switch_react=192)),
        g_converge=(64,),
        engine="loop", max_slots=20000,
        loop_opts=(("rho", "auto"), ("rto_slots", 250)))


def _fig12(trees: Tuple[int, ...] = (8,),
           seeds: Tuple[int, ...] = (0, 1)) -> Campaign:
    """Fig. 12 SACK loss-recovery grid on the loop engine: the scheme x
    load x seed axes run as fused megabatch dispatches (host_pkt and
    host_dr share the 'pre/pre' slotted pipeline and fuse; adaptive and
    switch schemes each compile their own shape).  Sweeping ``trees``
    keeps one dispatch per shape for EVERY scheme -- switch_pkt_ar's
    in-loop JSQ randomness rides counter streams keyed on logical ids
    (``core.entropy``), so it k-buckets like the rest."""
    return Campaign(
        name="fig12",
        schemes=("host_pkt", "host_dr", "switch_pkt_ar", "host_pkt_ar",
                 "ofan"),
        loads=(WorkloadSpec("permutation", 256, rng_seed=1),),
        trees=trees, seeds=seeds,
        engine="loop", max_slots=60000,
        loop_opts=(("loss", "sack"), ("sack_thresh", 32)))


def _train_iter(trees: Tuple[int, ...] = (4,),
                seeds: Tuple[int, ...] = (0, 1),
                iterations: int = 2) -> Campaign:
    """Collective-phase training campaign: the Table-2 contender schemes
    under a DeepSeek-V3-671B-derived phase schedule (MoE dispatch/combine
    all-to-alls, the gradient all-reduce, the over-pod FSDP ring) repeated
    for ``iterations`` training steps, crossed with two message-size loads.
    The iteration-time section of ``sweep report`` reads this campaign's
    per-iteration makespans; phased points fuse exactly like static ones
    (``n_dispatches == n_shapes``)."""
    sched = PhaseSchedule.from_model("deepseek-v3-671b", ep=8, dp=8,
                                     iterations=iterations)
    return Campaign(
        name="train_iter",
        schemes=("flow_ecmp", "host_pkt", "host_dr", "ofan"),
        loads=(WorkloadSpec("permutation", 8),
               WorkloadSpec("permutation", 16)),
        trees=trees, seeds=seeds,
        phases=(sched,))


PRESETS = {
    "table2": _table2,
    "fig1": _fig1,
    "theory": _theory,
    "layer_balance": _layer_balance,
    "failures": _failures,
    "flap": _flap,
    "fig12": _fig12,
    "train_iter": _train_iter,
}


def preset(name: str, **kw) -> Campaign:
    try:
        factory = PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; available: "
                       f"{', '.join(sorted(PRESETS))}") from None
    return factory(**kw)
