"""Slotted feedback engine (the "loop" simulator), in PyTorch.

A port of the JAX reference ``repro.net.loopsim``, bitwise equal to it per
point.  It complements ``fastsim``: a time-stepped simulation carrying the
*feedback* the layered max-plus engine cannot: ECN-marked ACKs (REPS, PLB),
windowed congestion control (MSwift), SACK loss recovery, link failures
with routing-convergence time ``G``, and finite buffers with drops.

Model (one step = one data-packet slot):

  * every queue (5 fat-tree layers, finite capacity) serves one packet/slot;
  * served packets travel ``prop_slots`` and are enqueued at the next stage;
    edge/aggregation port choices follow the scheme (host labels / RR or OFAN
    pointers / (quantized) JSQ on live queue lengths);
  * queues mark ECN on enqueue above the marking threshold and drop when full;
  * deliveries generate ACKs returning after a constant ``ack_delay``; ACKs
    never queue but consume the host NIC byte budget (ack debt);
  * hosts pace with the ideal fixed-rate CCA at ``rho`` or with MSwift;
  * loss recovery: ideal rateless erasure coding (§4) or SACK with
    reordering threshold ``x`` (§8.2, ``loss="sack"``).

Failures: a static ``links``/``g_converge`` pair, or a dynamic fault
schedule (``fault=``, a :class:`repro_torch.faults.FaultSchedule`) that
compiles to E link-state epochs: every link-derived operand carries a
leading epoch axis the loop gathers by slot, the physical state switching
at each epoch start and the routing state a per-scheme reaction delay
later.  The static pair is the one-epoch case.

The step body runs on a leading batch axis ``(B, ...)``: one row per fused
point.  Five of its blocks are kernels (``repro_torch.kernels.slot_step``):
the edge JSQ pick, the agg JSQ pick fused with the arrival enqueue, the
plain arrival enqueue, and under SACK the receiver-bitmap update with the
per-flow first-missing scan and the cumulative-ack advance; the RR/OFAN
pointer ranks go through ``rank_by`` and so through the Lindley kernel.
On CUDA tensors they launch the CUDA kernels, on CPU tensors their plain
versions; ``LoopConfig.impl="torch"`` takes the plain versions on any
device.

The reference's ``lax.while_loop`` becomes a host loop over chunks of
:data:`CHUNK_SLOTS` slots that reads the rows' done flags once per chunk.
Rows freeze explicitly, as the ``vmap`` rule of ``while_loop`` freezes
them: each row's predicate ``any(f_complete < 0) & (t < max_slots)`` is
evaluated before every step, and a row whose predicate is false keeps its
whole state.  Every row still running shares the slot ``t``, a host integer.

Dispatch granularities: :func:`simulate` (one point, one seed),
:func:`simulate_batch` (one point, many seeds) and
:func:`simulate_megabatch` (many points sharing a pipeline identity fused
onto one batch axis, optionally split over several CUDA devices) -- all
bitwise-identical per point.  Host-side preparation and per-seed draws stay
numpy, copied from the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .topology import FatTree, LinkState
from .workloads import Workload
from ._batching import (TreePad, pad_tail, pad_to_group_max,
                        port_pad_penalty, pow2_bucket, rank_by, shard_pad)
from ..core.lb_schemes import LBScheme, precompute_host_choices
from ..core import entropy as ent
from ..core import ofan as ofan_mod
from ..obs.probes import QueueProbe, probe_shape
from ..kernels._common import resolve_device
from ..kernels.jsq_scan.ref import fma32
from ..kernels.slot_step import ops as _slot

LOOP_IMPLS = ("auto", "torch")
# Slots run between two reads of the rows' done flags (one host sync each).
CHUNK_SLOTS = 32
# Slots stepped by the host loop, summed over every engine run (a plain
# counter for measurements, like the kernels' LAUNCHES).
STEPS = 0


@dataclasses.dataclass
class LoopSimResult:
    delivered_slot: np.ndarray      # per-packet first-delivery slot (-1 never)
    flow_complete_slot: np.ndarray  # per-flow full-message-ACKed slot
    flow_data_done_slot: np.ndarray  # per-flow all-data-delivered slot
    cct_slots: float                # data CCT (max flow_data_done)
    cct_acked_slots: float          # ACK-complete CCT
    drops: int
    retransmissions: int
    max_queue: int
    avg_queue: float
    finished: bool
    mean_cwnd: float
    # Queue-occupancy time series (5 layers x samples windows), present only
    # when the point ran with a probe spec (repro.obs.probes); its max over
    # layers and time equals ``max_queue`` exactly.
    probe: Optional[QueueProbe] = None


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    cca: str = "ideal"             # 'ideal' | 'mswift'
    loss: str = "erasure"          # 'erasure' | 'sack'
    rho: float = 1.0               # ideal CCA rate (rho_max under failures)
    prop_slots: int = 12
    ack_delay: int = 74            # return path: ~6*prop + serialization
    buffer_pkts: int = 195
    ecn_frac: float = 0.5          # marking threshold (fraction of buffer)
    sack_thresh: int = 32          # reordering threshold x (§8.2)
    rto_slots: int = 400
    ack_cost: float = 0.0206       # ack bytes / slot bytes (86/4178)
    bdp_pkts: int = 150
    max_slots: int = 200_000
    plb_alpha: int = 64            # PLB: min packets between label changes
    plb_beta: float = 0.4          # PLB: EWMA mark fraction trigger
    # MSwift (App. H): target delay = BDP + queueing component.
    sw_target_slots: float = 180.0
    sw_ai: float = 1.0
    sw_beta: float = 0.8
    sw_max_cwnd: float = 384.0
    # Slot-step kernels (repro_torch.kernels.slot_step): 'auto' launches
    # the CUDA kernels on CUDA tensors and runs their plain versions on CPU
    # tensors; 'torch' runs the plain versions on any device.  The
    # reference's 'lax', 'pallas' and 'auto' map to 'auto'
    # (interop.from_reference).  Bitwise-identical outputs either way.
    impl: str = "auto"


def static_config(cfg: LoopConfig) -> LoopConfig:
    """The shape-relevant normalization of a LoopConfig.

    ``rho`` and ``max_slots`` ride as per-row *operands* of the batched
    engine (so an rho_max axis or differing slot budgets share one
    dispatch), and the timing constants ``prop_slots``/``ack_delay``
    bucket to the next power of two: they only set the ``DELAY``/``ADELAY``
    ring-buffer *shapes*, while every ring index is taken modulo the
    point's real constants (per-row operands) -- rows past a point's real
    modulus stay at their init value and are never read, keeping results
    bitwise-identical to serial.  Every other field is fixed for the whole
    batch -- either through shapes (``buffer_pkts``) or through Python
    branches (``cca``, ``loss``, ``impl``).  Two points whose
    ``static_config`` are equal can fuse into one megabatch dispatch.
    """
    return dataclasses.replace(
        cfg, rho=0.0, max_slots=0,
        prop_slots=pow2_bucket(max(int(cfg.prop_slots), 1)),
        ack_delay=pow2_bucket(max(int(cfg.ack_delay), 1)))


@dataclasses.dataclass(frozen=True)
class _Static:
    n: int; h: int; mid: int; F: int; P: int; Fh: int
    n_edges: int; n_aggs: int; n_pods: int
    edge_mode: str; agg_mode: str
    quanta: Optional[Tuple[float, ...]]
    adaptive_host: bool
    plb: bool
    cfg: LoopConfig                 # normalized via static_config()
    # Probe grid (stride, samples); (0, 0) = probes off.  Static: the series
    # buffer shape is baked into the compiled engine, so probed campaigns
    # still fuse into one dispatch per pipeline shape.
    probe: Tuple[int, int] = (0, 0)


@dataclasses.dataclass
class LoopPlan:
    """Seed-independent preparation of one (tree, workload, scheme, cfg,
    links, g_converge | fault) simulation point.

    Splitting this out of :func:`simulate` is what makes seed replication
    and point fusion batchable: everything here is identical across seeds,
    while :func:`_draw_seed_inputs` produces the per-seed operands that
    become the leading ``vmap`` axis in :func:`simulate_batch` /
    :func:`simulate_megabatch`.

    ``ep_links`` is the fault-epoch timeline (one entry, the static link
    state, when no schedule was given); every link-derived table carries a
    leading epoch axis the engine gathers by current slot.  ``pv`` mirrors
    it: one per-flow path-validity stack per epoch (or None).
    """
    tree: FatTree
    wl: Workload
    scheme: LBScheme
    cfg: LoopConfig
    links: LinkState                 # epoch-0 link state
    ep_links: list
    any_fail: bool
    pv: Optional[list]
    fsrc: np.ndarray
    fdst: np.ndarray
    static: _Static
    tables: dict

    @property
    def n_epochs(self) -> int:
        return len(self.ep_links)


def _prepare(tree: FatTree, wl: Workload, scheme: LBScheme,
             cfg: LoopConfig = LoopConfig(),
             links: Optional[LinkState] = None,
             g_converge: Optional[int] = None, probes=None,
             fault=None) -> LoopPlan:
    """Host-side precomputation shared by every seed of a simulation point.

    ``fault`` (a :class:`repro_torch.faults.FaultSchedule`) is the dynamic
    alternative to the static ``links``/``g_converge`` pair: it compiles to
    an epoch timeline whose link states become stacked, slot-gathered
    operands, with per-scheme reaction delays in place of the single
    convergence slot.  The static pair lowers to the same machinery with
    one epoch starting at slot 0 and reacting at ``g_converge``.
    """
    _check_config(cfg)
    h = tree.half
    n = tree.n_hosts
    P = wl.n_packets
    F = wl.n_flows
    mid = tree.queues_per_mid_layer

    fsrc = wl.flow_src.astype(np.int32)
    fdst = wl.flow_dst.astype(np.int32)
    fsize = wl.flow_size.astype(np.int32)
    pkt_base = np.zeros(F + 1, dtype=np.int64)
    np.cumsum(fsize, out=pkt_base[1:])
    if not (wl.flow == np.repeat(np.arange(F), fsize)).all():
        raise ValueError("loopsim expects flow-contiguous packet layout")
    # Per-flow start gate (collective-phase schedules): a flow may not send
    # before its phase's start slot.  All-zero (every static workload) is
    # bitwise-inert in the engine's send mask.
    f_start = (np.zeros(F, dtype=np.int32) if wl.flow_start is None
               else np.asarray(wl.flow_start, dtype=np.int32))

    fp1 = tree.host_pod(fsrc).astype(np.int32)
    fe1 = tree.host_edge(fsrc).astype(np.int32)
    fp2 = tree.host_pod(fdst).astype(np.int32)
    fe2 = tree.host_edge(fdst).astype(np.int32)
    f_inter = fp1 != fp2
    f_leaves = f_inter | (fe1 != fe2)

    Fh = int(np.bincount(fsrc, minlength=n).max()) if F else 1
    host_flows = np.full((n, Fh), -1, dtype=np.int32)
    cnt = np.zeros(n, dtype=np.int64)
    for f, sh in enumerate(fsrc.tolist()):
        host_flows[sh, cnt[sh]] = f
        cnt[sh] += 1

    # ---- fault-epoch timeline ---------------------------------------------
    # Static (links, g_converge) lowers to a single epoch starting at slot 0
    # whose routing reacts at g_converge; a FaultSchedule compiles to E
    # epochs with per-scheme reaction delays.  Every link-derived table
    # below carries a leading epoch axis the engine gathers by slot.
    if fault is not None:
        if links is not None or g_converge is not None:
            raise ValueError("pass either fault= or links=/g_converge=, "
                             "not both")
        comp = fault.compile(tree)
        ep_links = list(comp.links)
        ep_start = np.asarray(comp.ep_start, np.int32)
        r_start = comp.react_starts(scheme.reaction_class())
    else:
        ep_links = [links if links is not None else LinkState.all_up(tree)]
        ep_start = np.zeros(1, np.int32)
        r_start = np.asarray(
            [g_converge if g_converge is not None else 2**30], np.int32)
    E = len(ep_links)
    links = ep_links[0]
    any_fail = any(l.any_failure() for l in ep_links)

    alive = np.stack([np.concatenate([
        l.ea.reshape(-1),                           # UP_E (pod,edge,agg)
        l.ac.reshape(-1),                           # UP_A (pod,agg,sub)
        l.ac.reshape(-1),                           # DN_C (pod,agg,sub)
        np.transpose(l.ea, (0, 2, 1)).reshape(-1),  # DN_A (pod,agg,edge)
        np.ones(n, bool)]) for l in ep_links])

    # Per-(switch, destination-group) valid port sets (W-ECMP reachability):
    # used by switch schemes after routing convergence.  Edge switches group
    # destinations by destination edge switch, aggregation switches by
    # destination pod (the same consolidation OFAN exploits).
    n_edges = tree.n_edge_switches
    n_aggs = tree.n_agg_switches

    def _port_lists(valid3d):  # (S, Gd, h) bool -> padded lists + counts
        S, Gd, _ = valid3d.shape
        ports = np.zeros((S * Gd, h), np.int32)
        cnts = np.zeros(S * Gd, np.int32)
        flat = valid3d.reshape(S * Gd, h)
        for i in range(S * Gd):
            alive_p = np.flatnonzero(flat[i])
            if len(alive_p) == 0:
                alive_p = np.arange(h)
            reps = int(np.ceil(h / len(alive_p)))
            ports[i] = np.tile(alive_p, reps)[:h]
            cnts[i] = len(alive_p)
        return ports, cnts

    def _wecmp_valid(l):
        # edge: valid uplink a for (src edge (p1,e1), dst edge (p2,e2))
        valid_e = np.zeros((n_edges, n_edges, h), bool)
        for se in range(n_edges):
            sp, sei = divmod(se, h)
            for de in range(n_edges):
                dp, dei = divmod(de, h)
                if se == de:
                    valid_e[se, de] = l.ea[sp, sei, :]
                    continue
                valid_e[se, de] = l.wecmp_edge_weights(sp, sei, dp, dei) > 0
        # agg: valid core sub-link c for (agg (p,a), dst pod)
        valid_a = np.zeros((n_aggs, tree.n_pods, h), bool)
        for ga in range(n_aggs):
            sp, ai = divmod(ga, h)
            for dp in range(tree.n_pods):
                if dp == sp:
                    valid_a[ga, dp] = l.ac[sp, ai, :]  # unused southbound
                else:
                    valid_a[ga, dp] = l.ac[sp, ai, :] & l.ac[dp, ai, :]
        return valid_e, valid_a

    e_ports = np.zeros((E, n_edges * n_edges, h), np.int32)
    e_pcnt = np.zeros((E, n_edges * n_edges), np.int32)
    a_ports = np.zeros((E, n_aggs * tree.n_pods, h), np.int32)
    a_pcnt = np.zeros((E, n_aggs * tree.n_pods), np.int32)
    e_dead = np.zeros((E, n_edges, n_edges, h), bool)
    a_dead = np.zeros((E, n_aggs, tree.n_pods, h), bool)
    for e_i, l in enumerate(ep_links):
        valid_e, valid_a = _wecmp_valid(l)
        e_ports[e_i], e_pcnt[e_i] = _port_lists(valid_e)
        a_ports[e_i], a_pcnt[e_i] = _port_lists(valid_a)
        e_dead[e_i] = ~valid_e
        a_dead[e_i] = ~valid_a

    # Path-validity matrices (seed-independent, rng-free): consumed by the
    # per-seed host-choice precompute and the REPS/PLB valid-label lists.
    # One (F, h, h) stack per epoch.
    pv = None
    if any_fail and (scheme.edge_mode == "pre" or scheme.adaptive_host):
        pv = [np.stack([l.path_matrix(int(s_), int(d_))
                        for s_, d_ in zip(fsrc, fdst)]) for l in ep_links]

    # Valid-path list per flow and epoch: post-convergence the W-ECMP rehash
    # maps any flow label onto an alive path (paper §5.2).  REPS/PLB labels.
    f_vpaths = np.tile(np.arange(h * h, dtype=np.int32), (E, F, 1))
    f_vcnt = np.full((E, F), h * h, dtype=np.int32)
    if any_fail and scheme.adaptive_host:
        for e_i in range(E):
            for fi in range(F):
                cand = np.flatnonzero(pv[e_i][fi].reshape(-1))
                if len(cand) == 0:
                    cand = np.arange(h * h)
                reps = int(np.ceil(h * h / len(cand)))
                f_vpaths[e_i, fi] = np.tile(cand, reps)[:h * h]
                f_vcnt[e_i, fi] = len(cand)

    static = _Static(
        n=n, h=h, mid=mid, F=F, P=P, Fh=Fh,
        n_edges=n_edges, n_aggs=n_aggs, n_pods=tree.n_pods,
        edge_mode=scheme.edge_mode, agg_mode=scheme.agg_mode,
        quanta=(tuple(scheme.quanta) if scheme.edge_mode == "jsq_quant"
                else None),
        adaptive_host=scheme.adaptive_host,
        plb=scheme.name == "host_flowlet_ar",
        cfg=static_config(cfg),
        probe=probe_shape(probes))

    tables = dict(
        fsrc=fsrc, fdst=fdst, fsize=fsize, pkt_base=pkt_base,
        fp1=fp1, fe1=fe1, fp2=fp2, fe2=fe2, f_start=f_start,
        f_inter=f_inter, f_leaves=f_leaves, host_flows=host_flows,
        alive=alive, ep_start=ep_start, r_start=r_start,
        e_ports=e_ports, e_pcnt=e_pcnt, a_ports=a_ports, a_pcnt=a_pcnt,
        e_dead=e_dead, a_dead=a_dead,
        f_vpaths=f_vpaths, f_vcnt=f_vcnt,
        rho=np.float32(cfg.rho), max_slots=np.int32(cfg.max_slots),
        # Logical port count: an operand, so a point padded onto a larger
        # tree's compiled engine still decodes labels / rotates pointers
        # over its own k/2 ports.
        h_log=np.int32(h),
        # Real timing constants: the compiled engine sizes its delay rings
        # from the pow2-bucketed static_config but indexes them modulo
        # these per-row values, so a timing sweep rides one compile.
        prop_slots=np.int32(cfg.prop_slots),
        ack_delay=np.int32(cfg.ack_delay),
    )
    return LoopPlan(tree=tree, wl=wl, scheme=scheme, cfg=cfg, links=links,
                    ep_links=ep_links, any_fail=any_fail, pv=pv,
                    fsrc=fsrc, fdst=fdst, static=static, tables=tables)


def _draw_seed_inputs(plan: LoopPlan, seed: int) -> dict:
    """Per-seed randomness, drawn in the exact order the pre-batching engine
    used so results stay bit-identical run-to-run and serial-to-batched.

    Fault epochs extend the sequential ``np.random`` stream *in epoch
    order* at the exact positions the static path draws its converged
    state: stale host choices first, then one converged draw per epoch,
    then the label pool / RR starts, then the stale OFAN tables, then one
    converged OFAN build per epoch.  A one-epoch plan therefore consumes
    the identical stream as the pre-schedule engine (bitwise goldens), and
    a failure-free plan aliases its converged state to the stale draw
    without consuming anything, as before.
    """
    tree, wl, scheme = plan.tree, plan.wl, plan.scheme
    h = tree.half
    P = wl.n_packets
    E = plan.n_epochs
    rng = np.random.default_rng(seed)
    key_lo, key_hi = ent.key_words(seed)

    a_stale = c_stale = a_conv = c_conv = None
    if scheme.edge_mode == "pre":
        pre_kw = dict(tree=tree, flow=wl.flow, seq=wl.seq, flow_src=plan.fsrc,
                      flow_dst=plan.fdst, rng=rng)
        a_stale, c_stale = precompute_host_choices(scheme, path_valid=None,
                                                   **pre_kw)
        if plan.any_fail:
            per_ep = [precompute_host_choices(scheme, path_valid=pv_e,
                                              **pre_kw) for pv_e in plan.pv]
            a_conv = np.stack([a for a, _ in per_ep])
            c_conv = np.stack([c for _, c in per_ep])
        else:
            a_conv = np.stack([a_stale] * E)
            c_conv = np.stack([c_stale] * E)

    rand_pool = rng.integers(0, h * h, size=65536).astype(np.int32)

    ofan_stale = None
    ofan_eps: list = []
    rr_starts_e = rng.integers(0, h, tree.n_edge_switches).astype(np.int32)
    rr_starts_a = rng.integers(0, h, tree.n_agg_switches).astype(np.int32)
    if scheme.edge_mode == "ofan":
        ofan_stale = ofan_mod.build_tables(tree, rng, links=None)
        ofan_eps = ([ofan_mod.build_tables(tree, rng, links=l)
                     for l in plan.ep_links]
                    if plan.any_fail else [ofan_stale] * E)

    return dict(
        a_stale=_z(a_stale, P), c_stale=_z(c_stale, P),
        a_conv=_ze(a_conv, E, P), c_conv=_ze(c_conv, E, P),
        rand_pool=rand_pool,
        rr_starts_e=rr_starts_e, rr_starts_a=rr_starts_a,
        ofan_e_orders=_tbl(ofan_stale, ofan_eps, "edge_orders", E),
        ofan_e_starts=_tbl(ofan_stale, ofan_eps, "edge_starts", E),
        ofan_e_len=_tbl(ofan_stale, ofan_eps, "edge_len", E),
        ofan_a_orders=_tbl(ofan_stale, ofan_eps, "agg_orders", E),
        ofan_a_starts=_tbl(ofan_stale, ofan_eps, "agg_starts", E),
        ofan_a_len=_tbl(ofan_stale, ofan_eps, "agg_len", E),
        # Counter-stream key words: the in-loop randomness operands.  Draws
        # are pure functions of (seed, site, logical id, slot), so they ride
        # any padding/batching unchanged (core.entropy).
        seed_lo=key_lo, seed_hi=key_hi,
    )


def _postprocess(out: dict, cfg: LoopConfig, n_packets: int,
                 n_flows: int, probes=None) -> LoopSimResult:
    """Assemble a LoopSimResult from one (unbatched) engine output tree,
    slicing off any shape-bucketing padding."""
    comp = out["flow_complete"][:n_flows]
    data_done = out["f_data_done"][:n_flows]
    f_cwnd = np.asarray(out["f_cwnd"][:n_flows], np.float32)
    finished = bool((comp >= 0).all())
    # Zero-flow workloads (msg_packets=0, empty phases): vacuously finished
    # at slot 0 -- the empty maxima below would raise.
    return LoopSimResult(
        delivered_slot=out["delivered_slot"][:n_packets],
        flow_complete_slot=comp,
        flow_data_done_slot=data_done,
        cct_slots=0.0 if n_flows == 0
        else float(data_done.max()) if (data_done >= 0).all()
        else float(cfg.max_slots),
        cct_acked_slots=0.0 if n_flows == 0
        else float(comp.max()) if finished else float(cfg.max_slots),
        drops=int(out["drops"]),
        retransmissions=int(out["rtx"]),
        max_queue=int(out["max_q"]),
        avg_queue=float(out["sum_q"]) / max(float(out["enq_events"]), 1.0),
        finished=finished,
        mean_cwnd=float(f_cwnd.mean()) if n_flows else 0.0,
        probe=(QueueProbe(probe_shape(probes)[0], np.asarray(out["q_probe"]))
               if "q_probe" in out else None),
    )

def _check_config(cfg: LoopConfig) -> None:
    if cfg.impl not in LOOP_IMPLS:
        raise ValueError(f"LoopConfig.impl {cfg.impl!r}: expected one of "
                         f"{LOOP_IMPLS}")
    if cfg.loss not in ("erasure", "sack"):
        raise ValueError(f"unknown loss {cfg.loss!r}")
    if cfg.cca not in ("ideal", "mswift"):
        raise ValueError(f"unknown cca {cfg.cca!r}")


def simulate(tree: FatTree, wl: Workload, scheme: LBScheme,
             cfg: LoopConfig = LoopConfig(), seed: int = 0,
             links: Optional[LinkState] = None,
             g_converge: Optional[int] = None,
             probes=None, fault=None, device=None) -> LoopSimResult:
    """Run one collective on the slotted engine.

    ``links``: failed-link state (None = all up).  ``g_converge``: slot at
    which routing state converges; None => G = infinity (never converges).
    ``fault``: a :class:`repro_torch.faults.FaultSchedule`, the dynamic
    alternative to the (links, g_converge) pair (mutually exclusive with
    it).  ``device=None`` runs on CUDA and raises when no card is visible;
    ``device="cpu"`` runs the plain PyTorch versions of the kernels.
    """
    _check_config(cfg)
    device = resolve_device(device)
    if wl.n_packets == 0:
        # The engine gathers per-packet state each step, which needs a
        # packet axis of at least 1: an all-degenerate workload runs as a
        # one-point megabatch padded to one inert packet row, as in the
        # reference.
        return simulate_megabatch(
            [(tree, wl, scheme, cfg, [seed], links, g_converge, fault)],
            npk_pad=1, probes=probes, device=device)[0][0]
    plan = _prepare(tree, wl, scheme, cfg, links, g_converge, probes=probes,
                    fault=fault)
    tables = {**plan.tables, **_draw_seed_inputs(plan, seed)}
    out = _run(plan.static, _stack([tables]), device)
    return _postprocess(_row(out, 0), cfg, wl.n_packets, wl.n_flows, probes)


def simulate_batch(tree: FatTree, wl: Workload, scheme: LBScheme,
                   seeds, cfg: LoopConfig = LoopConfig(),
                   links: Optional[LinkState] = None,
                   g_converge: Optional[int] = None, probes=None,
                   fault=None, device=None) -> list:
    """Run one simulation point for many seeds as one batched dispatch.

    Per-seed randomness is drawn host-side exactly as :func:`simulate` draws
    it and stacked onto the batch axis (seed-independent operands are
    repeated).  The host loop steps until every row's flows have completed
    (or hit ``max_slots``); finished rows freeze.  Results are
    bitwise-identical, per seed, to serial :func:`simulate` calls.
    """
    _check_config(cfg)
    device = resolve_device(device)
    seeds = list(seeds)
    if not seeds:
        return []
    if wl.n_packets == 0:
        return simulate_megabatch(
            [(tree, wl, scheme, cfg, seeds, links, g_converge, fault)],
            npk_pad=1, probes=probes, device=device)[0]
    plan = _prepare(tree, wl, scheme, cfg, links, g_converge, probes=probes,
                    fault=fault)
    out = _run(plan.static, _stack([{**plan.tables, **_draw_seed_inputs(
        plan, s)} for s in seeds]), device)
    return [_postprocess(_row(out, i), cfg, wl.n_packets, wl.n_flows, probes)
            for i in range(len(seeds))]


def _pipeline_identity(plan: LoopPlan) -> _Static:
    """Everything two plans must agree on to share one megabatched dispatch:
    scheme modes and the static LoopConfig fields.  Packet/flow/host-flow
    axes are padded, and tree dims pad to the group's largest k for EVERY
    scheme -- in-loop randomness comes from counter streams keyed on logical
    ids (``core.entropy``), so the draws survive padding."""
    return dataclasses.replace(plan.static, P=0, F=0, Fh=0, n=0, h=0, mid=0,
                               n_edges=0, n_aggs=0, n_pods=0)


def _repad_tables(st: dict, plan: LoopPlan, tp: TreePad) -> dict:
    """Re-lay one point's switch-/queue-id-indexed operands into the padded
    tree's id space (:class:`~._batching.TreePad`).  Host ids and per-flow
    coordinates are unchanged: real hosts are a dense prefix of the padded
    host space, and real (pod, edge/agg, port) coordinates are sparse in
    the padded switch/queue id spaces.  Padded queues stay empty (no real
    packet ever routes to one) and padded table rows are never indexed by a
    live flow, so dynamics match the standalone run exactly."""
    if tp.noop:
        return st
    pt = tp.padded
    st = dict(st)
    n_sw = pt.n_edge_switches            # == n_agg_switches
    mid_r = plan.tree.queues_per_mid_layer
    mid_p = pt.queues_per_mid_layer
    E = st["alive"].shape[0]

    # Per-queue aliveness (epoch-stacked): 4 mid layers scatter through the
    # queue-id map; padded queues read True, which is inert (nothing is
    # enqueued there).
    alive = np.ones((E, 4 * mid_p + pt.n_hosts), dtype=bool)
    for L in range(4):
        alive[:, L * mid_p + tp.mid] = st["alive"][:, L * mid_r:
                                                   (L + 1) * mid_r]
    st["alive"] = alive

    st["host_flows"] = pad_tail(st["host_flows"], 0, pt.n_hosts, fill=-1)
    # Valid-label lists keep their raw h_log-encoded entries; only the pool
    # axis widens (entries past a flow's own f_vcnt are never indexed).
    st["f_vpaths"] = pad_tail(st["f_vpaths"], 2, pt.half * pt.half)
    # W-ECMP valid-port lists: (switch, dst-group) rows scatter; the port
    # axis pads with zeros that sit beyond every row's count operand.
    # All carry a leading epoch axis, so table axes shift by one.
    st["e_ports"] = pad_tail(
        tp.scatter(st["e_ports"], tp.edge_pair, n_sw * n_sw, axis=1),
        2, pt.half)
    st["e_pcnt"] = tp.scatter(st["e_pcnt"], tp.edge_pair, n_sw * n_sw,
                              axis=1, fill=1)
    st["a_ports"] = pad_tail(
        tp.scatter(st["a_ports"], tp.agg_pod, n_sw * pt.n_pods, axis=1),
        2, pt.half)
    st["a_pcnt"] = tp.scatter(st["a_pcnt"], tp.agg_pod, n_sw * pt.n_pods,
                              axis=1, fill=1)
    st["e_dead"] = pad_tail(tp.scatter(
        tp.scatter(st["e_dead"], tp.switch, n_sw, axis=1, fill=True),
        tp.switch, n_sw, axis=2, fill=True), 3, pt.half, fill=True)
    st["a_dead"] = pad_tail(pad_tail(
        tp.scatter(st["a_dead"], tp.switch, n_sw, axis=1, fill=True),
        2, pt.n_pods, fill=True), 3, pt.half, fill=True)
    return st


def _repad_seed(d: dict, plan: LoopPlan, tp: TreePad) -> dict:
    """Scatter the per-seed switch tables (RR starts, OFAN pointer tables)
    into the padded tree's id space."""
    if tp.noop:
        return d
    pt = tp.padded
    d = dict(d)
    n_sw = pt.n_edge_switches
    d["rr_starts_e"] = tp.scatter(d["rr_starts_e"], tp.switch, n_sw)
    d["rr_starts_a"] = tp.scatter(d["rr_starts_a"], tp.switch, n_sw)
    if plan.scheme.edge_mode == "ofan":
        for pre, idx, n_ptr in (("ofan_e", tp.edge_pair, n_sw * n_sw),
                                ("ofan_a", tp.agg_pod, n_sw * pt.n_pods)):
            for suf in ("orders", "starts", "len"):
                d[f"{pre}_{suf}"] = tp.scatter(d[f"{pre}_{suf}"], idx,
                                               n_ptr, axis=1)
    return d


# Seed-independent per-point operands that carry a padded flow/packet axis.
# (f_start pads with 0; pad flows have fsize 0 and complete at slot 0, so
# their gate value never matters.)
_F_PAD0 = ("fsrc", "fdst", "fsize", "fp1", "fe1", "fp2", "fe2", "f_start")

def simulate_megabatch(items, *, npk_pad: Optional[int] = None,
                       n_shards=1, k_pad: Optional[int] = None,
                       probes=None, device=None) -> list:
    """Run many loop-engine simulation points as ONE fused dispatch.

    ``items`` is a sequence of ``(tree, wl, scheme, cfg, seeds, links,
    g_converge)`` tuples, or 8-tuples with a trailing ``fault`` schedule
    (``links`` and ``g_converge`` then None), whose points share one
    pipeline identity (scheme modes and static LoopConfig fields; ``rho``,
    ``max_slots``, ``g_converge`` and the fault epochs ride as per-row
    operands).  Fault-epoch axes pad to the group maximum: pad epochs
    repeat the last real epoch and start at the unreachable sentinel slot
    ``2**30``, so static and flapping points fuse.
    Per-seed inputs are drawn host-side exactly as :func:`simulate` draws
    them, padded to shared shapes (packet arrays up to ``npk_pad``, flow
    arrays and ``host_flows`` columns to group-wide maxima, OFAN order widths
    to the group maximum, switch/queue tables scattered into the padded
    ``k_pad`` tree's id space; pad flows have size 0 and are inert, padded
    switches and queues never see traffic), stacked onto one fused batch
    axis and run by one batched host loop.  ``n_shards`` (or ``"auto"``: one
    chunk per visible CUDA device, at most one per element) cuts the fused
    axis into contiguous chunks, chunk ``i`` on CUDA device ``i``; results
    do not depend on it.

    Returns one list of :class:`LoopSimResult` per item (aligned with its
    ``seeds``); every result is bitwise-identical to the standalone
    :func:`simulate` call with the same arguments.
    """
    device = resolve_device(device)
    items = [(it[0], it[1], it[2], it[3], list(it[4]), it[5], it[6],
              it[7] if len(it) > 7 else None) for it in items]
    for it in items:
        _check_config(it[3])
    if not items or all(not it[4] for it in items):
        return [[] for _ in items]

    plans = [_prepare(t, w, s, c, l, g, probes=probes, fault=fz)
             for (t, w, s, c, _, l, g, fz) in items]
    idents = {_pipeline_identity(p) for p in plans}
    if len(idents) > 1:
        raise ValueError(f"megabatch items span {len(idents)} pipeline "
                         f"identities; group by tree size, scheme loop "
                         f"shape and static LoopConfig first")

    k_max = max(p.tree.k for p in plans)
    k_pad = k_max if k_pad is None else max(int(k_pad), k_max)
    tree_pad = next((p.tree for p in plans if p.tree.k == k_pad),
                    FatTree(k_pad))
    pads = [TreePad(p.tree, tree_pad) for p in plans]

    P_max = max(p.wl.n_packets for p in plans)
    # The engine's per-step packet gathers need a non-empty packet axis
    # even when every member is degenerate (all-empty phase schedules).
    npk_pad = max(P_max if npk_pad is None else max(int(npk_pad), P_max), 1)
    F_pad = max(p.wl.n_flows for p in plans)
    Fh_pad = max(p.static.Fh for p in plans)
    E_pad = max(p.n_epochs for p in plans)

    elems: list = []          # merged (static + per-seed) dicts, padded
    spans: list = []          # (item index, seed) per fused-axis element
    for i, ((tree, wl, scheme, cfg, seeds, links, g, _), plan) in enumerate(
            zip(items, plans)):
        st = _repad_tables(plan.tables, plan, pads[i])
        for k in ("alive", "e_ports", "e_pcnt", "a_ports", "a_pcnt",
                  "e_dead", "a_dead", "f_vpaths", "f_vcnt"):
            st[k] = _pad_epochs(st[k], E_pad)
        for k in ("ep_start", "r_start"):
            st[k] = pad_tail(st[k], 0, E_pad, fill=2**30)
        # Flow-axis padding: pad flows have fsize 0, so they complete at the
        # first slot, never send, and never reference a packet; pkt_base is
        # edge-padded so searchsorted still lands real packets on real flows.
        st["pkt_base"] = pad_tail(st["pkt_base"], 0, F_pad + 1,
                                  fill=int(st["pkt_base"][-1]))
        for k in _F_PAD0:
            st[k] = pad_tail(st[k], 0, F_pad)
        st["f_inter"] = pad_tail(st["f_inter"], 0, F_pad, fill=False)
        st["f_leaves"] = pad_tail(st["f_leaves"], 0, F_pad, fill=False)
        st["f_vpaths"] = pad_tail(st["f_vpaths"], 1, F_pad)
        st["f_vcnt"] = pad_tail(st["f_vcnt"], 1, F_pad, fill=1)
        # Padded host_flows columns hold -1 and rank below every real flow
        # in the host round-robin.
        st["host_flows"] = pad_tail(st["host_flows"], 1, Fh_pad, fill=-1)
        for s in seeds:
            d = {**st, **_repad_seed(_draw_seed_inputs(plan, s), plan,
                                     pads[i])}
            for k in ("a_stale", "c_stale"):
                d[k] = pad_tail(d[k], 0, npk_pad)
            for k in ("a_conv", "c_conv"):
                d[k] = pad_tail(_pad_epochs(d[k], E_pad), 1, npk_pad)
            for k in ("ofan_e_orders", "ofan_e_starts", "ofan_e_len",
                      "ofan_a_orders", "ofan_a_starts", "ofan_a_len"):
                d[k] = _pad_epochs(d[k], 1 + E_pad)
            elems.append(d)
            spans.append((i, s))

    # OFAN rotation orders are padded to the group-wide width; entries past
    # a row's own table length are never indexed.
    for key in ("ofan_e_orders", "ofan_a_orders"):
        for d, arr in zip(elems, pad_to_group_max([d[key] for d in elems])):
            d[key] = arr

    n_batch = len(elems)
    if n_shards == "auto":
        n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
        n_shards = max(1, min(n_dev, n_batch))
    n_shards = int(n_shards)
    stacked = shard_pad(_stack(elems), n_batch, n_shards)

    static = dataclasses.replace(
        plans[0].static, P=npk_pad, F=F_pad, Fh=Fh_pad,
        n=tree_pad.n_hosts, h=tree_pad.half,
        mid=tree_pad.queues_per_mid_layer,
        n_edges=tree_pad.n_edge_switches, n_aggs=tree_pad.n_agg_switches,
        n_pods=tree_pad.n_pods)
    out = _run(static, stacked, device, n_shards)

    results = [dict() for _ in items]
    for b, (i, s) in enumerate(spans):
        results[i][s] = _postprocess(_row(out, b), items[i][3],
                                     plans[i].wl.n_packets,
                                     plans[i].wl.n_flows, probes)
    return [[results[i][s] for s in seeds]
            for i, (_, _, _, _, seeds, _, _, _) in enumerate(items)]


def _pad_epochs(x, e_pad, axis=0):
    """Pad an epoch-stacked table to ``e_pad`` epochs by repeating its last
    real epoch (inert: the sentinel-padded start operands guarantee the
    epoch counters never index past the real epochs)."""
    E = x.shape[axis]
    if E >= e_pad:
        return x
    last = np.take(x, [E - 1], axis=axis)
    return np.concatenate([x, np.repeat(last, e_pad - E, axis=axis)],
                          axis=axis)


def _z(x, P):
    return np.zeros(P, np.int32) if x is None else x.astype(np.int32)


def _ze(x, E, P):
    return np.zeros((E, P), np.int32) if x is None else x.astype(np.int32)


def _tbl(stale, eps, attr, n_ep):
    """Stack OFAN tables as [stale, epoch_0, ..., epoch_{E-1}] (the engine
    indexes this axis with the reaction-epoch counter directly: 0 = stale,
    1+e = converged on epoch e's links), width-padding ragged IWRR orders
    by tiling (entries past a group's ``len`` are never indexed)."""
    if stale is None:
        return np.zeros((1 + n_ep, 1, 1) if attr.endswith("orders")
                        else (1 + n_ep, 1), np.int32)
    arrs = [getattr(stale, attr)] + [getattr(e, attr) for e in eps]
    if arrs[0].ndim == 2 and len({a.shape[1] for a in arrs}) > 1:
        w = max(a.shape[1] for a in arrs)
        def padw(x):
            reps = int(np.ceil(w / x.shape[1]))
            return np.tile(x, (1, reps))[:, :w]
        arrs = [padw(a) for a in arrs]
    return np.stack(arrs)


# ---------------------------------------------------------------------------
# The batched engine
# ---------------------------------------------------------------------------

# Operand dtypes: everything int32, as the reference runs with x64 off; the
# uint32 PRF key words ride as their int32 bit patterns (the kernels read
# them as uint32, the torch Threefry masks them back to 32 bits).
_KEY_WORDS = ("seed_lo", "seed_hi")


def _stack(elems: list) -> dict:
    return {k: np.stack([np.asarray(d[k]) for d in elems]) for k in elems[0]}


def _row(out: dict, b: int) -> dict:
    return {k: v[b] for k, v in out.items()}


def _to_device(stacked: dict, device: torch.device) -> dict:
    out = {}
    for k, v in stacked.items():
        v = np.ascontiguousarray(v)
        if k in _KEY_WORDS:
            v = v.astype(np.uint32).view(np.int32)
        elif v.dtype.kind in "iu":
            v = v.astype(np.int32)
        elif v.dtype.kind == "f":
            v = v.astype(np.float32)
        out[k] = torch.from_numpy(v).to(device)
    return out


def _run(static: _Static, stacked: dict, device: torch.device,
         n_shards: int = 1) -> dict:
    """Run the engine over a stacked numpy batch; with ``n_shards > 1`` the
    batch is cut into ``n_shards`` contiguous chunks, chunk ``i`` on CUDA
    device ``i`` (every chunk on the CPU for a CPU device).  Returns numpy
    outputs with the batch axis first."""
    n_batch = len(stacked["max_slots"])
    if device.type == "cuda" and n_shards > torch.cuda.device_count():
        raise ValueError(f"n_shards={n_shards} but only "
                         f"{torch.cuda.device_count()} CUDA devices")
    size = n_batch // n_shards
    outs = []
    for i in range(n_shards):
        dev = (torch.device("cuda", i)
               if device.type == "cuda" and n_shards > 1 else device)
        chunk = {k: v[i * size:(i + 1) * size] for k, v in stacked.items()}
        out = _engine(static, _to_device(chunk, dev))
        outs.append({k: v.cpu().numpy() for k, v in out.items()})
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def _engine(s: _Static, x: dict) -> dict:
    """Run the slot loop over the ``(B, ...)`` operands ``x`` (the keys of
    ``_prepare``'s tables and ``_draw_seed_inputs``, stacked) until every
    row is done; returns the engine outputs as tensors on their device."""
    global STEPS
    cfg = s.cfg
    n, h, mid, F, P, Fh = s.n, s.h, s.mid, s.F, s.P, s.Fh
    B = x["max_slots"].shape[0]
    dev = x["max_slots"].device
    CAP = cfg.buffer_pkts
    NQ = 4 * mid + n
    # Delay rings: shapes from the pow2-bucketed static config, indices
    # modulo each row's real timing constants (per-row operands).
    DELAY_PAD = max(cfg.prop_slots, 1) + 1
    ADELAY_PAD = cfg.ack_delay + 1
    ecn_t = max(1, int(cfg.ecn_frac * CAP))
    OFF = (0, mid, 2 * mid, 3 * mid, 4 * mid)
    backend = "torch" if cfg.impl == "torch" else "auto"
    sack = cfg.loss == "sack"
    pool_n = x["rand_pool"].shape[1]

    bidx = torch.arange(B, device=dev)
    i32 = torch.int32

    # Constants are filled on the device: a tensor copied from the host
    # would make the host wait for the card at every slot.
    def f32(v):
        return torch.full((), v, dtype=torch.float32, device=dev)

    def col(v):                      # (B,) -> (B, 1)
        return v[:, None]

    def g(t_, idx):                  # gather along axis 1 of a (B, N) table
        return torch.gather(t_, 1, idx.reshape(B, -1).long()).reshape(
            idx.shape)

    def g3(t_, i, j):                # t_ (B, N, K)[b, i, j]
        K = t_.shape[2]
        return g(t_.reshape(B, -1), i.long() * K + j.long())

    def row_of(t_, r):               # t_ (B, R, ...)[b, r[b]]
        return t_[bidx, r.long()]

    def scatter(t_, mask, idx, val, op="set"):
        """``t_.at[where(mask, idx, N)].<op>(val, mode="drop")`` per row:
        the target gets a sink column N that is cut off."""
        N = t_.shape[1]
        tt = torch.cat([t_, t_[:, :1]], dim=1)
        ii = torch.where(mask, idx.long(), N)
        vv = (val.to(t_.dtype).expand(ii.shape)
              if isinstance(val, torch.Tensor)
              else torch.full(ii.shape, val, dtype=t_.dtype, device=dev))
        if op == "set":
            tt.scatter_(1, ii, vv)
        elif op == "add":
            tt.scatter_add_(1, ii, vv)
        else:
            tt.scatter_reduce_(1, ii, vv, op)
        return tt[:, :N]

    def scatter_last(t_, mask, idx, val):
        """As ``scatter(..., "set")``, the last lane winning where lanes
        share a target (XLA's sequential scatter): arrivals may carry two
        copies of one packet in a slot."""
        M = idx.shape[1]
        N = t_.shape[1]
        lanes = torch.arange(M, device=dev).expand(B, M)
        ii = torch.where(mask, idx.long(), N)
        win = torch.full((B, N + 1), -1, dtype=torch.int64, device=dev)
        win.scatter_reduce_(1, ii, lanes, "amax")
        keep = mask & (torch.gather(win, 1, ii) == lanes)
        return scatter(t_, keep, idx, val)

    def set_row(t_, r, vals):        # new tensor with t_[b, r[b]] = vals[b]
        out = t_.clone()
        out[bidx, r.long()] = vals
        return out

    def searchsorted(v):
        return (torch.searchsorted(pkt_base, v, right=True) - 1).to(i32)

    fsrc, fdst, fsize = x["fsrc"], x["fdst"], x["fsize"]
    pkt_base = x["pkt_base"]
    fp1, fe1, fp2, fe2 = x["fp1"], x["fe1"], x["fp2"], x["fe2"]
    f_start, f_inter, f_leaves = x["f_start"], x["f_inter"], x["f_leaves"]
    host_flows, alive = x["host_flows"], x["alive"]
    ep_start, r_start = x["ep_start"], x["r_start"]
    rho, max_slots, h_log = x["rho"], x["max_slots"], x["h_log"]
    prop_slots, ack_delay = x["prop_slots"], x["ack_delay"]
    rand_pool = x["rand_pool"]
    seed_lo, seed_hi = x["seed_lo"], x["seed_hi"]
    DELAY = torch.clamp_min(prop_slots, 1) + 1
    ADELAY = ack_delay + 1
    PBASE = pkt_base[:, :F].contiguous()
    hl = col(h_log)
    # JSQ guard for tree-size padding: +1e9 on port columns >= h_log.
    pad_pen = port_pad_penalty(h, h_log)
    stg = torch.clamp(torch.div(torch.arange(NQ, device=dev), mid,
                                rounding_mode="floor"), 0, 4)
    host_ids = torch.arange(n, dtype=i32, device=dev).expand(B, n)
    fh_ar = torch.arange(Fh, device=dev)

    st = dict(
        qbuf=torch.full((B, NQ, CAP), -1, dtype=i32, device=dev),
        qhead=torch.zeros((B, NQ), dtype=i32, device=dev),
        qcnt=torch.zeros((B, NQ), dtype=i32, device=dev),
        dl_pkt=torch.full((B, DELAY_PAD, NQ), -1, dtype=i32, device=dev),
        dl_q=torch.zeros((B, DELAY_PAD, NQ), dtype=i32, device=dev),
        al_pkt=torch.full((B, ADELAY_PAD, n), -1, dtype=i32, device=dev),
        p_sent_t=torch.full((B, P), -1, dtype=i32, device=dev),
        p_ecn=torch.zeros((B, P), dtype=torch.bool, device=dev),
        p_recv=torch.zeros((B, P), dtype=torch.bool, device=dev),
        p_deliv=torch.full((B, P), -1, dtype=i32, device=dev),
        p_a=torch.zeros((B, P), dtype=i32, device=dev),
        p_c=torch.zeros((B, P), dtype=i32, device=dev),
        f_next=torch.zeros((B, F), dtype=i32, device=dev),
        f_sent=torch.zeros((B, F), dtype=i32, device=dev),
        f_acked=torch.zeros((B, F), dtype=i32, device=dev),
        f_delivered=torch.zeros((B, F), dtype=i32, device=dev),
        f_hi=torch.full((B, F), -1, dtype=i32, device=dev),
        f_cum=torch.zeros((B, F), dtype=i32, device=dev),
        f_complete=torch.full((B, F), -1, dtype=i32, device=dev),
        # Zero-size flows are data-done at slot 0.
        f_data_done=torch.where(fsize > 0, -1, 0).to(i32),
        f_last_ack_t=torch.full((B, F), -1, dtype=i32, device=dev),
        f_lost=torch.zeros((B, F), dtype=i32, device=dev),
        f_cwnd=torch.full((B, F), float(np.float32(min(
            cfg.bdp_pkts * 2.0, cfg.sw_max_cwnd))), dtype=torch.float32,
            device=dev),
        f_last_dec=torch.full((B, F), -10**6, dtype=i32, device=dev),
        f_label=g(rand_pool, torch.remainder(
            torch.arange(F, device=dev), pool_n).expand(B, F)).to(i32),
        f_label_cnt=torch.zeros((B, F), dtype=i32, device=dev),
        f_mark_ewma=torch.zeros((B, F), dtype=torch.float32, device=dev),
        f_draw=(torch.arange(F, dtype=i32, device=dev) * 31 + 1).expand(
            B, F).contiguous(),
        pool_lab=torch.zeros((B, F * 64), dtype=i32, device=dev),
        pool_cnt=torch.zeros((B, F), dtype=i32, device=dev),
        h_rr=torch.zeros((B, n), dtype=i32, device=dev),
        h_credit=torch.zeros((B, n), dtype=torch.float32, device=dev),
        h_ackdebt=torch.zeros((B, n), dtype=torch.float32, device=dev),
        ptr_e=torch.zeros((B, s.n_edges * s.n_edges if s.edge_mode == "ofan"
                           else s.n_edges), dtype=i32, device=dev),
        ptr_a=torch.zeros((B, s.n_aggs * s.n_pods if s.agg_mode == "ofan"
                           else s.n_aggs), dtype=i32, device=dev),
        drops=torch.zeros((B,), dtype=i32, device=dev),
        rtx=torch.zeros((B,), dtype=i32, device=dev),
        max_q=torch.zeros((B,), dtype=i32, device=dev),
        sum_q=torch.zeros((B,), dtype=torch.float32, device=dev),
        enq_events=torch.zeros((B,), dtype=i32, device=dev),
    )
    if s.probe[1]:
        st["q_probe"] = torch.zeros((B, 5, s.probe[1]), dtype=i32,
                                    device=dev)

    def step(st_in: dict, t: int) -> dict:
        st = dict(st_in)
        # Fault-epoch counters (one epoch on the static path): ``pe`` the
        # physical epoch, ``cvg_i`` how many epochs routing has reacted to.
        pe = torch.clamp_min((t >= ep_start).sum(1) - 1, 0)
        cvg_i = (t >= r_start).sum(1)
        converged = cvg_i > 0
        ci = cvg_i                          # OFAN [stale, epoch...] index
        ric = torch.clamp_min(cvg_i - 1, 0)  # converged epoch index
        cv = col(converged)

        # ---- 1. serve all queues -------------------------------------------
        qcnt = st["qcnt"]
        has = qcnt > 0
        headpos = st["qhead"]
        popped = torch.where(has, torch.gather(
            st["qbuf"], 2, headpos.long()[..., None])[..., 0], -1)
        st["qhead"] = torch.where(has, torch.remainder(headpos + 1, CAP),
                                  headpos)
        st["qcnt"] = torch.where(has, qcnt - 1, qcnt)

        # ---- 2. route popped packets ---------------------------------------
        pk = popped
        valid = pk >= 0
        pkc = torch.clamp_min(pk, 0)
        pf = torch.where(valid, searchsorted(pk), 0)
        a_ch = g(st["p_a"], pkc)
        c_ch = g(st["p_c"], pkc)
        p2 = g(fp2, pf)
        e2 = g(fe2, pf)
        nq_from_0 = torch.where(g(f_inter, pf),
                                OFF[1] + (g(fp1, pf) * h + a_ch) * h + c_ch,
                                OFF[3] + (p2 * h + a_ch) * h + e2)
        nq_from_1 = OFF[2] + (p2 * h + a_ch) * h + c_ch
        nq_from_2 = OFF[3] + (p2 * h + a_ch) * h + e2
        nq_from_3 = OFF[4] + g(fdst, pf)
        nxt = torch.where(stg == 0, nq_from_0, torch.where(
            stg == 1, nq_from_1, torch.where(
                stg == 2, nq_from_2, torch.where(stg == 3, nq_from_3, -2))))
        nxt = torch.where(valid, nxt, -1)

        # ---- 3. deliveries (stage-4 pops) ----------------------------------
        deliv = valid & (nxt == -2)
        dt = col(t + prop_slots)
        # Two copies of one packet delivered in one slot both read the
        # bitmap before the update, so both count as first deliveries.
        first_del = deliv & ~g(st["p_recv"], pkc)
        st["p_deliv"] = scatter(st["p_deliv"], first_del, pk, dt)
        if sack:
            # The bitmap update and each flow's first missing sequence
            # (step 5's retransmit candidate) in one kernel: nothing
            # between here and step 5 writes p_recv or f_cum.
            st["p_recv"], fm_flow = _slot.sack_update_scan(
                st["p_recv"], pk, deliv, st["f_cum"], fsize, PBASE,
                backend=backend)
        else:
            st["p_recv"] = scatter(st["p_recv"], deliv, pk, True)
        # Erasure coding is rateless: every delivered symbol counts; SACK
        # needs unique packets.
        st["f_delivered"] = scatter(st["f_delivered"],
                                    first_del if sack else deliv, pf, 1,
                                    "add")
        data_done_now = ((st["f_data_done"] < 0)
                         & (st["f_delivered"] >= fsize))
        st["f_data_done"] = torch.where(data_done_now, dt, st["f_data_done"])
        # ACKs: deliveries only come from DN_E pops (<= n)
        dn_pk = popped[:, OFF[4]:]
        dn_ok = deliv[:, OFF[4]:]
        st["al_pkt"] = set_row(st["al_pkt"], torch.remainder(t, ADELAY),
                               torch.where(dn_ok, dn_pk, -1))

        # ---- 4. fabric moves (written with step 6's injections) -------------
        mover = valid & (nxt >= 0)
        dslot = torch.remainder(t + prop_slots, DELAY)

        # ---- 5. host injection ----------------------------------------------
        inflight = st["f_sent"] - st["f_acked"] - st["f_lost"]
        if sack:
            gap = st["f_hi"] + 1 - st["f_cum"]
            need_rtx = ((st["f_hi"] >= 0) & (gap > cfg.sack_thresh)
                        & (st["f_cum"] < fsize))
            remaining = (st["f_next"] < fsize) | need_rtx
        else:
            remaining = ((st["f_acked"] < fsize)
                         & (inflight < (fsize - st["f_acked"])
                            + cfg.bdp_pkts))
        sendable = remaining & (st["f_complete"] < 0) & (t >= f_start)
        if cfg.cca != "ideal":
            sendable = sendable & (inflight.to(torch.float32) < st["f_cwnd"])
        hf = host_flows
        hf_ok = torch.where(hf >= 0, g(sendable, torch.clamp_min(hf, 0)),
                            False)
        prio = torch.remainder(fh_ar - st["h_rr"][..., None], Fh)
        prio = torch.where(hf_ok, prio, Fh + 1)
        pick = torch.argmin(prio, dim=2)
        can_send = torch.gather(hf_ok, 2, pick[..., None])[..., 0]
        h_credit = torch.minimum(st["h_credit"] + col(rho), f32(4.0))
        debt_ok = st["h_ackdebt"] < 1.0
        st["h_ackdebt"] = torch.where(~debt_ok, st["h_ackdebt"] - f32(1.0),
                                      st["h_ackdebt"])
        do_send = can_send & (h_credit >= 1.0) & debt_ok
        st["h_credit"] = torch.where(do_send, h_credit - f32(1.0), h_credit)
        st["h_rr"] = torch.where(do_send, torch.remainder(pick + 1, Fh),
                                 st["h_rr"]).to(i32)

        sf = torch.where(do_send, torch.gather(hf, 2, pick[..., None])[
            ..., 0], -1)
        sfv = torch.clamp_min(sf, 0)
        seq_fresh = g(st["f_next"], sfv)
        fs = g(fsize, sfv)
        if sack:
            first_missing = g(fm_flow, sfv)
            is_rtx = g(need_rtx, sfv) & do_send
            seq = torch.where(is_rtx, first_missing,
                              torch.minimum(seq_fresh, fs - 1))
            # No fresh sequence left and no retransmit due: resend the
            # first missing one too.
            exhausted = (seq_fresh >= fs) & ~is_rtx & do_send
            seq = torch.where(exhausted, first_missing, seq)
            is_rtx = is_rtx | exhausted
            st["rtx"] = st["rtx"] + is_rtx.sum(1).to(i32)
            fresh_ok = do_send & ~is_rtx & (seq_fresh < fs)
        else:
            seq = torch.where(seq_fresh < fs, seq_fresh, torch.remainder(
                g(st["f_sent"], sfv), torch.clamp_min(fs, 1)))
            fresh_ok = do_send & (seq_fresh < fs)
        pid = g(PBASE, sfv) + torch.minimum(torch.clamp_min(seq, 0), fs - 1)

        st["f_next"] = scatter(st["f_next"], fresh_ok, sf, 1, "add")
        first_send = do_send & (g(st["f_sent"], sfv) == 0)
        st["f_last_ack_t"] = scatter(st["f_last_ack_t"], first_send, sf, t)
        st["f_sent"] = scatter(st["f_sent"], do_send, sf, 1, "add")
        st["p_sent_t"] = scatter(st["p_sent_t"], do_send, pid, t)

        # ---- 6. edge port choice for injected packets -----------------------
        # REPS / PLB labels; f_draw * 48271 wraps in int32 as in the
        # reference, and the floor modulo keeps the index non-negative.
        draw_idx = torch.remainder(g(st["f_draw"], sfv) * 48271 + 12345,
                                   pool_n)
        fresh_lab = g(rand_pool, draw_idx)
        pc_s = g(st["pool_cnt"], sfv)
        has_pool = pc_s > 0
        pooled = g(st["pool_lab"], sfv.long() * 64
                   + torch.clamp_min(pc_s - 1, 0))
        if s.adaptive_host and not s.plb:      # REPS
            lab = torch.where(has_pool, pooled, fresh_lab)
            st["pool_cnt"] = scatter(st["pool_cnt"], do_send & has_pool, sf,
                                     -1, "add")
        elif s.plb:
            lab = g(st["f_label"], sfv)
        else:
            lab = fresh_lab
        st["f_draw"] = scatter(st["f_draw"], do_send, sf, 7, "add")

        sw = g(fp1, sfv) * h + g(fe1, sfv)
        de = g(fp2, sfv) * h + g(fe2, sfv)
        gp = sw * s.n_edges + de
        c_new = torch.zeros((B, n), dtype=i32, device=dev)
        if s.edge_mode == "pre":
            if s.adaptive_host:
                # Post-convergence W-ECMP rehash onto valid labels, encoded
                # in the point's own h_log port space.
                vp = row_of(x["f_vpaths"], ric)
                vc = g(row_of(x["f_vcnt"], ric), sfv)
                eff = torch.where(cv, g3(vp, sfv, torch.remainder(lab, vc)),
                                  lab)
                a_new = torch.remainder(
                    torch.div(eff, hl, rounding_mode="floor"), hl)
                c_new = torch.remainder(eff, hl)
            else:
                # A lane that does not send may carry pid -1 (its flow has
                # no packets); its value is never used.  Read it where the
                # reference's gather does, at the normalized index P - 1.
                pg = torch.remainder(pid, P)
                a_new = torch.where(cv, g(row_of(x["a_conv"], ric), pg),
                                    g(x["a_stale"], pg))
                c_new = torch.where(cv, g(row_of(x["c_conv"], ric), pg),
                                    g(x["c_stale"], pg))
        elif s.edge_mode == "rand":
            # Per-host spray over the logical (a, c) label space, keyed on
            # (seed, host id, slot).
            r = ent.draw_int_torch(col(seed_lo), col(seed_hi),
                                   ent.SITE_EDGE_RAND, host_ids, t, hl * hl)
            a_naive = torch.div(r, hl, rounding_mode="floor")
            pcnt = torch.clamp_min(g(row_of(x["e_pcnt"], ric), gp), 1)
            a_live = g3(row_of(x["e_ports"], ric), gp,
                        torch.remainder(r, pcnt))
            a_new = torch.where(cv, a_live, a_naive)
            c_new = torch.remainder(r, hl)
        elif s.edge_mode in ("rr", "rr_reset", "ofan"):
            north = do_send & g(f_leaves, sfv)
            if s.edge_mode == "ofan":
                gid = gp
                rk = rank_by(gid, north, backend)
                ctr = g(st["ptr_e"], gid) + rk
                L = torch.clamp_min(g(row_of(x["ofan_e_len"], ci), gid), 1)
                start = g(row_of(x["ofan_e_starts"], ci), gid)
                a_new = g3(row_of(x["ofan_e_orders"], ci), gid,
                           torch.remainder(start + ctr, L))
                st["ptr_e"] = scatter(st["ptr_e"], north, gid, 1, "add")
            else:
                rk = rank_by(sw, north, backend)
                ctr = g(st["ptr_e"], sw) + rk
                base = g(x["rr_starts_e"], sw) + ctr
                # pre-convergence: all ports; post: W-ECMP-valid for dest
                naive = torch.remainder(base, hl)
                pcn = torch.clamp_min(g(row_of(x["e_pcnt"], ric), gp), 1)
                live = g3(row_of(x["e_ports"], ric), gp,
                          torch.remainder(base, pcn))
                a_new = torch.where(cv, live, naive)
                st["ptr_e"] = scatter(st["ptr_e"], north, sw, 1, "add")
        else:  # jsq / jsq_quant at the edge: the jsq_pick kernel
            dead = cv[..., None] & g3(
                row_of(x["e_dead"], ric).reshape(B, s.n_edges * s.n_edges, h),
                (sw.long() * s.n_edges + de)[..., None],
                torch.arange(h, device=dev).expand(B, n, h))
            a_new = _slot.jsq_pick(
                st["qcnt"], OFF[0] + sw * h, host_ids, dead, pad_pen,
                seed_lo, seed_hi, t, site=ent.SITE_EDGE_JSQ,
                quanta=s.quanta, cap=CAP, backend=backend)
        a_new = a_new.to(i32)
        c_new = c_new.to(i32)

        st["p_a"] = scatter(st["p_a"], do_send, pid, a_new)
        st["p_c"] = scatter(st["p_c"], do_send, pid, c_new)
        st["f_label_cnt"] = scatter(st["f_label_cnt"], do_send, sf, 1, "add")
        inj_q = torch.where(g(f_leaves, sfv), OFF[0] + sw * h + a_new,
                            OFF[4] + g(fdst, sfv))
        st["dl_pkt"] = set_row(st["dl_pkt"], dslot, torch.cat(
            [torch.where(mover, pk, -1)[:, :4 * mid],
             torch.where(do_send, pid, -1)], dim=1))
        st["dl_q"] = set_row(st["dl_q"], dslot, torch.cat(
            [torch.where(mover, nxt, 0)[:, :4 * mid],
             torch.where(do_send, inj_q, 0)], dim=1))

        # ---- 7. arrivals: agg uplink choice then enqueue --------------------
        arr_slot = torch.remainder(t, DELAY)
        apk = row_of(st["dl_pkt"], arr_slot)
        aq = row_of(st["dl_q"], arr_slot)
        avalid = apk >= 0
        apkc = torch.clamp_min(apk, 0)
        af = torch.where(avalid, searchsorted(apk), 0)
        to_agg = avalid & (aq >= OFF[1]) & (aq < OFF[2])
        asw = torch.clamp(torch.div(aq - OFF[1], h, rounding_mode="floor"),
                          0, s.n_aggs - 1)
        fp2_af = g(fp2, af)
        gpa = asw * s.n_pods + fp2_af
        alive_pe = row_of(alive, pe)
        fuse_agg = s.agg_mode in ("jsq", "jsq_quant")
        if s.agg_mode in ("pre", "rand"):
            c_fin = g(st["p_c"], apkc)
            if s.agg_mode == "rand":
                # Per-packet draw over the logical core sub-links, keyed on
                # (seed, packet id, slot).
                r = ent.draw_int_torch(col(seed_lo), col(seed_hi),
                                       ent.SITE_AGG_RAND, apkc, t, hl)
                pcnt = torch.clamp_min(g(row_of(x["a_pcnt"], ric), gpa), 1)
                c_live = g3(row_of(x["a_ports"], ric), gpa,
                            torch.remainder(r, pcnt))
                c_fin = torch.where(cv, c_live, r)
        elif s.agg_mode in ("rr", "rr_reset", "ofan"):
            if s.agg_mode == "ofan":
                gid = gpa
                rk = rank_by(gid, to_agg, backend)
                ctr = g(st["ptr_a"], gid) + rk
                L = torch.clamp_min(g(row_of(x["ofan_a_len"], ci), gid), 1)
                start = g(row_of(x["ofan_a_starts"], ci), gid)
                c_fin = g3(row_of(x["ofan_a_orders"], ci), gid,
                           torch.remainder(start + ctr, L))
                st["ptr_a"] = scatter(st["ptr_a"], to_agg, gid, 1, "add")
            else:
                rk = rank_by(asw, to_agg, backend)
                ctr = g(st["ptr_a"], asw) + rk
                base = g(x["rr_starts_a"], asw) + ctr
                naive = torch.remainder(base, hl)
                pcn = torch.clamp_min(g(row_of(x["a_pcnt"], ric), gpa), 1)
                live = g3(row_of(x["a_ports"], ric), gpa,
                          torch.remainder(base, pcn))
                c_fin = torch.where(cv, live, naive)
                st["ptr_a"] = scatter(st["ptr_a"], to_agg, asw, 1, "add")

        # ---- 8. enqueue (drops, ECN, failure black-holing) ------------------
        if fuse_agg:
            # Steps 7 + 8 fused: the agg JSQ pick and the enqueue it feeds.
            dead = cv[..., None] & g3(
                row_of(x["a_dead"], ric).reshape(B, s.n_aggs * s.n_pods, h),
                gpa[..., None], torch.arange(h, device=dev).expand(B, NQ, h))
            (qbuf2, qcnt2, c_fin, enq_try, do_enq, occ_after,
             marked) = _slot.agg_jsq_enqueue(
                st["qbuf"], st["qhead"], st["qcnt"], alive_pe, apk, aq,
                to_agg, asw, dead, pad_pen, seed_lo, seed_hi, t,
                site=ent.SITE_AGG_JSQ, quanta=s.quanta, cap=CAP,
                ecn_thresh=ecn_t, off1=OFF[1], h=h, backend=backend)
            st["p_c"] = scatter_last(st["p_c"], to_agg, apk, c_fin)
        else:
            c_fin = c_fin.to(i32)
            st["p_c"] = scatter_last(st["p_c"], to_agg, apk, c_fin)
            aq = torch.where(to_agg, OFF[1] + asw * h + c_fin, aq)
            (qbuf2, qcnt2, enq_try, do_enq, occ_after,
             marked) = _slot.enqueue(
                st["qbuf"], st["qhead"], st["qcnt"], alive_pe, apk, aq,
                avalid, cap=CAP, ecn_thresh=ecn_t, backend=backend)
        st["drops"] = st["drops"] + (avalid & ~enq_try).sum(1).to(i32)
        st["drops"] = st["drops"] + (enq_try & ~do_enq).sum(1).to(i32)
        st["p_ecn"] = scatter(st["p_ecn"], marked, apk, True)
        st["qbuf"] = qbuf2
        st["qcnt"] = qcnt2
        st["max_q"] = torch.maximum(st["max_q"], qcnt2.amax(1))
        if s.probe[1]:
            # Per-layer maxima at the max_q reduction point, into the slot's
            # stride window (slots past the horizon clamp into the last).
            p_stride, p_samples = s.probe
            si = min(t // p_stride, p_samples - 1)
            lay = torch.stack([qcnt2[:, OFF[0]:OFF[1]].amax(1),
                               qcnt2[:, OFF[1]:OFF[2]].amax(1),
                               qcnt2[:, OFF[2]:OFF[3]].amax(1),
                               qcnt2[:, OFF[3]:OFF[4]].amax(1),
                               qcnt2[:, OFF[4]:].amax(1)], dim=1)
            qp = st["q_probe"].clone()
            qp[:, :, si] = torch.maximum(qp[:, :, si], lay)
            st["q_probe"] = qp
        # The slot's int32 sum, converted to float32, then added (the
        # reference's float32 + int32 promotion).
        st["sum_q"] = st["sum_q"] + torch.where(do_enq, occ_after, 0).sum(
            1).to(i32).to(torch.float32)
        st["enq_events"] = st["enq_events"] + do_enq.sum(1).to(i32)
        st["dl_pkt"] = set_row(st["dl_pkt"], arr_slot,
                               torch.full((B, NQ), -1, dtype=i32, device=dev))

        # ---- 9. ACK processing ----------------------------------------------
        a_row = torch.remainder(t + 1, ADELAY)   # written ack_delay slots ago
        ak = row_of(st["al_pkt"], a_row)
        aok = ak >= 0
        akc = torch.clamp_min(ak, 0)
        akf = torch.where(aok, searchsorted(ak), 0)
        st["al_pkt"] = set_row(st["al_pkt"], a_row,
                               torch.full((B, n), -1, dtype=i32, device=dev))
        # Duplicate hosts add the same float32 ack_cost: every order gives
        # the same partial sums, so the scatter-add is deterministic.
        st["h_ackdebt"] = scatter(st["h_ackdebt"], aok, g(fsrc, akf),
                                  f32(cfg.ack_cost), "add")
        st["f_acked"] = scatter(st["f_acked"], aok, akf, 1, "add")
        st["f_last_ack_t"] = scatter(st["f_last_ack_t"], aok, akf, t)
        aseq = ak - g(PBASE, akf)
        st["f_hi"] = scatter(st["f_hi"], aok, akf,
                             torch.where(aok, aseq, -1), "amax")
        if sack:
            st["f_cum"] = _slot.sack_advance(st["p_recv"], st["f_cum"], fsize,
                                             PBASE, backend=backend)
        mk = g(st["p_ecn"], akc)
        if s.adaptive_host and not s.plb:      # REPS recycle
            # ACKs of one flow come from its one destination host, at most
            # one a slot: the pool writes never collide.
            lab_back = g(st["p_a"], akc) * hl + g(st["p_c"], akc)
            good = aok & ~mk
            pc0 = g(st["pool_cnt"], akf)
            st["pool_lab"] = scatter(
                st["pool_lab"], good,
                akf.long() * 64 + torch.clamp_max(pc0, 63), lab_back)
            st["pool_cnt"] = torch.clamp_max(
                scatter(st["pool_cnt"], good, akf, 1, "add"), 64)
        if s.plb:
            w = f32(0.125)
            zero = torch.zeros((B, F), dtype=torch.float32, device=dev)
            dec = scatter(zero, aok, akf, 1.0, "add")
            inc = scatter(zero, aok & mk, akf, 1.0, "add")
            # XLA:CPU contracts ewma * (1 - w*dec) + w*inc into one fused
            # multiply-add (the reference engine's compiled fusion):
            # fma(ewma, 1 - w*dec, w*inc), both products exact.
            st["f_mark_ewma"] = fma32(st["f_mark_ewma"], f32(1.0) - w * dec,
                                      w * inc)
            change = ((st["f_mark_ewma"] > f32(cfg.plb_beta))
                      & (st["f_label_cnt"] > cfg.plb_alpha))
            newlab = g(rand_pool, torch.remainder(
                st["f_draw"] * 104729 + 13, pool_n))
            st["f_label"] = torch.where(change, newlab, st["f_label"])
            st["f_label_cnt"] = torch.where(change, 0, st["f_label_cnt"])
            st["f_draw"] = st["f_draw"] + change.to(i32)
        if cfg.cca == "mswift":
            target = f32(cfg.sw_target_slots)
            delay = (t - g(st["p_sent_t"], akc)).to(torch.float32)
            over = delay > target
            cw = st["f_cwnd"]
            inc = torch.where(aok & ~over, f32(cfg.sw_ai) / torch.maximum(
                g(cw, akf), f32(1.0)), f32(0.0))
            cw = scatter(cw, aok, akf, inc, "add")
            can_dec = ((t - g(st["f_last_dec"], akf))
                       > col(ack_delay + prop_slots))
            factor = torch.clamp(
                f32(1.0) - f32(cfg.sw_beta) * (delay - target)
                / torch.maximum(delay, f32(1.0)), 0.5, 1.0)
            dec_sel = aok & over & can_dec
            cw = scatter(cw, dec_sel, akf,
                         torch.where(dec_sel, factor, f32(1.0)), "prod")
            st["f_cwnd"] = torch.clamp(cw, f32(1.0), f32(cfg.sw_max_cwnd))
            st["f_last_dec"] = scatter(st["f_last_dec"], dec_sel, akf, t)

        # ---- 10. timeouts ---------------------------------------------------
        inflight2 = st["f_sent"] - st["f_acked"] - st["f_lost"]
        rto_fire = ((st["f_sent"] > 0) & (st["f_complete"] < 0)
                    & (inflight2 > 0)
                    & (t - st["f_last_ack_t"] > cfg.rto_slots))
        st["f_lost"] = st["f_lost"] + torch.where(rto_fire, inflight2, 0)
        st["f_last_ack_t"] = torch.where(rto_fire, t, st["f_last_ack_t"])
        if sack:
            st["f_next"] = torch.where(
                rto_fire, torch.minimum(st["f_next"], st["f_cum"]),
                st["f_next"])
        if cfg.cca == "mswift":
            st["f_cwnd"] = torch.where(rto_fire, f32(1.0), st["f_cwnd"])

        # ---- 11. flow completion --------------------------------------------
        done_now = ((st["f_complete"] < 0)
                    & ((st["f_cum"] if sack else st["f_acked"]) >= fsize))
        st["f_complete"] = torch.where(done_now, t, st["f_complete"])
        return {k: (v.to(st_in[k].dtype) if v.dtype != st_in[k].dtype
                    else v) for k, v in st.items()}

    def running(st: dict, t: int) -> torch.Tensor:
        return (st["f_complete"] < 0).any(1) & (t < max_slots)

    t = 0
    t_end = int(max_slots.max())
    while t < t_end and bool(running(st, t).any()):
        for _ in range(CHUNK_SLOTS):
            if t >= t_end:
                break
            act = running(st, t)
            new = step(st, t)
            # A row whose predicate is false keeps its whole state.
            st = {k: torch.where(act.view((B,) + (1,) * (v.dim() - 1)),
                                 new[k], v) for k, v in st.items()}
            t += 1
    STEPS += t
    out = {
        "delivered_slot": st["p_deliv"],
        "flow_complete": st["f_complete"],
        "f_data_done": st["f_data_done"],
        "drops": st["drops"],
        "rtx": st["rtx"],
        "max_q": st["max_q"],
        "sum_q": st["sum_q"],
        "enq_events": st["enq_events"],
        "f_cwnd": st["f_cwnd"],
    }
    if s.probe[1]:
        out["q_probe"] = st["q_probe"]
    return out
