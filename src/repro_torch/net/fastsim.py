"""Layered max-plus fabric engine (the "fast" simulator), in PyTorch.

A port of the JAX reference ``repro.net.fastsim``, bitwise equal to it per
point.  With the paper's uniform workloads (identical packet sizes,
synchronized line-rate senders) every queue is FIFO with unit service time
(1 slot = one data-packet serialization), so per-queue departure times obey
the Lindley recursion

    d_i = max(a_i, d_{i-1}) + 1

which is an associative segmented max-plus scan: expanding,
``d_i = i + 1 + max_{j<=i, same queue}(a_j - j)``.  A 5-hop fat-tree
traversal therefore becomes five rounds of (sort by (queue, arrival),
segmented cumulative max, gather).  The segmented cummax runs on the CUDA
kernel of ``repro_torch.kernels.lindley``; the adaptive (JSQ) layers walk
each switch's arrivals in order on the CUDA kernel of
``repro_torch.kernels.jsq_scan``.  On CPU tensors both take their plain
PyTorch versions.

Timing model
------------
* time unit: one data-packet slot ( (payload+header+gap) / line-rate );
* hosts pace at line rate and carry a random fractional *phase* in [0,1):
  synchronized-but-not-atomically-aligned senders, which give switch-local
  schemes (JSQ, RR) their "sticky flow" behavior (paper App. C);
* propagation adds ``prop_slots`` per traversed link;
* the queue length seen by an arriving packet equals its waiting time in
  slots: ``occ_i = d_i - a_i - 1``.

Supported schemes: everything without ACK/ECN feedback -- ECMP, subflows,
host packet spraying, HOST DR, SIMPLE RR, SWITCH PKT, RSQ, JSQ, SWITCH PKT
AR (quantized JSQ), OFAN.  Link failures are static (``links=``) or a
dynamic fault schedule (``fault=``, a
:class:`repro_torch.faults.FaultSchedule`): each packet's routing state is
bound to the fault epoch its integer release slot has reached (after the
scheme class's reaction delay), per-epoch host choices and OFAN pointer
tables are drawn host-side, and the pipeline gathers them by epoch.

Dispatch granularities: :func:`simulate` (one point), :func:`simulate_batch`
(one point, many seeds) and :func:`simulate_megabatch` (many points sharing
a pipeline shape fused onto one batch axis, optionally split over several
CUDA devices) -- all bitwise-identical per point.  One pipeline serves all
three: it runs over a leading batch axis ``(B, n_packets)``.  Host-side
preparation and per-seed draws stay numpy, exactly as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .topology import FatTree, LinkState, N_LAYERS, LAYER_NAMES
from .workloads import Workload
from ._batching import (TreePad, pad_tail as _pad_tail, pad_to_group_max,
                        port_pad_penalty, shard_pad)
from ..core.lb_schemes import LBScheme, precompute_host_choices
from ..core import entropy as ent
from ..core import ofan as ofan_mod
from ..obs.probes import QueueProbe, probe_shape
from ..kernels._common import resolve_backend, resolve_device
from ..kernels.lindley import ops as _lindley
from ..kernels.jsq_scan import ops as _jsq

_NEG = -1.0e9
_BIG = 2**30                 # sort key of inactive / bypass rows
_MAX_ROW = 2**24             # float32 packet indices are exact below this


# ---------------------------------------------------------------------------
# Sorting helpers along the last axis.
# ---------------------------------------------------------------------------

def _lexsort(keys) -> torch.Tensor:
    """Stable lexicographic order along the last axis, least significant
    key first (``jnp.lexsort`` semantics): one stable sort per key."""
    order = torch.argsort(keys[0], dim=-1, stable=True)
    for k in keys[1:]:
        o = torch.argsort(torch.gather(k, -1, order), dim=-1, stable=True)
        order = torch.gather(order, -1, o)
    return order


def _inverse(order: torch.Tensor) -> torch.Tensor:
    n = order.shape[-1]
    ar = torch.arange(n, device=order.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ar)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, idx)


def _seg_starts(sorted_key: torch.Tensor) -> torch.Tensor:
    first = torch.ones_like(sorted_key[..., :1], dtype=torch.bool)
    return torch.cat([first, sorted_key[..., 1:] != sorted_key[..., :-1]],
                     dim=-1)


def _row_index(n: int, device) -> torch.Tensor:
    if n > _MAX_ROW:
        raise ValueError(f"{n} packets in one row: float32 packet indices "
                         f"are exact only up to {_MAX_ROW}")
    return torch.arange(n, dtype=torch.float32, device=device)


def _counts(qid: torch.Tensor, active: torch.Tensor, n: int) -> torch.Tensor:
    """Per-queue packet counts (B, n) int32; integer adds are exact in any
    order."""
    cnt = torch.zeros((qid.shape[0], n), dtype=torch.int32, device=qid.device)
    return cnt.scatter_add_(1, torch.where(active, qid, 0).long(),
                            active.to(torch.int32))


# ---------------------------------------------------------------------------
# Segmented max-plus scan.
# ---------------------------------------------------------------------------

def _ranks_and_starts(sorted_gkey: torch.Tensor, backend: str):
    """Given group keys sorted ascending along the last axis, return (rank
    within group, segment start flags)."""
    n = sorted_gkey.shape[-1]
    if n == 0:      # zero-packet workload: no groups, no scan
        return (torch.zeros_like(sorted_gkey, dtype=torch.int32),
                torch.zeros_like(sorted_gkey, dtype=torch.bool))
    idx = _row_index(n, sorted_gkey.device)
    flag = _seg_starts(sorted_gkey)
    start = _lindley.segmented_cummax(torch.where(flag, idx, _NEG), flag,
                                      backend)
    return (idx - start).to(torch.int32), flag


# ---------------------------------------------------------------------------
# One queueing layer: Lindley over explicit queue ids.
# ---------------------------------------------------------------------------

def _lindley_layer(qid, a, tie, n_queues: int, backend: str):
    """FIFO service of one layer.  ``qid`` int32 (B, npk) (-1 => bypass).

    Returns (departure, counts[B, n_queues], occ): ``occ`` is the per-packet
    queue length seen on arrival (0 for bypass rows).
    """
    B, npk = qid.shape
    if npk == 0:
        return (a, torch.zeros((B, n_queues), dtype=torch.int32,
                               device=a.device),
                torch.zeros((B, 0), dtype=torch.float32, device=a.device))
    real = qid >= 0
    qkey = torch.where(real, qid, _BIG)
    order = _lexsort((tie, a, qkey))
    qs = _take(qkey, order)
    av = _take(a, order)
    idx = _row_index(npk, a.device)
    flag = _seg_starts(qs)
    m = _lindley.segmented_cummax(av - idx, flag, backend)
    d_sorted = m + idx + 1.0
    d_sorted = torch.where(qs < _BIG, d_sorted, av)    # bypass: no service
    d = _take(d_sorted, _inverse(order))
    occ = torch.where(real, d - a - 1.0, 0.0)         # queue seen on arrival
    return d, _counts(qid, real, n_queues), occ


# ---------------------------------------------------------------------------
# Rank-based switch port selection (SIMPLE RR / SWITCH PKT / OFAN).
# ---------------------------------------------------------------------------

def _ranked_ports(gkey, a, tie, active, select_fn, backend, extra=None):
    """Sort active packets by (group pointer key, arrival), rank each packet
    within its group, and map rank -> port via ``select_fn(gid, rank)``.
    Inactive packets get port 0.  ``extra`` (the per-packet fault-epoch
    index) is carried through the sort to ``select_fn(gid, rank, extra)``."""
    g = torch.where(active, gkey, _BIG)
    order = _lexsort((tie, a, g))
    gs = _take(g, order)
    rank, _ = _ranks_and_starts(gs, backend)
    gid = torch.where(gs < _BIG, gs, 0)
    if extra is None:
        port_sorted = select_fn(gid, rank)
    else:
        port_sorted = select_fn(gid, rank, _take(extra, order))
    port = _take(port_sorted, _inverse(order))
    return torch.where(active, port, 0).to(torch.int32)


def _select_fn_for(mode: str, h_log: torch.Tensor, tables: dict,
                   reset_wraps: int):
    """Build select_fn(gid, rank)->port for rank-based modes over (B, n)
    operands and (B, ...) tables.  ``h_log`` (B,) is each row's *logical*
    port count: a point padded onto a larger tree still rotates over its own
    k/2 ports."""
    hl = h_log[:, None]
    if mode == "rr":
        starts = tables["rr_starts"]          # (B, n_groups)

        def f(gid, rank):
            return (_take(starts, gid.long()) + rank) % hl
        return f
    if mode == "rr_reset":
        perms = tables["rr_perms"]            # (B, n_groups, n_epochs, h)
        starts = tables["rr_starts"]
        B, _, n_epochs, hp = perms.shape
        flat = perms.reshape(B, -1)

        def f(gid, rank):
            epoch = torch.clamp_max(rank // (reset_wraps * hl), n_epochs - 1)
            col = (_take(starts, gid.long()) + rank) % hl
            pos = (gid.long() * n_epochs + epoch.long()) * hp + col.long()
            return _take(flat, pos)
        return f
    if mode == "ofan":
        orders = tables["orders"]             # (B, n_epochs, n_ptrs, W)
        starts = tables["starts"]             # (B, n_epochs, n_ptrs)
        lens = tables["lens"]                 # (B, n_epochs, n_ptrs)
        B, _, n_ptrs, width = orders.shape
        orders_f = orders.reshape(B, -1)
        starts_f = starts.reshape(B, -1)
        lens_f = lens.reshape(B, -1)

        def f(gid, rank, ep):
            ptr = ep.long() * n_ptrs + gid.long()
            L = torch.clamp_min(_take(lens_f, ptr), 1)
            col = (_take(starts_f, ptr) + rank) % L
            return _take(orders_f, ptr * width + col.long())
        return f
    raise ValueError(mode)


# ---------------------------------------------------------------------------
# JSQ layers (adaptive switch): padded per-switch scan.
# ---------------------------------------------------------------------------

def _jsq_layer(switch, a, tie, active, *, n_switches: int, pad: int, h: int,
               h_log, quanta: Optional[Tuple[float, ...]], buffer_pkts: int,
               noise, backend: str):
    """Joint port-choice + FIFO service for one adaptive layer.

    Returns (port, departure, occ_seen, max_rank) over (B, npk).  ``noise``
    is (B, n_switches, pad, h) pre-drawn uniforms for random tie-breaking.
    ``max_rank`` (B,) is the deepest per-switch arrival rank seen; the
    caller compares it against the *logical* pad limit.
    """
    B, npk = switch.shape
    dev = a.device
    skey = torch.where(active, switch, _BIG)
    order = _lexsort((tie, a, skey))
    ss = _take(skey, order)
    av = _take(a, order)
    rank, _ = _ranks_and_starts(ss, backend)
    valid = ss < _BIG
    max_rank = (torch.where(valid, rank, 0).amax(dim=-1) if npk
                else torch.zeros((B,), dtype=torch.int32, device=dev))

    # Inactive packets scatter to a sink row (index n_switches) that is cut
    # off below -- they must never clobber grid cells owned by real packets.
    rows = torch.where(valid, ss, n_switches).long()
    cols = torch.clamp(rank, 0, pad - 1).long()
    cell = rows * pad + cols
    n_cells = (n_switches + 1) * pad
    t_grid = torch.full((B, n_cells), _NEG, dtype=torch.float32, device=dev)
    t_grid.scatter_(1, cell, torch.where(valid, av, _NEG))
    v_grid = torch.zeros((B, n_cells), dtype=torch.bool, device=dev)
    v_grid.scatter_(1, cell, valid)
    t_grid = t_grid.view(B, n_switches + 1, pad)[:, :n_switches]
    v_grid = v_grid.view(B, n_switches + 1, pad)[:, :n_switches]

    thresholds = None
    if quanta is not None:
        thresholds = (torch.tensor(quanta, dtype=torch.float32, device=dev)
                      * buffer_pkts)
    # Ports beyond the point's logical k/2 exist only because the grid is
    # padded to a larger tree's width.
    port_pen = port_pad_penalty(h, h_log)
    ports_g, deps_g, occs_g = _jsq.jsq_scan(t_grid, v_grid, noise, port_pen,
                                            thresholds, backend)
    # Inactive rows read a real cell (row clamped, as the reference's
    # gather clamps) and are masked below.
    back = torch.clamp_max(rows, n_switches - 1) * pad + cols
    inv = _inverse(order)
    port = _take(_take(ports_g.reshape(B, -1), back), inv)
    dep = _take(_take(deps_g.reshape(B, -1), back), inv)
    occ = _take(_take(occs_g.reshape(B, -1), back), inv)
    return (torch.where(active, port, 0).to(torch.int32),
            torch.where(active, dep, a),
            torch.where(active, occ, 0.0), max_rank)


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LayerStats:
    counts: np.ndarray
    max_queue: float
    avg_wait: float


@dataclasses.dataclass
class FastSimResult:
    delivery: np.ndarray            # per-packet delivery time (slots)
    flow_completion: np.ndarray     # per-flow last-delivery (slots)
    cct: float                      # max over flows (slots)
    layers: Dict[str, LayerStats]
    max_queue: float                # max over all layers (packets)
    a_used: np.ndarray
    c_used: np.ndarray
    # Queue-occupancy time series, present only when the point ran with a
    # probe spec (see repro_torch.obs.probes).
    probe: Optional[QueueProbe] = None

    def max_queue_layer(self, layer: int) -> float:
        return self.layers[LAYER_NAMES[layer]].max_queue


# ---------------------------------------------------------------------------
# The batched 5-layer pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PipeShape:
    """Everything static about one pipeline run: tree dims of the (padded)
    tree, scheme modes, JSQ grid padding, propagation delay, backend,
    table keys and probe shape."""
    h: int
    n_pods: int
    n_edges: int
    n_aggs: int
    n_hosts: int
    edge_mode: str
    agg_mode: str
    quanta: Optional[Tuple[float, ...]]
    buffer_pkts: int
    reset_wraps: int
    pad_e: int
    pad_a: int
    prop: float
    backend: str
    tables_e_keys: Tuple[str, ...]
    tables_a_keys: Tuple[str, ...]
    probe_stride: int = 0
    probe_samples: int = 0


def _pipeline(cfg: PipeShape, x: Dict[str, torch.Tensor]) -> dict:
    """Run the five queueing layers over a (B, npk) batch of points."""
    h, backend = cfg.h, cfg.backend
    mid = cfg.n_pods * h * h            # queues per middle layer
    p1, e1, p2, e2, dst = x["p1"], x["e1"], x["p2"], x["e2"], x["dst"]
    inter_pod, leaves_edge = x["inter_pod"], x["leaves_edge"]
    tie, h_log = x["tie"], x["h_log"]
    tbl_e = dict(zip(cfg.tables_e_keys, x["te"]))
    tbl_a = dict(zip(cfg.tables_a_keys, x["ta"]))
    # The reference adds python floats to float32 arrays, i.e. their float32
    # roundings; a float32-exact value gives that sum on every device.
    prop = float(np.float32(cfg.prop))
    B = p1.shape[0]
    overflow = torch.zeros((B,), dtype=torch.bool, device=p1.device)
    counts, occs, n_real, p_arr, p_act = [], [], [], [], []

    def served(qid, a_t, n_queues, active):
        d, cnt, occ = _lindley_layer(qid, a_t, tie, n_queues, backend)
        counts.append(cnt)
        occs.append(occ)
        n_real.append(active.sum(dim=-1, dtype=torch.int32))
        p_arr.append(a_t)
        p_act.append(active)
        return d

    def adaptive(switch, a_t, active, n_switches, pad, noise, pad_lim):
        port, d, occ, max_rank = _jsq_layer(
            switch, a_t, tie, active, n_switches=n_switches, pad=pad, h=h,
            h_log=h_log, quanta=cfg.quanta, buffer_pkts=cfg.buffer_pkts,
            noise=noise, backend=backend)
        qid = torch.where(active, switch * h + port, -1)
        counts.append(_counts(qid, qid >= 0, mid))
        occs.append(occ)
        n_real.append(active.sum(dim=-1, dtype=torch.int32))
        p_arr.append(a_t)
        p_act.append(active)
        return port, d, max_rank >= pad_lim

    def ranked(mode, gkey, a_t, active, tbl, extra=None):
        fn = _select_fn_for(mode, h_log, tbl, cfg.reset_wraps)
        return _ranked_ports(gkey, a_t, tie, active, fn, backend, extra)

    a_t = x["t_rel"] + prop                 # arrival at source edge switch
    edge_switch = p1 * h + e1

    # ---------- UP_E ----------
    mode = cfg.edge_mode
    if mode in ("jsq", "jsq_quant"):
        a_used, d, ovf = adaptive(edge_switch, a_t, leaves_edge, cfg.n_edges,
                                  cfg.pad_e, x["noise_e"], x["pad_lim_e"])
        overflow |= ovf
    else:
        if mode == "pre":
            a_used = x["a_pre"]
        elif mode == "rand":
            a_used = x["rand_a"]
        elif mode in ("rr", "rr_reset"):
            a_used = ranked(mode, edge_switch, a_t, leaves_edge, tbl_e)
        elif mode == "ofan":
            gkey = edge_switch * cfg.n_edges + (p2 * h + e2)
            a_used = ranked(mode, gkey, a_t, leaves_edge, tbl_e, x["ep_sw"])
        else:
            raise ValueError(mode)
        qid = torch.where(leaves_edge, edge_switch * h + a_used, -1)
        d = served(qid, a_t, mid, leaves_edge)
    a_t = torch.where(leaves_edge, d + prop, a_t)

    # ---------- UP_A ----------
    agg_switch = p1 * h + a_used
    mode = cfg.agg_mode
    if mode in ("jsq", "jsq_quant"):
        c_used, d, ovf = adaptive(agg_switch, a_t, inter_pod, cfg.n_aggs,
                                  cfg.pad_a, x["noise_a"], x["pad_lim_a"])
        overflow |= ovf
    else:
        if mode == "pre":
            c_used = x["c_pre"]
        elif mode == "rand":
            c_used = x["rand_c"]
        elif mode in ("rr", "rr_reset"):
            c_used = ranked(mode, agg_switch, a_t, inter_pod, tbl_a)
        elif mode == "ofan":
            gkey = agg_switch * cfg.n_pods + p2
            c_used = ranked(mode, gkey, a_t, inter_pod, tbl_a, x["ep_sw"])
        else:
            raise ValueError(mode)
        qid = torch.where(inter_pod, agg_switch * h + c_used, -1)
        d = served(qid, a_t, mid, inter_pod)
    a_t = torch.where(inter_pod, d + prop, a_t)

    # ---------- DN_C (forced: core (a_used, c_used) -> agg a_used of p2) --
    qid = torch.where(inter_pod, (p2 * h + a_used) * h + c_used, -1)
    d = served(qid, a_t, mid, inter_pod)
    a_t = torch.where(inter_pod, d + prop, a_t)

    # ---------- DN_A (forced: agg a_used -> edge e2) ----------
    qid = torch.where(leaves_edge, (p2 * h + a_used) * h + e2, -1)
    d = served(qid, a_t, mid, leaves_edge)
    a_t = torch.where(leaves_edge, d + prop, a_t)

    # ---------- DN_E (forced: edge -> host) ----------
    # dst == -1 marks shape-bucketing pad packets (inert bypass rows).
    d = served(dst, a_t, cfg.n_hosts, dst >= 0)
    delivery = d + prop

    out = {"delivery": delivery, "counts": counts,
           "occ": torch.stack(occs, dim=1), "n_real": torch.stack(n_real, 1),
           "a_used": a_used, "c_used": c_used, "overflow": overflow}
    if cfg.probe_samples:
        # Scatter-max each packet's observed occupancy into the stride
        # window of its arrival time; inactive rows go to a sink window that
        # is cut off, arrivals past the horizon clamp into the last window.
        stride = float(np.float32(cfg.probe_stride))
        n_s = cfg.probe_samples
        qsr = torch.zeros((B, N_LAYERS, n_s + 1), dtype=torch.float32,
                          device=p1.device)
        for li in range(N_LAYERS):
            si = torch.clamp(torch.div(p_arr[li], stride,
                                       rounding_mode="floor").to(torch.int32),
                             0, n_s - 1)
            win = torch.where(p_act[li], si, n_s).long()
            qsr[:, li].scatter_reduce_(
                -1, win, torch.where(p_act[li], occs[li], 0.0), "amax")
        out["probe_q"] = qsr[..., :n_s]
    return out


def _to_device(stacked: dict, device: torch.device) -> dict:
    def conv(v):
        if isinstance(v, tuple):
            return tuple(conv(y) for y in v)
        return torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return {k: conv(v) for k, v in stacked.items()}


def _to_numpy(out: dict) -> dict:
    def conv(v):
        if isinstance(v, list):
            return [conv(y) for y in v]
        return v.cpu().numpy()
    return {k: conv(v) for k, v in out.items()}


def _run(cfg: PipeShape, stacked: dict, device: torch.device,
         n_shards: int = 1) -> dict:
    """Run the pipeline over a stacked numpy batch; with ``n_shards > 1`` the
    batch is cut into ``n_shards`` contiguous chunks and chunk ``i`` runs on
    CUDA device ``i`` (every chunk on the CPU for a CPU device).  Returns
    the numpy outputs with the batch axis first."""
    n_batch = len(stacked["t_rel"])
    if n_shards == 1:
        return _to_numpy(_pipeline(cfg, _to_device(stacked, device)))
    if device.type == "cuda" and n_shards > torch.cuda.device_count():
        raise ValueError(f"n_shards={n_shards} but only "
                         f"{torch.cuda.device_count()} CUDA devices")
    size = n_batch // n_shards
    outs = []
    for i in range(n_shards):        # launch every chunk before reading any
        dev = torch.device("cuda", i) if device.type == "cuda" else device
        chunk = {k: (tuple(y[i * size:(i + 1) * size] for y in v)
                     if isinstance(v, tuple) else v[i * size:(i + 1) * size])
                 for k, v in stacked.items()}
        outs.append(_pipeline(cfg, _to_device(chunk, dev)))
    outs = [_to_numpy(o) for o in outs]
    return {k: ([np.concatenate([o[k][li] for o in outs])
                 for li in range(len(outs[0][k]))]
                if isinstance(outs[0][k], list)
                else np.concatenate([o[k] for o in outs]))
            for k in outs[0]}


def _stack(elems: list) -> dict:
    out = {}
    for k, v in elems[0].items():
        if isinstance(v, tuple):
            out[k] = tuple(np.stack([d[k][j] for d in elems])
                           for j in range(len(v)))
        else:
            out[k] = np.stack([d[k] for d in elems])
    return out


def _row(out: dict, b: int) -> dict:
    return {k: ([x[b] for x in v] if isinstance(v, list) else v[b])
            for k, v in out.items()}


# ---------------------------------------------------------------------------
# Host-side preparation (numpy; per-seed draws bit-identical to the
# reference).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SimPlan:
    """Seed-independent preparation of one (tree, workload, scheme, links)
    simulation point; :func:`_draw_seed_inputs` makes the per-seed arrays
    that become the leading batch axis."""
    tree: FatTree
    wl: Workload
    scheme: LBScheme
    prop_slots: float
    links: Optional[LinkState]
    backend: str
    jsq_pad_factor: float
    static_args: dict = dataclasses.field(default_factory=dict)
    # Fault-epoch state: one LinkState per epoch ([links] for static points),
    # per-epoch (n_flows, k/2, k/2) alive paths of host-labelled schemes
    # (None entries for failure-free epochs; None when no epoch fails) and
    # the host-reaction epoch index of each packet (see _prepare).
    ep_links: list = dataclasses.field(default_factory=list)
    pv: Optional[list] = None
    ep_host: Optional[np.ndarray] = None
    n_reset_epochs: int = 1
    pad_e: int = 0
    pad_a: int = 0
    quanta: Optional[Tuple[float, ...]] = None
    tables_e_keys: Tuple[str, ...] = ()
    tables_a_keys: Tuple[str, ...] = ()

    @property
    def jsq(self) -> bool:
        return self.scheme.edge_mode in ("jsq", "jsq_quant")

    def pipe_shape(self, *, pad_e=None, pad_a=None, tree=None,
                   probes=None) -> PipeShape:
        """``pad_e``/``pad_a`` override the plan's own JSQ grid padding when
        a megabatch pads members to a group-wide maximum; ``tree`` overrides
        the plan's own tree when a megabatch pads members onto a larger fat
        tree; ``probes`` adds the per-layer queue-occupancy series."""
        tree = self.tree if tree is None else tree
        stride, samples = probe_shape(probes)
        return PipeShape(
            h=tree.half, n_pods=tree.n_pods, n_edges=tree.n_edge_switches,
            n_aggs=tree.n_agg_switches, n_hosts=tree.n_hosts,
            edge_mode=self.scheme.edge_mode, agg_mode=self.scheme.agg_mode,
            quanta=self.quanta, buffer_pkts=self.scheme.buffer_pkts,
            reset_wraps=self.scheme.reset_wraps,
            pad_e=self.pad_e if pad_e is None else pad_e,
            pad_a=self.pad_a if pad_a is None else pad_a,
            prop=float(self.prop_slots), backend=self.backend,
            tables_e_keys=self.tables_e_keys,
            tables_a_keys=self.tables_a_keys,
            probe_stride=stride, probe_samples=samples)


def _prepare(tree: FatTree, wl: Workload, scheme: LBScheme, prop_slots: float,
             links: Optional[LinkState], backend: str,
             jsq_pad_factor: float, fault=None) -> SimPlan:
    """Host-side precomputation shared by every seed of a simulation point."""
    if scheme.needs_feedback:
        raise ValueError(f"{scheme.name} needs ACK feedback; use net.loopsim")
    if fault is not None:
        if links is not None:
            raise ValueError("pass either links= or fault=, not both")
        comp = fault.compile(tree)
        ep_links = list(comp.links)
        links = ep_links[0]             # epoch-0 state for host-side consumers
        host_starts = comp.react_starts("host")
        switch_starts = comp.react_starts("switch")
    else:
        ep_links = [links]
        host_starts = switch_starts = np.zeros(1, np.int32)
    plan = SimPlan(tree=tree, wl=wl, scheme=scheme, prop_slots=prop_slots,
                   links=links, backend=backend, jsq_pad_factor=jsq_pad_factor)
    plan.ep_links = ep_links
    src, dst = wl.src, wl.dst
    p1 = tree.host_pod(src).astype(np.int32)
    e1 = tree.host_edge(src).astype(np.int32)
    p2 = tree.host_pod(dst).astype(np.int32)
    e2 = tree.host_edge(dst).astype(np.int32)
    inter_pod = (p1 != p2)
    leaves_edge = inter_pod | (e1 != e2)
    # Per-packet fault-epoch binding at the seed-independent integer release
    # slot (before the per-seed phase jitter): reaction starts are
    # nondecreasing, so the epoch a packet sees is the last one whose
    # reaction slot its release has reached, floored at 0.  Static points
    # get all zeros.
    ep_host = np.maximum(
        np.searchsorted(host_starts, wl.t_release, side="right") - 1,
        0).astype(np.int32)
    ep_sw = np.maximum(
        np.searchsorted(switch_starts, wl.t_release, side="right") - 1,
        0).astype(np.int32)
    plan.ep_host = ep_host
    plan.static_args = dict(p1=p1, e1=e1, p2=p2, e2=e2,
                            dst=dst.astype(np.int32), inter_pod=inter_pod,
                            leaves_edge=leaves_edge, ep_sw=ep_sw,
                            # Logical port count: an operand, so a point
                            # padded onto a larger tree's pipeline still
                            # rotates/sprays over its own k/2 ports.
                            h_log=np.int32(tree.half))

    # ---- path validity under failures (host visibility: converged state) --
    if scheme.edge_mode == "pre":
        pv = [np.stack([l.path_matrix(int(s), int(d))
                        for s, d in zip(wl.flow_src, wl.flow_dst)])
              if (l is not None and l.any_failure()) else None
              for l in ep_links]
        if any(x is not None for x in pv):
            plan.pv = pv

    h = tree.half
    plan.tables_e_keys = plan.tables_a_keys = scheme.table_keys()
    if scheme.edge_mode == "rr_reset":
        max_cnt = int(np.bincount(tree.host_global_edge(src)[leaves_edge],
                                  minlength=tree.n_edge_switches).max()
                      ) if leaves_edge.any() else 1
        plan.n_reset_epochs = max(
            1, int(np.ceil(max_cnt / (scheme.reset_wraps * h))))

    # ---- JSQ padding (workload-dependent, seed-independent) ----------------
    if plan.jsq:
        cnt_e = np.bincount(tree.host_global_edge(src)[leaves_edge],
                            minlength=tree.n_edge_switches)
        plan.pad_e = max(int(cnt_e.max()), 1)
        per_pod = np.bincount(p1[inter_pod], minlength=tree.n_pods)
        plan.pad_a = max(int(np.ceil(jsq_pad_factor * per_pod.max() / h)) + 64,
                         64)
    plan.quanta = (tuple(scheme.quanta) if scheme.edge_mode == "jsq_quant"
                   else None)
    # Logical JSQ pad limits travel as operands: a megabatch may run this
    # point on a grid padded to a group-wide maximum, yet the
    # overflow-and-retry decision must match a standalone run's.
    plan.static_args["pad_lim_e"] = np.int32(plan.pad_e if plan.jsq else 2**30)
    plan.static_args["pad_lim_a"] = np.int32(plan.pad_a if plan.jsq else 2**30)
    return plan


def _draw_seed_inputs(plan: SimPlan, seed: int) -> dict:
    """Per-seed randomness, drawn in the reference's exact order so results
    stay bit-identical to it, run-to-run and serial-to-batched."""
    tree, wl, scheme = plan.tree, plan.wl, plan.scheme
    h = tree.half
    npk = wl.n_packets
    rng = np.random.default_rng(seed)

    phases = rng.random(wl.n_hosts).astype(np.float32)
    t_rel = (wl.t_release + phases[wl.src]).astype(np.float32)
    # Flow-static tie keys: consistent switch arbitration across slots.
    tie = rng.random(wl.n_flows).astype(np.float32)[wl.flow]

    a_pre = c_pre = None
    if scheme.edge_mode == "pre":
        if plan.pv is None:
            a_pre, c_pre = precompute_host_choices(
                scheme, tree, wl.flow, wl.seq, wl.flow_src, wl.flow_dst, rng)
        else:
            # One sequential draw per epoch, in epoch order (a one-epoch
            # schedule consumes exactly the static path's draws), then each
            # packet takes its host-reaction epoch's choice.
            per_ep = [precompute_host_choices(
                scheme, tree, wl.flow, wl.seq, wl.flow_src, wl.flow_dst, rng,
                path_valid=pv_e) for pv_e in plan.pv]
            pk = np.arange(npk)
            a_pre = np.stack([a for a, _ in per_ep])[plan.ep_host, pk]
            c_pre = np.stack([c for _, c in per_ep])[plan.ep_host, pk]
        a_pre = a_pre.astype(np.int32)
        c_pre = c_pre.astype(np.int32)
    rand_a = rng.integers(0, h, npk).astype(np.int32)
    rand_c = rng.integers(0, h, npk).astype(np.int32)

    # ---- switch tables ------------------------------------------------------
    n_edges = tree.n_edge_switches
    n_aggs = tree.n_agg_switches
    tables_e: dict = {}
    tables_a: dict = {}
    if scheme.edge_mode in ("rr", "rr_reset"):
        tables_e["rr_starts"] = rng.integers(0, h, n_edges).astype(np.int32)
        tables_a["rr_starts"] = rng.integers(0, h, n_aggs).astype(np.int32)
        if scheme.edge_mode == "rr_reset":
            n_ep = plan.n_reset_epochs
            tables_e["rr_perms"] = np.argsort(
                rng.random((n_edges, n_ep, h)), axis=-1).astype(np.int32)
            tables_a["rr_perms"] = np.argsort(
                rng.random((n_aggs, n_ep, h)), axis=-1).astype(np.int32)
    elif scheme.edge_mode == "ofan":
        # One table build per fault epoch, in epoch order ([links] for
        # static points, so one epoch consumes the static stream).  Pointer
        # tables carry a leading epoch axis, width-padded to the widest
        # epoch; pad columns lie beyond every epoch's ``lens`` modulo.
        ots = [ofan_mod.build_tables(tree, rng, links=l)
               for l in plan.ep_links]

        def _eps(arrs):
            return np.stack(pad_to_group_max([np.asarray(a) for a in arrs]))
        tables_e = {"orders": _eps([ot.edge_orders for ot in ots]),
                    "starts": _eps([ot.edge_starts for ot in ots]),
                    "lens": _eps([ot.edge_len for ot in ots])}
        tables_a = {"orders": _eps([ot.agg_orders for ot in ots]),
                    "starts": _eps([ot.agg_starts for ot in ots]),
                    "lens": _eps([ot.agg_len for ot in ots])}

    # JSQ tie-break noise from the counter streams (core.entropy), keyed on
    # (seed, site, logical switch id, arrival rank, port): growing the rank
    # axis (pad-overflow retry, megabatch padding) extends the grid without
    # perturbing existing entries.
    noise_e = noise_a = np.zeros((1, 1, 1), np.float32)
    if plan.jsq:
        noise_e = ent.uniform_grid(seed, ent.SITE_FAST_EDGE_JSQ,
                                   n_edges, plan.pad_e, h)
        noise_a = ent.uniform_grid(seed, ent.SITE_FAST_AGG_JSQ,
                                   n_aggs, plan.pad_a, h)

    return dict(t_rel=t_rel, tie=tie,
                a_pre=a_pre if a_pre is not None else np.zeros(npk, np.int32),
                c_pre=c_pre if c_pre is not None else np.zeros(npk, np.int32),
                rand_a=rand_a, rand_c=rand_c,
                noise_e=noise_e, noise_a=noise_a,
                te=tuple(np.asarray(tables_e[k]) for k in plan.tables_e_keys),
                ta=tuple(np.asarray(tables_a[k]) for k in plan.tables_a_keys))


def _postprocess(out: dict, wl: Workload, probes=None) -> FastSimResult:
    """Assemble a FastSimResult from one (unbatched) numpy output row."""
    delivery = out["delivery"]
    flow_completion = np.full(wl.n_flows, -np.inf)
    np.maximum.at(flow_completion, wl.flow, delivery)
    # Zero-packet flows receive no delivery and complete instantly.
    flow_completion[np.isneginf(flow_completion)] = 0.0
    layers = {}
    max_q = 0.0
    for li, name in enumerate(LAYER_NAMES):
        cnts = out["counts"][li]
        occ = np.asarray(out["occ"][li])
        mq = float(occ.max()) if occ.size else 0.0
        n_real = int(out["n_real"][li])
        # Host-side f64 sum over the (already unpadded) occupancy: padding
        # and fusion can never perturb the average through reduction order.
        aw = float(occ.sum(dtype=np.float64)) / max(n_real, 1)
        layers[name] = LayerStats(counts=cnts, max_queue=mq, avg_wait=aw)
        max_q = max(max_q, mq)
    probe = (QueueProbe(probe_shape(probes)[0], np.asarray(out["probe_q"]))
             if "probe_q" in out else None)
    return FastSimResult(delivery=delivery, flow_completion=flow_completion,
                         cct=float(delivery.max()) if delivery.size else 0.0,
                         layers=layers,
                         max_queue=max_q, a_used=out["a_used"],
                         c_used=out["c_used"], probe=probe)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def simulate(tree: FatTree, wl: Workload, scheme: LBScheme, seed: int = 0,
             prop_slots: float = 12.0, collect_stats: bool = True,
             links: Optional[LinkState] = None,
             backend: str = "auto", jsq_pad_factor: float = 4.0,
             probes=None, fault=None, device=None) -> FastSimResult:
    """Run one collective under ``scheme`` on the fast engine.

    ``fault``: a :class:`repro_torch.faults.FaultSchedule` (mutually
    exclusive with ``links``).  ``device=None`` runs on CUDA and raises when
    no card is visible; ``device="cpu"`` runs the plain PyTorch versions of
    the kernels.
    """
    resolve_backend(backend)
    device = resolve_device(device)
    plan = _prepare(tree, wl, scheme, prop_slots, links, backend,
                    jsq_pad_factor, fault=fault)
    elem = {**plan.static_args, **_draw_seed_inputs(plan, seed)}
    out = _row(_run(plan.pipe_shape(probes=probes), _stack([elem]), device),
               0)
    if bool(out["overflow"]):
        if jsq_pad_factor > 64:
            raise RuntimeError("JSQ pad overflow even with huge padding")
        return simulate(tree, wl, scheme, seed=seed, prop_slots=prop_slots,
                        collect_stats=collect_stats, links=links,
                        backend=backend, jsq_pad_factor=jsq_pad_factor * 2,
                        probes=probes, fault=fault, device=device)
    return _postprocess(out, wl, probes)


def simulate_batch(tree: FatTree, wl: Workload, scheme: LBScheme,
                   seeds, prop_slots: float = 12.0,
                   collect_stats: bool = True,
                   links: Optional[LinkState] = None, backend: str = "auto",
                   jsq_pad_factor: float = 4.0, probes=None,
                   fault=None, device=None) -> list:
    """Run one simulation point for many seeds as one batched dispatch.

    Per-seed randomness is drawn host-side exactly as :func:`simulate` draws
    it and stacked onto the batch axis (seed-independent operands are
    repeated).  Results are bitwise-identical per seed to serial
    :func:`simulate`; JSQ pad overflows re-run with a larger pad only for the
    seeds that overflowed, matching the serial retry.
    """
    resolve_backend(backend)
    device = resolve_device(device)
    seeds = list(seeds)
    if not seeds:
        return []
    plan = _prepare(tree, wl, scheme, prop_slots, links, backend,
                    jsq_pad_factor, fault=fault)
    stacked = _stack([{**plan.static_args, **_draw_seed_inputs(plan, s)}
                      for s in seeds])
    out = _run(plan.pipe_shape(probes=probes), stacked, device)

    results: dict = {}
    retry = []
    for i, s in enumerate(seeds):
        if bool(out["overflow"][i]):
            retry.append(s)
        else:
            results[s] = _postprocess(_row(out, i), wl, probes)
    if retry:
        if jsq_pad_factor > 64:
            raise RuntimeError("JSQ pad overflow even with huge padding")
        redone = simulate_batch(tree, wl, scheme, retry,
                                prop_slots=prop_slots,
                                collect_stats=collect_stats, links=links,
                                backend=backend,
                                jsq_pad_factor=jsq_pad_factor * 2,
                                probes=probes, fault=fault, device=device)
        results.update(dict(zip(retry, redone)))
    return [results[s] for s in seeds]


# ---------------------------------------------------------------------------
# Megabatch: fuse (scheme x load x failure x seed) onto one batch axis.
# ---------------------------------------------------------------------------

# Per-packet pipeline arguments (padded to the bucketed packet count).
_PKT_KEYS = ("p1", "e1", "p2", "e2", "dst", "inter_pod", "leaves_edge",
             "ep_sw", "t_rel", "tie", "a_pre", "c_pre", "rand_a", "rand_c")


def _pipeline_identity(plan: SimPlan) -> Tuple:
    """Everything two plans must agree on to share one fused dispatch."""
    return (plan.scheme.shape_key(), plan.tables_e_keys, plan.tables_a_keys,
            float(plan.prop_slots), plan.backend)


def _repad_elem(d: dict, plan: SimPlan, tp: TreePad) -> dict:
    """Re-lay one point's switch-id-indexed operands into the padded tree's
    id space (:class:`~._batching.TreePad`).  Per-packet coordinate arrays
    are untouched: the scatter maps are monotone, so every sort-based
    arbitration sees the same relative order as the standalone run."""
    if tp.noop:
        return d
    pt = tp.padded
    d = dict(d)
    n_sw = pt.n_edge_switches            # == n_agg_switches

    def _sw(x):
        return tp.scatter(x, tp.switch, n_sw)

    for key, keys, ptr_idx, n_ptr in (
            ("te", plan.tables_e_keys, tp.edge_pair, n_sw * n_sw),
            ("ta", plan.tables_a_keys, tp.agg_pod, n_sw * pt.n_pods)):
        tbl = dict(zip(keys, d[key]))
        if "rr_starts" in tbl:
            tbl["rr_starts"] = _sw(tbl["rr_starts"])
        if "rr_perms" in tbl:
            tbl["rr_perms"] = _sw(_pad_tail(tbl["rr_perms"], 2, pt.half))
        if "orders" in tbl:      # OFAN pointer tables, (n_epochs, n_ptr, W)
            tbl["orders"] = tp.scatter(tbl["orders"], ptr_idx, n_ptr, axis=1)
            tbl["starts"] = tp.scatter(tbl["starts"], ptr_idx, n_ptr, axis=1)
            tbl["lens"] = tp.scatter(tbl["lens"], ptr_idx, n_ptr, axis=1)
        d[key] = tuple(tbl[k] for k in keys)
    if plan.jsq:
        for k in ("noise_e", "noise_a"):
            d[k] = _sw(_pad_tail(d[k], 2, pt.half))
    return d


def simulate_megabatch(items, *, prop_slots: float = 12.0,
                       backend: str = "auto", jsq_pad_factor: float = 4.0,
                       npk_pad: Optional[int] = None, n_shards=1,
                       k_pad: Optional[int] = None, probes=None,
                       device=None) -> list:
    """Run many simulation points as ONE fused dispatch.

    ``items`` is a sequence of ``(tree, wl, scheme, seeds, links)`` tuples,
    or 6-tuples with a trailing fault schedule (``links`` then None), whose
    points lower to the same pipeline (equal ``LBScheme.shape_key()``, same
    backend).  Fault epochs are per-packet gather indices bounded by each
    member's own epoch count, so the epoch axes of the scheme tables pad
    to the group maximum like their other axes.  Per-seed inputs are drawn
    host-side exactly as :func:`simulate` draws them, padded to shared
    shapes (packet arrays up to ``npk_pad``, JSQ noise grids and scheme
    tables up to group-wide maxima, switch-indexed tables scattered into the
    padded ``k_pad`` tree's id space; pad packets are inert bypass rows with
    ``dst = -1``), stacked onto one fused batch axis and run by one batched
    pipeline.  ``n_shards`` (or ``"auto"``: one chunk per visible CUDA
    device, at most one per element) cuts the fused axis into contiguous
    chunks, chunk ``i`` on CUDA device ``i``; results do not depend on it.

    Returns one list of :class:`FastSimResult` per item (aligned with its
    ``seeds``); every result is bitwise-identical to the standalone
    :func:`simulate` call with the same arguments, including the JSQ
    pad-overflow retry decision.
    """
    resolve_backend(backend)
    device = resolve_device(device)
    items = [(it[0], it[1], it[2], list(it[3]), it[4],
              it[5] if len(it) > 5 else None) for it in items]
    if not items or all(not it[3] for it in items):
        return [[] for _ in items]

    plans = [_prepare(tree, wl, scheme, prop_slots, links, backend,
                      jsq_pad_factor, fault=fz)
             for (tree, wl, scheme, _, links, fz) in items]
    idents = {_pipeline_identity(p) for p in plans}
    if len(idents) > 1:
        raise ValueError(f"megabatch items span {len(idents)} pipeline "
                         f"identities; group by LBScheme.shape_key() first")

    k_max = max(p.tree.k for p in plans)
    k_pad = k_max if k_pad is None else max(int(k_pad), k_max)
    tree_pad = next((p.tree for p in plans if p.tree.k == k_pad),
                    FatTree(k_pad))
    pads = [TreePad(p.tree, tree_pad) for p in plans]

    npk_max = max(p.wl.n_packets for p in plans)
    npk_pad = npk_max if npk_pad is None else max(int(npk_pad), npk_max)
    pad_e_m = max(p.pad_e for p in plans)
    pad_a_m = max(p.pad_a for p in plans)
    jsq = plans[0].jsq

    elems: list = []          # merged (static + per-seed) dicts, padded
    spans: list = []          # (item index, seed) per fused-axis element
    for i, ((tree, wl, scheme, seeds, links, fz), plan) in enumerate(
            zip(items, plans)):
        for s in seeds:
            d = _repad_elem({**plan.static_args,
                             **_draw_seed_inputs(plan, s)}, plan, pads[i])
            for k in _PKT_KEYS:
                d[k] = _pad_tail(d[k], 0, npk_pad,
                                 fill=-1 if k == "dst" else 0)
            if jsq:
                d["noise_e"] = _pad_tail(d["noise_e"], 1, pad_e_m)
                d["noise_a"] = _pad_tail(d["noise_a"], 1, pad_a_m)
            elems.append(d)
            spans.append((i, s))

    # Scheme tables are padded per position to the group-wide maximum
    # shape; padded entries are only ever indexed by inert packets.
    for key in ("te", "ta"):
        for j in range(len(elems[0][key])):
            padded = pad_to_group_max([d[key][j] for d in elems])
            for d, t in zip(elems, padded):
                d[key] = d[key][:j] + (t,) + d[key][j + 1:]

    n_batch = len(elems)
    if n_shards == "auto":
        n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
        n_shards = max(1, min(n_dev, n_batch))
    n_shards = int(n_shards)
    stacked = shard_pad(_stack(elems), n_batch, n_shards)

    cfg = plans[0].pipe_shape(pad_e=pad_e_m, pad_a=pad_a_m, tree=tree_pad,
                              probes=probes)
    out = _run(cfg, stacked, device, n_shards)

    results = [dict() for _ in items]
    retries: Dict[int, list] = {}
    for b, (i, s) in enumerate(spans):
        if bool(out["overflow"][b]):
            retries.setdefault(i, []).append(s)
            continue
        out_b = _row(out, b)
        npk_i = plans[i].wl.n_packets
        for k in ("delivery", "a_used", "c_used"):
            out_b[k] = out_b[k][:npk_i]
        out_b["occ"] = out_b["occ"][:, :npk_i]
        if not pads[i].noop:
            # Gather per-queue packet counts back onto the real tree's queue
            # ids (padded queues hold zero: no real packet lands there).
            out_b["counts"] = ([c[pads[i].mid] for c in out_b["counts"][:4]]
                               + [out_b["counts"][4][:plans[i].tree.n_hosts]])
        results[i][s] = _postprocess(out_b, plans[i].wl, probes)

    # JSQ pad overflow: re-run exactly the (item, seed) cells a standalone
    # run would re-pad, through the seed-batched path.
    for i, retry_seeds in retries.items():
        tree, wl, scheme, _, links, fz = items[i]
        redone = simulate_batch(tree, wl, scheme, retry_seeds,
                                prop_slots=prop_slots, links=links,
                                backend=backend,
                                jsq_pad_factor=jsq_pad_factor * 2,
                                probes=probes, fault=fz, device=device)
        results[i].update(dict(zip(retry_seeds, redone)))

    return [[results[i][s] for s in seeds]
            for i, (_, _, _, seeds, _, _) in enumerate(items)]
