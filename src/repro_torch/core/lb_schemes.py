"""Load-balancing scheme descriptors — the paper's leading contenders (§3.2),
the simplified theory models (§6.1), and the DR disciplines (§6–7).

A scheme tells the engines how the two free path choices of a 3-level
fat-tree are made:

  * ``edge_mode``: how the source edge switch uplink (aggregation index
    ``a`` in [0, k/2)) is picked;
  * ``agg_mode``: how the aggregation uplink (core sub-index ``c``) is picked.

Modes:
  ``pre``        choice precomputed at the host (per flow / subflow / packet /
                 DR pointer) — host-based schemes;
  ``rr``         switch round-robin over the uplink group, one pointer per
                 switch (the theory's SIMPLE RR);
  ``rr_reset``   htsim-style round-robin whose traversal order is re-permuted
                 every ``reset_wraps`` wraparounds (SWITCH PKT);
  ``rand``       uniform random at the switch (the theory's RSQ);
  ``jsq``        join-shortest-queue with random tie-break (theory JSQ);
  ``jsq_quant``  JSQ over quantized queue bins (SWITCH PKT AR / Spectrum-X);
  ``ofan``       OFAN consolidated DR pointers: per destination edge switch at
                 the edge layer, per destination pod at the aggregation layer.

Host-based adaptive schemes (REPS, PLB) need ACK/ECN feedback and therefore
only run on the slotted feedback engine (``net.loopsim``); their descriptors
carry the relevant thresholds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..net.topology import FatTree
from . import dr as dr_mod


@dataclasses.dataclass(frozen=True)
class LBScheme:
    name: str
    edge_mode: str
    agg_mode: str
    # pre-mode host label granularity: 'flow' | 'subflow' | 'packet' | 'dr'
    host_granularity: Optional[str] = None
    n_subflows: int = 0
    reset_wraps: int = 5                     # SWITCH PKT order re-permute period
    quanta: Tuple[float, ...] = (0.05, 0.10, 0.20)   # SWITCH PKT AR bins
    buffer_pkts: int = 195                   # 800 KB / ~4.1 KB frames
    # loopsim-only host adaptation:
    ecn_frac: float = 0.0          # REPS: discard labels whose ACK was marked
    plb_alpha: int = 0             # PLB: may change label every alpha packets
    plb_beta: float = 0.0          # PLB: ...if > beta of recent acks ECN-marked
    adaptive_host: bool = False    # needs ACK feedback (loopsim only)

    @property
    def needs_feedback(self) -> bool:
        return self.adaptive_host

    def reaction_class(self) -> str:
        """How fast this scheme observes path-state changes under a dynamic
        fault schedule: ``'host'`` for schemes whose path
        choices live at the host (host-labelled ``pre`` schemes and
        ACK-adaptive REPS/PLB see failures end-to-end -- black-holed labels
        stop returning ACKs), ``'switch'`` for switch-local state (RR, JSQ,
        OFAN wait on local port status / W-ECMP convergence).  Selects
        between a schedule's ``host_react`` and ``switch_react`` delays."""
        if self.adaptive_host or self.edge_mode == "pre":
            return "host"
        return "switch"

    def table_keys(self) -> Tuple[str, ...]:
        """Names of the per-seed switch-table operands this scheme's
        fast-engine pipeline consumes, in pipeline argument order.  These are
        the vmappable pytree leaves a megabatch stacks onto the fused batch
        axis (rotation state for RR/SWITCH PKT, consolidated DR pointers for
        OFAN); host-labelled and JSQ schemes carry their per-layer state in
        the per-packet/noise operands instead and need no tables."""
        if self.edge_mode == "rr_reset":
            return ("rr_perms", "rr_starts")
        if self.edge_mode == "rr":
            return ("rr_starts",)
        if self.edge_mode == "ofan":
            return ("lens", "orders", "starts")
        return ()

    def shape_key(self) -> Tuple:
        """Hashable key of everything that determines the *compiled* fast-engine
        pipeline (mirrors ``fastsim._build_run``'s cache key, minus the
        topology/padding part).  Two schemes with equal shape keys -- e.g.
        flow_ecmp and host_pkt, which differ only in host-side label
        granularity -- share one compiled executable; the sweep planner orders
        campaign grid points by this key to maximize compile-cache reuse."""
        quanta = (tuple(self.quanta) if self.edge_mode == "jsq_quant"
                  else None)
        return (self.edge_mode, self.agg_mode, quanta, self.buffer_pkts,
                self.reset_wraps)

    def loop_kfusable(self) -> bool:
        """Whether the slotted engine can pad this scheme's points onto a
        larger fat tree while staying bitwise-identical (the planner's
        cross-tree-size fusion).  Always True: pointer and host-label
        schemes draw host-side or from shape-independent pools, and
        rand/JSQ switch modes draw in-loop from the counter streams of
        ``core.entropy`` -- pure functions of (seed, draw site, logical
        host/packet id, slot) that padding cannot perturb.  Retained (as a
        constant) for API stability; no planner branch keys on it anymore.
        """
        return True

    def loop_shape_key(self) -> Tuple:
        """Hashable key of everything that determines the compiled *loop*
        engine (``net.loopsim``): the port-choice branches and the host
        adaptation machinery.  Schemes with equal loop shape keys -- e.g.
        flow_ecmp, host_pkt and host_dr, which all lower to the 'pre/pre'
        slotted pipeline -- fuse into one megabatched loop dispatch (the
        LoopConfig static fields are the other half of that fused key)."""
        quanta = (tuple(self.quanta) if self.edge_mode == "jsq_quant"
                  else None)
        return (self.edge_mode, self.agg_mode, quanta, self.adaptive_host,
                self.name == "host_flowlet_ar")


# ---------------------------------------------------------------------------
# Factories — Table 2 of the paper.
# ---------------------------------------------------------------------------

def ecmp() -> LBScheme:
    return LBScheme("flow_ecmp", "pre", "pre", host_granularity="flow")


def subflow(n: int = 4) -> LBScheme:
    return LBScheme("subflow_mptcp", "pre", "pre",
                    host_granularity="subflow", n_subflows=n)


def plb(alpha: int = 64, beta: float = 0.4, ecn_thresh_frac: float = 0.5) -> LBScheme:
    """HOST FLOWLET AR, modeled after PLB: change label at most every alpha
    packets when > beta of recent ACKs carried ECN marks (paper fn. 2).
    ``ecn_thresh_frac`` is the marking threshold as a fraction of buffer."""
    return LBScheme("host_flowlet_ar", "pre", "pre", host_granularity="flow",
                    plb_alpha=alpha, plb_beta=beta, ecn_frac=ecn_thresh_frac,
                    adaptive_host=True)


def host_pkt() -> LBScheme:
    """Host per-packet spraying (OPS): fresh random label every packet."""
    return LBScheme("host_pkt", "pre", "pre", host_granularity="packet")


def switch_pkt(reset_wraps: int = 5) -> LBScheme:
    """Switch per-packet round-robin, order permuted every 5 wraparounds."""
    return LBScheme("switch_pkt", "rr_reset", "rr_reset", reset_wraps=reset_wraps)


def host_pkt_ar(ecn_frac: float = 0.10) -> LBScheme:
    """Adaptive host per-packet (REPS): recycle labels whose ACKs came back
    unmarked; discard marked ones.  Feedback => loopsim only; on the fast
    engine it degenerates to host_pkt (documented approximation)."""
    return LBScheme("host_pkt_ar", "pre", "pre", host_granularity="packet",
                    ecn_frac=ecn_frac, adaptive_host=True)


def switch_pkt_ar(quanta: Tuple[float, ...] = (0.05, 0.10, 0.20),
                  buffer_pkts: int = 195) -> LBScheme:
    """Adaptive switch per-packet (Spectrum-X style): quantized shortest-queue
    with random choice inside the smallest bin."""
    return LBScheme("switch_pkt_ar", "jsq_quant", "jsq_quant",
                    quanta=quanta, buffer_pkts=buffer_pkts)


# ---- simplified theory models (§6.1) --------------------------------------

def simple_rr() -> LBScheme:
    return LBScheme("simple_rr", "rr", "rr")


def jsq() -> LBScheme:
    return LBScheme("jsq", "jsq", "jsq")


def rsq() -> LBScheme:
    return LBScheme("rsq", "rand", "rand")


# ---- DR disciplines ---------------------------------------------------------

def host_dr() -> LBScheme:
    """HOST DR (DRB): per (src host, dst host) pointer rotating over the
    lowest common layer (cores for inter-pod, aggs for intra-pod)."""
    return LBScheme("host_dr", "pre", "pre", host_granularity="dr")


def ofan() -> LBScheme:
    return LBScheme("ofan", "ofan", "ofan")


ALL_CONTENDERS = ("flow_ecmp", "subflow_mptcp", "host_flowlet_ar", "host_pkt",
                  "switch_pkt", "host_pkt_ar", "switch_pkt_ar")
PACKET_SCHEMES = ("host_pkt", "switch_pkt", "host_pkt_ar", "switch_pkt_ar",
                  "simple_rr", "jsq", "rsq", "host_dr", "ofan")


def by_name(name: str, **kw) -> LBScheme:
    table = {
        "flow_ecmp": ecmp, "subflow_mptcp": subflow, "host_flowlet_ar": plb,
        "host_pkt": host_pkt, "switch_pkt": switch_pkt,
        "host_pkt_ar": host_pkt_ar, "switch_pkt_ar": switch_pkt_ar,
        "simple_rr": simple_rr, "jsq": jsq, "rsq": rsq,
        "host_dr": host_dr, "ofan": ofan,
    }
    return table[name](**kw)


# ---------------------------------------------------------------------------
# Host-side label precomputation for 'pre' schemes.
# ---------------------------------------------------------------------------

def precompute_host_choices(scheme: LBScheme, tree: FatTree,
                            flow: np.ndarray, seq: np.ndarray,
                            flow_src: np.ndarray, flow_dst: np.ndarray,
                            rng: np.random.Generator,
                            path_valid: Optional[np.ndarray] = None,
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-packet (agg_choice, sub_choice) for host-based schemes.

    ``path_valid``: optional (n_flows, k/2, k/2) bool of alive (a, c) paths
    (HOST DR restricts its rotation to reachable common-layer switches; hash
    schemes re-hash among valid labels — modeling converged W-ECMP state).
    """
    h = tree.half
    n_pkts = flow.shape[0]
    n_flows = flow_src.shape[0]
    gran = scheme.host_granularity

    if gran in ("flow", "subflow"):
        n_sub = max(1, scheme.n_subflows if gran == "subflow" else 1)
        # One random (a, c) label per (flow, subflow), drawn among valid paths.
        a_lab = np.empty((n_flows, n_sub), dtype=np.int32)
        c_lab = np.empty((n_flows, n_sub), dtype=np.int32)
        for f in range(n_flows):
            if path_valid is not None:
                cand = np.argwhere(path_valid[f])
                if len(cand) == 0:
                    cand = np.argwhere(np.ones((h, h), dtype=bool))
                pick = cand[rng.integers(0, len(cand), size=n_sub)]
            else:
                pick = np.stack([rng.integers(0, h, size=n_sub),
                                 rng.integers(0, h, size=n_sub)], axis=1)
            a_lab[f], c_lab[f] = pick[:, 0], pick[:, 1]
        sub_id = (seq % n_sub).astype(np.int64)
        return a_lab[flow, sub_id], c_lab[flow, sub_id]

    if gran == "packet":
        if path_valid is None:
            return (rng.integers(0, h, size=n_pkts).astype(np.int32),
                    rng.integers(0, h, size=n_pkts).astype(np.int32))
        # Random among valid paths of the packet's flow.
        a_out = np.empty(n_pkts, dtype=np.int32)
        c_out = np.empty(n_pkts, dtype=np.int32)
        for f in range(n_flows):
            idx = np.flatnonzero(flow == f)
            cand = np.argwhere(path_valid[f])
            if len(cand) == 0:
                cand = np.argwhere(np.ones((h, h), dtype=bool))
            pick = cand[rng.integers(0, len(cand), size=len(idx))]
            a_out[idx], c_out[idx] = pick[:, 0], pick[:, 1]
        return a_out, c_out

    if gran == "dr":
        # HOST DR: per-flow pointer over the lowest-common-layer switches.
        p1 = tree.host_pod(flow_src)
        p2 = tree.host_pod(flow_dst)
        a_out = np.empty(n_pkts, dtype=np.int32)
        c_out = np.zeros(n_pkts, dtype=np.int32)
        for f in range(n_flows):
            idx = np.flatnonzero(flow == f)
            if len(idx) == 0:
                continue
            s = seq[idx]
            if p1[f] != p2[f]:
                # rotate over cores == (a, c) pairs (k^2/4 of them)
                if path_valid is not None:
                    cand = np.argwhere(path_valid[f])
                    if len(cand) == 0:
                        cand = np.argwhere(np.ones((h, h), dtype=bool))
                else:
                    cand = np.argwhere(np.ones((h, h), dtype=bool))
                order = cand[rng.permutation(len(cand))]
                start = rng.integers(0, len(order))
                sel = order[(start + s) % len(order)]
                a_out[idx], c_out[idx] = sel[:, 0], sel[:, 1]
            else:
                if path_valid is not None:
                    cand = np.flatnonzero(path_valid[f][:, 0])
                    if len(cand) == 0:
                        cand = np.arange(h)
                else:
                    cand = np.arange(h)
                order = cand[rng.permutation(len(cand))]
                start = rng.integers(0, len(order))
                a_out[idx] = order[(start + s) % len(order)]
                c_out[idx] = rng.integers(0, h, size=len(idx))
        return a_out, c_out

    raise ValueError(f"scheme {scheme.name} has no host precompute "
                     f"(granularity={gran})")
