"""k-ary 3-level fat-tree topology for the load-balancing fabric simulator.

Structure (standard fat-tree, k even):
  * ``k`` pods; each pod has ``k/2`` edge switches and ``k/2`` aggregation
    switches; each edge switch hosts ``k/2`` endpoints -> ``n = k^3/4`` hosts.
  * ``(k/2)^2`` core switches arranged in ``k/2`` *groups* of ``k/2``:
    core group ``a`` connects to aggregation switch index ``a`` of every pod.
    This is the "mandatory waypoint" property the paper's OFAN exploits:
    traffic leaving aggregation switch ``a`` of the source pod can only enter
    the destination pod through aggregation switch ``a``.

Queueing model: every directed inter-switch (and switch->host) link carries a
FIFO queue served at one data packet per slot.  Five queueing layers matter:

  ``UP_E``  edge -> aggregation      indexed (pod, edge, agg)
  ``UP_A``  aggregation -> core      indexed (pod, agg, core_sub)
  ``DN_C``  core -> aggregation      indexed (dst_pod, agg, core_sub)
  ``DN_A``  aggregation -> edge      indexed (pod, agg, edge)
  ``DN_E``  edge -> host             indexed (pod, edge, slot)  == host id

Host->edge uplinks are paced at the source (one packet per slot under the
ideal fixed-rate CCA) and therefore never queue; they contribute only
serialization + propagation latency.

Everything here is plain numpy precomputation; the simulation engines convert
to torch tensors as needed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

# Layer symbolic ids (stage order along an inter-pod path).
UP_E, UP_A, DN_C, DN_A, DN_E = 0, 1, 2, 3, 4
N_LAYERS = 5
LAYER_NAMES = ("E->A", "A->C", "C->A", "A->E", "E->H")

# A stage whose queue id is BYPASS is skipped (departure == arrival): used for
# intra-pod / intra-edge traffic that traverses fewer than 5 queues.
BYPASS = -1


@dataclasses.dataclass(frozen=True)
class FatTree:
    """Static description of a k-ary fat tree (no failure state)."""

    k: int

    def __post_init__(self):
        if self.k % 2 != 0 or self.k < 4:
            raise ValueError(f"fat-tree parameter k must be even and >= 4, got {self.k}")

    # ---- counts -----------------------------------------------------------
    @property
    def half(self) -> int:
        return self.k // 2

    @property
    def n_pods(self) -> int:
        return self.k

    @property
    def edges_per_pod(self) -> int:
        return self.half

    @property
    def aggs_per_pod(self) -> int:
        return self.half

    @property
    def hosts_per_edge(self) -> int:
        return self.half

    @property
    def hosts_per_pod(self) -> int:
        return self.half * self.half

    @property
    def n_hosts(self) -> int:
        return self.k * self.hosts_per_pod  # k^3/4

    @property
    def n_edge_switches(self) -> int:
        return self.k * self.half

    @property
    def n_agg_switches(self) -> int:
        return self.k * self.half

    @property
    def n_cores(self) -> int:
        return self.half * self.half

    @property
    def queues_per_mid_layer(self) -> int:
        # UP_E, UP_A, DN_C, DN_A all have k * (k/2)^2 queues.
        return self.k * self.half * self.half

    @property
    def n_queues(self) -> int:
        return 4 * self.queues_per_mid_layer + self.n_hosts

    # ---- host coordinate helpers (vectorized over numpy arrays) ----------
    def host_pod(self, h):
        return h // self.hosts_per_pod

    def host_edge(self, h):
        return (h % self.hosts_per_pod) // self.half

    def host_slot(self, h):
        return h % self.half

    def host_global_edge(self, h):
        """Global edge-switch id in [0, k*k/2)."""
        return self.host_pod(h) * self.half + self.host_edge(h)

    def host_id(self, pod, edge, slot):
        return (pod * self.half + edge) * self.half + slot

    # ---- per-layer queue ids ----------------------------------------------
    def qid_up_e(self, pod, edge, agg):
        return (pod * self.half + edge) * self.half + agg

    def qid_up_a(self, pod, agg, sub):
        return (pod * self.half + agg) * self.half + sub

    def qid_dn_c(self, dst_pod, agg, sub):
        return (dst_pod * self.half + agg) * self.half + sub

    def qid_dn_a(self, pod, agg, edge):
        return (pod * self.half + agg) * self.half + edge

    def qid_dn_e(self, host):
        return host

    def layer_sizes(self) -> Tuple[int, ...]:
        q = self.queues_per_mid_layer
        return (q, q, q, q, self.n_hosts)

    # ---- path stage computation (vectorized) ------------------------------
    def stage_queues(self, src: np.ndarray, dst: np.ndarray,
                     agg_choice: np.ndarray, sub_choice: np.ndarray) -> np.ndarray:
        """Per-packet queue id at each of the 5 stage layers.

        ``agg_choice`` in [0, k/2): which aggregation switch the packet uses on
        its way up (and, by the fat-tree waypoint property, also down).
        ``sub_choice`` in [0, k/2): which core inside group ``agg_choice``.

        Returns int32 array of shape (len(src), 5); BYPASS where a stage is
        skipped (intra-pod / intra-edge traffic).
        """
        src = np.asarray(src)
        dst = np.asarray(dst)
        agg_choice = np.asarray(agg_choice)
        sub_choice = np.asarray(sub_choice)
        p1, e1 = self.host_pod(src), self.host_edge(src)
        p2, e2 = self.host_pod(dst), self.host_edge(dst)
        inter_pod = p1 != p2
        same_edge = (p1 == p2) & (e1 == e2)
        intra_pod = (~inter_pod) & (~same_edge)

        n = src.shape[0]
        out = np.full((n, N_LAYERS), BYPASS, dtype=np.int64)
        # UP_E used whenever the packet leaves its edge switch.
        leaves_edge = ~same_edge
        out[leaves_edge, UP_E] = self.qid_up_e(p1, e1, agg_choice)[leaves_edge]
        # UP_A / DN_C only for inter-pod traffic.
        out[inter_pod, UP_A] = self.qid_up_a(p1, agg_choice, sub_choice)[inter_pod]
        out[inter_pod, DN_C] = self.qid_dn_c(p2, agg_choice, sub_choice)[inter_pod]
        # DN_A for anything that reached an aggregation switch.
        out[leaves_edge, DN_A] = self.qid_dn_a(p2, agg_choice, e2)[leaves_edge]
        # DN_E always.
        out[:, DN_E] = dst
        # (intra_pod packets: UP_E, DN_A, DN_E; same_edge: DN_E only)
        del intra_pod
        return out

    def n_hops(self, src, dst) -> np.ndarray:
        """Number of store-and-forward switch hops (for latency accounting)."""
        p1, e1 = self.host_pod(src), self.host_edge(src)
        p2, e2 = self.host_pod(dst), self.host_edge(dst)
        same_edge = (p1 == p2) & (e1 == e2)
        same_pod = p1 == p2
        return np.where(same_edge, 1, np.where(same_pod, 3, 5))


# --------------------------------------------------------------------------
# Failures
# --------------------------------------------------------------------------

@dataclasses.dataclass
class LinkState:
    """Alive/dead state of the bidirectional fabric links.

    ``ea[p, e, a]``  edge<->agg link in pod p between edge e and agg a.
    ``ac[p, a, c]``  agg<->core link between agg a of pod p and core (a, c).

    Following the paper's failure model, only edge-aggregation and
    aggregation-core links fail (host links and switches stay up), and a
    failed link is dead in both directions.
    """

    tree: FatTree
    ea: np.ndarray  # bool (k, k/2, k/2)
    ac: np.ndarray  # bool (k, k/2, k/2)

    @classmethod
    def all_up(cls, tree: FatTree) -> "LinkState":
        h = tree.half
        return cls(tree,
                   np.ones((tree.k, h, h), dtype=bool),
                   np.ones((tree.k, h, h), dtype=bool))

    @classmethod
    def random_failures(cls, tree: FatTree, p_fail: float,
                        rng: Optional[np.random.Generator] = None,
                        *, seed: Optional[int] = None) -> "LinkState":
        """Random i.i.d. link failures with probability ``p_fail``.

        Counter-keyed path (pass ``seed``): each link's fate is the Threefry
        stream of :mod:`repro_torch.core.entropy` evaluated at (seed,
        SITE_LINK_FAIL, lane=tree.k, layer, flat link id) -- a pure function
        of the link's identity, stable across numpy versions and independent
        of draw order.  Legacy path (pass ``rng``): sequential ``Generator``
        draws, ``ea`` then ``ac``, kept so goldens recorded before the rekey
        stay reproducible.
        """
        h = tree.half
        if rng is not None:
            if seed is not None:
                raise ValueError("pass either rng (legacy) or seed, not both")
            ea = rng.random((tree.k, h, h)) >= p_fail
            ac = rng.random((tree.k, h, h)) >= p_fail
            return cls(tree, ea, ac)
        if seed is None:
            raise ValueError("random_failures needs rng (legacy) or seed=")
        from ..core import entropy as ent
        lo, hi = ent.key_words(seed)
        ids = np.arange(tree.k * h * h, dtype=np.uint32)
        u_ea = ent.draw_uniform(lo, hi, ent.SITE_LINK_FAIL, ids, slot=0,
                                lane=tree.k)
        u_ac = ent.draw_uniform(lo, hi, ent.SITE_LINK_FAIL, ids, slot=1,
                                lane=tree.k)
        return cls(tree,
                   (u_ea >= p_fail).reshape(tree.k, h, h),
                   (u_ac >= p_fail).reshape(tree.k, h, h))

    # ---- reachability / path validity -------------------------------------
    def inter_pod_path_alive(self, p1, e1, p2, e2, a, c):
        """Vectorized: is the (a, c) path from (p1,e1) to (p2,e2) fully alive?"""
        return (self.ea[p1, e1, a] & self.ac[p1, a, c]
                & self.ac[p2, a, c] & self.ea[p2, e2, a])

    def intra_pod_path_alive(self, p, e1, e2, a):
        return self.ea[p, e1, a] & self.ea[p, e2, a]

    def path_matrix(self, src: int, dst: int) -> np.ndarray:
        """Boolean (k/2, k/2) of valid (agg, sub) choices for src->dst.

        For intra-pod traffic the core sub-choice is irrelevant: the matrix is
        constant along axis 1.  For same-edge traffic everything is valid
        (the path does not traverse any failing link).
        """
        t = self.tree
        h = t.half
        p1, e1 = int(t.host_pod(src)), int(t.host_edge(src))
        p2, e2 = int(t.host_pod(dst)), int(t.host_edge(dst))
        a = np.arange(h)[:, None]
        c = np.arange(h)[None, :]
        if p1 != p2:
            return self.inter_pod_path_alive(p1, e1, p2, e2, a, c)
        if e1 != e2:
            return np.broadcast_to(self.intra_pod_path_alive(p1, e1, e2, a), (h, h)).copy()
        return np.ones((h, h), dtype=bool)

    def any_failure(self) -> bool:
        return not (self.ea.all() and self.ac.all())

    # ---- W-ECMP weights -----------------------------------------------------
    def wecmp_edge_weights(self, src_pod: int, src_edge: int,
                           dst_pod: int, dst_edge: int) -> np.ndarray:
        """Raw W-ECMP weight per uplink ``a`` of the source edge switch toward
        a destination edge switch: the number of distinct alive paths through
        aggregation switch ``a`` (paper App. F.4 / [51])."""
        h = self.tree.half
        w = np.zeros(h, dtype=np.int64)
        for a in range(h):
            if not self.ea[src_pod, src_edge, a]:
                continue
            if src_pod == dst_pod:
                w[a] = int(self.ea[dst_pod, dst_edge, a])
            else:
                cores = self.ac[src_pod, a, :] & self.ac[dst_pod, a, :]
                w[a] = int(cores.sum()) if self.ea[dst_pod, dst_edge, a] else 0
        return w

    def wecmp_agg_weights(self, src_pod: int, agg: int, dst_pod: int) -> np.ndarray:
        """Raw W-ECMP weight per core sub-link ``c`` of aggregation switch
        ``agg`` toward a destination pod (1 path per alive core pair)."""
        if src_pod == dst_pod:
            raise ValueError("agg weights are for inter-pod traffic only")
        return (self.ac[src_pod, agg, :] & self.ac[dst_pod, agg, :]).astype(np.int64)


# --------------------------------------------------------------------------
# rho_max  (Appendix A): maximum uniform sending rate when every flow splits
# equally across all of its valid shortest paths.
# --------------------------------------------------------------------------

def rho_max(tree: FatTree, links: LinkState,
            src: np.ndarray, dst: np.ndarray) -> float:
    """Per-flow rate (fraction of line rate) such that the most-loaded link
    carries exactly line rate, under equal splitting across valid paths.

    Returns 1.0 when no link carries more than one flow unit (e.g. the
    failure-free permutation case).  Returns 0.0 if some flow is fully
    disconnected (no valid path).
    """
    h = tree.half
    load = {
        UP_E: np.zeros((tree.k, h, h)),
        UP_A: np.zeros((tree.k, h, h)),
        DN_C: np.zeros((tree.k, h, h)),
        DN_A: np.zeros((tree.k, h, h)),
        DN_E: np.zeros(tree.n_hosts),
    }
    src = np.asarray(src)
    dst = np.asarray(dst)
    for s, d in zip(src.tolist(), dst.tolist()):
        p1, e1 = int(tree.host_pod(s)), int(tree.host_edge(s))
        p2, e2 = int(tree.host_pod(d)), int(tree.host_edge(d))
        load[DN_E][d] += 1.0
        if p1 == p2 and e1 == e2:
            continue
        pm = links.path_matrix(s, d)
        if p1 == p2:
            valid = pm[:, 0]
            tot = valid.sum()
            if tot == 0:
                return 0.0
            share = valid / tot
            load[UP_E][p1, e1, :] += share
            load[DN_A][p2, :, e2] += share
        else:
            tot = pm.sum()
            if tot == 0:
                return 0.0
            share = pm / tot
            load[UP_E][p1, e1, :] += share.sum(axis=1)
            load[UP_A][p1, :, :] += share
            load[DN_C][p2, :, :] += share
            load[DN_A][p2, :, e2] += share.sum(axis=1)
    worst = max(float(v.max()) for v in load.values())
    if worst <= 1.0:
        return 1.0
    return 1.0 / worst
