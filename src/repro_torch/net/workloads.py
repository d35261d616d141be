"""Collective traffic workloads for the fabric simulator.

The paper evaluates two representative traffic matrices (§5):

  * a random **permutation** (each host sends to exactly one other host and
    receives from exactly one) -- the building block of ring AllGather /
    AllReduce and iterative AlltoAll;
  * **all-to-all** (every host sends to every other host) -- one-shot
    AllReduce / AllGather / AlltoAll.

plus the §8.4 **FSDP hierarchical-ring** scenario (Llama 7B/70B/405B on a
1,024-GPU cluster, 8 parallel rings, random server placement).

A workload compiles down to a flat per-packet description consumed by the
engines:

  ``src[i]``       source host of packet i
  ``dst[i]``       destination host
  ``flow[i]``      flow index (src,dst pair id)
  ``seq[i]``       sequence number of the packet inside its flow
  ``t_release[i]`` slot at which the source NIC finishes serializing packet i
                   (hosts pace at line rate == 1 data packet / slot and
                   round-robin across their active flows, matching the
                   paper's uniform, synchronized senders)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .topology import FatTree


@dataclasses.dataclass
class Workload:
    name: str
    n_hosts: int
    src: np.ndarray        # (P,) int64
    dst: np.ndarray        # (P,) int64
    flow: np.ndarray       # (P,) int64
    seq: np.ndarray        # (P,) int64
    t_release: np.ndarray  # (P,) float64  (slots)
    flow_src: np.ndarray   # (F,) int64
    flow_dst: np.ndarray   # (F,) int64
    flow_size: np.ndarray  # (F,) int64  packets per flow
    # Optional per-flow start slot (collective-phase schedules): the
    # slotted engine gates each flow's first send on it, the fast engine
    # sees the same offsets folded into ``t_release``.
    # ``None`` (every static workload) means all-zero and is
    # bitwise-equivalent to a zero array on both engines.
    flow_start: Optional[np.ndarray] = None   # (F,) int64  (slots)

    @property
    def n_packets(self) -> int:
        return int(self.src.shape[0])

    @property
    def n_flows(self) -> int:
        return int(self.flow_src.shape[0])

    def packets_per_host(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n_hosts)


def _packets_from_flows(name: str, n_hosts: int, flow_src: np.ndarray,
                        flow_dst: np.ndarray, flow_size: np.ndarray) -> Workload:
    """Expand per-flow sizes to per-packet records with host-paced release.

    Each host interleaves its flows round-robin (uniform collectives send the
    same amount on each flow at the same pace), emitting one packet per slot.
    """
    flow_src = np.asarray(flow_src, dtype=np.int64)
    flow_dst = np.asarray(flow_dst, dtype=np.int64)
    flow_size = np.asarray(flow_size, dtype=np.int64)
    n_flows = flow_src.shape[0]

    # Host-local flow index r (stable order) and flows-per-host F.
    order = np.argsort(flow_src, kind="stable")
    sorted_src = flow_src[order]
    # rank within host = position - first position of that host
    first = np.searchsorted(sorted_src, sorted_src, side="left")
    local_rank = np.arange(n_flows) - first
    flow_rank = np.empty(n_flows, dtype=np.int64)
    flow_rank[order] = local_rank
    flows_per_host = np.bincount(flow_src, minlength=n_hosts)

    if n_flows and (flow_size == flow_size[0]).all():
        # Uniform collectives (all the paper's workloads): packet j of the
        # host-local r-th flow goes out in slot j*F + r.  Fully vectorized.
        s = int(flow_size[0])
        flow_ids = np.repeat(np.arange(n_flows), s)
        seq = np.tile(np.arange(s), n_flows)
        F = flows_per_host[flow_src[flow_ids]]
        t_rel = (seq * F + flow_rank[flow_ids]).astype(np.float64)
        return Workload(
            name=name, n_hosts=n_hosts,
            src=flow_src[flow_ids], dst=flow_dst[flow_ids],
            flow=flow_ids, seq=seq, t_release=t_rel,
            flow_src=flow_src, flow_dst=flow_dst, flow_size=flow_size)

    # General (non-uniform sizes, possibly zero-size flows) fallback:
    # per-host python round-robin pacing, emitted FLOW-CONTIGUOUS -- the
    # slotted engine requires packets grouped by flow in flow-id order, so
    # the release times are computed in host-time order but written out
    # per flow.  Zero-size flows contribute no packets but keep their flow
    # row (searchsorted release binding and pkt_base edge-padding stay
    # well-formed downstream).
    rel_by_flow = [[] for _ in range(n_flows)]
    for h in range(n_hosts):
        fl = np.flatnonzero(flow_src == h)
        if len(fl) == 0:
            continue
        counters = np.zeros(len(fl), dtype=np.int64)
        sizes = flow_size[fl]
        t, r = 0, 0
        remaining = int(sizes.sum())
        while remaining > 0:
            fi = r % len(fl)
            r += 1
            if counters[fi] < sizes[fi]:
                rel_by_flow[int(fl[fi])].append(float(t))
                counters[fi] += 1
                remaining -= 1
                t += 1
    flow_l = np.repeat(np.arange(n_flows), flow_size)
    seq_l = (np.concatenate([np.arange(s) for s in flow_size.tolist()])
             if n_flows else np.empty(0, dtype=np.int64))
    rel_l = np.asarray([t for rs in rel_by_flow for t in rs],
                       dtype=np.float64)
    return Workload(
        name=name, n_hosts=n_hosts,
        src=flow_src[flow_l],
        dst=flow_dst[flow_l],
        flow=flow_l.astype(np.int64),
        seq=seq_l.astype(np.int64),
        t_release=rel_l,
        flow_src=flow_src, flow_dst=flow_dst, flow_size=flow_size,
    )


# --------------------------------------------------------------------------
# Traffic matrices
# --------------------------------------------------------------------------

def permutation(tree: FatTree, msg_packets: int, rng: np.random.Generator,
                inter_pod_only: bool = False) -> Workload:
    """Random permutation: host i -> perm(i), ``msg_packets`` packets each.

    ``inter_pod_only`` restricts to derangements where every (src, dst) pair
    crosses pods (used by the paper for Fig. 7 / App. F experiments).
    """
    n = tree.n_hosts
    if inter_pod_only:
        # Rejection sampling is infeasible (acceptance ~ (1-1/k)^n); build a
        # conflict-free perm by local swap repair of a random permutation.
        pod = tree.host_pod(np.arange(n))
        perm = rng.permutation(n)
        for _ in range(10_000):
            bad = np.flatnonzero(pod == pod[perm])
            if len(bad) == 0:
                break
            # Swap each conflicting position with a random other position;
            # strictly decreases expected conflicts.
            other = rng.integers(0, n, size=len(bad))
            for b, o in zip(bad.tolist(), other.tolist()):
                perm[b], perm[o] = perm[o], perm[b]
        else:  # pragma: no cover
            raise RuntimeError("could not build inter-pod permutation")
    else:
        while True:
            perm = rng.permutation(n)
            if (perm != np.arange(n)).all():
                break
    sizes = np.full(n, msg_packets, dtype=np.int64)
    return _packets_from_flows("permutation", n, np.arange(n), perm, sizes)


def all_to_all(tree: FatTree, msg_packets_per_dst: int,
               rng: Optional[np.random.Generator] = None) -> Workload:
    """All-to-all: every host sends ``msg_packets_per_dst`` to each other host."""
    n = tree.n_hosts
    srcs = np.repeat(np.arange(n), n - 1)
    dsts = np.concatenate([np.concatenate([np.arange(i), np.arange(i + 1, n)])
                           for i in range(n)])
    sizes = np.full(n * (n - 1), msg_packets_per_dst, dtype=np.int64)
    return _packets_from_flows("all_to_all", n, srcs, dsts, sizes)


def fsdp_rings(tree: FatTree, gpus_per_server: int, msg_packets: int,
               rng: np.random.Generator) -> Workload:
    """The paper's §8.4 FSDP scenario mapped onto this fat tree.

    ``n_hosts`` physical ports host ``n_hosts`` logical GPUs grouped into
    servers of ``gpus_per_server``; servers are placed at random on
    consecutive-port groups.  Inter-server traffic follows
    ``gpus_per_server`` parallel rings: logical GPU i sends to logical GPU
    (i + gpus_per_server) mod n -- i.e. each server sends ``gpus_per_server``
    parallel flows to the next server in the logical ring.
    """
    n = tree.n_hosts
    g = gpus_per_server
    if n % g:
        raise ValueError("host count must be divisible by gpus_per_server")
    n_servers = n // g
    # Random placement: logical server s occupies physical ports
    # place[s]*g .. place[s]*g+g-1.
    place = rng.permutation(n_servers)
    phys = (place[:, None] * g + np.arange(g)[None, :]).reshape(-1)  # logical gpu -> port
    logical_dst = (np.arange(n) + g) % n
    flow_src = phys
    flow_dst = phys[logical_dst]
    sizes = np.full(n, msg_packets, dtype=np.int64)
    return _packets_from_flows("fsdp_rings", n, flow_src, flow_dst, sizes)
