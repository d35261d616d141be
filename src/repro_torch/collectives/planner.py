"""Collective schedule planner: chooses between XLA one-shot collectives and
DR rotation schedules using the paper's queue laws as the congestion model.

For a collective of ``m`` bytes per destination over a fabric whose
load-balancing discipline has queue law q(m), the expected completion is

    T(m) ~ serialization(m) + queue_delay(q(m)) + propagation

The paper's result: with hash-based fabric LB (the default on multi-tenant
DCNs), q grows like sqrt(m) (or m under synchronization), while a rotation
schedule keeps every round a permutation => q = O(1) (ND/D/1).  The planner
therefore prefers rotation for large cross-pod transfers and XLA's fused
collectives intra-pod (ICI is deterministically routed; rotation only adds
dispatch overhead there).

A copy of the JAX reference's planner: the plan names (``'xla'`` for the
one-shot collective) and the cost model are kept as they are, so a phase
schedule lowers to the same traffic in both packages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from ..core import theory


@dataclasses.dataclass(frozen=True)
class FabricModel:
    link_bw_Bps: float = 50e9          # per ICI/DCN link
    rtt_s: float = 25e-6
    packet_B: int = 4178
    lb_scheme: str = "host_pkt"        # fabric's LB for one-shot collectives
    fat_tree_k: int = 16

    def queue_pkts(self, m_pkts: float) -> float:
        if self.lb_scheme in ("ofan", "host_dr"):
            return theory.q_nd_d_1(self.fat_tree_k ** 2 / 4, 1.0)
        if self.lb_scheme in ("simple_rr", "jsq", "flow_ecmp"):
            return theory.q_linear(m_pkts, 0.5)
        return float(theory.q_sqrt(m_pkts, self.fat_tree_k))


@dataclasses.dataclass
class Plan:
    impl: str           # 'xla' | 'rotation' | 'ring' | 'rs_ag' | 'none'
    est_time_s: float
    reason: str


def _empty_plan(what: str) -> Plan:
    """Degenerate collective: a single participant or non-positive bytes
    moves no traffic, so return an explicit empty plan instead of letting
    the queue laws divide by zero / go negative."""
    return Plan("none", 0.0, f"degenerate collective ({what}): no traffic")


def plan_all_to_all(bytes_per_pair: float, n: int,
                    fabric: FabricModel = FabricModel(),
                    intra_pod: bool = True) -> Plan:
    """Choose the AllToAll schedule across an axis of size n."""
    if n <= 1:
        return _empty_plan(f"n={n}")
    if bytes_per_pair <= 0:
        return _empty_plan(f"bytes_per_pair={bytes_per_pair:g}")
    m_pkts = bytes_per_pair / fabric.packet_B
    ser = bytes_per_pair * (n - 1) / fabric.link_bw_Bps
    if intra_pod:
        return Plan("xla", ser + fabric.rtt_s,
                    "ICI is deterministically routed; one-shot a2a")
    # One-shot over the DCN: the fabric queue q(m) inflates delay, and the
    # delay-targeting CCA throttles throughput to keep queues near its
    # target (the paper's Fig. 13 mechanism: spraying schemes get reined in,
    # DR does not).  util = target / (target + queue_delay).
    q = fabric.queue_pkts(m_pkts * (n - 1))
    q_delay = q * fabric.packet_B * 8 / fabric.link_bw_Bps
    target = fabric.rtt_s            # Swift-style: ~BDP-scale target delay
    util = target / (target + q_delay)
    t_oneshot = ser / max(util, 1e-3) + fabric.rtt_s + q_delay
    # rotation: n-1 rounds, each a clean permutation (O(1) queues, no
    # throttling), but each round pays an RTT-scale dispatch latency
    q_rot = theory.q_nd_d_1(fabric.fat_tree_k ** 2 / 4, 1.0)
    t_rot = (ser + (n - 1) * fabric.rtt_s
             + (n - 1) * q_rot * fabric.packet_B * 8 / fabric.link_bw_Bps)
    if t_rot < t_oneshot:
        return Plan("rotation", t_rot,
                    f"DR rotation wins: queue {q:.0f} pkts one-shot vs "
                    f"O(1) per round")
    return Plan("xla", t_oneshot, "message too small: per-round RTT dominates")


def plan_all_reduce(bytes_total: float, n: int,
                    fabric: FabricModel = FabricModel(),
                    intra_pod: bool = True) -> Plan:
    if n <= 1:
        return _empty_plan(f"n={n}")
    if bytes_total <= 0:
        return _empty_plan(f"bytes_total={bytes_total:g}")
    ser = 2 * bytes_total * (n - 1) / n / fabric.link_bw_Bps
    if intra_pod:
        return Plan("xla", ser + fabric.rtt_s, "ICI: fused all-reduce")
    m_pkts = bytes_total / fabric.packet_B
    q = fabric.queue_pkts(m_pkts)
    q_delay = q * fabric.packet_B * 8 / fabric.link_bw_Bps
    util = fabric.rtt_s / (fabric.rtt_s + q_delay)
    t_oneshot = ser / max(util, 1e-3) + fabric.rtt_s + q_delay
    t_rsag = ser + 2 * (n - 1) * fabric.rtt_s
    if t_rsag < t_oneshot:
        return Plan("rs_ag", t_rsag,
                    "ring RS+AG (two rotation phases) beats one-shot under "
                    f"fabric queue ~{q:.0f} pkts")
    return Plan("xla", t_oneshot, "small reduction: RTTs dominate")
