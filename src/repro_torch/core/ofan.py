"""OFAN — the paper's switch-based realization of Destination-based Rotation.

OFAN exploits the fat-tree's *mandatory waypoints* to consolidate DR pointers:

  * an **edge** switch keeps one pointer per (destination edge switch,
    packet-size class) rotating over its k/2 uplink ports;
  * an **aggregation** switch keeps one pointer per (destination pod,
    packet-size class) rotating over its k/2 core-facing ports.

At startup every pointer gets a random initial port and a random traversal
order (to avoid cross-pointer synchronization).  Under failures, the traversal
orders become IWRR schedules over W-ECMP weights (App. F.4); with no failures
the schedule degenerates to the shuffled permutation.

This module builds the static pointer tables consumed by both engines.  The
data-plane semantics (`rank within the pointer's group -> port`) live in the
engines; here we only build (order, start) tables.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..net.topology import FatTree, LinkState
from . import dr as dr_mod


@dataclasses.dataclass
class OfanTables:
    """Pointer tables.  Edge layer: pointer id = src_global_edge * n_edges +
    dst_global_edge.  Agg layer: pointer id = global_agg * n_pods + dst_pod.

    ``edge_orders``: (n_edge_ptrs, sched_len) int32 port schedule per pointer.
    ``edge_starts``: (n_edge_ptrs,) random initial offsets.
    ``edge_len``:    (n_edge_ptrs,) schedule length actually used (IWRR
                     schedules under failure may differ in length; rows are
                     padded with repeats of the schedule to a common width).
    Similarly for agg_*.
    """
    edge_orders: np.ndarray
    edge_starts: np.ndarray
    edge_len: np.ndarray
    agg_orders: np.ndarray
    agg_starts: np.ndarray
    agg_len: np.ndarray


def build_tables(tree: FatTree, rng: np.random.Generator,
                 links: Optional[LinkState] = None,
                 use_wecmp: bool = True) -> OfanTables:
    """Build OFAN pointer tables; with ``links`` given and failures present,
    schedules follow IWRR over W-ECMP weights (or plain FIB reachability when
    ``use_wecmp=False`` — the simpler variant of App. F.4)."""
    h = tree.half
    n_edges = tree.n_edge_switches
    n_pods = tree.n_pods
    n_aggs = tree.n_agg_switches

    failure_free = links is None or not links.any_failure()

    # ---- edge pointers: (src edge, dst edge) -------------------------------
    n_eptr = n_edges * n_edges
    if failure_free:
        e_orders, e_starts = dr_mod.random_pointer_table(n_eptr, h, rng)
        e_len = np.full(n_eptr, h, dtype=np.int32)
        a_orders, a_starts = dr_mod.random_pointer_table(n_aggs * n_pods, h, rng)
        a_len = np.full(n_aggs * n_pods, h, dtype=np.int32)
        return OfanTables(e_orders, e_starts, e_len, a_orders, a_starts, a_len)

    # Failure case: IWRR schedules; pad rows to a common width by tiling.
    def _pad(rows):
        width = max((len(r) for r in rows if len(r)), default=h)
        out = np.zeros((len(rows), width), dtype=np.int32)
        lens = np.zeros(len(rows), dtype=np.int32)
        for i, r in enumerate(rows):
            if len(r) == 0:          # unreachable: keep port 0, flagged len 0
                lens[i] = 0
                continue
            reps = int(np.ceil(width / len(r)))
            out[i] = np.tile(r, reps)[:width]
            lens[i] = len(r)
        return out, lens

    e_rows = []
    for se in range(n_edges):
        sp, sei = divmod(se, h)
        for de in range(n_edges):
            dp, dei = divmod(de, h)
            if se == de:
                e_rows.append(np.arange(h, dtype=np.int32))  # unused
                continue
            if use_wecmp:
                w = links.wecmp_edge_weights(sp, sei, dp, dei)
            else:
                w = (links.ea[sp, sei, :]).astype(np.int64)
                if dp != sp:
                    # FIB-only: reachable if some path exists through a
                    w = w * (links.ea[dp, dei, :] & (
                        (links.ac[sp, :, :] & links.ac[dp, :, :]).any(axis=1))
                    ).astype(np.int64)
                else:
                    w = w * links.ea[dp, dei, :].astype(np.int64)
            e_rows.append(dr_mod.iwrr_schedule(w, rng))
    e_orders, e_len = _pad(e_rows)
    e_starts = rng.integers(0, np.maximum(e_len, 1)).astype(np.int32)

    a_rows = []
    for ga in range(n_aggs):
        sp, ai = divmod(ga, h)
        for dp in range(n_pods):
            if dp == sp:
                a_rows.append(np.arange(h, dtype=np.int32))  # unused (southbound)
                continue
            if use_wecmp:
                w = links.wecmp_agg_weights(sp, ai, dp)
            else:
                w = (links.ac[sp, ai, :] & links.ac[dp, ai, :]).astype(np.int64)
            a_rows.append(dr_mod.iwrr_schedule(w, rng))
    a_orders, a_len = _pad(a_rows)
    a_starts = rng.integers(0, np.maximum(a_len, 1)).astype(np.int32)
    return OfanTables(e_orders, e_starts, e_len, a_orders, a_starts, a_len)


def pointer_counts(tree: FatTree) -> dict:
    """Pointer state a switch must hold (paper §7: 'very reasonable'):
    edge: one per destination edge switch x size class; agg: one per
    destination pod x size class.  Returned per size class."""
    return {
        "edge_pointers": tree.n_edge_switches - 1,
        "agg_pointers": tree.n_pods - 1,
        "host_dr_pointers_per_host": tree.n_hosts - 1,
    }
