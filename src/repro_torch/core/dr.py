"""Destination-based Rotation (DR) — the paper's optimal scheduling discipline.

DR generalizes DRB [Cao et al.]: traffic is load-balanced round-robin *per
destination group*, guaranteeing uniform load on both uplinks **and**
downlinks of a fat tree (the per-destination pointer is what SIMPLE RR lacks:
RR balances uplinks but lets a destination's traffic collide on the single
southbound path from core to destination).

This module holds the pointer machinery shared by HOST DR and OFAN:

  * a *pointer* is (start offset, traversal order) over a set of candidate
    ports/paths; packet ``r`` of the pointer's group uses
    ``order[(start + r) % len(order)]``;
  * pointers are initialized to a random start and a random traversal order to
    avoid cross-pointer synchronization (paper §7, Implementation);
  * under failures, the traversal order is rebuilt from W-ECMP weights as an
    Interleaved Weighted Round-Robin (IWRR) schedule (paper App. F.4).
"""
from __future__ import annotations

import numpy as np


def random_pointer_table(n_pointers: int, n_ports: int,
                         rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """(orders, starts): orders (n_pointers, n_ports) random permutations,
    starts (n_pointers,) random initial offsets."""
    orders = np.argsort(rng.random((n_pointers, n_ports)), axis=1).astype(np.int32)
    starts = rng.integers(0, n_ports, size=n_pointers).astype(np.int32)
    return orders, starts


def iwrr_schedule(weights: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Interleaved Weighted Round-Robin schedule from raw W-ECMP weights.

    Divides by the gcd, randomly shuffles the port order, then interleaves so
    a port with weight w appears w times, spread as evenly as possible
    (paper App. F.4 example: weights {2,2,2,1} -> schedule length 7 with the
    weight-1 port appearing half as often).

    Returns an int32 array of port indices (the schedule); all-zero weights
    yield an empty schedule (destination unreachable).
    """
    w = np.asarray(weights, dtype=np.int64)
    if (w < 0).any():
        raise ValueError("negative W-ECMP weight")
    if w.sum() == 0:
        return np.zeros((0,), dtype=np.int32)
    nz = w > 0
    g = np.gcd.reduce(w[nz])
    w = w // g
    ports = np.flatnonzero(nz)
    ports = ports[rng.permutation(len(ports))]
    wp = w[ports]
    # Interleave: round r emits every port whose weight exceeds the number of
    # times it has been emitted, in shuffled port order -- the classic IWRR
    # expansion (each of max(w) rounds emits ports with w > round).
    sched = []
    for r in range(int(wp.max())):
        for p, wi in zip(ports.tolist(), wp.tolist()):
            if wi > r:
                sched.append(p)
    return np.asarray(sched, dtype=np.int32)


def rotate(order: np.ndarray, start: int, ranks: np.ndarray) -> np.ndarray:
    """Apply a pointer: port for the rank-th packet of this pointer's group."""
    L = order.shape[0]
    return order[(start + ranks) % L]
