"""Compact digests of engine results, for comparing runs across machines
that cannot run each other's code (the card has no JAX).

:func:`result_digest` (fast engine) and :func:`loop_result_digest` (slotted
engine) keep the scalar metrics as numbers and replace each array by the
sha256 of its bytes; they read attributes only, so they digest the JAX
reference's results and the port's alike.
"""
from __future__ import annotations

import hashlib

import numpy as np


def _sha(x) -> str:
    return hashlib.sha256(np.ascontiguousarray(np.asarray(x)).tobytes()
                          ).hexdigest()


def result_digest(res) -> dict:
    """cct, max_queue, per-layer max_queue/avg_wait/counts digest, and the
    digests of the per-packet delivery, a_used and c_used arrays."""
    return {
        "cct": float(res.cct),
        "max_queue": float(res.max_queue),
        "layers": {name: {"max_queue": float(ls.max_queue),
                          "avg_wait": float(ls.avg_wait),
                          "counts_sha256": _sha(ls.counts)}
                   for name, ls in res.layers.items()},
        "delivery_sha256": _sha(res.delivery),
        "a_used_sha256": _sha(res.a_used),
        "c_used_sha256": _sha(res.c_used),
    }


def loop_result_digest(res) -> dict:
    """The scalar fields of a ``LoopSimResult`` as numbers, and the digests
    of its per-packet and per-flow slot arrays and of its probe series (when
    the point ran with probes)."""
    out = {
        "cct_slots": float(res.cct_slots),
        "cct_acked_slots": float(res.cct_acked_slots),
        "drops": int(res.drops),
        "retransmissions": int(res.retransmissions),
        "max_queue": int(res.max_queue),
        "avg_queue": float(res.avg_queue),
        "finished": bool(res.finished),
        "mean_cwnd": float(res.mean_cwnd),
        "delivered_slot_sha256": _sha(res.delivered_slot),
        "flow_complete_slot_sha256": _sha(res.flow_complete_slot),
        "flow_data_done_slot_sha256": _sha(res.flow_data_done_slot),
    }
    if res.probe is not None:
        out["probe_stride"] = int(res.probe.stride)
        out["probe_sha256"] = _sha(res.probe.series)
    return out
