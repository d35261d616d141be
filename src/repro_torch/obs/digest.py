"""Compact digests of fast-engine results, for comparing runs across
machines that cannot run each other's code (the card has no JAX).

:func:`result_digest` keeps the scalar metrics as floats and replaces each
array by the sha256 of its bytes; it reads attributes only, so it digests
the JAX reference's ``FastSimResult`` and the port's alike.
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
