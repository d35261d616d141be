"""Public wrappers of the slot-step kernels.

Each dispatches on the device of its first tensor operand: a CPU tensor
takes the plain version (``ref.py``), a CUDA tensor launches the CUDA kernel
(``kernel.py``).  ``backend="torch"`` takes the plain version on any device.
``LAUNCHES`` counts, per kernel, the launches made through these wrappers.
"""
from __future__ import annotations

import torch

from . import kernel as _kernel
from . import ref as _ref
from .._common import resolve_backend

LAUNCHES = {"jsq_pick": 0, "enqueue": 0, "agg_jsq_enqueue": 0,
            "sack_update_scan": 0, "sack_advance": 0}


def _plain(backend: str, x: torch.Tensor, name: str) -> bool:
    if resolve_backend(backend) == "torch" or x.device.type == "cpu":
        return True
    if not x.is_cuda:
        raise ValueError(f"{name}: unsupported device {x.device}")
    return False


def _c(*ts):
    return [t.contiguous() for t in ts]


def jsq_pick(qcnt, qbase, ids, dead, pad_pen, seed_lo, seed_hi, t, *,
             site, quanta, cap, backend="auto"):
    """See ``ref.jsq_pick``: (B, M) int32 ports."""
    if _plain(backend, qcnt, "jsq_pick"):
        return _ref.jsq_pick(qcnt, qbase, ids, dead, pad_pen, seed_lo,
                             seed_hi, t, site=site, quanta=quanta, cap=cap)
    if qbase.numel() == 0:
        return torch.zeros(qbase.shape, dtype=torch.int32, device=qcnt.device)
    out = _kernel.jsq_pick(*_c(qcnt, qbase, ids, dead, pad_pen, seed_lo,
                               seed_hi), t, site=site, quanta=quanta, cap=cap)
    LAUNCHES["jsq_pick"] += 1
    return out


def enqueue(qbuf, qhead, qcnt, alive_row, apk, aq, avalid, *, cap,
            ecn_thresh, backend="auto"):
    """See ``ref.enqueue``: ``(qbuf', qcnt', enq_try, do_enq, occ_after,
    marked)``."""
    if _plain(backend, qbuf, "enqueue"):
        return _ref.enqueue(qbuf, qhead, qcnt, alive_row, apk, aq, avalid,
                            cap=cap, ecn_thresh=ecn_thresh)
    out = _kernel.enqueue(*_c(qbuf, qhead, qcnt, alive_row, apk, aq, avalid),
                          cap=cap, ecn_thresh=ecn_thresh)
    LAUNCHES["enqueue"] += 1
    return out


def agg_jsq_enqueue(qbuf, qhead, qcnt, alive_row, apk, aq, to_agg, asw,
                    dead, pad_pen, seed_lo, seed_hi, t, *, site, quanta, cap,
                    ecn_thresh, off1, h, backend="auto"):
    """See ``ref.agg_jsq_enqueue``: ``(qbuf', qcnt', c_fin, enq_try,
    do_enq, occ_after, marked)``."""
    args = (qbuf, qhead, qcnt, alive_row, apk, aq, to_agg, asw, dead,
            pad_pen, seed_lo, seed_hi)
    kw = dict(site=site, quanta=quanta, cap=cap, ecn_thresh=ecn_thresh,
              off1=off1, h=h)
    if _plain(backend, qbuf, "agg_jsq_enqueue"):
        return _ref.agg_jsq_enqueue(*args, t, **kw)
    out = _kernel.agg_jsq_enqueue(*_c(*args), t, **kw)
    LAUNCHES["agg_jsq_enqueue"] += 1
    return out


def sack_update_scan(p_recv, pk, deliv, f_cum, fsize, pbase, *,
                     backend="auto"):
    """See ``ref.sack_update_scan``: ``(p_recv', first_missing)``."""
    if _plain(backend, p_recv, "sack_update_scan"):
        return _ref.sack_update_scan(p_recv, pk, deliv, f_cum, fsize, pbase)
    out = _kernel.sack_update_scan(*_c(p_recv, pk, deliv, f_cum, fsize,
                                       pbase))
    LAUNCHES["sack_update_scan"] += 1
    return out


def sack_advance(p_recv, f_cum, fsize, pbase, *, backend="auto"):
    """See ``ref.sack_advance``: the advanced ``f_cum``."""
    if _plain(backend, p_recv, "sack_advance"):
        return _ref.sack_advance(p_recv, f_cum, fsize, pbase)
    if f_cum.numel() == 0:
        return f_cum.clone()
    out = _kernel.sack_advance(*_c(p_recv, f_cum, fsize, pbase))
    LAUNCHES["sack_advance"] += 1
    return out
