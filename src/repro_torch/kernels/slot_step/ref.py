"""Plain PyTorch versions of the slotted engine's slot-step kernels.

Each function mirrors the JAX reference's ``repro/kernels/slot_step/ref.py``
operation for operation, over a leading row axis ``(B, ...)``: one row per
point of a fused megabatch.  ``seed_lo``/``seed_hi`` are ``(B,)`` integer
tensors holding the uint32 key words (as values, or as int32 bit
patterns); ``t`` is the slot (a python int: every
row that still runs shares it).

Rounding follows XLA on the CPU, which the reference runs on: the JSQ score
``lens + nz * 1e-3`` is contracted into one fused multiply-add there (the
engine's compiled fusion holds a ``vfmadd``, and the jitted ``jsq_score``
equals an exact FMA on 2**20 elements), so it is rounded once here
(``fma32``).  Every other add is rounded on its own.  ``*_drop`` scatters
give the target a sink slot that is cut off, as XLA's ``mode="drop"``
drops out-of-range rows.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...core import entropy as ent
from ...net._batching import rank_by
from ..jsq_scan.ref import fma32

JSQ_NOISE_SCALE = 1e-3
QUANT_NOISE_SCALE = 0.5
DEAD_PENALTY = 1e9


def thresholds(quanta: Tuple[float, ...], cap: int) -> np.ndarray:
    """float32 bin edges ``float32(quanta) * float32(cap)``: the rounding of
    the reference's ``jnp.asarray(quanta, float32) * cap``."""
    return np.asarray(quanta, np.float32) * np.float32(cap)


def jsq_score(qcnt, qbase, ids, dead, pad_pen, seed_lo, seed_hi, t: int, *,
              site: int, quanta: Optional[Tuple[float, ...]], cap: int):
    """The ``(B, M, h)`` float32 JSQ score grid.

    ``qcnt`` (B, NQ) int32 queue occupancy; ``qbase`` (B, M) int32 first-port
    queue id per chooser; ``ids`` (B, M) int32 entropy ids (host ids at the
    edge, packet ids at the agg); ``dead`` (B, M, h) bool failed-port mask
    (already gated on convergence); ``pad_pen`` (B, h) float32
    ``port_pad_penalty``.  Port ``l`` of chooser ``i`` reads
    ``qcnt[gather_index(qbase[i] + l, NQ)]``, the reference's gather rule.
    """
    B, M = qbase.shape
    h = pad_pen.shape[-1]
    lane = torch.arange(h, dtype=torch.int32, device=qcnt.device)
    cols = gather_index(qbase[..., None] + lane, qcnt.shape[1])
    lens = torch.gather(qcnt, 1, cols.reshape(B, M * h)).reshape(B, M, h)
    nz = ent.draw_uniform_torch(seed_lo.reshape(B, 1, 1),
                                seed_hi.reshape(B, 1, 1), site,
                                ids[..., None], t, lane=lane)
    if quanta is None:
        score = fma32(nz, JSQ_NOISE_SCALE, lens.to(torch.float32))
    else:
        thr = torch.from_numpy(thresholds(quanta, cap)).to(qcnt.device)
        bins = (lens[..., None] > thr).sum(-1, dtype=torch.int32)
        score = bins.to(torch.float32) + nz * QUANT_NOISE_SCALE
    score = score + pad_pen[:, None, :]
    return score + torch.where(dead, DEAD_PENALTY, 0.0)


def jsq_pick(qcnt, qbase, ids, dead, pad_pen, seed_lo, seed_hi, t: int, *,
             site: int, quanta, cap: int) -> torch.Tensor:
    """First-occurrence argmin port per chooser: (B, M) int32."""
    score = jsq_score(qcnt, qbase, ids, dead, pad_pen, seed_lo, seed_hi, t,
                      site=site, quanta=quanta, cap=cap)
    return torch.argmin(score, dim=-1).to(torch.int32)


def enqueue(qbuf, qhead, qcnt, alive_row, apk, aq, avalid, *, cap: int,
            ecn_thresh: int):
    """Same-slot arrival enqueue: failure black-holing, same-queue arrival
    ranking (by lane order), capacity drop, ring-buffer scatter, occupancy
    add and ECN marking.

    ``qbuf`` (B, NQ, cap) int32; ``qhead``/``qcnt`` (B, NQ) int32;
    ``alive_row`` (B, NQ) bool; ``apk``/``aq`` (B, M) int32; ``avalid``
    (B, M) bool.  Returns new ``(qbuf', qcnt', enq_try, do_enq, occ_after,
    marked)``; the inputs are not written.

    A lane reads the queue ``clip(aq, 0, NQ - 1)`` (occupancy, head, alive)
    and ranks among the earlier lanes of the same raw ``aq``.  Its ring
    write and occupancy add go where the reference's scatters put them: a
    negative ``aq`` wraps once (``aq + NQ``, JAX's index rule), a target
    still outside ``[0, NQ)`` is dropped, and where two lanes write one cell
    (``q`` and ``q - NQ``) the later lane wins (XLA's sequential scatter).
    The engine's arrivals always target ``[0, NQ)``.
    """
    B, NQ = qcnt.shape
    aqc = torch.clamp(aq, 0, NQ - 1).long()
    dead = ~torch.gather(alive_row, 1, aqc)
    enq_try = avalid & ~dead
    rkq = rank_by(aq, enq_try, backend="torch")
    qa = torch.gather(qcnt, 1, aqc)
    room = qa + rkq < cap
    do_enq = enq_try & room
    pos = torch.remainder(torch.gather(qhead, 1, aqc) + qa + rkq, cap)
    tgt = torch.where(aq < 0, aq + NQ, aq)
    hit = do_enq & (tgt >= 0) & (tgt < NQ)
    cell = torch.where(hit, tgt.long() * cap + pos.long(), NQ * cap)
    lanes = torch.arange(aq.shape[1], device=aq.device).expand(cell.shape)
    last = torch.full((B, NQ * cap + 1), -1, dtype=torch.int64,
                      device=aq.device)
    last.scatter_reduce_(1, cell, lanes, "amax")
    cell = torch.where(torch.gather(last, 1, cell) == lanes, cell, NQ * cap)
    flat = torch.cat([qbuf.reshape(B, NQ * cap),
                      torch.zeros((B, 1), dtype=qbuf.dtype,
                                  device=qbuf.device)], dim=1)
    flat.scatter_(1, cell, torch.where(do_enq, apk, -1))
    qbuf2 = flat[:, :NQ * cap].reshape(B, NQ, cap)
    occ_after = qa + rkq + 1
    marked = do_enq & (occ_after > ecn_thresh)
    cnt = torch.cat([qcnt, torch.zeros((B, 1), dtype=qcnt.dtype,
                                       device=qcnt.device)], dim=1)
    cnt.scatter_add_(1, torch.where(hit, tgt.long(), NQ),
                     hit.to(qcnt.dtype))
    return qbuf2, cnt[:, :NQ], enq_try, do_enq, occ_after, marked


def agg_jsq_enqueue(qbuf, qhead, qcnt, alive_row, apk, aq, to_agg, asw,
                    dead, pad_pen, seed_lo, seed_hi, t: int, *, site: int,
                    quanta, cap: int, ecn_thresh: int, off1: int, h: int):
    """Agg-layer JSQ pick (ids = packet ids) for every arriving lane, the
    target queue of agg-bound lanes rewritten to the picked port, then
    :func:`enqueue` with ``avalid = apk >= 0``.  Returns ``(qbuf', qcnt',
    c_fin, enq_try, do_enq, occ_after, marked)``."""
    qb = off1 + asw * h
    c_fin = jsq_pick(qcnt, qb, torch.clamp_min(apk, 0), dead, pad_pen,
                     seed_lo, seed_hi, t, site=site, quanta=quanta, cap=cap)
    aq2 = torch.where(to_agg, qb + c_fin, aq)
    out = enqueue(qbuf, qhead, qcnt, alive_row, apk, aq2, apk >= 0, cap=cap,
                  ecn_thresh=ecn_thresh)
    return out[:2] + (c_fin,) + out[2:]


def sack_update_scan(p_recv, pk, deliv, f_cum, fsize, pbase, *,
                     window: int = 64):
    """Receiver-bitmap update and per-flow first missing sequence (the SACK
    retransmit candidate), over rows.

    ``p_recv`` (B, P) bool; ``pk``/``deliv`` (B, M) int32 / bool: this
    slot's popped packets and delivery mask; ``f_cum``/``fsize``/``pbase``
    (B, F) int32.  A delivering lane sets ``p_recv[pk]``, a ``pk`` in
    ``[-P, -1]`` wrapping once to ``pk + P`` and any other ``pk`` outside
    ``[0, P)`` dropped, as the reference's scatter does.  Returns new
    ``(p_recv', first_missing (B, F) int32)``: the bitmap with every
    delivered packet set, and per flow the candidate
    ``min(f_cum + w, fsize - 1)`` at the first ``w < window`` whose packet
    is not received (``w = 0`` when all are, ``argmin``'s first-occurrence
    rule), in int32 arithmetic that wraps, as the reference's.  Every flow
    reads its window, whatever its size: a flow of size 0 gives ``-1`` only
    where ``f_cum >= -1`` (every candidate is then ``fsize - 1``); below
    that its candidates ``f_cum + w`` read the bitmap at ``pbase + cand``
    by :func:`gather_index`'s rule.
    """
    B, P = p_recv.shape
    tgt = torch.where(pk < 0, pk + P, pk)
    ok = deliv & (tgt >= 0) & (tgt < P)
    bm = torch.cat([p_recv, torch.zeros((B, 1), dtype=p_recv.dtype,
                                        device=p_recv.device)], dim=1)
    bm.scatter_(1, torch.where(ok, tgt, P).long(),
                torch.ones(pk.shape, dtype=p_recv.dtype,
                           device=p_recv.device))
    p_recv2 = bm[:, :P]
    offs = torch.arange(window, dtype=torch.int32, device=p_recv.device)
    cand = torch.minimum(f_cum[..., None] + offs, fsize[..., None] - 1)
    got = _window_bits(p_recv2, pbase, cand)
    first = torch.argmin(got.to(torch.uint8), dim=2, keepdim=True)
    return p_recv2, torch.gather(cand, 2, first)[..., 0]


def sack_advance(p_recv, f_cum, fsize, pbase, *, rounds: int = 2,
                 window: int = 4):
    """Cumulative-ack advance: ``rounds`` passes, each moving ``f_cum`` past
    up to ``window`` contiguously received sequences (the sum of a running
    product of the window's received bits, masked to ``f_cum + w <
    fsize``), capped at ``fsize``.  Operands as :func:`sack_update_scan`;
    returns the new ``f_cum`` (B, F) int32."""
    offs = torch.arange(window, dtype=torch.int32, device=p_recv.device)
    for _ in range(rounds):
        ahead = f_cum[..., None] + offs
        cand = torch.minimum(ahead, fsize[..., None] - 1)
        got = _window_bits(p_recv, pbase, cand) & (ahead < fsize[..., None])
        adv = torch.cumprod(got.to(torch.int32), dim=2).sum(
            2, dtype=torch.int32)
        f_cum = torch.minimum(f_cum + adv, fsize)
    return f_cum


def gather_index(idx, n: int):
    """The row index a gather reads for int32 ``idx`` in a row of ``n``, by
    the reference's (JAX's) rule: a negative index wraps once, then the index
    clamps to ``[0, n - 1]``.  Returns int64 indices."""
    idx = idx.long()
    return torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1)


def _window_bits(bitmap, pbase, cand):
    """``bitmap[b, pbase[b, f] + cand[b, f, w]]`` by :func:`gather_index`'s
    rule."""
    B, P = bitmap.shape
    idx = gather_index(pbase[..., None] + cand, P)
    return torch.gather(bitmap, 1, idx.reshape(B, -1)).reshape(idx.shape)
