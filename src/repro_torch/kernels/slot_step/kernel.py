"""ctypes bindings of the CUDA slot-step kernels (``csrc/slot_step.cu``).

The CUDA source replaces the Pallas TPU kernels ``jsq_pick``, ``enqueue``,
``agg_jsq_enqueue``, ``sack_update_scan`` and ``sack_advance`` of
``repro/kernels/slot_step/kernel.py``; its header
states the design and the bounds.  Each function here launches its kernel on
contiguous CUDA tensors on the current stream, returns new output tensors
(the inputs are never written) and raises if the launch fails.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .. import _build
from .._common import check_cuda
from .ref import thresholds

_VP = ctypes.c_void_p
_I = ctypes.c_int
_U32 = ctypes.c_uint32
SACK_TILE = 2048            # bitmap bytes a sack_update_scan CTA copies
SACK_WARPS = 8              # its warps, one a flow
SACK_MAX_CTAS = 64          # its CTAs a row, at most
SACK_SMEM = 48 * 1024       # shared bytes its delivered set may take
_EDGES: Dict[Tuple, Tuple[ctypes.Array, torch.Tensor, int]] = {}
# The kernels' hash tables, one scratch per (kernel, device, stream): a
# kernel clears what it uses, and launches on one stream run in order.
_TABLES: Dict[Tuple[str, int, int], torch.Tensor] = {}


def _lib() -> ctypes.CDLL:
    lib = _build.load("slot_step")
    if not getattr(lib, "_typed", False):
        lib.slot_jsq_pick.argtypes = ([_VP] * 7 + [_U32, _I, _VP, _VP]
                                      + [_I] * 6 + [_VP, _VP])
        lib.slot_enqueue.argtypes = ([_VP] * 7 + [_I] * 5 + [_VP, _I]
                                     + [_VP] * 7)
        lib.slot_agg_jsq_enqueue.argtypes = (
            [_VP] * 12 + [_U32, _I, _VP, _VP] + [_I] * 9 + [_VP, _I]
            + [_VP] * 8)
        lib.slot_sack_update_scan.argtypes = ([_VP] * 6 + [_I] * 4
                                              + [ctypes.c_longlong, _I, _I, _I]
                                              + [_VP] * 4)
        lib.slot_sack_advance.argtypes = [_VP] * 4 + [_I] * 3 + [_VP] * 2
        for f in (lib.slot_jsq_pick, lib.slot_enqueue,
                  lib.slot_agg_jsq_enqueue, lib.slot_sack_update_scan,
                  lib.slot_sack_advance):
            f.restype = ctypes.c_int
        lib._typed = True
    return lib


def _edges(quanta, cap: int, device) -> Tuple[int, torch.Tensor, int, int]:
    """The float32 bin edges as the pick kernels take them: the address of
    a host copy (the first ones go into the kernel's arguments), a device
    copy (the rest are read from it), their count and whether the score is
    quantized at all (``quanta`` not None, even with no edges).  Cached per
    quanta/cap/device."""
    key = (quanta, int(cap), str(device))
    hit = _EDGES.get(key)
    if hit is None:
        vals = [] if quanta is None else thresholds(quanta, cap).tolist()
        host = (ctypes.c_float * max(len(vals), 1))(*vals)
        dev = torch.tensor(vals or [0.0], dtype=torch.float32, device=device)
        hit = _EDGES[key] = (host, dev, len(vals))
    host, dev, n = hit
    return ctypes.addressof(host), dev, n, int(quanta is not None)


def _slot(t: int) -> int:
    """The slot as the uint32 counter word of Threefry (a negative or wider
    slot wraps, as ``core.entropy._u32_torch`` wraps it)."""
    return int(t) & 0xFFFFFFFF


def _u8(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.uint8) if x.dtype == torch.bool else x


def _seed32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern of uint32 key words (held as int32 bit patterns
    already, or as values in a wider integer tensor)."""
    if x.dtype == torch.int32:
        return x
    x = x.to(torch.int64)
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _check_int32(name, *ts):
    for t in ts:
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: int32 operands expected, got {t.dtype}")


def jsq_pick(qcnt, qbase, ids, dead, pad_pen, seed_lo, seed_hi, t: int, *,
             site: int, quanta: Optional[tuple], cap: int) -> torch.Tensor:
    """Launch ``slot_jsq_pick``; shapes and meaning as ``ref.jsq_pick``."""
    B, M = qbase.shape
    h = pad_pen.shape[-1]
    if h < 1:
        raise ValueError(f"jsq_pick kernel: {h} ports, at least 1")
    if dead.shape != (B, M, h) or qcnt.shape[0] != B or ids.shape != (B, M):
        raise ValueError("jsq_pick kernel: mismatched operand shapes")
    _check_int32("jsq_pick", qcnt, qbase, ids)
    dead = _u8(dead)
    lo, hi = _seed32(seed_lo), _seed32(seed_hi)
    host, edges, n_edges, quantized = _edges(quanta, cap, qcnt.device)
    check_cuda("jsq_pick", qcnt, qbase, ids, dead, pad_pen, lo, hi, edges)
    out = torch.empty((B, M), dtype=torch.int32, device=qcnt.device)
    with torch.cuda.device(qcnt.device):
        err = _lib().slot_jsq_pick(
            qcnt.data_ptr(), qbase.data_ptr(), ids.data_ptr(),
            dead.data_ptr(), pad_pen.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            _slot(t), int(site), host, edges.data_ptr(), n_edges, quantized,
            B, M, qcnt.shape[1], h, out.data_ptr(), _stream(qcnt.device))
    _check("slot_jsq_pick", err)
    return out


def _enqueue_outs(qbuf, B, M):
    dev = qbuf.device
    return (torch.empty_like(qbuf),
            torch.empty(qbuf.shape[:2], dtype=torch.int32, device=dev),
            torch.empty((B, M), dtype=torch.bool, device=dev),
            torch.empty((B, M), dtype=torch.bool, device=dev),
            torch.empty((B, M), dtype=torch.int32, device=dev),
            torch.empty((B, M), dtype=torch.bool, device=dev))


def _out_ptrs(outs):
    return [(_u8(o)).data_ptr() for o in outs]


def enqueue(qbuf, qhead, qcnt, alive_row, apk, aq, avalid, *, cap: int,
            ecn_thresh: int):
    """Launch ``slot_enqueue``; shapes and meaning as ``ref.enqueue``."""
    B, NQ, C = qbuf.shape
    M = aq.shape[1]
    if C != cap or qcnt.shape != (B, NQ) or apk.shape != (B, M):
        raise ValueError("enqueue kernel: mismatched operand shapes")
    _check_int32("enqueue", qbuf, qhead, qcnt, apk, aq)
    alive_row, avalid = _u8(alive_row), _u8(avalid)
    check_cuda("enqueue", qbuf, qhead, qcnt, alive_row, apk, aq, avalid)
    outs = _enqueue_outs(qbuf, B, M)
    table, hsize = _table(qbuf.device, B, M)
    with torch.cuda.device(qbuf.device):
        err = _lib().slot_enqueue(
            qbuf.data_ptr(), qhead.data_ptr(), qcnt.data_ptr(),
            alive_row.data_ptr(), apk.data_ptr(), aq.data_ptr(),
            avalid.data_ptr(), int(cap), int(ecn_thresh), B, M, NQ,
            table.data_ptr(), hsize, *_out_ptrs(outs), _stream(qbuf.device))
    _check("slot_enqueue", err)
    return outs


def _scratch(name: str, dev, n: int) -> torch.Tensor:
    """``n`` int32 of the kernel's scratch, one per (kernel, device,
    stream), grown as needed."""
    key = (name, dev.index, _stream(dev))
    table = _TABLES.get(key)
    if table is None or table.numel() < n:
        table = torch.empty(max(n, 1), dtype=torch.int32, device=dev)
        _TABLES[key] = table
    return table


def _table(dev, B: int, M: int) -> Tuple[torch.Tensor, int]:
    """The enqueue kernels' rank counters of keys outside ``[0, NQ)``: an
    open-addressing table of ``hsize`` keys and counts a row for the first
    and the last queue tile, cleared by the kernel where used."""
    hsize = 1 << max(6, (2 * M - 1).bit_length())
    return _scratch("enqueue", dev, B * 4 * hsize), hsize


def agg_jsq_enqueue(qbuf, qhead, qcnt, alive_row, apk, aq, to_agg, asw,
                    dead, pad_pen, seed_lo, seed_hi, t: int, *, site: int,
                    quanta, cap: int, ecn_thresh: int, off1: int, h: int):
    """Launch ``slot_agg_jsq_enqueue``; shapes and meaning as
    ``ref.agg_jsq_enqueue``."""
    B, NQ, C = qbuf.shape
    M = aq.shape[1]
    if h < 1 or pad_pen.shape != (B, h):
        raise ValueError(f"agg_jsq_enqueue kernel: {h} ports, at least 1, "
                         f"and a (B, h) pad penalty")
    if (C != cap or qcnt.shape != (B, NQ) or dead.shape != (B, M, h)
            or asw.shape != (B, M)):
        raise ValueError("agg_jsq_enqueue kernel: mismatched operand shapes")
    _check_int32("agg_jsq_enqueue", qbuf, qhead, qcnt, apk, aq, asw)
    alive_row, to_agg, dead = _u8(alive_row), _u8(to_agg), _u8(dead)
    lo, hi = _seed32(seed_lo), _seed32(seed_hi)
    host, edges, n_edges, quantized = _edges(quanta, cap, qbuf.device)
    check_cuda("agg_jsq_enqueue", qbuf, qhead, qcnt, alive_row, apk, aq,
               to_agg, asw, dead, pad_pen, lo, hi, edges)
    outs = _enqueue_outs(qbuf, B, M)
    c_fin = torch.empty((B, M), dtype=torch.int32, device=qbuf.device)
    table, hsize = _table(qbuf.device, B, M)
    with torch.cuda.device(qbuf.device):
        err = _lib().slot_agg_jsq_enqueue(
            qbuf.data_ptr(), qhead.data_ptr(), qcnt.data_ptr(),
            alive_row.data_ptr(), apk.data_ptr(), aq.data_ptr(),
            to_agg.data_ptr(), asw.data_ptr(), dead.data_ptr(),
            pad_pen.data_ptr(), lo.data_ptr(), hi.data_ptr(), _slot(t),
            int(site), host, edges.data_ptr(), n_edges, quantized, int(cap),
            int(ecn_thresh), int(off1), int(h), B, M, NQ, table.data_ptr(),
            hsize,
            outs[0].data_ptr(),
            outs[1].data_ptr(), c_fin.data_ptr(), *_out_ptrs(outs[2:]),
            _stream(qbuf.device))
    _check("slot_agg_jsq_enqueue", err)
    return outs[:2] + (c_fin,) + outs[2:]


def _sack_shapes(name, p_recv, f_cum, fsize, pbase):
    B, P = p_recv.shape
    if f_cum.shape != fsize.shape or f_cum.shape != pbase.shape \
            or f_cum.shape[0] != B or p_recv.dtype != torch.bool:
        raise ValueError(f"{name} kernel: a (B, P) bool bitmap and (B, F) "
                         f"flow operands expected")
    _check_int32(name, f_cum, fsize, pbase)
    return B, P, f_cum.shape[1]


def sack_layout(P: int, M: int, F: int) -> Tuple[int, int, int, bool]:
    """``(tile, ctas, hsize, shared)``: ``sack_update_scan``'s grid over rows
    of ``P`` packets, ``M`` lanes and ``F`` flows (``csrc/slot_step.cu``'s
    header).  ``ctas`` CTAs a row: one per ``tile`` bytes of the row
    (``SACK_TILE``, more where a row would take over ``SACK_MAX_CTAS``), and
    more where the row's flows need them (a warp a flow, ``SACK_WARPS`` a
    CTA, up to ``SACK_MAX_CTAS``); those past the row's end copy nothing.
    The delivered set is a bitset of the row (``hsize`` 0) or a table of
    ``hsize`` keys, whichever has fewer ints, in shared memory where it fits
    ``SACK_SMEM`` (``shared``), else the table in a global scratch."""
    per_cta = -(-P // SACK_MAX_CTAS)
    tile = max(SACK_TILE, (per_cta + 15) // 16 * 16)
    ctas = max(-(-P // tile), min(-(-F // SACK_WARPS), SACK_MAX_CTAS))
    words = -(-P // 32)
    hsize = 1 << max(5, (2 * M - 1).bit_length())
    fits = lambda n: 4 * n <= SACK_SMEM               # noqa: E731
    if fits(words) and (words <= hsize or not fits(hsize)):
        hsize = 0
    return tile, ctas, hsize, hsize == 0 or fits(hsize)


def sack_update_scan(p_recv, pk, deliv, f_cum, fsize, pbase):
    """Launch ``slot_sack_update_scan``; shapes and meaning as
    ``ref.sack_update_scan`` (window 64)."""
    B, P, F = _sack_shapes("sack_update_scan", p_recv, f_cum, fsize, pbase)
    M = pk.shape[1]
    if pk.shape != (B, M) or deliv.shape != (B, M) \
            or deliv.dtype != torch.bool:
        raise ValueError("sack_update_scan kernel: (B, M) int32 lanes and a "
                         "bool delivery mask expected")
    _check_int32("sack_update_scan", pk)
    check_cuda("sack_update_scan", p_recv, pk, deliv, f_cum, fsize, pbase)
    out = torch.empty_like(p_recv)
    fm = torch.empty((B, F), dtype=torch.int32, device=p_recv.device)
    tile, ctas, hsize, shared = sack_layout(P, M, F)
    scratch = 0 if shared else _scratch("sack_update_scan", p_recv.device,
                                        B * ctas * hsize).data_ptr()
    with torch.cuda.device(p_recv.device):
        err = _lib().slot_sack_update_scan(
            _u8(p_recv).data_ptr(), pk.data_ptr(), _u8(deliv).data_ptr(),
            f_cum.data_ptr(), fsize.data_ptr(), pbase.data_ptr(), B, P, M, F,
            tile, ctas, hsize, int(shared), scratch, _u8(out).data_ptr(),
            fm.data_ptr(), _stream(p_recv.device))
    _check("slot_sack_update_scan", err)
    return out, fm


def sack_advance(p_recv, f_cum, fsize, pbase):
    """Launch ``slot_sack_advance``; shapes and meaning as
    ``ref.sack_advance`` (2 rounds, window 4)."""
    B, P, F = _sack_shapes("sack_advance", p_recv, f_cum, fsize, pbase)
    check_cuda("sack_advance", p_recv, f_cum, fsize, pbase)
    out = torch.empty_like(f_cum)
    with torch.cuda.device(p_recv.device):
        err = _lib().slot_sack_advance(
            _u8(p_recv).data_ptr(), f_cum.data_ptr(), fsize.data_ptr(),
            pbase.data_ptr(), B, P, F, out.data_ptr(), _stream(p_recv.device))
    _check("slot_sack_advance", err)
    return out
