"""Tests of the PyTorch port that need a CUDA card: each kernel against its
plain version, both engines on the card against the engines on the CPU, and
the dense, Mamba2 and Zamba2-hybrid serving paths on the card against the
CPU.

They skip without a card.  The machine with the card has no JAX, and
``tests/conftest.py`` imports it, so run them there with

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

This file imports neither ``jax`` nor the JAX reference package.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.lindley import ops as lindley_ops, ref as lindley_ref
from repro_torch.kernels.jsq_scan import ops as jsq_ops
from repro_torch.kernels.slot_step import ops as slot_ops
from repro_torch.kernels.slot_step import kernel as slot_kernel
from repro_torch.kernels.flash_attn import ops as attn_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops, ref as ssd_ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.configs import get_config
from repro_torch.models.registry import Model
from repro_torch.serve import batching, serve_step
from repro_torch.faults import FaultSchedule
from repro_torch.net import fastsim, loopsim, workloads
from repro_torch.net._batching import port_pad_penalty
from repro_torch.net.topology import FatTree
from repro_torch.core import lb_schemes as lbs

from _torch_compare import (AGG_OOB_KW, AGG_PICK_OOB_KW, ENQUEUE_CASES,
                            PICK_CASES, PICK_FAULT_KW, agg_case_operands,
                            agg_oob_operands, agg_pick_case_operands,
                            agg_pick_oob_operands,
                            assert_same_loop_result, assert_same_result,
                            cuda_or_skip, enqueue_operands, jsq_walk_grid,
                            pick_case_operands, pick_fault_operands,
                            pick_oob_operands, SACK_EDGE_CASES, SACK_TILE_CASES,
                            sack_edge_operands, sack_fault_operands,
                            sack_oob_operands, sack_tile_operands, to_torch)

pytestmark = pytest.mark.gpu


def _cummax_inputs(n, density, seed):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(n) * 100).astype(np.float32)
    if density == "first":
        f = np.zeros(n, bool)
        f[:1] = True
    elif density == "all":
        f = np.ones(n, bool)
    else:
        f = rng.random(n) < density
    return torch.from_numpy(v), torch.from_numpy(f)


@pytest.mark.parametrize("density", ["first", 1e-3, 0.5, "all"], ids=str)
@pytest.mark.parametrize("n", [0, 1, 1023, 1025, 5000, (1 << 20) + 3])
def test_segmented_cummax_kernel_matches_plain(n, density):
    dev = cuda_or_skip()
    v, f = _cummax_inputs(n, density, seed=n)
    want = lindley_ref.segmented_cummax(v, f)
    before = lindley_ops.LAUNCHES
    for flags in (f, f.to(torch.int32)):
        got = lindley_ops.segmented_cummax(v.to(dev), flags.to(dev))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
    assert lindley_ops.LAUNCHES == before + (2 if n else 0)


def test_segmented_cummax_rows_on_card():
    dev = cuda_or_skip()
    v, f = _cummax_inputs(3 * 4000, 1e-3, seed=1)
    v, f = v.view(3, 4000), f.view(3, 4000)
    want = lindley_ref.segmented_cummax(v, f)
    got = lindley_ops.segmented_cummax(v.to(dev), f.to(dev))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("quanta", [None, (0.05, 0.10, 0.20)])
@pytest.mark.parametrize("shape", [(2, 3, 50, 4), (1, 32, 300, 4),
                                   (2, 5, 40, 32), (1, 2, 20, 1)])
def test_jsq_scan_kernel_matches_plain(shape, quanta):
    dev = cuda_or_skip()
    B, S, pad, h = shape
    rng = np.random.default_rng(sum(shape))
    ok = torch.from_numpy(rng.random((B, S, pad)) < 0.8)
    t = torch.from_numpy((rng.integers(0, max(pad // 2, 1), (B, S, pad))
                          + rng.random((B, S, pad))).astype(np.float32))
    t = torch.where(ok, t, torch.tensor(-1e9))
    noise = torch.from_numpy(rng.random((B, S, pad, h)).astype(np.float32))
    pen = port_pad_penalty(h, torch.tensor([h, max(1, h - 1)][:B],
                                           dtype=torch.int32))
    thr = (None if quanta is None
           else torch.tensor(quanta, dtype=torch.float32) * 40)
    want = jsq_ops.jsq_scan(t, ok, noise, pen, thr)
    got = jsq_ops.jsq_scan(t.to(dev), ok.to(dev), noise.to(dev), pen.to(dev),
                           None if thr is None else thr.to(dev))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("quanta", [None, (0.05, 0.10, 0.20)])
@pytest.mark.parametrize("h", [33, 64])
def test_jsq_scan_kernel_many_ports_match_plain(h, quanta):
    """More ports than a warp has lanes: lane l walks ports l, l + 32, ...;
    bitwise equal to the plain version, with padded ports on one row."""
    test_jsq_scan_kernel_matches_plain((2, 4, 60, h), quanta)


# (pad, h): the engine's 4 and 8 ports, a lane group of 2 and 16, ports past
# a warp's lanes, pad = 1; with no bin edges, the engine's 3, 6 and 10.  Up
# to 8 ports and 8 edges take the registers walk, 10 edges the lanes walk.
_WALK_CASES = [(300, 4), (300, 8), (300, 2), (300, 16), (1, 4), (1, 33),
               (700, 33), (120, 64), (2000, 4)]
_WALK_QUANTA = [None, (0.05, 0.10, 0.20), (0.05, 0.1, 0.15, 0.2, 0.3, 0.5),
                tuple(0.05 * k for k in range(1, 11))]


@pytest.mark.parametrize("pad,h,quanta", [
    c + (q,) for c in _WALK_CASES for q in _WALK_QUANTA], ids=str)
def test_jsq_scan_kernel_walk_edges_match_plain(pad, h, quanta):
    """The walk of the prefix and the parallel tail (``jsq_walk_grid``: an
    empty row, a full row, packets that are not a prefix, finite times in
    empty cells), both walks' steps, bitwise against the plain version on
    the CPU."""
    dev = cuda_or_skip()
    args = jsq_walk_grid(pad + h, 2, 3, pad, h, quanta)
    want = jsq_ops.jsq_scan(*args)
    got = jsq_ops.jsq_scan(*[None if a is None else a.to(dev)
                             for a in args])
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


@pytest.mark.parametrize("scheme", ["host_pkt", "switch_pkt", "switch_pkt_ar",
                                    "jsq", "ofan"])
def test_card_matches_cpu(scheme):
    dev = cuda_or_skip()
    tree = FatTree(6)
    wl = workloads.all_to_all(tree, 4)
    s = lbs.by_name(scheme)
    cpu = fastsim.simulate_batch(tree, wl, s, [0, 1], device="cpu")
    card = fastsim.simulate_batch(tree, wl, s, [0, 1], device=dev)
    for a, b in zip(cpu, card):
        assert_same_result(a, b, scheme)


def _slot_operands(seed, B, M, NQ, cap, h, n_aggs):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    P = 4096
    o = dict(qcnt=t(rng.integers(0, cap, (B, NQ)).astype(np.int32)),
             qbuf=t(rng.integers(-1, P, (B, NQ, cap)).astype(np.int32)),
             qhead=t(rng.integers(0, cap, (B, NQ)).astype(np.int32)),
             qbase=t(rng.integers(0, NQ - h, (B, M)).astype(np.int32)),
             ids=t(rng.integers(0, P, (B, M)).astype(np.int32)),
             dead=t(rng.random((B, M, h)) < 0.2),
             pad_pen=port_pad_penalty(h, torch.tensor(
                 [h - (b % 2) for b in range(B)], dtype=torch.int32)),
             alive=t(rng.random((B, NQ)) < 0.9),
             apk=t(np.where(rng.random((B, M)) < 0.8,
                            rng.integers(0, P, (B, M)), -1).astype(np.int32)),
             aq=t(rng.integers(0, NQ // 4, (B, M)).astype(np.int32) * 4),
             asw=t(rng.integers(0, n_aggs, (B, M)).astype(np.int32)),
             seed_lo=t(rng.integers(0, 2**32, B).astype(np.int64)),
             seed_hi=t(rng.integers(0, 2**32, B).astype(np.int64)))
    o["avalid"] = o["apk"] >= 0
    o["to_agg"] = o["avalid"] & t(rng.random((B, M)) < 0.5)
    return o


_PICK = ("qcnt", "qbase", "ids", "dead", "pad_pen", "seed_lo", "seed_hi")
_ENQ = ("qbuf", "qhead", "qcnt", "alive", "apk", "aq", "avalid")
_AGG = ("qbuf", "qhead", "qcnt", "alive", "apk", "aq", "to_agg", "asw",
        "dead", "pad_pen", "seed_lo", "seed_hi")


@pytest.mark.parametrize("quanta", [None, (0.05, 0.10, 0.20)])
@pytest.mark.parametrize("size", [(3, 640, 4, 195, 32), (2, 5120, 8, 195, 128),
                                  (1, 7, 2, 5, 2), (2, 640, 33, 40, 8),
                                  (2, 1280, 64, 40, 16)])
def test_slot_step_kernels_match_plain(size, quanta):
    dev = cuda_or_skip()
    B, M, h, cap, n_aggs = size
    o = _slot_operands(M, B, M, M, cap, h, n_aggs)
    c = {k: v.to(dev) for k, v in o.items()}
    before = dict(slot_ops.LAUNCHES)
    kw = dict(site=3, quanta=quanta, cap=cap)
    want = slot_ops.jsq_pick(*[o[k] for k in _PICK], 123, **kw)
    got = slot_ops.jsq_pick(*[c[k] for k in _PICK], 123, **kw)
    assert torch.equal(got.cpu(), want)
    ekw = dict(cap=cap, ecn_thresh=cap // 2)
    for g, w in zip(slot_ops.enqueue(*[c[k] for k in _ENQ], **ekw),
                    slot_ops.enqueue(*[o[k] for k in _ENQ], **ekw)):
        assert torch.equal(g.cpu(), w)
    akw = dict(site=4, quanta=quanta, cap=cap, ecn_thresh=cap // 2,
               off1=M // 5, h=h)
    for g, w in zip(slot_ops.agg_jsq_enqueue(*[c[k] for k in _AGG], 9, **akw),
                    slot_ops.agg_jsq_enqueue(*[o[k] for k in _AGG], 9, **akw)):
        assert torch.equal(g.cpu(), w)
    torch.cuda.synchronize()
    assert all(slot_ops.LAUNCHES[k] == before[k] + 1
               for k in ("jsq_pick", "enqueue", "agg_jsq_enqueue"))
    # the inputs are not written
    assert torch.equal(c["qbuf"].cpu(), o["qbuf"])
    assert torch.equal(c["qcnt"].cpu(), o["qcnt"])


@pytest.mark.parametrize("case", sorted(ENQUEUE_CASES) + ["rows_140"])
def test_enqueue_kernel_cases_match_plain(case):
    """The enqueue kernel at the edges of its domain (``ENQUEUE_CASES``,
    among them 12 and 17 queues: one tile a row, a one-queue last tile;
    and 140 rows: more CTAs than SMs), bitwise against the plain version
    on the CPU; the inputs are not written."""
    dev = cuda_or_skip()
    if case == "rows_140":
        ops, cap = enqueue_operands("cap_13", seed=140, rows=140)
    else:
        ops, cap = enqueue_operands(case, seed=len(case))
    cpu = [torch.from_numpy(a) for a in ops]
    card = [a.to(dev) for a in cpu]
    kw = dict(cap=cap, ecn_thresh=cap // 2)
    got = slot_kernel.enqueue(*card, **kw)
    want = slot_ops.enqueue(*cpu, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    assert torch.equal(card[0].cpu(), cpu[0])
    assert torch.equal(card[2].cpu(), cpu[2])


@pytest.mark.parametrize("seed", [0, 1])
def test_agg_jsq_enqueue_kernel_out_of_range_keys_match_plain(seed):
    """The fused pick + enqueue kernel where the lanes that are not
    agg-bound target keys outside ``[0, NQ)`` (``agg_oob_operands``: a
    negative key wraps once, two keys share a ring cell), bitwise against
    the plain version on the CPU."""
    dev = cuda_or_skip()
    *ops, t = agg_oob_operands(seed)
    cpu = [torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                            else a) for a in ops]
    got = slot_ops.agg_jsq_enqueue(*[a.to(dev) for a in cpu], t,
                                   **AGG_OOB_KW)
    want = slot_ops.agg_jsq_enqueue(*cpu, t, **AGG_OOB_KW)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


@pytest.mark.parametrize("case", sorted(ENQUEUE_CASES) + ["k16"])
def test_agg_jsq_enqueue_kernel_cases_match_plain(case):
    """The fused pick + enqueue kernel on the enqueue's edge cases with
    about half the valid lanes agg-bound (``agg_case_operands``), and at the
    k=16 slot's 5,120 lanes and queues with 8 ports, bitwise against the
    plain version on the CPU; the inputs are not written."""
    dev = cuda_or_skip()
    if case == "k16":
        (*ops, t), kw = agg_case_operands("cap_195", seed=16,
                                          size=(5120, 5120, 195), h=8)
    else:
        (*ops, t), kw = agg_case_operands(case, seed=len(case))
    cpu = [to_torch(a) for a in ops]
    card = [a.to(dev) for a in cpu]
    got = slot_ops.agg_jsq_enqueue(*card, t, **kw)
    want = slot_ops.agg_jsq_enqueue(*cpu, t, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    assert torch.equal(card[0].cpu(), cpu[0])
    assert torch.equal(card[2].cpu(), cpu[2])


@pytest.mark.parametrize("seed", ["fault", 0, 1])
def test_pick_kernels_out_of_range_qbase_match_plain(seed):
    """Both pick kernels where the occupancy gather leaves the row: the
    pick at ``pick_fault_operands`` (``[0, 1, 3, 3]``) or
    ``pick_oob_operands``, and the fused agg kernel at
    ``agg_pick_oob_operands``; bitwise against the plain versions."""
    dev = cuda_or_skip()
    if seed == "fault":
        *ops, t = pick_fault_operands()
        kw = PICK_FAULT_KW
    else:
        *ops, t = pick_oob_operands(seed)
        kw = dict(site=3, quanta=(0.05, 0.10, 0.20) if seed else None,
                  cap=12)
    cpu = [to_torch(a) for a in ops]
    got = slot_ops.jsq_pick(*[a.to(dev) for a in cpu], t, **kw)
    want = slot_ops.jsq_pick(*cpu, t, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    if seed == "fault":
        assert want.tolist() == [[0, 1, 3, 3]]
        return
    *ops, t = agg_pick_oob_operands(seed)
    cpu = [to_torch(a) for a in ops]
    got = slot_ops.agg_jsq_enqueue(*[a.to(dev) for a in cpu], t,
                                   **AGG_PICK_OOB_KW)
    want = slot_ops.agg_jsq_enqueue(*cpu, t, **AGG_PICK_OOB_KW)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


@pytest.mark.parametrize("case", sorted(PICK_CASES))
def test_pick_kernels_domain_cases_match_plain(case):
    """Both CUDA picks at the edges of their domain (``PICK_CASES``: 0, 10,
    16 and 1,100 bin edges, the slot -1, -2**31 and 2**31 + 5, NaN and
    +-inf scores, all ports tied or dead, 1-400 ports, choosers not a
    multiple of a CTA's tile, rows of 2,000, 12,285 and 12,300 queues),
    bitwise against the plain versions on the CPU; each call
    launches its kernel once."""
    dev = cuda_or_skip()
    (*ops, t), kw = pick_case_operands(case)
    (*aops, _), akw = agg_pick_case_operands(case)
    cpu, acpu = [to_torch(a) for a in ops], [to_torch(a) for a in aops]
    before = dict(slot_ops.LAUNCHES)
    got = slot_ops.jsq_pick(*[a.to(dev) for a in cpu], t, **kw)
    agot = slot_ops.agg_jsq_enqueue(*[a.to(dev) for a in acpu], t, **akw)
    torch.cuda.synchronize()
    assert all(slot_ops.LAUNCHES[k] == before[k] + 1
               for k in ("jsq_pick", "agg_jsq_enqueue"))
    want = slot_ops.jsq_pick(*cpu, t, **kw)
    assert torch.equal(got.cpu(), want)
    for g, w in zip(agot, slot_ops.agg_jsq_enqueue(*acpu, t, **akw)):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    if case == "nan_score":          # the first NaN of each row
        assert want.tolist() == [[1] * 64, [2] * 64, [3] * 64]


def _sack_kernels_match_plain(ops):
    """Both SACK kernels on numpy operands ``ops`` against their plain
    versions, bitwise; each call launches its kernel once (``sack_advance``
    none when there is no flow) and leaves its inputs unwritten."""
    dev = cuda_or_skip()
    cpu = [to_torch(a) for a in ops]
    card = [a.to(dev) for a in cpu]
    before = dict(slot_ops.LAUNCHES)
    for g, w in zip(slot_ops.sack_update_scan(*card),
                    slot_ops.sack_update_scan(*cpu)):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    adv = [card[0]] + card[3:]
    got = slot_ops.sack_advance(*adv)
    assert torch.equal(got.cpu(),
                       slot_ops.sack_advance(*[cpu[0]] + cpu[3:]))
    torch.cuda.synchronize()
    assert slot_ops.LAUNCHES["sack_update_scan"] == \
        before["sack_update_scan"] + 1
    assert slot_ops.LAUNCHES["sack_advance"] == \
        before["sack_advance"] + (cpu[3].numel() > 0)
    for c, a in zip(card, cpu):                        # inputs unwritten
        assert torch.equal(c.cpu(), a)


@pytest.mark.parametrize("seed", ["fault", 0, 1, *SACK_EDGE_CASES])
def test_sack_kernels_out_of_range_match_plain(seed):
    """Both SACK kernels outside the engine's domain: delivering lanes at
    negative ``pk`` (wrapping once) and beyond ``[-P, P)`` (dropped), and
    windows before the row's start and past its end (``sack_fault_operands``,
    ``sack_oob_operands``); flows of size <= 0 whose windows start below
    ``fsize - 1``, acks past the flow's end and acks within 64 of INT_MAX
    (``sack_edge_operands``); bitwise against the plain versions."""
    ops = (sack_fault_operands() if seed == "fault"
           else sack_edge_operands(seed) if seed in SACK_EDGE_CASES
           else sack_oob_operands(seed))
    _sack_kernels_match_plain(ops)


@pytest.mark.parametrize("case", sorted(SACK_TILE_CASES))
def test_sack_kernels_tile_edges_match_plain(case):
    """``sack_update_scan``'s grid at its edges (``SACK_TILE_CASES``: a row
    shorter than a tile, one tile, a tile and a byte, rows at every
    alignment mod 16, windows across tile boundaries and the row's ends, no
    lanes, no flows, each form of the delivered set, tiles wider than 2,048
    bytes), and ``sack_advance`` on the same operands: bitwise against the
    plain versions."""
    _sack_kernels_match_plain(sack_tile_operands(case))


@pytest.mark.parametrize("scheme", ["jsq", "simple_rr", "host_pkt_ar"])
def test_loop_engine_card_matches_cpu(scheme):
    dev = cuda_or_skip()
    tree = FatTree(4)
    wl = workloads.permutation(tree, 32, np.random.default_rng(1),
                               inter_pod_only=True)
    s = lbs.by_name(scheme)
    cfg = loopsim.LoopConfig(max_slots=4000)
    cpu = loopsim.simulate_batch(tree, wl, s, [0, 1], cfg, device="cpu")
    card = loopsim.simulate_batch(tree, wl, s, [0, 1], cfg, device=dev)
    for a, b in zip(cpu, card):
        assert_same_loop_result(a, b, scheme)


def _sack_operands(seed, B, F, M):
    """SACK scoreboard operands: flows of 0-300 packets back to back (every
    5th empty), some received whole, cumulative acks anywhere in
    ``[0, fsize]``, and deliveries with repeated targets."""
    rng = np.random.default_rng(seed)
    fsize = rng.integers(1, 301, (B, F)).astype(np.int32)
    fsize[:, ::5] = 0
    pbase = (np.cumsum(fsize, axis=1) - fsize).astype(np.int32)
    P = int(fsize.sum(axis=1).max()) + 3
    f_cum = (rng.random((B, F)) * (fsize + 1)).astype(np.int32)
    f_cum[:, 1::6] = np.maximum(fsize[:, 1::6] - 1, 0)
    p_recv = rng.random((B, P)) < 0.8
    for b in range(B):
        for f in range(3, F, 4):
            p_recv[b, pbase[b, f]:pbase[b, f] + fsize[b, f]] = True
    pk = rng.integers(0, P, (B, M)).astype(np.int32)
    pk[:, 1::2] = pk[:, ::2][:, :pk[:, 1::2].shape[1]]
    deliv = rng.random((B, M)) < 0.5
    pk = np.where(deliv | (rng.random((B, M)) < 0.5), pk, -1)
    t = torch.from_numpy
    return dict(p_recv=t(p_recv), pk=t(pk), deliv=t(deliv), f_cum=t(f_cum),
                fsize=t(fsize), pbase=t(pbase))


@pytest.mark.parametrize("size", [(4, 128, 640), (2, 1024, 5120), (1, 1, 3),
                                  (3, 7, 1)])
def test_sack_kernels_match_plain(size):
    dev = cuda_or_skip()
    B, F, M = size
    o = _sack_operands(F + M, B, F, M)
    c = {k: v.to(dev) for k, v in o.items()}
    before = dict(slot_ops.LAUNCHES)
    upd = ("p_recv", "pk", "deliv", "f_cum", "fsize", "pbase")
    adv = ("p_recv", "f_cum", "fsize", "pbase")
    for g, w in zip(slot_ops.sack_update_scan(*[c[k] for k in upd]),
                    slot_ops.sack_update_scan(*[o[k] for k in upd])):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    got = slot_ops.sack_advance(*[c[k] for k in adv])
    assert torch.equal(got.cpu(), slot_ops.sack_advance(*[o[k] for k in adv]))
    torch.cuda.synchronize()
    assert all(slot_ops.LAUNCHES[k] == before[k] + 1
               for k in ("sack_update_scan", "sack_advance"))
    assert torch.equal(c["p_recv"].cpu(), o["p_recv"])   # inputs unwritten
    assert torch.equal(c["f_cum"].cpu(), o["f_cum"])


@pytest.mark.parametrize("scheme", ["host_pkt_ar", "switch_pkt_ar", "ofan"])
def test_sack_and_flap_card_matches_cpu(scheme):
    dev = cuda_or_skip()
    tree = FatTree(4)
    wl = workloads.permutation(tree, 96, np.random.default_rng(3))
    s = lbs.by_name(scheme)
    cfg = loopsim.LoopConfig(loss="sack", sack_thresh=8, buffer_pkts=20,
                             max_slots=8000)
    flap = FaultSchedule.flap(layer="ea", pod=0, i=0, j=1, t0=20, period=60,
                              cycles=1, host_react=8, switch_react=16)
    for fault in (None, flap):
        cpu = loopsim.simulate_batch(tree, wl, s, [0, 1], cfg, fault=fault,
                                     device="cpu")
        card = loopsim.simulate_batch(tree, wl, s, [0, 1], cfg, fault=fault,
                                      device=dev)
        for a, b in zip(cpu, card):
            assert_same_loop_result(a, b, scheme)
    fast = {"host_pkt_ar": "host_pkt", "switch_pkt_ar": "switch_pkt_ar",
            "ofan": "ofan"}[scheme]
    quick = FaultSchedule.flap(layer="ea", pod=0, i=0, j=1, t0=8, period=24,
                               cycles=1, host_react=2, switch_react=4)
    cpu = fastsim.simulate_batch(tree, wl, lbs.by_name(fast), [0, 1],
                                 fault=quick, device="cpu")
    card = fastsim.simulate_batch(tree, wl, lbs.by_name(fast), [0, 1],
                                  fault=quick, device=dev)
    for a, b in zip(cpu, card):
        assert_same_result(a, b, fast)


# chip_smoke.py's attention_vs_plain shapes (B, Hq, Hkv, Sq, Sk, D): Yi-6B's
# heads at its prefill lengths, two query tails, smaller head dims.
ATTN_SHAPES = ([(1, 32, 4, S, S, 128)
                for S in (1, 13, 64, 100, 128, 511, 1000, 1025, 2048)]
               + [(1, 32, 4, 1, 2048, 128), (2, 32, 4, 64, 1000, 128),
                  (2, 4, 2, 37, 37, 32), (1, 8, 2, 100, 130, 64),
                  (2, 6, 3, 65, 200, 96), (1, 4, 1, 50, 50, 80)])
# The reference's own tolerances (tests/test_kernels.py).
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _attn_inputs(shape, dtype, dev, seed):
    B, Hq, Hkv, Sq, Sk, D = shape
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(dev, dtype)
            for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=str)
def test_flash_attention_kernel_matches_plain(shape, dtype):
    dev = cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q, k, v = _attn_inputs(shape, dtype, dev, sum(shape))
    before = attn_ops.LAUNCHES
    got = attn_ops.attention(q, k, v)
    want = attn_ops.attention(q, k, v, backend="torch")
    torch.cuda.synchronize()
    assert attn_ops.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("Sq", [1, 13, 2048])
@pytest.mark.parametrize("D", [36, 80, 128, 136, 256])
def test_flash_attention_kernel_head_dims_match_plain(D, Sq, dtype):
    """Both routes (bf16: tensor cores; float32: CUDA cores) at head dims
    that are not a multiple of 8 or 64, or span two column tiles, for a
    decode row, a short prompt and a long one (causal, Sq == Sk; a single
    query sees 2,048 keys).  D = 36 arrives contiguous, so the wrapper
    copies it into rows padded to 40 elements first."""
    dev = cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    Sk = 2048 if Sq == 1 else Sq
    q, k, v = _attn_inputs((1, 8, 2, Sq, Sk, D), dtype, dev, D + Sq)
    route = "wgmma" if dtype == torch.bfloat16 else "cuda_cores"
    before = attn_ops.ROUTE_LAUNCHES[route]
    got = attn_ops.attention(q, k, v)
    want = attn_ops.attention(q, k, v, backend="torch")
    torch.cuda.synchronize()
    assert attn_ops.ROUTE_LAUNCHES[route] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("dims", [(192, 128), (48, 32), (64, 192), (32, 300)],
                         ids=str)
def test_flash_attention_kernel_value_width_matches_plain(dims, dtype):
    """v narrower or wider than q and k (MLA's Dk = 192, Dv = 128): the
    kernels take it, held to the plain path (the reference's route,
    ``mha_chunked``)."""
    dev = cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    Dk, Dv = dims
    g = torch.Generator().manual_seed(Dk + Dv)
    q, k, v = (torch.randn(s, generator=g).to(dev, dtype)
               for s in ((1, 8, 100, Dk), (1, 2, 130, Dk), (1, 2, 130, Dv)))
    before = attn_ops.LAUNCHES
    got = attn_ops.attention(q, k, v)
    want = attn_ops.attention(q, k, v, backend="torch")
    torch.cuda.synchronize()
    assert attn_ops.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == (1, 8, 100, Dv)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_attention_kernel_strided_and_non_causal():
    """(B, S, H, D) tensors read as (B, H, S, D) views, as the model passes
    them; the output keeps q's layout."""
    dev = cuda_or_skip()
    q, k, v = _attn_inputs((2, 8, 2, 70, 70, 64), torch.bfloat16, dev, 5)
    qs, ks, vs = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (q, k, v))
    for causal in (True, False):
        got = attn_ops.attention(qs, ks, vs, causal=causal)
        assert got.stride() == qs.stride()
        want = attn_ops.attention(q, k, v, causal=causal, backend="torch")
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)


def _greedy_trace(model, params, prompt, n_new, dev):
    """Greedy tokens (B, n_new) through the serve fns, and each step's
    smallest top-2 logit margin."""
    prompt = torch.as_tensor(prompt, device=dev)
    B, S = prompt.shape
    cache = serve_step.zero_cache(model, B, S + n_new, dev)
    prefill, decode = serve_step.build_serve_fns(model)
    logits, cache = prefill(params, {"tokens": prompt}, cache)
    toks, margins = [], []
    for i in range(n_new):
        if i:
            logits, cache = decode(params, toks[-1], cache, S + i - 1)
        top = logits.topk(2, dim=-1).values
        margins.append(float((top[..., 0] - top[..., 1]).min()))
        toks.append(logits.argmax(-1).to(torch.int32))
    return torch.cat(toks, dim=1), margins


def test_serving_on_card_matches_cpu():
    """Yi-6B's smoke config in float32: prefill logits within 1e-4 of the
    CPU's, and the greedy and batcher tokens equal the CPU's (every step's
    top-2 margin on the CPU exceeds 10 x 1e-4); one kernel launch a layer
    per prefill."""
    dev = cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    model = Model(get_config("yi-6b", smoke=True))
    cpu_params = model.init_params(0, device="cpu")
    card_params = model.init_params(0, device="cpu").to(dev)
    prompt = np.random.default_rng(0).integers(0, model.cfg.vocab, (2, 37))
    cache_c = serve_step.zero_cache(model, 2, 41, "cpu")
    cache_g = serve_step.zero_cache(model, 2, 41, dev)
    want, _ = model.prefill(cpu_params, {"tokens": torch.from_numpy(prompt)},
                            cache_c)
    before = attn_ops.LAUNCHES
    got, _ = model.prefill(card_params, {"tokens": torch.from_numpy(
        prompt).to(dev)}, cache_g)
    assert attn_ops.LAUNCHES == before + model.cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    cpu_tokens = serve_step.greedy_decode(model, cpu_params, prompt, 4,
                                          device="cpu")
    trace, margins = _greedy_trace(model, cpu_params, prompt, 4, "cpu")
    assert torch.equal(trace, cpu_tokens) and min(margins) > 1e-3, margins
    card_tokens = serve_step.greedy_decode(model, card_params, prompt, 4,
                                           device=dev)
    assert torch.equal(card_tokens.cpu(), cpu_tokens)
    done = {}
    for d, params in (("cpu", cpu_params), (dev, card_params)):
        cb = batching.ContinuousBatcher(model, params, n_slots=2, max_len=64,
                                        device=d)
        r = np.random.default_rng(2)
        for rid in range(4):
            cb.submit(batching.Request(
                rid=rid, prompt=r.integers(0, model.cfg.vocab,
                                           (13 + 7 * rid,)).astype(np.int32),
                max_new_tokens=5))
        done[str(d)] = {rid: q.out for rid, q in
                        cb.run_to_completion(max_ticks=200).items()}
    assert done["cpu"] == done[str(dev)]


# SSD kernel shapes (B, L, H, P, G, N): tests/test_kernels.py's, Zamba2-2.7B's
# heads and Mamba2-130M's at ragged and full prefill lengths.
SSD_SHAPES = [(1, 64, 2, 16, 1, 16), (2, 128, 4, 32, 2, 64),
              (1, 96, 8, 64, 4, 32), (1, 1, 80, 64, 1, 64),
              (2, 100, 80, 64, 1, 64), (1, 2048, 80, 64, 1, 64),
              (2, 37, 24, 64, 1, 128), (1, 2048, 24, 64, 1, 128),
              (1, 300, 4, 128, 1, 256), (2, 77, 6, 100, 2, 200)]
# float32: the reference's tolerance (tests/test_kernels.py); bf16: the
# output is rounded once to bf16 (2**-8 relative) from float32 sums taken
# in another order, so the two can differ by one bf16 step.
SSD_TOL = {torch.float32: (5e-5, 5e-4), torch.bfloat16: (2e-2, 2e-2)}


def _ssd_inputs(shape, dtype, dev, seed, decay=1.0):
    B, L, H, P, G, N = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, L, H, P, generator=g)
    dt = 0.01 + torch.rand(B, L, H, generator=g) * 0.2
    A = -(0.5 + torch.rand(H, generator=g)) * decay
    Bm = torch.randn(B, L, G, N, generator=g)
    C = torch.randn(B, L, G, N, generator=g)
    return [x.to(dev, dtype), dt.to(dev), A.to(dev), Bm.to(dev, dtype),
            C.to(dev, dtype)]


@pytest.mark.parametrize("decay", [1.0, 100.0], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
def test_ssd_kernel_matches_plain(shape, dtype, decay):
    """``decay=100``: A * dt sums past 100 within a chunk; the kernel must
    stay finite (it takes exp only where lam_i - lam_j <= 0)."""
    dev = cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _ssd_inputs(shape, dtype, dev, sum(shape), decay)
    before = ssd_ops.LAUNCHES
    got = ssd_ops.ssd(*args)
    want = ssd_ops.ssd(*args, backend="torch")
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == shape[:4]
    assert bool(torch.isfinite(got).all())
    atol, rtol = SSD_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    if shape[1] <= 128 and dtype == torch.float32:
        seq = ssd_ref.ssd_scan(*args)
        torch.testing.assert_close(got, seq, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_ssd_kernel_wide_chunk_matches_plain(dtype):
    """P = 128, N = 256 and a requested chunk of 128, which the kernel runs
    as chunks of 64: held to the plain ``ssd_chunked`` at chunk 128."""
    dev = cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _ssd_inputs((1, 500, 4, 128, 1, 256), dtype, dev, 3)
    got = ssd_ops.ssd(*args, chunk=128)
    want = ssd_ops.ssd(*args, chunk=128, backend="torch")
    atol, rtol = SSD_TOL[dtype]
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
def test_ssd_kernel_final_state_matches_plain(shape, dtype):
    """``final_state=True``: y and the state after the last position
    against the plain ``ssd_chunked`` and ``ssd_final_state``; bf16 runs
    the tensor-core walk in one launch, float32 the CUDA-core route."""
    dev = cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _ssd_inputs(shape, dtype, dev, sum(shape) + 1)
    before = dict(ssd_ops.ROUTE_LAUNCHES)
    y, h = ssd_ops.ssd(*args, final_state=True)
    want_y, want_h = ssd_ops.ssd(*args, final_state=True, backend="torch")
    torch.cuda.synchronize()
    which = ssd_kernel.route(dtype, shape[5])
    assert which == ("wgmma" if dtype == torch.bfloat16 else "cuda_cores")
    assert ssd_ops.ROUTE_LAUNCHES[which] == before[which] + 1
    assert h.dtype == torch.float32 and h.shape == want_h.shape
    atol, rtol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), want_y.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(h, want_h, atol=atol, rtol=rtol)


@pytest.mark.parametrize("chunk", [1, 16, 32, 63])
def test_ssd_kernel_bf16_short_chunks_match_plain(chunk):
    """The bf16 walk at a requested chunk below its 64-row tile, which it
    runs as chunks of 64 (the same closed form): y and h against the plain
    ``ssd_chunked`` and ``ssd_final_state`` at the requested chunk, at a
    ragged L, G > 1 and a large decay."""
    dev = cuda_or_skip()
    for decay in (1.0, 100.0):
        args = _ssd_inputs((2, 301, 8, 64, 2, 64), torch.bfloat16, dev,
                           chunk, decay)
        before = dict(ssd_ops.ROUTE_LAUNCHES)
        y, h = ssd_ops.ssd(*args, chunk=chunk, final_state=True)
        want_y, want_h = ssd_ops.ssd(*args, chunk=chunk, final_state=True,
                                     backend="torch")
        torch.cuda.synchronize()
        assert ssd_ops.ROUTE_LAUNCHES["wgmma"] == before["wgmma"] + 1
        assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
        torch.testing.assert_close(y.float(), want_y.float(), atol=2e-2,
                                   rtol=2e-2)
        torch.testing.assert_close(h, want_h, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("ptile", [32, 64])
@pytest.mark.parametrize("shape", [(1, 2048, 80, 64, 1, 64),
                                   (2, 130, 24, 64, 1, 128),
                                   (1, 100, 3, 40, 1, 96)], ids=str)
def test_ssd_kernel_p_tiles_match_plain(shape, ptile):
    """The bf16 walk with 32 and with 64 P columns a CTA (the split and
    the unsplit walk), y and h within the bf16 tolerance; a large decay
    too."""
    dev = cuda_or_skip()
    for decay in (1.0, 100.0):
        args = _ssd_inputs(shape, torch.bfloat16, dev, 5, decay)
        y, h = ssd_kernel.ssd_scan(*args, final_state=True, ptile=ptile)
        want_y, want_h = ssd_ops.ssd(*args, final_state=True,
                                     backend="torch")
        assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
        torch.testing.assert_close(y.float(), want_y.float(), atol=2e-2,
                                   rtol=2e-2)
        torch.testing.assert_close(h, want_h, atol=2e-2, rtol=2e-2)


def test_ssd_kernel_reads_strided_slices():
    """x, B and C as slices of one (B, L, width) projection, as the model
    passes them: the kernel reads them through their strides."""
    dev = cuda_or_skip()
    B, L, H, P, G, N = 2, 77, 8, 32, 2, 16
    g = torch.Generator().manual_seed(1)
    proj = torch.randn(B, L, H * P + 2 * G * N + 5, generator=g).to(dev)
    x = proj[..., :H * P].reshape(B, L, H, P)
    Bm = proj[..., H * P:H * P + G * N].reshape(B, L, G, N)
    C = proj[..., H * P + G * N:H * P + 2 * G * N].reshape(B, L, G, N)
    dt = (0.01 + torch.rand(B, L, H, generator=g) * 0.2).to(dev)
    A = -(0.5 + torch.rand(H, generator=g)).to(dev)
    assert not x.is_contiguous()
    got = ssd_ops.ssd(x, dt, A, Bm, C)
    want = ssd_ops.ssd(x.contiguous(), dt, A, Bm.contiguous(),
                       C.contiguous(), backend="torch")
    torch.testing.assert_close(got, want, atol=5e-5, rtol=5e-4)


@pytest.mark.parametrize("P,N", [(32, 16), (20, 12), (64, 64)])
def test_ssd_kernel_bf16_strided_slices_match_plain(P, N):
    """The tensor-core walk on x, B and C sliced from one bf16 projection:
    TMA reads them through their strides where those are multiples of 16
    bytes, and the wrapper hands it a padded copy where not (P = 20, N =
    12)."""
    dev = cuda_or_skip()
    B, L, H, G = 2, 77, 4, 2
    g = torch.Generator().manual_seed(2)
    proj = torch.randn(B, L, H * P + 2 * G * N + 8, generator=g).to(
        dev, torch.bfloat16)
    x = proj[..., :H * P].reshape(B, L, H, P)
    Bm = proj[..., H * P:H * P + G * N].reshape(B, L, G, N)
    C = proj[..., H * P + G * N:H * P + 2 * G * N].reshape(B, L, G, N)
    dt = (0.01 + torch.rand(B, L, H, generator=g) * 0.2).to(dev)
    A = -(0.5 + torch.rand(H, generator=g)).to(dev)
    y, h = ssd_ops.ssd(x, dt, A, Bm, C, final_state=True)
    want_y, want_h = ssd_ops.ssd(x.contiguous(), dt, A, Bm.contiguous(),
                                 C.contiguous(), backend="torch",
                                 final_state=True)
    torch.testing.assert_close(y.float(), want_y.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(h, want_h, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_ssm_serving_on_card_matches_cpu(arch):
    """The smoke configs in float32: prefill logits within 1e-4 of the
    CPU's, one ``ssd_scan`` launch a Mamba layer per prefill (and one
    ``flash_attention`` launch a shared-block application), and the batcher
    tokens equal the CPU's."""
    dev = cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    model = Model(get_config(arch, smoke=True))
    cpu_params = model.init_params(0, device="cpu")
    card_params = model.init_params(0, device="cpu").to(dev)
    prompt = np.random.default_rng(0).integers(0, model.cfg.vocab, (2, 70))
    cache_c = serve_step.zero_cache(model, 2, 74, "cpu")
    cache_g = serve_step.zero_cache(model, 2, 74, dev)
    want, _ = model.prefill(cpu_params, {"tokens": torch.from_numpy(prompt)},
                            cache_c)
    before = (ssd_ops.LAUNCHES, attn_ops.LAUNCHES)
    got, _ = model.prefill(card_params, {"tokens": torch.from_numpy(
        prompt).to(dev)}, cache_g)
    cfg = model.cfg
    n_apps = (cfg.n_layers // cfg.shared_attn_every
              if cfg.shared_attn_every else 0)
    assert (ssd_ops.LAUNCHES, attn_ops.LAUNCHES) == (
        before[0] + cfg.n_layers, before[1] + n_apps)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    done = {}
    for d, params in (("cpu", cpu_params), (dev, card_params)):
        cb = batching.ContinuousBatcher(model, params, n_slots=2, max_len=64,
                                        device=d)
        r = np.random.default_rng(3)
        for rid in range(3):
            cb.submit(batching.Request(
                rid=rid, prompt=r.integers(0, model.cfg.vocab,
                                           (13 + 7 * rid,)).astype(np.int32),
                max_new_tokens=4))
        done[str(d)] = {rid: q.out for rid, q in
                        cb.run_to_completion(max_ticks=200).items()}
    assert done["cpu"] == done[str(dev)]


# ---- the wrappers' domain: NaN and any flag dtype (cummax), causal Sq > Sk,
# float16 and mixed dtypes (attention and SSD) ------------------------------

def _nan_cummax_inputs(case):
    if case == "documented":
        v = torch.tensor([1, 5, float("nan"), 2, 7, 3, 0, 9])
        f = torch.zeros(8, dtype=torch.int64)
        f[[0, 5]] = 1
        return v, f
    g = torch.Generator().manual_seed(case)
    n = 1 << 16
    v = torch.randn(n, generator=g) * 100
    v[torch.rand(n, generator=g) < 0.01] = float("nan")
    f = (torch.rand(n, generator=g) < 0.02).to(torch.int64) * 7
    return v, f


@pytest.mark.parametrize("case", ["documented", 0, 1], ids=str)
def test_segmented_cummax_kernel_nan_and_int64_flags_match_plain(case):
    """NaN holds to its segment's end (jnp.maximum's rule; CUDA's fmaxf
    alone drops it), int64 flags count where nonzero; also as 4 rows."""
    dev = cuda_or_skip()
    v, f = _nan_cummax_inputs(case)
    outs = []
    for vv, ff in ((v, f), (v.view(4, -1), f.view(4, -1))):
        want = lindley_ops.segmented_cummax(vv, ff)
        got = lindley_ops.segmented_cummax(vv.to(dev), ff.to(dev)).cpu()
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   equal_nan=True)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        outs.append(got)
    if case == "documented":
        got = outs[0]
        assert torch.isnan(got[2:5]).all() and got[5:].tolist() == [3, 3, 9]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [(1, 2, 1, 160, 128, 16),
                                   (1, 32, 4, 300, 100, 128),
                                   (2, 4, 4, 129, 1, 32),
                                   (1, 8, 2, 1000, 999, 80)], ids=str)
def test_flash_attention_kernel_causal_more_queries_than_keys(shape, dtype):
    """Causal with Sq > Sk: rows at negative positions see no key and give
    the mean of v, on both routes."""
    dev = cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _attn_inputs(shape, dtype, dev, sum(shape))
    route = "wgmma" if dtype == torch.bfloat16 else "cuda_cores"
    before = attn_ops.ROUTE_LAUNCHES[route]
    got = attn_ops.attention(q, k, v)
    want = attn_ops.attention(q, k, v, backend="torch")
    torch.cuda.synchronize()
    assert attn_ops.ROUTE_LAUNCHES[route] == before + 1
    assert bool(torch.isfinite(got).all())
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    n_blind = shape[3] - shape[4]
    mean_v = v.float().mean(dim=2, keepdim=True).repeat_interleave(
        shape[1] // shape[2], dim=1)
    torch.testing.assert_close(got[:, :, :n_blind].float(),
                               mean_v.expand(-1, -1, n_blind, -1),
                               atol=tol, rtol=tol)


HALF_MIXED = [(torch.float16,) * 3,
              (torch.bfloat16, torch.float32, torch.float32),
              (torch.float32, torch.bfloat16, torch.float16)]


@pytest.mark.parametrize("dtypes", HALF_MIXED, ids=["float16", "bf16_first",
                                                    "mixed3"])
@pytest.mark.parametrize("shape", [(1, 4, 2, 128, 128, 16),
                                   (1, 32, 4, 100, 300, 128)], ids=str)
def test_flash_attention_kernel_half_and_mixed_dtypes(shape, dtypes):
    """Read in float32 (exact), the CUDA-core kernel, q's dtype out."""
    dev = cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (t.to(d) for t, d in zip(
        _attn_inputs(shape, torch.float32, dev, sum(shape)), dtypes))
    before = attn_ops.ROUTE_LAUNCHES["cuda_cores"]
    got = attn_ops.attention(q, k, v)
    want = attn_ops.attention(q, k, v, backend="torch")
    torch.cuda.synchronize()
    assert attn_ops.ROUTE_LAUNCHES["cuda_cores"] == before + 1
    assert got.dtype == dtypes[0] and want.dtype == dtypes[0]
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("dtypes", HALF_MIXED, ids=["float16", "bf16_x",
                                                    "mixed3"])
@pytest.mark.parametrize("shape", [(1, 64, 2, 16, 1, 16),
                                   (1, 100, 80, 64, 1, 64)], ids=str)
def test_ssd_kernel_half_and_mixed_dtypes(shape, dtypes):
    """x, B, C in float16 or mixed dtypes: read in float32 (exact), the
    CUDA-core route, x's dtype out."""
    dev = cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    x, dt, A, Bm, C = _ssd_inputs(shape, torch.float32, dev, sum(shape))
    x, Bm, C = (t.to(d) for t, d in zip((x, Bm, C), dtypes))
    before = ssd_ops.ROUTE_LAUNCHES["cuda_cores"]
    got = ssd_ops.ssd(x, dt, A, Bm, C)
    want = ssd_ops.ssd(x, dt, A, Bm, C, backend="torch")
    torch.cuda.synchronize()
    assert ssd_ops.ROUTE_LAUNCHES["cuda_cores"] == before + 1
    assert got.dtype == dtypes[0] and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
