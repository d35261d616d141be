"""Tests of the PyTorch port that need a CUDA card: each kernel against its
plain version, both engines on the card against the engines on the CPU, and
the serving paths of every family (dense, Mamba2, Zamba2 hybrid, MoE, MLA,
VLM, enc-dec) on the card against the CPU.

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
@pytest.mark.parametrize("D", [36, 80, 96, 128, 136, 256])
def test_flash_attention_kernel_head_dims_match_plain(D, Sq, dtype):
    """Every route (bf16: tensor cores; float32: tensor cores up to D =
    128, CUDA cores past it) at head dims that are not a multiple of 8 or
    64, or span two column tiles, for a decode row, a short prompt and a
    long one (causal, Sq == Sk; a single query sees 2,048 keys).  D = 36
    arrives contiguous, so the wrapper copies it into rows padded to 40
    elements first."""
    dev = cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    Sk = 2048 if Sq == 1 else Sq
    q, k, v = _attn_inputs((1, 8, 2, Sq, Sk, D), dtype, dev, D + Sq)
    route = ("wgmma" if dtype == torch.bfloat16
             else "wgmma_f32" if D <= 128 else "cuda_cores")
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
    the bf16 tensor-core walk in one launch, float32 the float32 one up to
    N = 128 and the CUDA-core route past it."""
    dev = cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _ssd_inputs(shape, dtype, dev, sum(shape) + 1)
    before = dict(ssd_ops.ROUTE_LAUNCHES)
    y, h = ssd_ops.ssd(*args, final_state=True)
    want_y, want_h = ssd_ops.ssd(*args, final_state=True, backend="torch")
    torch.cuda.synchronize()
    which = ssd_kernel.route(dtype, shape[5])
    assert which == ("wgmma" if dtype == torch.bfloat16
                     else "wgmma_f32" if shape[5] <= 128 else "cuda_cores")
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


@pytest.mark.parametrize("chunk", [1, 16, 32, 63, 128])
def test_ssd_kernel_f32_short_and_long_chunks_match_plain(chunk):
    """The float32 walk at a requested chunk other than its 64-row tile,
    which it runs as chunks of 64 (the same closed form): y and h against
    the plain ``ssd_chunked`` and ``ssd_final_state`` at the requested
    chunk, at a ragged L, G > 1 and a large decay, at the float32
    tolerance."""
    dev = cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    for decay in (1.0, 100.0):
        args = _ssd_inputs((2, 301, 8, 64, 2, 64), torch.float32, dev,
                           chunk, decay)
        before = dict(ssd_ops.ROUTE_LAUNCHES)
        y, h = ssd_ops.ssd(*args, chunk=chunk, final_state=True)
        want_y, want_h = ssd_ops.ssd(*args, chunk=chunk, final_state=True,
                                     backend="torch")
        torch.cuda.synchronize()
        assert ssd_ops.ROUTE_LAUNCHES["wgmma_f32"] == before["wgmma_f32"] + 1
        assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
        torch.testing.assert_close(y, want_y, atol=5e-5, rtol=5e-4)
        torch.testing.assert_close(h, want_h, atol=5e-5, rtol=5e-4)


@pytest.mark.parametrize("ptile", [32, 64])
@pytest.mark.parametrize("shape", [(1, 2048, 80, 64, 1, 64),
                                   (2, 130, 24, 64, 1, 128),
                                   (1, 100, 3, 40, 1, 96),
                                   (2, 77, 6, 100, 2, 48)], ids=str)
def test_ssd_kernel_f32_p_tiles_match_plain(shape, ptile):
    """The float32 walk with 32 and with 64 P columns a CTA (64 only with
    N <= 64), y and h within the float32 tolerance, a large decay too; a
    rerun is bitwise equal."""
    dev = cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    if ptile == 64 and shape[5] > 64:
        args = _ssd_inputs(shape, torch.float32, dev, 5)
        with pytest.raises(ValueError, match="ptile"):
            ssd_kernel.ssd_scan(*args, ptile=ptile)
        return
    for decay in (1.0, 100.0):
        args = _ssd_inputs(shape, torch.float32, dev, 5, decay)
        y, h = ssd_kernel.ssd_scan(*args, final_state=True, ptile=ptile)
        y2, h2 = ssd_kernel.ssd_scan(*args, final_state=True, ptile=ptile)
        want_y, want_h = ssd_ops.ssd(*args, final_state=True,
                                     backend="torch")
        assert torch.equal(y, y2) and torch.equal(h, h2)
        assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
        torch.testing.assert_close(y, want_y, atol=5e-5, rtol=5e-4)
        torch.testing.assert_close(h, want_h, atol=5e-5, rtol=5e-4)


@pytest.mark.parametrize("P,N", [(32, 16), (20, 12), (64, 64), (64, 128)])
def test_ssd_kernel_f32_strided_slices_match_plain(P, N):
    """The float32 walk on x, B and C sliced from one float32 projection
    whose rows are multiples of 16 bytes: its 16-byte loads read them
    through their strides (no copy), with columns past P and N masked."""
    dev = cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    B, L, H, G = 2, 77, 4, 2
    g = torch.Generator().manual_seed(4)
    proj = torch.randn(B, L, H * P + 2 * G * N + 8, generator=g).to(dev)
    x = proj[..., :H * P].reshape(B, L, H, P)
    Bm = proj[..., H * P:H * P + G * N].reshape(B, L, G, N)
    C = proj[..., H * P + G * N:H * P + 2 * G * N].reshape(B, L, G, N)
    assert ssd_kernel._tma_ready(x) is x and ssd_kernel._tma_ready(Bm) is Bm
    dt = (0.01 + torch.rand(B, L, H, generator=g) * 0.2).to(dev)
    A = -(0.5 + torch.rand(H, generator=g)).to(dev)
    before = ssd_ops.ROUTE_LAUNCHES["wgmma_f32"]
    y, h = ssd_ops.ssd(x, dt, A, Bm, C, final_state=True)
    assert ssd_ops.ROUTE_LAUNCHES["wgmma_f32"] == before + 1
    want_y, want_h = ssd_ops.ssd(x.contiguous(), dt, A, Bm.contiguous(),
                                 C.contiguous(), backend="torch",
                                 final_state=True)
    torch.testing.assert_close(y, want_y, atol=5e-5, rtol=5e-4)
    torch.testing.assert_close(h, want_h, atol=5e-5, rtol=5e-4)


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
    the mean of v, on both tensor-core routes."""
    dev = cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _attn_inputs(shape, dtype, dev, sum(shape))
    route = "wgmma" if dtype == torch.bfloat16 else "wgmma_f32"
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
    """Read in float32 (exact), the float32 tensor-core kernel (head dims
    up to 128), q's dtype out."""
    dev = cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (t.to(d) for t, d in zip(
        _attn_inputs(shape, torch.float32, dev, sum(shape)), dtypes))
    before = attn_ops.ROUTE_LAUNCHES["wgmma_f32"]
    got = attn_ops.attention(q, k, v)
    want = attn_ops.attention(q, k, v, backend="torch")
    torch.cuda.synchronize()
    assert attn_ops.ROUTE_LAUNCHES["wgmma_f32"] == before + 1
    assert got.dtype == dtypes[0] and want.dtype == dtypes[0]
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("dtypes", HALF_MIXED, ids=["float16", "bf16_x",
                                                    "mixed3"])
@pytest.mark.parametrize("shape", [(1, 64, 2, 16, 1, 16),
                                   (1, 100, 80, 64, 1, 64)], ids=str)
def test_ssd_kernel_half_and_mixed_dtypes(shape, dtypes):
    """x, B, C in float16 or mixed dtypes: read in float32 (exact), the
    float32 tensor-core walk, x's dtype out."""
    dev = cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    x, dt, A, Bm, C = _ssd_inputs(shape, torch.float32, dev, sum(shape))
    x, Bm, C = (t.to(d) for t, d in zip((x, Bm, C), dtypes))
    before = ssd_ops.ROUTE_LAUNCHES["wgmma_f32"]
    got = ssd_ops.ssd(x, dt, A, Bm, C)
    want = ssd_ops.ssd(x, dt, A, Bm, C, backend="torch")
    torch.cuda.synchronize()
    assert ssd_ops.ROUTE_LAUNCHES["wgmma_f32"] == before + 1
    assert got.dtype == dtypes[0] and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


# ---- the rest of the zoo: attention at its shapes, its serving paths ------

# (B, Hq, Hkv, Sq, Sk, Dk, Dv, causal): MLA's prefill (128 heads, Dk 192,
# Dv 128), Whisper's encoder (1,500 ragged keys) and cross attention (a
# decode query against 1,500 keys), not causal.
ZOO_ATTN = [(1, 128, 128, 64, 64, 192, 128, True),
            (1, 12, 12, 1500, 1500, 64, 64, False),
            (2, 12, 12, 1, 1500, 64, 64, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", ZOO_ATTN, ids=str)
def test_flash_attention_kernel_zoo_shapes_match_plain(shape, dtype):
    dev = cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    B, Hq, Hkv, Sq, Sk, Dk, Dv, causal = shape
    g = torch.Generator().manual_seed(Sk + Dk)
    q, k, v = (torch.randn(s, generator=g).to(dev, dtype)
               for s in ((B, Hq, Sq, Dk), (B, Hkv, Sk, Dk), (B, Hkv, Sk, Dv)))
    before = attn_ops.LAUNCHES
    got = attn_ops.attention(q, k, v, causal=causal)
    want = attn_ops.attention(q, k, v, causal=causal, backend="torch")
    torch.cuda.synchronize()
    assert attn_ops.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == (B, Hq, Sq, Dv)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-v3-671b",
                                  "llava-next-34b", "whisper-small"])
def test_zoo_serving_on_card_matches_cpu(arch):
    """The smoke configs in float32: prefill logits within 1e-4 of the
    CPU's (vision embeds or frames in the batch), the attention kernel's
    launches a prefill, greedy tokens with the frontend input equal to the
    CPU's, and the batcher's tokens equal to the CPU's."""
    dev = cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    model = Model(get_config(arch, smoke=True))
    cfg = model.cfg
    cpu_params = model.init_params(0, device="cpu")
    card_params = model.init_params(0, device="cpu").to(dev)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 37)))
    extra, n_front, per_prefill = {}, 0, cfg.n_layers
    if cfg.family == "vlm":
        n_front = 16
        extra = {"vision_embeds": torch.from_numpy(rng.standard_normal(
            (2, n_front, cfg.frontend_dim), dtype=np.float32))}
    elif cfg.family == "encdec":
        extra = {"frames": torch.from_numpy(rng.standard_normal(
            (2, 10, cfg.frontend_dim), dtype=np.float32))}
        per_prefill = 2 * cfg.n_layers + cfg.n_encoder_layers
    cache_c = serve_step.zero_cache(model, 2, n_front + 41, "cpu")
    cache_g = serve_step.zero_cache(model, 2, n_front + 41, dev)
    want, _ = model.prefill(cpu_params, {"tokens": prompt, **extra}, cache_c)
    before = attn_ops.LAUNCHES
    got, _ = model.prefill(card_params, {
        "tokens": prompt.to(dev), **{k: v.to(dev) for k, v in extra.items()}},
        cache_g)
    assert attn_ops.LAUNCHES == before + per_prefill
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    toks = {str(d): serve_step.greedy_decode(
        model, params, prompt, 4, device=d, extra_batch=extra).cpu()
        for d, params in (("cpu", cpu_params), (dev, card_params))}
    assert torch.equal(toks["cpu"], toks[str(dev)])
    done = {}
    for d, params in (("cpu", cpu_params), (dev, card_params)):
        cb = batching.ContinuousBatcher(model, params, n_slots=2, max_len=64,
                                        device=d)
        r = np.random.default_rng(3)
        for rid in range(3):
            cb.submit(batching.Request(
                rid=rid, prompt=r.integers(0, cfg.vocab,
                                           (13 + 7 * rid,)).astype(np.int32),
                max_new_tokens=4))
        done[str(d)] = {rid: q.out for rid, q in
                        cb.run_to_completion(max_ticks=200).items()}
    assert done["cpu"] == done[str(dev)]


# ---------------------------------------------------------------------------
# Training: the attention backward kernel, SSD's missing backward, a step
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, Sq, Sk, Dk, Dv, causal); each gradient within atol = tol x
# its largest magnitude and rtol = tol of ref.mha_vjp's: bf16 2e-2 (the
# forward's), float32 1e-4 (chip_smoke.py's ATTN_GRAD_TOL states why).
GRAD_SHAPES = [(1, 4, 2, 64, 64, 32, 32, True),
               (2, 8, 2, 100, 130, 64, 64, True),
               (1, 2, 1, 160, 128, 16, 16, True),
               (1, 16, 16, 300, 300, 192, 128, True),
               (2, 12, 12, 1, 300, 64, 64, False),
               (1, 4, 1, 77, 200, 256, 256, True),
               (1, 32, 4, 1025, 1025, 128, 128, True),
               (1, 8, 8, 257, 257, 80, 80, True),
               (1, 8, 2, 200, 300, 96, 64, False),
               (1, 2, 1, 160, 128, 192, 128, True),
               (1, 4, 2, 77, 200, 160, 64, False),
               (1, 4, 1, 64, 64, 288, 128, True),
               (1, 4, 2, 64, 64, 192, 136, True)]
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _grads(q, k, v, dout, causal):
    qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
    before = attn_ops.BWD_LAUNCHES
    out = attn_ops.attention(qq, kk, vv, causal=causal)
    grads = torch.autograd.grad(out, (qq, kk, vv), dout)
    torch.cuda.synchronize()
    assert attn_ops.BWD_LAUNCHES == before + 1
    return grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("shape", GRAD_SHAPES, ids=str)
def test_flash_attention_backward_kernel_matches_plain(shape, dtype):
    """Every route against the plain version, reruns bitwise; a head dim
    up to 192 and a value width up to 128 take the tensor-core routes
    (bf16, or float32 by the three-way split), wider heads the CUDA-core
    route."""
    from repro_torch.kernels.flash_attn import kernel as attn_kernel
    from repro_torch.kernels.flash_attn import ref as attn_ref
    dev = cuda_or_skip()
    B, Hq, Hkv, Sq, Sk, D, Dv, causal = shape
    route = attn_kernel.route_bwd(dtype, D, Dv)
    assert route == ("cuda_cores" if D > 192 or Dv > 128
                     else "wgmma" if dtype == torch.bfloat16
                     else "wgmma_f32")
    rng = np.random.default_rng(0)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                     .to(dev, dtype) for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D),
                                               (B, Hkv, Sk, Dv),
                                               (B, Hq, Sq, Dv)))
    before = attn_ops.BWD_ROUTE_LAUNCHES[route]
    got = _grads(q, k, v, dout, causal)
    again = _grads(q, k, v, dout, causal)
    assert attn_ops.BWD_ROUTE_LAUNCHES[route] == before + 2
    want = attn_ref.mha_vjp(q, k, v, dout, causal=causal)
    tol = GRAD_TOL[dtype]
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)                  # bitwise reruns
        assert g.dtype == w.dtype and g.shape == w.shape
        scale = float(w.float().abs().max()) or 1.0
        torch.testing.assert_close(g.float(), w.float(), atol=tol * scale,
                                   rtol=tol)


def test_flash_attention_backward_strided_views():
    """The tensor-core backward on (B, H, S, D) views of (B, S, H, D)
    projections, as the model passes them: each gradient in its input's
    layout, within the bf16 tolerance of the plain version."""
    from repro_torch.kernels.flash_attn import ref as attn_ref
    dev = cuda_or_skip()
    B, Hq, Hkv, S, D = 2, 8, 2, 200, 128
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, h, D),
                                                    dtype=np.float32))
               .to(dev, torch.bfloat16).transpose(1, 2)
               for h in (Hq, Hkv, Hkv))
    dout = torch.randn(B, Hq, S, D, device=dev).to(torch.bfloat16)
    before = attn_ops.BWD_ROUTE_LAUNCHES["wgmma"]
    got = _grads(q, k, v, dout, True)
    assert attn_ops.BWD_ROUTE_LAUNCHES["wgmma"] == before + 1
    want = attn_ref.mha_vjp(q, k, v, dout)
    for t, g, w in zip((q, k, v), got, want):
        assert g.stride() == t.stride()
        scale = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), atol=2e-2 * scale,
                                   rtol=2e-2)


# (B, Hq, Hkv, Sq, Sk, Dk, Dv, causal): GQA, rows that see no key, Yi-6B's
# heads, Dv != D without the mask, D = 256 (the forward's widest).
LSE_SHAPES = [(1, 4, 2, 100, 130, 64, 64, True),
              (1, 2, 1, 160, 128, 16, 16, True),
              (1, 32, 4, 1025, 1025, 128, 128, True),
              (1, 4, 2, 77, 200, 96, 64, False),
              (1, 4, 1, 77, 200, 256, 256, True)]


@pytest.mark.parametrize("shape", LSE_SHAPES, ids=str)
def test_flash_attention_lse_matches_plain(shape):
    """The bf16 forward's log-sum-exp (log2 domain) against ``ref.mha_lse``
    within 1e-3 (log2 units; both sum the same bf16 products in float32, in
    another order) on the rows that see a key; the rows that see none are
    below -1e29 in both.  Its output is bitwise the output without it."""
    from repro_torch.kernels.flash_attn import kernel as attn_kernel
    from repro_torch.kernels.flash_attn import ref as attn_ref
    dev = cuda_or_skip()
    B, Hq, Hkv, Sq, Sk, D, Dv, causal = shape
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(dev, torch.bfloat16) for s in ((B, Hq, Sq, D),
                                                  (B, Hkv, Sk, D),
                                                  (B, Hkv, Sk, Dv)))
    plain = attn_kernel.flash_attention(q, k, v, causal=causal)
    out, lse = attn_kernel.flash_attention(q, k, v, causal=causal,
                                           return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    _, want = attn_ref.mha_lse(q, k, v, causal=causal)
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, Sq)
    seen = (torch.arange(Sq, device=dev) + (Sk - Sq) >= 0) if causal else \
        torch.ones(Sq, dtype=torch.bool, device=dev)
    torch.testing.assert_close(lse[..., seen], want[..., seen], rtol=0,
                               atol=1e-3)
    assert bool((lse[..., ~seen] < -1e29).all())
    assert bool((want[..., ~seen] < -1e29).all())


def test_flash_attention_lse_only_on_the_tensor_core_route():
    """float32 with a head past 128 takes the CUDA-core forward, which
    returns no lse."""
    from repro_torch.kernels.flash_attn import kernel as attn_kernel
    dev = cuda_or_skip()
    q = torch.randn(1, 2, 16, 136, device=dev)
    out, lse = attn_kernel.flash_attention(q, q, q, return_lse=True)
    assert lse is None and out.shape == q.shape


# (B, L, H, P, G, N, chunk, decay, final_state): Zamba2's heads at a
# ragged length with the final state's gradient, Mamba2's at 64, the
# grouped heads at chunk 16, a decay past 100 a chunk, P and N past a
# tile of 64.
SSD_GRAD_CASES = [(1, 300, 80, 64, 1, 64, 64, 1.0, True),
                  (2, 64, 24, 64, 1, 128, 64, 1.0, False),
                  (1, 301, 8, 64, 4, 32, 16, 1.0, False),
                  (1, 256, 8, 64, 4, 32, 64, 100.0, True),
                  (1, 100, 2, 100, 1, 200, 64, 1.0, True)]


@pytest.mark.parametrize("case", SSD_GRAD_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_ssd_gradient_on_the_card_raises(case, dtype):
    """The SSD scan's backward kernel against ``ref.ssd_vjp`` on the card:
    finite (at the large decay too), a rerun bitwise equal; bf16 each
    gradient within 2e-2 of its largest magnitude, float32 each no further
    from the float64 plain gradient than twice the float32 plain version's
    distance plus 2.4e-7 of its largest magnitude (at a decay past 100 the
    float32 plain dA is 2e-4 of its magnitude from float64); and
    ``ops.ssd``'s autograd route launches it once with the same result
    (its name is kept from when the card refused this gradient)."""
    dev = cuda_or_skip()
    B, L, H, P, G, N, chunk, decay, final = case
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
    x, Bm, C, dy = (t.to(dev, dtype) for t in (
        f(B, L, H, P), f(B, L, G, N), f(B, L, G, N), f(B, L, H, P)))
    dt = torch.from_numpy(
        0.01 + 0.2 * rng.random((B, L, H), dtype=np.float32)).to(dev)
    A = torch.from_numpy(
        (-0.5 - rng.random(H, dtype=np.float32)) * decay).to(dev)
    dh = f(B, H, N, P).to(dev) if final else None
    args = (x, dt, A, Bm, C)
    got = ssd_kernel.ssd_scan_bwd(*args, dy, dh, chunk=chunk)
    again = ssd_kernel.ssd_scan_bwd(*args, dy, dh, chunk=chunk)
    want = ssd_ref.ssd_vjp(*args, dy, chunk=chunk, dh_final=dh)
    torch.cuda.synchronize()
    exact = (ssd_ref.ssd_vjp(*(t.double() for t in args), dy.double(),
                             chunk=chunk,
                             dh_final=None if dh is None else dh.double())
             if dtype == torch.float32 else want)
    for g, a, w, e, t in zip(got, again, want, exact, args):
        assert torch.equal(g, a)
        assert g.dtype == t.dtype and g.shape == t.shape
        assert bool(torch.isfinite(g).all())
        scale = float(e.abs().max())
        if dtype == torch.float32:
            k_err = float((g.double() - e).abs().max())
            p_err = float((w.double() - e).abs().max())
            assert k_err <= 2 * p_err + 2.4e-7 * scale
        else:
            torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                       atol=2e-2 * scale)
    ins = [t.detach().requires_grad_(True) for t in args]
    before = ssd_ops.BWD_LAUNCHES
    out = ssd_ops.ssd(*ins, chunk=chunk, final_state=final)
    outs, cots = (out, (dy, dh)) if final else ((out,), (dy,))
    via_ops = torch.autograd.grad(outs, ins, cots)
    assert ssd_ops.BWD_LAUNCHES == before + 1
    assert all(torch.equal(a, b) for a, b in zip(via_ops, got))


# (B, L, H, P, G, N, chunk, final_state, strided): bf16 on the backward's
# tensor-core route at Zamba2-2.7B's and Mamba2-130M's train shapes, a
# requested chunk of 128 over a ragged length with the final state's
# gradient, strided slices of x, B, C and dy, heads of P 32, 100, 128 and
# 256 (a masked P box, 2 to 4 boxes, N = 128 with P = 256); then N = 200,
# past the route's 128, on the CUDA cores.
SSD_BWD_ROUTE_CASES = [(1, 4096, 80, 64, 1, 64, 64, False, False),
                       (2, 2048, 24, 64, 1, 128, 64, False, False),
                       (1, 301, 8, 64, 4, 32, 128, True, False),
                       (2, 100, 24, 64, 1, 128, 64, False, True),
                       (1, 301, 4, 32, 2, 64, 64, True, False),
                       (1, 301, 4, 100, 1, 128, 64, True, False),
                       (1, 301, 6, 128, 2, 64, 64, True, False),
                       (1, 301, 2, 256, 1, 128, 64, True, False),
                       (1, 100, 2, 64, 1, 200, 64, True, False)]


@pytest.mark.parametrize("case", SSD_BWD_ROUTE_CASES, ids=str)
def test_ssd_gradient_bf16_routes(case):
    """bf16 SSD gradients on the route ``kernel.route_bwd`` names (the
    tensor cores up to N = 128, the CUDA cores past it) against
    ``ref.ssd_vjp``: each gradient within 2e-2 of its largest magnitude,
    finite, a rerun bitwise equal; ``ops.ssd``'s autograd route gives the
    same gradients and counts one ``BWD_ROUTE_LAUNCHES`` on that route."""
    dev = cuda_or_skip()
    B, L, H, P, G, N, chunk, final, strided = case
    route = "wgmma" if N <= 128 else "cuda_cores"
    assert ssd_kernel.route_bwd(torch.bfloat16, N, P) == route
    rng = np.random.default_rng(1)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
    x, Bm, C, dy = (t.to(dev, torch.bfloat16) for t in (
        f(B, L, H, P), f(B, L, G, N), f(B, L, G, N), f(B, L, H, P)))
    if strided:
        proj = torch.zeros(B, L, H * P + 2 * G * N + 8, dtype=torch.bfloat16,
                           device=dev)
        proj[..., :H * P] = x.reshape(B, L, -1)
        proj[..., H * P:H * P + G * N] = Bm.reshape(B, L, -1)
        proj[..., H * P + G * N:H * P + 2 * G * N] = C.reshape(B, L, -1)
        x = proj[..., :H * P].reshape(B, L, H, P)
        Bm = proj[..., H * P:H * P + G * N].reshape(B, L, G, N)
        C = proj[..., H * P + G * N:H * P + 2 * G * N].reshape(B, L, G, N)
        wide = torch.zeros(B, L, H, P + 3, dtype=torch.bfloat16, device=dev)
        wide[..., :P] = dy
        dy = wide[..., :P]
        assert not x.is_contiguous() and not dy.is_contiguous()
    dt = torch.from_numpy(
        0.01 + 0.2 * rng.random((B, L, H), dtype=np.float32)).to(dev)
    A = torch.from_numpy(-0.5 - rng.random(H, dtype=np.float32)).to(dev)
    dh = f(B, H, N, P).to(dev) if final else None
    args = (x, dt, A, Bm, C)
    got = ssd_kernel.ssd_scan_bwd(*args, dy, dh, chunk=chunk)
    again = ssd_kernel.ssd_scan_bwd(*args, dy, dh, chunk=chunk)
    want = ssd_ref.ssd_vjp(*args, dy, chunk=chunk, dh_final=dh)
    torch.cuda.synchronize()
    for g, a, w, t in zip(got, again, want, args):
        assert torch.equal(g, a)
        assert g.dtype == t.dtype and g.shape == t.shape
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=2e-2 * float(w.float().abs().max()))
    ins = [t.detach().requires_grad_(True) for t in args]
    before = dict(ssd_ops.BWD_ROUTE_LAUNCHES)
    out = ssd_ops.ssd(*ins, chunk=chunk, final_state=final)
    outs, cots = (out, (dy, dh)) if final else ((out,), (dy,))
    via_ops = torch.autograd.grad(outs, ins, cots)
    assert ssd_ops.BWD_ROUTE_LAUNCHES == {**before,
                                          route: before[route] + 1}
    assert all(torch.equal(a, b) for a, b in zip(via_ops, got))


@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-moe-30b-a3b",
                                  "deepseek-v3-671b", "llava-next-34b",
                                  "whisper-small", "mamba2-130m",
                                  "zamba2-2.7b"])
def test_train_step_on_card_matches_plain(arch):
    """One train step of the smoke config (float32) through the kernels and
    through the plain versions on the card: loss within 1e-5 and gradient
    norm within 1e-4, relative; the backward kernels of the family's layers
    (attention, SSD scan) launched."""
    from repro_torch.train import train_step as ts
    dev = cuda_or_skip()
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (4, 32)).astype(np.int32)).to(dev)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.randn(4, 8, cfg.frontend_dim,
                                             device=dev)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(4, cfg.n_frontend_tokens,
                                      cfg.frontend_dim, device=dev)
    out = {}
    for backend in ("auto", "torch"):
        model = Model(cfg, backend=backend)
        state = ts.make_train_state(model, model.init_params(0, device=dev),
                                    ts.TrainConfig())
        before = attn_ops.BWD_LAUNCHES + ssd_ops.BWD_LAUNCHES
        _, m = ts.build_train_step(model, ts.TrainConfig())(state, batch)
        out[backend] = (float(m["loss"]), float(m["grad_norm"]),
                        attn_ops.BWD_LAUNCHES + ssd_ops.BWD_LAUNCHES - before)
    assert out["auto"][2] > 0 and out["torch"][2] == 0
    assert abs(out["auto"][0] - out["torch"][0]) <= 1e-5 * out["torch"][0]
    assert abs(out["auto"][1] - out["torch"][1]) <= 1e-4 * out["torch"][1]


# ---- the float32 routes on the tensor cores (three bf16 parts, six
# products): forward, log-sum-exp, backward ------------------------------

# (B, Hq, Hkv, Sq, Sk, D, Dv, causal): GQA, ragged keys, rows that see no
# key (Sq > Sk), not causal, D = 16, 36, 64, 96, 128, Dv != D; then MLA's
# Dk 192 / Dv 128 (the wide instances: 32-key tiles forward, 16-row tiles
# backward), with rows that see no key, and D = 160 with Dv = 64.
F32_TC_SHAPES = [(1, 8, 2, 100, 130, 16, 16, True),
                 (2, 4, 2, 37, 53, 36, 36, True),
                 (1, 8, 2, 300, 100, 64, 64, True),
                 (1, 6, 3, 65, 200, 96, 96, False),
                 (1, 32, 4, 1025, 1025, 128, 128, True),
                 (1, 4, 1, 77, 200, 128, 64, True),
                 (2, 4, 4, 129, 1, 32, 32, True),
                 (1, 16, 16, 300, 300, 192, 128, True),
                 (1, 2, 1, 160, 128, 192, 128, True),
                 (1, 4, 2, 77, 200, 160, 64, False)]


def _f32_inputs(shape, seed, dtypes=(torch.float32,) * 4):
    B, Hq, Hkv, Sq, Sk, D, Dv, _ = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            .to("cuda", d) for s, d in zip(
                ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, Dv),
                 (B, Hq, Sq, Dv)), dtypes)]


@pytest.mark.parametrize("shape", F32_TC_SHAPES, ids=str)
def test_flash_attention_f32_tensor_core_route_matches_plain(shape):
    """The float32 forward on the tensor cores within the reference's 2e-5
    of the plain version, its launch counted on ``wgmma_f32``; rows that
    see no key give the mean of v."""
    cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    B, Hq, Hkv, Sq, Sk, D, Dv, causal = shape
    q, k, v, _ = _f32_inputs(shape, 5)
    before = dict(attn_ops.ROUTE_LAUNCHES)
    got = attn_ops.attention(q, k, v, causal=causal)
    want = attn_ops.attention(q, k, v, causal=causal, backend="torch")
    torch.cuda.synchronize()
    assert attn_ops.ROUTE_LAUNCHES == {**before, "wgmma_f32":
                                       before["wgmma_f32"] + 1}
    assert got.dtype == torch.float32 and got.shape == (B, Hq, Sq, Dv)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    blind = max(Sq - Sk, 0) if causal else 0
    mean_v = v.mean(dim=2, keepdim=True).repeat_interleave(Hq // Hkv, dim=1)
    torch.testing.assert_close(got[:, :, :blind],
                               mean_v.expand(-1, -1, blind, -1), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("shape", F32_TC_SHAPES, ids=str)
def test_flash_attention_f32_lse_matches_plain(shape):
    """The float32 tensor-core forward's log-sum-exp (log2 domain) within
    2e-5 of ``ref.mha_lse`` on the rows that see a key (below -1e29 on
    those that see none); its output is bitwise the output without it."""
    from repro_torch.kernels.flash_attn import kernel as attn_kernel
    from repro_torch.kernels.flash_attn import ref as attn_ref
    cuda_or_skip()
    B, Hq, Hkv, Sq, Sk, D, Dv, causal = shape
    q, k, v = (t if attn_kernel.kernel_ready(t) else attn_kernel.ready_copy(t)
               for t in _f32_inputs(shape, 6)[:3])
    plain = attn_kernel.flash_attention(q, k, v, causal=causal)
    out, lse = attn_kernel.flash_attention(q, k, v, causal=causal,
                                           return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    _, want = attn_ref.mha_lse(q, k, v, causal=causal)
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, Sq)
    seen = (torch.arange(Sq, device=q.device) + (Sk - Sq) >= 0) if causal \
        else torch.ones(Sq, dtype=torch.bool, device=q.device)
    torch.testing.assert_close(lse[..., seen], want[..., seen], rtol=0,
                               atol=2e-5)
    assert bool((lse[..., ~seen] < -1e29).all())


@pytest.mark.parametrize("dtypes", HALF_MIXED, ids=["float16", "bf16_q",
                                                    "mixed3"])
@pytest.mark.parametrize("shape", F32_TC_SHAPES[:2], ids=str)
def test_flash_attention_f32_route_half_and_mixed_backward(shape, dtypes):
    """float16 and mixed dtypes read in float32 take both float32
    tensor-core routes (forward and backward), q's dtype out, each
    gradient in its input's dtype, within 2e-2 of ``ref.mha_vjp``."""
    from repro_torch.kernels.flash_attn import ref as attn_ref
    cuda_or_skip()
    causal = shape[-1]
    q, k, v = _f32_inputs(shape, 7, dtypes + (torch.float32,))[:3]
    dout = _f32_inputs(shape, 8)[3].to(q.dtype)
    before = (dict(attn_ops.ROUTE_LAUNCHES), dict(attn_ops.BWD_ROUTE_LAUNCHES))
    got = _grads(q, k, v, dout, causal)
    assert attn_ops.ROUTE_LAUNCHES["wgmma_f32"] == before[0]["wgmma_f32"] + 1
    assert (attn_ops.BWD_ROUTE_LAUNCHES["wgmma_f32"]
            == before[1]["wgmma_f32"] + 1)
    want = attn_ref.mha_vjp(q, k, v, dout, causal=causal)
    for t, g, w in zip((q, k, v), got, want):
        assert g.dtype == t.dtype
        scale = float(w.float().abs().max()) or 1.0
        torch.testing.assert_close(g.float(), w.float(), atol=2e-2 * scale,
                                   rtol=2e-2)


@pytest.mark.parametrize("shape", F32_TC_SHAPES, ids=str)
def test_flash_attention_f32_backward_matches_plain_and_reruns_bitwise(shape):
    """The float32 tensor-core backward within 1e-4 (of each gradient's
    largest magnitude) of ``ref.mha_vjp``, counted on ``wgmma_f32``, three
    runs bitwise equal (no atomics, fixed-order sums)."""
    from repro_torch.kernels.flash_attn import ref as attn_ref
    cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    causal = shape[-1]
    q, k, v, dout = _f32_inputs(shape, 9)
    before = dict(attn_ops.BWD_ROUTE_LAUNCHES)
    runs = [_grads(q, k, v, dout, causal) for _ in range(3)]
    assert attn_ops.BWD_ROUTE_LAUNCHES == {**before, "wgmma_f32":
                                           before["wgmma_f32"] + 3}
    want = attn_ref.mha_vjp(q, k, v, dout, causal=causal)
    for i, (g, w) in enumerate(zip(runs[0], want)):
        assert all(torch.equal(g, r[i]) for r in runs[1:])
        scale = float(w.abs().max()) or 1.0
        torch.testing.assert_close(g, w, atol=1e-4 * scale, rtol=1e-4)
