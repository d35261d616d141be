"""Tests of the PyTorch port that need a CUDA card: each kernel against its
plain version, and both engines on the card against the engines on the CPU.

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
from repro_torch.faults import FaultSchedule
from repro_torch.net import fastsim, loopsim, workloads
from repro_torch.net._batching import port_pad_penalty
from repro_torch.net.topology import FatTree
from repro_torch.core import lb_schemes as lbs

from _torch_compare import (assert_same_loop_result, assert_same_result,
                            cuda_or_skip)

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


def test_jsq_scan_rejects_too_many_ports():
    dev = cuda_or_skip()
    t = torch.zeros((1, 1, 4), device=dev)
    with pytest.raises(ValueError):
        jsq_ops.jsq_scan(t, t > 0, torch.zeros((1, 1, 4, 33), device=dev),
                         torch.zeros((1, 33), device=dev))


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
                                  (1, 7, 2, 5, 2)])
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
