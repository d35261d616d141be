"""Tests of the PyTorch port that need a CUDA card: each kernel against its
plain version, and the engine on the card against the engine on the CPU.

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
from repro_torch.net import fastsim, workloads
from repro_torch.net._batching import port_pad_penalty
from repro_torch.net.topology import FatTree
from repro_torch.core import lb_schemes as lbs

from _torch_compare import assert_same_result, cuda_or_skip

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
