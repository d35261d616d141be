"""Dynamic fault schedules in the PyTorch port against the JAX reference:
the schedule objects (epoch timeline, reaction starts, labels, dict round
trip, entropy-keyed base failures), a one-epoch schedule against the static
path on both engines, and flapping and mixed static + flap megabatches on
both engines, bitwise."""
import json

import numpy as np
import pytest

from repro import faults as ref_faults
from repro.core import lb_schemes as lbs
from repro.net import fastsim as ref_fastsim, loopsim as ref_loopsim
from repro.net import workloads
from repro.net.topology import FatTree, LinkState

from repro_torch import faults
from repro_torch.interop import from_reference
from repro_torch.net import fastsim, loopsim

from _torch_compare import assert_same_loop_result, assert_same_result

CFG = ref_loopsim.LoopConfig(max_slots=4000)
# The flap of tests/test_faults.py: down at slot 20, up at 80.
FLAP = ref_faults.FaultSchedule.flap(layer="ea", pod=0, i=0, j=1, t0=20,
                                     period=60, cycles=1, host_react=8,
                                     switch_react=16)
# A flap whose epochs and reactions fall inside the release window of the
# fast engine's 24-packet point (slots 0-23).
QUICK = ref_faults.FaultSchedule.flap(layer="ea", pod=0, i=0, j=1, t0=4,
                                      period=12, cycles=1, host_react=2,
                                      switch_react=3)
BURST = ref_faults.FaultSchedule.burst([("ea", 0, 0, 0), ("ac", 0, 1, 0)],
                                       t_down=30, t_up=90, host_react=12,
                                       switch_react=24)


@pytest.fixture(scope="module")
def point():
    tree = FatTree(4)
    return tree, workloads.permutation(tree, 24, np.random.default_rng(1),
                                       inter_pod_only=True)


def _failing_seed(tree, p=0.15):
    for s in range(60):
        if LinkState.random_failures(tree, p, seed=s).any_failure():
            return s
    raise RuntimeError("no failures sampled")


def _schedules(tree):
    s = _failing_seed(tree)
    return (FLAP, QUICK, BURST,
            ref_faults.FaultSchedule.static(0.15, s, host_react=64,
                                            switch_react=64),
            ref_faults.FaultSchedule.static(0.1, 7, legacy_rng=True),
            ref_faults.FaultSchedule.burst([("ea", 1, 0, 0), ("ac", 1, 1, 1)],
                                           t_down=100, t_up=300,
                                           p_fail=0.05))


def test_schedules_compile_like_reference(point):
    tree, _ = point
    for sched in _schedules(tree):
        port = from_reference(sched)
        assert type(port) is faults.FaultSchedule
        assert port.label() == sched.label()
        assert port.n_epochs == sched.n_epochs
        d = port.to_dict()
        assert d == sched.to_dict()
        assert faults.FaultSchedule.from_dict(json.loads(json.dumps(d))) \
            == port
        want = sched.compile(tree)
        got = port.compile(from_reference(tree))
        assert got.ep_start == want.ep_start
        assert got.n_epochs == want.n_epochs
        for lw, lg in zip(want.links, got.links):
            np.testing.assert_array_equal(lg.ea, lw.ea)
            np.testing.assert_array_equal(lg.ac, lw.ac)
        for cls in ("host", "switch"):
            a, b = want.react_starts(cls), got.react_starts(cls)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert faults.NEVER == ref_faults.schedule.NEVER == 2**30
    with pytest.raises(ValueError):
        faults.LinkEvent(-1, "ea", 0, 0, 0, up=False)
    with pytest.raises(ValueError):
        faults.FaultSchedule(events=(faults.LinkEvent(5, "ea", 0, 3, 0,
                                                      up=False),)
                             ).compile(from_reference(tree))


def test_one_epoch_schedule_equals_static_fast(point):
    tree, wl = point
    s = _failing_seed(tree)
    t, w = from_reference(tree), from_reference(wl)
    links = from_reference(LinkState.random_failures(tree, 0.15, seed=s))
    sched = faults.FaultSchedule.static(0.15, s)
    for name in ("host_pkt", "host_dr", "ofan", "jsq", "flow_ecmp"):
        scheme = from_reference(lbs.by_name(name))
        static = fastsim.simulate(t, w, scheme, seed=0, links=links,
                                  device="cpu")
        epoch = fastsim.simulate(t, w, scheme, seed=0, fault=sched,
                                 device="cpu")
        assert_same_result(static, epoch, name)
    ref = ref_fastsim.simulate(tree, wl, lbs.host_dr(), seed=0,
                               fault=ref_faults.FaultSchedule.static(0.15, s))
    assert_same_result(ref, fastsim.simulate(
        t, w, from_reference(lbs.host_dr()), seed=0, fault=sched,
        device="cpu"), "host_dr vs reference")


def test_one_epoch_schedule_equals_static_loop(point):
    tree, wl = point
    s = _failing_seed(tree)
    t, w = from_reference(tree), from_reference(wl)
    links = from_reference(LinkState.random_failures(tree, 0.15, seed=s))
    cfg = from_reference(CFG)
    sched = faults.FaultSchedule.static(0.15, s, host_react=64,
                                        switch_react=64)
    for name in ("host_pkt_ar", "ofan"):        # one host-, one switch-class
        scheme = from_reference(lbs.by_name(name))
        static = loopsim.simulate(t, w, scheme, cfg, seed=0, links=links,
                                  g_converge=64, device="cpu")
        epoch = loopsim.simulate(t, w, scheme, cfg, seed=0, fault=sched,
                                 device="cpu")
        assert_same_loop_result(static, epoch, name)


@pytest.mark.parametrize("name", ["host_pkt", "host_dr", "ofan",
                                  "switch_pkt", "jsq"])
def test_flap_fast_matches_reference(point, name):
    tree, wl = point
    t, w = from_reference(tree), from_reference(wl)
    scheme = from_reference(lbs.by_name(name))
    for sched in (QUICK, BURST):
        ref = ref_fastsim.simulate(tree, wl, lbs.by_name(name), seed=1,
                                   fault=sched)
        port = fastsim.simulate(t, w, scheme, seed=1,
                                fault=from_reference(sched), device="cpu")
        assert_same_result(ref, port, f"{name} {sched.label()}")
    # QUICK binds packets to all three epochs, at both reaction classes.
    plan = fastsim._prepare(t, w, scheme, 12.0, None, "auto", 4.0,
                            fault=from_reference(QUICK))
    assert plan.ep_host.max() == plan.static_args["ep_sw"].max() == 2
    if name in ("ofan", "host_pkt"):    # link-aware: the flap moves packets
        base = fastsim.simulate(t, w, scheme, seed=1, device="cpu")
        flap = fastsim.simulate(t, w, scheme, seed=1,
                                fault=from_reference(QUICK), device="cpu")
        assert not np.array_equal(base.delivery, flap.delivery)


@pytest.mark.parametrize("name", ["host_pkt_ar", "switch_pkt_ar", "ofan"])
def test_flap_loop_matches_reference(point, name):
    tree, wl = point
    ref = ref_loopsim.simulate(tree, wl, lbs.by_name(name), CFG, seed=0,
                               fault=FLAP)
    port = loopsim.simulate(from_reference(tree), from_reference(wl),
                            from_reference(lbs.by_name(name)),
                            from_reference(CFG), seed=0,
                            fault=from_reference(FLAP), device="cpu")
    assert_same_loop_result(ref, port, name)
    assert port.finished


def test_mixed_megabatch_fast_matches_reference(point):
    tree, wl = point
    s = _failing_seed(tree)
    static = LinkState.random_failures(tree, 0.15, seed=s)
    items = [(tree, wl, lbs.host_pkt(), [0, 1], None, None),
             (tree, wl, lbs.host_pkt(), [0, 1], static, None),
             (tree, wl, lbs.host_pkt(), [0, 1], None, FLAP),
             (tree, wl, lbs.host_pkt(), [0], None, QUICK),
             (tree, wl, lbs.host_pkt(), [0], None, BURST)]
    fused = fastsim.simulate_megabatch(
        [tuple(from_reference(x) if j != 3 else x for j, x in enumerate(it))
         for it in items], device="cpu")
    for (t, w, scheme, seeds, links, fz), results in zip(items, fused):
        for seed, got in zip(seeds, results):
            ref = ref_fastsim.simulate(t, w, scheme, seed=seed, links=links,
                                       fault=fz)
            assert_same_result(ref, got, f"seed {seed}")
    ofan = [(tree, wl, lbs.ofan(), [0], None, None),
            (tree, wl, lbs.ofan(), [1], None, QUICK)]
    fused = fastsim.simulate_megabatch(
        [tuple(from_reference(x) if j != 3 else x for j, x in enumerate(it))
         for it in ofan], device="cpu")
    for (t, w, scheme, seeds, links, fz), results in zip(ofan, fused):
        ref = ref_fastsim.simulate(t, w, scheme, seed=seeds[0], fault=fz)
        assert_same_result(ref, results[0], "ofan")


def test_mixed_megabatch_loop_matches_reference(point):
    tree, wl = point
    s = _failing_seed(tree)
    static = LinkState.random_failures(tree, 0.15, seed=s)
    items = [(tree, wl, lbs.host_pkt_ar(), CFG, [0], None, None, None),
             (tree, wl, lbs.host_pkt_ar(), CFG, [0, 1], static, 64, None),
             (tree, wl, lbs.host_pkt_ar(), CFG, [0, 1], None, None, FLAP),
             (tree, wl, lbs.host_pkt_ar(), CFG, [0], None, None, BURST)]
    fused = loopsim.simulate_megabatch(
        [tuple(from_reference(x) if j != 4 else x for j, x in enumerate(it))
         for it in items], device="cpu")
    for (t, w, scheme, cfg, seeds, links, g, fz), results in zip(items,
                                                                 fused):
        for seed, got in zip(seeds, results):
            ref = ref_loopsim.simulate(t, w, scheme, cfg, seed=seed,
                                       links=links, g_converge=g, fault=fz)
            assert_same_loop_result(ref, got, f"seed {seed}")
