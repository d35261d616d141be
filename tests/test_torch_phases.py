"""Collective-phase schedules in the PyTorch port against the JAX reference:
``from_model`` structure, labels, dict round trip and the compiled
``Workload`` arrays (``flow_start``, ``t_release``), a single phase against
the static path, and phased points on both engines (serial and fused with
unphased points), bitwise.  Also the copies the schedules rest on:
``core/theory``, ``collectives/planner`` and ``configs``."""
import dataclasses
import json

import numpy as np
import pytest

from repro import configs as ref_configs, phases as ref_phases
from repro.collectives import planner as ref_planner
from repro.core import lb_schemes as lbs, theory as ref_theory
from repro.net import fastsim as ref_fastsim, loopsim as ref_loopsim
from repro.net import workloads
from repro.net.topology import FatTree

from repro_torch import configs, phases
from repro_torch.collectives import planner
from repro_torch.core import theory
from repro_torch.interop import from_reference
from repro_torch.net import fastsim, loopsim

from _torch_compare import assert_same_loop_result, assert_same_result

WL_FIELDS = ("src", "dst", "flow", "seq", "t_release", "flow_src",
             "flow_dst", "flow_size", "flow_start")
CP_ARRAYS = ("phase_start", "pkt_lo", "pkt_hi", "iter_of")
# A two-phase schedule for the slotted engine (tests/test_phases.py).
MINI = ref_phases.PhaseSchedule("mini", (
    ref_phases.Phase("a2a", "all_to_all", 1.0, 16),
    ref_phases.Phase("ring", "all_reduce", 1.0, 16, gap_slots=4),
), iterations=2, slack=1.0)


@pytest.fixture(scope="module")
def tree():
    return FatTree(4)


def _model(iterations=2, **kw):
    return ref_phases.PhaseSchedule.from_model("deepseek-v3-671b", ep=8,
                                               dp=8, iterations=iterations,
                                               **kw)


def _same_workload(a, b, tag=""):
    for k in WL_FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), (tag, k)
        if x is not None:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, (tag, k, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=f"{tag} {k}")
    assert a.name == b.name and a.n_hosts == b.n_hosts


def test_configs_theory_and_planner_match_reference():
    assert configs.list_architectures() == ref_configs.list_architectures()
    for name in configs.list_architectures():
        for smoke in (False, True):
            assert dataclasses.asdict(configs.get_config(name, smoke)) == \
                dataclasses.asdict(ref_configs.get_config(name, smoke))
    assert dataclasses.asdict(theory.DEFAULT_NET) == \
        dataclasses.asdict(ref_theory.DEFAULT_NET)
    assert theory.DEFAULT_NET.prop_slots == ref_theory.DEFAULT_NET.prop_slots
    fab, ref_fab = planner.FabricModel(), ref_planner.FabricModel()
    for nbytes in (0.0, 1e3, 1e6, 1e9):
        for n in (1, 8, 64):
            for intra in (False, True):
                for fn in ("plan_all_to_all", "plan_all_reduce"):
                    got = getattr(planner, fn)(nbytes, n, fab,
                                               intra_pod=intra)
                    want = getattr(ref_planner, fn)(nbytes, n, ref_fab,
                                                    intra_pod=intra)
                    assert dataclasses.asdict(got) == \
                        dataclasses.asdict(want), (fn, nbytes, n, intra)


@pytest.mark.parametrize("model,ep,dp", [("deepseek-v3-671b", 8, 8),
                                         ("qwen3-moe-30b-a3b", 4, 16),
                                         ("yi-6b", 1, 8)])
def test_from_model_matches_reference(model, ep, dp):
    want = ref_phases.PhaseSchedule.from_model(model, ep=ep, dp=dp,
                                               iterations=2)
    got = phases.PhaseSchedule.from_model(model, ep=ep, dp=dp, iterations=2)
    assert got == from_reference(want)
    assert got.label() == want.label()
    assert got.to_dict() == want.to_dict()
    assert phases.phases_from_dict(json.loads(json.dumps(got.to_dict()))) \
        == got
    assert phases.phases_from_dict(None) is None
    assert [dataclasses.asdict(p) for p in got.plans()] == \
        [dataclasses.asdict(p) for p in want.plans()]


@pytest.mark.parametrize("sched", ["model", "mini", "degenerate"])
@pytest.mark.parametrize("msg", [0, 4, 8])
def test_compiled_workloads_match_reference(tree, sched, msg):
    s = {"model": _model(), "mini": MINI,
         "degenerate": ref_phases.PhaseSchedule("degen", (
             ref_phases.Phase("solo_a2a", "all_to_all", 1 << 20, 1),
             ref_phases.Phase("no_bytes", "all_reduce", 0.0, 16)))}[sched]
    want = s.compile(tree, msg, rng_seed=1)
    port = from_reference(s)
    got = port.compile(from_reference(tree), msg, rng_seed=1)
    _same_workload(want.workload, got.workload, sched)
    for k in CP_ARRAYS:
        a, b = getattr(want, k), getattr(got, k)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert (got.names, got.impls) == (want.names, want.impls)
    assert port.n_packets(4, msg) == got.workload.n_packets


def test_single_phase_equals_static_on_both_engines(tree):
    s = phases.PhaseSchedule("a2a1", (phases.Phase("a2a", "all_to_all", 1.0,
                                                   tree.n_hosts),))
    t = from_reference(tree)
    wl_ph = s.compile(t, 4).workload
    wl_st = from_reference(workloads.all_to_all(tree, 4))
    for name in ("flow_ecmp", "host_pkt", "ofan", "jsq"):
        scheme = from_reference(lbs.by_name(name))
        assert_same_result(
            fastsim.simulate(t, wl_st, scheme, seed=3, device="cpu"),
            fastsim.simulate(t, wl_ph, scheme, seed=3, device="cpu"), name)
    cfg = loopsim.LoopConfig(max_slots=3000)
    for name in ("host_pkt", "host_pkt_ar"):
        scheme = from_reference(lbs.by_name(name))
        assert_same_loop_result(
            loopsim.simulate(t, wl_st, scheme, cfg, seed=3, device="cpu"),
            loopsim.simulate(t, wl_ph, scheme, cfg, seed=3, device="cpu"),
            name)


@pytest.mark.parametrize("name", ["flow_ecmp", "host_pkt", "host_dr",
                                  "ofan"])
def test_phased_fast_points_match_reference(tree, name):
    wl = _model().compile(tree, 8, rng_seed=1).workload
    ref = ref_fastsim.simulate(tree, wl, lbs.by_name(name), seed=0)
    port = fastsim.simulate(from_reference(tree), from_reference(wl),
                            from_reference(lbs.by_name(name)), seed=0,
                            device="cpu")
    assert_same_result(ref, port, name)


def test_phased_fast_megabatch_matches_reference(tree):
    """Phased and unphased points of two loads fused into one dispatch."""
    wls = [_model().compile(tree, m, rng_seed=1).workload for m in (4, 8)]
    wls.append(workloads.permutation(tree, 8, np.random.default_rng(1)))
    items = [(tree, w, lbs.by_name(n), [0, 1], None)
             for w in wls for n in ("flow_ecmp", "host_pkt", "host_dr")]
    fused = fastsim.simulate_megabatch(
        [tuple(from_reference(x) if j != 3 else x for j, x in enumerate(it))
         for it in items], device="cpu")
    for (t, w, scheme, seeds, _), results in zip(items, fused):
        for seed, got in zip(seeds, results):
            ref = ref_fastsim.simulate(t, w, scheme, seed=seed)
            assert_same_result(ref, got, f"{scheme.name} seed {seed}")


@pytest.mark.parametrize("name,loss", [("host_pkt", "erasure"),
                                       ("ofan", "erasure"),
                                       ("host_pkt_ar", "sack")])
def test_phased_loop_points_match_reference(tree, name, loss):
    wl = MINI.compile(tree, 4, rng_seed=1).workload
    cfg = ref_loopsim.LoopConfig(max_slots=4000, loss=loss)
    ref = ref_loopsim.simulate(tree, wl, lbs.by_name(name), cfg, seed=0)
    port = loopsim.simulate(from_reference(tree), from_reference(wl),
                            from_reference(lbs.by_name(name)),
                            from_reference(cfg), seed=0, device="cpu")
    assert_same_loop_result(ref, port, name)
    ds = port.delivered_slot
    start = np.asarray(wl.flow_start)[np.asarray(wl.flow)]
    assert (ds[ds >= 0] > start[ds >= 0]).all()     # the phase gate holds


def test_phased_loop_megabatch_matches_reference(tree):
    wl_ph = MINI.compile(tree, 4, rng_seed=1).workload
    wl_st = workloads.permutation(tree, 4, np.random.default_rng(1))
    cfg = ref_loopsim.LoopConfig(max_slots=4000)
    items = [(tree, wl_ph, lbs.host_pkt(), cfg, [0, 1], None, None),
             (tree, wl_st, lbs.host_pkt(), cfg, [0], None, None)]
    fused = loopsim.simulate_megabatch(
        [tuple(from_reference(x) if j != 4 else x for j, x in enumerate(it))
         for it in items], device="cpu")
    for (t, w, scheme, c, seeds, _, _), results in zip(items, fused):
        for seed, got in zip(seeds, results):
            ref = ref_loopsim.simulate(t, w, scheme, c, seed=seed)
            assert_same_loop_result(ref, got, f"seed {seed}")
