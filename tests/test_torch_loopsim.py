"""The PyTorch slotted engine against the JAX reference: serial
``simulate``, bitwise, for the twelve schemes, MSwift, static failures with
finite and infinite convergence time, probes and empty workloads."""
import numpy as np
import pytest

from repro.net.topology import FatTree, LinkState, rho_max
from repro.net import workloads, loopsim as ref_loopsim
from repro.core import lb_schemes as lbs
from repro.obs.probes import ProbeSpec

from repro_torch.faults import FaultSchedule
from repro_torch.interop import from_reference
from repro_torch.net import loopsim

from _torch_compare import assert_same_loop_result

ALL_SCHEMES = ["flow_ecmp", "subflow_mptcp", "host_flowlet_ar", "host_pkt",
               "switch_pkt", "host_pkt_ar", "switch_pkt_ar", "simple_rr",
               "jsq", "rsq", "host_dr", "ofan"]
CFG = ref_loopsim.LoopConfig(max_slots=4000)


def _perm_k4():
    tree = FatTree(4)
    return tree, workloads.permutation(tree, 32, np.random.default_rng(1),
                                       inter_pod_only=True)


def both(tree, wl, scheme, cfg, **kw):
    """The reference's serial ``simulate`` and the port's, on the CPU."""
    ref = ref_loopsim.simulate(tree, wl, scheme, cfg, **kw)
    conv = {k: from_reference(v) for k, v in kw.items()}
    port = loopsim.simulate(from_reference(tree), from_reference(wl),
                            from_reference(scheme), from_reference(cfg),
                            device="cpu", **conv)
    return ref, port


@pytest.mark.parametrize("scheme", ALL_SCHEMES)
def test_simulate_matches_reference(scheme):
    tree, wl = _perm_k4()
    ref, port = both(tree, wl, lbs.by_name(scheme), CFG, seed=0)
    assert_same_loop_result(ref, port, scheme)
    assert port.finished


@pytest.mark.parametrize("scheme,seed", [("jsq", 2**31 + 7),
                                         ("rsq", 2**40 + 3)])
def test_key_words_past_int32_match_reference(scheme, seed):
    """Seeds whose uint32 key words pass 2**31 (the in-loop draws carry
    them as int32 bit patterns)."""
    tree, wl = _perm_k4()
    ref, port = both(tree, wl, lbs.by_name(scheme), CFG, seed=seed)
    assert_same_loop_result(ref, port, scheme)


@pytest.mark.parametrize("scheme", ["host_pkt", "ofan"])
def test_mswift_matches_reference(scheme):
    tree = FatTree(4)
    wl = workloads.permutation(tree, 96, np.random.default_rng(3),
                               inter_pod_only=True)
    cfg = ref_loopsim.LoopConfig(cca="mswift", max_slots=8000,
                                 sw_target_slots=80.0)
    ref, port = both(tree, wl, lbs.by_name(scheme), cfg, seed=1)
    assert_same_loop_result(ref, port, scheme)
    assert port.mean_cwnd != 300.0          # the window moved


def _failures():
    tree, wl = _perm_k4()
    # seed 11: the first draw at p = 0.15 that leaves every flow of this
    # workload connected (rho_max 0.6; seed 3 disconnects one, rho_max 0).
    links = LinkState.random_failures(tree, 0.15, seed=11)
    assert links.any_failure()
    rho = float(rho_max(tree, links, wl.flow_src, wl.flow_dst))
    assert 0.0 < rho < 1.0
    return tree, wl, links, ref_loopsim.LoopConfig(
        max_slots=12000, rho=rho, rto_slots=300)


@pytest.mark.parametrize("g", [None, 0, 86])
@pytest.mark.parametrize("scheme", ["host_pkt_ar", "switch_pkt_ar", "ofan"])
def test_static_failures_match_reference(scheme, g):
    tree, wl, links, cfg = _failures()
    ref, port = both(tree, wl, lbs.by_name(scheme), cfg, seed=2,
                     links=links, g_converge=g)
    assert_same_loop_result(ref, port, f"{scheme} G={g}")
    assert port.drops > 0 or g == 0


@pytest.mark.parametrize("scheme", ["host_pkt", "switch_pkt_ar", "ofan"])
def test_probes_match_reference(scheme):
    tree, wl = _perm_k4()
    ref, port = both(tree, wl, lbs.by_name(scheme), CFG, seed=1,
                     probes=ProbeSpec(stride=8, samples=16))
    assert_same_loop_result(ref, port, scheme)
    assert port.probe.series.max() == port.max_queue


def test_zero_packet_workload_matches_reference():
    tree = FatTree(4)
    wl = workloads.permutation(tree, 0, np.random.default_rng(1))
    assert wl.n_packets == 0 and wl.n_flows > 0
    cfg = ref_loopsim.LoopConfig(max_slots=500)
    for name in ("host_pkt", "jsq"):
        ref, port = both(tree, wl, lbs.by_name(name), cfg, seed=0)
        assert_same_loop_result(ref, port, name)
        assert port.cct_slots == 0.0 and port.finished


def test_mixed_zero_flows_match_reference():
    tree = FatTree(4)
    fsize = np.array([3, 0, 2, 0, 1, 4, 0, 2])
    src = np.arange(8)
    dst = (np.arange(8) + 3) % tree.n_hosts
    wl = workloads._packets_from_flows("mix", tree.n_hosts, src, dst, fsize)
    ref, port = both(tree, wl, lbs.host_pkt(),
                     ref_loopsim.LoopConfig(max_slots=500), seed=0)
    assert_same_loop_result(ref, port)
    assert (port.flow_complete_slot[fsize == 0] == 0).all()


def test_unported_paths_raise():
    """What the port rejects: the reference's body names, an unknown loss
    model, and a fault schedule beside static links or ``g_converge``."""
    tree, wl = _perm_k4()
    t, w = from_reference(tree), from_reference(wl)
    s = from_reference(lbs.host_pkt())
    with pytest.raises(ValueError, match="loss"):
        loopsim.simulate(t, w, s, loopsim.LoopConfig(loss="arq"),
                         device="cpu")
    with pytest.raises(ValueError, match="fault"):
        loopsim.simulate(t, w, s, fault=FaultSchedule.flap(), g_converge=8,
                         device="cpu")
    with pytest.raises(ValueError):
        loopsim.simulate(t, w, s, loopsim.LoopConfig(impl="lax"),
                         device="cpu")
    for impl in ("lax", "pallas", "auto"):
        cfg = from_reference(ref_loopsim.LoopConfig(impl=impl, rho=0.5))
        assert cfg.impl == "auto" and cfg.rho == 0.5
    assert loopsim.simulate_batch(t, w, s, [], device="cpu") == []
