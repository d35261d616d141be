"""The PyTorch slotted engine's batched entry points: ``simulate_batch``
and ``simulate_megabatch`` equal the port's serial ``simulate`` and the JAX
reference bitwise, across padded flow/packet axes, fused failure and
convergence axes, mixed tree sizes, the int32 wrap of the label draws, and
rows that finish at very different slots (the explicit freeze)."""
import numpy as np
import pytest

from repro.net.topology import FatTree, LinkState
from repro.net import workloads, loopsim as ref_loopsim
from repro.core import lb_schemes as lbs

from repro_torch.interop import from_reference
from repro_torch.net import loopsim

from _torch_compare import assert_same_loop_result
from test_torch_loopsim import both

CFG = ref_loopsim.LoopConfig(max_slots=4000)


def _port_items(items):
    return [tuple(from_reference(v) if j != 4 else v
                  for j, v in enumerate(it)) for it in items]


def _check_mega(items, **kw):
    """Port megabatch == port serial == reference serial, per point."""
    out = loopsim.simulate_megabatch(_port_items(items), device="cpu", **kw)
    for (t, w, sch, c, seeds, l, g), results in zip(items, out):
        assert len(results) == len(seeds)
        for s, res in zip(seeds, results):
            assert res.delivered_slot.shape == (w.n_packets,)
            ref, serial = both(t, w, sch, c, seed=s, links=l, g_converge=g)
            assert_same_loop_result(ref, res, f"{sch.name} seed {s}")
            assert_same_loop_result(serial, res, f"{sch.name} seed {s}")
    return out


@pytest.mark.parametrize("scheme", ["host_pkt", "ofan"])
def test_batch_matches_serial_and_reference(scheme):
    tree = FatTree(4)
    wl = workloads.permutation(tree, 32, np.random.default_rng(1),
                               inter_pod_only=True)
    sch = lbs.by_name(scheme)
    seeds = [0, 1, 2]
    ref = ref_loopsim.simulate_batch(tree, wl, sch, seeds, CFG)
    port = loopsim.simulate_batch(from_reference(tree), from_reference(wl),
                                  from_reference(sch), seeds,
                                  from_reference(CFG), device="cpu")
    for s, r, p in zip(seeds, ref, port):
        assert_same_loop_result(r, p, f"{scheme} seed {s}")
        _, serial = both(tree, wl, sch, CFG, seed=s)
        assert_same_loop_result(serial, p, f"{scheme} seed {s}")


def test_megabatch_pads_flow_and_packet_axes():
    tree = FatTree(4)
    wl_p = workloads.permutation(tree, 32, np.random.default_rng(1),
                                 inter_pod_only=True)
    wl_a = workloads.all_to_all(tree, 2)
    _check_mega([(tree, wl_p, lbs.host_pkt(), CFG, [0, 1], None, None),
                 (tree, wl_a, lbs.host_dr(), CFG, [0], None, None)],
                npk_pad=1024)


def test_megabatch_fuses_failure_and_g_axes():
    tree = FatTree(4)
    wl = workloads.permutation(tree, 32, np.random.default_rng(1),
                               inter_pod_only=True)
    links = LinkState.random_failures(tree, 0.15, seed=11)
    assert links.any_failure()
    cfg_a = ref_loopsim.LoopConfig(max_slots=12000, rto_slots=300, rho=0.8)
    cfg_b = ref_loopsim.LoopConfig(max_slots=9000, rto_slots=300, rho=1.0)
    _check_mega([(tree, wl, lbs.host_pkt_ar(), cfg_a, [0], links, 0),
                 (tree, wl, lbs.host_pkt_ar(), cfg_a, [0], links, None),
                 (tree, wl, lbs.host_pkt_ar(), cfg_b, [0, 1], None, None)])


@pytest.mark.parametrize("scheme", ["jsq", "rsq"])
def test_mixed_k_megabatch(scheme):
    """k=4 and k=6 points padded onto one k=6 engine: in-loop draws are
    keyed on logical ids and padded JSQ ports carry the pad penalty."""
    t4, t6 = FatTree(4), FatTree(6)
    sch = lbs.by_name(scheme)
    _check_mega([(t4, workloads.all_to_all(t4, 1), sch, CFG, [0, 1], None,
                  None),
                 (t6, workloads.permutation(t6, 4, np.random.default_rng(7)),
                  sch, CFG, [0], None, None)], k_pad=6)


@pytest.mark.parametrize("scheme", ["host_pkt_ar", "host_flowlet_ar"])
def test_label_draws_wrap_in_int32(scheme):
    """REPS and PLB on all_to_all(FatTree(6), 1): 2,862 flows, so the label
    draw ``f_draw * 48271`` passes 2**31 and must wrap as int32 does."""
    tree = FatTree(6)
    wl = workloads.all_to_all(tree, 1)
    assert (wl.n_flows * 31 + 1) * 48271 > 2**31
    ref, port = both(tree, wl, lbs.by_name(scheme), CFG, seed=0)
    assert_same_loop_result(ref, port, scheme)


def test_finished_rows_freeze(monkeypatch):
    """Rows that finish at very different slots (message sizes 2 and 64, a
    row cut by max_slots=60) come out the same whether the host loop reads
    the done flags after every slot or every 64 slots, and equal to their
    serial runs."""
    tree = FatTree(4)
    long_wl = workloads.permutation(tree, 64, np.random.default_rng(1),
                                    inter_pod_only=True)
    short_wl = workloads.permutation(tree, 2, np.random.default_rng(2),
                                     inter_pod_only=True)
    cut = ref_loopsim.LoopConfig(max_slots=60)
    items = [(tree, long_wl, lbs.host_pkt(), CFG, [0], None, None),
             (tree, short_wl, lbs.host_pkt(), CFG, [0, 1], None, None),
             (tree, long_wl, lbs.host_pkt(), cut, [2], None, None)]
    runs = []
    for chunk in (1, 64):
        monkeypatch.setattr(loopsim, "CHUNK_SLOTS", chunk)
        runs.append(_check_mega(items))
    for a, b in zip(*runs):
        for ra, rb in zip(a, b):
            assert_same_loop_result(ra, rb)
    assert not runs[0][2][0].finished and runs[0][1][0].finished
    short, long_ = runs[0][1][0].cct_acked_slots, runs[0][0][0].cct_acked_slots
    assert short + 64 < long_


def test_shards_split_the_fused_axis():
    tree = FatTree(4)
    wl = workloads.permutation(tree, 16, np.random.default_rng(5),
                               inter_pod_only=True)
    items = [(tree, wl, lbs.switch_pkt(), CFG, [0, 1, 2], None, None)]
    one = loopsim.simulate_megabatch(_port_items(items), device="cpu")
    two = loopsim.simulate_megabatch(_port_items(items), n_shards=2,
                                     device="cpu")
    for a, b in zip(one[0], two[0]):
        assert_same_loop_result(a, b)


def test_megabatch_rejects_mixed_pipeline_identities():
    tree = from_reference(FatTree(4))
    wl = from_reference(workloads.permutation(FatTree(4), 4,
                                              np.random.default_rng(1)))
    with pytest.raises(ValueError, match="pipeline identities"):
        loopsim.simulate_megabatch(
            [(tree, wl, from_reference(lbs.host_pkt()), loopsim.LoopConfig(),
              [0], None, None),
             (tree, wl, from_reference(lbs.ofan()), loopsim.LoopConfig(),
              [0], None, None)], device="cpu")
