"""The PyTorch fast engine's batched entry points against the JAX reference:
``simulate_batch`` and ``simulate_megabatch`` (mixed tree sizes, packet
padding, JSQ pad-overflow retry, batch split into shards), bitwise."""
import numpy as np
import pytest

from repro.net.topology import FatTree, LinkState
from repro.net import workloads, fastsim as ref_fastsim
from repro.core import lb_schemes as lbs
from repro.obs.probes import ProbeSpec

from repro_torch.interop import from_reference
from repro_torch.net import fastsim

from _torch_compare import assert_same_result

ALL_FAST = ["flow_ecmp", "subflow_mptcp", "host_pkt", "switch_pkt",
            "switch_pkt_ar", "simple_rr", "jsq", "rsq", "host_dr", "ofan"]

# Megabatch groups: schemes of one group share one pipeline shape.
GROUPS = [("flow_ecmp", "subflow_mptcp", "host_pkt", "host_dr"),
          ("switch_pkt",), ("switch_pkt_ar",), ("simple_rr",), ("jsq",),
          ("rsq",), ("ofan",)]


def _perm(k, m, seed):
    tree = FatTree(k)
    return tree, workloads.permutation(tree, m, np.random.default_rng(seed),
                                       inter_pod_only=True)


def _port_items(items):
    return [tuple(from_reference(x) if j != 3 else list(x)
                  for j, x in enumerate(it)) for it in items]


@pytest.mark.parametrize("scheme", ALL_FAST)
def test_simulate_batch_matches_reference(scheme):
    tree, wl = _perm(4, 32, 1)
    s = lbs.by_name(scheme)
    ref = ref_fastsim.simulate_batch(tree, wl, s, [0, 1, 2])
    port = fastsim.simulate_batch(from_reference(tree), from_reference(wl),
                                  from_reference(s), [0, 1, 2], device="cpu")
    for seed, r, p in zip((0, 1, 2), ref, port):
        assert_same_result(r, p, f"{scheme}/seed{seed}")


@pytest.mark.parametrize("group", GROUPS, ids=lambda g: "+".join(g))
def test_megabatch_mixed_k_matches_reference(group):
    """k=4 and k=6 points of one shape group fused on a k=6 tree, packet
    arrays padded past the largest member, one failure pattern."""
    t4, w4 = _perm(4, 32, 1)
    t6, w6 = _perm(6, 16, 2)
    links = LinkState.random_failures(t4, 0.15, seed=5)
    items = []
    for i, name in enumerate(group):
        s = lbs.by_name(name)
        items.append((t4, w4, s, [0, 1], None))
        items.append((t6, w6, s, [3], None))
        if i == 0:
            items.append((t4, w4, s, [2], links))
    npk_pad = max(w4.n_packets, w6.n_packets) + 100
    ref = ref_fastsim.simulate_megabatch(items, npk_pad=npk_pad, k_pad=6)
    port = fastsim.simulate_megabatch(_port_items(items), npk_pad=npk_pad,
                                      k_pad=6, device="cpu")
    for it, rs, ps in zip(items, ref, port):
        for seed, r, p in zip(it[3], rs, ps):
            assert_same_result(r, p, f"{it[2].name}/k{it[0].k}/seed{seed}")


@pytest.mark.parametrize("scheme", ["jsq", "switch_pkt_ar"])
def test_jsq_pad_overflow_retry_matches_reference(scheme):
    """A small ``jsq_pad_factor`` makes the first run overflow its JSQ grid;
    every entry point retries with a doubled pad exactly as the reference."""
    tree, wl = _perm(4, 64, 3)
    s = lbs.by_name(scheme)
    factor = 0.5
    t, w, sp = from_reference(tree), from_reference(wl), from_reference(s)
    plan = fastsim._prepare(t, w, sp, 12.0, None, "auto", factor)
    ref = ref_fastsim.simulate(tree, wl, s, seed=0, jsq_pad_factor=factor)
    port = fastsim.simulate(t, w, sp, seed=0, jsq_pad_factor=factor,
                            device="cpu")
    assert_same_result(ref, port, "simulate")
    # The first run overflowed: some agg switch took more arrivals than the
    # pad it was given.
    inter = t.host_pod(w.src) != t.host_pod(w.dst)
    agg = t.host_pod(w.src)[inter] * t.half + port.a_used[inter]
    assert np.bincount(agg).max() > plan.pad_a

    ref_b = ref_fastsim.simulate_batch(tree, wl, s, [0, 1],
                                       jsq_pad_factor=factor)
    port_b = fastsim.simulate_batch(t, w, sp, [0, 1], jsq_pad_factor=factor,
                                    device="cpu")
    for r, p in zip(ref_b, port_b):
        assert_same_result(r, p, "simulate_batch")
    items = [(tree, wl, s, [1], None), (tree, wl, s, [0], None)]
    ref_m = ref_fastsim.simulate_megabatch(items, jsq_pad_factor=factor)
    port_m = fastsim.simulate_megabatch(_port_items(items),
                                        jsq_pad_factor=factor, device="cpu")
    for rs, ps in zip(ref_m, port_m):
        assert_same_result(rs[0], ps[0], "simulate_megabatch")


def test_megabatch_probes_and_shards_match_reference():
    """Probes on, and the fused axis cut into two shards (both on the CPU
    here): results equal the reference and do not depend on the split."""
    t4, w4 = _perm(4, 32, 1)
    probes = ProbeSpec(stride=8, samples=32)
    items = [(t4, w4, lbs.ofan(), [0, 1, 2], None)]
    ref = ref_fastsim.simulate_megabatch(items, probes=probes)
    port_items = _port_items(items)
    one = fastsim.simulate_megabatch(port_items, probes=from_reference(probes),
                                     device="cpu")
    two = fastsim.simulate_megabatch(port_items, probes=from_reference(probes),
                                     n_shards=2, device="cpu")
    auto = fastsim.simulate_megabatch(port_items,
                                      probes=from_reference(probes),
                                      n_shards="auto", device="cpu")
    for r, a, b, c in zip(ref[0], one[0], two[0], auto[0]):
        assert_same_result(r, a, "n_shards=1")
        assert_same_result(r, b, "n_shards=2")
        assert_same_result(r, c, "n_shards=auto")


def test_megabatch_rejects_mixed_shapes_and_empty():
    t4, w4 = _perm(4, 8, 1)
    items = [(t4, w4, lbs.host_pkt(), [0], None),
             (t4, w4, lbs.ofan(), [0], None)]
    with pytest.raises(ValueError):
        fastsim.simulate_megabatch(_port_items(items), device="cpu")
    assert fastsim.simulate_megabatch([], device="cpu") == []
    empty = _port_items([(t4, w4, lbs.ofan(), [], None)])
    assert fastsim.simulate_megabatch(empty, device="cpu") == [[]]
