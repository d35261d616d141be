"""The PyTorch fast engine against the JAX reference: serial ``simulate``,
bitwise, for the ten fast schemes, static failures, probes and empty
workloads, plus the JSQ scan where the FMA rounding lives."""
from fractions import Fraction

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.net.topology import FatTree, LinkState
from repro.net import workloads, fastsim as ref_fastsim
from repro.core import lb_schemes as lbs
from repro.core import entropy as ref_ent
from repro.obs.probes import ProbeSpec

from repro_torch.interop import from_reference
from repro_torch.net import fastsim
from repro_torch.kernels.jsq_scan import ref as jsq_ref

from _torch_compare import assert_same_result

ALL_FAST = ["flow_ecmp", "subflow_mptcp", "host_pkt", "switch_pkt",
            "switch_pkt_ar", "simple_rr", "jsq", "rsq", "host_dr", "ofan"]


def _point(kind):
    if kind == "perm_k4":
        tree = FatTree(4)
        return tree, workloads.permutation(tree, 32, np.random.default_rng(1),
                                           inter_pod_only=True)
    tree = FatTree(6)
    return tree, workloads.all_to_all(tree, 4)


def _both(tree, wl, scheme, **kw):
    ref = ref_fastsim.simulate(tree, wl, scheme, **kw)
    conv = {k: from_reference(v) for k, v in kw.items()}
    port = fastsim.simulate(from_reference(tree), from_reference(wl),
                            from_reference(scheme), device="cpu", **conv)
    return ref, port


@pytest.mark.parametrize("kind", ["perm_k4", "a2a_k6"])
@pytest.mark.parametrize("scheme", ALL_FAST)
def test_simulate_matches_reference(kind, scheme):
    tree, wl = _point(kind)
    ref, port = _both(tree, wl, lbs.by_name(scheme), seed=0)
    assert_same_result(ref, port, f"{kind}/{scheme}")


@pytest.mark.parametrize("scheme", ["flow_ecmp", "host_pkt", "host_dr",
                                    "switch_pkt", "jsq", "ofan"])
def test_static_failures_match_reference(scheme):
    tree = FatTree(4)
    wl = workloads.permutation(tree, 32, np.random.default_rng(4),
                               inter_pod_only=True)
    links = LinkState.random_failures(tree, 0.15, seed=3)
    assert links.any_failure()
    ref, port = _both(tree, wl, lbs.by_name(scheme), seed=2, links=links)
    assert_same_result(ref, port, scheme)


@pytest.mark.parametrize("scheme", ["host_pkt", "switch_pkt_ar", "ofan"])
def test_probes_match_reference(scheme):
    tree, wl = _point("perm_k4")
    ref, port = _both(tree, wl, lbs.by_name(scheme), seed=1,
                      probes=ProbeSpec(stride=8, samples=64))
    assert_same_result(ref, port, scheme)
    assert port.probe.series.max() == port.max_queue


def test_zero_packet_workload_matches_reference():
    tree = FatTree(4)
    wl = workloads.permutation(tree, 0, np.random.default_rng(1))
    assert wl.n_packets == 0 and wl.n_flows > 0
    for name in ("host_pkt", "flow_ecmp", "jsq", "ofan", "host_dr"):
        ref, port = _both(tree, wl, lbs.by_name(name), seed=0)
        assert_same_result(ref, port, name)
        assert port.cct == 0.0 and port.delivery.shape == (0,)
        assert (port.flow_completion == 0.0).all()


def _jsq_inputs(seed, n_sw, npk, h):
    rng = np.random.default_rng(seed)
    switch = rng.integers(0, n_sw, npk).astype(np.int32)
    a = (rng.integers(0, npk // 4, npk)
         + rng.random(npk)).astype(np.float32)
    tie = rng.random(npk).astype(np.float32)
    active = rng.random(npk) < 0.9
    pad = int(np.bincount(switch[active], minlength=n_sw).max())
    noise = ref_ent.uniform_grid(seed, ref_ent.SITE_FAST_AGG_JSQ, n_sw, pad, h)
    return switch, a, tie, active, pad, noise


@pytest.mark.parametrize("quanta", [None, (0.05, 0.10, 0.20)])
def test_jsq_scan_matches_reference_jsq_layer(quanta):
    """The plain JSQ scan through ``_jsq_layer`` against the reference's
    ``lax.scan``: ports, departures, occupancies and the deepest rank."""
    n_sw, npk, h, h_log = 6, 3000, 4, 3
    switch, a, tie, active, pad, noise = _jsq_inputs(7, n_sw, npk, h)
    kw = dict(n_switches=n_sw, pad=pad, h=h, quanta=quanta, buffer_pkts=40)
    ref = ref_fastsim._jsq_layer(
        jnp.asarray(switch), jnp.asarray(a), jnp.asarray(tie),
        jnp.asarray(active), h_log=jnp.int32(h_log), noise=jnp.asarray(noise),
        backend="auto", **kw)
    t = torch.from_numpy
    port = fastsim._jsq_layer(
        t(switch)[None], t(a)[None], t(tie)[None], t(active)[None],
        h_log=torch.tensor([h_log], dtype=torch.int32),
        noise=t(noise)[None], backend="auto", **kw)
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(np.asarray(r), p[0].numpy())
    assert int(port[0].max()) < h_log         # padded port never elected


@pytest.mark.parametrize("quanta", [None, (0.05, 0.10, 0.20)])
def test_jsq_scan_matches_reference_jsq_layer_at_33_ports(quanta):
    """More ports than a warp has lanes (the CUDA scan walks ports l,
    l + 32, ...): the plain scan through ``_jsq_layer`` against the
    reference's ``lax.scan``, bitwise, with padded ports past ``h_log``."""
    n_sw, npk, h, h_log = 3, 6000, 33, 31
    switch, a, tie, active, pad, noise = _jsq_inputs(9, n_sw, npk, h)
    kw = dict(n_switches=n_sw, pad=pad, h=h, quanta=quanta, buffer_pkts=40)
    ref = ref_fastsim._jsq_layer(
        jnp.asarray(switch), jnp.asarray(a), jnp.asarray(tie),
        jnp.asarray(active), h_log=jnp.int32(h_log), noise=jnp.asarray(noise),
        backend="auto", **kw)
    t = torch.from_numpy
    port = fastsim._jsq_layer(
        t(switch)[None], t(a)[None], t(tie)[None], t(active)[None],
        h_log=torch.tensor([h_log], dtype=torch.int32),
        noise=t(noise)[None], backend="auto", **kw)
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(np.asarray(r), p[0].numpy())
    assert int(port[0].max()) < h_log         # padded ports never elected


def test_jsq_score_is_one_rounding_like_xla():
    """``qlen + nz * 1e-3`` (fastsim.py:228): XLA on the CPU contracts it
    into a fused multiply-add; ``fma32`` gives the same bits and the
    separately rounded float32 expression does not."""
    rng = np.random.default_rng(0)
    n = 1 << 20
    q = rng.integers(0, 4096, n).astype(np.float32)
    nz = rng.integers(0, 1 << 24, n).astype(np.float32) * np.float32(2**-24)
    xla = np.asarray(jax.jit(lambda q, n: q + n * 1e-3)(q, nz))
    port = jsq_ref.fma32(torch.from_numpy(nz), 1e-3,
                         torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(port, xla)
    separate = q + nz * np.float32(1e-3)
    assert (separate != xla).any()


def _round_f32(exact: Fraction) -> np.float32:
    """Round a rational to the nearest float32, ties to even."""
    x = np.float32(float(exact))
    cands = [np.nextafter(x, np.float32(-np.inf)), x,
             np.nextafter(x, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - exact),
                                     int(np.array(c).view(np.int32)) & 1))


def _check_fma32(a, b, c):
    got = jsq_ref.fma32(torch.from_numpy(a), b, torch.from_numpy(c)).numpy()
    fb = Fraction(float(np.float32(b)))
    want = np.array([_round_f32(Fraction(float(x)) * fb + Fraction(float(y)))
                     for x, y in zip(a, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    return want


def test_fma32_is_correctly_rounded():
    """Against exact rational arithmetic: random JSQ-like pairs, and pairs
    whose float64 sum lands exactly on a float32 midpoint, where rounding
    the float64 sum again to float32 would be wrong."""
    rng = np.random.default_rng(1)
    _check_fma32(rng.random(3000).astype(np.float32), 1e-3,
                 rng.integers(0, 1 << 20, 3000).astype(np.float32))
    # b = 1 - 2**-15 and a = 2**(k-24) * (1 + 2**-15) make a * b half a
    # float32 ulp of c (in [2**k, 2**(k+1))) less 2**(k-54): the float64
    # sum is the midpoint and the exact sum lies just below it.
    b = 1.0 - 2.0**-15
    a, c = [], []
    for k in range(-6, 12):
        for i in range(40):
            a.append(2.0**(k - 24) * (1 + 2.0**-15))
            c.append(2.0**k * (1 + i * 2.0**-23))
    a, c = np.array(a, np.float32), np.array(c, np.float32)
    want = _check_fma32(a, b, c)
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (twice != want).sum() == len(want) // 2   # every odd-mantissa c


def test_entry_points_validate_arguments():
    tree, wl = _point("perm_k4")
    t, w = from_reference(tree), from_reference(wl)
    with pytest.raises(ValueError):
        fastsim.simulate(t, w, from_reference(lbs.host_pkt()),
                         backend="xla", device="cpu")
    with pytest.raises(ValueError):
        fastsim.simulate(t, w, from_reference(lbs.by_name("host_pkt_ar")),
                         device="cpu")
