"""The port's host-side inputs against the JAX reference for the same
seeds: topology, failures, workloads, host label draws, OFAN tables,
entropy streams, tree padding maps and the torch batching helpers."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.net import topology as r_topo, workloads as r_wl
from repro.net import _batching as r_bat
from repro.core import lb_schemes as r_lbs, ofan as r_ofan, entropy as r_ent
from repro.obs import probes as r_probes

from repro_torch.net import topology as t_topo, workloads as t_wl
from repro_torch.net import _batching as t_bat
from repro_torch.core import lb_schemes as t_lbs, ofan as t_ofan
from repro_torch.core import entropy as t_ent
from repro_torch.obs import probes as t_probes
from repro_torch.interop import from_reference


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [4, 6])
def test_fat_tree_and_failures(k):
    rt, tt = r_topo.FatTree(k), t_topo.FatTree(k)
    assert rt.layer_sizes() == tt.layer_sizes()
    rng = np.random.default_rng(k)
    src = rng.integers(0, rt.n_hosts, 200)
    dst = rng.integers(0, rt.n_hosts, 200)
    ac = rng.integers(0, k // 2, 200)
    sc = rng.integers(0, k // 2, 200)
    _eq(rt.stage_queues(src, dst, ac, sc), tt.stage_queues(src, dst, ac, sc))
    _eq(rt.n_hops(src, dst), tt.n_hops(src, dst))
    for kw in ({"seed": 3}, {}):
        if kw:
            rl = r_topo.LinkState.random_failures(rt, 0.2, **kw)
            tl = t_topo.LinkState.random_failures(tt, 0.2, **kw)
        else:
            rl = r_topo.LinkState.random_failures(
                rt, 0.2, np.random.default_rng(9))
            tl = t_topo.LinkState.random_failures(
                tt, 0.2, np.random.default_rng(9))
        _eq(rl.ea, tl.ea)
        _eq(rl.ac, tl.ac)
        for s, d in zip(src[:20], dst[:20]):
            _eq(rl.path_matrix(int(s), int(d)), tl.path_matrix(int(s), int(d)))
        assert (r_topo.rho_max(rt, rl, src[:30], dst[:30])
                == t_topo.rho_max(tt, tl, src[:30], dst[:30]))
        _eq(from_reference(rl).ea, rl.ea)


def _same_workload(a, b):
    for f in ("src", "dst", "flow", "seq", "t_release", "flow_src",
              "flow_dst", "flow_size"):
        _eq(getattr(a, f), getattr(b, f))
    assert (a.name, a.n_hosts) == (b.name, b.n_hosts)


@pytest.mark.parametrize("k", [4, 6])
def test_workloads(k):
    rt, tt = r_topo.FatTree(k), t_topo.FatTree(k)
    for inter in (False, True):
        _same_workload(
            r_wl.permutation(rt, 16, np.random.default_rng(2), inter),
            t_wl.permutation(tt, 16, np.random.default_rng(2), inter))
    _same_workload(r_wl.all_to_all(rt, 3), t_wl.all_to_all(tt, 3))
    _same_workload(r_wl.fsdp_rings(rt, 2, 8, np.random.default_rng(5)),
                   t_wl.fsdp_rings(tt, 2, 8, np.random.default_rng(5)))
    sizes = np.array([3, 0, 2, 0, 1, 4, 0, 2])
    src, dst = np.arange(8), (np.arange(8) + 3) % rt.n_hosts
    _same_workload(r_wl._packets_from_flows("mix", rt.n_hosts, src, dst, sizes),
                   t_wl._packets_from_flows("mix", tt.n_hosts, src, dst, sizes))
    wl = r_wl.all_to_all(rt, 2)
    _same_workload(wl, from_reference(wl))


@pytest.mark.parametrize("name", ["flow_ecmp", "subflow_mptcp", "host_pkt",
                                  "host_dr"])
@pytest.mark.parametrize("failures", [False, True])
def test_precompute_host_choices(name, failures):
    rt, tt = r_topo.FatTree(4), t_topo.FatTree(4)
    wl = r_wl.permutation(rt, 12, np.random.default_rng(1))
    pv = None
    if failures:
        links = r_topo.LinkState.random_failures(rt, 0.3, seed=1)
        pv = np.stack([links.path_matrix(int(s), int(d))
                       for s, d in zip(wl.flow_src, wl.flow_dst)])
    args = (wl.flow, wl.seq, wl.flow_src, wl.flow_dst)
    ra, rc = r_lbs.precompute_host_choices(
        r_lbs.by_name(name), rt, *args, np.random.default_rng(4),
        path_valid=pv)
    ta, tc = t_lbs.precompute_host_choices(
        t_lbs.by_name(name), tt, *args, np.random.default_rng(4),
        path_valid=pv)
    _eq(ra, ta)
    _eq(rc, tc)


def test_scheme_descriptors():
    for name in ("flow_ecmp", "subflow_mptcp", "host_flowlet_ar", "host_pkt",
                 "switch_pkt", "host_pkt_ar", "switch_pkt_ar", "simple_rr",
                 "jsq", "rsq", "host_dr", "ofan"):
        r, t = r_lbs.by_name(name), t_lbs.by_name(name)
        assert r.shape_key() == t.shape_key()
        assert r.table_keys() == t.table_keys()
        assert r.needs_feedback == t.needs_feedback
        assert from_reference(r) == t
    spec = r_probes.ProbeSpec(stride=4, samples=16)
    assert from_reference(spec) == t_probes.ProbeSpec(4, 16)
    assert t_probes.probe_shape((8, 0)) == r_probes.probe_shape((8, 0))
    with pytest.raises(TypeError):
        from_reference(object())


@pytest.mark.parametrize("k", [4, 6])
@pytest.mark.parametrize("p_fail", [0.0, 0.25])
def test_ofan_tables(k, p_fail):
    rt, tt = r_topo.FatTree(k), t_topo.FatTree(k)
    rl = r_topo.LinkState.random_failures(rt, p_fail, seed=2)
    tl = from_reference(rl)
    r = r_ofan.build_tables(rt, np.random.default_rng(6), links=rl)
    t = t_ofan.build_tables(tt, np.random.default_rng(6), links=tl)
    for f in ("edge_orders", "edge_starts", "edge_len", "agg_orders",
              "agg_starts", "agg_len"):
        _eq(getattr(r, f), getattr(t, f))


def test_entropy_streams():
    for seed in (0, 7, 2**40 + 3):
        assert r_ent.key_words(seed) == t_ent.key_words(seed)
        for site in (t_ent.SITE_FAST_EDGE_JSQ, t_ent.SITE_FAST_AGG_JSQ):
            _eq(r_ent.uniform_grid(seed, site, 5, 17, 3),
                t_ent.uniform_grid(seed, site, 5, 17, 3))
    lo, hi = t_ent.key_words(11)
    ids = np.arange(100, dtype=np.uint32)
    _eq(r_ent.draw_int(lo, hi, 1, ids, 3, 7), t_ent.draw_int(lo, hi, 1, ids,
                                                           3, 7))
    _eq(r_ent.threefry2x32(*(np.uint32(x) for x in (1, 2, 3, 4))),
        t_ent.threefry2x32(*(np.uint32(x) for x in (1, 2, 3, 4))))


def test_tree_padding_helpers():
    for n in (-3, 0, 1, 2, 3, 5, 1024, 1025):
        assert t_bat.pow2_bucket(n) == r_bat.pow2_bucket(n)
    assert t_bat.pow2_bucket(0) == 1 and t_bat.pow2_bucket(-1) == 1
    for trees in ([4], [4, 6, 8], [4, 8, 16, 20], [6, 4, 6]):
        assert t_bat.k_buckets(trees) == r_bat.k_buckets(trees)
    for k, kp in ((4, 4), (4, 6), (6, 8), (4, 12)):
        rp = r_bat.TreePad(r_topo.FatTree(k), r_topo.FatTree(kp))
        tp = t_bat.TreePad(t_topo.FatTree(k), t_topo.FatTree(kp))
        assert rp.noop == tp.noop
        for f in ("switch", "mid", "edge_pair", "agg_pod"):
            _eq(getattr(rp, f), getattr(tp, f))
    with pytest.raises(ValueError):
        t_bat.TreePad(t_topo.FatTree(6), t_topo.FatTree(4))
    x = np.arange(6).reshape(2, 3)
    _eq(r_bat.pad_tail(x, 1, 5, fill=-1), t_bat.pad_tail(x, 1, 5, fill=-1))
    for a, b in zip(r_bat.pad_to_group_max([x, np.ones((3, 1), int)]),
                    t_bat.pad_to_group_max([x, np.ones((3, 1), int)])):
        _eq(a, b)
    st = {"a": np.arange(3), "t": (np.ones((3, 2)),)}
    r = r_bat.shard_pad(st, 3, 2)
    t = t_bat.shard_pad(st, 3, 2)
    _eq(r["a"], t["a"])
    _eq(r["t"][0], t["t"][0])
    assert t_bat.shard_pad(st, 3, 1) is st


@pytest.mark.parametrize("h,h_log", [(4, 4), (4, 2), (6, 3)])
def test_port_pad_penalty(h, h_log):
    ref = np.asarray(r_bat.port_pad_penalty(h, jnp.int32(h_log)))
    got = t_bat.port_pad_penalty(h, torch.tensor([h_log, h], dtype=torch.int32))
    assert got.dtype == torch.float32
    _eq(got[0].numpy(), ref)
    _eq(got[1].numpy(), np.zeros(h, np.float32))


@pytest.mark.parametrize("m", [0, 1, 37, 500])
def test_rank_by(m):
    rng = np.random.default_rng(m)
    keys = rng.integers(0, 6, m).astype(np.int32)
    valid = rng.random(m) < 0.7
    got = t_bat.rank_by(torch.from_numpy(keys), torch.from_numpy(valid))
    if m:
        ref = np.asarray(r_bat.rank_by(jnp.asarray(keys), jnp.asarray(valid)))
        _eq(got.numpy(), ref)
    else:
        assert got.shape == (0,)
    batched = t_bat.rank_by(torch.from_numpy(np.stack([keys, keys[::-1]])),
                            torch.from_numpy(np.stack([valid, valid[::-1]])))
    _eq(batched[0].numpy(), got.numpy())


def test_threefry_torch_known_answers():
    """The torch Threefry against JAX's own ``threefry_2x32`` (the
    known-answer test of ``tests/test_entropy.py``) and the numpy half."""
    from jax._src import prng as jprng
    rng = np.random.default_rng(0)
    for _ in range(8):
        k = rng.integers(0, 2**32, 2, dtype=np.uint32)
        c = rng.integers(0, 2**32, 64, dtype=np.uint32)
        ref = np.asarray(jprng.threefry_2x32(k, c))
        x0, x1 = t_ent.threefry2x32_torch(
            *(torch.from_numpy(np.asarray(v).astype(np.int64))
              for v in (k[0], k[1], c[:32], c[32:])))
        _eq(np.concatenate([x0.numpy(), x1.numpy()]).astype(np.uint32), ref)


@pytest.mark.parametrize("seed", [0, 11, 2**40 + 3])
def test_entropy_torch_streams(seed):
    """draw_u32/draw_int/draw_uniform in torch equal the reference on grids
    of ids, slots and lanes, ids >= 2**31 and negative int32 ids included
    (both take them mod 2**32)."""
    lo, hi = r_ent.key_words(seed)
    ids = np.concatenate([np.arange(300), [2**31 - 1, 2**31, 2**32 - 1]])
    slots = np.array([0, 1, 77, 4095])
    for site in (t_ent.SITE_EDGE_RAND, t_ent.SITE_AGG_JSQ):
        i3, s3, l3 = ids[:, None, None], slots[None, :, None], np.arange(
            4)[None, None, :]
        ref = r_ent.draw_u32(lo, hi, site, i3.astype(np.uint32),
                             s3.astype(np.uint32),
                             lane=l3.astype(np.uint32))
        got = t_ent.draw_u32_torch(
            torch.tensor(int(lo)), torch.tensor(int(hi)), site,
            torch.from_numpy(i3), torch.from_numpy(s3),
            lane=torch.from_numpy(l3))
        _eq(got.numpy().astype(np.uint32), ref)
        _eq(t_ent.draw_uniform_torch(lo, hi, site, torch.from_numpy(i3), 5,
                                     lane=torch.from_numpy(l3)).numpy(),
            r_ent.draw_uniform(lo, hi, site, i3.astype(np.uint32), 5,
                               lane=l3.astype(np.uint32)))
        bound = np.array([[3], [9]] * 150 + [[4]] * 3)[:, :, None]
        _eq(t_ent.draw_int_torch(lo, hi, site, torch.from_numpy(i3), 9,
                                 torch.from_numpy(bound)).numpy(),
            r_ent.draw_int(lo, hi, site, i3.astype(np.uint32), 9,
                           bound.astype(np.uint32)))
    neg = torch.tensor([-1, -5], dtype=torch.int32)
    _eq(t_ent.draw_u32_torch(lo, hi, 1, neg, 3).numpy().astype(np.uint32),
        r_ent.draw_u32(lo, hi, 1, np.array([-1, -5], np.int32)
                       .astype(np.uint32), 3))
    # jitted (the reference engine's in-loop path)
    jit = jax.jit(lambda a, b: r_ent.draw_uniform(
        a, b, 4, jnp.arange(64)[:, None], 33, lane=jnp.arange(4)[None]))
    _eq(t_ent.draw_uniform_torch(torch.tensor([int(lo)])[:, None, None],
                                 torch.tensor([int(hi)])[:, None, None], 4,
                                 torch.arange(64)[None, :, None], 33,
                                 lane=torch.arange(4))[0].numpy(),
        np.asarray(jit(lo, hi)))


@pytest.mark.parametrize("m", [1, 37, 300])
def test_rank_by_rows_match_reference(m):
    """Rows of keys and masks, with ties and an all-invalid row, against the
    reference's ``rank_by`` vmapped over rows; backend 'torch' agrees."""
    rng = np.random.default_rng(m)
    keys = rng.integers(0, 5, (4, m)).astype(np.int32)
    valid = rng.random((4, m)) < 0.6
    valid[2] = False
    ref = np.asarray(jax.vmap(r_bat.rank_by)(jnp.asarray(keys),
                                             jnp.asarray(valid)))
    got = t_bat.rank_by(torch.from_numpy(keys), torch.from_numpy(valid))
    _eq(got.numpy(), ref)
    _eq(t_bat.rank_by(torch.from_numpy(keys), torch.from_numpy(valid),
                      backend="torch").numpy(), ref)
    assert (got[2] == 0).all()
    with pytest.raises(ValueError):
        t_bat.rank_by(torch.from_numpy(keys), torch.from_numpy(valid),
                      backend="cuda")
