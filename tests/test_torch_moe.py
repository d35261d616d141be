"""The port's MoE serving path (``repro_torch.models.moe`` and the MoE
section of ``repro_torch.models.transformer``) against the JAX reference on
the CPU, on Qwen3-MoE-30B-A3B's smoke config (8 experts, top 2, GQA, no
shared expert) and units of the one-card dense oracle, with the reference's
``init_params(PRNGKey(0))`` carried across.  Without a mesh the reference
takes the dense oracle, as the port always does.

Tolerances and guards: ``tests/_torch_zoo.py`` (float32 1e-4, bf16 0.1;
token comparisons need reference top-2 margins above 10 x 1e-4, and every
reference routing a gap of 1e-3 between the k-th and (k+1)-th router
logits).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as ref_moe
from repro.serve import serve_step as ref_serve

from repro_torch.configs import get_config
from repro_torch.models import moe, transformer
from repro_torch.models.registry import Model
from repro_torch.serve import serve_step

import _torch_zoo as Z

ARCH = "qwen3-moe-30b-a3b"


@pytest.fixture(scope="module")
def qwen():
    return Z.pair(ARCH)


def test_param_shapes_match_reference(qwen):
    ref, _, port, pparams = qwen
    assert Z.shapes_of(port.param_shapes()) == Z.ref_shapes_of(
        ref.param_shapes())
    assert "dense" not in port.param_shapes() and len(pparams.dense) == 0
    assert [k for k, _ in transformer.leaves(port.cfg)] == [
        tuple(p.key for p in path) for path, _ in
        jax.tree_util.tree_flatten_with_path(ref.param_shapes())[0]]
    layer = pparams.moe[0]
    assert layer.router.dtype == torch.float32
    assert tuple(layer.w_gate.shape) == (8, 128, 64)
    assert Z.shapes_of(port.cache_shapes(2, 9)) == Z.ref_shapes_of(
        jax.eval_shape(lambda: ref_serve.zero_cache(ref, 2, 9)))


def test_full_config_shapes():
    """Qwen3-MoE-30B-A3B at full width: 128 experts of (2,048, 768) in each
    of 48 layers, a float32 router, 30.5 B parameters."""
    cfg = get_config(ARCH)
    shapes = transformer.param_shapes(cfg)
    assert shapes["moe"]["w_gate"] == ((48, 128, 2048, 768), torch.bfloat16)
    assert shapes["moe"]["router"] == ((48, 2048, 128), torch.float32)
    n = sum(int(np.prod(s)) for _, (s, _) in transformer.leaves(cfg))
    assert 30.4e9 < n < 30.6e9, n


def test_route_ties_break_toward_the_lower_index():
    """An all-zero router makes every probability equal: the reference's
    ``top_k`` and the port pick experts 0..k-1, each with gate 1/k."""
    x = np.random.default_rng(0).standard_normal((5, 16)).astype(np.float32)
    router = np.zeros((16, 8), np.float32)
    for k in (1, 2, 3, 8):
        gates, idx = moe.route(torch.from_numpy(x), torch.from_numpy(router),
                               k)
        rg, ri = ref_moe._route(jnp.asarray(x), jnp.asarray(router), k)
        assert idx.tolist() == [list(range(k))] * 5 == np.asarray(ri).tolist()
        np.testing.assert_array_equal(gates.numpy(), np.asarray(rg))
        np.testing.assert_allclose(gates.numpy(), 1.0 / k, rtol=1e-7)


def test_route_partial_ties_keep_the_lower_index():
    """Router columns that are equal in pairs: each tie (within and across
    the k-th place) goes to the lower expert index, as ``top_k`` breaks it."""
    x = np.random.default_rng(1).standard_normal((7, 16)).astype(np.float32)
    base = np.random.default_rng(2).standard_normal((16, 4)).astype(np.float32)
    router = np.repeat(base, 2, axis=1)           # experts 2i and 2i+1 tie
    for k in (1, 2, 3, 5):
        gates, idx = moe.route(torch.from_numpy(x), torch.from_numpy(router),
                               k)
        rg, ri = ref_moe._route(jnp.asarray(x), jnp.asarray(router), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
        np.testing.assert_allclose(gates.numpy(), np.asarray(rg), rtol=1e-6,
                                   atol=1e-7)


def test_route_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 32)).astype(np.float32)
    router = rng.standard_normal((32, 16)).astype(np.float32)
    top = np.asarray(jax.lax.top_k(jnp.asarray(x) @ jnp.asarray(router),
                                   5)[0])
    assert (top[:, 3] - top[:, 4]).min() > Z.ROUTE_GAP
    gates, idx = moe.route(torch.from_numpy(x), torch.from_numpy(router), 4)
    rg, ri = ref_moe._route(jnp.asarray(x), jnp.asarray(router), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gates.numpy(), np.asarray(rg), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("shared", [0, 1, 2])
def test_moe_block_matches_reference(shared):
    """The dense oracle with 0, 1 or 2 shared experts (the shared expert
    adds a SwiGLU of width ``moe_d_ff * n_shared_experts``); ``moe_impl``
    and ``capacity_factor`` change nothing on one card."""
    ref, params, port, pparams = Z.pair(ARCH, n_shared_experts=shared)
    lp = jax.tree_util.tree_map(lambda a: a[0], params["moe"])
    x = np.random.default_rng(4).standard_normal((2, 9, 128)).astype(
        np.float32)
    with Z.route_gaps() as gaps:
        want = ref_moe.moe_block(ref.cfg, lp, jnp.asarray(x))
        jax.effects_barrier()
    assert min(gaps) > Z.ROUTE_GAP, gaps
    for impl, cap in (("a2a", 1.25), ("rotation", 0.5), ("dense", 0.0)):
        cfg = dataclasses.replace(port.cfg, moe_impl=impl,
                                  capacity_factor=cap)
        got = moe.moe_block(cfg, pparams.moe[0], torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == (2, 9, 128)
        Z.close(got, want)
    if shared:
        assert tuple(pparams.moe[0].ws_gate.shape) == (128, 64 * shared)


def test_prefill_and_decode_match_reference(qwen):
    """Logits of every prefill position and of three decode steps, and the
    whole caches after each call; the reference's tokens feed both."""
    ref, params, port, pparams = qwen
    B, S, n = 2, 11, 3
    toks = np.random.default_rng(2).integers(0, ref.cfg.vocab, (B, S))
    with Z.route_gaps() as gaps:
        jref = Z.jitted(ref)
        rcache = ref_serve.zero_cache(ref, B, S + n + 2)
        pcache = serve_step.zero_cache(port, B, S + n + 2, Z.CPU)
        want, rcache = jref.prefill(params, {"tokens": jnp.asarray(
            toks, jnp.int32)}, rcache)
        got, pcache2 = port.prefill(pparams, {"tokens": torch.from_numpy(
            toks)}, pcache)
        assert pcache2 is pcache                      # written in place
        Z.close(got, want)
        for i in range(n):
            Z.close_tree(pcache, rcache)
            tok = np.array(jnp.argmax(want[:, -1:], -1), np.int32)
            want, rcache = jref.decode_step(params, jnp.asarray(tok), rcache,
                                            S + i)
            got, pcache = port.decode_step(pparams, torch.from_numpy(tok),
                                           pcache, S + i)
            Z.close(got, want)
        jax.effects_barrier()
    assert min(gaps) > Z.ROUTE_GAP, min(gaps)


def test_greedy_decode_matches_reference(qwen):
    ref, params, port, pparams = qwen
    prompt = np.random.default_rng(1).integers(0, ref.cfg.vocab, (2, 8))
    with Z.route_gaps() as gaps:
        want, margin, _ = Z.ref_trace(Z.jitted(ref), params, prompt, 4)
        jax.effects_barrier()
    assert margin > 10 * Z.TOL and min(gaps) > Z.ROUTE_GAP, (margin,
                                                             min(gaps))
    got = serve_step.greedy_decode(port, pparams, prompt, 4, device=Z.CPU)
    assert got.dtype == torch.int32 and got.shape == (2, 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_batcher_matches_solo_and_reference(qwen):
    """Four prompts of 4-7 tokens into two slots: the port's batcher gives
    each request's solo greedy tokens, and the reference batcher's."""
    ref, params, port, pparams = qwen
    r = np.random.default_rng(2)
    reqs = [(rid, r.integers(0, ref.cfg.vocab, (4 + rid,)).astype(np.int32),
             3) for rid in range(4)]
    with Z.route_gaps() as gaps:
        jref = Z.jitted(ref)
        for _, prompt, n_new in reqs:
            _, margin, _ = Z.ref_trace(jref, params, prompt[None], n_new, 32)
            assert margin > 10 * Z.TOL, margin
        want, got, solo = Z.batcher_runs(ref, jref, params, port, pparams,
                                         reqs)
        jax.effects_barrier()
    assert min(gaps) > Z.ROUTE_GAP, min(gaps)
    assert want == got == solo


def test_bf16_prefill_and_decode_match_reference():
    """The smoke config in bf16 (the full config's dtype): logits and
    caches within 0.1; the router stays float32."""
    ref, params, port, pparams = Z.pair(ARCH, "bfloat16")
    assert pparams.moe[0].w_gate.dtype == torch.bfloat16
    assert pparams.moe[0].router.dtype == torch.float32
    B, S = 2, 13
    toks = np.random.default_rng(4).integers(0, ref.cfg.vocab, (B, S))
    jref = Z.jitted(ref)
    rcache = ref_serve.zero_cache(ref, B, S + 4)
    pcache = serve_step.zero_cache(port, B, S + 4, Z.CPU)
    want, rcache = jref.prefill(params, {"tokens": jnp.asarray(
        toks, jnp.int32)}, rcache)
    got, pcache = port.prefill(pparams, {"tokens": torch.from_numpy(toks)},
                               pcache)
    Z.close(got, want, Z.TOL_BF16)
    for i in range(2):
        tok = np.array(jnp.argmax(want[:, -1:], -1), np.int32)
        want, rcache = jref.decode_step(params, jnp.asarray(tok), rcache,
                                        S + i)
        got, pcache = port.decode_step(pparams, torch.from_numpy(tok),
                                       pcache, S + i)
        Z.close(got, want, Z.TOL_BF16)
        Z.close_tree(pcache, rcache, Z.TOL_BF16)


def test_random_init_follows_the_reference_rule():
    """``init_params`` on a torch.Generator: the experts are normals times
    ``D ** -0.5`` (``shape[-2]`` of the stacked (nl, E, D, F) leaf), the
    router is float32; same seed, same parameters."""
    port = Model(get_config(ARCH, smoke=True))
    a = port.init_params(3, device=Z.CPU)
    b = port.init_params(torch.Generator().manual_seed(3), device=Z.CPU)
    for (na, ta), (nb, tb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(ta, tb)
    w = a.moe[0].w_up
    assert abs(float(w.std()) - w.shape[1] ** -0.5) < 0.01
    assert a.moe[0].router.dtype == torch.float32


def test_zoo_goldens_match_their_maker():
    """The four goldens of ``tests/torch_golden/make_zoo_golden.py`` (which
    ``chip_smoke.py`` holds the card to) carry their maker's configuration,
    cut, prompts, frontend input and fixed ids, and each step's record is
    self-consistent; the MoE golden's smallest router-logit gap is
    recorded.  (Re-deriving the logits needs the models at full width.)"""
    import importlib.util
    import json
    import sys
    from pathlib import Path
    path = Path(__file__).resolve().parent / "torch_golden"
    sys.path.insert(0, str(path))
    spec = importlib.util.spec_from_file_location(
        "make_zoo_golden", path / "make_zoo_golden.py")
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    for name, (arch, cut, key) in maker.GOLDENS.items():
        golden = json.loads((path / name).read_text())
        rcfg, cfg = maker.configs(arch, cut)
        assert (golden["arch"], golden["cut"], golden["dtype"]) == (
            arch, cut, maker.DTYPE)
        assert golden["n_layers"] == cfg.n_layers
        assert golden["param_seed"] == maker.PARAM_SEED
        assert golden["front"] == maker.front_spec(rcfg, key)
        assert golden["fixed_ids"] == maker.fixed_ids(cfg.vocab).tolist()
        assert [r["prompt"] for r in golden["runs"]] == [
            p.tolist() for p in maker.prompts(rcfg.vocab)]
        for run in golden["runs"]:
            assert run["tokens"] == [s["token"] for s in run["steps"]]
            assert (run["route_gap"] is not None) == (
                "moe" in transformer.section_layers(cfg)
                if cfg.family == "moe" else False)
            for s in run["steps"]:
                top = s["top_logits"]
                assert s["top_ids"][0] == s["token"] and top == sorted(
                    top, reverse=True)
                assert s["margin"] == pytest.approx(top[0] - top[1])


def test_numpy_reference_params_in_blocks():
    """``numpy_reference_params`` draws each leaf in blocks, block ``c`` of
    the k-th leaf from ``default_rng([seed, k, c])`` (the same on every
    call, other numbers for another seed), by the init rule: normals times
    ``shape[-2] ** -0.5``, ones for 1-D leaves."""
    from repro_torch.interop import numpy_reference_params
    from repro_torch.models import _params
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), vocab=4096)
    old = _params.BLOCK
    _params.BLOCK = 1 << 12               # several blocks a leaf
    try:
        a = numpy_reference_params(cfg, 5)
        b = numpy_reference_params(cfg, 5)
        other = numpy_reference_params(cfg, 6)
    finally:
        _params.BLOCK = old
    leaves = transformer.leaves(cfg)
    for k, (key, (shape, _)) in enumerate(leaves):
        x, y, z = a, b, other
        for part in key:
            x, y, z = x[part], y[part], z[part]
        assert x.dtype == np.float32 and x.shape == shape
        np.testing.assert_array_equal(x, y)
        if len(shape) < 2:
            assert (x == 1).all()
            continue
        assert not np.array_equal(x, z)
        flat = x.reshape(-1)
        for c in range(-(-flat.size // (1 << 12))):
            want = np.random.default_rng([5, k, c]).standard_normal(
                min(1 << 12, flat.size - (c << 12)), dtype=np.float32)
            np.testing.assert_array_equal(
                flat[c << 12:(c + 1) << 12],
                want * np.float32(shape[-2] ** -0.5))
        if x.size >= 4096:
            assert abs(x.std() * shape[-2] ** 0.5 - 1) < 0.05, key