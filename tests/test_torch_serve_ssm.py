"""The port's Mamba2 (``family="ssm"``) and Zamba2-hybrid
(``family="hybrid"``) serving paths against the JAX reference on the CPU,
on the smoke configs of Mamba2-130M and Zamba2-2.7B, with the reference's
``init_params(PRNGKey(0))`` carried across by
``interop.params_from_reference``.

Tolerances:
* float32, ``TOL = 1e-4`` (atol and rtol) on logits and caches: the same
  float32 math as the reference, its sums taken in another order (XLA's and
  PyTorch's CPU matmuls and einsums) over widths of at most 512; the
  differences seen are below 2e-6 on logits of scale 0.1-0.4.
* bf16, ``TOL_BF16 = 0.05`` on logits, ``0.1`` on caches: activations are
  rounded to bf16 (2**-8 relative) at the same places, but a float32 sum
  that the two packages order differently can land on the other side of a
  bf16 rounding boundary and move that activation by one bf16 step; the
  logits here are of scale 0.1-0.4 and the SSM states of scale 1, so a few
  such steps through 2-4 layers stay well inside these limits.
Where tokens are compared, every compared step's top-2 logit margin in the
reference must exceed ``10 * TOL``, so no near tie can make the tokens
agree or differ by chance.
"""
import dataclasses
import importlib.util
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.models.registry import Model as RefModel
from repro.serve import batching as ref_batching, serve_step as ref_serve

from repro_torch.configs import get_config
from repro_torch.interop import (cache_from_reference, numpy_reference_params,
                                 params_from_reference)
from repro_torch.launch import serve as launch_serve
from repro_torch.models import hybrid, mamba2
from repro_torch.models._params import leaves
from repro_torch.models.registry import Model, family_module
from repro_torch.serve import batching, serve_step

ARCHS = ["mamba2-130m", "zamba2-2.7b"]
TOL = 1e-4
TOL_BF16 = 0.05
CPU = "cpu"


def _pair(arch, dtype="float32"):
    rcfg = dataclasses.replace(ref_config(arch, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    ref = RefModel(rcfg)
    params = ref.init_params(jax.random.PRNGKey(0))
    port = Model(cfg)
    pparams = params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, params), CPU)
    return ref, params, port, pparams


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


def _close_tree(port, ref, tol=TOL):
    jax.tree_util.tree_map(lambda r, p: _close(p, r, tol), ref, port)


def _margin(logits) -> float:
    top = np.sort(np.asarray(logits, np.float32), axis=-1)
    return float((top[..., -1] - top[..., -2]).min())


_JITTED = {}


def _jitted(ref):
    """The reference ``Model`` with ``prefill`` and ``decode_step`` under
    ``jax.jit`` (the same functions, compiled once per shape)."""
    if id(ref) not in _JITTED:
        _JITTED[id(ref)] = types.SimpleNamespace(
            ref=ref, cfg=ref.cfg, cache_shapes=ref.cache_shapes,
            prefill=jax.jit(ref.prefill),
            decode_step=jax.jit(ref.decode_step))
    return _JITTED[id(ref)]


def _ref_trace(ref, params, prompt, n_new, max_len=None):
    """The reference's greedy tokens (B, n_new) and the smallest top-2
    margin over the steps."""
    prompt = jnp.asarray(prompt, jnp.int32)
    B, S = prompt.shape
    jref = _jitted(ref)
    cache = ref_serve.zero_cache(ref, B, max_len or S + n_new)
    logits, cache = jref.prefill(params, {"tokens": prompt}, cache)
    logits = logits[:, -1:]
    margins, out = [_margin(logits)], [jnp.argmax(logits, -1)]
    for i in range(n_new - 1):
        logits, cache = jref.decode_step(params, out[-1].astype(jnp.int32),
                                         cache, S + i)
        margins.append(_margin(logits))
        out.append(jnp.argmax(logits, -1))
    return np.asarray(jnp.concatenate(out, 1)), min(margins)


def _shape_tree(tree):
    return jax.tree_util.tree_map(
        lambda s: (tuple(s[0]), str(s[1]).split(".")[-1]), tree,
        is_leaf=lambda x: isinstance(x, tuple))


def test_param_shapes_match_reference(pair):
    ref, _, port, _ = pair
    want = jax.tree_util.tree_map(lambda s: (tuple(s.shape), str(s.dtype)),
                                  ref.param_shapes())
    assert _shape_tree(port.param_shapes()) == want
    assert [k for k, _ in leaves(port.param_shapes())] == [
        tuple(p.key for p in path) for path, _ in
        jax.tree_util.tree_flatten_with_path(ref.param_shapes())[0]]


def test_cache_layout_matches_reference(pair):
    """Cache shapes and dtypes, and each leaf's batch axis where the
    reference's ``cache_logical_axes`` names "batch"."""
    ref, _, port, _ = pair
    want = jax.tree_util.tree_map(lambda s: (tuple(s.shape), str(s.dtype)),
                                  ref.cache_shapes(3, 17))
    assert _shape_tree(port.cache_shapes(3, 17)) == want
    axes = jax.tree_util.tree_map(
        lambda a: a.index("batch"), ref.cache_logical_axes(),
        is_leaf=lambda x: isinstance(x, tuple))
    assert port.cache_batch_axes() == axes


def test_forward_logits_match_reference(pair):
    ref, params, port, pparams = pair
    toks = np.random.default_rng(1).integers(0, ref.cfg.vocab, (2, 70))
    want = ref._fwd(params, {"tokens": jnp.asarray(toks, jnp.int32)},
                    mode="train")
    got = port._fwd(pparams, {"tokens": torch.from_numpy(toks)},
                    mode="train")
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want)


def test_prefill_and_decode_match_reference(pair):
    """Logits of every prefill position and of three decode steps, and the
    whole caches after each call; the reference's tokens feed both."""
    ref, params, port, pparams = pair
    jref = _jitted(ref)
    B, S, n = 2, 11, 3
    toks = np.random.default_rng(2).integers(0, ref.cfg.vocab, (B, S))
    rcache = ref_serve.zero_cache(ref, B, S + n + 2)
    pcache = serve_step.zero_cache(port, B, S + n + 2, CPU)
    want, rcache = jref.prefill(params, {"tokens": jnp.asarray(toks,
                                                               jnp.int32)},
                                rcache)
    got, pcache2 = port.prefill(pparams, {"tokens": torch.from_numpy(toks)},
                                pcache)
    assert pcache2 is pcache                      # written in place
    _close(got, want)
    for i in range(n):
        _close_tree(pcache, rcache)
        tok = np.array(jnp.argmax(want[:, -1:], -1), np.int32)
        want, rcache = jref.decode_step(params, jnp.asarray(tok), rcache,
                                        S + i)
        got, pcache = port.decode_step(pparams, torch.from_numpy(tok),
                                       pcache, S + i)
        _close(got, want)
    _close_tree(pcache, rcache)
    # The port's cache carried across from the reference's decodes the same.
    tok = np.array(jnp.argmax(want[:, -1:], -1), np.int32)
    want, _ = jref.decode_step(params, jnp.asarray(tok), rcache, S + n)
    carried = cache_from_reference(
        jax.tree_util.tree_map(np.asarray, rcache), CPU)
    got, _ = port.decode_step(pparams, torch.from_numpy(tok), carried, S + n)
    _close(got, want)


def test_greedy_decode_matches_reference(pair):
    ref, params, port, pparams = pair
    prompt = np.random.default_rng(0).integers(0, ref.cfg.vocab, (2, 9))
    want, margin = _ref_trace(ref, params, prompt, 4)
    assert margin > 10 * TOL, margin
    np.testing.assert_array_equal(
        np.asarray(ref_serve.greedy_decode(ref, params,
                                           jnp.asarray(prompt, jnp.int32),
                                           n_new=4)), want)
    got = serve_step.greedy_decode(port, pparams, prompt, 4, device=CPU)
    assert got.dtype == torch.int32 and got.shape == (2, 4)
    np.testing.assert_array_equal(got.numpy(), want)


def _requests(vocab, seed, n, lens=(4, 5, 6, 7, 9)):
    r = np.random.default_rng(seed)
    return [(rid, r.integers(0, vocab, (lens[rid % len(lens)],)).astype(
        np.int32), 3) for rid in range(n)]


@pytest.mark.parametrize("mix", ["completes", "unbatched"])
def test_batcher_matches_solo_and_reference(pair, mix):
    """Requests through the port's batcher: each one's tokens equal the
    port's solo ``greedy_decode`` and the reference's per-request greedy
    decode.  The reference batcher serves Mamba2 too and must agree; on
    the hybrid it raises (``test_reference_batcher_fails_on_the_hybrid``)."""
    ref, params, port, pparams = pair
    reqs = (_requests(ref.cfg.vocab, 3, 4) if mix == "completes"
            else _requests(ref.cfg.vocab, 2, 1, (5,)))
    pcb = batching.ContinuousBatcher(port, pparams, n_slots=2, max_len=32,
                                     device=CPU)
    for rid, prompt, n_new in reqs:
        pcb.submit(batching.Request(rid=rid, prompt=prompt,
                                    max_new_tokens=n_new))
    got = pcb.run_to_completion(max_ticks=200)
    assert sorted(got) == [r[0] for r in reqs]
    for rid, prompt, n_new in reqs:
        want, margin = _ref_trace(ref, params, prompt[None], n_new, 32)
        assert margin > 10 * TOL, (rid, margin)
        solo = serve_step.greedy_decode(port, pparams, prompt[None], n_new,
                                        device=CPU)
        assert got[rid].out == solo[0].tolist() == want[0].tolist(), rid
        assert got[rid].done
    if ref.cfg.family == "ssm":
        rcb = ref_batching.ContinuousBatcher(_jitted(ref), params, n_slots=2,
                                             max_len=32)
        for rid, prompt, n_new in reqs:
            rcb.submit(ref_batching.Request(rid=rid, prompt=prompt,
                                            max_new_tokens=n_new))
        rdone = rcb.run_to_completion(max_ticks=200)
        assert {k: v.out for k, v in rdone.items()} == {
            k: v.out for k, v in got.items()}


def test_reference_batcher_fails_on_the_hybrid():
    """The reference's batcher cuts axis 1 of every cache leaf, the k axis
    of the hybrid's ``(napp, k, B, ...)`` Mamba cache, and its decode
    raises; the port's cuts each leaf on its batch axis and serves the same
    requests, each equal to the reference's solo greedy decode."""
    ref, params, port, pparams = _pair("zamba2-2.7b")
    reqs = _requests(ref.cfg.vocab, 3, 3)
    rcb = ref_batching.ContinuousBatcher(ref, params, n_slots=2, max_len=32)
    pcb = batching.ContinuousBatcher(port, pparams, n_slots=2, max_len=32,
                                     device=CPU)
    for rid, prompt, n_new in reqs:
        rcb.submit(ref_batching.Request(rid=rid, prompt=prompt,
                                        max_new_tokens=n_new))
        pcb.submit(batching.Request(rid=rid, prompt=prompt,
                                    max_new_tokens=n_new))
    with pytest.raises(ValueError, match="leading axis sizes"):
        rcb.run_to_completion(max_ticks=50)
    got = pcb.run_to_completion(max_ticks=200)
    for rid, prompt, n_new in reqs:
        want, margin = _ref_trace(ref, params, prompt[None], n_new, 32)
        assert margin > 10 * TOL, (rid, margin)
        assert got[rid].out == want[0].tolist(), rid


def test_batcher_leaves_other_slots_untouched():
    """A decode group's gather/scatter along the batch axes: after serving
    one request in slot 0 of a 3-slot batcher, the other slots' caches are
    still zero in every leaf (the hybrid's axis-2 Mamba leaves too)."""
    _, _, port, pparams = _pair("zamba2-2.7b")
    cb = batching.ContinuousBatcher(port, pparams, n_slots=3, max_len=16,
                                    device=CPU)
    cb.submit(batching.Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                               max_new_tokens=2))
    cb.step()
    axes = port.cache_batch_axes()
    seen = []

    def check(full, ax):
        assert bool(full.select(ax, 0).abs().sum() > 0)
        for s in (1, 2):
            assert bool((full.select(ax, s) == 0).all())
        seen.append(ax)
    serve_step.tree_map(check, cb.cache, axes)
    assert sorted(seen) == [1, 1, 2, 2]


def test_cached_decode_matches_dense_recompute(pair):
    """Cached greedy decode equals argmax decoding with a full forward over
    the grown sequence at each step (the port alone)."""
    _, _, port, pparams = pair
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, port.cfg.vocab, (1, 6)))
    cached = serve_step.greedy_decode(port, pparams, prompt, 4, device=CPU)
    toks, dense = prompt, []
    for _ in range(4):
        logits = port._fwd(pparams, {"tokens": toks}, mode="train")
        assert _margin(logits[:, -1].numpy()) > 10 * TOL
        nxt = logits[:, -1:].argmax(-1)
        dense.append(int(nxt[0, 0]))
        toks = torch.cat([toks, nxt], dim=1)
    assert cached[0].tolist() == dense


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_and_decode_match_reference(arch):
    """The smoke configs in bf16 (the full configs' dtype, for Zamba2):
    logits within ``TOL_BF16`` and caches within 0.1 (module docstring);
    tokens are not compared (bf16 logits carry near ties at this
    tolerance)."""
    ref, params, port, pparams = _pair(arch, "bfloat16")
    assert pparams.layers[0].in_proj.dtype == torch.bfloat16
    assert pparams.layers[0].A_log.dtype == torch.float32
    B, S = 2, 13
    toks = np.random.default_rng(4).integers(0, ref.cfg.vocab, (B, S))
    rcache = ref_serve.zero_cache(ref, B, S + 4)
    pcache = serve_step.zero_cache(port, B, S + 4, CPU)
    want, rcache = ref.prefill(params, {"tokens": jnp.asarray(toks,
                                                              jnp.int32)},
                               rcache)
    got, pcache = port.prefill(pparams, {"tokens": torch.from_numpy(toks)},
                               pcache)
    assert got.dtype == torch.float32
    _close(got, want, TOL_BF16)
    for i in range(2):
        tok = np.array(jnp.argmax(want[:, -1:], -1), np.int32)
        want, rcache = ref.decode_step(params, jnp.asarray(tok), rcache,
                                       S + i)
        got, pcache = port.decode_step(pparams, torch.from_numpy(tok),
                                       pcache, S + i)
        _close(got, want, TOL_BF16)
        _close_tree(pcache, rcache, 0.1)


@pytest.mark.parametrize("arch", ARCHS)
def test_random_init_follows_the_ssm_rule(arch):
    """``init_params`` on a torch.Generator, by ``repro.models.mamba2``'s
    rule: normals times ``shape[-2] ** -0.5`` where the (stacked) last axis
    exceeds 8, else 0.1; ``A_log = 0`` and ``dt_bias = -2``; same seed,
    same parameters."""
    port = Model(get_config(arch, smoke=True))
    a = port.init_params(3, device=CPU)
    b = port.init_params(torch.Generator().manual_seed(3), device=CPU)
    for (na, ta), (nb, tb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(ta, tb)
    assert torch.equal(a.final_norm, torch.full_like(a.final_norm, 0.1))
    for layer in a.layers:
        assert torch.equal(layer.A_log, torch.zeros_like(layer.A_log))
        assert torch.equal(layer.dt_bias, torch.full_like(layer.dt_bias, -2))
    if arch == "zamba2-2.7b":
        assert torch.equal(a.shared.ln1, torch.full_like(a.shared.ln1, 0.1))
        wq = a.shared.wq
        assert abs(float(wq.std()) - wq.shape[0] ** -0.5) < 0.01
    w = a.layers[0].in_proj
    assert abs(float(w.std()) - w.shape[0] ** -0.5) < 0.01


@pytest.mark.parametrize("arch", ARCHS)
def test_numpy_reference_params_follow_the_reference_rule(arch):
    """``numpy_reference_params`` draws the reference's tree (same paths,
    shapes) by the reference's rule: its constant leaves equal the
    reference ``init_params``' leaves exactly, its random leaves have the
    reference's scale."""
    rcfg = ref_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    want = jax.tree_util.tree_map(np.asarray, RefModel(rcfg).init_params(
        jax.random.PRNGKey(0)))
    got = numpy_reference_params(cfg, 0)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    mod = family_module(cfg)
    for key, (shape, _) in leaves(mod.param_shapes(cfg)):
        g, w = got, want
        for k in key:
            g, w = g[k], w[k]
        assert g.shape == w.shape == shape and g.dtype == np.float32
        kind, value = mod.init_rule(key, shape)
        if kind == "fill":
            np.testing.assert_array_equal(g, w)
        else:
            assert abs(float(g.std()) - value) < 0.2 * value, key
    np.testing.assert_array_equal(numpy_reference_params(cfg, 0)["embed"],
                                  got["embed"])
    assert mod is {"mamba2-130m": mamba2, "zamba2-2.7b": hybrid}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_on_the_cpu(arch, capsys):
    launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "3", "--max-new", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "device: cpu"
    assert lines[1].startswith("served 3/3 requests, 9 tokens, ")
    assert lines[1].endswith(" tok/s")


def test_ssm_golden_matches_its_maker():
    """``tests/torch_golden/serve_ssm.json`` (which ``chip_smoke.py`` holds
    the card to) carries its maker's models, prompts and fixed ids, and each
    step's record is self-consistent.  (Re-deriving its logits needs the
    models at full width: ``make_ssm_golden.py``.)"""
    path = Path(__file__).resolve().parent / "torch_golden"
    spec = importlib.util.spec_from_file_location(
        "make_ssm_golden", path / "make_ssm_golden.py")
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    golden = json.loads(maker.OUT.read_text())
    assert [(m["arch"], m["n_layers"]) for m in golden["models"]] == list(
        maker.MODELS)
    for m in golden["models"]:
        rcfg, cfg = maker.configs(m["arch"], m["n_layers"])
        assert m["dtype"] == maker.DTYPE == cfg.dtype
        assert m["fixed_ids"] == maker.fixed_ids(cfg.vocab).tolist()
        assert [r["prompt"] for r in m["runs"]] == [
            p.tolist() for p in maker.prompts(rcfg.vocab)]
        for run in m["runs"]:
            assert run["tokens"] == [s["token"] for s in run["steps"]]
            assert len(run["steps"]) == m["n_new"] == maker.N_NEW
            for s in run["steps"]:
                top = s["top_logits"]
                assert s["top_ids"][0] == s["token"] and top == sorted(
                    top, reverse=True)
                assert s["margin"] == pytest.approx(top[0] - top[1])
                assert len(s["fixed_logits"]) == len(m["fixed_ids"])


def test_hybrid_needs_whole_groups_of_layers():
    """The shared block follows each group of ``shared_attn_every`` Mamba
    layers; a depth that leaves a partial group is refused (the reference
    fails reshaping the layers into groups)."""
    cfg = dataclasses.replace(get_config("zamba2-2.7b", smoke=True),
                              n_layers=3)
    with pytest.raises(ValueError, match="shared_attn_every"):
        Model(cfg).cache_shapes(1, 8)
