"""The port's MLA attention (``repro_torch.models.mla``) and DeepSeek-V3's
layout (leading dense layers, then MoE layers with a shared expert) against
the JAX reference on the CPU, on DeepSeek-V3's smoke config (MLA with Dk =
48, Dv = 32; one dense and one MoE layer of 8 experts, top 2, one shared
expert), with the reference's ``init_params(PRNGKey(0))`` carried across.

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

from repro.models import mla as ref_mla
from repro.serve import serve_step as ref_serve

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attn import ops as attn_ops
from repro_torch.models import mla, transformer
from repro_torch.models.registry import Model
from repro_torch.serve import serve_step

import _torch_zoo as Z

ARCH = "deepseek-v3-671b"


@pytest.fixture(scope="module")
def ds():
    return Z.pair(ARCH)


def test_param_and_cache_shapes_match_reference(ds):
    ref, _, port, pparams = ds
    assert Z.shapes_of(port.param_shapes()) == Z.ref_shapes_of(
        ref.param_shapes())
    assert [k for k, _ in transformer.leaves(port.cfg)] == [
        tuple(p.key for p in path) for path, _ in
        jax.tree_util.tree_flatten_with_path(ref.param_shapes())[0]]
    assert (len(pparams.dense), len(pparams.moe)) == (1, 1)
    assert tuple(pparams.moe[0].ws_gate.shape) == (128, 64)
    cache = port.cache_shapes(2, 9)
    assert Z.shapes_of(cache) == Z.ref_shapes_of(
        jax.eval_shape(lambda: ref_serve.zero_cache(ref, 2, 9)))
    assert sorted(cache["dense"]) == ["c_kv", "k_rope"]
    assert port.cache_batch_axes() == {"dense": {"c_kv": 1, "k_rope": 1},
                                       "moe": {"c_kv": 1, "k_rope": 1}}


def test_depth_cuts_set_both_fields():
    """``n_moe = n_layers - n_dense_layers``: a cut below the dense layers
    without lowering ``n_dense_layers`` is refused; lowering both gives the
    dense section alone (the golden's MLA-with-dense-MLP cut)."""
    cfg = get_config(ARCH)
    with pytest.raises(ValueError, match="n_dense_layers"):
        transformer.param_shapes(dataclasses.replace(cfg, n_layers=2))
    one = transformer.param_shapes(dataclasses.replace(
        cfg, n_layers=1, n_dense_layers=1))
    assert "moe" not in one and one["dense"]["wkv_a"][0] == (1, 7168, 576)
    four = transformer.section_layers(dataclasses.replace(cfg, n_layers=4))
    assert four == {"dense": 3, "moe": 1}
    shapes = transformer.param_shapes(dataclasses.replace(cfg, n_layers=4))
    n = sum(int(np.prod(s)) for k, (s, _) in transformer.P.leaves(shapes))
    assert 15.0e9 < n < 15.2e9, n


def test_mla_prefill_attention_goes_through_the_kernel_wrapper(ds,
                                                              monkeypatch):
    """The prefill's attention is one ``ops.attention`` call a layer with
    the model's backend, causal, ``scale = (dn + dr) ** -0.5`` and Dk = dn +
    dr != Dv."""
    _, _, port, pparams = ds
    cfg = port.cfg
    calls = []
    real = attn_ops.attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attn_ops, "attention", spy)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, 7)))
    for backend in ("auto", "torch"):
        calls.clear()
        Model(cfg, backend).prefill(pparams, {"tokens": toks},
                                    serve_step.zero_cache(port, 1, 9, Z.CPU))
        H, dk = cfg.n_heads, cfg.nope_head_dim + cfg.rope_head_dim
        assert calls == [((1, H, 7, dk), (1, H, 7, dk),
                          (1, H, 7, cfg.v_head_dim),
                          dict(causal=True, scale=dk ** -0.5,
                               backend=backend))] * cfg.n_layers


def test_absorbed_decode_matches_reference(ds):
    """The absorbed-weights decode attention alone, over a random
    compressed cache of 12 positions (9 valid), for 1 and 3 queries."""
    ref, params, port, pparams = ds
    cfg = port.cfg
    lp = jax.tree_util.tree_map(lambda a: a[0], params["dense"])
    rng = np.random.default_rng(6)
    H, dn, dr = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim
    for S in (1, 3):
        qn = rng.standard_normal((2, S, H, dn)).astype(np.float32)
        qr = rng.standard_normal((2, S, H, dr)).astype(np.float32)
        cache = {"c_kv": rng.standard_normal((2, 12, cfg.kv_lora_rank)),
                 "k_rope": rng.standard_normal((2, 12, dr))}
        cache = {k: v.astype(np.float32) for k, v in cache.items()}
        want = ref_mla._absorbed_attention(
            jnp.asarray(qn), jnp.asarray(qr),
            {k: jnp.asarray(v) for k, v in cache.items()}, lp, ref.cfg, 9)
        got = mla._absorbed_attention(
            torch.from_numpy(qn), torch.from_numpy(qr), Z.to_torch(cache),
            pparams.dense[0], cfg, 9)
        Z.close(got, want)


def test_prefill_and_decode_match_reference(ds):
    """Logits of every prefill position and of three decode steps, and the
    compressed caches of both sections after each call."""
    ref, params, port, pparams = ds
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
        assert pcache2 is pcache
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


def test_greedy_decode_matches_reference(ds):
    ref, params, port, pparams = ds
    prompt = np.random.default_rng(0).integers(0, ref.cfg.vocab, (2, 8))
    with Z.route_gaps() as gaps:
        want, margin, _ = Z.ref_trace(Z.jitted(ref), params, prompt, 4)
        jax.effects_barrier()
    assert margin > 10 * Z.TOL and min(gaps) > Z.ROUTE_GAP, (margin,
                                                             min(gaps))
    got = serve_step.greedy_decode(port, pparams, prompt, 4, device=Z.CPU)
    np.testing.assert_array_equal(got.numpy(), want)


def test_batcher_matches_solo_and_reference(ds):
    """Four prompts of 4-7 tokens into two slots: the port's batcher (which
    cuts the compressed cache on its batch axis) gives each request's solo
    greedy tokens, and the reference batcher's."""
    ref, params, port, pparams = ds
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


class _UpcastEinsum:
    """``jax.numpy`` with an ``einsum`` that upcasts bf16 operands to
    float32 where ``preferred_element_type=float32`` is asked: the same
    function (bf16 products are exact in float32, summed in float32), which
    XLA:CPU cannot run on bf16 operands."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) for o in ops]
        return jnp.einsum(spec, *ops,
                          preferred_element_type=preferred_element_type, **kw)


def test_bf16_prefill_and_decode_match_reference(monkeypatch):
    """The smoke config in bf16: logits and compressed caches within 0.1.
    The reference cannot decode MLA in bf16 on the CPU as it stands
    (XLA:CPU has no bf16 x bf16 -> float32 dot for the absorbed
    attention's ``preferred_element_type``; ``ROADMAP.md`` §C), so its
    decode runs with those contractions' bf16 operands upcast to float32
    (:class:`_UpcastEinsum`), the same function."""
    ref, params, port, pparams = Z.pair(ARCH, "bfloat16")
    assert pparams.dense[0].wkv_a.dtype == torch.bfloat16
    B, S = 2, 13
    toks = np.random.default_rng(4).integers(0, ref.cfg.vocab, (B, S))
    jref = Z.jitted(ref)
    rcache = ref_serve.zero_cache(ref, B, S + 4)
    pcache = serve_step.zero_cache(port, B, S + 4, Z.CPU)
    assert pcache["moe"]["c_kv"].dtype == torch.bfloat16
    want, rcache = jref.prefill(params, {"tokens": jnp.asarray(
        toks, jnp.int32)}, rcache)
    got, pcache = port.prefill(pparams, {"tokens": torch.from_numpy(toks)},
                               pcache)
    Z.close(got, want, Z.TOL_BF16)
    Z.close_tree(pcache, rcache, Z.TOL_BF16)
    tok = np.array(jnp.argmax(want[:, -1:], -1), np.int32)
    with pytest.raises(Exception, match="BF16 x BF16 = F32"):
        np.asarray(jref.decode_step(params, jnp.asarray(tok), rcache, S)[0])
    monkeypatch.setattr(ref_mla, "jnp", _UpcastEinsum())
    jref = Z.jitted(ref)
    for i in range(2):
        want, rcache = jref.decode_step(params, jnp.asarray(tok), rcache,
                                        S + i)
        got, pcache = port.decode_step(pparams, torch.from_numpy(tok),
                                       pcache, S + i)
        Z.close(got, want, Z.TOL_BF16)
        Z.close_tree(pcache, rcache, Z.TOL_BF16)
        tok = np.array(jnp.argmax(want[:, -1:], -1), np.int32)


def test_dense_only_cut_matches_reference():
    """``n_layers = n_dense_layers = 1`` (MLA with the dense MLP, the
    golden's cut of DeepSeek-V3): prefill logits and the cache."""
    ref, params, port, pparams = Z.pair(ARCH, n_layers=1, n_dense_layers=1)
    assert "moe" not in port.cache_shapes(1, 4) and len(pparams.moe) == 0
    toks = np.random.default_rng(7).integers(0, ref.cfg.vocab, (1, 9))
    rcache = ref_serve.zero_cache(ref, 1, 12)
    pcache = serve_step.zero_cache(port, 1, 12, Z.CPU)
    want, rcache = jax.jit(ref.prefill)(
        params, {"tokens": jnp.asarray(toks, jnp.int32)}, rcache)
    got, pcache = port.prefill(pparams, {"tokens": torch.from_numpy(toks)},
                               pcache)
    Z.close(got, want)
    Z.close_tree(pcache, rcache)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-v3-671b",
                                  "llava-next-34b", "whisper-small"])
def test_launcher_serves_the_zoo_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "3", "--max-new", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "device: cpu"
    assert lines[1].startswith("served 3/3 requests, 9 tokens, ")


def test_carried_reference_cache_decodes_the_same(ds):
    """``cache_from_reference`` of the reference's sectioned compressed
    cache: the port's decode step from it gives the reference's logits."""
    from repro_torch.interop import cache_from_reference
    ref, params, port, pparams = ds
    toks = np.random.default_rng(8).integers(0, ref.cfg.vocab, (2, 7))
    jref = Z.jitted(ref)
    rcache = ref_serve.zero_cache(ref, 2, 9)
    logits, rcache = jref.prefill(params, {"tokens": jnp.asarray(
        toks, jnp.int32)}, rcache)
    tok = np.array(jnp.argmax(logits[:, -1:], -1), np.int32)
    want, _ = jref.decode_step(params, jnp.asarray(tok), rcache, 7)
    carried = cache_from_reference(
        jax.tree_util.tree_map(np.asarray, rcache), Z.CPU)
    got, _ = port.decode_step(pparams, torch.from_numpy(tok), carried, 7)
    Z.close(got, want)
