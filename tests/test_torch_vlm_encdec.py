"""The port's VLM frontend (LLaVA-NeXT-34B: projected vision embeddings put
before the tokens) and enc-dec family (Whisper-small: ``repro_torch.models.
encdec``, ``layers.cross_attention``) against the JAX reference on the CPU,
on their smoke configs (16 frontend positions of width 128), with the
reference's ``init_params(PRNGKey(0))`` carried across.

Tolerances and guards: ``tests/_torch_zoo.py`` (float32 1e-4, bf16 0.1;
token comparisons need reference top-2 margins above 10 x 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as ref_encdec, layers as ref_layers
from repro.serve import serve_step as ref_serve

from repro_torch.models import encdec, layers
from repro_torch.serve import serve_step

import _torch_zoo as Z

VLM, ENCDEC = "llava-next-34b", "whisper-small"


@pytest.fixture(scope="module")
def vlm():
    return Z.pair(VLM)


@pytest.fixture(scope="module")
def wh():
    return Z.pair(ENCDEC)


def _front(cfg, n, seed=2, batch=2):
    return np.random.default_rng(seed).standard_normal(
        (batch, n, cfg.frontend_dim)).astype(np.float32)


@pytest.mark.parametrize("fixture", ["vlm", "wh"])
def test_param_and_cache_shapes_match_reference(fixture, request):
    ref, _, port, _ = request.getfixturevalue(fixture)
    assert Z.shapes_of(port.param_shapes()) == Z.ref_shapes_of(
        ref.param_shapes())
    assert Z.shapes_of(port.cache_shapes(2, 9)) == Z.ref_shapes_of(
        jax.eval_shape(lambda: ref_serve.zero_cache(ref, 2, 9)))


def test_vlm_prefill_and_decode_match_reference(vlm):
    """5 vision embeds before 11 tokens: every prefill position's logits
    (frontend positions included), the cache, and three decode steps at the
    ``n_front``-shifted index."""
    ref, params, port, pparams = vlm
    B, S, nf, n = 2, 11, 5, 3
    toks = np.random.default_rng(2).integers(0, ref.cfg.vocab, (B, S))
    ve = _front(port.cfg, nf)
    jref = Z.jitted(ref)
    rcache = ref_serve.zero_cache(ref, B, nf + S + n)
    pcache = serve_step.zero_cache(port, B, nf + S + n, Z.CPU)
    want, rcache = jref.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32),
                                         "vision_embeds": jnp.asarray(ve)},
                                rcache)
    got, pcache = port.prefill(pparams, {"tokens": torch.from_numpy(toks),
                                         "vision_embeds": torch.from_numpy(ve)},
                               pcache)
    assert got.shape == (B, nf + S, ref.cfg.vocab)
    Z.close(got, want)
    for i in range(n):
        Z.close_tree(pcache, rcache)
        tok = np.array(jnp.argmax(want[:, -1:], -1), np.int32)
        want, rcache = jref.decode_step(params, jnp.asarray(tok), rcache,
                                        nf + S + i)
        got, pcache = port.decode_step(pparams, torch.from_numpy(tok),
                                       pcache, nf + S + i)
        Z.close(got, want)


def test_vlm_greedy_decode_offsets_by_the_frontend(vlm):
    """``greedy_decode(..., extra_batch={"vision_embeds"})``: the cache
    holds ``n_front`` more positions and decoding starts after them, as the
    reference's; the vision embeds change the tokens."""
    ref, params, port, pparams = vlm
    prompt = np.random.default_rng(0).integers(0, ref.cfg.vocab, (2, 8))
    ve = _front(port.cfg, 16)
    want, margin, _ = Z.ref_trace(Z.jitted(ref), params, prompt, 4,
                                  extra={"vision_embeds": ve})
    assert margin > 10 * Z.TOL, margin
    np.testing.assert_array_equal(np.asarray(ref_serve.greedy_decode(
        ref, params, jnp.asarray(prompt, jnp.int32), n_new=4,
        extra_batch={"vision_embeds": jnp.asarray(ve)})), want)
    got = serve_step.greedy_decode(port, pparams, prompt, 4, device=Z.CPU,
                                   extra_batch={"vision_embeds": ve})
    assert got.dtype == torch.int32 and got.shape == (2, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = serve_step.greedy_decode(port, pparams, prompt, 4, device=Z.CPU)
    assert not torch.equal(plain, got)


def test_vlm_batcher_matches_solo_and_reference(vlm):
    """The batcher prefills tokens only, as the reference's does."""
    ref, params, port, pparams = vlm
    r = np.random.default_rng(2)
    reqs = [(rid, r.integers(0, ref.cfg.vocab, (4 + rid,)).astype(np.int32),
             3) for rid in range(4)]
    jref = Z.jitted(ref)
    for _, prompt, n_new in reqs:
        _, margin, _ = Z.ref_trace(jref, params, prompt[None], n_new, 32)
        assert margin > 10 * Z.TOL, margin
    want, got, solo = Z.batcher_runs(ref, jref, params, port, pparams, reqs)
    assert want == got == solo


def test_cross_attention_matches_reference(wh):
    """Not causal, 1 and 6 queries against 10 and 16 encoder positions."""
    ref, params, port, pparams = wh
    cfg = port.cfg
    lp = jax.tree_util.tree_map(lambda a: a[0], params["decoder"])
    rng = np.random.default_rng(3)
    for S, T in ((1, 16), (6, 10)):
        x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
        kv = [rng.standard_normal((2, T, cfg.n_kv_heads, cfg.head_dim)
                                  ).astype(np.float32) for _ in range(2)]
        want = ref_layers.cross_attention(
            jnp.asarray(x), tuple(jnp.asarray(a) for a in kv),
            {"wq": lp["xq"], "wo": lp["xo"]}, ref.cfg)
        got = layers.cross_attention(
            torch.from_numpy(x), tuple(torch.from_numpy(a) for a in kv),
            pparams.decoder[0].xq, pparams.decoder[0].xo, cfg)
        Z.close(got, want)


@pytest.mark.parametrize("n_frames", [16, 10])
def test_encdec_prefill_and_decode_match_reference(wh, n_frames):
    """Frames (all 16 of ``n_frontend_tokens``, or 10) through the encoder:
    every prefill position's logits, the self cache, the cross K/V (the
    port REPLACES the 16-frame leaves with the frames' own, so no zero key
    is left for decode to attend to), and three decode steps."""
    ref, params, port, pparams = wh
    B, S, n = 2, 9, 3
    toks = np.random.default_rng(2).integers(0, ref.cfg.vocab, (B, S))
    fr = _front(port.cfg, n_frames)
    jref = Z.jitted(ref)
    rcache = ref_serve.zero_cache(ref, B, S + n)
    pcache = serve_step.zero_cache(port, B, S + n, Z.CPU)
    assert pcache["cross_k"].shape[2] == 16
    want, rcache = jref.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32),
                                         "frames": jnp.asarray(fr)}, rcache)
    got, pcache2 = port.prefill(pparams, {"tokens": torch.from_numpy(toks),
                                          "frames": torch.from_numpy(fr)},
                                pcache)
    assert pcache2 is pcache and pcache["cross_k"].shape[2] == n_frames
    Z.close(got, want)
    for i in range(n):
        Z.close_tree(pcache, rcache)
        tok = np.array(jnp.argmax(want[:, -1:], -1), np.int32)
        want, rcache = jref.decode_step(params, jnp.asarray(tok), rcache,
                                        S + i)
        got, pcache = port.decode_step(pparams, torch.from_numpy(tok),
                                       pcache, S + i)
        Z.close(got, want)


def test_encdec_encoder_matches_reference(wh):
    ref, params, port, pparams = wh
    fr = _front(port.cfg, 13, seed=4)
    want = jax.jit(lambda p, f: ref_encdec.encode(ref.cfg, p, f))(
        params, jnp.asarray(fr))
    got = encdec.encode(port.cfg, pparams, torch.from_numpy(fr))
    Z.close(got, want)


@pytest.mark.parametrize("n_frames", [16, 10])
def test_encdec_greedy_decode_matches_reference(wh, n_frames):
    ref, params, port, pparams = wh
    prompt = np.random.default_rng(0).integers(0, ref.cfg.vocab, (2, 6))
    fr = _front(port.cfg, n_frames, seed=5)
    want, margin, _ = Z.ref_trace(Z.jitted(ref), params, prompt, 4,
                                  extra={"frames": fr})
    assert margin > 10 * Z.TOL, margin
    got = serve_step.greedy_decode(port, pparams, prompt, 4, device=Z.CPU,
                                   extra_batch={"frames": fr})
    np.testing.assert_array_equal(got.numpy(), want)


def test_encdec_batcher_matches_solo_and_reference(wh):
    """The batcher prefills tokens only, as the reference's does: the cross
    K/V are the zero cache's, and every slot's leaves are cut on axis 1."""
    ref, params, port, pparams = wh
    r = np.random.default_rng(2)
    reqs = [(rid, r.integers(0, ref.cfg.vocab, (4 + rid,)).astype(np.int32),
             3) for rid in range(4)]
    jref = Z.jitted(ref)
    for _, prompt, n_new in reqs:
        _, margin, _ = Z.ref_trace(jref, params, prompt[None], n_new, 32)
        assert margin > 10 * Z.TOL, margin
    want, got, solo = Z.batcher_runs(ref, jref, params, port, pparams, reqs)
    assert want == got == solo


@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_bf16_prefill_and_decode_match_reference(arch):
    """The smoke configs in bf16: logits and caches within 0.1, with the
    frontend (6 vision embeds, or 10 frames) in the prefill."""
    ref, params, port, pparams = Z.pair(arch, "bfloat16")
    B, S = 2, 13
    toks = np.random.default_rng(4).integers(0, ref.cfg.vocab, (B, S))
    key, nf = ("vision_embeds", 6) if arch == VLM else ("frames", 10)
    front = _front(port.cfg, nf, seed=6)
    off = nf if arch == VLM else 0
    jref = Z.jitted(ref)
    rcache = ref_serve.zero_cache(ref, B, off + S + 4)
    pcache = serve_step.zero_cache(port, B, off + S + 4, Z.CPU)
    want, rcache = jref.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32),
                                         key: jnp.asarray(front)}, rcache)
    got, pcache = port.prefill(pparams, {"tokens": torch.from_numpy(toks),
                                         key: torch.from_numpy(front)},
                               pcache)
    Z.close(got, want, Z.TOL_BF16)
    for i in range(2):
        tok = np.array(jnp.argmax(want[:, -1:], -1), np.int32)
        want, rcache = jref.decode_step(params, jnp.asarray(tok), rcache,
                                        off + S + i)
        got, pcache = port.decode_step(pparams, torch.from_numpy(tok),
                                       pcache, off + S + i)
        Z.close(got, want, Z.TOL_BF16)
        Z.close_tree(pcache, rcache, Z.TOL_BF16)


@pytest.mark.parametrize("fixture", ["vlm", "wh"])
def test_carried_reference_cache_decodes_the_same(fixture, request):
    """``cache_from_reference`` of the reference's cache after a prefill
    with the frontend input (the enc-dec's cross K/V of 10 frames, the
    VLM's positions after 6 vision embeds): the port's decode step from it
    gives the reference's logits."""
    from repro_torch.interop import cache_from_reference
    ref, params, port, pparams = request.getfixturevalue(fixture)
    arch = VLM if fixture == "vlm" else ENCDEC
    toks = np.random.default_rng(8).integers(0, ref.cfg.vocab, (2, 7))
    key, nf = ("vision_embeds", 6) if arch == VLM else ("frames", 10)
    off = nf if arch == VLM else 0
    jref = Z.jitted(ref)
    rcache = ref_serve.zero_cache(ref, 2, off + 9)
    logits, rcache = jref.prefill(params, {
        "tokens": jnp.asarray(toks, jnp.int32),
        key: jnp.asarray(_front(port.cfg, nf, seed=9))}, rcache)
    tok = np.array(jnp.argmax(logits[:, -1:], -1), np.int32)
    want, _ = jref.decode_step(params, jnp.asarray(tok), rcache, off + 7)
    carried = cache_from_reference(
        jax.tree_util.tree_map(np.asarray, rcache), Z.CPU)
    got, _ = port.decode_step(pparams, torch.from_numpy(tok), carried,
                              off + 7)
    Z.close(got, want)
