"""The port's dense-transformer serving path (``repro_torch.models``,
``repro_torch.serve``, ``repro_torch.launch.serve``) against the JAX
reference on the CPU, on the smoke configs of Yi-6B, Phi-4-mini,
Qwen1.5-4B (QKV bias) and Phi-3-mini (MHA), with the reference's
``init_params(PRNGKey(0))`` carried across by
``interop.params_from_reference``.

Tolerances:
* float32, ``TOL = 1e-4`` (atol and rtol) on logits and caches: the same
  float32 math as the reference, its sums taken in another order (XLA's
  and PyTorch's CPU matmuls) over widths of at most 256; the differences
  seen are near 3e-6 on logits of unit scale.
* bf16, ``TOL_BF16 = 0.1``: activations are rounded to bf16 (8 bits of
  mantissa, 2**-8 relative) at the same places, but a float32 sum that the
  two packages order differently can land on the other side of a bf16
  rounding boundary, which moves that activation by one bf16 step; over
  two layers such steps move unit-scale logits by a few hundredths (0.02-
  0.03 seen), and 0.1 is about 25 bf16 steps at unit scale.
Where tokens are compared, every compared step's top-2 logit margin in the
reference must exceed ``10 * TOL``, so no near tie can make the tokens
agree or differ by chance.  Prompt lengths (5-12) are not multiples of 128:
the reference's Pallas kernel would refuse them, its CPU route (the one
both packages take here) does not.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.models.registry import Model as RefModel
from repro.serve import batching as ref_batching, serve_step as ref_serve

from repro_torch.configs import get_config
from repro_torch.interop import cache_from_reference, params_from_reference
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer
from repro_torch.models.registry import Model
from repro_torch.serve import batching, serve_step

ARCHS = ["yi-6b", "phi4-mini-3.8b", "qwen1.5-4b", "phi3-mini-3.8b"]
TOL = 1e-4
TOL_BF16 = 0.1
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


def _margin(logits) -> float:
    """Smallest top-2 gap of a (..., vocab) logits array."""
    top = np.sort(np.asarray(logits, np.float32), axis=-1)
    return float((top[..., -1] - top[..., -2]).min())


_JITTED = {}


def _jitted(ref):
    """The reference ``Model`` with ``prefill`` and ``decode_step`` under
    ``jax.jit`` (the same functions; the reference's batcher calls them
    eagerly, which dispatches and compiles op by op).  One per reference
    model, so that calls of equal shapes share a compile."""
    if id(ref) not in _JITTED:
        _JITTED[id(ref)] = types.SimpleNamespace(
            ref=ref, cfg=ref.cfg, cache_shapes=ref.cache_shapes,
            prefill=jax.jit(ref.prefill),
            decode_step=jax.jit(ref.decode_step))
    return _JITTED[id(ref)]


def _ref_trace(ref, params, prompt, n_new, max_len=None):
    """The reference's greedy tokens (B, n_new), with a cache of
    ``max_len`` positions (default: the prompt's length plus ``n_new``),
    and the smallest top-2 margin over the steps."""
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


def test_param_shapes_match_reference(pair):
    ref, _, port, _ = pair
    want = jax.tree_util.tree_map(lambda s: (tuple(s.shape), str(s.dtype)),
                                  ref.param_shapes())
    got = {k: ({kk: (s, str(d).split(".")[-1]) for kk, (s, d) in v.items()}
               if isinstance(v, dict) else (v[0], str(v[1]).split(".")[-1]))
           for k, v in port.param_shapes().items()}
    assert got == want
    assert [k for k, _ in transformer.leaves(port.cfg)] == [
        tuple(p.key for p in path) for path, _ in
        jax.tree_util.tree_flatten_with_path(ref.param_shapes())[0]]


def test_forward_logits_match_reference(pair):
    ref, params, port, pparams = pair
    toks = np.random.default_rng(1).integers(0, ref.cfg.vocab, (2, 12))
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
        for name in ("k", "v"):
            _close(pcache["dense"][name], rcache["dense"][name])
        tok = np.array(jnp.argmax(want[:, -1:], -1), np.int32)
        want, rcache = jref.decode_step(params, jnp.asarray(tok), rcache,
                                        S + i)
        got, pcache = port.decode_step(pparams, torch.from_numpy(tok),
                                       pcache, S + i)
        _close(got, want)
    # The port's cache carried across from the reference's decodes the same.
    tok = np.array(jnp.argmax(want[:, -1:], -1), np.int32)
    want, _ = jref.decode_step(params, jnp.asarray(tok), rcache, S + n)
    carried = cache_from_reference(
        jax.tree_util.tree_map(np.asarray, rcache), CPU)
    got, _ = port.decode_step(pparams, torch.from_numpy(tok), carried, S + n)
    _close(got, want)


def test_greedy_decode_matches_reference(pair):
    ref, params, port, pparams = pair
    prompt = np.random.default_rng(0).integers(0, ref.cfg.vocab, (2, 8))
    want, margin = _ref_trace(ref, params, prompt, 4)
    assert margin > 10 * TOL, margin
    np.testing.assert_array_equal(
        np.asarray(ref_serve.greedy_decode(ref, params,
                                           jnp.asarray(prompt, jnp.int32),
                                           n_new=4)), want)
    got = serve_step.greedy_decode(port, pparams, prompt, 4, device=CPU)
    assert got.dtype == torch.int32 and got.shape == (2, 4)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mix", ["completes", "unbatched"])
def test_batcher_matches_reference(pair, mix):
    """``tests/test_serve.py``'s two request mixes through both batchers:
    four prompts of 4-7 tokens into two slots, and one of five.  The
    reference batcher runs on the jitted model (``_jitted``)."""
    ref, params, port, pparams = pair
    if mix == "completes":
        r = np.random.default_rng(2)
        reqs = [(rid, r.integers(0, ref.cfg.vocab, (4 + rid,)).astype(
            np.int32), 3) for rid in range(4)]
    else:
        r = np.random.default_rng(3)
        reqs = [(0, r.integers(0, ref.cfg.vocab, (5,)).astype(np.int32), 3)]
    rcb = ref_batching.ContinuousBatcher(_jitted(ref), params, n_slots=2,
                                         max_len=32)
    pcb = batching.ContinuousBatcher(port, pparams, n_slots=2, max_len=32,
                                     device=CPU)
    for rid, prompt, n_new in reqs:
        rcb.submit(ref_batching.Request(rid=rid, prompt=prompt,
                                        max_new_tokens=n_new))
        pcb.submit(batching.Request(rid=rid, prompt=prompt,
                                    max_new_tokens=n_new))
        _, margin = _ref_trace(ref, params, prompt[None], n_new, 32)
        assert margin > 10 * TOL, (rid, margin)
    want = rcb.run_to_completion(max_ticks=200)
    got = pcb.run_to_completion(max_ticks=200)
    assert sorted(got) == sorted(want) == [r[0] for r in reqs]
    for rid in want:
        assert got[rid].out == want[rid].out, rid
        assert got[rid].done


def test_cached_decode_matches_dense_recompute(pair):
    """Cached greedy decode equals argmax decoding with a full forward over
    the grown sequence at each step (the port alone)."""
    _, _, port, pparams = pair
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
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


def test_bf16_prefill_and_decode_match_reference():
    """Yi-6B's smoke config in bf16 (the full config's dtype): logits and
    caches within ``TOL_BF16`` (module docstring); tokens are not compared
    (bf16 logits carry near ties at this tolerance)."""
    ref, params, port, pparams = _pair("yi-6b", "bfloat16")
    assert pparams.dense[0].wq.dtype == torch.bfloat16
    B, S = 2, 13
    toks = np.random.default_rng(4).integers(0, ref.cfg.vocab, (B, S))
    rcache = ref_serve.zero_cache(ref, B, S + 4)
    pcache = serve_step.zero_cache(port, B, S + 4, CPU)
    assert pcache["dense"]["k"].dtype == torch.bfloat16
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
        _close(pcache["dense"]["k"], rcache["dense"]["k"], TOL_BF16)


@pytest.mark.parametrize("arch,item", [("qwen3-moe-30b-a3b", "A3"),
                                       ("deepseek-v3-671b", "A3"),
                                       ("llava-next-34b", "A3"),
                                       ("whisper-small", "A3"),
                                       ("mamba2-130m", "B8"),
                                       ("zamba2-2.7b", "B8")])
def test_unported_families_raise(arch, item):
    """No family is left unported: those of B8 (Mamba2 and the Zamba2
    hybrid, ported with the SSD kernel) and of A3 (MoE, MLA, VLM and
    enc-dec) build, give their cache and, since A4, train on the CPU (a
    finite, differentiable ``Model.loss``); what still raises is
    multi-card training (gradient compression across pods), naming its
    ROADMAP item (A5)."""
    from repro_torch.train import train_step
    model = Model(get_config(arch, smoke=True))
    assert model.cache_shapes(1, 8)
    if item == "B8":
        assert model.cfg.family in ("ssm", "hybrid")
    else:
        assert model.cfg.family in ("moe", "vlm", "encdec")
    cfg = model.cfg
    params = model.init_params(0, device="cpu").requires_grad_(True)
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.zeros((1, 4, cfg.frontend_dim))
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((1, cfg.n_frontend_tokens,
                                       cfg.frontend_dim))
    loss = model.loss(params, batch)
    loss.backward()
    assert bool(torch.isfinite(loss))
    assert all(p.grad is not None for p in params.parameters())
    with pytest.raises(NotImplementedError, match="ROADMAP.md A5"):
        train_step.build_train_step(
            model, train_step.TrainConfig(compress_dcn="bf16"))


def test_random_init_draws_like_the_reference():
    """``init_params`` on a torch.Generator: normals times
    ``shape[-2] ** -0.5`` per reference leaf (the stacked norm gains get
    ``n_layers ** -0.5``), ones for ``final_norm``; same seed, same
    parameters."""
    port = Model(get_config("yi-6b", smoke=True))
    a = port.init_params(3, device=CPU)
    b = port.init_params(torch.Generator().manual_seed(3), device=CPU)
    for (na, ta), (nb, tb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(ta, tb)
    assert torch.equal(a.final_norm, torch.ones_like(a.final_norm))
    nl = port.cfg.n_layers
    ln = torch.stack([layer.ln1 for layer in a.dense])
    assert abs(float(ln.std()) - nl ** -0.5) < 0.1
    wq = a.dense[0].wq
    assert abs(float(wq.std()) - wq.shape[0] ** -0.5) < 0.01


def test_launcher_serves_on_the_cpu(capsys):
    launch_serve.main(["--arch", "qwen1.5-4b", "--smoke", "--device", "cpu",
                       "--requests", "3", "--max-new", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "device: cpu"
    assert lines[1].startswith("served 3/3 requests, 9 tokens, ")
    assert lines[1].endswith(" tok/s")


def test_serve_golden_matches_its_maker():
    """``tests/torch_golden/serve_yi6b_l2.json`` (which ``chip_smoke.py``
    holds the card to) carries its maker's configuration, prompts and fixed
    ids, and each step's record is self-consistent.  (Re-deriving its
    logits needs Yi-6B at full width: ``make_serve_golden.py``.)"""
    import importlib.util
    import json
    from pathlib import Path
    path = Path(__file__).resolve().parent / "torch_golden"
    spec = importlib.util.spec_from_file_location(
        "make_serve_golden", path / "make_serve_golden.py")
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    golden = json.loads(maker.OUT.read_text())
    rcfg, cfg = maker.configs()
    assert (golden["arch"], golden["n_layers"], golden["dtype"]) == (
        maker.ARCH, maker.N_LAYERS, maker.DTYPE)
    assert (golden["param_seed"], golden["n_new"]) == (maker.PARAM_SEED,
                                                       maker.N_NEW)
    assert golden["fixed_ids"] == maker.fixed_ids(cfg.vocab).tolist()
    assert [r["prompt"] for r in golden["runs"]] == [
        p.tolist() for p in maker.prompts(rcfg.vocab)]
    for run in golden["runs"]:
        assert run["tokens"] == [s["token"] for s in run["steps"]]
        for s in run["steps"]:
            top = s["top_logits"]
            assert s["top_ids"][0] == s["token"] and top == sorted(
                top, reverse=True)
            assert s["margin"] == pytest.approx(top[0] - top[1])
            assert len(s["fixed_logits"]) == len(golden["fixed_ids"])
