"""Shared helpers of the differential tests of the port's model zoo
(``tests/test_torch_{moe,mla,vlm_encdec}.py``): a reference model and the
port's on the same parameters, the reference's steps under ``jax.jit``, and
the margin guards.

Tolerances (those of ``tests/test_torch_serve.py``): float32 ``TOL = 1e-4``
on logits and caches (the same float32 math, sums taken in another order);
bf16 ``TOL_BF16 = 0.1`` (an activation may round to the neighbouring bf16
value where the two packages sum in another order).  Where tokens are
compared, every step's top-2 logit margin in the reference must exceed
``10 * TOL``; where a MoE layer routes, every token's k-th and (k+1)-th
router logits in the reference (the log of the two probabilities' ratio)
must be ``ROUTE_GAP`` apart (:func:`route_gaps`), so that neither a token
nor an expert choice can agree or differ by chance.
"""
import contextlib
import dataclasses
import types

import numpy as np
import torch

TOL = 1e-4
TOL_BF16 = 0.1
# The reference's and the port's float32 router logits differ by ~1e-6
# (x @ router summed in another order); a gap of 10 x TOL between the k-th
# and (k+1)-th logits (probabilities 0.1 % apart) leaves no doubt which
# experts win.
ROUTE_GAP = 10 * TOL
CPU = "cpu"


def pair(arch, dtype="float32", **cut):
    """(reference Model, its params from ``init_params(PRNGKey(0))``, the
    port's Model, those params carried to the port on the CPU) for the smoke
    config of ``arch`` in ``dtype``, with the fields ``cut`` replaced in
    both configs."""
    import jax
    from repro.configs.base import get_config as ref_config
    from repro.models.registry import Model as RefModel
    from repro_torch.configs import get_config
    from repro_torch.interop import params_from_reference
    from repro_torch.models.registry import Model
    rcfg = dataclasses.replace(ref_config(arch, smoke=True), dtype=dtype,
                               **cut)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype,
                              **cut)
    ref = RefModel(rcfg)
    params = ref.init_params(jax.random.PRNGKey(0))
    pparams = params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, params), CPU)
    return ref, params, Model(cfg), pparams


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


def close_tree(port, ref, tol=TOL):
    """Every leaf of two caches (nested dicts) within ``tol``."""
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref)
        for k in port:
            close_tree(port[k], ref[k], tol)
        return
    assert tuple(port.shape) == tuple(ref.shape), (port.shape, ref.shape)
    close(port, ref, tol)


def margin(logits) -> float:
    """Smallest top-2 gap of a (..., vocab) logits array."""
    top = np.sort(np.asarray(logits, np.float32), axis=-1)
    return float((top[..., -1] - top[..., -2]).min())


@contextlib.contextmanager
def route_gaps():
    """Record, for every reference MoE routing inside the block (eager or
    under ``jax.jit``), the smallest gap between a token's k-th and
    (k+1)-th router logits; yields the list of gaps."""
    import jax
    import pytest
    from repro.models import moe as ref_moe
    real = ref_moe._route
    gaps = []

    def recording(x2d, router, k):
        logits = x2d.astype(np.float32) @ router
        top = jax.lax.top_k(logits, k + 1)[0]
        jax.debug.callback(lambda g: gaps.append(float(np.min(g))),
                           top[:, k - 1] - top[:, k])
        return real(x2d, router, k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_moe, "_route", recording)
        yield gaps


def jitted(ref):
    """The reference ``Model`` with ``prefill`` and ``decode_step`` under
    ``jax.jit`` (the reference's batcher calls them eagerly, which compiles
    op by op).  Made anew inside each :func:`route_gaps` so the recording
    router is traced in."""
    import jax
    return types.SimpleNamespace(
        ref=ref, cfg=ref.cfg, cache_shapes=ref.cache_shapes,
        prefill=jax.jit(ref.prefill), decode_step=jax.jit(ref.decode_step))


def ref_trace(jref, params, prompt, n_new, max_len=None, extra=None):
    """The reference's greedy tokens (B, n_new) with a cache of ``max_len``
    positions (default: the prompt's length, ``extra``'s vision embeds and
    ``n_new``), the smallest top-2 margin over the steps, and the steps'
    (B, vocab) logits."""
    import jax.numpy as jnp
    from repro.serve import serve_step as ref_serve
    prompt = jnp.asarray(prompt, jnp.int32)
    B, S = prompt.shape
    n_front = 0
    if extra and "vision_embeds" in extra:
        n_front = extra["vision_embeds"].shape[1]
    cache = ref_serve.zero_cache(jref.ref, B, max_len or S + n_front + n_new)
    batch = {"tokens": prompt, **{k: jnp.asarray(v) for k, v in
                                  (extra or {}).items()}}
    logits, cache = jref.prefill(params, batch, cache)
    logits = logits[:, -1:]
    steps, out = [np.asarray(logits[:, -1])], [jnp.argmax(logits, -1)]
    for i in range(n_new - 1):
        logits, cache = jref.decode_step(params, out[-1].astype(jnp.int32),
                                         cache, S + n_front + i)
        steps.append(np.asarray(logits[:, -1]))
        out.append(jnp.argmax(logits, -1))
    return (np.asarray(jnp.concatenate(out, 1)),
            min(margin(s) for s in steps), steps)


def batcher_runs(ref, jref, params, port, pparams, reqs, n_slots=2,
                 max_len=32):
    """``reqs`` [(rid, prompt, n_new)] through the reference batcher (on the
    jitted model), the port's batcher, and the port's greedy decode of each
    prompt alone; returns ({rid: tokens} reference, port, port solo)."""
    from repro.serve import batching as ref_batching
    from repro_torch.serve import batching, serve_step
    rcb = ref_batching.ContinuousBatcher(jref, params, n_slots=n_slots,
                                         max_len=max_len)
    pcb = batching.ContinuousBatcher(port, pparams, n_slots=n_slots,
                                     max_len=max_len, device=CPU)
    for rid, prompt, n_new in reqs:
        rcb.submit(ref_batching.Request(rid=rid, prompt=prompt,
                                        max_new_tokens=n_new))
        pcb.submit(batching.Request(rid=rid, prompt=prompt,
                                    max_new_tokens=n_new))
    want = rcb.run_to_completion(max_ticks=200)
    got = pcb.run_to_completion(max_ticks=200)
    solo = {rid: serve_step.greedy_decode(port, pparams, prompt[None], n_new,
                                          device=CPU)[0].tolist()
            for rid, prompt, n_new in reqs}
    return ({r: q.out for r, q in want.items()},
            {r: q.out for r, q in got.items()}, solo)


def shapes_of(tree):
    """A (shape, dtype-name) tree of the port's ``param_shapes`` or
    ``cache_shapes``, comparable with the reference's."""
    if isinstance(tree, dict):
        return {k: shapes_of(v) for k, v in tree.items()}
    shape, dtype = tree
    return (tuple(shape), str(dtype).split(".")[-1])


def ref_shapes_of(tree):
    import jax
    return jax.tree_util.tree_map(lambda s: (tuple(s.shape), str(s.dtype)),
                                  tree)


def to_torch(tree):
    return {k: (to_torch(v) if isinstance(v, dict)
                else torch.from_numpy(np.asarray(v))) for k, v in tree.items()}



def train_batches(cfg, B=2, S=16, seed=0):
    """(reference batch, port batch) of a training step: tokens drawn from
    numpy, and the family's frontend input (8 vision embeds, or the
    config's audio frames) as standard normals."""
    import jax.numpy as jnp
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    ref = {"tokens": jnp.asarray(toks)}
    port = {"tokens": torch.from_numpy(toks)}
    extra = None
    if cfg.family == "vlm":
        extra = ("vision_embeds", (B, 8, cfg.frontend_dim))
    if cfg.family == "encdec":
        extra = ("frames", (B, cfg.n_frontend_tokens, cfg.frontend_dim))
    if extra:
        a = r.standard_normal(extra[1]).astype(np.float32)
        ref[extra[0]] = jnp.asarray(a)
        port[extra[0]] = torch.from_numpy(a)
    return ref, port
