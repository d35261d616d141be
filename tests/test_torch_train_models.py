"""``Model.loss`` and its gradients against the reference,
for every family's smoke config, on the CPU.

The reference's loss and gradients come from ``jax.value_and_grad(loss)``
under ``jax.jit``; the port's from ``Model.loss`` under ordinary autograd
(the plain attention and SSD routes, ``remat`` as the config has it), from
the same float32 parameters (``interop.params_from_reference``).

Tolerances (float32, sums in another order): the loss within ``1e-5``
relative; each gradient leaf within ``GRAD_TOL = 1e-4`` of its largest
magnitude; remat on and off bitwise equal.  (One whole train step against
the reference's is in ``tests/test_torch_train.py``.)
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro_torch.train import tree as T

from _torch_zoo import pair, train_batches as _batches

FAMILIES = ["yi-6b", "qwen3-moe-30b-a3b", "deepseek-v3-671b",
            "llava-next-34b", "whisper-small", "mamba2-130m", "zamba2-2.7b"]
GRAD_TOL = 1e-4


def _grads_close(ref_grads, port_tree):
    for path, want in T.items(jax.tree_util.tree_map(np.asarray, ref_grads)):
        leaf = T.get(port_tree, path)
        got = (torch.stack([t.grad for t in leaf]) if isinstance(leaf, list)
               else leaf.grad).numpy()
        scale = float(np.abs(want).max()) or 1.0
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * scale,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_reference(arch):
    ref, params, port, pparams = pair(arch)
    rb, pb = _batches(port.cfg)
    loss, grads = jax.jit(jax.value_and_grad(ref.loss))(params, rb)
    pparams.requires_grad_(True)
    ploss = port.loss(pparams, pb)
    ploss.backward()
    assert abs(float(ploss.detach()) - float(loss)) <= 1e-5 * abs(float(loss))
    _grads_close(grads, pparams.tree())


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_gives_the_same_gradients(policy):
    ref, params, port, pparams = pair("yi-6b", remat_policy=policy)
    _, pb = _batches(port.cfg)
    pparams.requires_grad_(True)
    grads = {}
    for remat in (True, False):
        cfg = dataclasses.replace(port.cfg, remat=remat)
        pparams.zero_grad()
        loss = type(port)(cfg).loss(pparams, pb)
        loss.backward()
        grads[remat] = {n: p.grad.clone() for n, p in
                        pparams.named_parameters()}
    for n, g in grads[True].items():
        assert torch.equal(g, grads[False][n]), n


def test_serving_builds_no_autograd_graph():
    _, _, port, pparams = pair("yi-6b")
    pparams.requires_grad_(True)
    from repro_torch.serve import serve_step
    cache = serve_step.zero_cache(port, 1, 12, "cpu")
    logits, _ = port.prefill(pparams, {"tokens": torch.zeros(
        (1, 4), dtype=torch.int32)}, cache)
    assert not logits.requires_grad and logits.grad_fn is None
    toks = serve_step.greedy_decode(port, pparams, np.zeros((1, 4), np.int32),
                                    3, device="cpu")
    assert toks.shape == (1, 3)
