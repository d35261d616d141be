"""The gradient of the port's attention on the CPU: the plain version of the
backward kernel (``ref.mha_vjp``, ``torch.autograd.grad`` of ``ref.mha``)
against ``jax.vjp`` of the reference's ``ref.mha`` and ``ref.mha_chunked``,
and ``ops.attention``'s plain route under autograd against it.

Shapes cover GQA, causal with Sq < Sk, = Sk and > Sk (rows that see no key,
which send dout / Sk to every dV row and nothing to dQ or dK), a value
width other than the key depth (MLA's Dv != Dk), ragged lengths and no
mask.  Tolerances: float32 ``F32_TOL = 1e-5`` of each gradient's largest
magnitude (the same float32 math, summed over keys, queries and a group's
heads in another order); bf16 ``2e-2`` (the reference's attention
tolerance: inputs and gradients rounded to 8 bits of mantissa).  The
kernel itself is held to this plain version on the card
(``chip_smoke.py`` phase ``attention_grad_vs_plain``,
``tests/test_torch_gpu.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import ref as fr
from repro_torch.kernels.flash_attn import ops as po, ref as pr

F32_TOL = 1e-5
BF16_TOL = 2e-2

# (B, Hq, Hkv, Sq, Sk, Dk, Dv, causal)
SHAPES = [
    (1, 4, 2, 64, 64, 32, 32, True),      # GQA
    (2, 4, 4, 37, 53, 16, 16, True),      # ragged, a query tail
    (1, 4, 2, 40, 30, 8, 8, True),        # Sq > Sk: ten rows see no key
    (1, 2, 1, 20, 48, 24, 16, True),      # Dv != Dk
    (2, 4, 2, 33, 70, 16, 16, False),     # no mask, ragged
    (1, 6, 2, 100, 300, 36, 20, True),    # odd depth, Dv < Dk
]


def _inputs(shape, seed, dtype=np.float32):
    B, Hq, Hkv, Sq, Sk, Dk, Dv, _ = shape
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, Hq, Sq, Dk)).astype(np.float32)
    k = r.standard_normal((B, Hkv, Sk, Dk)).astype(np.float32)
    v = r.standard_normal((B, Hkv, Sk, Dv)).astype(np.float32)
    do = r.standard_normal((B, Hq, Sq, Dv)).astype(np.float32)
    return q, k, v, do


def _ref_vjp(fn, q, k, v, do, **kw):
    out, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, **kw), q, k, v)
    return [np.asarray(g, np.float32) for g in vjp(do.astype(out.dtype))]


def _close(got, want, tol, what):
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        g = g.float().numpy() if torch.is_tensor(g) else g
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_vjp_matches_reference_mha(shape):
    q, k, v, do = _inputs(shape, 0)
    causal = shape[-1]
    want = _ref_vjp(jax.jit(fr.mha, static_argnames="causal"), q, k, v, do,
                    causal=causal)
    got = pr.mha_vjp(*(torch.from_numpy(a) for a in (q, k, v, do)),
                     causal=causal)
    _close(got, want, F32_TOL, shape)


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[3], SHAPES[5]], ids=str)
def test_plain_vjp_matches_reference_bf16(shape):
    q, k, v, do = _inputs(shape, 1)
    causal = shape[-1]
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    out, vjp = jax.vjp(lambda a, b, c: fr.mha(a, b, c, causal=causal),
                       jq, jk, jv)
    want = [np.asarray(g, np.float32)
            for g in vjp(jnp.asarray(do, jnp.bfloat16))]
    tq, tk, tv, td = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in (q, k, v, do))
    got = pr.mha_vjp(tq, tk, tv, td, causal=causal)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _close(got, want, BF16_TOL, shape)


@pytest.mark.parametrize("shape,block_k", [
    ((1, 4, 2, 64, 128, 32, 32, True), 32),
    ((1, 2, 1, 20, 48, 24, 16, True), 16),   # Dv != Dk, the chunked route
    ((2, 4, 2, 33, 70, 16, 16, False), 32),  # ragged last block
], ids=str)
def test_plain_vjp_matches_reference_mha_chunked(shape, block_k):
    q, k, v, do = _inputs(shape, 2)
    causal = shape[-1]
    want = _ref_vjp(jax.jit(fr.mha_chunked,
                            static_argnames=("causal", "block_k")),
                    q, k, v, do, causal=causal, block_k=block_k)
    got = pr.mha_vjp(*(torch.from_numpy(a) for a in (q, k, v, do)),
                     causal=causal)
    _close(got, want, F32_TOL, shape)


def test_rows_that_see_no_key_feed_only_dv():
    """Causal Sq > Sk: the first Sq - Sk queries see no key (every logit
    -1e30: the mean of v).  Their gradient is dout / Sk on every dV row and
    nothing on dQ or dK."""
    B, Hq, Hkv, Sq, Sk, D = 1, 2, 1, 12, 5, 8
    q, k, v, do = _inputs((B, Hq, Hkv, Sq, Sk, D, D, True), 3)
    do[:, :, Sq - Sk:] = 0.0                  # only the blind rows' dout
    dq, dk, dv = pr.mha_vjp(*(torch.from_numpy(a) for a in (q, k, v, do)))
    assert float(dq.abs().max()) == 0.0 and float(dk.abs().max()) == 0.0
    want = do[:, :, :Sq - Sk].sum(axis=(1, 2)) / Sk     # (B, D), both heads
    np.testing.assert_allclose(dv.numpy(), np.broadcast_to(
        want[:, None, None], dv.shape), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[3]], ids=str)
def test_attention_plain_route_differentiates(shape):
    """``ops.attention`` on CPU tensors runs the plain route under ordinary
    autograd (``mha``, or ``mha_chunked`` for Dv != Dk): its gradient is
    the plain VJP's."""
    q, k, v, do = _inputs(shape, 4)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = po.attention(*ts, causal=shape[-1])
    out.backward(torch.from_numpy(do))
    want = pr.mha_vjp(*(torch.from_numpy(a) for a in (q, k, v, do)),
                      causal=shape[-1])
    _close([t.grad for t in ts], [w.numpy() for w in want], F32_TOL, shape)
    assert po.BWD_LAUNCHES == 0
