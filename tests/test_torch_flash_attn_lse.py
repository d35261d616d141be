"""The plain pieces of the bf16 attention backward's tensor-core route on the
CPU, against the JAX package:

* ``ref.mha_lse`` (the plain version of ``kernel.flash_attention(...,
  return_lse=True)``): its log-sum-exp against ``jax.nn.logsumexp`` of the
  masked, scaled logits ``repro.kernels.flash_attn.ref.mha`` builds, times
  log2(e) (the kernels' log2 domain), and its output against ``mha``'s;
* a plain transcription of the route's equations (``_wgmma_equations``: P
  from the forward's log-sum-exp, ``delta = rowsum(dO * O)``, the rows that
  see no key found by their index, the ragged key tail padded with zero
  keys and masked, dQ summed over the streamed key tiles and dK and dV
  over the streamed query tiles in order (64 rows, 32 at D = 192: the
  kernels' ``stream_rows``), dK and dV summed over the group in head
  order) against ``jax.vjp`` of ``mha`` and, at the wide heads, against
  ``ref.mha_vjp``;
* ``kernel.route_bwd`` and the wrapper's refusal of the tensor-core
  routes (``wgmma``, ``wgmma_f32``) without a log-sum-exp, at MLA's heads
  too.

Shapes cover GQA, causal with Sq > Sk (rows that see no key), ragged keys
and queries, D = 80 and 96, Dv != D without the mask, MLA's Dk 192 / Dv
128 and D = 256 (past the routes' limits; the equations hold there as
well).  Tolerances:
float32 ``F32_TOL = 1e-5`` of each gradient's (or output's) largest
magnitude (the same float32 math in another order; exp2 of a log2-domain
log-sum-exp for exp of a max-shifted logit); the log-sum-exp within
``LSE_ATOL = 1e-5`` (log2 units, values of order 1-10) on rows that see a
key; bf16 inputs ``2e-2`` (the attention's bf16 tolerance: 8 bits of
mantissa).  The kernels themselves are held to these plain versions on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.flash_attn import ref as fr
from repro_torch.kernels.flash_attn import kernel as pk, ref as pr

F32_TOL = 1e-5
LSE_ATOL = 1e-5
BF16_TOL = 2e-2
LOG2E = 1.4426950408889634
PLAIN_TOL = 1e-4   # the wide heads against ref.mha_vjp (chip_smoke.py's)


def _tile(D):
    """Rows of the tiles the bf16 kernels stream (csrc/flash_attn_bwd.cu:
    stream_rows): the dQ kernel's keys (its ragged tail padded with zero
    keys) and the dK/dV kernel's queries."""
    return 64 if D <= 128 else 32

# (B, Hq, Hkv, Sq, Sk, Dk, Dv, causal)
SHAPES = [
    (1, 4, 2, 64, 64, 32, 32, True),      # GQA
    (1, 4, 2, 40, 30, 16, 16, True),      # Sq > Sk: ten rows see no key
    (2, 4, 2, 37, 53, 16, 16, True),      # ragged keys and queries
    (1, 4, 1, 70, 70, 80, 80, True),      # Zamba2's depth, a group of 4
    (1, 2, 2, 50, 90, 96, 96, True),      # Phi-3's depth, ragged
    (1, 4, 2, 33, 70, 96, 64, False),     # Dv != D, no mask
    (1, 4, 2, 40, 70, 192, 128, True),    # MLA's Dk 192 / Dv 128, ragged
    (1, 2, 1, 50, 40, 192, 128, True),    # MLA's heads, ten rows see no key
    (1, 2, 2, 33, 45, 256, 256, False),   # D = 256, no mask
]
WIDE = [s for s in SHAPES if s[5] > 128]


def _inputs(shape, seed):
    B, Hq, Hkv, Sq, Sk, Dk, Dv, _ = shape
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32) for s in (
        (B, Hq, Sq, Dk), (B, Hkv, Sk, Dk), (B, Hkv, Sk, Dv), (B, Hq, Sq, Dv))]


def _jax_logits(q, k, causal):
    """``fr.mha``'s masked, scaled logits (its own construction)."""
    group = q.shape[1] // k.shape[1]
    Sq, Sk = q.shape[2], k.shape[2]
    kf = jnp.repeat(k.astype(jnp.float32), group, axis=1)
    logits = jnp.einsum("bhqd,bhkd->bhqk", q.astype(jnp.float32),
                        kf) * (1.0 / q.shape[-1] ** 0.5)
    if causal:
        mask = jnp.arange(Sk)[None, :] <= jnp.arange(Sq)[:, None] + (Sk - Sq)
        logits = jnp.where(mask[None, None], logits, -1e30)
    return logits


def _seen(shape):
    """Rows that see at least one key."""
    Sq, Sk, causal = shape[3], shape[4], shape[7]
    return np.arange(Sq) + (Sk - Sq) >= 0 if causal else np.ones(Sq, bool)


def _close(got, want, tol, what):
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        g = g.float().numpy() if torch.is_tensor(g) else g
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale,
                                   err_msg=f"{what} {name}")


def _wgmma_equations(q, k, v, out, dout, lse, causal):
    """(dq, dk, dv) as the tensor-core route computes them, in float32: the
    keys padded with zero rows to a multiple of the streamed tile (TMA's
    fill) and masked there, dQ summed over the key tiles and each head's
    dK and dV over the query tiles, in order."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    group = Hq // Hkv
    scale = 1.0 / D ** 0.5
    tile = _tile(D)
    pad = (-Sk) % tile
    kp, vp = (F.pad(t.float(), (0, 0, 0, pad)).repeat_interleave(group, 1)
              for t in (k, v))
    qf, of, dof = q.float(), out.float(), dout.float()
    x = torch.einsum("bhqd,bhkd->bhqk", qf, kp) * (scale * LOG2E)
    p = torch.exp2(x - lse[..., None])
    kpos = torch.arange(Sk + pad)
    qpos = torch.arange(Sq) + (Sk - Sq)
    vis = (kpos < Sk)[None, :].expand(Sq, -1)
    blind = torch.zeros(Sq, dtype=torch.bool)
    if causal:
        vis = vis & (kpos[None, :] <= qpos[:, None])
        blind = qpos < 0                     # by index, not by lse
    p = torch.where(vis, p, 0.0)
    # a row that sees no key: P = 1/Sk on every key for dV, no dS
    p_dv = torch.where(blind[:, None] & (kpos < Sk)[None, :], 1.0 / Sk, p)
    delta = (dof * of).sum(-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vp)
    ds = torch.where(blind[:, None], 0.0, p * (dp - delta[..., None]))
    dq = torch.zeros((B, Hq, Sq, D))
    for t0 in range(0, Sk + pad, tile):      # the dQ kernel's key tiles
        dq += torch.einsum("bhqk,bhkd->bhqd", ds[..., t0:t0 + tile],
                           kp[:, :, t0:t0 + tile])
    dq = scale * dq
    dk_h = torch.zeros((B, Hq, Sk + pad, D))
    dv_h = torch.zeros((B, Hq, Sk + pad, v.shape[-1]))
    for q0 in range(0, Sq, tile):            # the dK/dV kernel's query tiles
        rows = slice(q0, q0 + tile)
        dk_h += torch.einsum("bhqk,bhqd->bhkd", ds[:, :, rows],
                             qf[:, :, rows])
        dv_h += torch.einsum("bhqk,bhqd->bhkd", p_dv[:, :, rows],
                             dof[:, :, rows])
    dk_h = scale * dk_h
    dk, dv = (torch.zeros((B, Hkv, Sk + pad, t.shape[-1])) for t in (k, v))
    for g in range(group):                   # the reduce kernel's order
        dk += dk_h[:, g::group]
        dv += dv_h[:, g::group]
    return dq, dk[:, :, :Sk], dv[:, :, :Sk]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_mha_lse_matches_reference_logsumexp(shape):
    q, k, v, _ = _inputs(shape, 0)
    causal = shape[-1]
    want_lse = jax.jit(lambda a, b: jax.nn.logsumexp(
        _jax_logits(a, b, causal), axis=-1) * LOG2E)(q, k)
    want_out = jax.jit(fr.mha, static_argnames="causal")(q, k, v,
                                                         causal=causal)
    out, lse = pr.mha_lse(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal)
    assert lse.dtype == torch.float32 and lse.shape == shape[:2] + shape[3:4]
    seen = _seen(shape)
    np.testing.assert_allclose(lse.numpy()[..., seen],
                               np.asarray(want_lse)[..., seen], rtol=0,
                               atol=LSE_ATOL)
    # rows that see no key: hugely negative in both, read by no backward
    assert (lse.numpy()[..., ~seen] < -1e29).all()
    assert (np.asarray(want_lse)[..., ~seen] < -1e29).all()
    want_out = np.asarray(want_out)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=F32_TOL,
                               atol=F32_TOL * float(np.abs(want_out).max()))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_wgmma_equations_match_reference_vjp(shape):
    q, k, v, do = _inputs(shape, 1)
    causal = shape[-1]
    mha = jax.jit(fr.mha, static_argnames="causal")
    _, vjp = jax.vjp(lambda a, b, c: mha(a, b, c, causal=causal), q, k, v)
    want = [np.asarray(g, np.float32) for g in vjp(do)]
    tq, tk, tv, td = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = pr.mha_lse(tq, tk, tv, causal=causal)
    got = _wgmma_equations(tq, tk, tv, out, td, lse, causal)
    _close(got, want, F32_TOL, shape)


@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[3], SHAPES[5]],
                         ids=str)
def test_wgmma_equations_match_reference_vjp_bf16(shape):
    """bf16 inputs and output (the route's types), float32 math."""
    q, k, v, do = _inputs(shape, 2)
    causal = shape[-1]
    jq, jk, jv, jd = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    _, vjp = jax.vjp(jax.jit(lambda a, b, c: fr.mha(a, b, c, causal=causal)),
                     jq, jk, jv)
    want = [np.asarray(g, np.float32) for g in vjp(jd)]
    tq, tk, tv, td = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in (q, k, v, do))
    out, lse = pr.mha_lse(tq, tk, tv, causal=causal)
    assert out.dtype == torch.bfloat16
    got = _wgmma_equations(tq, tk, tv, out, td, lse, causal)
    _close(got, want, BF16_TOL, shape)


@pytest.mark.parametrize("shape", WIDE, ids=str)
def test_wgmma_equations_match_plain_vjp_wide(shape):
    """At MLA's heads and at 256, the tiled equations against the plain
    version of the backward kernel, ``ref.mha_vjp``, within 1e-4."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(shape, 4))
    causal = shape[-1]
    out, lse = pr.mha_lse(q, k, v, causal=causal)
    got = _wgmma_equations(q, k, v, out, do, lse, causal)
    want = pr.mha_vjp(q, k, v, do, causal=causal)
    _close(got, [w.numpy() for w in want], PLAIN_TOL, shape)


def test_route_bwd_names_the_tensor_core_route():
    bf16, f32 = torch.bfloat16, torch.float32
    for d, dv in ((128, 128), (96, 96), (80, 80), (64, 64), (16, 16),
                  (96, 64), (1, 128), (192, 128), (160, 64), (129, 1),
                  (64, 128)):
        assert pk.route_bwd(bf16, d, dv) == "wgmma"
        assert pk.route_bwd(f32, d, dv) == "wgmma_f32"
    for d, dv in ((256, 256), (128, 129), (193, 128), (192, 129),
                  (288, 128), (64, 192)):
        assert pk.route_bwd(bf16, d, dv) == "cuda_cores"
        assert pk.route_bwd(f32, d, dv) == "cuda_cores"


def test_wgmma_route_needs_the_forward_lse():
    B, Hq, Hkv, S, D = 1, 4, 2, 16, 32
    q, out, dout = (torch.zeros(B, Hq, S, D, dtype=torch.bfloat16)
                    for _ in range(3))
    k, v = (torch.zeros(B, Hkv, S, D, dtype=torch.bfloat16) for _ in range(2))
    with pytest.raises(ValueError, match="log-sum-exp"):
        pk.flash_attention_bwd(q, k, v, out, dout)
    with pytest.raises(ValueError, match="log-sum-exp"):
        pk.flash_attention_bwd(q, k, v, out, dout,
                               torch.zeros(B, Hq, S, dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_wide_tensor_core_routes_need_the_forward_lse(dtype):
    """At MLA's heads (Dk 192, Dv 128) both tensor-core routes read the
    forward's log-sum-exp, and the wrapper refuses a call without it."""
    B, Hq, Hkv, S = 1, 4, 2, 16
    q = torch.zeros(B, Hq, S, 192, dtype=dtype)
    out, dout = (torch.zeros(B, Hq, S, 128, dtype=dtype) for _ in range(2))
    k = torch.zeros(B, Hkv, S, 192, dtype=dtype)
    v = torch.zeros(B, Hkv, S, 128, dtype=dtype)
    which = pk.route_bwd(dtype, 192, 128)
    assert which == ("wgmma" if dtype == torch.bfloat16 else "wgmma_f32")
    with pytest.raises(ValueError, match=f"{which} route needs"):
        pk.flash_attention_bwd(q, k, v, out, dout)
    with pytest.raises(ValueError, match="log-sum-exp"):
        pk.flash_attention_bwd(q, k, v, out, dout,
                               torch.zeros(B, Hq, S + 1))


def test_f32_tensor_core_route_needs_the_forward_lse():
    B, Hq, Hkv, S, D = 1, 4, 2, 16, 32
    q, out, dout = (torch.zeros(B, Hq, S, D) for _ in range(3))
    k, v = (torch.zeros(B, Hkv, S, D) for _ in range(2))
    assert pk.route_bwd(torch.float32, D, D) == "wgmma_f32"
    with pytest.raises(ValueError, match="wgmma_f32 route needs"):
        pk.flash_attention_bwd(q, k, v, out, dout)
    with pytest.raises(ValueError, match="log-sum-exp"):
        pk.flash_attention_bwd(q, k, v, out, dout, torch.zeros(B, Hq, S + 1))
