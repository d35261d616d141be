"""The arithmetic of the float32 attention routes on the tensor cores, on the
CPU: ``ref.split3_bf16`` (each float32 operand as three bf16 parts) and
attention whose matrix products are each the six partial products
``ref.SPLIT_PAIRS`` names, against the JAX package.

* The three parts sum back to x within 2^-24 |x| (float32's own rounding),
  and the largest is x rounded to bf16.
* A product from the six partial products (each part product exact, summed
  in float32, as the tensor cores sum a tile) is within 2^-20 of the
  float64 product, relative to sum |a| |b|: the dropped products are below
  2^-24 and float32 sums add a few ulps.
* The forward with both products so taken (S = Q K^T, then O = P V with P
  split again) is within 2e-5 of ``ref.mha`` and of the reference's
  ``mha`` (the forward's float32 tolerance), and the backward's equations
  with every product so taken (S, dP, dV, dQ, dK; P and dS split) within
  ``F32_TOL`` of ``jax.vjp`` of the reference's ``mha``.
* The kernels' tiling of those products (``_forward_tiled``,
  ``_backward_tiled``): the forward's online softmax over key tiles of 64
  (32 at D = 192), each tile's P V into a fresh accumulator added to O in
  float32; the backward's dQ over key tiles and dK, dV over query tiles of
  32 rows, each tile's products fresh, dQ's 64 columns at a time at D =
  192; within 2e-5 (forward) and ``F32_TOL`` (backward) of the
  reference, and 1e-4 of the plain ``ref.mha_vjp``, at MLA's Dk 192 / Dv
  128 and at 256.

The kernels themselves are held to the plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import ref as fr
from repro_torch.kernels.flash_attn import ref as pr

F32_TOL = 1e-5     # the backward's equations, of each gradient's largest
ATTN_TOL = 2e-5    # the forward's float32 tolerance (the reference's own)

# (B, Hq, Hkv, Sq, Sk, D, Dv, causal)
SHAPES = [
    (1, 4, 2, 64, 64, 32, 32, True),      # GQA
    (1, 4, 2, 40, 30, 16, 16, True),      # Sq > Sk: ten rows see no key
    (2, 4, 2, 37, 53, 36, 36, True),      # ragged keys and queries, D = 36
    (1, 2, 2, 50, 90, 96, 96, True),      # Phi-3's depth, ragged
    (1, 4, 1, 33, 70, 128, 64, False),    # Dv != D, no mask
    (1, 4, 2, 40, 70, 192, 128, True),    # MLA's Dk 192 / Dv 128, ragged
    (1, 2, 1, 50, 40, 192, 128, True),    # MLA's heads, ten rows see no key
    (1, 2, 2, 33, 45, 256, 256, False),   # D = 256, no mask
]
WIDE = [s for s in SHAPES if s[5] > 128]
PLAIN_TOL = 1e-4   # the backward against ref.mha_vjp (chip_smoke.py's)


def _inputs(shape, seed):
    B, Hq, Hkv, Sq, Sk, D, Dv, _ = shape
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32) for s in (
        (B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, Dv), (B, Hq, Sq, Dv))]


def _six(eq, a, b):
    """einsum(eq, a, b) as the float32 routes compute it: the six partial
    products of a's and b's bf16 parts, small first, each exact in float32
    (two bf16 significands of 8 bits), summed in float32."""
    pa, pb = pr.split3_bf16(a), pr.split3_bf16(b)
    out = None
    for i, j in pr.SPLIT_PAIRS:
        term = torch.einsum(eq, pa[i].float(), pb[j].float())
        out = term if out is None else out + term
    return out


def _mask(Sq, Sk, causal):
    kpos = torch.arange(Sk)
    vis = torch.ones(Sq, Sk, dtype=torch.bool)
    blind = torch.zeros(Sq, dtype=torch.bool)
    if causal:
        qpos = torch.arange(Sq) + (Sk - Sq)
        vis = kpos[None, :] <= qpos[:, None]
        blind = qpos < 0
    return vis, blind


def _forward(q, k, v, causal):
    """(out, lse): attention with S and P V from six partial products."""
    B, Hq, Sq, D = q.shape
    group = Hq // k.shape[1]
    Sk = k.shape[2]
    kr, vr = (t.repeat_interleave(group, 1) for t in (k, v))
    x = _six("bhqd,bhkd->bhqk", q, kr) * (D ** -0.5 * pr.LOG2E)
    vis, _ = _mask(Sq, Sk, causal)
    x = torch.where(vis, x, pr.NEG_INF)
    m = x.amax(-1, keepdim=True)
    p = torch.exp2(x - m)
    l = p.sum(-1, keepdim=True)
    out = _six("bhqk,bhkd->bhqd", p, vr) / l
    return out, (m + torch.log2(l))[..., 0]


def _backward(q, k, v, out, dout, lse, causal):
    """(dq, dk, dv) of the float32 route's equations with every product
    from six partial products: P from the forward's log-sum-exp, delta =
    rowsum(dO * O), rows that see no key by their index."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = D ** -0.5
    kr, vr = (t.repeat_interleave(group, 1) for t in (k, v))
    x = _six("bhqd,bhkd->bhqk", q, kr) * (scale * pr.LOG2E)
    vis, blind = _mask(Sq, Sk, causal)
    p = torch.where(vis, torch.exp2(x - lse[..., None]), 0.0)
    p_dv = torch.where(blind[:, None], 1.0 / Sk, p)
    delta = (dout * out).sum(-1)
    dp = _six("bhqd,bhkd->bhqk", dout, vr)
    ds = torch.where(blind[:, None], 0.0, p * (dp - delta[..., None]))
    dq = scale * _six("bhqk,bhkd->bhqd", ds, kr)
    dk_h = scale * _six("bhqk,bhqd->bhkd", ds, q)
    dv_h = _six("bhqk,bhqd->bhkd", p_dv, dout)
    dk = sum(dk_h[:, g::group] for g in range(group))
    dv = sum(dv_h[:, g::group] for g in range(group))
    return dq, dk, dv


def _key_tile(D):
    """Keys a tile of the float32 forward (csrc/flash_attn_f32.cu: KB)."""
    return 64 if D <= 128 else 32


# Rows of the float32 backward's streamed tiles (csrc/flash_attn_bwd_f32.cu:
# F3_KV_QT, F3_DQ_KT).
STREAM_ROWS = 32


def _forward_tiled(q, k, v, causal):
    """(out, lse) as the float32 forward kernel computes them: the online
    softmax over key tiles (log2 domain, masked logits -1e30, keys past Sk
    -inf), S of a tile from six products, P V of a tile from six products
    into a fresh accumulator, added to the rescaled O in float32."""
    B, Hq, Sq, D = q.shape
    group = Hq // k.shape[1]
    Sk, Dv = k.shape[2], v.shape[-1]
    kr, vr = (t.repeat_interleave(group, 1) for t in (k, v))
    vis, _ = _mask(Sq, Sk, causal)
    m = torch.full((B, Hq, Sq, 1), pr.NEG_INF)
    l = torch.zeros((B, Hq, Sq, 1))
    o = torch.zeros((B, Hq, Sq, Dv))
    kb = _key_tile(D)
    for k0 in range(0, Sk, kb):
        keys = slice(k0, k0 + kb)
        x = _six("bhqd,bhkd->bhqk", q, kr[:, :, keys]) * (D ** -0.5
                                                            * pr.LOG2E)
        x = torch.where(vis[:, keys], x, pr.NEG_INF)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _six("bhqk,bhkd->bhqd", p, vr[:, :, keys])
        m = m_new
    return o / torch.clamp(l, min=1e-30), (m + torch.log2(l))[..., 0]


def _backward_tiled(q, k, v, out, dout, lse, causal):
    """(dq, dk, dv) as the float32 backward kernels take the products: dQ
    over key tiles (each tile's six products fresh, CW columns at a time:
    all of them up to D = 128, 64 at D = 192), each head's dK and dV over
    query tiles (each tile's six products fresh), added in float32 in
    order; then dK and dV summed over the group in head order."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = D ** -0.5
    rows = STREAM_ROWS
    cw = D if D <= 128 else 64
    kr, vr = (t.repeat_interleave(group, 1) for t in (k, v))
    vis, blind = _mask(Sq, Sk, causal)
    delta = (dout * out).sum(-1)
    dq = torch.zeros_like(q)
    for k0 in range(0, Sk, rows):            # the dQ kernel's key tiles
        keys = slice(k0, k0 + rows)
        x = _six("bhqd,bhkd->bhqk", q, kr[:, :, keys]) * (scale * pr.LOG2E)
        p = torch.where(vis[:, keys], torch.exp2(x - lse[..., None]), 0.0)
        dp = _six("bhqd,bhkd->bhqk", dout, vr[:, :, keys])
        ds = torch.where(blind[:, None], 0.0, p * (dp - delta[..., None]))
        for c0 in range(0, D, cw):
            dq[..., c0:c0 + cw] += _six("bhqk,bhkd->bhqd", ds,
                                        kr[:, :, keys, c0:c0 + cw])
    dk_h = torch.zeros((B, Hq, Sk, D))
    dv_h = torch.zeros((B, Hq, Sk, v.shape[-1]))
    for q0 in range(0, Sq, rows):            # the dK/dV kernel's query tiles
        qs = slice(q0, q0 + rows)
        x = _six("bhqd,bhkd->bhqk", q[:, :, qs], kr) * (scale * pr.LOG2E)
        p = torch.where(vis[qs], torch.exp2(x - lse[:, :, qs, None]), 0.0)
        p_dv = torch.where(blind[qs, None], 1.0 / Sk, p)
        dp = _six("bhqd,bhkd->bhqk", dout[:, :, qs], vr)
        ds = torch.where(blind[qs, None], 0.0,
                         p * (dp - delta[:, :, qs, None]))
        dk_h += _six("bhqk,bhqd->bhkd", ds, q[:, :, qs])
        dv_h += _six("bhqk,bhqd->bhkd", p_dv, dout[:, :, qs])
    dk = sum(scale * dk_h[:, g::group] for g in range(group))
    dv = sum(dv_h[:, g::group] for g in range(group))
    return scale * dq, dk, dv


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3], ids=str)
def test_split3_bf16_sums_back_to_float32(scale):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096).astype(np.float32) * scale)
    hi, mid, lo = pr.split3_bf16(x)
    assert all(t.dtype == torch.bfloat16 for t in (hi, mid, lo))
    assert torch.equal(hi, x.to(torch.bfloat16))
    back = hi.double() + mid.double() + lo.double()
    assert bool(((back - x.double()).abs()
                 <= 2.0 ** -24 * x.double().abs()).all())
    # each part at most 2^-8 of the one before it (a bf16 rounding error)
    assert bool((mid.double().abs() <= 2.0 ** -8 * hi.double().abs()).all())
    assert bool((lo.double().abs() <= 2.0 ** -8 * mid.double().abs()).all())


def test_six_partial_products_match_float64_product():
    r = np.random.default_rng(1)
    a = torch.from_numpy(r.standard_normal((3, 64, 128)).astype(np.float32))
    b = torch.from_numpy(r.standard_normal((3, 128, 96)).astype(np.float32))
    got = _six("bik,bkj->bij", a, b).double()
    want = torch.einsum("bik,bkj->bij", a.double(), b.double())
    bound = torch.einsum("bik,bkj->bij", a.double().abs(), b.double().abs())
    assert bool(((got - want).abs() <= 2.0 ** -20 * bound).all())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forward_from_six_products_matches_reference(shape):
    q, k, v, _ = _inputs(shape, 2)
    causal = shape[-1]
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = _forward(tq, tk, tv, causal)
    want = jax.jit(fr.mha, static_argnames="causal")(q, k, v, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=ATTN_TOL,
                               atol=ATTN_TOL)
    plain, plain_lse = pr.mha_lse(tq, tk, tv, causal=causal)
    torch.testing.assert_close(out, plain, rtol=ATTN_TOL, atol=ATTN_TOL)
    seen = ~_mask(shape[3], shape[4], causal)[1]
    torch.testing.assert_close(lse[..., seen], plain_lse[..., seen], rtol=0,
                               atol=ATTN_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_backward_from_six_products_matches_reference_vjp(shape):
    q, k, v, do = _inputs(shape, 3)
    causal = shape[-1]
    mha = jax.jit(fr.mha, static_argnames="causal")
    _, vjp = jax.vjp(lambda a, b, c: mha(a, b, c, causal=causal), q, k, v)
    want = [np.asarray(g, np.float32) for g in vjp(do)]
    tq, tk, tv, td = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = _forward(tq, tk, tv, causal)
    got = _backward(tq, tk, tv, out, td, lse, causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(g.numpy(), w, rtol=F32_TOL,
                                   atol=F32_TOL * scale, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_tiled_forward_matches_reference(shape):
    """The float32 forward kernel's tiling (32-key tiles at D = 192) within
    2e-5 of the reference's ``mha`` and of ``ref.mha_lse``."""
    q, k, v, _ = _inputs(shape, 4)
    causal = shape[-1]
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = _forward_tiled(tq, tk, tv, causal)
    want = jax.jit(fr.mha, static_argnames="causal")(q, k, v, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=ATTN_TOL,
                               atol=ATTN_TOL)
    plain, plain_lse = pr.mha_lse(tq, tk, tv, causal=causal)
    torch.testing.assert_close(out, plain, rtol=ATTN_TOL, atol=ATTN_TOL)
    seen = ~_mask(shape[3], shape[4], causal)[1]
    torch.testing.assert_close(lse[..., seen], plain_lse[..., seen], rtol=0,
                               atol=ATTN_TOL)


@pytest.mark.parametrize("shape", WIDE, ids=str)
def test_tiled_backward_matches_reference_vjp_wide(shape):
    """The float32 backward kernels' tiling at MLA's heads and at 256 (32-row
    tiles, dQ's fresh accumulators 64 columns wide) within ``F32_TOL`` of
    ``jax.vjp`` of the reference's ``mha`` and ``PLAIN_TOL`` of the plain
    ``ref.mha_vjp``."""
    q, k, v, do = _inputs(shape, 5)
    causal = shape[-1]
    mha = jax.jit(fr.mha, static_argnames="causal")
    _, vjp = jax.vjp(lambda a, b, c: mha(a, b, c, causal=causal), q, k, v)
    want = [np.asarray(g, np.float32) for g in vjp(do)]
    tq, tk, tv, td = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = _forward_tiled(tq, tk, tv, causal)
    got = _backward_tiled(tq, tk, tv, out, td, lse, causal)
    plain = pr.mha_vjp(tq, tk, tv, td, causal=causal)
    for g, w, p, name in zip(got, want, plain, ("dq", "dk", "dv")):
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(g.numpy(), w, rtol=F32_TOL,
                                   atol=F32_TOL * scale, err_msg=name)
        torch.testing.assert_close(g, p, rtol=PLAIN_TOL,
                                   atol=PLAIN_TOL * scale)
