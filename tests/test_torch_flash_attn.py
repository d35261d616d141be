"""The port's attention (``repro_torch.kernels.flash_attn``) against the JAX
reference on the CPU: the plain versions against ``ref.mha`` /
``ref.mha_chunked`` and against the Pallas kernel in interpret mode, the
ragged key lengths that the Pallas kernel refuses, and the wrapper's
routing.

Tolerances are the reference's own (``tests/test_kernels.py``): 2e-5 in
float32 (the same float32 math, summed in another order) and 2e-2 in bf16
(inputs and outputs rounded to bf16, 8 bits of mantissa).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import kernel as fk, ops as fo, ref as fr

from repro_torch.kernels.flash_attn import kernel as pk, ops as po, ref as pr

# test_kernels.py's flash-attention shapes: (B, Hq, Hkv, Sq, Sk, D)
SHAPES = [
    (1, 4, 2, 128, 128, 64),
    (2, 8, 8, 256, 256, 64),
    (1, 8, 1, 128, 128, 128),
    (1, 4, 4, 1, 256, 64),      # decode
    (2, 6, 2, 64, 256, 32),     # Sq < Sk (query tail)
]
DTYPES = {"float32": (np.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
# The reference's plain versions under jax.jit: the same functions, compiled
# whole rather than op by op as eager calls are (about 5x quicker here).
ref_mha = jax.jit(fr.mha, static_argnames=("causal", "scale"))
ref_mha_chunked = jax.jit(fr.mha_chunked,
                          static_argnames=("causal", "scale", "block_k"))


def _inputs(shape, seed, dv=None):
    B, Hq, Hkv, Sq, Sk, D = shape
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, Hq, Sq, D)).astype(np.float32)
    k = r.standard_normal((B, Hkv, Sk, D)).astype(np.float32)
    v = r.standard_normal((B, Hkv, Sk, dv or D)).astype(np.float32)
    return q, k, v


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_mha_matches_reference(shape, dtype, causal):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(shape, sum(shape)), dtype)
    want = ref_mha(jq, jk, jv, causal=causal)
    got = pr.mha(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_attention_matches_pallas_kernel_interpret(shape, dtype):
    """The wrapper's CPU route against the Pallas kernel run in interpret
    mode with 64-wide tiles (every SHAPES key length is a multiple of
    64)."""
    assert shape[4] % 64 == 0
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(shape, 7 + sum(shape)), dtype)
    want = fk.flash_attention(jq, jk, jv, causal=True, block_q=64,
                              block_k=64)
    got = po.attention(tq, tk, tv, causal=True)
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fn", ["mha", "mha_chunked"])
@pytest.mark.parametrize("D", [36, 136, 256])
def test_plain_versions_match_reference_at_wide_head_dims(D, fn, dtype):
    """Head dims the CUDA kernels take since they pad to their tile depth
    (36: not a multiple of 8; 136 and 256: past one 128-column tile)."""
    shape = (1, 4, 2, 40, 70, D)
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(shape, D), dtype)
    if fn == "mha":
        want = ref_mha(jq, jk, jv, causal=True)
        got = pr.mha(tq, tk, tv, causal=True)
    else:
        want = ref_mha_chunked(jq, jk, jv, causal=True, block_k=32)
        got = pr.mha_chunked(tq, tk, tv, causal=True, block_k=32)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("block_k", [32, 100, 128])
@pytest.mark.parametrize("shape", [(1, 4, 2, 64, 300, 32),
                                   (2, 6, 3, 37, 37, 16),
                                   (1, 2, 1, 1, 129, 64)], ids=str)
def test_plain_chunked_matches_reference(shape, block_k):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(shape, 3), "float32")
    want = ref_mha_chunked(jq, jk, jv, causal=True, block_k=block_k)
    got = pr.mha_chunked(tq, tk, tv, causal=True, block_k=block_k)
    _close(got, want, 2e-5)


def test_plain_chunked_mixed_dims_matches_reference():
    """MLA's shape (Dk != Dv) goes through ``mha_chunked`` in both."""
    (jq, jk, jv), (tq, tk, tv) = _both(
        _inputs((1, 4, 4, 64, 64, 48), 5, dv=32), "float32")
    want = fo.attention(jq, jk, jv, causal=True, backend="xla")
    got = po.attention(tq, tk, tv, causal=True)
    assert got.shape == (1, 4, 64, 32)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("Sq", ["all", 1, 5])
@pytest.mark.parametrize("Sk", [1, 8, 37, 100])
def test_ragged_key_lengths_match_mha(Sk, Sq, dtype):
    """Prompt lengths that are not a multiple of 128: the reference's
    Pallas kernel refuses them, the port's route takes them and agrees
    with ``ref.mha``."""
    Sq = Sk if Sq == "all" else min(Sq, Sk)
    shape = (2, 8, 2, Sq, Sk, 32)
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(shape, Sk * 10 + Sq), dtype)
    want = ref_mha(jq, jk, jv, causal=True)
    got = po.attention(tq, tk, tv, causal=True)
    _close(got, want, DTYPES[dtype][2])
    with pytest.raises(ValueError, match="multiple of block_k"):
        fo.attention(jq, jk, jv, causal=True, backend="pallas")


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_attention_routes_like_the_reference_cpu_path(backend, monkeypatch):
    """``mha`` up to 1,024 keys, ``mha_chunked`` with ``block_k=min(512,
    Sk)`` beyond, and for Dv != Dk; no kernel launch on CPU tensors."""
    calls = []
    for name in ("mha", "mha_chunked"):
        orig = getattr(pr, name)

        def rec(*a, _name=name, _orig=orig, **kw):
            calls.append((_name, kw.get("block_k")))
            return _orig(*a, **kw)
        monkeypatch.setattr(pr, name, rec)
    before = po.LAUNCHES
    for Sk, dv, want in ((1024, 16, ("mha", None)),
                         (1025, 16, ("mha_chunked", 512)),
                         (300, 8, ("mha_chunked", 300))):
        q, k, v = _inputs((1, 2, 1, 3, Sk, 16), Sk, dv=dv)
        calls.clear()
        got = po.attention(*map(torch.from_numpy, (q, k, v)),
                           backend=backend)
        assert calls == [want], (Sk, calls)
        ref = fo.attention(*map(jnp.asarray, (q, k, v)), backend="xla")
        _close(got, ref, 2e-5)
    assert po.LAUNCHES == before


def test_kernel_wrapper_refuses_what_it_cannot_take():
    """Malformed input only: every head dim >= 1, causal Sq > Sk and every
    floating dtype are taken."""
    q = torch.zeros(1, 4, 8, 32)
    k = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        pk.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        pk.flash_attention(torch.zeros(1, 4, 8, 36), torch.zeros(1, 2, 8, 36),
                           torch.zeros(1, 2, 8, 36))
    # causal Sq > Sk, float16 and mixed dtypes are taken: they reach the
    # device check
    with pytest.raises(ValueError, match="CUDA"):
        pk.flash_attention(torch.zeros(1, 4, 9, 32), k, k)
    with pytest.raises(ValueError, match="CUDA"):
        pk.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="CUDA"):
        pk.flash_attention(q.bfloat16(), k, k)
    with pytest.raises(ValueError, match="floating point"):
        pk.flash_attention(q.int(), k, k)
    with pytest.raises(ValueError, match="fit"):
        pk.flash_attention(torch.zeros(1, 3, 8, 32), k, k)
    with pytest.raises(ValueError, match="head dim"):
        pk.flash_attention(torch.zeros(1, 4, 8, 0), torch.zeros(1, 2, 8, 0),
                           torch.zeros(1, 2, 8, 0))
    assert pk.kernel_ready(q) and pk.kernel_ready(q.transpose(1, 2))
    assert not pk.kernel_ready(q.transpose(2, 3))


@pytest.mark.parametrize("D", [1, 36, 80, 128, 136, 192, 193, 256, 300])
def test_kernel_route_and_ready_copy(D):
    """bf16 up to D = 256 takes the bf16 tensor-core kernel, float32 with q's
    head dim up to 192 and v's width up to 128 (MLA's 192 / 128) the
    float32 tensor-core kernel, a wider float32 head or v and a bf16 head
    past 256 the CUDA-core kernel; ``ready_copy`` pads rows to a multiple
    of 8 elements and keeps the values."""
    assert pk.route(torch.bfloat16, D) == ("wgmma" if D <= 256
                                           else "cuda_cores")
    assert pk.route(torch.float32, D) == ("wgmma_f32" if D <= 128
                                          else "cuda_cores")
    assert pk.route(torch.float32, D, 129) == "cuda_cores"
    assert pk.route(torch.float32, D, 64) == ("wgmma_f32" if D <= 192
                                              else "cuda_cores")
    assert pk.route(torch.float32, D, 128) == ("wgmma_f32" if D <= 192
                                               else "cuda_cores")
    t = torch.from_numpy(np.random.default_rng(D).standard_normal(
        (2, 3, 5, D)).astype(np.float32)).transpose(1, 2)
    c = pk.ready_copy(t)
    assert pk.kernel_ready(c) and torch.equal(c, t)
    assert c.stride(-2) == -(-D // 8) * 8


def test_causal_more_queries_than_keys_matches_reference():
    """Causal with Sq > Sk: the first Sq - Sk queries sit at negative
    positions, see no key and give the mean of v (every logit -1e30);
    the port's plain path against ``mha``, the Pallas kernel in interpret
    mode and ``ops.attention(backend="xla")``, float32 at 2e-5."""
    q, k, v = _inputs((1, 2, 1, 160, 128, 16), 21)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    got = po.attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    assert torch.isfinite(got).all()
    for want in (ref_mha(jq, jk, jv, causal=True),
                 fk.flash_attention(jq, jk, jv, causal=True, interpret=True),
                 fo.attention(jq, jk, jv, causal=True, backend="xla")):
        _close(got, want, 2e-5)
    mean_v = torch.from_numpy(v[0, 0].mean(0))
    for h in range(2):
        _close(got[0, h, :32], mean_v.expand(32, 16).numpy(), 2e-5)


@pytest.mark.parametrize("dtypes", [("float16",) * 3,
                                    ("bfloat16", "float32", "float32"),
                                    ("float32", "bfloat16", "float16")],
                         ids=["float16", "bf16_q", "mixed3"])
def test_half_and_mixed_dtypes_match_reference(dtypes):
    """float16 and mixed dtypes compute in float32 from the inputs' own
    values and return q's dtype, as the reference's ``mha`` and (for
    float16) its Pallas kernel in interpret mode do; at 2e-2."""
    arrs = _inputs((1, 4, 2, 128, 128, 16), 22)
    jdt = {"float16": jnp.float16, "bfloat16": jnp.bfloat16,
           "float32": jnp.float32}
    tdt = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32}
    j = [jnp.asarray(a, jdt[d]) for a, d in zip(arrs, dtypes)]
    t = [torch.from_numpy(a).to(tdt[d]) for a, d in zip(arrs, dtypes)]
    got = po.attention(*t)
    assert got.dtype == tdt[dtypes[0]]
    want = fr.mha(*j)
    assert want.dtype == jdt[dtypes[0]]
    _close(got, want, 2e-2)
    if len(set(dtypes)) == 1:
        _close(got, fk.flash_attention(*j, causal=True, interpret=True),
               2e-2)
