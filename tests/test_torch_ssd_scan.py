"""The port's SSD scan (``repro_torch.kernels.ssd_scan``: the plain
versions ``ssd_scan``, ``ssd_chunked``, ``ssd_final_state`` and the
wrapper ``ops.ssd``) against the JAX reference's plain versions
(``repro.kernels.ssd_scan.ref``) on the same numpy inputs, on the CPU.

Tolerance: the reference's own, atol 5e-5 and rtol 5e-4
(``tests/test_kernels.py``): the same float32 math, its sums taken in
another order.  The reference's Pallas kernel is not run: it fails on this
JAX (``pl.store``, ``ROADMAP.md`` B8), and the CUDA kernel is held to these
plain versions on the card (``test_torch_gpu.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ref as jref

from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as tref

ATOL, RTOL = 5e-5, 5e-4
# (B, L, H, P, G, N): tests/test_kernels.py's SSD_SHAPES, then Zamba2-2.7B's
# heads (80 of P = 64, N = 64) and Mamba2-130M's (24 of P = 64, N = 128),
# at ragged lengths.
SHAPES = [(1, 64, 2, 16, 1, 16), (2, 128, 4, 32, 2, 64),
          (1, 96, 8, 64, 4, 32), (1, 100, 80, 64, 1, 64),
          (2, 37, 24, 64, 1, 128)]


def _inputs(shape, seed, decay=1.0):
    """tests/test_kernels.py's draws; ``decay`` scales A."""
    B, L, H, P, G, N = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dt = (0.01 + rng.random((B, L, H)) * 0.2).astype(np.float32)
    A = ((-0.5 - rng.random(H)) * decay).astype(np.float32)
    Bm = rng.normal(size=(B, L, G, N)).astype(np.float32)
    C = rng.normal(size=(B, L, G, N)).astype(np.float32)
    return x, dt, A, Bm, C


def _both(shape, seed, decay=1.0):
    arrs = _inputs(shape, seed, decay)
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(a) for a in arrs])


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def _pad(arrs, chunk=64):
    L = arrs[0].shape[1]
    p = (-L) % chunk
    return [a if i == 2 else jnp.pad(a, [(0, 0), (0, p)] +
                                     [(0, 0)] * (a.ndim - 2))
            for i, a in enumerate(arrs)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_sequential_scan_matches_reference(shape):
    j, t = _both(shape, sum(shape))
    got = tref.ssd_scan(*t)
    assert got.dtype == torch.float32 and got.shape == shape[:4]
    _close(got, jref.ssd_scan(*j))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_chunked_matches_reference(shape):
    """The chunked closed form on zero-padded inputs (the reference's
    ``ssd_chunked`` needs L % chunk == 0), against both reference forms."""
    j, t = _both(shape, sum(shape) + 1)
    jp = _pad(j)
    tp = tref.pad_to_chunk(64, t[0], t[1], t[3], t[4])
    got = tref.ssd_chunked(tp[0], tp[1], t[2], tp[2], tp[3])
    L = shape[1]
    _close(got, jref.ssd_chunked(*jp))
    _close(got[:, :L], jref.ssd_scan(*j))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_final_state_matches_reference(shape):
    j, t = _both(shape, sum(shape) + 2)
    got = tref.ssd_final_state(*t)
    B, L, H, P, G, N = shape
    assert got.shape == (B, H, N, P) and got.dtype == torch.float32
    _close(got, jref.ssd_final_state(*j))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ops_pads_like_the_reference(shape):
    """``ops.ssd`` on CPU tensors (``auto`` and ``torch``) pads L to the
    chunk and cuts the result back, as ``repro``'s ``ops.ssd`` does; no
    kernel is launched."""
    j, t = _both(shape, sum(shape) + 3)
    want = jref.ssd_scan(*j)
    before = ssd_ops.LAUNCHES
    for backend in ("auto", "torch"):
        got = ssd_ops.ssd(*t, backend=backend)
        assert got.shape == shape[:4]
        _close(got, want)
    assert ssd_ops.LAUNCHES == before


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ops_final_state_matches_reference(shape):
    """``ops.ssd(..., final_state=True)`` on CPU tensors (``auto`` and
    ``torch``): y against the reference's ``ssd_chunked`` (on the padded
    inputs, cut back) and h against its ``ssd_final_state``, at ragged L
    and G > 1; no kernel is launched."""
    j, t = _both(shape, sum(shape) + 4)
    L = shape[1]
    want_y = np.asarray(jref.ssd_chunked(*_pad(j)))[:, :L]
    want_h = jref.ssd_final_state(*j)
    before = ssd_ops.LAUNCHES
    for backend in ("auto", "torch"):
        y, h = ssd_ops.ssd(*t, backend=backend, final_state=True)
        assert y.shape == shape[:4] and h.dtype == torch.float32
        assert h.shape == (shape[0], shape[2], shape[5], shape[3])
        _close(y, want_y)
        _close(h, want_h)
    assert ssd_ops.LAUNCHES == before


def test_kernel_routes():
    """The bf16 tensor-core walk takes bf16 with N <= 256, the float32 one
    float32 (the goldens; float16 and mixed dtypes read in float32) with N
    <= 128 (Zamba2-2.7B's 64, Mamba2-130M's 128); wider states take the
    CUDA-core route; the backward's tensor-core route takes bf16 with N <=
    128 and P <= 256, in runs of up to 8 heads a block.  A CTA of a walk takes 32 P columns while those CTAs
    fit one an SM (Mamba2-130M's 24 heads), where N is past what a CTA of
    64 columns holds (128 in bf16, 64 in float32) or P <= 32, else 64
    (Zamba2-2.7B's 80 heads)."""
    assert ssd_kernel.route(torch.bfloat16, 64) == "wgmma"
    assert ssd_kernel.route(torch.bfloat16, 256) == "wgmma"
    assert ssd_kernel.route(torch.bfloat16, 257) == "cuda_cores"
    assert ssd_kernel.route(torch.float32, 64) == "wgmma_f32"
    assert ssd_kernel.route(torch.float32, 128) == "wgmma_f32"
    assert ssd_kernel.route(torch.float32, 129) == "cuda_cores"
    assert ssd_kernel.route(torch.float32, 256) == "cuda_cores"
    assert ssd_kernel.WGMMA_F32_MAX_N == 128
    assert set(ssd_ops.ROUTE_LAUNCHES) == {"wgmma", "wgmma_f32",
                                           "cuda_cores"}
    # The backward: bf16 on the tensor cores up to N = 128 (Mamba2-130M's)
    # and P = 256, the rest (float32, float16 and mixed dtypes, wider
    # states or heads) on the CUDA cores.
    assert ssd_kernel.WGMMA_BWD_MAX_N == 128
    assert ssd_kernel.WGMMA_BWD_MAX_P == 256
    assert ssd_kernel.route_bwd(torch.bfloat16, 64, 64) == "wgmma"
    assert ssd_kernel.route_bwd(torch.bfloat16, 128, 64) == "wgmma"
    assert ssd_kernel.route_bwd(torch.bfloat16, 128, 256) == "wgmma"
    assert ssd_kernel.route_bwd(torch.bfloat16, 32, 1) == "wgmma"
    assert ssd_kernel.route_bwd(torch.bfloat16, 129, 64) == "cuda_cores"
    assert ssd_kernel.route_bwd(torch.bfloat16, 64, 257) == "cuda_cores"
    assert ssd_kernel.route_bwd(torch.float32, 64, 64) == "cuda_cores"
    assert set(ssd_ops.BWD_ROUTE_LAUNCHES) == {"wgmma", "cuda_cores"}
    # The binding counts its own launches; ops reads the same counts.
    assert ssd_ops.BWD_ROUTE_LAUNCHES is ssd_kernel.BWD_ROUTE_LAUNCHES
    assert ssd_kernel.heads_per_cta(1, 4096, 80, 1) == 8     # Zamba2-2.7B
    assert ssd_kernel.heads_per_cta(2, 2048, 24, 1) == 2     # Mamba2-130M
    assert ssd_kernel.heads_per_cta(1, 64, 8, 4) == 1
    for dtype in (torch.float16, torch.bfloat16, torch.float32):
        x = torch.zeros(1, 1, 1, 1, dtype=dtype)
        f = torch.zeros(1, 1, 1, 1)
        assert ssd_kernel.route(ssd_kernel.compute_dtype(x, f, f),
                                64) == "wgmma_f32"
    assert ssd_kernel.p_tile(64, 64, 80) == 64
    assert ssd_kernel.p_tile(64, 128, 24) == 32
    assert ssd_kernel.p_tile(64, 64, 66) == 32
    assert ssd_kernel.p_tile(64, 64, 67) == 64
    assert ssd_kernel.p_tile(64, 256, 400) == 32
    assert ssd_kernel.p_tile(16, 64, 400) == 32
    f32 = torch.float32
    assert ssd_kernel.p_tile(64, 64, 80, dtype=f32) == 64
    assert ssd_kernel.p_tile(64, 64, 66, dtype=f32) == 32
    assert ssd_kernel.p_tile(64, 128, 24, dtype=f32) == 32
    assert ssd_kernel.p_tile(64, 128, 400, dtype=f32) == 32
    assert ssd_kernel.p_tile(16, 64, 400, dtype=f32) == 32


@pytest.mark.parametrize("decay", [1.0, 100.0], ids=str)
def test_chunked_matches_reference_at_wide_shapes(decay):
    """Head dim P = 128, state N = 256 and chunk = 128 (the CUDA kernel
    tiles P and N and runs chunks of 64): the chunked closed form and
    ``ops.ssd`` against the reference's ``ssd_chunked`` and ``ssd_scan``;
    ``decay=100`` sums A * dt past 100 within a chunk."""
    shape = (1, 200, 2, 128, 1, 256)
    j, t = _both(shape, 11, decay)
    jp = _pad(j, 128)
    tp = tref.pad_to_chunk(128, t[0], t[1], t[3], t[4])
    got = tref.ssd_chunked(tp[0], tp[1], t[2], tp[2], tp[3], chunk=128)
    assert bool(torch.isfinite(got).all())
    _close(got, jref.ssd_chunked(*jp, chunk=128))
    _close(got[:, :200], jref.ssd_scan(*j))
    _close(ssd_ops.ssd(*t, chunk=128), jref.ssd_scan(*j))


def test_large_decay_is_finite():
    """``A * dt`` summing past 100 within a chunk: ``exp(lam_i - lam_j)``
    overflows for j > i, which a 0/1 mask would turn into NaN; the plain
    versions drop those entries with a ``where`` and stay finite and equal
    to the sequential scan."""
    shape = (1, 128, 4, 16, 2, 16)
    j, t = _both(shape, 7, decay=100.0)
    A, dt = t[2].double(), t[1].double()
    assert float((-A[None, None] * dt)[:, :64].sum(1).min()) > 100
    seq = tref.ssd_scan(*t)
    for got in (tref.ssd_chunked(*t), ssd_ops.ssd(*t)):
        assert bool(torch.isfinite(got).all())
        _close(got, seq)
    _close(seq, jref.ssd_scan(*j))


def test_bf16_inputs_return_bf16():
    """bf16 x, B and C (the model's full-size dtype) compute in float32 and
    round once to bf16, in both packages."""
    shape = (1, 70, 8, 16, 2, 16)
    arrs = _inputs(shape, 11)
    jb = [jnp.asarray(a, jnp.bfloat16 if i in (0, 3, 4) else jnp.float32)
          for i, a in enumerate(arrs)]
    tb = [torch.from_numpy(a).to(torch.bfloat16 if i in (0, 3, 4)
                                 else torch.float32)
          for i, a in enumerate(arrs)]
    got = ssd_ops.ssd(*tb)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jref.ssd_chunked(*_pad(jb)), np.float32)[:, :70]
    # one bf16 rounding of the same float32 value: at most one bf16 step
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2,
                               rtol=2 ** -7)


def test_kernel_wrapper_checks_its_inputs():
    """The CUDA wrapper refuses what the kernel does not take before it
    builds or launches anything: CPU tensors, integer inputs, mismatched
    shapes, an empty chunk, head dim or state.  Mixed dtypes and a float64
    dt are taken: they reach the device check."""
    _, (x, dt, A, Bm, C) = _both((1, 8, 4, 16, 2, 16), 0)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_scan(x, dt, A, Bm, C)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_scan(x, dt, A, Bm.bfloat16(), C)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_scan(x, dt.double(), A, Bm, C)
    with pytest.raises(ValueError, match="floating point"):
        ssd_kernel.ssd_scan(x, dt, A, Bm.int(), C)
    with pytest.raises(ValueError, match="chunk"):
        ssd_kernel.ssd_scan(x, dt, A, Bm, C, chunk=0)
    with pytest.raises(ValueError, match="shapes"):
        ssd_kernel.ssd_scan(x, dt, A[:3], Bm, C)
    empty = torch.zeros((1, 8, 2, 0))
    with pytest.raises(ValueError, match="N >= 1"):
        ssd_kernel.ssd_scan(x, dt, A, empty, empty)
    with pytest.raises(ValueError, match="backend"):
        ssd_ops.ssd(x, dt, A, Bm, C, backend="pallas")


@pytest.mark.parametrize("dtypes", [("float16",) * 3,
                                    ("bfloat16", "float32", "float32"),
                                    ("float32", "float16", "bfloat16")],
                         ids=["float16", "bf16_x", "mixed3"])
def test_half_and_mixed_dtypes_match_reference(dtypes):
    """x, B and C in float16 or mixed dtypes compute in float32 from the
    inputs' own values and return x's dtype, as the reference's
    ``ssd_chunked`` does (its Pallas kernel does not run here); at 2e-2."""
    shape = (1, 64, 2, 16, 1, 16)
    x, dt, A, Bm, C = _inputs(shape, 12)
    jdt = {"float16": jnp.float16, "bfloat16": jnp.bfloat16,
           "float32": jnp.float32}
    tdt = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32}
    dx, dB, dC = dtypes
    got = ssd_ops.ssd(torch.from_numpy(x).to(tdt[dx]), torch.from_numpy(dt),
                      torch.from_numpy(A), torch.from_numpy(Bm).to(tdt[dB]),
                      torch.from_numpy(C).to(tdt[dC]))
    assert got.dtype == tdt[dx]
    want = jref.ssd_chunked(jnp.asarray(x, jdt[dx]), jnp.asarray(dt),
                            jnp.asarray(A), jnp.asarray(Bm, jdt[dB]),
                            jnp.asarray(C, jdt[dC]))
    assert want.dtype == jdt[dx]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)
