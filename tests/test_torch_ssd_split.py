"""The arithmetic of the float32 SSD scan on the tensor cores
(``csrc/ssd_scan_f32.cu``, ``kernel.route`` ``"wgmma_f32"``), on the CPU:
the walk emulated in plain PyTorch, against the JAX package.

The emulation (``_walk``) takes the kernel's steps: chunks of 64 rows
whatever chunk is requested (the closed form is the same function for any
cut of L), a ragged last chunk padded with zeros; per chunk lam (the running
sum of A dt), w = exp(lam_end - lam) dt, and the four products G = C B^T,
C h, S x and B^T (w x), each the six partial products of
``ref.split3_bf16`` parts (``ref.SPLIT_PAIRS``, small first), each exact in
float32 and summed in float32, each chunk's into a fresh sum; then
y = exp(lam_i) (C h) + S x and h = exp(lam_end) h + B^T (w x), added in
float32.  Held to:

* the reference's ``ssd_chunked`` (on inputs padded to the requested chunk)
  and ``ssd_scan`` at its own tolerance, 5e-5 / 5e-4, and the final state
  to its ``ssd_final_state`` and the port's;
* the same closed form in float64 (``_walk`` with exact float64 products):
  the emulation's largest distance from it at most twice the plain float32
  version's (``ref.ssd_chunked``, ``ref.ssd_final_state``).

The kernel itself is held to the plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ref as jref
from repro_torch.kernels.flash_attn import ref as fref
from repro_torch.kernels.ssd_scan import ref as tref

ATOL, RTOL = 5e-5, 5e-4
Q = 64          # rows of the kernel's chunk

# name: ((B, L, H, P, G, N), requested chunk, decay)
CASES = {
    "zamba2_heads": ((1, 130, 4, 64, 1, 64), 64, 1.0),   # Zamba2's, narrowed
    "n128": ((1, 100, 2, 64, 1, 128), 64, 1.0),          # Mamba2-130M's N
    "grouped": ((2, 96, 8, 32, 4, 32), 64, 1.0),         # H 8 over G 4
    "ragged37": ((2, 37, 4, 16, 2, 16), 64, 1.0),
    "ragged301": ((1, 301, 4, 32, 2, 64), 64, 1.0),
    "chunk16": ((1, 150, 4, 32, 1, 32), 16, 1.0),
    "chunk128": ((1, 300, 2, 64, 1, 64), 128, 1.0),
    "large_decay": ((1, 200, 4, 16, 2, 32), 64, 100.0),  # A dt past 100
}


def _inputs(shape, seed, decay):
    """tests/test_kernels.py's draws; ``decay`` scales A."""
    B, L, H, P, G, N = shape
    r = np.random.default_rng(seed)
    x = r.normal(size=(B, L, H, P)).astype(np.float32)
    dt = (0.01 + r.random((B, L, H)) * 0.2).astype(np.float32)
    A = ((-0.5 - r.random(H)) * decay).astype(np.float32)
    Bm = r.normal(size=(B, L, G, N)).astype(np.float32)
    C = r.normal(size=(B, L, G, N)).astype(np.float32)
    return x, dt, A, Bm, C


def _six(eq, a, b):
    """einsum(eq, a, b) as the float32 walk takes it: the six partial
    products of a's and b's bf16 parts, small first, each exact in float32,
    summed in float32."""
    pa, pb = fref.split3_bf16(a), fref.split3_bf16(b)
    out = None
    for i, j in fref.SPLIT_PAIRS:
        term = torch.einsum(eq, pa[i].float(), pb[j].float())
        out = term if out is None else out + term
    return out


def _exact(eq, a, b):
    return torch.einsum(eq, a, b)


def _walk(x, dt, A, Bm, C, prod=_six):
    """(y, h_L) of the float32 walk's steps, each product by ``prod``; in
    the inputs' dtype (float64 with ``_exact``: the closed form in
    float64)."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    x, dt, Bm, C = tref.pad_to_chunk(Q, x, dt, Bm, C)
    Bh, Ch = (t.repeat_interleave(rep, dim=2) for t in (Bm, C))
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    h = torch.zeros((Bsz, H, N, P), dtype=x.dtype)
    ys = []
    for c0 in range(0, x.shape[1], Q):
        rows = slice(c0, c0 + Q)
        xc, dtc, Bc, Cc = x[:, rows], dt[:, rows], Bh[:, rows], Ch[:, rows]
        lam = torch.cumsum(A * dtc, dim=1)                    # (B, Q, H)
        lam_end = lam[:, -1]                                  # (B, H)
        w = torch.exp(lam_end[:, None] - lam) * dtc
        g = prod("bihn,bjhn->bhij", Cc, Bc)
        lh = lam.movedim(1, 2)                                # (B, H, Q)
        diff = lh[..., :, None] - lh[..., None, :]
        dec = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)),
                          0.0)
        s = g * dec * dtc.movedim(1, 2)[..., None, :]
        yc = prod("bihn,bhnp->bihp", Cc, h)
        ysx = prod("bhij,bjhp->bihp", s, xc)
        ys.append(torch.exp(lam)[..., None] * yc + ysx)
        hu = prod("bjhn,bjhp->bhnp", Bc, w[..., None] * xc)
        h = torch.exp(lam_end)[..., None, None] * h + hu
    return torch.cat(ys, dim=1)[:, :L], h


def _pad(arrs, chunk):
    L = arrs[0].shape[1]
    p = (-L) % chunk
    return [a if i == 2 else np.pad(a, [(0, 0), (0, p)]
                                     + [(0, 0)] * (a.ndim - 2))
            for i, a in enumerate(arrs)]


_chunked = jax.jit(jref.ssd_chunked, static_argnames="chunk")
_final = jax.jit(jref.ssd_final_state, static_argnames="chunk")
_scan = jax.jit(jref.ssd_scan)


@pytest.mark.parametrize("case", list(CASES), ids=str)
def test_walk_matches_reference_and_float64(case):
    shape, chunk, decay = CASES[case]
    arrs = _inputs(shape, sum(shape) + chunk, decay)
    L = shape[1]
    t = [torch.from_numpy(a) for a in arrs]
    y, h = _walk(*t)
    assert y.dtype == h.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    want_y = np.asarray(_chunked(*_pad(arrs, chunk), chunk=chunk))[:, :L]
    np.testing.assert_allclose(y.numpy(), want_y, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(_scan(*arrs)),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(_final(*arrs,
                                                            chunk=chunk)),
                               atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(h, tref.ssd_final_state(*t, chunk=chunk),
                               atol=ATOL, rtol=RTOL)
    # float64: the walk no further than twice the plain float32 version
    y64, h64 = _walk(*(a.double() for a in t), prod=_exact)
    tp = tref.pad_to_chunk(chunk, t[0], t[1], t[3], t[4])
    plain_y = tref.ssd_chunked(tp[0], tp[1], t[2], tp[2], tp[3],
                               chunk=chunk)[:, :L]
    plain_h = tref.ssd_final_state(*t, chunk=chunk)
    for got, plain, exact in ((y, plain_y, y64), (h, plain_h, h64)):
        err = float((got.double() - exact).abs().max())
        plain_err = float((plain.double() - exact).abs().max())
        assert err <= 2 * plain_err, (err, plain_err)


def test_walk_needs_the_third_part():
    """Two bf16 parts (about 16 bits, the bf16 walk's split) leave the
    walk past the float32 tolerance at Zamba2's narrowed heads: the third
    part is what float32 accuracy takes."""
    shape, chunk, decay = CASES["zamba2_heads"]
    t = [torch.from_numpy(a) for a in _inputs(shape, 3, decay)]

    def two(eq, a, b):
        hi, mid, _ = fref.split3_bf16(a)
        bh, bm, _ = fref.split3_bf16(b)
        out = None
        for pa, pb in ((mid, bh), (hi, bm), (hi, bh)):
            term = torch.einsum(eq, pa.float(), pb.float())
            out = term if out is None else out + term
        return out

    y2, _ = _walk(*t, prod=two)
    y3, _ = _walk(*t)
    y64, _ = _walk(*(a.double() for a in t), prod=_exact)
    err2 = float((y2.double() - y64).abs().max())
    err3 = float((y3.double() - y64).abs().max())
    assert err3 < ATOL < err2, (err3, err2)
