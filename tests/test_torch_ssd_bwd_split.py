"""The arithmetic of the bf16 SSD scan's backward on the tensor cores
(``csrc/ssd_scan_bwd_wgmma.cu``, ``kernel.route_bwd`` ``"wgmma"``), on the
CPU: its dataflow transcribed in plain PyTorch, against the JAX package and
against float64.

The transcription (``_route``) takes the kernel's steps on bf16 x, B, C and
dy: chunks of 64 rows whatever chunk is requested (a ragged last chunk
padded with zeros and dt = 0); lam, w = e^{Lend - lam} dt and el = e^{lam}
in float32; the chunk states B^T (w x) and dh terms C^T (el dy) with w x
and el dy split into three bf16 parts (``_split3``); the carries in
float32; per chunk G = C B^T and dS = dy x^T (bf16 products, float32
sums), S, dG, T and R, the row and column sums of R and T in float64; dx =
w (B dh1) + S^T dy with S split in two and dh1 in three (``_split3``), z =
x . (B dh1) and cq = dy . (C h0) with h0 in three; each run of
``kernel.heads_per_cta`` consecutive heads sums its dG in float32 in head
order, and its dB and dC in float32: per head (w x) dh1^T and (el dy)
h0^T with w x and el dy in two parts (``_split2``) and dh1 and h0 in
their first two (hi and mid), three products (lo hi, hi mid, hi hi), then
dGs^T C and dGs B (dGs in two); the runs of a group summed in float64 and rounded to bf16;
dlam, its suffix sums, ddt and dA in float64.  Every product is exact in
float32 (bf16 parts) and summed in float32, as the tensor cores sum them
(their order inside a product is not modelled).

Held to ``jax.vjp`` of the reference's ``ssd_chunked`` (under ``jax.jit``,
on inputs padded to the chunk) at ``BF16_TOL`` = 2e-2 of each gradient's
largest magnitude (the forward's bf16 tolerance), and to float64
``ref.ssd_vjp`` of the same bf16 inputs: its distance (the largest over the
five gradients of the largest error over the gradient's largest magnitude)
at most twice that of the CUDA-core kernel's float32 arithmetic
(``test_torch_ssd_grad._formulas`` in float32, outputs in the kernel's
dtypes).  The kernel itself is held to ``ref.ssd_vjp`` on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ref as jref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ref as tref
from test_torch_ssd_grad import _formulas

BF16_TOL = 2e-2
Q = 64          # rows of the kernel's chunk
NAMES = ("dx", "ddt", "dA", "dB", "dC")

# name: ((B, L, H, P, G, N), requested chunk, decay, final-state gradient)
CASES = {f"{name}_L{L}": ((1, L, *heads), 64, 1.0, L == 37)
         for name, heads in (("zamba2", (80, 64, 1, 64)),
                             ("mamba2", (24, 64, 1, 128)))
         for L in (1, 37, 128)}
CASES.update({
    "grouped_ragged": ((2, 100, 8, 64, 4, 32), 64, 1.0, True),
    "chunk16_ragged": ((1, 70, 4, 16, 2, 16), 16, 1.0, False),
})


def _bf(t):
    return t.to(torch.bfloat16).float()


def _split2(t):
    """hi = bf16(t), lo = bf16(t - hi) (the kernel's split_bf16)."""
    hi = _bf(t)
    return hi, _bf(t - hi)


def _split3(t):
    """hi, mid, lo: each bf16 of what the parts before leave
    (``hopper.cuh``'s split3_pair)."""
    hi = _bf(t)
    r = t - hi
    mid = _bf(r)
    return hi, mid, _bf(r - mid)


def _pad(t, nc):
    """Zero rows past L on axis 1, to nc chunks of Q."""
    pad = nc * Q - t.shape[1]
    if not pad:
        return t
    z = torch.zeros((t.shape[0], pad) + t.shape[2:], dtype=t.dtype)
    return torch.cat([t, z], dim=1)


def _route(x, dt, A, Bm, C, dy, dh_final=None, *, split=True, hpc=None):
    """(dx, ddt, dA, dB, dC) by the tensor-core route's dataflow (module
    docstring), in the kernel's output dtypes.  ``split=False`` rounds each
    float32 operand (S, dG's sum, h0, dh1, w x, el dy) to bf16 once instead
    of splitting it."""
    s2 = _split2 if split else (lambda t: (_bf(t),))
    s3 = _split3 if split else (lambda t: (_bf(t),))
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    hpc = hpc or ssd_kernel.heads_per_cta(Bsz, L, H, G)
    nrun = H // hpc
    nc = -(-L // Q)
    f = torch.float32
    xp = _pad(x.float(), nc).reshape(Bsz, nc, Q, H, P)
    dyp = _pad(dy.float(), nc).reshape(Bsz, nc, Q, H, P)
    Bp = _pad(Bm.float(), nc).reshape(Bsz, nc, Q, G, N)
    Cp = _pad(C.float(), nc).reshape(Bsz, nc, Q, G, N)
    Bh = Bp.repeat_interleave(rep, 3)
    Ch = Cp.repeat_interleave(rep, 3)
    dtp = _pad(dt.float(), nc).reshape(Bsz, nc, Q, H)
    valid = (torch.arange(nc * Q) < L).reshape(1, nc, Q, 1)
    lam = torch.cumsum(A.float() * dtp, dim=2)
    lend = lam[:, :, -1]                                        # (B, nc, H)
    w = torch.where(valid, torch.exp(lend[:, :, None] - lam) * dtp, 0.0)
    el = torch.where(valid, torch.exp(lam), 0.0)

    # Launch 1: s = B^T (w x), u = C^T (el dy); launch 2: the carries.
    s = sum(torch.einsum("bcjhn,bcjhp->bchnp", Bh, part)
            for part in s3(w[..., None] * xp))
    u = sum(torch.einsum("bcihn,bcihp->bchnp", Ch, part)
            for part in s3(el[..., None] * dyp))
    h0, h = [], torch.zeros((Bsz, H, N, P), dtype=f)
    for c in range(nc):
        h0.append(h)
        h = torch.exp(lend[:, c])[..., None, None] * h + s[:, c]
    dh1 = [None] * nc
    dh = (torch.zeros((Bsz, H, N, P), dtype=f) if dh_final is None
          else dh_final.float())
    for c in reversed(range(nc)):
        dh1[c] = dh
        dh = torch.exp(lend[:, c])[..., None, None] * dh + u[:, c]
    h0, dh1 = torch.stack(h0, 1), torch.stack(dh1, 1)          # (B,nc,H,N,P)

    # Launch 3.
    Gm = torch.einsum("bcihn,bcjhn->bchij", Ch, Bh)
    dS = torch.einsum("bcihp,bcjhp->bchij", dyp, xp)
    lh = lam.permute(0, 1, 3, 2)                                # (B, nc, H, Q)
    rows_ok = valid.reshape(1, nc, 1, Q, 1)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool)) & rows_ok
    e = torch.where(mask, torch.exp(torch.where(
        mask, lh[..., :, None] - lh[..., None, :], 0.0)), 0.0)
    dtj = dtp.permute(0, 1, 3, 2)[..., None, :]
    S = torch.where(mask, Gm * e * dtj, 0.0)
    T = torch.where(mask, dS * Gm * e, 0.0)
    dG = torch.where(mask, dS * e * dtj, 0.0)
    R = T * dtj
    rowR, colR = R.double().sum(-1), R.double().sum(-2)         # (B,nc,H,Q)
    colT = T.double().sum(-2)
    v = sum(torch.einsum("bcjhn,bchnp->bcjhp", Bh, part)
            for part in s3(dh1))
    z = (xp * v).sum(-1)                                        # (B,nc,Q,H)
    yc = sum(torch.einsum("bcihn,bchnp->bcihp", Ch, part)
             for part in s3(h0))
    cq = (dyp * yc).sum(-1)
    dx = w[..., None] * v + sum(torch.einsum("bchij,bcihp->bcjhp", part, dyp)
                                for part in s2(S))
    dB_run = torch.zeros((Bsz, nc, Q, nrun, N), dtype=f)
    dC_run = torch.zeros((Bsz, nc, Q, nrun, N), dtype=f)
    wx_hl, ed_hl = s2(w[..., None] * xp), s2(el[..., None] * dyp)
    d1_hm, h0_hm = s3(dh1)[:2], s3(h0)[:2]     # hi and mid: the two-way split
    for r in range(nrun):
        dGs = torch.zeros((Bsz, nc, Q, Q), dtype=f)
        for h in range(r * hpc, (r + 1) * hpc):
            for acc, a_parts, t_parts in ((dB_run, wx_hl, d1_hm),
                                          (dC_run, ed_hl, h0_hm)):
                pairs = ([(1, 0), (0, 1), (0, 0)] if split else [(0, 0)])
                for ia, it in pairs:
                    acc[:, :, :, r] += torch.einsum(
                        "bcqp,bcnp->bcqn", a_parts[ia][:, :, :, h],
                        t_parts[it][:, :, h])
            dGs = dGs + dG[:, :, h]
        g = (r * hpc) // rep
        for part in reversed(s2(dGs)):
            dC_run[:, :, :, r] += part @ Bp[:, :, :, g]
            dB_run[:, :, :, r] += part.transpose(-1, -2) @ Cp[:, :, :, g]
    rpg = rep // hpc
    dB = dB_run.double().reshape(Bsz, nc, Q, G, rpg, N).sum(4)
    dC = dC_run.double().reshape(Bsz, nc, Q, G, rpg, N).sum(4)

    # The tail, a chunk at a time, in float64.
    hd = (h0.double() * dh1.double()).sum((-1, -2))              # (B,nc,H)
    ddt = torch.zeros((Bsz, nc, Q, H), dtype=torch.float64)
    dA = torch.zeros((H,), dtype=torch.float64)
    for c in range(nc):
        rows = min(Q, L - c * Q)
        zc, wc = z[:, c].double(), w[:, c].double()             # (B, Q, H)
        dl = (rowR[:, c] - colR[:, c]).permute(0, 2, 1) \
            + el[:, c].double() * cq[:, c].double() - zc * wc
        dl[:, rows:] = 0
        dl[:, rows - 1] += (zc * wc).sum(1) + torch.exp(
            lend[:, c]).double() * hd[:, c]
        sfx = torch.flip(torch.cumsum(torch.flip(dl, [1]), 1), [1])
        ddt[:, c] = colT[:, c].permute(0, 2, 1) + zc * torch.exp(
            lend[:, c][:, None] - lam[:, c]).double() + A.double() * sfx
        dA += (dtp[:, c].double() * sfx).sum((0, 1))
    cut = lambda t: t.reshape(Bsz, nc * Q, *t.shape[3:])[:, :L]
    return (cut(dx).to(x.dtype), cut(ddt).float(), dA.float(),
            cut(dB).to(Bm.dtype), cut(dC).to(C.dtype))


def _inputs(shape, seed, decay=1.0):
    """x, dt, A, B, C, dy and dh (the port's test draws; ``decay`` scales
    A), x, B, C and dy rounded to bf16 as torch tensors."""
    B, L, H, P, G, N = shape
    r = np.random.default_rng(seed)
    x = r.normal(size=(B, L, H, P))
    dt = 0.01 + r.random((B, L, H)) * 0.2
    A = (-0.5 - r.random(H)) * decay
    Bm = r.normal(size=(B, L, G, N))
    C = r.normal(size=(B, L, G, N))
    dy = r.normal(size=(B, L, H, P))
    dh = r.normal(size=(B, H, N, P))
    t = [torch.from_numpy(a.astype(np.float32)) for a in
         (x, dt, A, Bm, C, dy, dh)]
    for i in (0, 3, 4, 5):
        t[i] = t[i].bfloat16()
    return t


@functools.lru_cache(maxsize=None)
def _ref_vjp(L, chunk, final_state):
    """jit of the reference's vjp (on zero-padded inputs), as
    ``test_torch_ssd_grad``'s."""
    def pad(a):
        p = (-L) % chunk
        return jnp.pad(a, [(0, 0), (0, p)] + [(0, 0)] * (a.ndim - 2))

    def fn(x, dt, A, Bm, C):
        y = jref.ssd_chunked(pad(x), pad(dt), A, pad(Bm), pad(C),
                             chunk=chunk)[:, :L]
        if not final_state:
            return y
        return y, jref.ssd_final_state(x, dt, A, Bm, C, chunk=chunk)

    def vjp(x, dt, A, Bm, C, *cot):
        _, back = jax.vjp(fn, x, dt, A, Bm, C)
        return back(cot if final_state else cot[0])
    return jax.jit(vjp)


def _jnp(t):
    return jnp.asarray(t.float().numpy(),
                       jnp.bfloat16 if t.dtype == torch.bfloat16
                       else jnp.float32)


def _rel(got, exact):
    """Each gradient's largest distance from ``exact`` over the largest
    magnitude of ``exact`` (over 1 where it is 0)."""
    return [float((g.double() - e).abs().max()) / (float(e.abs().max())
                                                  or 1.0)
            for g, e in zip(got, exact)]


def _f32_kernel(x, dt, A, Bm, C, dy, dh, chunk):
    """The CUDA-core kernel's float32 arithmetic (``_formulas``), its
    outputs in the inputs' dtypes as the kernel stores them."""
    got = _formulas(x, dt, A, Bm, C, dy, chunk=chunk, dh_final=dh,
                    dtype=torch.float32)
    return tuple(g.to(t.dtype) for g, t in zip(got, (x, dt, A, Bm, C)))


@pytest.mark.parametrize("name", list(CASES))
def test_route_matches_reference_and_float64(name):
    """Zamba2-2.7B's and Mamba2-130M's heads at L = 1, 37 (with a final
    state's gradient) and 128, grouped heads over a ragged length and a
    requested chunk of 16: within 2e-2 of ``jax.vjp`` of the reference, and
    no further from float64 than twice the CUDA-core kernel's float32
    arithmetic."""
    shape, chunk, decay, final = CASES[name]
    x, dt, A, Bm, C, dy, dh = _inputs(shape, 0, decay)
    dh = dh if final else None
    got = _route(x, dt, A, Bm, C, dy, dh)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16]
    L = shape[1]
    cot = (_jnp(dy),) + (() if dh is None else (_jnp(dh),))
    want = _ref_vjp(L, chunk, final)(*map(_jnp, (x, dt, A, Bm, C)), *cot)
    for g, w, what in zip(got, want, NAMES):
        w = np.asarray(w, np.float64)
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(g.double().numpy(), w, rtol=0,
                                   atol=BF16_TOL * scale,
                                   err_msg=f"{name} {what}")
    exact = tref.ssd_vjp(*(t.double() for t in (x, dt, A, Bm, C)),
                         dy.double(), chunk=chunk,
                         dh_final=None if dh is None else dh.double())
    ours = max(_rel(got, exact))
    f32 = max(_rel(_f32_kernel(x, dt, A, Bm, C, dy, dh, chunk), exact))
    assert ours <= 2 * f32, (name, ours, f32)


def test_route_large_decay_reference_nan_route_finite():
    """A = -16, dt = 0.1, chunk 64: a chunk's decay sums to 102.4.  The
    reference's gradient is NaN in ddt, dA, dB and dC; the route's is
    finite, its dx within 2e-2 of the reference's, and every gradient no
    further from float64 than twice the CUDA-core kernel's arithmetic."""
    shape = (1, 128, 4, 64, 1, 64)
    x, _, _, Bm, C, dy, _ = _inputs(shape, 3)
    dt = torch.full(shape[:3], 0.1)
    A = torch.full(shape[2:3], -16.0)
    got = _route(x, dt, A, Bm, C, dy)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    want = _ref_vjp(128, 64, False)(*map(_jnp, (x, dt, A, Bm, C, dy)))
    nan = [bool(np.isnan(np.asarray(w, np.float32)).any()) for w in want]
    assert nan == [False, True, True, True, True], nan
    w = np.asarray(want[0], np.float64)
    np.testing.assert_allclose(got[0].double().numpy(), w, rtol=0,
                               atol=BF16_TOL * float(np.abs(w).max()))
    exact = tref.ssd_vjp(*(t.double() for t in (x, dt, A, Bm, C)),
                         dy.double())
    ours = max(_rel(got, exact))
    f32 = max(_rel(_f32_kernel(x, dt, A, Bm, C, dy, None, 64), exact))
    assert ours <= 2 * f32, (ours, f32)


@pytest.mark.parametrize("hpc", [1, 2, 8])
def test_head_runs_change_only_the_order(hpc):
    """The run length (heads a block sums in float32 before the fixed-order
    sum of the runs in float64) changes dB and dC only by float32 order:
    within one bf16 unit (2^-8) of their largest magnitude, the rest equal."""
    x, dt, A, Bm, C, dy, _ = _inputs((1, 100, 8, 64, 1, 64), 5)
    one = _route(x, dt, A, Bm, C, dy, hpc=1)
    got = _route(x, dt, A, Bm, C, dy, hpc=hpc)
    for g, o in zip(got[:3], one[:3]):
        assert torch.equal(g, o)
    for g, o in zip(got[3:], one[3:]):
        assert float((g.float() - o.float()).abs().max()) \
            <= 2 ** -8 * float(o.float().abs().max())


def test_low_parts_buy_accuracy():
    """What the low parts buy, at Zamba2-2.7B's heads (L = 128): with S,
    dG's sum, h0, dh1, w x and el dy each rounded to bf16 once, ddt and dA
    (float32 outputs, through z, cq and the carries) are more than ten times
    further from float64 than with the split operands, and the largest
    distance of any gradient is larger."""
    x, dt, A, Bm, C, dy, dh = _inputs((1, 128, 80, 64, 1, 64), 7)
    exact = tref.ssd_vjp(*(t.double() for t in (x, dt, A, Bm, C)),
                         dy.double(), dh_final=dh.double())
    split = _rel(_route(x, dt, A, Bm, C, dy, dh), exact)
    once = _rel(_route(x, dt, A, Bm, C, dy, dh, split=False), exact)
    assert once[1] > 10 * split[1] and once[2] > 10 * split[2], (once, split)
    assert max(once) > max(split), (once, split)
