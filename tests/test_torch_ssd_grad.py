"""The gradient of the port's SSD scan on the CPU: the plain version of the
backward kernel (``ref.ssd_vjp``, ``torch.autograd.grad`` of
``ref.ssd_chunked`` and ``ref.ssd_final_state``) against ``jax.vjp`` of the
reference's ``ssd_chunked`` and ``ssd_final_state``; the backward kernel's
equations (``csrc/ssd_scan_bwd.cu``'s header), transcribed here in float64,
against it; and ``ops.SSDScan``'s wiring with the kernel bindings replaced
by their plain versions.

Tolerances, each of a gradient's largest magnitude: float32 ``F32_TOL =
1e-5`` (the same float32 math, summed in another order); bf16 ``2e-2``
(inputs and gradients rounded to 8 bits of mantissa), and ``2^-8`` plus
F32_TOL against the float64 gradient of the same bf16 inputs where 24
heads share a group (one rounding of the group's sum); float64 ``1e-10``
(the transcription against autograd of the closed form, both in float64).

At a chunk decay past ~88, ``jax.grad`` of the reference's ``ssd_chunked``
is NaN (it exponentiates ``lam_i - lam_j`` for ``j > i`` too, and the
``where`` that drops those entries passes ``0 * inf`` back; ``ROADMAP.md``
§C); the port's plain gradient exponentiates only where ``j <= i`` and is
held there to float64 autograd of the sequential ``ref.ssd_scan``.  The
kernel itself is held to ``ref.ssd_vjp`` on the card (``chip_smoke.py``
phase ``ssd_grad_vs_plain``, ``tests/test_torch_gpu.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ref as jref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as tref

F32_TOL = 1e-5
BF16_TOL = 2e-2
F64_TOL = 1e-10
NAMES = ("dx", "ddt", "dA", "dB", "dC")

# (B, L, H, P, G, N, chunk): a ragged L with 4 heads over 2 groups at chunks
# of 16 and 64, one chunk exactly, two groups of one head each.
CASES = [(1, 50, 4, 8, 2, 6, 16), (2, 100, 4, 16, 2, 8, 64),
         (1, 64, 2, 8, 2, 4, 64), (2, 37, 4, 8, 1, 8, 16)]


def _inputs(shape, seed, decay=1.0, dtype=np.float32):
    """x, dt, A, B, C (tests/test_kernels.py's draws; ``decay`` scales A),
    dy and the final state's gradient dh."""
    B, L, H, P, G, N = shape[:6]
    r = np.random.default_rng(seed)
    x = r.normal(size=(B, L, H, P))
    dt = 0.01 + r.random((B, L, H)) * 0.2
    A = (-0.5 - r.random(H)) * decay
    Bm = r.normal(size=(B, L, G, N))
    C = r.normal(size=(B, L, G, N))
    dy = r.normal(size=(B, L, H, P))
    dh = r.normal(size=(B, H, N, P))
    return [a.astype(dtype) for a in (x, dt, A, Bm, C, dy, dh)]


def _pad(a, L, chunk):
    p = (-L) % chunk
    return jnp.pad(a, [(0, 0), (0, p)] + [(0, 0)] * (a.ndim - 2))


@functools.lru_cache(maxsize=None)
def _ref_vjp(L, chunk, final_state):
    """jit of the reference's vjp: (x, dt, A, B, C, dy[, dh]) -> the five
    gradients of ``ssd_chunked`` on zero-padded inputs (and of
    ``ssd_final_state``)."""
    def fn(x, dt, A, Bm, C):
        y = jref.ssd_chunked(_pad(x, L, chunk), _pad(dt, L, chunk), A,
                             _pad(Bm, L, chunk), _pad(C, L, chunk),
                             chunk=chunk)[:, :L]
        if not final_state:
            return y
        return y, jref.ssd_final_state(x, dt, A, Bm, C, chunk=chunk)

    def vjp(x, dt, A, Bm, C, *cot):
        out, back = jax.vjp(fn, x, dt, A, Bm, C)
        return back(cot if final_state else cot[0])
    return jax.jit(vjp)


def _close(got, want, tol, what):
    for g, w, name in zip(got, want, NAMES):
        g = g.double().numpy() if torch.is_tensor(g) else np.asarray(g)
        w = w.double().numpy() if torch.is_tensor(w) else np.asarray(
            w, np.float64)
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_vjp_matches_reference(case):
    x, dt, A, Bm, C, dy, _ = _inputs(case, 0)
    L, chunk = case[1], case[6]
    want = _ref_vjp(L, chunk, False)(x, dt, A, Bm, C, dy)
    got = tref.ssd_vjp(*(torch.from_numpy(a) for a in (x, dt, A, Bm, C, dy)),
                       chunk=chunk)
    assert [g.dtype for g in got] == [torch.float32] * 5
    _close(got, want, F32_TOL, case)


@pytest.mark.parametrize("case", [CASES[0], CASES[1]], ids=str)
def test_plain_vjp_matches_reference_bf16(case):
    """x, B, C and dy in bf16 (dt and A float32, as the models give them)."""
    x, dt, A, Bm, C, dy, _ = _inputs(case, 1)
    L, chunk = case[1], case[6]
    jx, jB, jC, jdy = (jnp.asarray(a, jnp.bfloat16) for a in (x, Bm, C, dy))
    want = _ref_vjp(L, chunk, False)(jx, dt, A, jB, jC, jdy)
    tx, tB, tC, tdy = (torch.from_numpy(a).bfloat16() for a in (x, Bm, C, dy))
    got = tref.ssd_vjp(tx, torch.from_numpy(dt), torch.from_numpy(A), tB, tC,
                       tdy, chunk=chunk)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16]
    _close(got, [np.asarray(w, np.float32) for w in want], BF16_TOL, case)


def _per_head_vjp(x, dt, A, Bm, C, dy, chunk):
    """The plain gradient with each head's dB and dC rounded to B's and C's
    dtype before the group's sum: B and C repeated to every head in their
    own dtype, then cast (the plain version's earlier order)."""
    G, rep = Bm.shape[2], x.shape[2] // Bm.shape[2]
    g = tref.ssd_vjp(x, dt, A, Bm.repeat_interleave(rep, dim=2),
                     C.repeat_interleave(rep, dim=2), dy, chunk=chunk)
    return (*g[:3], *(t.reshape(*t.shape[:2], G, rep, -1).sum(3)
                      for t in g[3:]))


@pytest.mark.parametrize("L", [1, 37])
def test_plain_vjp_bf16_many_heads_a_group(L):
    """24 heads on one group of B and C (Mamba2-130M's), bf16: each of the
    plain version's gradients is the float64 gradient of the same bf16
    inputs rounded once, within 2^-8 of its largest magnitude (plus
    F32_TOL for the float32 math); rounding each head's dB and dC before
    the group's sum misses that bound at L = 1."""
    x, dt, A, Bm, C, dy, _ = _inputs((1, L, 24, 8, 1, 8), 2)
    ins = [torch.from_numpy(a) for a in (x, dt, A, Bm, C, dy)]
    for i in (0, 3, 4, 5):
        ins[i] = ins[i].bfloat16()
    exact = tref.ssd_vjp(*(t.double() for t in ins), chunk=16)
    got = tref.ssd_vjp(*ins, chunk=16)
    _close(got, exact, 2 ** -8 + F32_TOL, ("bf16 24 heads", L))
    if L == 1:
        per_head = _per_head_vjp(*ins, chunk=16)
        assert max(float((g.double() - e).abs().max() / e.abs().max())
                   for g, e in zip(per_head[3:], exact[3:])) > 2 ** -8


@pytest.mark.parametrize("case", [CASES[0], CASES[1]], ids=str)
def test_plain_vjp_final_state_matches_reference(case):
    """With a gradient of the final state, against ``jax.vjp`` of (y,
    ``ssd_final_state``)."""
    x, dt, A, Bm, C, dy, dh = _inputs(case, 2)
    L, chunk = case[1], case[6]
    want = _ref_vjp(L, chunk, True)(x, dt, A, Bm, C, dy, dh)
    got = tref.ssd_vjp(*(torch.from_numpy(a) for a in (x, dt, A, Bm, C, dy)),
                       chunk=chunk, dh_final=torch.from_numpy(dh))
    _close(got, want, F32_TOL, case)
    # the final state's share is not zero: without it the gradients differ
    alone = tref.ssd_vjp(*(torch.from_numpy(a)
                           for a in (x, dt, A, Bm, C, dy)), chunk=chunk)
    assert not torch.allclose(alone[0], got[0], atol=1e-3)


def test_large_decay_reference_nan_port_finite():
    """A = -16, dt = 0.1, chunk 64: a chunk's decay sums to 102.4.  The
    reference's gradient is NaN in ddt, dA, dB and dC; the port's is finite
    and matches float64 autograd of the sequential scan."""
    B, L, H, P, G, N, chunk = 1, 128, 2, 8, 1, 8, 64
    x, _, _, Bm, C, dy, _ = _inputs((B, L, H, P, G, N), 3)
    dt = np.full((B, L, H), 0.1, np.float32)
    A = np.full((H,), -16.0, np.float32)
    want = _ref_vjp(L, chunk, False)(x, dt, A, Bm, C, dy)
    nan = [bool(np.isnan(np.asarray(w)).any()) for w in want]
    assert nan == [False, True, True, True, True], nan
    ts = [torch.from_numpy(a) for a in (x, dt, A, Bm, C, dy)]
    got = tref.ssd_vjp(*ts, chunk=chunk)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    with torch.enable_grad():
        ins = [t.double().requires_grad_(True) for t in ts[:5]]
        seq = torch.autograd.grad(tref.ssd_scan(*ins), ins, ts[5].double())
    _close(got, seq, F32_TOL, "large decay")


def _formulas(x, dt, A, Bm, C, dy, *, chunk=64, dh_final=None,
              dtype=torch.float64):
    """The backward kernel's equations (``csrc/ssd_scan_bwd.cu``'s header)
    in ``dtype`` (float64, or float32 as the CUDA-core kernel computes),
    chunk by chunk, the last chunk ragged (masked, not padded), chunks above
    64 run as 64: the carry of the chunks' start states h0, then the reverse
    walk carrying dh as the forward carries h."""
    x, dt, A, Bm, C, dy = (t.to(dtype) for t in (x, dt, A, Bm, C, dy))
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Bh, Ch = Bm.repeat_interleave(rep, 2), C.repeat_interleave(rep, 2)
    Q = min(chunk, 64)
    rows = [slice(c, min(L, c + Q)) for c in range(0, L, Q)]
    dx, ddt, dA = torch.zeros_like(x), torch.zeros_like(dt), torch.zeros_like(A)
    dBh, dCh = torch.zeros_like(Bh), torch.zeros_like(Ch)
    for b in range(Bsz):
        for h in range(H):
            h0s, lams, hc = [], [], torch.zeros(N, P, dtype=dtype)
            for r in rows:
                lam = torch.cumsum(A[h] * dt[b, r, h], 0)
                w = torch.exp(lam[-1] - lam) * dt[b, r, h]
                h0s.append(hc)
                lams.append(lam)
                hc = (torch.exp(lam[-1]) * hc
                      + (Bh[b, r, h] * w[:, None]).T @ x[b, r, h])
            dh = (torch.zeros(N, P, dtype=dtype) if dh_final is None
                  else dh_final[b, h].to(dtype))
            for c in reversed(range(len(rows))):
                r, lam, h0, dh1 = rows[c], lams[c], h0s[c], dh
                xc, dyc, dtc = x[b, r, h], dy[b, r, h], dt[b, r, h]
                Bc, Cc = Bh[b, r, h], Ch[b, r, h]
                n = lam.shape[0]
                le = lam[-1]
                mask = torch.tril(torch.ones(n, n, dtype=torch.bool))
                e = torch.where(mask, torch.exp(torch.where(
                    mask, lam[:, None] - lam[None, :], 0.0)), 0.0)
                Gm = Cc @ Bc.T
                dS = torch.where(mask, dyc @ xc.T, 0.0)
                S, T = Gm * e * dtc, dS * Gm * e
                dG, R = dS * e * dtc, dS * Gm * e * dtc
                w = torch.exp(le - lam) * dtc
                v = Bc @ dh1                       # v_j = dh1^T B_j
                z = (xc * v).sum(1)
                q = dyc @ h0.T                     # q_i = h0 dy_i
                dx[b, r, h] = S.T @ dyc + w[:, None] * v
                dCh[b, r, h] = dG @ Bc + torch.exp(lam)[:, None] * q
                dBh[b, r, h] = dG.T @ Cc + w[:, None] * (xc @ dh1.T)
                dlam = (R.sum(1) - R.sum(0)
                        + torch.exp(lam) * (Cc * q).sum(1) - z * w)
                dlam[-1] += (z * w).sum() + torch.exp(le) * (h0 * dh1).sum()
                suffix = torch.flip(torch.cumsum(torch.flip(dlam, [0]), 0),
                                    [0])
                ddt[b, r, h] = T.sum(0) + z * torch.exp(le - lam) + A[h] * suffix
                dA[h] += (dtc * suffix).sum()
                dh = (torch.exp(le) * dh1
                      + (torch.exp(lam)[:, None] * Cc).T @ dyc)
    return (dx, ddt, dA, dBh.reshape(Bsz, L, G, rep, N).sum(3),
            dCh.reshape(Bsz, L, G, rep, N).sum(3))


# (B, L, H, P, G, N, chunk, decay, final_state)
FORMULA_CASES = [(1, 37, 4, 8, 2, 6, 16, 1.0, False),
                 (2, 130, 4, 5, 1, 7, 64, 1.0, True),
                 (1, 100, 2, 8, 1, 8, 64, 100.0, True),
                 (1, 70, 2, 3, 2, 4, 128, 1.0, False)]


@pytest.mark.parametrize("case", FORMULA_CASES, ids=str)
def test_kernel_equations_match_plain_vjp_float64(case):
    """The kernel's equations against ``ssd_vjp`` in float64: ragged
    chunks, groups, a requested chunk of 128 (run as 64 by the kernel; the
    same function), a decay past 100 a chunk and a final-state gradient."""
    *shape, chunk, decay, final_state = case
    x, dt, A, Bm, C, dy, dh = (torch.from_numpy(a) for a in _inputs(
        shape, 4, decay, np.float64))
    dh = dh if final_state else None
    want = tref.ssd_vjp(x, dt, A, Bm, C, dy, chunk=min(chunk, 64),
                        dh_final=dh)
    assert all(g.dtype == torch.float64 and bool(torch.isfinite(g).all())
               for g in want)
    got = _formulas(x, dt, A, Bm, C, dy, chunk=chunk, dh_final=dh)
    _close(got, want, F64_TOL, case)


def _plain_forward(x, dt, A, B_mat, C, *, chunk, final_state, ptile=None):
    return ssd_ops.ssd(x, dt, A, B_mat, C, chunk=chunk,
                       final_state=final_state, backend="torch")


def _plain_backward(x, dt, A, B_mat, C, dy, dh_final=None, *, chunk):
    """The binding's stand-in: the plain gradient, counted by route where
    the binding counts its launch."""
    ssd_kernel.BWD_ROUTE_LAUNCHES[ssd_kernel.route_bwd(
        ssd_kernel.compute_dtype(x, B_mat, C), B_mat.shape[3],
        x.shape[3])] += 1
    return tref.ssd_vjp(x, dt, A, B_mat, C, dy, chunk=chunk,
                        dh_final=dh_final)


@pytest.mark.parametrize("final_state", [False, True])
def test_ssdscan_backward_wiring(monkeypatch, final_state):
    """``SSDScan`` with the kernel bindings replaced by their plain
    versions, on CPU tensors: the gradients of every tensor input equal
    autograd of the plain path, in each input's dtype; the backward returns
    one gradient per forward argument, None for chunk and final_state;
    ``BWD_LAUNCHES`` counts the launch the binding counted, by
    ``kernel.route_bwd``'s route (bf16 here: ``"wgmma"``), and
    ``ops.BWD_ROUTE_LAUNCHES`` shows the binding's count."""
    monkeypatch.setattr(ssd_kernel, "ssd_scan", _plain_forward)
    monkeypatch.setattr(ssd_kernel, "ssd_scan_bwd", _plain_backward)
    x, dt, A, Bm, C, dy, dh = (torch.from_numpy(a) for a in _inputs(
        (1, 40, 4, 8, 2, 6), 5))
    x, Bm, C = x.bfloat16(), Bm.bfloat16(), C.bfloat16()
    ins = [t.requires_grad_(True) for t in (x, dt, A, Bm, C)]
    before = (ssd_ops.BWD_LAUNCHES, dict(ssd_ops.BWD_ROUTE_LAUNCHES))
    out = ssd_ops.SSDScan.apply(*ins, 16, final_state)
    outs, cots = ((out, (dy.bfloat16(),)) if not final_state
                  else (out, (dy.bfloat16(), dh)))
    outs = outs if final_state else (outs,)
    got = torch.autograd.grad(outs, ins, cots, retain_graph=True)
    assert ssd_ops.BWD_LAUNCHES == before[0] + 1
    # bf16 x, B and C with N = 6: the tensor-core route's count
    assert ssd_ops.BWD_ROUTE_LAUNCHES == {**before[1], "wgmma":
                                          before[1]["wgmma"] + 1}
    raw = outs[0].grad_fn.apply(*cots)
    assert len(raw) == 7 and raw[5] is None and raw[6] is None
    want = tref.ssd_vjp(*ins, dy.bfloat16(), chunk=16,
                        dh_final=dh if final_state else None)
    for g, w, t in zip(got, want, ins):
        assert g.dtype == t.dtype
        assert torch.equal(g, w)


def test_binding_counts_only_its_launches():
    """``kernel.ssd_scan_bwd`` counts a launch by route where it launches:
    a call it refuses (CPU tensors, here) counts nothing, on either route,
    and neither does ``ops.BWD_ROUTE_LAUNCHES``, the same counts."""
    x, dt, A, Bm, C, dy, _ = (torch.from_numpy(a) for a in _inputs(
        (1, 40, 4, 8, 2, 6), 5))
    before = dict(ssd_kernel.BWD_ROUTE_LAUNCHES)
    for cast in (torch.Tensor.bfloat16, torch.Tensor.float):
        with pytest.raises(ValueError, match="CUDA"):
            ssd_kernel.ssd_scan_bwd(cast(x), dt, A, cast(Bm), cast(C),
                                    cast(dy))
    assert ssd_kernel.BWD_ROUTE_LAUNCHES == before
    assert ssd_ops.BWD_ROUTE_LAUNCHES == before


def _old_ssd_chunked(x, dt, A, B_mat, C, chunk=64):
    """``ref.ssd_chunked`` as it was before the exponent was masked
    (``exp(lam_i - lam_j)`` of every pair, then the ``where``)."""
    Bsz, L, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    rep, Q = H // G, chunk
    nc = L // Q
    xf, dtf, Bf, lam, lam_end, chunk_state = tref._chunk_terms(
        x, dt, A, B_mat, Q)
    Cf = C.repeat_interleave(rep, dim=2).float().reshape(Bsz, nc, Q, H, N)
    Sdot = torch.einsum("bcqhn,bckhn->bchqk", Cf, Bf)
    dec = torch.movedim(torch.exp(lam[:, :, :, None, :]
                                  - lam[:, :, None, :, :]), -1, 2)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    S = torch.where(mask[None, None, None], Sdot * dec
                    * torch.movedim(dtf, 2, 3)[:, :, :, None, :],
                    torch.zeros(()))
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", S, xf)
    h = torch.zeros((Bsz, H, N, P))
    starts = []
    for c in range(nc):
        starts.append(h)
        h = torch.exp(lam_end[:, c])[:, :, None, None] * h + chunk_state[:, c]
    h_starts = torch.stack(starts, dim=1)
    y_inter = torch.einsum("bcqhn,bchnp,bcqh->bcqhp", Cf, h_starts,
                           torch.exp(lam))
    return (y_intra + y_inter).reshape(Bsz, L, H, P).to(x.dtype)


@pytest.mark.parametrize("shape,chunk,decay,dtype", [
    ((1, 64, 2, 16, 1, 16), 64, 1.0, torch.float32),
    ((2, 128, 4, 32, 2, 64), 32, 1.0, torch.float32),
    ((1, 128, 8, 16, 4, 32), 64, 100.0, torch.float32),
    ((1, 96, 4, 16, 2, 8), 16, 1.0, torch.bfloat16)], ids=str)
def test_chunked_forward_bitwise_unchanged(shape, chunk, decay, dtype):
    """Masking the exponent changes no forward value: ``ssd_chunked`` is
    bitwise its earlier form, at a large decay (where the earlier form's
    dropped entries were inf) too."""
    x, dt, A, Bm, C = (torch.from_numpy(a) for a in _inputs(
        shape, 6, decay)[:5])
    x, Bm, C = x.to(dtype), Bm.to(dtype), C.to(dtype)
    got = tref.ssd_chunked(x, dt, A, Bm, C, chunk=chunk)
    assert torch.equal(got, _old_ssd_chunked(x, dt, A, Bm, C, chunk=chunk))
