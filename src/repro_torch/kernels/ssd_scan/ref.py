"""Plain PyTorch versions of the Mamba2 SSD (state-space duality) scan, the
oracle of the CUDA ``ssd_scan`` kernel, copied from
``repro.kernels.ssd_scan.ref``.

Semantics (scalar-per-head A, the Mamba2 parameterization):

    h_t = exp(A_h * dt_t) * h_{t-1} + dt_t * (B_t  outer  x_t)
    y_t = C_t . h_t                       (contract the state dim N)

shapes: x (B, L, H, P); dt (B, L, H); A (H,) (negative);
B_mat, C (B, L, G, N) with H % G == 0 (grouped B/C a la GQA, head h reads
group ``h // (H // G)``).  Returns y (B, L, H, P) in x's dtype; the math is
float32, or float64 when an input is float64 (the yardstick of the float32
kernels' accuracy).

``ssd_scan`` is the sequential oracle, ``ssd_chunked`` the chunked closed
form (what the model runs on the CPU and what the kernel computes), and
``ssd_final_state`` the state after the last position (prefill seeds decode
with it).  The intra-chunk decay ``exp(lam_i - lam_j)`` overflows for
``j > i`` once a chunk's decay passes ~88; as in the reference, those
entries are dropped by a ``where``, never multiplied by a 0/1 mask (which
would give ``inf * 0 = nan``).  Unlike the reference, the exponent is taken
only for ``j <= i`` (``where(mask, lam_i - lam_j, 0)`` first): the forward
is the same, and the gradient of the dropped branch is 0, not ``0 * inf =
nan`` as ``jax.grad`` of the reference's ``ssd_chunked`` gives there
(``ROADMAP.md`` §C).

``ssd_vjp`` is the gradient of ``ssd_chunked`` (and of ``ssd_final_state``),
the plain version of the backward kernel ``csrc/ssd_scan_bwd.cu``.
"""
from __future__ import annotations

import torch


def _math_dtype(*ts: torch.Tensor) -> torch.dtype:
    """float64 when one of ``ts`` is float64, else float32."""
    return (torch.float64 if any(t.dtype == torch.float64 for t in ts)
            else torch.float32)


def _heads(t: torch.Tensor, rep: int, ct: torch.dtype) -> torch.Tensor:
    """(B, L, G, N) -> (B, L, H, N) in ``ct``: group g serves heads
    g * rep ... g * rep + rep - 1 (``jnp.repeat`` along axis 2).  Cast
    first, then repeated (the same values as the reference's repeat, then
    cast), so that the gradient sums a group's heads in ``ct`` and rounds
    to a bf16 B or C once, as the backward kernel does, not once a head."""
    return t.to(ct).repeat_interleave(rep, dim=2)


def ssd_scan(x, dt, A, B_mat, C):
    Bsz, L, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    assert H % G == 0
    rep = H // G
    ct = _math_dtype(x, dt, A, B_mat, C)
    Bh, Ch = _heads(B_mat, rep, ct), _heads(C, rep, ct)
    xf, dtf, Af = x.to(ct), dt.to(ct), A.to(ct)
    h = torch.zeros((Bsz, H, N, P), dtype=ct, device=x.device)
    ys = []
    for t in range(L):
        dtt = dtf[:, t]                                          # (B, H)
        h = (torch.exp(Af * dtt)[..., None, None] * h
             + dtt[..., None, None] * (Bh[:, t, :, :, None]
                                       * xf[:, t, :, None, :]))
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], h))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((Bsz, 0, H, P), dtype=ct, device=x.device))
    return y.to(x.dtype)


def _chunk_terms(x, dt, A, B_mat, chunk):
    """Chunked views (in the math dtype) and the per-chunk decays shared by
    ``ssd_chunked`` and ``ssd_final_state``: (xf, dtf, Bf, lam, lam_end,
    chunk_state) with lam the within-chunk cumulative ``A * dt``."""
    Bsz, L, H, P = x.shape
    N = B_mat.shape[3]
    rep = H // B_mat.shape[2]
    nc = L // chunk
    ct = _math_dtype(x, dt, A, B_mat)
    xf = x.to(ct).reshape(Bsz, nc, chunk, H, P)
    dtf = dt.to(ct).reshape(Bsz, nc, chunk, H)
    Bf = _heads(B_mat, rep, ct).reshape(Bsz, nc, chunk, H, N)
    lam = torch.cumsum(A.to(ct)[None, None, None, :] * dtf, dim=2)
    lam_end = lam[:, :, -1, :]                                   # (B,nc,H)
    # chunk state: sum_j exp(lam_end - lam_j) dt_j B_j x_j^T
    w = torch.exp(lam_end[:, :, None, :] - lam) * dtf            # (B,nc,Q,H)
    chunk_state = torch.einsum("bcqh,bcqhn,bcqhp->bchnp", w, Bf, xf)
    return xf, dtf, Bf, lam, lam_end, chunk_state


def ssd_chunked(x, dt, A, B_mat, C, chunk: int = 64):
    """Chunked closed form (the algorithm of the kernel); mathematically
    identical to ``ssd_scan``.  L must be a multiple of ``chunk``."""
    Bsz, L, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    rep = H // G
    assert L % chunk == 0
    Q = chunk
    nc = L // Q
    xf, dtf, Bf, lam, lam_end, chunk_state = _chunk_terms(x, dt, A, B_mat,
                                                          Q)
    Cf = _heads(C, rep, xf.dtype).reshape(Bsz, nc, Q, H, N)

    # intra-chunk: S[i,j] = (C_i.B_j) exp(lam_i - lam_j) dt_j for j<=i
    Sdot = torch.einsum("bcqhn,bckhn->bchqk", Cf, Bf)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    diff = torch.movedim(lam[:, :, :, None, :] - lam[:, :, None, :, :], -1,
                         2)                                      # (B,nc,H,Q,K)
    dec = torch.exp(torch.where(mask[None, None, None], diff,
                                torch.zeros((), device=x.device)))
    S = torch.where(mask[None, None, None], Sdot * dec
                    * torch.movedim(dtf, 2, 3)[:, :, :, None, :],
                    torch.zeros((), device=x.device))
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", S, xf)

    # inter-chunk: carry the states sequentially, emitting each chunk's
    # state at its start
    h = torch.zeros((Bsz, H, N, P), dtype=xf.dtype, device=x.device)
    starts = []
    for c in range(nc):
        starts.append(h)
        h = torch.exp(lam_end[:, c])[:, :, None, None] * h + chunk_state[:, c]
    h_starts = (torch.stack(starts, dim=1) if starts
                else chunk_state)                                # (B,nc,H,N,P)

    y_inter = torch.einsum("bcqhn,bchnp,bcqh->bcqhp", Cf, h_starts,
                           torch.exp(lam))
    y = (y_intra + y_inter).reshape(Bsz, L, H, P)
    return y.to(x.dtype)


def pad_to_chunk(chunk: int, *ts: torch.Tensor):
    """Zero-pad axis 1 of each tensor to a multiple of ``chunk`` (a zero
    ``dt`` leaves the state unchanged, so the padding adds nothing)."""
    pad = (-ts[0].shape[1]) % chunk
    if not pad:
        return ts
    out = []
    for t in ts:
        z = torch.zeros((t.shape[0], pad) + t.shape[2:], dtype=t.dtype,
                        device=t.device)
        out.append(torch.cat([t, z], dim=1))
    return tuple(out)


def ssd_final_state(x, dt, A, B_mat, C, chunk: int = 64):
    """Final SSM state h_L (B, H, N, P), float32 (float64 from float64
    inputs) -- used by prefill to seed decode.  Any L (padded to the chunk
    here)."""
    x, dt, B_mat = pad_to_chunk(chunk, x, dt, B_mat)
    Bsz, _, H, P = x.shape
    N = B_mat.shape[3]
    _, _, _, _, lam_end, chunk_state = _chunk_terms(x, dt, A, B_mat, chunk)
    h = torch.zeros((Bsz, H, N, P), dtype=chunk_state.dtype,
                    device=x.device)
    for c in range(chunk_state.shape[1]):
        h = torch.exp(lam_end[:, c])[:, :, None, None] * h + chunk_state[:, c]
    return h


def ssd_vjp(x, dt, A, B_mat, C, dy, *, chunk: int = 64, dh_final=None):
    """(dx, ddt, dA, dB, dC): the gradients of ``ssd_chunked`` on the
    zero-padded inputs (any L, as ``ops.ssd`` runs it) at (x, dt, A, B_mat,
    C) along ``dy`` (B, L, H, P), each in its input's dtype; with
    ``dh_final`` (B, H, N, P) also along the final state
    (``ssd_final_state``)."""
    L = x.shape[1]
    with torch.enable_grad():
        ins = tuple(t.detach().requires_grad_(True)
                    for t in (x, dt, A, B_mat, C))
        xx, dtt, AA, BB, CC = ins
        xp, dtp, Bp, Cp = pad_to_chunk(chunk, xx, dtt, BB, CC)
        y = ssd_chunked(xp, dtp, AA, Bp, Cp, chunk=chunk)[:, :L]
        outs, grads = [y], [dy.to(y.dtype)]
        if dh_final is not None:
            outs.append(ssd_final_state(xx, dtt, AA, BB, CC, chunk=chunk))
            grads.append(dh_final.to(outs[1].dtype))
        got = torch.autograd.grad(outs, ins, grads, allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g.to(t.dtype)
                 for g, t in zip(got, ins))
