"""Plain PyTorch versions of the Mamba2 SSD (state-space duality) scan, the
oracle of the CUDA ``ssd_scan`` kernel, copied from
``repro.kernels.ssd_scan.ref``.

Semantics (scalar-per-head A, the Mamba2 parameterization):

    h_t = exp(A_h * dt_t) * h_{t-1} + dt_t * (B_t  outer  x_t)
    y_t = C_t . h_t                       (contract the state dim N)

shapes: x (B, L, H, P); dt (B, L, H); A (H,) (negative);
B_mat, C (B, L, G, N) with H % G == 0 (grouped B/C a la GQA, head h reads
group ``h // (H // G)``).  Returns y (B, L, H, P) in x's dtype; the math is
float32.

``ssd_scan`` is the sequential oracle, ``ssd_chunked`` the chunked closed
form (what the model runs on the CPU and what the kernel computes), and
``ssd_final_state`` the state after the last position (prefill seeds decode
with it).  The intra-chunk decay ``exp(lam_i - lam_j)`` overflows for
``j > i`` once a chunk's decay passes ~88; as in the reference, those
entries are dropped by a ``where``, never multiplied by a 0/1 mask (which
would give ``inf * 0 = nan``).
"""
from __future__ import annotations

import torch


def _heads(t: torch.Tensor, rep: int) -> torch.Tensor:
    """(B, L, G, N) -> float32 (B, L, H, N): group g serves heads
    g * rep ... g * rep + rep - 1 (``jnp.repeat`` along axis 2)."""
    return t.repeat_interleave(rep, dim=2).float()


def ssd_scan(x, dt, A, B_mat, C):
    Bsz, L, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    assert H % G == 0
    rep = H // G
    Bh, Ch = _heads(B_mat, rep), _heads(C, rep)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    h = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        dtt = dtf[:, t]                                          # (B, H)
        h = (torch.exp(Af * dtt)[..., None, None] * h
             + dtt[..., None, None] * (Bh[:, t, :, :, None]
                                       * xf[:, t, :, None, :]))
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], h))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((Bsz, 0, H, P), device=x.device))
    return y.to(x.dtype)


def _chunk_terms(x, dt, A, B_mat, chunk):
    """float32 chunked views and the per-chunk decays shared by
    ``ssd_chunked`` and ``ssd_final_state``: (xf, dtf, Bf, lam, lam_end,
    chunk_state) with lam the within-chunk cumulative ``A * dt``."""
    Bsz, L, H, P = x.shape
    N = B_mat.shape[3]
    rep = H // B_mat.shape[2]
    nc = L // chunk
    xf = x.float().reshape(Bsz, nc, chunk, H, P)
    dtf = dt.float().reshape(Bsz, nc, chunk, H)
    Bf = _heads(B_mat, rep).reshape(Bsz, nc, chunk, H, N)
    lam = torch.cumsum(A.float()[None, None, None, :] * dtf, dim=2)
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
    Cf = _heads(C, rep).reshape(Bsz, nc, Q, H, N)

    # intra-chunk: S[i,j] = (C_i.B_j) exp(lam_i - lam_j) dt_j for j<=i
    Sdot = torch.einsum("bcqhn,bckhn->bchqk", Cf, Bf)
    dec = torch.exp(lam[:, :, :, None, :] - lam[:, :, None, :, :])
    dec = torch.movedim(dec, -1, 2)                              # (B,nc,H,Q,K)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    S = torch.where(mask[None, None, None], Sdot * dec
                    * torch.movedim(dtf, 2, 3)[:, :, :, None, :],
                    torch.zeros((), device=x.device))
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", S, xf)

    # inter-chunk: carry the states sequentially, emitting each chunk's
    # state at its start
    h = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
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
    """Final SSM state h_L (B, H, N, P), float32 -- used by prefill to seed
    decode.  Any L (padded to the chunk here)."""
    x, dt, B_mat = pad_to_chunk(chunk, x, dt, B_mat)
    Bsz, _, H, P = x.shape
    N = B_mat.shape[3]
    _, _, _, _, lam_end, chunk_state = _chunk_terms(x, dt, A, B_mat, chunk)
    h = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    for c in range(chunk_state.shape[1]):
        h = torch.exp(lam_end[:, c])[:, :, None, None] * h + chunk_state[:, c]
    return h
