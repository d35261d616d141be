"""Plain PyTorch version of the per-switch JSQ arbitration scan.

The fast engine's adaptive layers (``jsq`` / ``jsq_quant``) lay each
switch's arrivals out on a ``(switch, rank)`` grid in arrival order and walk
it sequentially: every arrival sees the queue length of each of the ``h``
ports, picks the port of least score (first occurrence on ties), and
advances that port's last departure.  In the JAX reference this is the
``lax.scan`` of ``repro/net/fastsim.py:_jsq_layer`` (``:224-243``); here it
is a Python loop over the rank axis, vectorised over (batch row, switch).

The JSQ score ``qlen + nz * 1e-3`` is rounded once, as a fused multiply-add:
XLA contracts it on the CPU, and the CUDA kernel uses ``fmaf``.
:func:`fma32` computes it exactly in float64 and rounds once to float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG = -1.0e9
JSQ_NOISE_SCALE = 1e-3      # float32(1e-3) multiplies the tie-break noise
QUANT_NOISE_SCALE = 0.5


def fma32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` with one rounding to float32 (float32 ``a``, ``c``;
    ``b`` a float32 tensor, or a python float rounded to float32 first).

    ``a * b`` is exact in float64 (24 + 24 bits).  The float64 sum ``s`` and
    its exact error ``e`` (TwoSum) give the correctly rounded float32 result:
    rounding ``s`` to float32 is right unless ``s`` lies exactly halfway
    between two float32 values and ``e`` pushes the exact sum past that
    midpoint, in which case the neighbour on ``e``'s side is the answer.
    """
    if isinstance(b, torch.Tensor):
        p = a.double() * b.double()
    else:
        p = a.double() * float(torch.tensor(b, dtype=torch.float32))
    c64 = c.double()
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    r = s.float()
    diff = s - r.double()
    toward = torch.where(diff > 0, torch.full_like(r, float("inf")),
                         torch.full_like(r, float("-inf")))
    other = torch.nextafter(r, toward)
    midpoint = (diff != 0) & (2 * diff == other.double() - r.double())
    past = ((e > 0) & (diff > 0)) | ((e < 0) & (diff < 0))
    return torch.where(midpoint & past, other, r)


def jsq_scan(t_grid: torch.Tensor, ok_grid: torch.Tensor, noise: torch.Tensor,
             port_pen: torch.Tensor,
             thresholds: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sequential JSQ over the rank axis of ``(B, S, pad)`` grids.

    ``t_grid`` float32 arrival times (``NEG`` in empty cells), ``ok_grid``
    bool cell occupancy, ``noise`` ``(B, S, pad, h)`` float32 tie-break
    uniforms, ``port_pen`` ``(B, h)`` float32 padded-port penalty,
    ``thresholds`` ``(nq,)`` float32 queue-length bin edges for
    ``jsq_quant`` (``None`` for plain JSQ).  Returns per cell the chosen
    port (int32), the departure time (the arrival time for empty cells) and
    the queue length the arrival saw on the chosen port.
    """
    B, S, pad = t_grid.shape
    h = noise.shape[-1]
    dev = t_grid.device
    d_last = torch.full((B, S, h), NEG, dtype=torch.float32, device=dev)
    pen = port_pen[:, None, :]
    lanes = torch.arange(h, device=dev)
    ports = torch.empty((B, S, pad), dtype=torch.int32, device=dev)
    deps = torch.empty((B, S, pad), dtype=torch.float32, device=dev)
    occs = torch.empty((B, S, pad), dtype=torch.float32, device=dev)
    for j in range(pad):
        t = t_grid[:, :, j]
        ok = ok_grid[:, :, j]
        nz = noise[:, :, j, :]
        qlen = torch.ceil(torch.clamp_min(d_last - t[..., None], 0.0))
        if thresholds is None:
            score = fma32(nz, JSQ_NOISE_SCALE, qlen)
        else:
            bins = (qlen[..., None] > thresholds).sum(-1).to(torch.float32)
            score = bins + nz * QUANT_NOISE_SCALE
        p = torch.argmin(score + pen, dim=-1, keepdim=True)
        d_new = torch.maximum(t, torch.gather(d_last, -1, p)[..., 0]) + 1.0
        d_last = torch.where(ok[..., None] & (lanes == p), d_new[..., None],
                             d_last)
        ports[:, :, j] = p[..., 0].to(torch.int32)
        deps[:, :, j] = torch.where(ok, d_new, t)
        occs[:, :, j] = torch.gather(qlen, -1, p)[..., 0]
    return ports, deps, occs
