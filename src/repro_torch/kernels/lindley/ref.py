"""Plain PyTorch versions of the segmented max-plus (Lindley) scan.

``segmented_cummax(v, flags)`` returns the running maximum of ``v`` along
the last axis that resets at every True in ``flags`` (segment starts).  With
packets sorted by (queue, arrival), FIFO departure times are
``d_i = i + 1 + segmented_cummax(a - i)`` (the Lindley recursion in max-plus
form).  The doubling scan below combines (value, flag) pairs exactly as the
JAX reference's ``jax.lax.associative_scan`` oracle does; max is exact, so
any scan tree gives the same bits.
"""
from __future__ import annotations

import torch


def segmented_cummax(v: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Hillis-Steele doubling scan on (value, flag) pairs along the last axis."""
    v = v.to(torch.float32)
    f = flags.to(torch.bool)
    n = v.shape[-1]
    shift = 1
    while shift < n:
        vp, fp = v[..., :-shift], f[..., :-shift]
        vs, fs = v[..., shift:], f[..., shift:]
        v = torch.cat([v[..., :shift],
                       torch.where(fs, vs, torch.maximum(vp, vs))], dim=-1)
        f = torch.cat([f[..., :shift], fs | fp], dim=-1)
        shift *= 2
    return v.clone() if n <= 1 else v


def segmented_cummax_serial(v: torch.Tensor,
                            flags: torch.Tensor) -> torch.Tensor:
    """Sequential reference over a 1-D input (a second oracle for tests)."""
    vals = v.to(torch.float32).tolist()
    fl = flags.to(torch.bool).tolist()
    out = []
    cur = float("-inf")
    for x, f in zip(vals, fl):
        cur = x if f else max(cur, x)
        out.append(cur)
    return torch.tensor(out, dtype=torch.float32, device=v.device)


def lindley_departures(arrival_sorted: torch.Tensor, seg_start: torch.Tensor,
                       service: float = 1.0) -> torch.Tensor:
    """Departure times for FIFO unit-rate queues: packets sorted by
    (queue, arrival); ``seg_start`` marks the first packet of each queue."""
    n = arrival_sorted.shape[-1]
    idx = torch.arange(n, dtype=torch.float32,
                       device=arrival_sorted.device) * service
    m = segmented_cummax(arrival_sorted - idx, seg_start)
    return m + idx + service
