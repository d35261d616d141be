"""Public wrapper of the segmented max-plus (Lindley) scan.

Dispatches on the device of ``v``: a CPU tensor takes the plain version
(``ref.py``), a CUDA tensor launches the CUDA kernel (``kernel.py``).
``backend="torch"`` takes the plain version on any device.  ``LAUNCHES``
counts the kernel launches made through this wrapper.
"""
from __future__ import annotations

import torch

from . import kernel as _kernel
from . import ref as _ref
from .._common import resolve_backend

LAUNCHES = 0


def segmented_cummax(v: torch.Tensor, flags: torch.Tensor,
                     backend: str = "auto") -> torch.Tensor:
    """Running max of ``v`` along the last axis, restarting where ``flags``
    is set; rows of a batched input are scanned independently."""
    global LAUNCHES
    if resolve_backend(backend) == "torch" or v.device.type == "cpu":
        return _ref.segmented_cummax(v, flags)
    if not v.is_cuda:
        raise ValueError(f"segmented_cummax: unsupported device {v.device}")
    if v.numel() == 0:
        return torch.empty_like(v, dtype=torch.float32)
    shape = v.shape
    v1 = v.to(torch.float32).contiguous().view(-1)
    f1 = flags.contiguous()
    if v.dim() > 1:
        # Rows are independent: a flag at every row start keeps the
        # flattened scan from carrying one row's maximum into the next.
        f1 = f1.clone()
        f1[..., 0] = True
    f1 = f1.view(-1)
    out = _kernel.segmented_cummax(v1, f1)
    LAUNCHES += 1
    return out.view(shape)


def lindley_departures(arrival_sorted: torch.Tensor, seg_start: torch.Tensor,
                       service: float = 1.0,
                       backend: str = "auto") -> torch.Tensor:
    n = arrival_sorted.shape[-1]
    idx = torch.arange(n, dtype=torch.float32,
                       device=arrival_sorted.device) * service
    m = segmented_cummax(arrival_sorted - idx, seg_start, backend=backend)
    return m + idx + service
