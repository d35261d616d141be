"""Public wrapper of the per-switch JSQ arbitration scan.

Dispatches on the device of ``t_grid``: a CPU tensor takes the plain
version (``ref.py``), a CUDA tensor launches the CUDA kernel
(``kernel.py``).  ``backend="torch"`` takes the plain version on any
device.  ``LAUNCHES`` counts the kernel launches made through this wrapper.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernel as _kernel
from . import ref as _ref
from .._common import resolve_backend

LAUNCHES = 0


def jsq_scan(t_grid: torch.Tensor, ok_grid: torch.Tensor, noise: torch.Tensor,
             port_pen: torch.Tensor, thresholds: Optional[torch.Tensor] = None,
             backend: str = "auto"
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """See ``ref.jsq_scan`` for shapes and meaning."""
    global LAUNCHES
    if resolve_backend(backend) == "torch" or t_grid.device.type == "cpu":
        return _ref.jsq_scan(t_grid, ok_grid, noise, port_pen, thresholds)
    if not t_grid.is_cuda:
        raise ValueError(f"jsq_scan: unsupported device {t_grid.device}")
    if t_grid.numel() == 0:
        shape = t_grid.shape
        return (torch.zeros(shape, dtype=torch.int32, device=t_grid.device),
                t_grid.clone(), torch.zeros_like(t_grid))
    out = _kernel.jsq_scan(t_grid.contiguous(), ok_grid.contiguous(),
                           noise.contiguous(), port_pen.contiguous(),
                           None if thresholds is None
                           else thresholds.contiguous())
    LAUNCHES += 1
    return out
