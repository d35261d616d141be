"""Public wrapper of the Mamba2 SSD scan.

Copied from ``repro.kernels.ssd_scan.ops`` with the port's ``{auto,
torch}`` switch: ``auto`` launches the CUDA kernel (``kernel.py``) on CUDA
tensors and runs the chunked plain version (``ref.ssd_chunked``, on zero-
padded inputs) on CPU tensors; ``torch`` runs the chunked plain version on
any device.  There is no fallback from the kernel to the plain version.
The kernel masks a ragged last chunk itself, so its inputs are not padded.
float16 and mixed dtypes run in float32 on the CUDA-core route, returning
x's dtype (``kernel.compute_dtype``), as the reference's ``ssd_chunked``
computes them.
``final_state=True`` also returns the state after the last position (the
kernel's own on CUDA tensors, ``ref.ssd_final_state`` on the plain path),
which prefill hands to decode.
``LAUNCHES`` counts the kernel calls made through this wrapper, and
``ROUTE_LAUNCHES`` each route's share (``kernel.route``: the bf16
tensor-core walk, one launch; the CUDA-core route, three launches).
"""
from __future__ import annotations

import torch

from . import kernel as _kernel
from . import ref as _ref
from .._common import resolve_backend

LAUNCHES = 0
ROUTE_LAUNCHES = {"wgmma": 0, "cuda_cores": 0}


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        B_mat: torch.Tensor, C: torch.Tensor, *, chunk: int = 64,
        backend: str = "auto", final_state: bool = False):
    """x (B, L, H, P); dt (B, L, H); A (H,); B_mat, C (B, L, G, N) ->
    y (B, L, H, P) in x's dtype, or ``(y, h)`` with ``final_state``: h
    (B, H, N, P) float32, the state after position L - 1."""
    global LAUNCHES
    L = x.shape[1]
    if resolve_backend(backend) == "torch" or x.device.type == "cpu":
        xp, dtp, Bp, Cp = _ref.pad_to_chunk(chunk, x, dt, B_mat, C)
        y = _ref.ssd_chunked(xp, dtp, A, Bp, Cp, chunk=chunk)[:, :L]
        if not final_state:
            return y
        return y, _ref.ssd_final_state(x, dt, A, B_mat, C, chunk=chunk)
    if not x.is_cuda:
        raise ValueError(f"ssd: unsupported device {x.device}")
    x, B_mat, C = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (x, B_mat, C))
    out = _kernel.ssd_scan(x, dt.float(), A.float().contiguous(), B_mat, C,
                           chunk=chunk, final_state=final_state)
    if x.numel():
        LAUNCHES += 1
        ROUTE_LAUNCHES[_kernel.route(_kernel.compute_dtype(x, B_mat, C),
                                     B_mat.shape[3])] += 1
    return out
