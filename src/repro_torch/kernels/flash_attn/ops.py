"""Public attention entry point of the model zoo.

Dispatches on the device of ``q``: a CPU tensor takes the plain version on
the reference's CPU route (``ref.mha`` up to 1,024 keys, else
``ref.mha_chunked`` with ``block_k = min(512, Sk)``), a CUDA tensor
launches a CUDA kernel (``kernel.py``: the tensor-core kernel in bf16, the
CUDA-core kernel in float32).  ``backend="torch"`` takes the plain
version's route on any device.  A tensor the kernels cannot read as it
lies (``kernel.kernel_ready``) is copied first (``kernel.ready_copy``).
float16 and mixed dtypes run in float32 on the CUDA-core kernel, returning
q's dtype (``kernel.compute_dtype``), as the reference's ``mha`` computes
them.  ``Dv != Dk`` (MLA, off the dense path) takes the reference's own route to
``mha_chunked`` on the plain path (``repro/kernels/flash_attn/ops.py:30-31``)
and the kernels on CUDA tensors, which take any Dv.  ``LAUNCHES`` counts the
kernel launches made through this wrapper, and ``ROUTE_LAUNCHES`` the same
launches by kernel (``kernel.route``: ``wgmma`` or ``cuda_cores``).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernel as _kernel
from . import ref as _ref
from .._common import resolve_backend

LAUNCHES = 0
ROUTE_LAUNCHES = {"wgmma": 0, "cuda_cores": 0}


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, scale: Optional[float] = None,
              backend: str = "auto") -> torch.Tensor:
    """q (B, Hq, Sq, Dk); k (B, Hkv, Sk, Dk); v (B, Hkv, Sk, Dv) ->
    (B, Hq, Sq, Dv) in q's dtype."""
    global LAUNCHES
    mixed_dims = v.shape[-1] != k.shape[-1]
    if resolve_backend(backend) == "torch" or q.device.type == "cpu":
        if mixed_dims or k.shape[2] > 1024:
            return _ref.mha_chunked(q, k, v, causal=causal, scale=scale,
                                    block_k=min(512, k.shape[2]))
        return _ref.mha(q, k, v, causal=causal, scale=scale)
    if not q.is_cuda:
        raise ValueError(f"attention: unsupported device {q.device}")
    q, k, v = (t if _kernel.kernel_ready(t) else _kernel.ready_copy(t)
               for t in (q, k, v))
    out = _kernel.flash_attention(q, k, v, causal=causal, scale=scale)
    if out.numel():
        LAUNCHES += 1
        ROUTE_LAUNCHES[_kernel.route(_kernel.compute_dtype(q, k, v),
                                     q.shape[-1])] += 1
    return out
