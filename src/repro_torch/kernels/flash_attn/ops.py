"""Public attention entry point of the model zoo.

Dispatches on the device of ``q``: a CPU tensor takes the plain version on
the reference's CPU route (``ref.mha`` up to 1,024 keys, else
``ref.mha_chunked`` with ``block_k = min(512, Sk)``), a CUDA tensor
launches a CUDA kernel (``kernel.py``: the bf16 tensor-core kernel in
bf16; in float32 with q's head dim up to 192 and v's width up to 128 (MLA's
Dk 192 / Dv 128 among them) the float32 tensor-core kernel, which reaches
float32 accuracy on the bf16 tensor cores by a three-way bf16 split of its
operands; the float32 CUDA-core kernel for wider heads).
``backend="torch"`` takes the plain version's route on any device.  A
tensor the kernels cannot read as it lies (``kernel.kernel_ready``) is
copied first (``kernel.ready_copy``).
float16 and mixed dtypes run in float32 on a float32 route, returning q's
dtype (``kernel.compute_dtype``), as the reference's ``mha`` computes
them.  ``Dv != Dk`` (MLA, off the dense path) takes the reference's own route to
``mha_chunked`` on the plain path (``repro/kernels/flash_attn/ops.py:30-31``)
and the kernels on CUDA tensors, which take any Dv.  ``LAUNCHES`` counts the
kernel launches made through this wrapper, and ``ROUTE_LAUNCHES`` the same
launches by kernel (``kernel.route``: ``wgmma``, ``wgmma_f32`` or
``cuda_cores``).

Gradients: CUDA tensors of which one needs a gradient (with grad mode on)
go through :class:`FlashAttention`, a ``torch.autograd.Function`` whose
forward is the same kernel and whose backward is the backward kernel
(``kernel.flash_attention_bwd``, ``csrc/flash_attn_bwd.cu``);
``BWD_LAUNCHES`` counts its calls and ``BWD_ROUTE_LAUNCHES`` the same calls
by route (``kernel.route_bwd``).  Its forward also writes each row's
log-sum-exp (on the tensor-core forwards), which the backward's
tensor-core routes (``wgmma`` in bf16, ``wgmma_f32`` in float32, head dim
up to 192 and value width up to 128) read.  CPU tensors and ``backend="torch"``
differentiate the plain route under ordinary autograd, as the reference's
CPU route does.  A forward that needs no gradient is unchanged.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernel as _kernel
from . import ref as _ref
from .._common import resolve_backend

LAUNCHES = 0
ROUTE_LAUNCHES = {"wgmma": 0, "wgmma_f32": 0, "cuda_cores": 0}
BWD_LAUNCHES = 0
BWD_ROUTE_LAUNCHES = {"wgmma": 0, "wgmma_f32": 0, "cuda_cores": 0}


class FlashAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        # lse: None on the CUDA-core forward (its backward recomputes it)
        out, lse = _kernel.flash_attention(q, k, v, causal=causal,
                                           scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        global BWD_LAUNCHES
        q, k, v, out, lse = ctx.saved_tensors
        grads = _kernel.flash_attention_bwd(q, k, v, out, dout, lse,
                                            causal=ctx.causal,
                                            scale=ctx.scale)
        if out.numel():
            BWD_LAUNCHES += 1
            BWD_ROUTE_LAUNCHES[_kernel.route_bwd(
                _kernel.compute_dtype(q, k, v, out, dout), q.shape[-1],
                v.shape[-1])] += 1
        return (*grads, None, None)


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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out = FlashAttention.apply(q, k, v, causal, scale)
    else:
        out = _kernel.flash_attention(q, k, v, causal=causal, scale=scale)
    if out.numel():
        LAUNCHES += 1
        ROUTE_LAUNCHES[_kernel.route(_kernel.compute_dtype(q, k, v),
                                     q.shape[-1], v.shape[-1])] += 1
    return out
