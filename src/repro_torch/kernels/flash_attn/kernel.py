"""ctypes binding of the CUDA flash-attention kernels (``csrc/flash_attn.cu``).

The CUDA source replaces the Pallas TPU kernel
``repro/kernels/flash_attn/kernel.py:flash_attention``; its header states
the design and the bound.  :func:`flash_attention` launches one of its two
kernels on CUDA tensors on the current stream and raises if the launch
fails.  :func:`route` names the kernel: bf16 with a head dim up to 256 (every
model of the repo) runs the tensor-core kernel (``wgmma`` + TMA); float32,
and bf16 with a wider head, the CUDA-core kernel.  Float32 stays off the
tensor cores on purpose: TF32 would miss the 2e-5 tolerance of the goldens.

The kernels read q, k and v through their (batch, head, position) strides,
so a (B, H, S, D) view of a (B, S, H, D) tensor needs no copy; the last axis
must be contiguous, the other strides multiples of 8 elements (TMA needs
16-byte strides) and the data 16-byte aligned (:func:`kernel_ready`;
:func:`ready_copy` makes such a copy of any tensor).  The output has q's
layout (``torch.empty_like``) when v's width is q's depth, else a new
contiguous tensor.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import _build

_VP = ctypes.c_void_p
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WGMMA_MAX_HEAD_DIM = 256    # Q resident in shared memory, 64-column boxes
_SHAPE_ARGS = [_VP, _VP, _VP, _VP, *[ctypes.c_int] * 7,
               ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
               ctypes.c_int, _VP]


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_cuda_cores_fwd.argtypes = [ctypes.c_int,
                                                       *_SHAPE_ARGS]
        lib.flash_attention_cuda_cores_fwd.restype = ctypes.c_int
        lib.flash_attention_wgmma_fwd.argtypes = _SHAPE_ARGS
        lib.flash_attention_wgmma_fwd.restype = ctypes.c_int
        lib._typed = True
    return lib


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that takes (dtype, head_dim): ``"wgmma"`` (bf16 tensor
    cores) or ``"cuda_cores"`` (float32 CUDA cores)."""
    if dtype == torch.bfloat16 and head_dim <= WGMMA_MAX_HEAD_DIM:
        return "wgmma"
    return "cuda_cores"


def kernel_ready(t: torch.Tensor) -> bool:
    """Whether the kernels can read ``t`` as it lies: a contiguous last
    axis, other strides multiples of 8 elements, 16-byte aligned data."""
    return (t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def ready_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` that :func:`kernel_ready` accepts: a view of a new
    buffer whose rows are padded to a multiple of 8 elements."""
    D = t.shape[-1]
    buf = torch.empty((*t.shape[:-1], -(-D // 8) * 8), dtype=t.dtype,
                      device=t.device)
    out = buf[..., :D]
    out.copy_(t)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, Sq, D); k (B, Hkv, Sk, D); v (B, Hkv, Sk, Dv), all float32
    or all bf16 on one CUDA device, ``Hq % Hkv == 0``, ``D, Dv >= 1``,
    ``Sk >= 1`` and, when causal, ``Sq <= Sk``.  Returns (B, Hq, Sq, Dv) in
    q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError("flash_attention kernel: q (B, Hq, Sq, D), k (B, "
                         "Hkv, Sk, D) and v (B, Hkv, Sk, Dv)")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, Dk = k.shape
    Dv = v.shape[-1]
    if k.shape[0] != B or Dk != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)} does "
                         f"not fit k/v {tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention kernel: q, k, v must all be "
                         "float32 or all bfloat16")
    if D < 1 or Dv < 1:
        raise ValueError("flash_attention kernel: head dims must be >= 1")
    if Sk == 0 or (causal and Sq > Sk):
        raise ValueError(f"flash_attention kernel: needs Sk >= 1 and, when "
                         f"causal, Sq <= Sk (Sq={Sq}, Sk={Sk})")
    dev = q.device
    for t in (q, k, v):
        if not t.is_cuda or t.device != dev:
            raise ValueError("flash_attention kernel: q, k, v must share "
                             "one CUDA device")
        if not kernel_ready(t):
            raise ValueError("flash_attention kernel: the last axis must be "
                             "contiguous, strides multiples of 8 and data "
                             "16-byte aligned")
    # q's strides (or contiguous if q overlaps) when the widths agree
    out = (torch.empty_like(q) if Dv == D
           else q.new_empty((B, Hq, Sq, Dv)))
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            Hkv, Sq, Sk, D, Dv, strides, float(scale), int(bool(causal)))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route(q.dtype, D) == "wgmma":
            err = lib.flash_attention_wgmma_fwd(*args, stream)
        else:
            err = lib.flash_attention_cuda_cores_fwd(_DTYPES[q.dtype], *args,
                                                     stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed ({route(q.dtype, D)}"
                           f" route): cudaError {err}")
    return out
