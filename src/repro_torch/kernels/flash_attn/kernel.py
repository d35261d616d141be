"""ctypes binding of the CUDA flash-attention kernel (``csrc/flash_attn.cu``).

The CUDA source replaces the Pallas TPU kernel
``repro/kernels/flash_attn/kernel.py:flash_attention``; its header states
the design and the bound.  :func:`flash_attention` launches it on CUDA
tensors on the current stream and raises if the launch fails.

The kernel reads q, k and v through their (batch, head, position) strides,
so a (B, H, S, D) view of a (B, S, H, D) tensor needs no copy; the last axis
must be contiguous, the strides multiples of 8 elements and the data
16-byte aligned.  The output has q's layout (``torch.empty_like``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import _build

_VP = ctypes.c_void_p
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_fwd.argtypes = [
            ctypes.c_int, _VP, _VP, _VP, _VP, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
            _VP]
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib._typed = True
    return lib


def kernel_ready(t: torch.Tensor) -> bool:
    """Whether the kernel can read ``t`` as it lies: a contiguous last
    axis, other strides multiples of 8 elements, 16-byte aligned data."""
    return (t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, Sq, D); k, v (B, Hkv, Sk, D), all float32 or all bf16 on
    one CUDA device, ``Hq % Hkv == 0``, ``D <= 128`` a multiple of 8,
    ``Sk >= 1`` and, when causal, ``Sq <= Sk``.  Returns (B, Hq, Sq, D) in
    q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention kernel: q (B, Hq, Sq, D) and k, v "
                         "(B, Hkv, Sk, D) of one shape")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, Dk = k.shape
    if k.shape[0] != B or Dk != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)} does "
                         f"not fit k/v {tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention kernel: q, k, v must all be "
                         "float32 or all bfloat16")
    if D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"flash_attention kernel: head dim {D} must be a "
                         f"multiple of 8 and at most {MAX_HEAD_DIM}")
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
    out = torch.empty_like(q)     # q's strides, or contiguous if q overlaps
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().flash_attention_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, Hq, Hkv, Sq, Sk, D, strides, float(scale),
            int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: "
                           f"cudaError {err}")
    return out
