"""ctypes binding of the CUDA flash-attention kernels (``csrc/flash_attn.cu``
and ``csrc/flash_attn_f32.cu``, forward; ``csrc/flash_attn_bwd.cu`` and
``csrc/flash_attn_bwd_f32.cu``, backward; one library each, built side by
side).

The forward sources replace the Pallas TPU kernel
``repro/kernels/flash_attn/kernel.py:flash_attention``; their headers state
the design and the bound.  :func:`flash_attention` launches one of three
kernels on CUDA tensors on the current stream and raises if the launch
fails.  :func:`route` names the kernel:

* ``"wgmma"``: bf16 with a head dim up to 256 (every model of the repo),
  the bf16 tensor-core kernel (``wgmma`` + TMA);
* ``"wgmma_f32"``: float32 with q's head dim up to 192 and v's width up
  to 128 (``WGMMA_F32_MAX_DIMS``: every float32 path of the repo, MLA's
  Dk 192 / Dv 128 among them), the float32 tensor-core kernel, which
  splits each float32 operand into three bf16 planes and sums six partial
  products of each matrix product (float32 accuracy on the bf16 tensor
  cores: no TF32, which would miss the 2e-5 tolerance of the goldens);
* ``"cuda_cores"``: float32 with a wider head or value, and bf16 past
  256, the float32 CUDA-core kernel.

Any other floating dtype, and operands of mixed dtypes, are cast to float32
(exact for float16 and bf16), as the reference's ``mha`` casts them, and
take a float32 route; the output is cast back to q's dtype
(:func:`compute_dtype`).  A float32 operand is never rounded to bf16 as a
whole: the tensor-core route carries all its bits in its three planes.

The kernels read q, k and v through their (batch, head, position) strides,
so a (B, H, S, D) view of a (B, S, H, D) tensor needs no copy; the last axis
must be contiguous, the other strides multiples of 8 elements (TMA needs
16-byte strides) and the data 16-byte aligned (:func:`kernel_ready`;
:func:`ready_copy` makes such a copy of any tensor).  The output has q's
layout (``torch.empty_like``) when v's width is q's depth, else a new
contiguous tensor.

:func:`flash_attention_bwd` binds the backward kernels, the gradient of
the forward, on three routes (:func:`route_bwd`): with q's head dim up to
192 and v's width up to 128 (``WGMMA_BWD_MAX_DIMS``), bf16 runs the bf16
tensor-core kernels and float32 the float32 tensor-core kernels (the
three-way split), both of which read each row's log-sum-exp from the
forward (``flash_attention(..., return_lse=True)``); wider heads the
CUDA-core kernels, which recompute it.  They replace no TPU kernel:
JAX cannot differentiate the Pallas one, and the port's training path
needs this gradient.
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
# (q's head dim, v's width) limits of the tensor-core kernels past the bf16
# forward.  The float32 routes, both directions: three bf16 planes of Q (or
# K and V) resident in shared memory beside tiles of the others', which at
# D = 192 fit with 32-key tiles (forward) or one buffer of the operand read
# first (backward).  The bf16 backward: dK and dV accumulators in
# registers, 96 + 64 a thread at (192, 128); D = 256 would take 256.
WGMMA_F32_MAX_DIMS = (192, 128)
WGMMA_BWD_MAX_DIMS = (192, 128)
TENSOR_CORE_ROUTES = ("wgmma", "wgmma_f32")
_SHAPE_ARGS = [_VP, _VP, _VP, _VP, *[ctypes.c_int] * 7,
               ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
               ctypes.c_int, _VP]


_BWD_ARGS = [ctypes.c_int, *[_VP] * 10, *[ctypes.c_int] * 7,
             ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
             _VP]
_BWD_WGMMA_ARGS = [*[_VP] * 12, *[ctypes.c_int] * 7,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                   ctypes.c_int, _VP]
_LSE_ARGS = [*_SHAPE_ARGS[:-1], _VP, _VP]        # ..., lse, stream
# Each library (csrc/<name>.cu) and the argument types of its entry points.
_ENTRY_POINTS = {
    "flash_attn": {"flash_attention_cuda_cores_fwd": [ctypes.c_int,
                                                      *_SHAPE_ARGS],
                   "flash_attention_wgmma_fwd": _LSE_ARGS},
    "flash_attn_f32": {"flash_attention_f32_fwd": _LSE_ARGS},
    "flash_attn_bwd": {"flash_attention_bwd": _BWD_ARGS,
                       "flash_attention_bwd_wgmma": _BWD_WGMMA_ARGS},
    "flash_attn_bwd_f32": {"flash_attention_bwd_f32": _BWD_WGMMA_ARGS},
}


def _lib(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, its entry points typed."""
    lib = _build.load(name)
    if not getattr(lib, "_typed", False):
        for fn, args in _ENTRY_POINTS[name].items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        lib._typed = True
    return lib


def compute_dtype(*tensors: torch.Tensor) -> torch.dtype:
    """The dtype the kernels read: bf16 when every operand is bf16, else
    float32."""
    return (torch.bfloat16 if all(t.dtype == torch.bfloat16 for t in tensors)
            else torch.float32)


def route(dtype: torch.dtype, head_dim: int,
          value_dim: Optional[int] = None) -> str:
    """The forward kernel that takes (compute dtype, q's head dim, v's
    width, which defaults to the head dim): ``"wgmma"`` (bf16 tensor
    cores, head dim up to 256), ``"wgmma_f32"`` (float32 on the tensor
    cores, head dim up to 192 and width up to 128) or ``"cuda_cores"``
    (float32 CUDA cores)."""
    value_dim = head_dim if value_dim is None else value_dim
    if dtype == torch.bfloat16 and head_dim <= WGMMA_MAX_HEAD_DIM:
        return "wgmma"
    if dtype == torch.float32 and _within(head_dim, value_dim,
                                          WGMMA_F32_MAX_DIMS):
        return "wgmma_f32"
    return "cuda_cores"


def route_bwd(dtype: torch.dtype, head_dim: int, value_dim: int) -> str:
    """The backward kernels that take (dtype, head_dim, value_dim), both
    tensor-core routes up to head dim 192 and width 128: ``"wgmma"`` (bf16
    tensor cores), ``"wgmma_f32"`` (float32 on the tensor cores) or
    ``"cuda_cores"`` (float32 CUDA cores)."""
    if dtype == torch.bfloat16 and _within(head_dim, value_dim,
                                           WGMMA_BWD_MAX_DIMS):
        return "wgmma"
    if dtype == torch.float32 and _within(head_dim, value_dim,
                                          WGMMA_F32_MAX_DIMS):
        return "wgmma_f32"
    return "cuda_cores"


def _within(head_dim: int, value_dim: int, limits) -> bool:
    return head_dim <= limits[0] and value_dim <= limits[1]


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
                    causal: bool = True, scale: Optional[float] = None,
                    return_lse: bool = False):
    """q (B, Hq, Sq, D); k (B, Hkv, Sk, D); v (B, Hkv, Sk, Dv), floating
    point on one CUDA device, ``Hq % Hkv == 0``, ``D, Dv >= 1``, ``Sk >= 1``.
    All bf16 or all float32 run as they are; other and mixed dtypes in
    float32 (:func:`compute_dtype`).  Causal queries are the last Sq
    positions of the Sk-long context; with ``Sq > Sk`` the first ``Sq - Sk``
    see no key and give the mean of v.  Returns (B, Hq, Sq, Dv) in q's
    dtype; with ``return_lse``, ``(out, lse)``: on the tensor-core routes
    lse is each row's log-sum-exp of the scaled logits in the log2 domain,
    float32 (B, Hq, Sq) (``ref.mha_lse``; a row that sees no key holds
    about -1e30), on the CUDA-core route None (its backward recomputes
    it)."""
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
    if not all(t.is_floating_point() for t in (q, k, v)):
        raise ValueError("flash_attention kernel: q, k, v must be floating "
                         "point")
    if D < 1 or Dv < 1:
        raise ValueError("flash_attention kernel: head dims must be >= 1")
    if Sk == 0:
        raise ValueError("flash_attention kernel: needs Sk >= 1")
    out_dtype, cd = q.dtype, compute_dtype(q, k, v)
    if any(t.dtype != cd for t in (q, k, v)):
        q, k, v = (t if t.dtype == cd else ready_copy(t.to(cd))
                   for t in (q, k, v))
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
    which = route(q.dtype, D, Dv)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
           if return_lse and which in TENSOR_CORE_ROUTES else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            Hkv, Sq, Sk, D, Dv, strides, float(scale), int(bool(causal)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if which == "wgmma":
            err = _lib("flash_attn").flash_attention_wgmma_fwd(
                *args, None if lse is None else lse.data_ptr(), stream)
        elif which == "wgmma_f32":
            err = _lib("flash_attn_f32").flash_attention_f32_fwd(
                *args, None if lse is None else lse.data_ptr(), stream)
        else:
            err = _lib("flash_attn").flash_attention_cuda_cores_fwd(
                _DTYPES[q.dtype], *args, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed ({which}"
                           f" route): cudaError {err}")
    out = out if out.dtype == out_dtype else out.to(out_dtype)
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: Optional[torch.Tensor] = None, *,
                        causal: bool = True, scale: Optional[float] = None):
    """The gradients (dq, dk, dv) of :func:`flash_attention` (of
    ``ref.mha``) at q, k, v, given its output ``out`` and the output's
    gradient ``dout`` (both (B, Hq, Sq, Dv)), from the backward kernels of
    ``csrc/flash_attn_bwd.cu`` and ``csrc/flash_attn_bwd_f32.cu``, on the
    route :func:`route_bwd` names:

    * ``"wgmma"`` (all five bf16, D <= 192 and Dv <= 128): the bf16
      tensor-core kernels, which need ``lse``, the forward's log-sum-exp
      (``flash_attention(..., return_lse=True)``, float32 (B, Hq, Sq));
    * ``"wgmma_f32"`` (any other dtypes, read in float32, D <= 192 and Dv
      <= 128): the float32 tensor-core kernels (three bf16 planes of each
      operand, six products), which need ``lse`` too;
    * ``"cuda_cores"`` (wider heads): the float32 CUDA-core kernels,
      which recompute the log-sum-exp and ignore ``lse``; they read bf16 as
      it is when all five are bf16 and cast any other dtype to float32.

    Each gradient is returned in its input's dtype and layout
    (``torch.empty_like``)."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    Dv = v.shape[-1]
    if out.shape != (B, Hq, Sq, Dv) or dout.shape != out.shape:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} and "
                         f"dout {tuple(dout.shape)} must be {(B, Hq, Sq, Dv)}")
    dtypes = (q.dtype, k.dtype, v.dtype)
    cd = compute_dtype(q, k, v, out, dout)
    which = route_bwd(cd, D, Dv)
    tensor_cores = which in TENSOR_CORE_ROUTES
    if tensor_cores and (lse is None or lse.shape != (B, Hq, Sq)
                         or lse.dtype != torch.float32
                         or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: the {which} route needs the "
                         "forward's log-sum-exp, a contiguous float32 (B, "
                         "Hq, Sq) tensor (flash_attention(..., "
                         "return_lse=True))")
    ops = [t if t.dtype == cd and kernel_ready(t) else ready_copy(t.to(cd))
           for t in (q, k, v, out, dout)]
    dev = q.device
    for t in ops + ([lse] if tensor_cores else []):
        if not t.is_cuda or t.device != dev:
            raise ValueError("flash_attention_bwd: the operands must share "
                             "one CUDA device")
    grads = [torch.empty_like(t) for t in ops[:3]]
    if out.numel() == 0 or q.numel() == 0:
        for g in grads:
            g.zero_()
    else:
        dlt = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
        strides = (ctypes.c_longlong * 24)(
            *(s for t in (*ops, *grads) for s in t.stride()[:3]))
        if scale is None:
            scale = 1.0 / math.sqrt(D)
        shape = (B, Hq, Hkv, Sq, Sk, D, Dv, strides, float(scale),
                 int(bool(causal)))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if tensor_cores:
                # float32 partials of dK and dV, a query head each, in
                # 64-column chunks
                wk, wv = (torch.empty((B, Hq, Sk, -(-w // 64) * 64),
                                      dtype=torch.float32, device=dev)
                          for w in (D, Dv))
                fn = (_lib("flash_attn_bwd").flash_attention_bwd_wgmma
                      if which == "wgmma" else
                      _lib("flash_attn_bwd_f32").flash_attention_bwd_f32)
                err = fn(
                    *(t.data_ptr() for t in (*ops, lse, *grads, dlt, wk, wv)),
                    *shape, stream)
            else:
                lse = torch.empty_like(dlt)
                err = _lib("flash_attn_bwd").flash_attention_bwd(
                    _DTYPES[cd], *(t.data_ptr() for t in (*ops, *grads)),
                    lse.data_ptr(), dlt.data_ptr(), *shape, stream)
        if err != 0:
            raise RuntimeError(f"flash_attention_bwd launch failed ({which} "
                               f"route): cudaError {err}")
    return tuple(g if g.dtype == dt else g.to(dt)
                 for g, dt in zip(grads, dtypes))
