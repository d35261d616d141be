"""ctypes binding of the CUDA SSD chunked-scan kernel (``csrc/ssd_scan.cu``).

The CUDA source replaces the Pallas TPU kernel
``repro/kernels/ssd_scan/kernel.py:ssd_scan``; its header states the design
and the bound.  :func:`ssd_scan` launches it (three kernels: chunk states,
the state carry across chunks, the chunk outputs) on CUDA tensors on the
current stream and raises if a launch fails.

The kernel reads x and dt through their (batch, position, head) strides and
B and C through their (batch, position, group) strides, so the model's
slices of one projection need no copy; the last axis of x, B and C must be
contiguous.  The output is a new contiguous (B, L, H, P) tensor in x's
dtype.  A ragged last chunk is masked in the kernel: any L >= 1 works, and
any P and N.  A chunk above ``TILE`` (64, the kernel's row tile) runs as
chunks of ``TILE``: the chunked closed form is the same function for any
cut, so only the order of the float32 sums changes.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_VP = ctypes.c_void_p
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64                   # rows of the kernel's chunk tile


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    if not getattr(lib, "_typed", False):
        lib.ssd_scan_fwd.argtypes = (
            [ctypes.c_int] + [_VP] * 8 + [ctypes.c_int] * 7
            + [ctypes.POINTER(ctypes.c_longlong), _VP])
        lib.ssd_scan_fwd.restype = ctypes.c_int
        lib._typed = True
    return lib


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_mat: torch.Tensor, C: torch.Tensor, *,
             chunk: int = 64) -> torch.Tensor:
    """x (B, L, H, P) float32 or bf16; dt (B, L, H) float32; A (H,)
    float32, contiguous; B_mat, C (B, L, G, N) of x's dtype, ``H % G ==
    0``; all on one CUDA device; chunk, P and N >= 1.  Returns y (B, L, H,
    P) in x's dtype."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B_mat.dim() != 4 \
            or C.shape != B_mat.shape:
        raise ValueError("ssd_scan kernel: x (B, L, H, P), dt (B, L, H), "
                         "A (H,), B and C (B, L, G, N) of one shape")
    Bsz, L, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    if (tuple(dt.shape) != (Bsz, L, H) or tuple(A.shape) != (H,)
            or tuple(B_mat.shape[:2]) != (Bsz, L) or G == 0 or H % G):
        raise ValueError(f"ssd_scan kernel: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B/C "
                         f"{tuple(B_mat.shape)} do not fit")
    if x.dtype not in _DTYPES or B_mat.dtype != x.dtype \
            or C.dtype != x.dtype:
        raise ValueError("ssd_scan kernel: x, B and C must all be float32 "
                         "or all bfloat16")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError("ssd_scan kernel: dt and A must be float32")
    if chunk < 1 or P < 1 or N < 1:
        raise ValueError(f"ssd_scan kernel: needs chunk, P and N >= 1 "
                         f"(chunk={chunk}, P={P}, N={N})")
    chunk = min(chunk, TILE)
    dev = x.device
    for t in (x, dt, A, B_mat, C):
        if not t.is_cuda or t.device != dev:
            raise ValueError("ssd_scan kernel: tensors must share one CUDA "
                             "device")
    if x.stride(-1) != 1 or B_mat.stride(-1) != 1 or C.stride(-1) != 1 \
            or not A.is_contiguous():
        raise ValueError("ssd_scan kernel: the last axis of x, B and C and "
                         "A must be contiguous")
    y = torch.empty((Bsz, L, H, P), dtype=x.dtype, device=dev)
    if y.numel() == 0:
        return y
    nc = -(-L // chunk)
    states = torch.empty((Bsz, H, nc, N, P), dtype=torch.float32,
                         device=dev)
    lam = torch.empty((Bsz, H, nc), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (x, dt, B_mat, C) for s in t.stride()[:3]))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ssd_scan_fwd(
            _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B_mat.data_ptr(), C.data_ptr(), y.data_ptr(), states.data_ptr(),
            lam.data_ptr(), Bsz, L, H, G, P, N, chunk, strides, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_fwd launch failed: cudaError {err}")
    return y
