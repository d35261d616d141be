"""ctypes binding of the CUDA SSD chunked-scan kernels (``csrc/ssd_scan.cu``).

The CUDA source replaces the Pallas TPU kernel
``repro/kernels/ssd_scan/kernel.py:ssd_scan``; its header states the design
and the bound.  :func:`ssd_scan` launches one of its two routes on CUDA
tensors on the current stream and raises if a launch fails
(:func:`route`): bf16 with N <= 256 takes the tensor-core walk
(``ssd_wgmma_kernel``: one launch, wgmma + TMA, the state kept on chip),
float32 (the goldens' type, where TF32 would miss the 5e-5 tolerance) and
bf16 with N > 256 the CUDA-core route (three launches: chunk states, the
state carry across chunks, the chunk outputs).  Both can return the final
state.  float16, or x, B and C of mixed dtypes, are cast to float32 (exact
for float16 and bf16), as the reference's ``ssd_chunked`` casts them, and
take the float32 route; y is cast back to x's dtype (:func:`compute_dtype`).
A float32 operand is never rounded to bf16.

The kernel reads x and dt through their (batch, position, head) strides and
B and C through their (batch, position, group) strides, so the model's
slices of one projection need no copy; the last axis of x, B and C must be
contiguous.  The output is a new contiguous (B, L, H, P) tensor in x's
dtype.  A ragged last chunk is masked in the kernel: any L >= 1 works, and
any P and N.  The chunked closed form is the same function for any cut of
L, so only the order of the float32 sums depends on the chunk: the
CUDA-core route runs a chunk above ``TILE`` (64, the kernels' row tile) as
chunks of ``TILE``, and the tensor-core walk runs every chunk as chunks of
``TILE``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

_VP = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64                   # rows of the kernel's chunk tile
WGMMA_MAX_N = 256           # widest state of the tensor-core walk


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    if not getattr(lib, "_typed", False):
        lib.ssd_scan_fwd.argtypes = (
            [_I] + [_VP] * 9 + [_I] * 7
            + [ctypes.POINTER(ctypes.c_longlong), _VP])
        lib.ssd_scan_fwd.restype = _I
        lib.ssd_scan_wgmma_fwd.argtypes = (
            [_VP] * 6 + [_I, _VP] + [_I] * 7
            + [ctypes.POINTER(ctypes.c_longlong), _VP])
        lib.ssd_scan_wgmma_fwd.restype = _I
        lib._typed = True
    return lib


def compute_dtype(x: torch.Tensor, B_mat: torch.Tensor,
                  C: torch.Tensor) -> torch.dtype:
    """The dtype the kernels read x, B and C in: bf16 when all three are
    bf16, else float32."""
    return (torch.bfloat16 if x.dtype == B_mat.dtype == C.dtype
            == torch.bfloat16 else torch.float32)


def route(dtype: torch.dtype, N: int) -> str:
    """``"wgmma"`` (the bf16 tensor-core walk) or ``"cuda_cores"``."""
    return ("wgmma" if dtype == torch.bfloat16 and N <= WGMMA_MAX_N
            else "cuda_cores")


def p_tile(P: int, N: int, heads: int, sms: int = 132) -> int:
    """P columns a CTA of the tensor-core walk takes (``heads``: batch x
    heads, a CTA each per tile).  A CTA's walk is a chain of dependent
    steps whose time barely depends on its width, so tiles of 32 pay only
    while they fill idle SMs: 32 when the tiles of 32 fit one CTA an SM,
    when N > 128 (the state of 64 columns would not fit the registers) or
    when P <= 32; else 64."""
    if N > 128 or P <= 32 or heads * -(-P // 32) <= sms:
        return 32
    return 64


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """x, B or C as TMA reads it: a 16-byte aligned base and strides of 16
    bytes along every axis longer than 1; else a contiguous copy with the
    last axis padded to a multiple of 8 (the zero columns change no
    product, and the kernel reads only the first ones)."""
    ok = t.data_ptr() % 16 == 0 and all(
        (st * t.element_size()) % 16 == 0
        for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)
    if ok:
        return t
    n = t.shape[-1]
    out = torch.zeros(t.shape[:3] + (-(-n // 8) * 8,), dtype=t.dtype,
                      device=t.device)
    out[..., :n] = t
    return out


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_mat: torch.Tensor, C: torch.Tensor, *,
             chunk: int = 64, final_state: bool = False,
             ptile: Optional[int] = None):
    """x (B, L, H, P); dt (B, L, H); A (H,); B_mat, C (B, L, G, N),
    ``H % G == 0``; all floating point on one CUDA device; chunk, P and N
    >= 1.  x, B and C all bf16 take the tensor-core walk, else they are
    read in float32 (:func:`compute_dtype`); dt and A are read in float32.
    Returns y (B, L, H, P) in x's dtype, and with ``final_state`` also the
    state after the last position, (B, H, N, P) float32.  ``ptile`` (32 or
    64) overrides the P columns of a tensor-core CTA (:func:`p_tile`)."""
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
    if not all(t.is_floating_point() for t in (x, dt, A, B_mat, C)):
        raise ValueError("ssd_scan kernel: x, dt, A, B and C must be "
                         "floating point")
    out_dtype, cd = x.dtype, compute_dtype(x, B_mat, C)
    x, B_mat, C = (t if t.dtype == cd else t.to(cd) for t in (x, B_mat, C))
    dt, A = dt.float(), A.float().contiguous()
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
    which = route(x.dtype, N)
    # The walk stores y by TMA: rows of a multiple of 16 bytes.
    Py = -(-P // 8) * 8 if which == "wgmma" else P
    y = torch.empty((Bsz, L, H, Py), dtype=x.dtype, device=dev)
    hfin = (torch.empty((Bsz, H, N, P), dtype=torch.float32, device=dev)
            if final_state else None)
    if y.numel() == 0:
        y = y[..., :P].to(out_dtype)
        return (y, hfin.zero_()) if final_state else y
    if which == "wgmma":
        x, B_mat, C = _tma_ready(x), _tma_ready(B_mat), _tma_ready(C)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        pt = p_tile(P, N, Bsz * H, sms) if ptile is None else int(ptile)
        if pt not in (32, 64) or (pt == 64 and N > 128):
            raise ValueError(f"ssd_scan kernel: ptile {pt} (32, or 64 with "
                             f"N <= 128)")
    else:
        nc = -(-L // chunk)
        states = torch.empty((Bsz, H, nc, N, P), dtype=torch.float32,
                             device=dev)
        lam = torch.empty((Bsz, H, nc), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (x, dt, B_mat, C) for s in t.stride()[:3]))
    hptr = hfin.data_ptr() if final_state else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if which == "wgmma":
            err = _lib().ssd_scan_wgmma_fwd(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_mat.data_ptr(),
                C.data_ptr(), y.data_ptr(), Py, hptr, Bsz, L, H, G, P, N, pt,
                strides, stream)
        else:
            err = _lib().ssd_scan_fwd(
                _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                B_mat.data_ptr(), C.data_ptr(), y.data_ptr(),
                states.data_ptr(), lam.data_ptr(), hptr, Bsz, L, H, G, P, N,
                chunk, strides, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan ({which}) launch failed: cudaError "
                           f"{err}")
    if Py != P:
        y = y[..., :P]
    if y.dtype != out_dtype:
        y = y.to(out_dtype)
    return (y, hfin) if final_state else y
