"""ctypes binding of the CUDA SSD chunked-scan kernels (``csrc/ssd_scan.cu``
and ``csrc/ssd_scan_f32.cu``).

The CUDA sources replace the Pallas TPU kernel
``repro/kernels/ssd_scan/kernel.py:ssd_scan``; their headers state the
design and the bound.  :func:`ssd_scan` launches one of three routes on
CUDA tensors on the current stream and raises if a launch fails
(:func:`route`): bf16 with N <= 256 takes the bf16 tensor-core walk
(``ssd_wgmma_kernel``: one launch, wgmma + TMA, the state kept on chip),
float32 with N <= 128 the float32 tensor-core walk (``ssd_wgmma_f32_kernel``:
one launch, the same dataflow, each float32 operand split into three bf16
parts and each product taken as six exact bf16 products, float32 accuracy
where TF32 would miss the 5e-5 tolerance), float32 with N > 128 and bf16
with N > 256 the CUDA-core route (three launches: chunk states, the state
carry across chunks, the chunk outputs).  All three can return the final
state.  float16, or x, B and C of mixed dtypes, are cast to float32 (exact
for float16 and bf16), as the reference's ``ssd_chunked`` casts them, and
take a float32 route; y is cast back to x's dtype (:func:`compute_dtype`).
A float32 operand is never rounded to bf16 whole.

The kernels read x and dt through their (batch, position, head) strides and
B and C through their (batch, position, group) strides, so the model's
slices of one projection need no copy; the last axis of x, B and C must be
contiguous.  The output is a new contiguous (B, L, H, P) tensor in x's
dtype.  A ragged last chunk is masked in the kernels: any L >= 1 works, and
any P and N.  The chunked closed form is the same function for any cut of
L, so only the order of the float32 sums depends on the chunk: the
CUDA-core route runs a chunk above ``TILE`` (64, the kernels' row tile) as
chunks of ``TILE``, and both tensor-core walks run every chunk as chunks of
``TILE``.

:func:`ssd_scan_bwd` launches the backward: the gradients of x, dt, A, B
and C along dy and, optionally, the final state's gradient, on one of two
routes (:func:`route_bwd`), each four launches with no atomics (chunk
states, the carries of h and dh across chunks, a block per chunk, the
fixed-order sums): bf16 with N <= 128 and P <= 256 on the tensor cores
(``csrc/ssd_scan_bwd_wgmma.cu``: wgmma + TMA, every float32 operand split
into bf16 high and low parts, a block per (chunk, run of heads of one
group)), the rest on the CUDA cores in float32 (``csrc/ssd_scan_bwd.cu``).
Both read their inputs as the forward does (strided x, dy, B and C with a
contiguous last axis, float16 and mixed dtypes in float32 on the CUDA
cores, a ragged last chunk masked; the CUDA cores run a chunk above 64 as
chunks of 64, the tensor cores every chunk as chunks of 64).
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
WGMMA_MAX_N = 256           # widest state of the bf16 tensor-core walk
WGMMA_F32_MAX_N = 128       # widest state of the float32 tensor-core walk
WGMMA_BWD_MAX_N = 128       # widest state of the bf16 tensor-core backward
WGMMA_BWD_MAX_P = 256       # widest head of it (x and dy stay on chip)
# Backward launches by route, counted where :func:`ssd_scan_bwd` launches.
BWD_ROUTE_LAUNCHES = {"wgmma": 0, "cuda_cores": 0}


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


def _lib_f32() -> ctypes.CDLL:
    lib = _build.load("ssd_scan_f32")
    if not getattr(lib, "_typed", False):
        lib.ssd_scan_wgmma_f32_fwd.argtypes = (
            [_VP] * 7 + [_I] * 7
            + [ctypes.POINTER(ctypes.c_longlong), _VP])
        lib.ssd_scan_wgmma_f32_fwd.restype = _I
        lib._typed = True
    return lib


def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("ssd_scan_bwd")
    if not getattr(lib, "_typed", False):
        lib.ssd_scan_bwd.argtypes = (
            [_I] + [_VP] * 18 + [_I] * 7
            + [ctypes.POINTER(ctypes.c_longlong), _VP])
        lib.ssd_scan_bwd.restype = _I
        lib._typed = True
    return lib


def _lib_bwd_wgmma() -> ctypes.CDLL:
    lib = _build.load("ssd_scan_bwd_wgmma")
    if not getattr(lib, "_typed", False):
        lib.ssd_scan_bwd_wgmma.argtypes = (
            [_VP] * 18 + [_I] * 7 + [ctypes.POINTER(ctypes.c_longlong), _VP])
        lib.ssd_scan_bwd_wgmma.restype = _I
        lib._typed = True
    return lib


def compute_dtype(x: torch.Tensor, B_mat: torch.Tensor,
                  C: torch.Tensor) -> torch.dtype:
    """The dtype the kernels read x, B and C in: bf16 when all three are
    bf16, else float32."""
    return (torch.bfloat16 if x.dtype == B_mat.dtype == C.dtype
            == torch.bfloat16 else torch.float32)


def route(dtype: torch.dtype, N: int) -> str:
    """``"wgmma"`` (the bf16 tensor-core walk), ``"wgmma_f32"`` (the
    float32 one) or ``"cuda_cores"``, for x, B and C read in ``dtype``
    (:func:`compute_dtype`) and a state of N."""
    if dtype == torch.bfloat16:
        return "wgmma" if N <= WGMMA_MAX_N else "cuda_cores"
    return "wgmma_f32" if N <= WGMMA_F32_MAX_N else "cuda_cores"


def route_bwd(dtype: torch.dtype, N: int, P: int) -> str:
    """The backward's route for x, B and C read in ``dtype``, a state of N
    and a head of P: ``"wgmma"`` (the tensor cores) for bf16 with N <=
    ``WGMMA_BWD_MAX_N`` and P <= ``WGMMA_BWD_MAX_P``, else ``"cuda_cores"``
    (float32 arithmetic on the CUDA cores)."""
    if (dtype == torch.bfloat16 and N <= WGMMA_BWD_MAX_N
            and P <= WGMMA_BWD_MAX_P):
        return "wgmma"
    return "cuda_cores"


def heads_per_cta(Bsz: int, L: int, H: int, G: int, sms: int = 132) -> int:
    """Heads a block of the tensor-core backward takes (consecutive heads
    of one group, which share B and C: their dB and dC are summed in the
    block): the most, up to 8, that divide the group's heads and still
    leave at least four blocks an SM, else 1."""
    rep, nc = H // G, -(-L // TILE)
    for d in range(min(8, rep), 1, -1):
        if rep % d == 0 and Bsz * nc * (H // d) >= 4 * sms:
            return d
    return 1


def p_tile(P: int, N: int, heads: int, sms: int = 132,
           dtype: torch.dtype = torch.bfloat16) -> int:
    """P columns a CTA of a tensor-core walk takes (``heads``: batch x
    heads, a CTA each per tile).  A CTA's walk is a chain of dependent
    steps whose time barely depends on its width, so tiles of 32 pay only
    while they fill idle SMs: 32 when the tiles of 32 fit one CTA an SM,
    when N is past what a CTA of 64 columns holds (128 for the bf16 walk,
    64 for the float32 one: registers and shared memory) or when P <= 32;
    else 64."""
    widest = 128 if dtype == torch.bfloat16 else 64
    if N > widest or P <= 32 or heads * -(-P // 32) <= sms:
        return 32
    return 64


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """x, B or C as a tensor-core walk reads it (TMA, or the float32 walk's
    16-byte loads): a 16-byte aligned base and strides of 16 bytes along
    every axis longer than 1; else a contiguous copy with the last axis
    padded to a multiple of 8 (the zero columns change no product, and the
    kernels read only the first ones)."""
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
    >= 1.  x, B and C all bf16 take the bf16 tensor-core walk, else they
    are read in float32 (:func:`compute_dtype`) and take the float32 one
    up to N = 128; wider states take the CUDA-core route (:func:`route`);
    dt and A are read in float32.  Returns y (B, L, H, P) in x's dtype, and
    with ``final_state`` also the state after the last position, (B, H, N,
    P) float32.  ``ptile`` (32 or 64) overrides the P columns of a
    tensor-core CTA (:func:`p_tile`; 64 needs N <= 128 in bf16, N <= 64 in
    float32)."""
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
    # The bf16 walk stores y by TMA: rows of a multiple of 16 bytes.
    Py = -(-P // 8) * 8 if which == "wgmma" else P
    y = torch.empty((Bsz, L, H, Py), dtype=x.dtype, device=dev)
    hfin = (torch.empty((Bsz, H, N, P), dtype=torch.float32, device=dev)
            if final_state else None)
    if y.numel() == 0:
        y = y[..., :P].to(out_dtype)
        return (y, hfin.zero_()) if final_state else y
    if which in ("wgmma", "wgmma_f32"):
        x, B_mat, C = _tma_ready(x), _tma_ready(B_mat), _tma_ready(C)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        pt = (p_tile(P, N, Bsz * H, sms, x.dtype) if ptile is None
              else int(ptile))
        widest = 128 if which == "wgmma" else 64
        if pt not in (32, 64) or (pt == 64 and N > widest):
            raise ValueError(f"ssd_scan kernel: ptile {pt} (32, or 64 with "
                             f"N <= {widest})")
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
        elif which == "wgmma_f32":
            err = _lib_f32().ssd_scan_wgmma_f32_fwd(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_mat.data_ptr(),
                C.data_ptr(), y.data_ptr(), hptr, Bsz, L, H, G, P, N, pt,
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


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B_mat: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                 dh_final: Optional[torch.Tensor] = None, *,
                 chunk: int = 64):
    """(dx, ddt, dA, dB, dC), each in its input's dtype: the gradients of
    :func:`ssd_scan` at (x, dt, A, B_mat, C) along dy (B, L, H, P) and, if
    given, along the final state's gradient ``dh_final`` (B, H, N, P).
    Shapes and devices as :func:`ssd_scan`; the last axis of x, dy, B and C
    must be contiguous.  Takes :func:`route_bwd`'s route, launches on the
    current stream, counts the launch in ``BWD_ROUTE_LAUNCHES`` and raises
    if a launch fails."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B_mat.dim() != 4 \
            or C.shape != B_mat.shape or dy.shape != x.shape:
        raise ValueError("ssd_scan_bwd kernel: x and dy (B, L, H, P), dt "
                         "(B, L, H), A (H,), B and C (B, L, G, N) of one "
                         "shape")
    Bsz, L, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    if (tuple(dt.shape) != (Bsz, L, H) or tuple(A.shape) != (H,)
            or tuple(B_mat.shape[:2]) != (Bsz, L) or G == 0 or H % G):
        raise ValueError(f"ssd_scan_bwd kernel: shapes x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, B/C "
                         f"{tuple(B_mat.shape)} do not fit")
    if dh_final is not None and tuple(dh_final.shape) != (Bsz, H, N, P):
        raise ValueError(f"ssd_scan_bwd kernel: dh_final "
                         f"{tuple(dh_final.shape)}, expected "
                         f"{(Bsz, H, N, P)}")
    ins = (x, dt, A, B_mat, C, dy) + (() if dh_final is None else (dh_final,))
    if not all(t.is_floating_point() for t in ins):
        raise ValueError("ssd_scan_bwd kernel: inputs must be floating "
                         "point")
    dev = x.device
    for t in ins:
        if not t.is_cuda or t.device != dev:
            raise ValueError("ssd_scan_bwd kernel: tensors must share one "
                             "CUDA device")
    if chunk < 1:
        raise ValueError(f"ssd_scan_bwd kernel: chunk {chunk} < 1")
    dtypes = (x.dtype, dt.dtype, A.dtype, B_mat.dtype, C.dtype)
    cd = compute_dtype(x, B_mat, C)
    xk, Bk, Ck, dyk = (t if t.dtype == cd else t.to(cd)
                       for t in (x, B_mat, C, dy))
    dtk, Ak = dt.float(), A.float().contiguous()
    if any(t.stride(-1) != 1 for t in (xk, Bk, Ck, dyk) if t.shape[-1] > 1):
        raise ValueError("ssd_scan_bwd kernel: the last axis of x, dy, B and "
                         "C must be contiguous")
    dhk = None if dh_final is None else dh_final.float().contiguous()
    which = route_bwd(cd, N, P)
    chunk = TILE if which == "wgmma" else min(chunk, TILE)
    nc = -(-L // chunk) if L else 0
    dx = torch.empty((Bsz, L, H, P), dtype=cd, device=dev)
    ddt = torch.empty((Bsz, L, H), dtype=torch.float32, device=dev)
    dA = torch.empty((H,), dtype=torch.float32, device=dev)
    dB = torch.empty((Bsz, L, G, N), dtype=cd, device=dev)
    dC = torch.empty((Bsz, L, G, N), dtype=cd, device=dev)
    if Bsz * L * H * P * N == 0:
        outs = (dx.zero_(), ddt.zero_(), dA.zero_(), dB.zero_(), dC.zero_())
        return tuple(g if g.dtype == d else g.to(d)
                     for g, d in zip(outs, dtypes))
    f32 = dict(dtype=torch.float32, device=dev)
    if which == "wgmma":
        xk, Bk, Ck, dyk = (_tma_ready(t) for t in (xk, Bk, Ck, dyk))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        hpc = heads_per_cta(Bsz, L, H, G, sms)
        parts = H // hpc
    else:
        parts = H
    states = torch.empty((Bsz, H, nc, N, P), **f32)
    dstates = torch.empty((Bsz, H, nc, N, P), **f32)
    lam_end = torch.empty((Bsz, H, nc), **f32)
    dBp = torch.empty((Bsz, L, parts, N), **f32)
    dCp = torch.empty((Bsz, L, parts, N), **f32)
    dAp = torch.empty((Bsz, H, nc), dtype=torch.float64, device=dev)
    strides = (ctypes.c_longlong * 15)(
        *(s for t in (xk, dtk, Bk, Ck, dyk) for s in t.stride()[:3]))
    ptrs = (xk.data_ptr(), dtk.data_ptr(), Ak.data_ptr(), Bk.data_ptr(),
            Ck.data_ptr(), dyk.data_ptr(),
            None if dhk is None else dhk.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            states.data_ptr(), dstates.data_ptr(), lam_end.data_ptr(),
            dBp.data_ptr(), dCp.data_ptr(), dAp.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if which == "wgmma":
            err = _lib_bwd_wgmma().ssd_scan_bwd_wgmma(
                *ptrs, Bsz, L, H, G, P, N, hpc, strides, stream)
        else:
            err = _lib_bwd().ssd_scan_bwd(
                _DTYPES[cd], *ptrs, Bsz, L, H, G, P, N, chunk, strides,
                stream)
        if err == 0:
            BWD_ROUTE_LAUNCHES[which] += 1
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd ({which}) launch failed: "
                           f"cudaError {err}")
    outs = (dx, ddt, dA, dB, dC)
    return tuple(g if g.dtype == d else g.to(d)
                 for g, d in zip(outs, dtypes))
