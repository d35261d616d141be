"""ctypes binding of the CUDA segmented-cummax kernel (``csrc/lindley.cu``).

The CUDA source replaces the Pallas TPU kernel
``repro/kernels/lindley/kernel.py:segmented_cummax``; its header states the
design and the memory bound.  :func:`segmented_cummax` launches it on a 1-D
CUDA tensor on the current stream and raises if the launch fails.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._common import check_cuda

_VP = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = _build.load("lindley")
    if not getattr(lib, "_typed", False):
        lib.lindley_segmented_cummax.argtypes = [
            _VP, _VP, ctypes.c_int, ctypes.c_int64, _VP, _VP, _VP]
        lib.lindley_segmented_cummax.restype = ctypes.c_int
        lib.lindley_scratch_bytes.argtypes = [ctypes.c_int64]
        lib.lindley_scratch_bytes.restype = ctypes.c_int64
        lib._typed = True
    return lib


def segmented_cummax(v: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a contiguous 1-D float32 CUDA ``v`` and bool,
    uint8 or int32 ``flags`` of the same length (``n > 0``)."""
    if v.dtype != torch.float32 or v.dim() != 1:
        raise ValueError("segmented_cummax kernel: v must be 1-D float32")
    if flags.shape != v.shape:
        raise ValueError("segmented_cummax kernel: flags must match v")
    if flags.dtype == torch.bool:
        flags = flags.view(torch.uint8)
    if flags.dtype not in (torch.uint8, torch.int32):
        raise ValueError("segmented_cummax kernel: flags must be bool, "
                         "uint8 or int32")
    check_cuda("segmented_cummax", v, flags)
    n = v.shape[0]
    lib = _lib()
    out = torch.empty_like(v)
    scratch = torch.empty(int(lib.lindley_scratch_bytes(n)), dtype=torch.uint8,
                          device=v.device)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.lindley_segmented_cummax(
            v.data_ptr(), flags.data_ptr(), flags.element_size(), n,
            out.data_ptr(), scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"lindley_segmented_cummax launch failed: "
                           f"cudaError {err}")
    return out
