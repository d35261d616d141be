"""ctypes binding of the CUDA JSQ arbitration scan (``csrc/jsq_scan.cu``).

The CUDA source replaces the ``lax.scan`` of the JAX reference's
``repro/net/fastsim.py:_jsq_layer``; its header states the design and the
bound.  :func:`jsq_scan` launches it on CUDA tensors on the current stream
and raises if the launch fails.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from .._common import check_cuda

_VP = ctypes.c_void_p
MAX_PORTS = 14_560          # a row's ports' last departures in shared memory


def _lib() -> ctypes.CDLL:
    lib = _build.load("jsq_scan")
    if not getattr(lib, "_typed", False):
        lib.jsq_scan.argtypes = [
            _VP, _VP, _VP, _VP, _VP, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP, _VP, _VP, _VP]
        lib.jsq_scan.restype = ctypes.c_int
        lib._typed = True
    return lib


def jsq_scan(t_grid: torch.Tensor, ok_grid: torch.Tensor, noise: torch.Tensor,
             port_pen: torch.Tensor, thresholds: Optional[torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel; shapes and meaning as ``ref.jsq_scan``."""
    B, S, pad = t_grid.shape
    h = noise.shape[-1]
    if not 1 <= h <= MAX_PORTS:
        raise ValueError(f"jsq_scan kernel: {h} ports, at most {MAX_PORTS} "
                         f"(the ports' last departures in shared memory)")
    if (t_grid.dtype != torch.float32 or noise.dtype != torch.float32
            or port_pen.dtype != torch.float32 or ok_grid.dtype != torch.bool):
        raise ValueError("jsq_scan kernel: float32 grids and bool ok_grid")
    if (ok_grid.shape != t_grid.shape or noise.shape != (B, S, pad, h)
            or port_pen.shape != (B, h)):
        raise ValueError("jsq_scan kernel: mismatched grid shapes")
    if thresholds is None:
        thresholds = torch.zeros(1, dtype=torch.float32, device=t_grid.device)
        nq = 0
    else:
        nq = thresholds.shape[0]
    ok = ok_grid.view(torch.uint8)
    check_cuda("jsq_scan", t_grid, ok, noise, port_pen, thresholds)
    ports = torch.empty((B, S, pad), dtype=torch.int32, device=t_grid.device)
    deps = torch.empty((B, S, pad), dtype=torch.float32, device=t_grid.device)
    occs = torch.empty((B, S, pad), dtype=torch.float32, device=t_grid.device)
    lib = _lib()
    with torch.cuda.device(t_grid.device):
        stream = torch.cuda.current_stream(t_grid.device).cuda_stream
        err = lib.jsq_scan(
            t_grid.data_ptr(), ok.data_ptr(), noise.data_ptr(),
            port_pen.data_ptr(), thresholds.data_ptr(), nq, B * S, S, pad, h,
            ports.data_ptr(), deps.data_ptr(), occs.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"jsq_scan launch failed: cudaError {err}")
    return ports, deps, occs
