"""Shared helpers for the kernel packages and the entry points that call them.

Every kernel package (``lindley``, ``jsq_scan``) ships the same files:
``ref.py`` (the plain PyTorch version), ``kernel.py`` (the ctypes binding of
the hand-written CUDA kernel in ``repro_torch/csrc``) and ``ops.py`` (the
public wrapper).  The wrapper dispatches on the device of the tensor it is
given: a CPU tensor takes the plain version, a CUDA tensor launches the
kernel (or raises if the kernel cannot be built or launched).  There is no
fallback from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

BACKENDS = ("auto", "torch")


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """Device of an entry point: ``None`` means CUDA.

    Raises when CUDA is asked for (explicitly or by default) and no card is
    visible -- a run meant for the card never drops to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_backend(backend: str) -> str:
    """Validate a ``{auto, torch}`` backend switch.

    ``auto`` runs each kernel on CUDA tensors and its plain version on CPU
    tensors; ``torch`` runs the plain versions on any device (the card-side
    comparison of kernel against plain version)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    return backend


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: tensors must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
