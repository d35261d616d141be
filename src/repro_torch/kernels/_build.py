"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``repro_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled on its own into ``build/repro_torch_kernels/<name>-<hash>.so`` at
the root of the checkout, where ``<hash>`` covers the source text and the
compiler flags.  The fabric and SSD kernels are built with
``--fmad=false``, so that no multiply-add is contracted and their results
stay bitwise those of their plain versions; the attention kernels, held to
a tolerance, let the compiler contract (:func:`flags`).  A library that is already there is loaded as it is, so
only the first use after a change pays for ``nvcc``.  :func:`build_all`
starts one ``nvcc`` per source at once; :func:`load` builds one source if
needed and returns its ``ctypes.CDLL``.  ``BUILDS`` counts the ``nvcc``
runs of this process (the sweep runner's compile-cache misses).

Nothing is compiled or loaded at import time: the CPU tests import every
module of the package on machines with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CONTRACTED = ("flash_attn",)    # sources built without --fmad=false

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILDS = 0


def sources() -> List[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = shutil.which("nvcc") or (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None)
    if not cand or not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return cand


def flags(name: str) -> List[str]:
    """The ``nvcc`` flags of ``csrc/<name>.cu``."""
    return [*NVCC_FLAGS, *(() if name in CONTRACTED else ("--fmad=false",))]


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def _start(name: str):
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    global BUILDS
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    BUILDS += 1
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> Dict[str, str]:
    """Compile every kernel source that is not built yet, one ``nvcc`` per
    source, all started together.  Returns ``{name: compiler output}``
    (empty for a library that was already built)."""
    jobs = {name: _start(name) for name in sources()}
    return {name: _finish(name, job) for name, job in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib
