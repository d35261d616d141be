"""Persistent kernel-build cache for repeat campaign invocations.

The port compiles nothing per pipeline shape: the engines run the same
hand-written CUDA kernels at every shape.  What a first run pays for, and a
repeat run can skip, is ``nvcc`` building those kernels
(``repro_torch.kernels._build``).  The libraries are written to a directory
keyed by each source's text and compiler flags, so re-running a campaign,
or running another one, reuses them.  This module points that directory
where the caller asks; on the CPU nothing is ever built and the directory
stays empty.

The cache location, in precedence order:

1. an explicit path (``run_campaign(compile_cache_dir=...)`` or the CLI's
   ``--compile-cache``);
2. the ``REPRO_COMPILE_CACHE`` environment variable;
3. otherwise the checkout's own ``build/repro_torch_kernels`` (already
   persistent), and :func:`enable` returns None.

The runner records the directory in the plan span (``cache_dir``) and the
files it gained in the campaign span (``cache_entries_added``); both are
timing fields of the trace.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from ..kernels import _build

ENV_VAR = "REPRO_COMPILE_CACHE"
_enabled_dir: Optional[str] = None


def enable(path: Optional[str] = None) -> Optional[str]:
    """Build and load the CUDA kernels from ``path`` (or the
    ``REPRO_COMPILE_CACHE`` env var) from now on.  Returns the active cache
    directory, or None when no path was given.  Libraries already loaded in
    this process stay loaded."""
    global _enabled_dir
    path = path or os.environ.get(ENV_VAR)
    if not path:
        return None
    if _enabled_dir == str(path):
        return _enabled_dir
    os.makedirs(path, exist_ok=True)
    _build.BUILD_DIR = Path(path)
    _enabled_dir = str(path)
    return _enabled_dir


def active_dir() -> Optional[str]:
    return _enabled_dir
