"""Bounded retry with exponential backoff.

One shared primitive for every "transient failure" loop of the package:
the sweep runner's per-dispatch retry (``repro_torch.sweep.runner``), and
any training loop's per-step retry.  Deliberately tiny and injectable --
callers pass their own ``sleep`` so tests (and deterministic trace
comparisons) never wait on a wall clock, and ``on_retry`` so each caller
keeps its own logging / health-callback / trace-span idiom.
"""
from __future__ import annotations

import time
from typing import Callable, Optional


def retry_call(fn: Callable, *, max_retries: int, backoff_s: float,
               sleep: Callable[[float], None] = time.sleep,
               on_retry: Optional[Callable] = None,
               on_exhausted: Optional[Callable] = None):
    """Call ``fn()`` up to ``1 + max_retries`` times.

    On attempt ``a`` failing with a retry budget left: ``on_retry(a, exc,
    delay)`` is invoked (if given), then ``sleep(delay)`` with ``delay =
    backoff_s * 2**a``.  When the budget is exhausted ``on_exhausted(exc)``
    runs (cleanup hook -- e.g. draining an async checkpointer) and the last
    exception propagates unchanged.  Returns ``fn()``'s value.
    """
    for attempt in range(max_retries + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 -- caller-scoped transience
            if attempt >= max_retries:
                if on_exhausted is not None:
                    on_exhausted(e)
                raise
            delay = backoff_s * (2 ** attempt)
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)
