"""Versioned JSONL dispatch traces.

The campaign runner emits one span per fused megabatch dispatch plus
campaign-level bookends into a :class:`TraceWriter`, which mirrors the
ResultStore's persistence contract: sorted keys, flush-per-line, and -- for
everything except the wall-clock / cache-state fields named in
:data:`TIMING_KEYS` -- byte-deterministic across re-runs of the same
campaign (tested in ``tests/test_obs.py`` via :func:`strip_timing`).

Span kinds (the ``kind`` field):

* ``"plan"``     -- one per campaign, before execution: grid size, dispatch
  and compiled-shape counts, device count, probe spec.  Cost-mode plans
  (``Campaign.planner="cost"``) additionally record the chosen bucket
  policy (``policy``, ``kmap``, ``pkt_exact``), its ``predicted`` cost
  breakdown (padded packet rows, fill, compile charge), the rejected
  ``alternatives``, and -- when calibrated via ``--plan-from-trace`` --
  the ``calibration`` source.
* ``"dispatch"`` -- one per fused megabatch: member population, padding
  ratios (packet rows, batch-row fill, loop slot budget), shard/device
  fill, wall seconds, optional compile-vs-execute split, compile-cache
  hit/miss.  Loop-engine dispatches additionally carry ``"impl"`` -- the
  *resolved* slot-step implementation (``"cuda"``: the CUDA kernels, or
  ``"torch"``: their plain versions; an ``impl="auto"`` campaign records
  ``"cuda"`` on a card and ``"torch"`` on the CPU), so perf trajectories
  can tell kernel runs from plain runs.
* ``"campaign"`` -- one per campaign, after execution: totals, including
  the trace's own cumulative emit overhead (``emit_s``), which is how the
  benchmark measures telemetry cost, and the *realized* packet-row
  padding counters (``pkt_rows_real`` / ``pkt_rows_padded`` /
  ``pkt_fill``) the report sets against a cost-mode plan's prediction.

Robustness spans (the runner's retry / degradation ladder / resume,
``sweep.runner``):

* ``"retry"``    -- a dispatch attempt failed with retry budget left:
  attempt index, error repr, backoff seconds.
* ``"error"``    -- a failure that exhausted its budget, at ``stage``
  ``"megabatch"`` (whole fused dispatch), ``"member"`` (one seed batch
  during degradation) or ``"point"`` (one seed during serial fallback);
  points under a terminal error span produce no result records.
* ``"degrade"``  -- a dispatch that completed only after splitting, at
  ``stage`` ``"member"`` or ``"serial"``.
* ``"resume"``   -- a ``--resume`` run skipping already-complete
  dispatches: how many were kept, how many records were trusted.

Every span carries ``"schema": TRACE_SCHEMA``; readers should skip spans
with a schema they don't know.
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Dict, List, Optional

import numpy as np

TRACE_SCHEMA = 1

# Fields that legitimately differ between two runs of the same campaign:
# wall-clock measurements and process/compile-cache state.  Golden
# comparisons strip these (strip_timing); everything else in a span is a
# pure function of the campaign spec and the simulation results.
TIMING_KEYS = frozenset({
    "wall_s", "compile_s", "execute_s", "emit_s",
    "cache", "cache_dir", "cache_entries_added",
    # Robustness fields: which attempt failed, with what error, after what
    # backoff is environment-dependent (a transient OOM needn't recur).
    "error", "backoff_s",
})


def strip_timing(span: Dict) -> Dict:
    """A span minus its :data:`TIMING_KEYS` fields (golden comparisons)."""
    return {k: v for k, v in span.items() if k not in TIMING_KEYS}


def _canon(x):
    if isinstance(x, np.floating):
        return float(x)
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.ndarray):
        return [_canon(v) for v in x.tolist()]
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    return x


def encode_span(span: Dict) -> str:
    return json.dumps({k: _canon(v) for k, v in span.items()},
                      sort_keys=True)


class TraceWriter:
    """Append-only JSONL span sink (``path=None`` keeps spans in memory).

    ``emit_s`` accumulates the wall time spent inside :meth:`emit` --
    the telemetry layer's own overhead, reported in the final campaign
    span and in ``BENCH_sweep.json``'s telemetry section.

    ``overwrite=False`` appends to an existing file instead of replacing
    it -- the ``--resume`` mode: a resumed campaign's trace keeps the
    crashed run's spans followed by a ``"resume"`` span and the replayed
    tail (traces are an execution log, so unlike ``results.jsonl`` they
    are *not* expected to be byte-identical to an uninterrupted run's).
    """

    def __init__(self, path: Optional[str] = None, overwrite: bool = True):
        self.path = pathlib.Path(path) if path else None
        self.spans: List[Dict] = []
        self.emit_s = 0.0
        self._fh = None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            if overwrite and self.path.exists():
                self.path.unlink()

    def emit(self, span: Dict) -> Dict:
        t0 = time.perf_counter()
        span = {"schema": TRACE_SCHEMA, **span}
        self.spans.append(span)
        if self.path:
            if self._fh is None:
                self._fh = self.path.open("a")
            self._fh.write(encode_span(span) + "\n")
            self._fh.flush()    # every emitted span is durable on return
        self.emit_s += time.perf_counter() - t0
        return span

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def load_trace(path: str) -> List[Dict]:
    """Read a trace JSONL back into its list of spans."""
    with pathlib.Path(path).open() as f:
        return [json.loads(line) for line in f if line.strip()]
