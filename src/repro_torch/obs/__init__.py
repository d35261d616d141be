"""Observability layer for the campaign engine.

Stdlib- and numpy-only pieces, so both the sweep stack and the engines can
import from here without cycles:

* :mod:`~repro_torch.obs.trace` -- versioned JSONL dispatch traces.  The
  runner emits one structured span per fused megabatch dispatch (plan key,
  bucket population, padding ratios, device fill, wall / compile-vs-execute
  split, compile-cache hits) plus campaign-level bookend spans; spans are
  deterministic modulo the :data:`~repro_torch.obs.trace.TIMING_KEYS`
  fields.
* :mod:`~repro_torch.obs.probes` -- the opt-in in-simulation probe spec
  (``Campaign.probes``): a fixed (stride, samples) downsampling grid both
  engines use to carry a per-layer queue-occupancy time series out of the
  batched pipelines without splitting pipeline shapes.
* :mod:`~repro_torch.obs.log` -- the structured sweep logger (quiet / info
  / debug) and the one-line-per-dispatch progress format.
* :mod:`~repro_torch.obs.report` -- renders a trace (+ optional results)
  into the ``python -m repro_torch.sweep report`` cost summary.
* :mod:`~repro_torch.obs.digest` -- compact digests of engine results, for
  comparing runs across machines.
"""
from .log import SweepLogger, dispatch_line
from .probes import ProbeSpec, QueueProbe, probe_shape
from .report import render_report
from .trace import (TIMING_KEYS, TRACE_SCHEMA, TraceWriter, load_trace,
                    strip_timing)

__all__ = [
    "SweepLogger", "dispatch_line",
    "ProbeSpec", "QueueProbe", "probe_shape",
    "render_report",
    "TIMING_KEYS", "TRACE_SCHEMA", "TraceWriter", "load_trace",
    "strip_timing",
]
