"""In-simulation queue-occupancy probes.

A :class:`ProbeSpec` asks the engines to carry a downsampled per-layer
queue-occupancy time series out of the batched pipelines: ``samples`` time
windows of ``stride`` slots each, recording the *maximum* queue length
observed in every window.  Both dimensions are static (baked into the
compiled shape) so an entire campaign still fuses into one dispatch per
pipeline shape -- the series rides the fused batch axis like any other
output.  Time past ``stride * samples`` clamps into the last window, so a
slot budget larger than the probe horizon saturates the tail bucket rather
than recompiling.

Recording window *maxima* (not instantaneous samples) gives the invariant
the tests pin down: the max over a point's probe series equals the engine's
existing scalar ``max_queue`` exactly -- per layer on the fast engine, over
all layers on the loop engine -- because both reduce the identical values.

With ``probes=None`` (the default everywhere) no probe code is generated
and engine outputs are bitwise-identical to pre-probe behavior.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ProbeSpec:
    """Opt-in queue-occupancy time series: ``samples`` windows of ``stride``
    slots, each recording the window's maximum occupancy."""
    stride: int
    samples: int = 256

    def __post_init__(self):
        if int(self.stride) < 1:
            raise ValueError(f"probe stride must be >= 1, got {self.stride}")
        if int(self.samples) < 1:
            raise ValueError(f"probe samples must be >= 1, "
                             f"got {self.samples}")

    @property
    def horizon_slots(self) -> int:
        """Slots covered before the series clamps into its last window."""
        return int(self.stride) * int(self.samples)


def probe_shape(probes) -> Tuple[int, int]:
    """Normalize a ProbeSpec / (stride, samples) tuple / None into the
    static ``(stride, samples)`` pair the compiled pipelines key on.
    ``(0, 0)`` means probes are off (no probe code is generated)."""
    if probes is None:
        return (0, 0)
    if isinstance(probes, tuple):
        stride, samples = probes
    else:
        stride, samples = probes.stride, probes.samples
    if int(samples) == 0:
        return (0, 0)
    return (int(stride), int(samples))


@dataclasses.dataclass
class QueueProbe:
    """One point's probe output: ``series[layer, window]`` is the maximum
    queue occupancy layer ``layer`` (``net.topology.LAYER_NAMES`` order) saw
    during window ``window`` (``stride`` slots wide; empty windows are 0)."""
    stride: int
    series: np.ndarray                   # (N_LAYERS, samples)

    def layer_max(self) -> np.ndarray:
        """Per-layer maximum over the series (equals the engine's per-layer
        ``max_queue`` scalars on the fast engine)."""
        return np.asarray(self.series).max(axis=1)

    def overall_max(self) -> float:
        """Max over layers and time (equals the engine's ``max_queue``)."""
        return float(np.asarray(self.series).max())
