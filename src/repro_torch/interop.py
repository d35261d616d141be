"""Carry the JAX reference's state objects across to the port.

:func:`from_reference` turns a ``repro`` ``FatTree``, ``LinkState``,
``Workload``, ``LBScheme``, ``ProbeSpec``, ``LoopConfig``, ``LinkEvent``,
``FaultSchedule``, ``Phase`` or ``PhaseSchedule`` into the port's
counterpart, reading public attributes only (numpy arrays are copied).  It
never imports ``repro``: objects are recognised by their class name, so
both packages can simulate the identical tree, workload, failure pattern,
scheme, engine configuration, fault schedule and phase schedule.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .core.lb_schemes import LBScheme
from .faults import FaultSchedule, LinkEvent
from .net.topology import FatTree, LinkState
from .net.workloads import Workload
from .net.loopsim import LoopConfig
from .obs.probes import ProbeSpec
from .phases import Phase, PhaseSchedule


def _fields(cls, obj) -> dict:
    out = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        out[f.name] = np.array(v) if isinstance(v, np.ndarray) else v
    return out


def from_reference(obj):
    """The port's counterpart of a reference object (see module doc);
    ``None`` and plain scalars pass through."""
    if obj is None or isinstance(obj, (int, float, str, np.generic)):
        return obj
    name = type(obj).__name__
    if name == "FatTree":
        return FatTree(int(obj.k))
    if name == "LinkState":
        return LinkState(from_reference(obj.tree), np.array(obj.ea, bool),
                         np.array(obj.ac, bool))
    if name == "Workload":
        return Workload(**_fields(Workload, obj))
    if name == "LBScheme":
        kw = _fields(LBScheme, obj)
        kw["quanta"] = tuple(kw["quanta"])
        return LBScheme(**kw)
    if name == "ProbeSpec":
        return ProbeSpec(int(obj.stride), int(obj.samples))
    if name == "LoopConfig":
        # The reference's body implementations ('lax', 'pallas', 'auto')
        # agree bitwise; the port has one body, whose kernels dispatch on
        # the device ('auto').
        kw = _fields(LoopConfig, obj)
        if kw["impl"] not in ("lax", "pallas", "auto"):
            raise ValueError(f"unknown LoopConfig.impl {kw['impl']!r}")
        kw["impl"] = "auto"
        return LoopConfig(**kw)
    if name == "LinkEvent":
        return LinkEvent(**_fields(LinkEvent, obj))
    if name == "FaultSchedule":
        kw = _fields(FaultSchedule, obj)
        kw["events"] = tuple(from_reference(e) for e in kw["events"])
        return FaultSchedule(**kw)
    if name == "Phase":
        return Phase(**_fields(Phase, obj))
    if name == "PhaseSchedule":
        kw = _fields(PhaseSchedule, obj)
        kw["phases"] = tuple(from_reference(p) for p in kw["phases"])
        return PhaseSchedule(**kw)
    raise TypeError(f"from_reference: unsupported object {name}")
