"""Carry the JAX reference's state objects across to the port.

:func:`from_reference` turns a ``repro`` ``FatTree``, ``LinkState``,
``Workload``, ``LBScheme``, ``ProbeSpec``, ``LoopConfig``, ``LinkEvent``,
``FaultSchedule``, ``Phase`` or ``PhaseSchedule`` into the port's
counterpart, reading public attributes only (numpy arrays are copied).  It
never imports ``repro``: objects are recognised by their class name, so
both packages can simulate the identical tree, workload, failure pattern,
scheme, engine configuration, fault schedule and phase schedule.

For the model zoo (every family), :func:`params_from_reference` carries a
``repro`` params pytree (numpy arrays) into the port's parameter module of
the config's family, :func:`cache_from_reference` a ``repro`` cache, and
:func:`numpy_reference_params` draws a reference-shaped tree from a numpy
seed by the family's init rule (the inputs both packages share when no JAX
is at hand).  :func:`train_state_from_reference` carries a ``repro`` train
state (``{"params", "opt", "step"}``, numpy) into the port's, and
:func:`train_state_to_reference` carries the port's back, as numpy with
stacked leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from .core.lb_schemes import LBScheme
from .faults import FaultSchedule, LinkEvent
from .net.topology import FatTree, LinkState
from .net.workloads import Workload
from .net.loopsim import LoopConfig
from .kernels._common import resolve_device
from .models import _params
from .models.registry import family_module
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


def _tensor(a, dtype: Optional[torch.dtype], device) -> torch.Tensor:
    """A numpy (or array-like) leaf as a tensor on ``device``, cast to
    ``dtype`` when given; ``ml_dtypes`` bfloat16 arrays are taken bit for
    bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        if not a.flags.writeable:     # e.g. np.asarray of a jax.Array
            a = a.copy()
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_reference(cfg, params,
                          device: Optional[Union[str, torch.device]] = None):
    """The port's parameters of a ``repro`` params tree (nested dicts of
    numpy arrays, as ``jax.tree_util.tree_map(np.asarray, params)`` gives),
    cast to each leaf's dtype, on ``device`` (``None``: CUDA).  The
    layer-stacked ``(nl, ...)`` leaves (``"dense"`` and ``"moe"`` of the
    transformer, ``"layers"`` of the SSM and hybrid families, ``"encoder"``
    and ``"decoder"`` of enc-dec) are split per layer."""
    dev = resolve_device(device)
    mod = family_module(cfg)
    out = mod.new_params(cfg, dev)
    with torch.no_grad():
        for key, (shape, dtype) in _params.leaves(mod.param_shapes(cfg)):
            src = params
            for k in key:
                src = src[k]
            if tuple(np.shape(src)) != shape:
                raise ValueError(f"{'/'.join(key)}: shape {np.shape(src)}, "
                                 f"expected {shape}")
            t = _tensor(src, dtype, dev)
            dst = _params.tensors(out, key, mod.STACKED)
            for l, d in enumerate(dst):
                d.copy_(t[l] if key[0] in mod.STACKED else t)
    return out


def cache_from_reference(cache, device: Optional[Union[str, torch.device]]
                         = None) -> dict:
    """The port's cache of a ``repro`` cache (a nested dict of numpy
    arrays, flat or sectioned): the same layout, as tensors on ``device``
    (``None``: CUDA)."""
    dev = resolve_device(device)
    if isinstance(cache, dict):
        return {k: cache_from_reference(v, dev) for k, v in cache.items()}
    return _tensor(cache, None, dev)


def numpy_reference_params(cfg, seed: int) -> dict:
    """A ``repro``-shaped params tree of float32 numpy arrays drawn by the
    family's init rule from numpy streams of ``seed``, a block of each leaf
    a stream (``_params.numpy_tree``): for the transformer and enc-dec
    families standard normals times ``shape[-2] ** -0.5`` for leaves of two
    or more axes and ones for 1-D leaves; for the SSM and hybrid families
    normals where the last axis exceeds 8, else 0.1, with ``A_log = 0`` and
    ``dt_bias = -2``."""
    mod = family_module(cfg)
    return _params.numpy_tree(mod.param_shapes(cfg), mod.init_rule, seed)


def train_state_from_reference(cfg, state,
                               device: Optional[Union[str, torch.device]]
                               = None) -> dict:
    """The port's train state (``repro_torch.train.train_step``) of a
    ``repro`` train state (nested dicts of numpy arrays: ``params``,
    ``opt`` -- ``mu``/``nu`` or ``acc`` -- and ``step``), on ``device``
    (``None``: CUDA).  The parameters take gradients; the optimizer leaves
    keep their stacked reference shapes (float32), the step counters are
    0-d int32 CPU tensors."""
    dev = resolve_device(device)
    params = params_from_reference(cfg, state["params"], dev)
    params.requires_grad_(True)

    def leaf(path, a):
        if path[-1] == "step":
            return torch.tensor(int(np.asarray(a)), dtype=torch.int32)
        return _tensor(a, None, dev)
    from .train import tree as T
    opt = T.unflatten([(p, leaf(p, a)) for p, a in T.items(state["opt"])])
    return {"params": params, "opt": opt,
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32)}


def train_state_to_reference(state) -> dict:
    """The reference's train state tree of the port's (as numpy; a stacked
    leaf stacked, bf16 as ``ml_dtypes`` bfloat16 when that package is at
    hand, else float32)."""
    from .train import tree as T

    def host(leaf):
        ts = [t.detach().cpu() for t in T.layers(leaf)]
        t = torch.stack(ts) if isinstance(leaf, (list, tuple)) else ts[0]
        if t.dtype == torch.bfloat16:
            try:
                import ml_dtypes
            except ImportError:
                return t.float().numpy()
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return T.map_leaves(host, state)
