"""AdamW and Adafactor with the reference's arithmetic
(``repro.train.optimizer``).

API: ``opt = make(name, lr=...); state = opt.init(params); state =
opt.update(grads, state, params)``.  ``params`` and ``grads`` are trees of
the reference's structure (:mod:`.tree`: a stacked leaf is the list of its
layers' tensors); ``update`` writes the new parameters into ``params`` in
place and returns the new state.  The state is the reference's tree, each
leaf of the reference's (stacked) shape: ``{"mu", "nu", "step"}`` (AdamW)
or ``{"acc": {leaf: {"vr", "vc"} | {"v"}}, "step"}`` (Adafactor), float32
moments on the parameters' device and ``step`` a 0-d int32 CPU tensor.

As in the reference, and unlike ``torch.optim.AdamW``: every update is
computed in float32 and cast to the parameter's dtype once, weight decay is
added to the update (``u + wd * p``), and the learning rate warms up as
``lr * min(1, step / warmup_steps)``.  The step's scalars (schedule, bias
corrections, Adafactor's ``beta``) are float32, computed on the host.
Adafactor factors a leaf by its reference (stacked) shape and clips its
update by the RMS over the whole stacked leaf, every layer at once: the
port stacks a stacked leaf's layers for it.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from . import tree as T

f32 = np.float32


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> new_state; params in place


def _zeros(leaf, shape):
    dev = T.layers(leaf)[0].device if torch.is_tensor(T.layers(leaf)[0]) \
        else "cpu"
    return torch.zeros(shape, dtype=torch.float32, device=dev)


def _step_tensor(step: int) -> torch.Tensor:
    return torch.tensor(step, dtype=torch.int32)


def _sched(lr: float, step: int, warmup_steps: int) -> float:
    """``lr * min(1, step / warmup_steps)`` in float32."""
    return float(f32(lr) * np.minimum(f32(1.0), f32(step) / f32(warmup_steps)))


def adamw(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          warmup_steps: int = 100) -> Optimizer:
    c_b1, c_1b1 = float(f32(b1)), float(f32(1 - b1))
    c_b2, c_1b2 = float(f32(b2)), float(f32(1 - b2))
    c_eps, c_wd = float(f32(eps)), float(f32(weight_decay))

    def init(params):
        def zeros(leaf):
            return _zeros(leaf, T.shape(leaf))
        return {"mu": T.map_leaves(zeros, params),
                "nu": T.map_leaves(zeros, params),
                "step": _step_tensor(0)}

    @torch.no_grad()
    def update(grads, state, params):
        step = int(state["step"]) + 1
        sched = _sched(lr, step, warmup_steps)
        bc1 = float(f32(1) - np.power(f32(b1), f32(step)))
        bc2 = float(f32(1) - np.power(f32(b2), f32(step)))
        for path, leaf in T.items(params):
            stacked = isinstance(leaf, (list, tuple))
            mu, nu = T.get(state["mu"], path), T.get(state["nu"], path)
            gs = T.layers(T.get(grads, path))
            for l, p in enumerate(T.layers(leaf)):
                m, v = (mu[l], nu[l]) if stacked else (mu, nu)
                # in place, each operation rounded as the reference's
                g = gs[l].float()
                m.mul_(c_b1).add_(g * c_1b1)
                v.mul_(c_b2).add_((g * g).mul_(c_1b2))
                del g
                u = (m / bc1).div_(torch.sqrt(v / bc2).add_(c_eps))
                p32 = p.float()
                u.add_(p32 * c_wd)
                p.copy_(p32.sub_(u.mul_(sched)))
                del u, p32
        return {"mu": state["mu"], "nu": state["nu"],
                "step": _step_tensor(step)}

    return Optimizer(init, update)


def adafactor(lr: float = 1e-2, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, warmup_steps: int = 100,
              min_dim_size_to_factor: int = 128) -> Optimizer:
    """Factored Adafactor (Shazeer & Stern).  Factors the trailing two dims
    of >=2D leaves (by the reference's stacked shape) when both reach
    ``min_dim_size_to_factor``."""
    c_eps = float(f32(eps))
    c_clip = float(f32(clip_threshold))

    def _factored(shape):
        return (len(shape) >= 2 and shape[-1] >= min_dim_size_to_factor
                and shape[-2] >= min_dim_size_to_factor)

    def init(params):
        def per(leaf):
            shape = T.shape(leaf)
            if _factored(shape):
                return {"vr": _zeros(leaf, shape[:-1]),
                        "vc": _zeros(leaf, shape[:-2] + shape[-1:])}
            return {"v": _zeros(leaf, shape)}
        return {"acc": T.map_leaves(per, params), "step": _step_tensor(0)}

    @torch.no_grad()
    def update(grads, state, params):
        step = int(state["step"]) + 1
        beta = f32(1.0) - np.power(f32(step) + f32(1.0), f32(-decay))
        c_beta, c_1beta = float(beta), float(f32(1.0) - beta)
        sched = _sched(lr, step, warmup_steps)
        for path, leaf in T.items(params):
            stacked = isinstance(leaf, (list, tuple))
            acc = T.get(state["acc"], path)
            ps = T.layers(leaf)
            gs = [g.float() for g in T.layers(T.get(grads, path))]
            g = torch.stack(gs) if stacked else gs[0]
            del gs
            g2 = g * g + c_eps
            if "vr" in acc:
                vr = acc["vr"] * c_beta + g2.mean(dim=-1) * c_1beta
                vc = acc["vc"] * c_beta + g2.mean(dim=-2) * c_1beta
                rfac = torch.rsqrt(
                    vr / torch.clamp(vr.mean(dim=-1, keepdim=True),
                                     min=c_eps) + c_eps)
                cfac = torch.rsqrt(vc + c_eps)
                u = g * rfac[..., None] * cfac[..., None, :]
                acc["vr"].copy_(vr)
                acc["vc"].copy_(vc)
            else:
                v = acc["v"] * c_beta + g2 * c_1beta
                u = g * torch.rsqrt(v + c_eps)
                acc["v"].copy_(v)
            del g, g2
            # update clipping by the RMS over the whole (stacked) leaf
            rms = torch.sqrt(torch.mean(u * u) + float(f32(1e-30)))
            u = u / torch.clamp(rms / c_clip, min=1.0)
            for l, p in enumerate(ps):
                ul = u[l] if stacked else u
                p.copy_((p.float() - ul * sched).to(p.dtype))
        return {"acc": state["acc"], "step": _step_tensor(step)}

    return Optimizer(init, update)


def make(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise ValueError(name)
