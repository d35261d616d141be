"""The training step on one card: microbatched gradient accumulation, the
global-norm clip and the optimizer (``repro.train.train_step``'s port).

The train state is ``{"params": <the model's parameter module>, "opt":
<the optimizer's state>, "step": 0-d int32 CPU tensor}``, which maps one
to one onto the reference's ``{"params", "opt", "step"}`` tree
(:mod:`.tree`; the parameters through their module's ``tree()``).  A step
accumulates each microbatch's gradients in float32 (``torch.autograd.grad``
of ``Model.loss``), divides by the microbatch count, clips them to the
global norm (summed leaf by leaf in the reference's flatten order), and
only then updates the parameters and the optimizer state in place: a step
that raises before the update leaves the state as it was, so
``ResilientLoop`` retries it on the same state.  With one microbatch the
gradients keep the parameters' dtype until ``g * scale`` promotes them, as
in JAX.

Waiting for the multi-card slice (``ROADMAP.md`` A5): ``compress_dcn``
(raises), ``shardings_for_state`` and ``batch_shardings``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.registry import Model
from . import optimizer as opt_mod
from . import tree as T


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    microbatch: int = 0               # 0: use cfg.microbatch (or 1)
    grad_clip: float = 1.0
    compress_dcn: Optional[str] = None   # None | 'bf16' | 'int8'
    seed: int = 0


def _optimizer(model: Model, tcfg: TrainConfig) -> opt_mod.Optimizer:
    return opt_mod.make(model.cfg.optimizer, lr=tcfg.learning_rate,
                        warmup_steps=tcfg.warmup_steps)


def make_train_state(model: Model, params, tcfg: TrainConfig) -> dict:
    """The train state of ``params`` (a parameter module of ``model``,
    whose gradients this turns on)."""
    params.requires_grad_(True)
    return {"params": params,
            "opt": _optimizer(model, tcfg).init(params.tree()),
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares, a float32 sum per reference leaf (a
    stacked leaf's layers summed in order) added leaf by leaf in flatten
    order."""
    total = None
    for _, leaf in T.items(grads):
        s = None
        for g in T.layers(leaf):
            part = torch.sum(torch.square(g.float()))
            s = part if s is None else s + part
        total = s if total is None else total + s
    return torch.sqrt(total)


def microbatches(batch: dict, n_micro: int):
    """The batch cut along its leading axis into ``n_micro`` equal
    microbatches."""
    gb = next(iter(batch.values())).shape[0]
    if gb % n_micro:
        raise ValueError(f"global batch {gb} is not a multiple of "
                         f"{n_micro} microbatches")
    return [{k: v.reshape((n_micro, gb // n_micro) + tuple(v.shape[1:]))[i]
             for k, v in batch.items()} for i in range(n_micro)]


def micro_count(model: Model, tcfg: TrainConfig) -> int:
    return tcfg.microbatch or model.cfg.microbatch or 1


def loss_and_grads(model: Model, params, batch: dict, n_micro: int):
    """(mean loss, gradients as the reference's tree): each microbatch's
    gradients summed in float32 and divided by ``n_micro``; with one
    microbatch the gradients in the parameters' dtype."""
    ptree = params.tree()
    tensors = [t for _, leaf in T.items(ptree) for t in T.layers(leaf)]
    if n_micro > 1:
        flat = [torch.zeros_like(t, dtype=torch.float32) for t in tensors]
        lsum = None
        for mb in microbatches(batch, n_micro):
            loss = model.loss(params, mb)
            grads = torch.autograd.grad(loss, tensors)
            for acc, g in zip(flat, grads):
                acc.add_(g.float())
            del grads
            loss = loss.detach()
            lsum = loss if lsum is None else lsum + loss
        for g in flat:
            g.div_(n_micro)
        loss = lsum / n_micro
    else:
        loss = model.loss(params, batch)
        flat = list(torch.autograd.grad(loss, tensors))
        loss = loss.detach()
    it = iter(flat)
    pairs = []
    for path, leaf in T.items(ptree):
        gs = [next(it) for _ in T.layers(leaf)]
        pairs.append((path, gs if isinstance(leaf, list) else gs[0]))
    return loss, T.unflatten(pairs)


def build_train_step(model: Model, tcfg: TrainConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``, metrics
    ``{"loss", "grad_norm"}`` (0-d float32 tensors on the parameters'
    device).

    ``batch["tokens"]`` is (GB, S); with microbatching the leading dim is
    cut into (n_micro, GB / n_micro, S) and the microbatches run in order.
    """
    if tcfg.compress_dcn is not None:
        raise NotImplementedError(
            "compress_dcn: gradient compression across pods needs "
            "collectives/compression.py, which is not ported yet "
            "(ROADMAP.md A5)")
    opt = _optimizer(model, tcfg)
    n_micro = micro_count(model, tcfg)

    def train_step(state, batch):
        params = state["params"]
        loss, grads = loss_and_grads(model, params, batch, n_micro)
        gnorm = global_norm(grads)
        scale = torch.clamp(tcfg.grad_clip / torch.clamp(gnorm, min=1e-6),
                            max=1.0)

        def scaled(g):   # float32 gradients are this step's own: in place
            return g.mul_(scale) if g.dtype == torch.float32 \
                else g.float() * scale
        grads = T.map_leaves(
            lambda leaf: ([scaled(g) for g in leaf]
                          if isinstance(leaf, list) else scaled(leaf)), grads)
        new_opt = opt.update(grads, state["opt"], params.tree())
        new_state = {"params": params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
