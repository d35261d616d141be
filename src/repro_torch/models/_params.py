"""The reference's parameter trees and the port's parameter modules.

A family module describes its parameters as the reference's tree of
``(shape, dtype)`` leaves (``param_shapes``), in which the leaves of a
*stacked* section carry a leading ``n_layers`` axis.  The port holds a
stacked leaf as one tensor per layer module (``params.<section>[l].<leaf>``)
and any other leaf as an attribute (``params.<leaf>`` or
``params.<section>.<leaf>``).  These helpers walk the tree in the order
``jax.tree_util`` flattens it (sorted keys) and draw each leaf by a
family's init rule: ``rule(key, shape)`` gives ``("normal", scale)``
(standard normals times ``scale``, drawn in float32) or ``("fill", value)``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

Shape = Tuple[Tuple[int, ...], torch.dtype]
Rule = Callable[[Tuple[str, ...], Tuple[int, ...]], Tuple[str, float]]


def leaves(shapes: Dict) -> Tuple[Tuple[Tuple[str, ...], Shape], ...]:
    """``(path, (shape, dtype))`` of every leaf, in flatten order."""
    out = []
    for k, v in sorted(shapes.items()):
        if isinstance(v, dict):
            out.extend(((k, kk), vv) for kk, vv in sorted(v.items()))
        else:
            out.append(((k,), v))
    return tuple(out)


def tensors(params: torch.nn.Module, key: Tuple[str, ...],
            stacked: Tuple[str, ...]) -> List[torch.Tensor]:
    """The port's tensors of a reference leaf: one a layer for a stacked
    section's leaf, else the one tensor."""
    node = getattr(params, key[0])
    if key[0] in stacked:
        return [getattr(layer, key[1]) for layer in node]
    return [getattr(node, key[1]) if len(key) > 1 else node]


@torch.no_grad()
def draw_(params: torch.nn.Module, shapes: Dict, stacked: Tuple[str, ...],
          rule: Rule, generator: torch.Generator) -> torch.nn.Module:
    """Fill ``params`` in flatten order by ``rule``, a stacked leaf one
    layer at a time (its scale from the stacked shape), from
    ``generator``; returns ``params``."""
    for key, (shape, _) in leaves(shapes):
        kind, value = rule(key, shape)
        for t in tensors(params, key, stacked):
            if kind == "fill":
                t.fill_(value)
            else:
                # scaled in place: one float32 draw at a time on the card
                t.copy_(torch.randn(t.shape, generator=generator,
                                    device=t.device,
                                    dtype=torch.float32).mul_(value))
    return params


BLOCK = 1 << 22       # elements a stream of numpy_tree


def _draw_blocks(out: np.ndarray, seed: int, leaf: int,
                 scale: float) -> None:
    """Fill ``out`` with standard normals times ``scale``, its flat block
    ``c`` of BLOCK elements from ``np.random.default_rng([seed, leaf,
    c])``, the blocks drawn on threads (numpy releases the GIL while it
    fills)."""
    import concurrent.futures as cf
    import os
    flat = out.reshape(-1)

    def draw(c):
        block = flat[c * BLOCK:(c + 1) * BLOCK]
        np.random.default_rng([seed, leaf, c]).standard_normal(
            out=block, dtype=np.float32)
        block *= np.float32(scale)
    n = -(-flat.size // BLOCK)
    with cf.ThreadPoolExecutor(min(n, os.cpu_count() or 1) or 1) as pool:
        list(pool.map(draw, range(n)))


def numpy_tree(shapes: Dict, rule: Rule, seed: int) -> dict:
    """A reference-shaped tree of float32 numpy arrays drawn by ``rule``:
    the k-th leaf (in flatten order; a stacked leaf is one leaf) in blocks
    of BLOCK elements, each from its own stream ``default_rng([seed, k,
    block])``, drawn in parallel (billions of parameters in seconds)."""
    tree: dict = {}
    for i, (key, (shape, _)) in enumerate(leaves(shapes)):
        kind, value = rule(key, shape)
        if kind == "fill":
            w = np.full(shape, value, np.float32)
        else:
            w = np.empty(shape, np.float32)
            _draw_blocks(w, seed, i, value)
        node = tree
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1]] = w
    return tree


def tree(params: torch.nn.Module, shapes: Dict,
         stacked: Tuple[str, ...]) -> dict:
    """The reference's tree of ``params``: nested dicts of its keys, each
    leaf the port's tensor, or for a stacked section's leaf the list of
    its layers' tensors (:func:`tensors`)."""
    out: dict = {}
    for key, _ in leaves(shapes):
        ts = tensors(params, key, stacked)
        node = out
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1]] = ts if key[0] in stacked else ts[0]
    return out


class Params(torch.nn.Module):
    """Base of a family's parameter module: :meth:`tree` gives it as the
    reference's tree (checkpoints and optimizer state follow that tree)."""

    def __init__(self, shapes: Dict, stacked: Tuple[str, ...]):
        super().__init__()
        self._ref = (shapes, stacked)

    def tree(self) -> dict:
        return tree(self, *self._ref)


def param(shape, dtype, device) -> torch.nn.Parameter:
    """An uninitialised parameter that takes no gradient until a trainer
    turns it on (``requires_grad_``)."""
    return torch.nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                              requires_grad=False)
