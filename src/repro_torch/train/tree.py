"""The reference's trees as the port holds them.

A tree is nested dicts with string keys; a leaf is a tensor, a numpy array,
a number, or -- for a leaf the reference stacks on a leading layer axis --
the list of its layers' tensors.  A parameter module
(``models._params.Params``) stands for its tree (``tree()``).  The
reference's flatten order is kept: dict keys sorted, as ``jax.tree_util``
flattens a dict, and a stacked leaf is one leaf.
"""
from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


def expand(node: Any) -> Any:
    """A parameter module's tree, anything else as it is."""
    tree = getattr(node, "tree", None)
    return tree() if isinstance(node, torch.nn.Module) and tree else node


def items(tree: Any, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """``(path, leaf)`` of every leaf in flatten order."""
    tree = expand(tree)
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(items(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def get(tree: Any, path: Path) -> Any:
    for k in path:
        tree = expand(tree)[k]
    return tree


def layers(leaf: Any) -> List[torch.Tensor]:
    """A leaf's tensors: a stacked leaf's layers, else the one tensor."""
    return list(leaf) if isinstance(leaf, (list, tuple)) else [leaf]


def shape(leaf: Any) -> Tuple[int, ...]:
    """The reference's shape of a leaf (a stacked leaf's layer axis
    first)."""
    if isinstance(leaf, (list, tuple)):
        return (len(leaf),) + tuple(leaf[0].shape)
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    return tuple(np.shape(leaf))


def unflatten(pairs: List[Tuple[Path, Any]]) -> dict:
    """The nested dicts of ``(path, leaf)`` pairs."""
    out: dict = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def map_leaves(fn, tree: Any) -> dict:
    """``fn(leaf)`` over every leaf, in the tree's structure."""
    return unflatten([(p, fn(leaf)) for p, leaf in items(tree)])
