"""Shared batching helpers for the fabric engines.

Per-point operands are padded host-side to shared shapes, stacked onto one
fused batch axis, and dispatched through one batched pipeline.  The
shape-bucketing and padding primitives (numpy) are copied from the JAX
reference so both packages pad identically:

  * :func:`pow2_bucket` -- the power-of-two shape bucket;
  * :func:`k_buckets` -- group tree sizes so each pads to its bucket head;
  * :class:`TreePad` -- scatter index maps from a real fat tree's id spaces
    into a padded tree's;
  * :func:`pad_tail` / :func:`pad_to_group_max` -- constant-fill padding;
  * :func:`shard_pad` -- round a stacked batch up to a multiple of the
    shard count by replicating the tail element (results are dropped).

Two helpers are torch:

  * :func:`rank_by` -- rank of each element among same-key valid elements;
  * :func:`port_pad_penalty` -- the JSQ guard added to port-choice scores so
    tree-size padding can never elect a port beyond a point's logical
    ``k/2``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


def pow2_bucket(n: int) -> int:
    """Next power of two >= ``n`` (and >= 1): sizes landing in one bucket
    share a compiled pipeline shape.  ``n <= 0`` clamps to 1 -- degenerate
    empty workloads and zero slot budgets land in the smallest bucket
    (``(-1).bit_length() == 1``, so the unclamped formula returned 2 for
    ``n == 0``, violating the >= 1 / next-pow2 contract)."""
    return 1 << max(0, int(max(n, 1) - 1).bit_length())


def k_buckets(trees: Sequence[int]) -> Dict[int, int]:
    """Group fat-tree sizes into padding buckets: ``{k: k_pad}``.

    Greedy from the largest tree down: a tree joins the current bucket when
    padding it to the bucket head costs at most 2x in ``k``, otherwise it
    opens its own bucket.  For workloads whose packet count is linear in
    the host count (permutation, fsdp_rings) that bounds the padding waste
    at 8x packet rows -- k^3/4 hosts; all_to_all is quadratic in hosts, so
    its waste can reach ~64x at a full 2x pad (the cost-model-driven bucket
    policy in ROADMAP.md is the standing fix).  Every ``k`` of one bucket
    pads its topology operands to the bucket head and shares ONE compiled
    pipeline, so a campaign's dispatch count no longer scales with the
    number of tree sizes.  Buckets are campaign-relative (computed over
    the grid's ``trees`` axis): a single-size campaign never pads.
    """
    out: Dict[int, int] = {}
    head = 0
    for k in sorted(set(int(k) for k in trees), reverse=True):
        if head == 0 or head > 2 * k:
            head = k
        out[k] = head
    return out


class TreePad:
    """Index maps from a real fat tree's id spaces into a padded tree's.

    Both engines identify switches, DR/OFAN pointers and queues by dense
    ids derived from ``(pod, edge/agg, port)`` coordinates with modulus
    ``k``/``k/2``; running a small tree inside a larger compiled pipeline
    therefore needs every id-indexed operand scattered to the padded
    layout (real coordinates are unchanged -- they are simply sparse in the
    padded id space).  The maps below give, for each real id in order, its
    position in the padded space; scattering with them is monotone, so
    relative id order (and hence every sort-based arbitration) is
    preserved.  ``tree`` and ``padded`` are ``topology.FatTree``-likes
    (only ``k``/``half``/counts are used).
    """

    def __init__(self, tree, padded):
        if padded.k < tree.k:
            raise ValueError(f"cannot pad k={tree.k} down to k={padded.k}")
        self.tree, self.padded = tree, padded
        kr, hr = tree.k, tree.half
        hp = padded.half
        # Real switch id p*hr + e  ->  padded id p*hp + e  (edge and agg
        # layers share the (pod, index<k/2) coordinate scheme).
        self.switch = (np.arange(kr)[:, None] * hp
                       + np.arange(hr)[None, :]).reshape(-1)
        # Mid-layer queue id (x*hr + y)*hr + z -> (x*hp + y)*hp + z; the same
        # map serves UP_E/UP_A/DN_C/DN_A (all are k * (k/2)^2 spaces).
        self.mid = ((np.arange(kr)[:, None, None] * hp
                     + np.arange(hr)[None, :, None]) * hp
                    + np.arange(hr)[None, None, :]).reshape(-1)
        # OFAN edge pointer id  se*n_edges + de  (se-major, de-minor).
        ne_p = padded.n_edge_switches
        self.edge_pair = (self.switch[:, None] * ne_p
                          + self.switch[None, :]).reshape(-1)
        # OFAN/W-ECMP agg pointer id  ga*n_pods + dst_pod.
        self.agg_pod = (self.switch[:, None] * padded.n_pods
                        + np.arange(kr)[None, :]).reshape(-1)

    @property
    def noop(self) -> bool:
        return self.padded.k == self.tree.k

    def scatter(self, x: np.ndarray, idx: np.ndarray, size: int,
                axis: int = 0, fill=0) -> np.ndarray:
        """Place ``x``'s entries along ``axis`` at positions ``idx`` of a
        ``fill``-initialized axis of length ``size``."""
        shape = list(x.shape)
        shape[axis] = size
        out = np.full(shape, fill, dtype=x.dtype)
        sl = [slice(None)] * x.ndim
        sl[axis] = idx
        out[tuple(sl)] = x
        return out


def pad_tail(x: np.ndarray, axis: int, target: int, fill=0) -> np.ndarray:
    """Pad ``x`` along ``axis`` up to ``target`` with constant ``fill``."""
    if x.shape[axis] >= target:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - x.shape[axis])
    return np.pad(x, widths, constant_values=fill)


def pad_to_group_max(arrays: Sequence[np.ndarray], fill=0) -> List[np.ndarray]:
    """Pad every array of a same-rank group to the element-wise max shape."""
    ndim = arrays[0].ndim
    shape = tuple(max(a.shape[ax] for a in arrays) for ax in range(ndim))
    out = []
    for a in arrays:
        for ax, tgt in enumerate(shape):
            a = pad_tail(a, ax, tgt, fill)
        out.append(a)
    return out


def shard_pad(stacked: Dict[str, np.ndarray], n_batch: int,
              n_shards: int) -> Dict[str, np.ndarray]:
    """Round the stacked batch up to a multiple of ``n_shards`` by
    replicating the last element (padding results are dropped by the
    caller's span bookkeeping).  ``stacked`` maps names to arrays whose
    leading axis is the batch, or to tuples of such arrays."""
    b_pad = -(-n_batch // n_shards) * n_shards
    if b_pad == n_batch:
        return stacked

    def _pad(x):
        if isinstance(x, tuple):
            return tuple(_pad(y) for y in x)
        return np.concatenate([x, np.repeat(x[-1:], b_pad - n_batch, axis=0)])

    return {k: _pad(v) for k, v in stacked.items()}


def port_pad_penalty(h: int, h_log: torch.Tensor) -> torch.Tensor:
    """``(..., h)`` float32 additive JSQ score penalty masking padded port
    columns, for ``h_log`` of shape ``(...)``.

    Ports at indices >= ``h_log`` (the point's logical ``k/2``, a per-row
    operand) exist only because the pipeline runs a larger padded tree; a
    huge penalty keeps ``argmin`` off them.  Real ports get ``0.0``, which
    is bitwise-neutral on the non-negative queue scores -- an unpadded
    point (``h_log == h``) is untouched.
    """
    ports = torch.arange(h, device=h_log.device)
    return torch.where(ports >= h_log[..., None],
                       torch.tensor(1e9, dtype=torch.float32,
                                    device=h_log.device),
                       torch.tensor(0.0, dtype=torch.float32,
                                    device=h_log.device))


def rank_by(keys: torch.Tensor, valid: torch.Tensor,
            backend: str = "auto") -> torch.Tensor:
    """Rank of each element among same-key valid elements (sort-based),
    along the last axis; invalid elements get 0.

    The segment starts come from ``kernels.lindley.ops.segmented_cummax``:
    on a CUDA tensor that is the CUDA kernel, one launch over all rows (each
    row starts with a flag); ``backend="torch"`` takes the plain version on
    any device."""
    from ..kernels.lindley import ops as lindley_ops
    m = keys.shape[-1]
    if m == 0:
        return torch.zeros_like(keys, dtype=torch.int32)
    k = torch.where(valid, keys, torch.full_like(keys, 2**30))
    order = torch.argsort(k, dim=-1, stable=True)
    ks = torch.gather(k, -1, order)
    idx = torch.arange(m, dtype=torch.float32,
                       device=keys.device).expand(ks.shape)
    flag = torch.cat([torch.ones_like(ks[..., :1], dtype=torch.bool),
                      ks[..., 1:] != ks[..., :-1]], dim=-1)
    start = lindley_ops.segmented_cummax(
        torch.where(flag, idx, torch.full_like(idx, -1.0)), flag, backend)
    rank_sorted = (idx - start).to(torch.int32)
    inv = torch.empty_like(order).scatter_(
        -1, order, torch.arange(m, device=keys.device).expand(order.shape))
    return torch.where(valid, torch.gather(rank_sorted, -1, inv),
                       torch.zeros_like(rank_sorted))
