"""Mixture-of-Experts layer on one card, in PyTorch.

Copied from ``repro.models.moe``'s single-device path.  Without a mesh the
reference always takes its dense oracle (``impl == "dense" or mesh is
None``): every expert runs on every token, the top-k gates weigh the
experts' outputs, and the weighted sum is taken in float32 and cast back to
x's dtype.  This is the function one card computes, so the port runs it for
every ``moe_impl`` and ignores ``capacity_factor``, as the reference does
without a mesh.  The capacity dispatch and the expert-parallel AllToAll of
the reference's ``shard_map`` path belong to the multi-card work.

The expert products are batched matrix products over the expert axis
(``(E, T, D) @ (E, D, F)``), the reference's ``td,edf->tef`` and
``tef,efd->ted`` einsums with the expert axis leading; the reference
computes them outside any Pallas kernel.  Routing follows ``_route``:
float32 router logits, a softmax, the top k (ties toward the lower expert
index, as ``jax.lax.top_k`` breaks them: a stable descending sort, since
``torch.topk`` promises no order among ties), renormalised by
``max(sum, 1e-9)``.  The router leaf is float32 whatever the config's
dtype.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import _params as P
from . import layers as L


def layer_shapes(cfg) -> Dict[str, P.Shape]:
    """One MoE layer's expert leaves ``(shape, dtype)`` (no layer axis):
    ``router`` (D, E) float32, ``w_gate``/``w_up`` (E, D, F), ``w_down``
    (E, F, D), and the shared expert's ``ws_*`` when the config has one."""
    d = L.dtype_of(cfg)
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {"router": ((D, E), torch.float32),
         "w_gate": ((E, D, Fe), d), "w_up": ((E, D, Fe), d),
         "w_down": ((E, Fe, D), d)}
    if cfg.n_shared_experts:
        Fs = Fe * cfg.n_shared_experts
        p.update({"ws_gate": ((D, Fs), d), "ws_up": ((D, Fs), d),
                  "ws_down": ((Fs, D), d)})
    return p


def route(x2d: torch.Tensor, router: torch.Tensor,
          k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2d (T, D) -> (gates (T, k) float32, experts (T, k) int64): the top
    k router probabilities, the lower expert index first among equals."""
    probs = torch.softmax(x2d.float() @ router, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :k], idx[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, idx


def moe_block(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D): the routed experts (the dense oracle) plus
    the shared expert when the config has one."""
    B, S, D = x.shape
    E = cfg.n_experts
    x2d = x.reshape(-1, D)
    T = x2d.shape[0]
    gates, idx = route(x2d, p.router, cfg.experts_per_tok)
    xe = x2d.expand(E, T, D)
    g = torch.bmm(xe, p.w_gate)                          # (E, T, F)
    u = torch.bmm(xe, p.w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    del g, u
    y_all = torch.bmm(h, p.w_down)                       # (E, T, D)
    del h
    # The one-hot gate weights (T, E): each token's k experts are distinct,
    # so the reference's tke,tk->te sum is each gate in its expert's column.
    w = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    w.scatter_(1, idx, gates)
    y = torch.einsum("te,etd->td", w, y_all.float()).to(x.dtype)
    y = y.reshape(B, S, D)
    if cfg.n_shared_experts:
        y = y + L.swiglu(x, p.ws_gate, p.ws_up, p.ws_down)
    return y
