"""Zamba2-style hybrid: a Mamba2 backbone with a *shared* transformer block
(attention + MLP, single parameter copy) applied every ``shared_attn_every``
layers, in PyTorch.

Copied from ``repro.models.hybrid``.  The parameters live in a
:class:`Hybrid` module: ``layers``, one :class:`~.mamba2.MambaLayer` a
layer, and ``shared``, one :class:`SharedBlock`.  The shared block's
parameters are reused at every application, but each application needs its
own KV cache (activations differ), so the cache keeps the reference's
layout: ``{"mamba": {"conv": (napp, k, B, K-1, Cv), "ssm": (napp, k, B, H,
N, P)}, "shared": {"k": (napp, B, S_max, Hkv, hd), "v": ...}}``, with the
batch on axis 2 of the Mamba leaves and axis 1 of the KV leaves.  Each
layer writes its slices IN PLACE.  The shared block's prefill attention is
the flash-attention kernel on the card (head dim 80 for Zamba2-2.7B).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn

from . import _params as P
from . import layers as L
from . import mamba2 as m2

STACKED = m2.STACKED
init_rule = m2.init_rule        # the reference's hybrid init is Mamba2's


def _n_apps(cfg) -> int:
    """Applications of the shared block: one after each group of
    ``shared_attn_every`` Mamba layers (the reference reshapes the layers
    into such groups, so they must divide evenly)."""
    if cfg.shared_attn_every <= 0 or cfg.n_layers % cfg.shared_attn_every:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not form "
                         f"groups of shared_attn_every="
                         f"{cfg.shared_attn_every}")
    return cfg.n_layers // cfg.shared_attn_every


def _shared_shapes(cfg) -> Dict[str, P.Shape]:
    d = L.dtype_of(cfg)
    D, H, Hkv, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    return {"ln1": ((D,), d), "ln2": ((D,), d),
            "wq": ((D, H * hd), d), "wk": ((D, Hkv * hd), d),
            "wv": ((D, Hkv * hd), d), "wo": ((H * hd, D), d),
            "w_gate": ((D, F), d), "w_up": ((D, F), d),
            "w_down": ((F, D), d)}


def param_shapes(cfg) -> Dict:
    p = m2.param_shapes(cfg)
    p["shared"] = _shared_shapes(cfg)
    return p


class SharedBlock(nn.Module):
    """The shared transformer block: ``ln1``, ``ln2``, ``wq``, ``wk``,
    ``wv``, ``wo``, ``w_gate``, ``w_up``, ``w_down``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        for name, (shape, dt) in _shared_shapes(cfg).items():
            setattr(self, name, P.param(shape, dt, device))


class Hybrid(P.Params):
    """The model's parameters: ``embed``, ``final_norm``, ``lm_head``
    (unless tied), ``layers`` (a list of :class:`~.mamba2.MambaLayer`) and
    ``shared`` (:class:`SharedBlock`).  Created uninitialised."""

    def __init__(self, cfg, device=None):
        super().__init__(param_shapes(cfg), STACKED)
        m2.add_embed_params(self, cfg, device)
        self.layers = nn.ModuleList(m2.MambaLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.shared = SharedBlock(cfg, device)


def new_params(cfg, device=None) -> Hybrid:
    return Hybrid(cfg, device)


def init_params(cfg, generator: torch.Generator, device) -> Hybrid:
    """Random parameters drawn by Mamba2's rule (``ln1``/``ln2`` are 0.1)
    in flatten order; the numbers differ from ``jax.random``'s."""
    return P.draw_(Hybrid(cfg, device), param_shapes(cfg), STACKED,
                   init_rule, generator)


def _shared_block(cfg, p: SharedBlock, x, positions, cache, cache_index,
                  mode, backend):
    h = L.rms_norm(x, p.ln1, cfg.norm_eps)
    attn, _ = L.gqa_attention(h, p, cfg, positions, cache, cache_index, mode,
                              backend)
    x = x + attn
    h = L.rms_norm(x, p.ln2, cfg.norm_eps)
    return x + L.swiglu(h, p.w_gate, p.w_up, p.w_down)


def forward(cfg, params: Hybrid, tokens: torch.Tensor, *,
            mode: str = "train", cache: Optional[dict] = None,
            cache_index: int = 0, backend: str = "auto"):
    """tokens (B, S) -> float32 logits (B, S, vocab), or (logits, cache)
    when a cache is given (written in place and returned).  In training
    each Mamba layer and each application of the shared block is
    rematerialised as ``cfg.remat`` says."""
    x = L.embed(tokens, params.embed)
    S = x.shape[1]
    positions = cache_index + torch.arange(S, device=x.device)[None, :]
    k = cfg.shared_attn_every
    for g in range(_n_apps(cfg)):
        for i in range(k):
            lc = None
            if cache is not None:
                mc = cache["mamba"]
                lc = {"conv": mc["conv"][g, i], "ssm": mc["ssm"][g, i]}
            x = L.remat(cfg, mode, functools.partial(
                m2.layer, cfg, params.layers[g * k + i]), x, lc, mode,
                backend)
        sc = None
        if cache is not None:
            sc = {"k": cache["shared"]["k"][g], "v": cache["shared"]["v"][g]}
        x = L.remat(cfg, mode, functools.partial(
            _shared_block, cfg, params.shared), x, positions, sc,
            cache_index, mode, backend)
    logits = m2.head(cfg, params, x)
    return (logits, cache) if cache is not None else logits


def cache_shapes(cfg, batch: int, max_len: int) -> Dict:
    d = L.dtype_of(cfg)
    napp, k = _n_apps(cfg), cfg.shared_attn_every
    mc = {name: ((napp, k) + shape[1:], dt)
          for name, (shape, dt) in m2.cache_shapes(cfg, batch).items()}
    kv = ((napp, batch, max_len, cfg.n_kv_heads, cfg.head_dim), d)
    return {"mamba": mc, "shared": {"k": kv, "v": kv}}


def cache_batch_axes(cfg) -> Dict:
    """The batch axis of each cache leaf (``cache_logical_axes``)."""
    return {"mamba": {"conv": 2, "ssm": 2}, "shared": {"k": 1, "v": 1}}
