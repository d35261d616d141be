"""Decoder-only transformer covering the dense, MoE and VLM LM families, in
PyTorch.

Copied from ``repro.models.transformer``.  One module, composed per config:

* attention: GQA (+RoPE, optional QKV bias) or MLA (DeepSeek's compressed
  latent, ``cfg.mla``: :mod:`.mla`);
* MLP: dense SwiGLU, or MoE (:mod:`.moe`, the reference's one-card dense
  oracle) after ``cfg.n_dense_layers`` leading dense layers (the DeepSeek-V3
  layout);
* the stubbed modality frontend of the ``"vlm"`` family: precomputed patch
  embeddings projected by ``vision_proj`` and put before the tokens.

The reference stacks each section's layer parameters (``"dense"`` and
``"moe"``) on a leading ``(nl, ...)`` axis and scans over it; here the
parameters live in a :class:`Transformer` module with one layer module a
layer in each section (``params.dense[l].wq``, ``params.moe[l].w_gate``),
under the reference's leaf names and in its ``(in, out)`` orientation, and
``forward`` runs a Python loop over the layers.  The cache keeps the
reference's sectioned layout, ``{"dense": {"k": (nl, B, S_max, Hkv, hd),
"v": ...}, "moe": {...}}`` (``{"c_kv", "k_rope"}`` leaves with MLA); each
layer writes its slice IN PLACE.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from . import _params as P
from . import layers as L
from . import mla as mla_mod
from . import moe as moe_mod

Shape = P.Shape
STACKED = ("dense", "moe")


def section_layers(cfg) -> Dict[str, int]:
    """Layers of each non-empty section: ``n_dense_layers`` dense layers
    before ``n_layers - n_dense_layers`` MoE layers when the config has
    experts, else ``n_layers`` dense layers."""
    n_moe = (cfg.n_layers - cfg.n_dense_layers) if cfg.n_experts else 0
    if n_moe < 0:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} is below "
                         f"n_dense_layers={cfg.n_dense_layers}")
    out = {"dense": cfg.n_layers - n_moe, "moe": n_moe}
    return {k: n for k, n in out.items() if n}


# ---------------------------------------------------------------------------
# Param shapes
# ---------------------------------------------------------------------------

def _attn_shapes(cfg) -> Dict[str, Shape]:
    if cfg.mla:
        return mla_mod.layer_shapes(cfg)
    d = L.dtype_of(cfg)
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {"wq": ((D, H * hd), d), "wk": ((D, Hkv * hd), d),
           "wv": ((D, Hkv * hd), d), "wo": ((H * hd, D), d)}
    if cfg.qkv_bias:
        out.update({"bq": ((H * hd,), d), "bk": ((Hkv * hd,), d),
                    "bv": ((Hkv * hd,), d)})
    return out


def _layer_shapes(cfg, section: str) -> Dict[str, Shape]:
    """One layer's ``(shape, dtype)`` leaves (no layer axis)."""
    d = L.dtype_of(cfg)
    D, F = cfg.d_model, cfg.d_ff
    out = {"ln1": ((D,), d), "ln2": ((D,), d), **_attn_shapes(cfg)}
    if section == "moe":
        out.update(moe_mod.layer_shapes(cfg))
    else:
        out.update({"w_gate": ((D, F), d), "w_up": ((D, F), d),
                    "w_down": ((F, D), d)})
    return out


def param_shapes(cfg) -> Dict:
    """The reference's parameter tree: ``(shape, dtype)`` leaves, each
    section's leaves stacked on a leading axis of its layers."""
    d = L.dtype_of(cfg)
    p = {"embed": ((cfg.vocab, cfg.d_model), d),
         "final_norm": ((cfg.d_model,), d)}
    if not cfg.tie_embeddings:
        p["lm_head"] = ((cfg.d_model, cfg.vocab), d)
    if cfg.family == "vlm":
        p["vision_proj"] = ((cfg.frontend_dim or cfg.d_model, cfg.d_model), d)
    for section, nl in section_layers(cfg).items():
        p[section] = {k: ((nl,) + s, dt)
                      for k, (s, dt) in _layer_shapes(cfg, section).items()}
    return p


class Layer(nn.Module):
    """One layer's parameters: ``ln1``, ``ln2``, the attention leaves (GQA's
    ``wq``, ``wk``, ``wv``, ``wo`` (+ ``bq``, ``bk``, ``bv``), or MLA's),
    and the MLP's (SwiGLU's ``w_gate``, ``w_up``, ``w_down``, or in a MoE
    layer the router, the (E, ...) experts and the shared expert)."""

    def __init__(self, cfg, section: str, device=None):
        super().__init__()
        for name, (shape, dt) in _layer_shapes(cfg, section).items():
            setattr(self, name, P.param(shape, dt, device))


class Transformer(P.Params):
    """The model's parameters: ``embed``, ``final_norm``, ``lm_head``
    (unless tied), ``vision_proj`` (VLM), and ``dense`` and ``moe``, lists
    of :class:`Layer` (empty when the config has no such layers).  Created
    uninitialised; :func:`init_params` or
    ``repro_torch.interop.params_from_reference`` fill it."""

    def __init__(self, cfg, device=None):
        super().__init__(param_shapes(cfg), STACKED)
        d = L.dtype_of(cfg)
        self.embed = P.param((cfg.vocab, cfg.d_model), d, device)
        self.final_norm = P.param((cfg.d_model,), d, device)
        if not cfg.tie_embeddings:
            self.lm_head = P.param((cfg.d_model, cfg.vocab), d, device)
        if cfg.family == "vlm":
            self.vision_proj = P.param(
                (cfg.frontend_dim or cfg.d_model, cfg.d_model), d, device)
        nls = section_layers(cfg)
        for section in STACKED:
            setattr(self, section, nn.ModuleList(
                Layer(cfg, section, device)
                for _ in range(nls.get(section, 0))))


def new_params(cfg, device=None) -> Transformer:
    return Transformer(cfg, device)


def leaves(cfg) -> Tuple[Tuple[Tuple[str, ...], Shape], ...]:
    """``(path, (shape, dtype))`` of every reference leaf, in the order
    ``jax.tree_util`` flattens the reference tree (sorted keys)."""
    return P.leaves(param_shapes(cfg))


def init_rule(key, shape):
    """``repro.models.transformer.init_params``'s rule: a leaf of two or
    more (stacked) axes is standard normal times ``shape[-2] ** -0.5`` (so
    the stacked norm gains and biases ``(nl, D)`` get ``nl ** -0.5``, and
    the experts ``(nl, E, D, F)`` ``D ** -0.5``), a 1-D leaf is ones."""
    if len(shape) < 2:
        return "fill", 1.0
    return "normal", shape[-2] ** -0.5


def init_params(cfg, generator: torch.Generator, device) -> Transformer:
    """Random parameters drawn by :func:`init_rule` for each leaf in
    flatten order (a stacked leaf one layer at a time) in float32, cast to
    the leaf's dtype.  The numbers differ from ``jax.random``'s."""
    return P.draw_(Transformer(cfg, device), param_shapes(cfg), STACKED,
                   init_rule, generator)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layer(cfg, use_moe: bool, p: Layer, x, positions, lc, cache_index,
           mode, backend):
    h = L.rms_norm(x, p.ln1, cfg.norm_eps)
    if cfg.mla:
        attn_out, _ = mla_mod.mla_attention(h, p, cfg, positions, lc,
                                            cache_index, mode, backend)
    else:
        attn_out, _ = L.gqa_attention(h, p, cfg, positions, lc, cache_index,
                                      mode, backend)
    x = x + attn_out
    h = L.rms_norm(x, p.ln2, cfg.norm_eps)
    if use_moe:
        return x + moe_mod.moe_block(cfg, p, h)
    return x + L.swiglu(h, p.w_gate, p.w_up, p.w_down)


def forward(cfg, params: Transformer, tokens: torch.Tensor, *,
            mode: str = "train", cache: Optional[dict] = None,
            cache_index: int = 0, vision_embeds: Optional[torch.Tensor] = None,
            backend: str = "auto"):
    """tokens (B, S) -> float32 logits (B, n_front + S, vocab), or (logits,
    cache) when a cache is given (written in place and returned).
    ``vision_embeds`` (B, n_front, frontend_dim), VLM only, are projected
    and put before the tokens.  In training each layer is rematerialised
    as ``cfg.remat`` says (:func:`layers.remat`)."""
    x = L.embed(tokens, params.embed)
    if vision_embeds is not None:
        v = vision_embeds.to(x.dtype) @ params.vision_proj
        x = torch.cat([v, x], dim=1)
    S = x.shape[1]
    positions = cache_index + torch.arange(S, device=x.device)[None, :]
    for section in STACKED:
        sc = cache[section] if cache is not None and section in cache \
            else None
        for l, lp in enumerate(getattr(params, section)):
            lc = None if sc is None else {n: t[l] for n, t in sc.items()}
            x = L.remat(cfg, mode, functools.partial(
                _layer, cfg, section == "moe", lp), x, positions, lc,
                cache_index, mode, backend)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    head = params.lm_head if not cfg.tie_embeddings else params.embed.T
    logits = L.unembed(x, head)
    return (logits, cache) if cache is not None else logits


def cache_shapes(cfg, batch: int, max_len: int) -> Dict[str, Dict[str, Shape]]:
    d = L.dtype_of(cfg)
    out = {}
    for section, nl in section_layers(cfg).items():
        if cfg.mla:
            out[section] = mla_mod.cache_shapes(cfg, nl, batch, max_len)
        else:
            shape = (nl, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            out[section] = {"k": (shape, d), "v": (shape, d)}
    return out


def cache_batch_axes(cfg) -> Dict[str, Dict[str, int]]:
    """The batch axis of each cache leaf (the reference's
    ``cache_logical_axes`` "batch")."""
    names = ("c_kv", "k_rope") if cfg.mla else ("k", "v")
    return {section: {n: 1 for n in names} for section in section_layers(cfg)}
