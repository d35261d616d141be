"""Decoder-only transformer of the dense LM family (GQA + RoPE, optional
QKV bias, SwiGLU), in PyTorch.

Copied from the dense section of ``repro.models.transformer``.  The
reference stacks each section's layer parameters on a leading ``(nl, ...)``
axis and scans over it; here the parameters live in a :class:`Transformer`
module with one :class:`DenseLayer` a layer (``params.dense[l].wq``), under
the reference's leaf names and in its ``(in, out)`` orientation, and
``forward`` runs a Python loop over the layers.  The KV cache keeps the
reference's layout, ``{"dense": {"k": (nl, B, S_max, Hkv, hd), "v": ...}}``;
each layer writes its slice IN PLACE.

MLA (``cfg.mla``), MoE (``cfg.n_experts``) and the VLM frontend
(``family == "vlm"``) are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from . import _params as P
from . import layers as L

Shape = P.Shape


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a configuration outside the ported
    dense family, naming its ``ROADMAP.md`` item."""
    if cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention is not ported yet (ROADMAP.md A8)")
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP.md A8)")
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP.md A8)")


# ---------------------------------------------------------------------------
# Param shapes
# ---------------------------------------------------------------------------

def _layer_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    D, H, Hkv, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    out = {"ln1": (D,), "ln2": (D,),
           "wq": (D, H * hd), "wk": (D, Hkv * hd), "wv": (D, Hkv * hd),
           "wo": (H * hd, D)}
    if cfg.qkv_bias:
        out.update({"bq": (H * hd,), "bk": (Hkv * hd,), "bv": (Hkv * hd,)})
    out.update({"w_gate": (D, F), "w_up": (D, F), "w_down": (F, D)})
    return out


def param_shapes(cfg) -> Dict[str, Union[Shape, Dict[str, Shape]]]:
    """The reference's parameter tree: ``(shape, dtype)`` leaves, the
    ``"dense"`` section layer-stacked on a leading ``n_layers`` axis."""
    check_supported(cfg)
    d = L.dtype_of(cfg)
    p = {"embed": ((cfg.vocab, cfg.d_model), d),
         "final_norm": ((cfg.d_model,), d)}
    if not cfg.tie_embeddings:
        p["lm_head"] = ((cfg.d_model, cfg.vocab), d)
    p["dense"] = {k: ((cfg.n_layers,) + s, d)
                  for k, s in _layer_shapes(cfg).items()}
    return p


class DenseLayer(nn.Module):
    """One layer's parameters: ``ln1``, ``ln2``, ``wq``, ``wk``, ``wv``,
    ``wo`` (+ ``bq``, ``bk``, ``bv``), ``w_gate``, ``w_up``, ``w_down``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d = L.dtype_of(cfg)
        for name, shape in _layer_shapes(cfg).items():
            setattr(self, name, P.param(shape, d, device))


class Transformer(nn.Module):
    """The model's parameters: ``embed``, ``final_norm``, ``lm_head``
    (unless tied) and ``dense``, a list of :class:`DenseLayer`.  Created
    uninitialised; :func:`init_params` or
    ``repro_torch.interop.params_from_reference`` fill it."""

    def __init__(self, cfg, device=None):
        super().__init__()
        check_supported(cfg)
        d = L.dtype_of(cfg)
        self.embed = P.param((cfg.vocab, cfg.d_model), d, device)
        self.final_norm = P.param((cfg.d_model,), d, device)
        if not cfg.tie_embeddings:
            self.lm_head = P.param((cfg.d_model, cfg.vocab), d, device)
        self.dense = nn.ModuleList(DenseLayer(cfg, device)
                                   for _ in range(cfg.n_layers))


STACKED = ("dense",)


def new_params(cfg, device=None) -> Transformer:
    return Transformer(cfg, device)


def leaves(cfg) -> Tuple[Tuple[Tuple[str, ...], Shape], ...]:
    """``(path, (shape, dtype))`` of every reference leaf, in the order
    ``jax.tree_util`` flattens the reference tree (sorted keys)."""
    return P.leaves(param_shapes(cfg))


def init_rule(key, shape):
    """``repro.models.transformer.init_params``'s rule: a leaf of two or
    more (stacked) axes is standard normal times ``shape[-2] ** -0.5`` (so
    the stacked norm gains and biases ``(nl, D)`` get ``nl ** -0.5``), a
    1-D leaf is ones."""
    if len(shape) < 2:
        return "fill", 1.0
    return "normal", shape[-2] ** -0.5


def init_params(cfg, generator: torch.Generator, device) -> Transformer:
    """Random parameters drawn by :func:`init_rule` for each leaf in
    flatten order (a stacked leaf one layer at a time) in float32, cast to
    the config's dtype.  The numbers differ from ``jax.random``'s."""
    return P.draw_(Transformer(cfg, device), param_shapes(cfg), STACKED,
                   init_rule, generator)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layer(cfg, p: DenseLayer, x, positions, lc, cache_index, mode,
           backend):
    h = L.rms_norm(x, p.ln1, cfg.norm_eps)
    attn_out, _ = L.gqa_attention(h, p, cfg, positions, lc, cache_index,
                                  mode, backend)
    x = x + attn_out
    h = L.rms_norm(x, p.ln2, cfg.norm_eps)
    return x + L.swiglu(h, p.w_gate, p.w_up, p.w_down)


@torch.no_grad()
def forward(cfg, params: Transformer, tokens: torch.Tensor, *,
            mode: str = "train", cache: Optional[dict] = None,
            cache_index: int = 0, backend: str = "auto"):
    """tokens (B, S) -> float32 logits (B, S, vocab), or (logits, cache)
    when a cache is given (written in place and returned)."""
    check_supported(cfg)
    x = L.embed(tokens, params.embed)
    B, S, _ = x.shape
    positions = cache_index + torch.arange(S, device=x.device)[None, :]
    for l, lp in enumerate(params.dense):
        lc = None
        if cache is not None:
            lc = {"k": cache["dense"]["k"][l], "v": cache["dense"]["v"][l]}
        x = _layer(cfg, lp, x, positions, lc, cache_index, mode, backend)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    head = params.lm_head if not cfg.tie_embeddings else params.embed.T
    logits = L.unembed(x, head)
    return (logits, cache) if cache is not None else logits


def cache_shapes(cfg, batch: int, max_len: int) -> Dict[str, Dict[str, Shape]]:
    check_supported(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    d = L.dtype_of(cfg)
    return {"dense": {"k": (shape, d), "v": (shape, d)}}


def cache_batch_axes(cfg) -> Dict[str, Dict[str, int]]:
    """The batch axis of each cache leaf (the reference's
    ``cache_logical_axes`` "batch")."""
    return {"dense": {"k": 1, "v": 1}}
