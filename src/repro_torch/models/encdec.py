"""Whisper-style encoder-decoder backbone, in PyTorch.

Copied from ``repro.models.encdec``.  The conv/audio frontend is a stub:
the model takes precomputed frame embeddings (B, n_frames, frontend_dim).
The encoder is a bidirectional transformer over the frames with a learned
positional table; the decoder is a causal transformer (RoPE, as in the
reference) with cross attention whose K/V are computed once from the
encoder output and cached for decode.

Parameters live in an :class:`EncDec` module: ``embed``, ``enc_pos``,
``enc_in``, ``enc_norm``, ``final_norm``, ``lm_head``, and ``encoder`` and
``decoder``, one layer module a layer (the reference stacks them on a
leading axis).  The encoder's self-attention and the cross attention (1,500
keys for Whisper-small, not a multiple of 128) go through
``repro_torch.kernels.flash_attn.ops.attention`` with the model's
``backend``, not causal: the reference passes ``backend="xla"`` only
because its Pallas kernel refuses ragged key lengths.

The cache keeps the reference's layout, ``{"self": {"k": (nd, B, S_max,
Hkv, hd), "v": ...}, "cross_k": (nd, B, T, Hkv, hd), "cross_v": ...}``.
The decoder's self-attention cache is written IN PLACE; a prefill with
frames REPLACES ``cross_k``/``cross_v`` in the cache dict with the K/V of
the frames it was given (the reference returns them), so fewer frames than
``cache_shapes`` sizes (``n_frontend_tokens``) leave no zero keys behind.
A call without frames attends to the cache's ``cross_k``/``cross_v``.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn

from . import _params as P
from . import layers as L
from .transformer import init_rule  # the reference's encdec rule is the same
from ..kernels.flash_attn import ops as attn_ops

STACKED = ("encoder", "decoder")


def _attn_shapes(cfg, prefix: str = "w") -> Dict[str, P.Shape]:
    d = L.dtype_of(cfg)
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {f"{prefix}q": ((D, H * hd), d), f"{prefix}k": ((D, Hkv * hd), d),
            f"{prefix}v": ((D, Hkv * hd), d), f"{prefix}o": ((H * hd, D), d)}


def _layer_shapes(cfg, section: str) -> Dict[str, P.Shape]:
    """One encoder or decoder layer's ``(shape, dtype)`` leaves."""
    d = L.dtype_of(cfg)
    D, F = cfg.d_model, cfg.d_ff
    out = {"ln1": ((D,), d), "ln2": ((D,), d)}
    if section == "decoder":
        out["ln3"] = ((D,), d)
    out.update(_attn_shapes(cfg))
    if section == "decoder":
        out.update(_attn_shapes(cfg, "x"))
    out.update({"w_gate": ((D, F), d), "w_up": ((D, F), d),
                "w_down": ((F, D), d)})
    return out


def _section_layers(cfg) -> Dict[str, int]:
    return {"encoder": cfg.n_encoder_layers, "decoder": cfg.n_layers}


def param_shapes(cfg) -> Dict:
    """The reference's parameter tree; ``encoder`` and ``decoder`` stacked
    on their layers."""
    d = L.dtype_of(cfg)
    D = cfg.d_model
    p = {"embed": ((cfg.vocab, D), d),
         "enc_pos": ((cfg.n_frontend_tokens, D), d),
         "enc_in": ((cfg.frontend_dim or D, D), d),
         "enc_norm": ((D,), d), "final_norm": ((D,), d),
         "lm_head": ((D, cfg.vocab), d)}
    for section, nl in _section_layers(cfg).items():
        p[section] = {k: ((nl,) + s, dt)
                      for k, (s, dt) in _layer_shapes(cfg, section).items()}
    return p


class Layer(nn.Module):
    """One encoder layer (``ln1``, ``ln2``, ``wq``/``wk``/``wv``/``wo``,
    ``w_gate``/``w_up``/``w_down``) or decoder layer (also ``ln3`` and the
    cross attention's ``xq``/``xk``/``xv``/``xo``)."""

    def __init__(self, cfg, section: str, device=None):
        super().__init__()
        for name, (shape, dt) in _layer_shapes(cfg, section).items():
            setattr(self, name, P.param(shape, dt, device))


class EncDec(P.Params):
    """The model's parameters (module doc).  Created uninitialised."""

    def __init__(self, cfg, device=None):
        super().__init__(param_shapes(cfg), STACKED)
        for name, leaf in param_shapes(cfg).items():
            if name not in STACKED:
                setattr(self, name, P.param(leaf[0], leaf[1], device))
        for section, nl in _section_layers(cfg).items():
            setattr(self, section, nn.ModuleList(
                Layer(cfg, section, device) for _ in range(nl)))


def new_params(cfg, device=None) -> EncDec:
    return EncDec(cfg, device)


def init_params(cfg, generator: torch.Generator, device) -> EncDec:
    """Random parameters drawn by the reference's rule (normals times
    ``shape[-2] ** -0.5``, ones for 1-D leaves) in flatten order; the
    numbers differ from ``jax.random``'s."""
    return P.draw_(EncDec(cfg, device), param_shapes(cfg), STACKED,
                   init_rule, generator)


def _heads(x, w, n_heads, hd):
    B, S, _ = x.shape
    return (x @ w).reshape(B, S, n_heads, hd)


def encode(cfg, params: EncDec, frames: torch.Tensor,
           backend: str = "auto") -> torch.Tensor:
    """frames (B, T, frontend_dim) -> (B, T, D)."""
    x = frames.to(L.dtype_of(cfg)) @ params.enc_in
    x = x + params.enc_pos[None, :x.shape[1]]
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for lp in params.encoder:
        h = L.rms_norm(x, lp.ln1, cfg.norm_eps)
        q, k, v = (_heads(h, w, n, hd) for w, n in ((lp.wq, H), (lp.wk, Hkv),
                                                     (lp.wv, Hkv)))
        attn = attn_ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=False,
                                  backend=backend)
        y = x + attn.transpose(1, 2).reshape(B, S, H * hd) @ lp.wo
        h2 = L.rms_norm(y, lp.ln2, cfg.norm_eps)
        x = y + L.swiglu(h2, lp.w_gate, lp.w_up, lp.w_down)
    return L.rms_norm(x, params.enc_norm, cfg.norm_eps)


def _cross_kv(cfg, params: EncDec, enc_out: torch.Tensor):
    """Each decoder layer's cross-attention K/V: (nd, B, T, Hkv, hd) each."""
    Hkv, hd = cfg.n_kv_heads, cfg.head_dim
    ks = [_heads(enc_out, lp.xk, Hkv, hd) for lp in params.decoder]
    vs = [_heads(enc_out, lp.xv, Hkv, hd) for lp in params.decoder]
    return torch.stack(ks), torch.stack(vs)


def _dec_layer(cfg, lp: Layer, x, positions, self_cache, cross_kv,
               cache_index, mode, backend):
    h = L.rms_norm(x, lp.ln1, cfg.norm_eps)
    attn, _ = L.gqa_attention(h, lp, cfg, positions, self_cache, cache_index,
                              mode, backend)
    x = x + attn
    h = L.rms_norm(x, lp.ln3, cfg.norm_eps)
    x = x + L.cross_attention(h, cross_kv, lp.xq, lp.xo, cfg, backend)
    h = L.rms_norm(x, lp.ln2, cfg.norm_eps)
    return x + L.swiglu(h, lp.w_gate, lp.w_up, lp.w_down)


def forward(cfg, params: EncDec, tokens: torch.Tensor, *,
            frames: Optional[torch.Tensor] = None,
            enc_out: Optional[torch.Tensor] = None, mode: str = "train",
            cache: Optional[dict] = None, cache_index: int = 0,
            backend: str = "auto"):
    """Decoder forward: tokens (B, S) -> float32 logits (B, S, vocab), or
    (logits, cache) when a cache is given.  ``frames`` run the encoder (or
    give ``enc_out``); without either, the cross K/V come from the cache.
    In training each decoder layer (not the encoder's, as in the reference)
    is rematerialised as ``cfg.remat`` says."""
    if enc_out is None and frames is not None:
        enc_out = encode(cfg, params, frames, backend)
    if enc_out is not None:
        xk, xv = _cross_kv(cfg, params, enc_out)
        if cache is not None:
            cache["cross_k"], cache["cross_v"] = xk, xv
    else:
        xk, xv = cache["cross_k"], cache["cross_v"]

    x = L.embed(tokens, params.embed)
    positions = cache_index + torch.arange(x.shape[1],
                                           device=x.device)[None, :]
    for l, lp in enumerate(params.decoder):
        sc = None
        if cache is not None:
            sc = {"k": cache["self"]["k"][l], "v": cache["self"]["v"][l]}
        x = L.remat(cfg, mode, functools.partial(_dec_layer, cfg, lp),
                    x, positions, sc, (xk[l], xv[l]), cache_index, mode,
                    backend)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = L.unembed(x, params.lm_head)
    return (logits, cache) if cache is not None else logits


def cache_shapes(cfg, batch: int, max_len: int) -> Dict:
    d = L.dtype_of(cfg)
    nd, T = cfg.n_layers, cfg.n_frontend_tokens
    Hkv, hd = cfg.n_kv_heads, cfg.head_dim
    kv = ((nd, batch, max_len, Hkv, hd), d)
    cross = ((nd, batch, T, Hkv, hd), d)
    return {"self": {"k": kv, "v": kv}, "cross_k": cross, "cross_v": cross}


def cache_batch_axes(cfg) -> Dict:
    """The batch axis of each cache leaf (``cache_logical_axes``)."""
    return {"self": {"k": 1, "v": 1}, "cross_k": 1, "cross_v": 1}
