"""Mamba2 (SSD) decoder -- the attention-free family, in PyTorch.

Copied from ``repro.models.mamba2``.  Block: in_proj -> (z | x | B | C |
dt); causal depthwise conv on (x|B|C); dt = softplus(dt + bias); SSD scan
(the CUDA ``ssd_scan`` kernel on the card, the chunked plain version on the
CPU); gated RMSNorm; out_proj.

The reference stacks the layer parameters on a leading ``(nl, ...)`` axis
and scans over it; here they live in a :class:`Mamba2` module with one
:class:`MambaLayer` a layer (``params.layers[l].in_proj``), under the
reference's leaf names and in its ``(in, out)`` orientation.  Decode keeps
O(1)-in-sequence state: a (K-1)-deep conv cache and the (H, N, P) float32
SSM state, ``{"conv": (nl, B, K-1, conv_dim), "ssm": (nl, B, H, N, P)}``
(the reference's flat layout; batch axis 1); each layer writes its slices
IN PLACE.  The prefill's final state comes from the same scan call
(``ops.ssd(..., final_state=True)``: the kernel's on the card, the plain
``ssd_final_state`` on the CPU, where the reference computes it in plain
jnp); the one-token decode recurrence is plain PyTorch, as in the
reference.  The rounding order is the
reference's: dt's softplus in float32, the ``D_skip`` term in x's dtype,
the gate's silu in float32 before the gated RMSNorm.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import _params as P
from . import layers as L
from ..kernels.ssd_scan import ops as ssd_ops

STACKED = ("layers",)


def _dims(cfg):
    din = cfg.ssm_d_inner
    H = cfg.ssm_heads
    Pd = cfg.ssm_head_dim
    G = cfg.ssm_groups
    N = cfg.ssm_state
    conv_dim = din + 2 * G * N
    return din, H, Pd, G, N, conv_dim


def _layer_shapes(cfg) -> Dict[str, P.Shape]:
    """One layer's ``(shape, dtype)`` leaves (no layer axis)."""
    d = L.dtype_of(cfg)
    f32 = torch.float32
    D = cfg.d_model
    din, H, _, G, N, conv_dim = _dims(cfg)
    return {
        "ln": ((D,), d),
        "in_proj": ((D, 2 * din + 2 * G * N + H), d),
        "conv_w": ((cfg.ssm_conv, conv_dim), d),
        "conv_b": ((conv_dim,), d),
        "dt_bias": ((H,), f32),
        "A_log": ((H,), f32),
        "D_skip": ((H,), f32),
        "norm_w": ((din,), d),
        "out_proj": ((din, D), d),
    }


def layer_shapes(cfg, nl: int) -> Dict[str, P.Shape]:
    return {k: ((nl,) + s, dt) for k, (s, dt) in _layer_shapes(cfg).items()}


def param_shapes(cfg) -> Dict:
    """The reference's parameter tree, ``"layers"`` stacked on ``nl``."""
    d = L.dtype_of(cfg)
    p = {"embed": ((cfg.vocab, cfg.d_model), d),
         "final_norm": ((cfg.d_model,), d),
         "layers": layer_shapes(cfg, cfg.n_layers)}
    if not cfg.tie_embeddings:
        p["lm_head"] = ((cfg.d_model, cfg.vocab), d)
    return p


class MambaLayer(nn.Module):
    """One layer's parameters: ``ln``, ``in_proj``, ``conv_w``, ``conv_b``,
    ``dt_bias``, ``A_log``, ``D_skip`` (float32), ``norm_w``,
    ``out_proj``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        for name, (shape, dt) in _layer_shapes(cfg).items():
            setattr(self, name, P.param(shape, dt, device))


def add_embed_params(module: nn.Module, cfg, device) -> None:
    d = L.dtype_of(cfg)
    module.embed = P.param((cfg.vocab, cfg.d_model), d, device)
    module.final_norm = P.param((cfg.d_model,), d, device)
    if not cfg.tie_embeddings:
        module.lm_head = P.param((cfg.d_model, cfg.vocab), d, device)


class Mamba2(P.Params):
    """The model's parameters: ``embed``, ``final_norm``, ``lm_head``
    (unless tied) and ``layers``, a list of :class:`MambaLayer`.  Created
    uninitialised; :func:`init_params` or
    ``repro_torch.interop.params_from_reference`` fill it."""

    def __init__(self, cfg, device=None):
        super().__init__(param_shapes(cfg), STACKED)
        add_embed_params(self, cfg, device)
        self.layers = nn.ModuleList(MambaLayer(cfg, device)
                                    for _ in range(cfg.n_layers))


def new_params(cfg, device=None) -> Mamba2:
    return Mamba2(cfg, device)


def init_rule(key, shape):
    """``repro.models.mamba2.init_params``'s rule: a leaf of two or more
    (stacked) axes whose last axis exceeds 8 is standard normal times
    ``shape[-2] ** -0.5``, any other leaf 0.1; then ``A_log = 0`` (A = -1)
    and ``dt_bias = -2``."""
    if key[-1] == "A_log":
        return "fill", 0.0
    if key[-1] == "dt_bias":
        return "fill", -2.0
    if len(shape) >= 2 and shape[-1] > 8:
        return "normal", shape[-2] ** -0.5
    return "fill", 0.1


def init_params(cfg, generator: torch.Generator, device) -> Mamba2:
    """Random parameters drawn by :func:`init_rule` in flatten order (a
    stacked leaf one layer at a time) in float32, cast to each leaf's
    dtype.  The numbers differ from ``jax.random``'s."""
    return P.draw_(Mamba2(cfg, device), param_shapes(cfg), STACKED,
                   init_rule, generator)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _causal_conv(x, w, b, conv_state=None):
    """x (B, S, C); w (K, C) depthwise; returns (y, new_state (B, K-1, C))."""
    K = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                     # (B, S+K-1, C)
    S = x.shape[1]
    y = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(K))
    y = F.silu((y + b).float()).to(x.dtype)
    return y, xp[:, -(K - 1):, :]


def mamba_block(cfg, p: MambaLayer, x, cache=None, mode="train",
                backend="auto"):
    """x (B, S, D) -> (y, new_cache).  cache: {"conv": (B, K-1, Cv),
    "ssm": (B, H, N, P)}."""
    B, S, D = x.shape
    din, H, Pd, G, N, conv_dim = _dims(cfg)
    proj = x @ p.in_proj
    z = proj[..., :din]
    xbc = proj[..., din:din + conv_dim]
    dt_raw = proj[..., din + conv_dim:]

    decode = mode == "decode" and S == 1
    conv_state = cache.get("conv") if cache else None
    xbc_conv, new_conv = _causal_conv(xbc, p.conv_w, p.conv_b,
                                      conv_state if mode != "train" else None)
    xc = xbc_conv[..., :din].reshape(B, S, H, Pd)
    Bm = xbc_conv[..., din:din + G * N].reshape(B, S, G, N)
    Cm = xbc_conv[..., din + G * N:].reshape(B, S, G, N)
    dt = F.softplus(dt_raw.float() + p.dt_bias)
    A = -torch.exp(p.A_log)

    new_ssm = None
    if decode:
        # single-step recurrence on the cached state
        h_prev = cache["ssm"].float()                   # (B,H,N,P)
        rep = H // G
        b1 = Bm[:, 0].repeat_interleave(rep, dim=1)     # (B,H,N)
        c1 = Cm[:, 0].repeat_interleave(rep, dim=1)
        dt1 = dt[:, 0]                                  # (B,H)
        x1 = xc[:, 0].float()                           # (B,H,P)
        decay = torch.exp(A[None] * dt1)                # (B,H)
        h = (decay[..., None, None] * h_prev
             + dt1[..., None, None] * b1[..., :, None] * x1[..., None, :])
        y = torch.einsum("bhn,bhnp->bhp", c1.float(), h)[:, None]
        new_ssm = h.to(cache["ssm"].dtype)
        y = y.to(x.dtype)
    elif cache is None:
        y = ssd_ops.ssd(xc, dt, A, Bm, Cm, backend=backend)
    else:  # prefill: the scan also returns the final state
        y, h = ssd_ops.ssd(xc, dt, A, Bm, Cm, backend=backend,
                           final_state=True)
        new_ssm = h.to(cache["ssm"].dtype)
    y = y + xc * p.D_skip.to(x.dtype)[None, None, :, None]
    y = y.reshape(B, S, din)
    y = L.rms_norm(y * F.silu(z.float()).to(x.dtype), p.norm_w, cfg.norm_eps)
    out = y @ p.out_proj
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv.to(cache["conv"].dtype),
                     "ssm": new_ssm}
    return out, new_cache


def layer(cfg, p: MambaLayer, x, cache, mode, backend="auto"):
    """One residual Mamba2 layer; a given cache ({"conv", "ssm"} views) is
    written in place."""
    h = L.rms_norm(x, p.ln, cfg.norm_eps)
    y, nc = mamba_block(cfg, p, h, cache, mode, backend)
    if cache is not None:
        cache["conv"].copy_(nc["conv"])
        cache["ssm"].copy_(nc["ssm"])
    return x + y


def head(cfg, params, x):
    """Final norm and float32 logits (the embedding transposed if tied)."""
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    table = params.embed.T if cfg.tie_embeddings else params.lm_head
    return L.unembed(x, table)


def forward(cfg, params: Mamba2, tokens: torch.Tensor, *,
            mode: str = "train", cache: Optional[dict] = None,
            cache_index: int = 0, backend: str = "auto"):
    """tokens (B, S) -> float32 logits (B, S, vocab), or (logits, cache)
    when a cache is given (written in place and returned).  ``cache_index``
    is unused: the state carries the position.  In training each layer is
    rematerialised as ``cfg.remat`` says."""
    x = L.embed(tokens, params.embed)
    for l, lp in enumerate(params.layers):
        lc = None
        if cache is not None:
            lc = {"conv": cache["conv"][l], "ssm": cache["ssm"][l]}
        x = L.remat(cfg, mode, functools.partial(layer, cfg, lp), x,
                    lc, mode, backend)
    logits = head(cfg, params, x)
    return (logits, cache) if cache is not None else logits


def cache_shapes(cfg, batch: int, max_len: int = 0) -> Dict[str, P.Shape]:
    """SSM caches are O(1) in sequence length (max_len unused)."""
    d = L.dtype_of(cfg)
    din, H, Pd, G, N, conv_dim = _dims(cfg)
    nl = cfg.n_layers
    return {"conv": ((nl, batch, cfg.ssm_conv - 1, conv_dim), d),
            "ssm": ((nl, batch, H, N, Pd), torch.float32)}


def cache_batch_axes(cfg) -> Dict[str, int]:
    """The batch axis of each cache leaf (``cache_logical_axes``)."""
    return {"conv": 1, "ssm": 1}
