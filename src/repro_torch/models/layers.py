"""Shared neural building blocks of the model zoo, in PyTorch.

Copied from ``repro.models.layers``.  Parameters are ``nn.Parameter``s of a
layer module, read by the reference's leaf names (``p.wq``, ``p.w_gate``)
in its ``(in, out)`` orientation (``x @ w``).  The rounding order is the
reference's:

* ``rms_norm`` casts to x's dtype before ``* w``;
* ``swiglu`` takes ``silu`` in float32, casts, then multiplies by ``u``;
* ``unembed`` and RoPE run in float32;
* ``_cached_attention`` scales q in q's dtype, contracts upcast operands
  (exact) so its logits stay float32 as with ``preferred_element_type``,
  and rounds the probabilities to v's dtype before the second contraction.

Prefill and training attention, and the enc-dec cross attention, go
through ``repro_torch.kernels.flash_attn.ops.attention`` (the CUDA kernel
on the card, the plain version on the CPU); decode attention over the
cache is plain PyTorch, as it is plain jnp in the reference.  The reference's
sharding constraints, no-ops without a mesh, are dropped.

:func:`remat` is the reference's ``jax.checkpoint(body,
policy=remat_policy_of(cfg))`` around a layer body in training:
``torch.utils.checkpoint`` (non-reentrant), recomputing everything under
policy ``"nothing"``, keeping the matrix products' outputs under
``"dots"``.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from ..kernels.flash_attn import ops as attn_ops

NEG_INF = -1.0e30


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# The operators whose outputs the "dots" policy keeps (the reference's
# ``checkpoint_dots``: every dot_general).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def remat(cfg, mode: str, body, *args):
    """``body(*args)``, recomputed in the backward pass when rematerialising
    applies: ``cfg.remat``, ``mode == "train"`` and grad mode on.
    ``cfg.remat_policy`` ``"dots"`` keeps the outputs of the matrix
    products; ``"nothing"`` keeps none."""
    if not (cfg.remat and mode == "train" and torch.is_grad_enabled()):
        return body(*args)
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, list(_DOTS))
    return _ckpt.checkpoint(body, *args, use_reentrant=False, **kw)


# ---------------------------------------------------------------------------
# Norms / activations / embeddings
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def swiglu(x, w_gate, w_up, w_down):
    g = x @ w_gate
    u = x @ w_up
    return (F.silu(g.float()).to(x.dtype) * u) @ w_down


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits in float32."""
    return x.float() @ table.float()


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)        # float32, as theta ** exps


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions (..., S)."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)                   # (D/2,)
    ang = positions[..., None].float() * freqs               # (..., S, D/2)
    if x.dim() == ang.dim() + 1:                             # has head axis
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention (training / prefill / cached decode)
# ---------------------------------------------------------------------------

def gqa_attention(x: torch.Tensor, p, cfg, positions: torch.Tensor,
                  cache: Optional[Dict[str, torch.Tensor]] = None,
                  cache_index: int = 0, mode: str = "train",
                  backend: str = "auto"):
    """Multi-head GQA attention with RoPE.

    x (B, S, D).  ``cache``: optional {"k": (B, S_max, Hkv, hd), "v": ...},
    written IN PLACE at [cache_index, cache_index + S).  ``mode``:
      train   -- no cache; causal flash attention;
      prefill -- causal flash attention over the S new tokens;
      decode  -- attention over the whole (padded) cache.
    Returns (out, cache) -- the same cache dict, updated.
    """
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    q = apply_rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, Hkv, hd), positions, cfg.rope_theta)
    v = v.reshape(B, S, Hkv, hd)

    if cache is not None:
        if cache_index + S > cache["k"].shape[1]:
            raise ValueError(f"cache of {cache['k'].shape[1]} positions "
                             f"cannot take [{cache_index}, {cache_index + S})")
        cache["k"][:, cache_index:cache_index + S] = k.to(cache["k"].dtype)
        cache["v"][:, cache_index:cache_index + S] = v.to(cache["v"].dtype)

    if mode == "decode":
        assert cache is not None
        out = _cached_attention(q, cache["k"], cache["v"], cache_index + S,
                                cache["k"].shape[1])
        return out.reshape(B, S, H * hd) @ p.wo, cache

    # (B, H, S, hd) views of the (B, S, H, hd) projections: the kernel
    # reads them through their strides, and its output, laid out like q,
    # is (B, S, H, hd) in memory again.
    out = attn_ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=True, backend=backend)
    out = out.transpose(1, 2).reshape(B, S, H * hd)
    return out @ p.wo, cache


def cross_attention(x: torch.Tensor, enc_kv, wq: torch.Tensor,
                    wo: torch.Tensor, cfg, backend: str = "auto"):
    """Cross attention of the enc-dec decoder (not causal): x (B, S, D);
    ``enc_kv`` the precomputed (k, v), each (B, T, Hkv, hd).  Goes through
    the attention kernel like prefill (the reference passes
    ``backend="xla"``, as its Pallas kernel refuses ragged key lengths;
    the port's kernels take them)."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q = (x @ wq).reshape(B, S, H, hd)
    k, v = enc_kv
    out = attn_ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=False, backend=backend)
    return out.transpose(1, 2).reshape(B, S, H * hd) @ wo


def _cached_attention(q, k, v, valid_len: int, kv_len: int):
    """Decode/prefill attention over a (possibly padded) KV cache.

    q (B, S, H, hd); k/v (B, S_max, Hkv, hd); positions >= valid_len masked.
    """
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    qg = (q * (hd ** -0.5)).reshape(B, S, Hkv, group, hd)
    logits = torch.einsum("bskgd,btkd->bskgt", qg.float(), k.float())
    # causal-and-valid: key t visible to query s iff t <= qpos_s (< valid_len)
    qpos = valid_len - S + torch.arange(S, device=q.device)
    cmask = torch.arange(kv_len, device=q.device)[None, :] <= qpos[:, None]
    logits = logits.masked_fill(~cmask[None, :, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bskgt,btkd->bskgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)
