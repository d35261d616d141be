"""Multi-head Latent Attention (DeepSeek-V3), in PyTorch.

Copied from ``repro.models.mla``.  Prefill (and training) materialises each
head's K/V from the compressed latent and runs causal attention through
``repro_torch.kernels.flash_attn.ops.attention`` with ``Dk = nope + rope``
(192) and ``Dv`` (128): the CUDA kernel on the card, the reference's own
plain route (``mha_chunked``, which takes ``Dv != Dk``) on the CPU.  The
reference passes ``backend="xla"`` there only because its Pallas kernel
refuses ``Dv != Dk``; the port's kernels take it.  The cache keeps only
``(c_kv, k_rope)``, ``kv_lora_rank + rope_head_dim`` values a token,
written IN PLACE, and decode runs the absorbed-weights attention over it in
plain PyTorch, as the reference does in plain jnp.  Its contractions read
exactly upcast float32 operands and sum in float32, as
``preferred_element_type=jnp.float32`` does, and round to the cache's dtype
where the reference calls ``.astype``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import _params as P
from . import layers as L
from ..kernels.flash_attn import ops as attn_ops


def layer_shapes(cfg) -> Dict[str, P.Shape]:
    """One layer's attention leaves ``(shape, dtype)`` (no layer axis)."""
    d = L.dtype_of(cfg)
    D, H = cfg.d_model, cfg.n_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": ((D, qr), d),              # q down-projection
        "q_norm": ((qr,), d),
        "wq_b": ((qr, H * (dn + dr)), d),
        "wkv_a": ((D, kr + dr), d),        # kv down-projection (+k_rope)
        "kv_norm": ((kr,), d),
        "wk_b": ((kr, H * dn), d),
        "wv_b": ((kr, H * dv), d),
        "wo": ((H * dv, D), d),
    }


def _project_q(x, p, cfg, positions):
    B, S, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim
    q = L.rms_norm(x @ p.wq_a, p.q_norm, cfg.norm_eps) @ p.wq_b
    q = q.reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, L.apply_rope(q_rope, positions, cfg.rope_theta)


def mla_attention(x: torch.Tensor, p, cfg, positions: torch.Tensor,
                  cache: Optional[Dict[str, torch.Tensor]] = None,
                  cache_index: int = 0, mode: str = "train",
                  backend: str = "auto"):
    """MLA attention.  Returns (out, cache) -- the same cache dict, its
    (B, S_max, kr) ``c_kv`` and (B, S_max, dr) ``k_rope`` written at
    [cache_index, cache_index + S).  ``train``/``prefill``: causal flash
    attention over the S new tokens; ``decode``: absorbed-weights
    attention over the compressed cache."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    kr = cfg.kv_lora_rank

    q_nope, q_rope = _project_q(x, p, cfg, positions)
    kv = x @ p.wkv_a                                   # (B, S, kr + dr)
    c_kv = L.rms_norm(kv[..., :kr], p.kv_norm, cfg.norm_eps)
    k_rope = L.apply_rope(kv[..., kr:], positions, cfg.rope_theta)  # shared

    if cache is not None:
        if cache_index + S > cache["c_kv"].shape[1]:
            raise ValueError(f"cache of {cache['c_kv'].shape[1]} positions "
                             f"cannot take [{cache_index}, {cache_index + S})")
        cache["c_kv"][:, cache_index:cache_index + S] = c_kv.to(
            cache["c_kv"].dtype)
        cache["k_rope"][:, cache_index:cache_index + S] = k_rope.to(
            cache["k_rope"].dtype)

    if mode == "decode":
        assert cache is not None
        out = _absorbed_attention(q_nope, q_rope, cache, p, cfg,
                                  cache_index + S)
        return out @ p.wo, cache

    k_nope = (c_kv @ p.wk_b).reshape(B, S, H, dn)
    v = (c_kv @ p.wv_b).reshape(B, S, H, dv)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = attn_ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=True,
                             scale=(dn + dr) ** -0.5, backend=backend)
    out = out.transpose(1, 2).reshape(B, S, H * dv).to(x.dtype)
    return out @ p.wo, cache


def _absorbed_attention(q_nope, q_rope, cache, p, cfg, valid_len: int):
    """Decode with the compressed cache only.

    scores = (W_kb^T q_nope)^T c + q_rope^T k_rope   (W_kb absorbed into q)
    out_h  = (probs . c) W_vb_h                        (W_vb applied after).
    """
    B, S, H, dn = q_nope.shape
    kr, dr, dv = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.v_head_dim
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    Tmax = c_kv.shape[1]
    cdt = c_kv.dtype
    scale = (dn + dr) ** -0.5

    wk = p.wk_b.reshape(kr, H, dn)
    q_abs = torch.einsum("bshd,khd->bshk", q_nope.float(), wk.float())
    logits = (torch.einsum("bshk,btk->bhst", q_abs.to(cdt).float(),
                           c_kv.float())
              + torch.einsum("bshd,btd->bhst", q_rope.float(),
                             k_rope.float())) * scale
    qpos = valid_len - S + torch.arange(S, device=c_kv.device)
    mask = torch.arange(Tmax, device=c_kv.device)[None, :] <= qpos[:, None]
    logits = logits.masked_fill(~mask[None, None], L.NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhst,btk->bshk", probs.to(cdt).float(),
                       c_kv.float())                   # (B, S, H, kr)
    wv = p.wv_b.reshape(kr, H, dv)
    out = torch.einsum("bshk,khd->bshd", ctx.to(wv.dtype).float(),
                       wv.float())
    return out.reshape(B, S, H * dv).to(p.wo.dtype)


def cache_shapes(cfg, nl: int, batch: int, max_len: int) -> Dict[str, P.Shape]:
    d = L.dtype_of(cfg)
    return {"c_kv": ((nl, batch, max_len, cfg.kv_lora_rank), d),
            "k_rope": ((nl, batch, max_len, cfg.rope_head_dim), d)}
