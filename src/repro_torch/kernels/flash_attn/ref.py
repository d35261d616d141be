"""Plain PyTorch versions of causal GQA attention (the oracle of the CUDA
flash-attention kernel), copied from ``repro.kernels.flash_attn.ref``.

``mha`` builds the full (Sq, Sk) logits; ``mha_chunked`` scans key blocks
with the online softmax, O(Sq * block) memory, and takes ``Dv != Dk``.
Both do their math in float32 and return q's dtype.  Masked logits are
``-1e30`` (not ``-inf``) and the softmax denominator is floored at
``1e-30``, as in the reference, so a row that sees no key gives the same
(finite) answer in both packages.  Queries are the last ``Sq`` positions of
the ``Sk``-long context: query ``i`` sees key ``t`` iff
``t <= i + (Sk - Sq)``.

``mha_lse`` is the plain version of the forward kernel asked for its
log-sum-exp (``kernel.flash_attention(..., return_lse=True)``): ``mha``'s
output and each row's log-sum-exp of its masked, scaled logits in the log2
domain, the backward kernels' input.  ``mha_vjp`` is the plain version of
the backward kernel: the vector-Jacobian product of ``mha`` by
``torch.autograd.grad`` (any Dv).

``split3_bf16`` is the plain version of the float32 tensor-core routes'
three-way split (``csrc/hopper.cuh``: ``split3_pair``, ``split_tile``):
three bf16 parts that sum back to a float32 value to within 2^-24 of it;
a product is then the six partial products ``SPLIT_PAIRS`` names.  Only
the tests use it: the plain versions above compute in float32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1.0e30
LOG2E = 1.4426950408889634
# The (a, b) parts of the six partial products a_i b_j, i + j <= 2, in the
# order the kernels issue them: the small ones first.
SPLIT_PAIRS = ((1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0))


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, scale: Optional[float] = None,
        logit_soft_cap: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, Sq, D); k, v (B, Hkv, Sk, D), Hq % Hkv == 0 -> (B, Hq, Sq, D)
    in q's dtype."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    assert Hq % Hkv == 0, (Hq, Hkv)
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if logit_soft_cap is not None:
        logits = logit_soft_cap * torch.tanh(logits / logit_soft_cap)
    if causal:
        Sk = k.shape[2]
        qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        kpos = torch.arange(Sk, device=q.device)[None, :]
        logits = logits.masked_fill(~(kpos <= qpos)[None, None], NEG_INF)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vf)
    return out.to(q.dtype)


def mha_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, scale: Optional[float] = None):
    """(out, lse): :func:`mha`'s output and, float32 (B, Hq, Sq), each
    row's ``log2(sum_t exp(l_t))`` over its logits ``l`` (scaled, masked to
    ``-1e30`` as :func:`mha` masks them), which is ``log2(e)`` times their
    natural log-sum-exp.  A row that sees no key gets about ``-1.44e30``
    (the kernel's ``-1e30``: both are read by no backward)."""
    B, Hq, Sq, D = q.shape
    group = Hq // k.shape[1]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    kf = k.float().repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    if causal:
        Sk = k.shape[2]
        qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        kpos = torch.arange(Sk, device=q.device)[None, :]
        logits = logits.masked_fill(~(kpos <= qpos)[None, None], NEG_INF)
    lse = torch.logsumexp(logits, dim=-1) * LOG2E
    return mha(q, k, v, causal=causal, scale=scale), lse


def mha_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True, scale: Optional[float] = None,
                block_k: int = 512) -> torch.Tensor:
    """Online-softmax attention over key blocks of ``block_k``: the same
    function as :func:`mha`, with ``Dv != Dk`` allowed.  A ragged last block
    is padded with zeros and its padding masked by position."""
    B, Hq, Sq, Dk = q.shape
    _, Hkv, Sk, _ = k.shape
    Dv = v.shape[-1]
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (Dk ** 0.5)
    pad = (-Sk) % block_k
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    nb = k.shape[2] // block_k
    dev = q.device
    qg = (q.float() * scale).reshape(B, Hkv, group, Sq, Dk)
    kb = k.float().reshape(B, Hkv, nb, block_k, Dk)
    vb = v.float().reshape(B, Hkv, nb, block_k, Dv)
    qpos = torch.arange(Sq, device=dev) + (Sk - Sq)
    m = torch.full((B, Hkv, group, Sq), NEG_INF, device=dev)
    l = torch.zeros((B, Hkv, group, Sq), device=dev)
    acc = torch.zeros((B, Hkv, group, Sq, Dv), device=dev)
    for j in range(nb):
        s = torch.einsum("bkgqd,bktd->bkgqt", qg, kb[:, :, j])
        kpos = j * block_k + torch.arange(block_k, device=dev)
        ok = (kpos < Sk)[None, :]
        if causal:
            ok = ok & (kpos[None, :] <= qpos[:, None])
        s = s.masked_fill(~ok[None, None, None], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqt,bktd->bkgqd", p,
                                                    vb[:, :, j])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Hq, Sq, Dv).to(q.dtype)


def mha_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            dout: torch.Tensor, *, causal: bool = True,
            scale: Optional[float] = None):
    """(dq, dk, dv): the gradients of :func:`mha` at (q, k, v) along
    ``dout`` (B, Hq, Sq, Dv), each in its input's dtype."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = mha(qq, kk, vv, causal=causal, scale=scale)
        return torch.autograd.grad(out, (qq, kk, vv), dout.to(out.dtype))


def split3_bf16(x: torch.Tensor):
    """(hi, mid, lo), bf16 tensors of x's shape: hi = bf16_rn(x), mid =
    bf16_rn(x - hi), lo = bf16_rn(x - hi - mid) (each difference exact in
    float32), so that hi + mid + lo is x to within 2^-24 |x| (bf16 keeps 8
    bits of x's significand, each part 8 more of what is left)."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo
