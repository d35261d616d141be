"""Serving steps: prefill and decode over the model zoo, in PyTorch.

Copied from ``repro.serve.serve_step`` for one card: ``build_serve_fns``
returns plain callables (PyTorch runs eagerly; no ``jit``, no mesh), and
caches are written in place.  A cache is the tree of its family's
``cache_shapes`` (sectioned for the transformer, hybrid and enc-dec
families, flat for Mamba2); :func:`tree_map` walks it.  ``cache_shardings`` waits for a
multi-card slice.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..kernels._common import resolve_device
from ..models.registry import Model

Device = Optional[Union[str, torch.device]]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a nested dict (and the same-shaped
    ``rest``), keeping the dict structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def zero_cache(model: Model, batch: int, max_len: int, device: Device = None):
    """A zero cache of the tree ``model.cache_shapes`` gives, flat or
    sectioned, on ``device`` (``None``: CUDA, raising without a card)."""
    dev = resolve_device(device)
    return tree_map(lambda leaf: torch.zeros(leaf[0], dtype=leaf[1],
                                             device=dev),
                    model.cache_shapes(batch, max_len))


def check_params_device(params, device: torch.device) -> None:
    """Raise unless the parameters lie on ``device``."""
    pdev = next(params.parameters()).device
    if pdev.type != device.type or (device.index is not None
                                    and pdev.index != device.index):
        raise ValueError(f"parameters lie on {pdev}, the run asks for "
                         f"{device}")


def build_serve_fns(model: Model):
    """(prefill_fn, decode_fn).

    prefill_fn(params, batch, cache) -> (last_logits, cache)
    decode_fn(params, tokens, cache, index) -> (logits, cache)
    """

    def prefill(params, batch, cache):
        logits, cache = model.prefill(params, batch, cache)
        return logits[:, -1:], cache

    def decode(params, tokens, cache, index):
        return model.decode_step(params, tokens, cache, index)

    return prefill, decode


@torch.no_grad()
def greedy_decode(model: Model, params, prompt_tokens, n_new: int,
                  device: Device = None, extra_batch=None) -> torch.Tensor:
    """Greedy decoding of ``n_new`` tokens after each prompt row: (B, S)
    int tokens -> (B, n_new) int32 on ``device`` (``None``: CUDA, raising
    without a card), where ``params`` must lie.  ``extra_batch`` joins the
    prefill's batch: ``{"vision_embeds": (B, n_front, frontend_dim)}``
    (VLM; the cache then holds ``n_front`` more positions and decoding
    starts after them) or ``{"frames": (B, T, frontend_dim)}`` (enc-dec)."""
    dev = resolve_device(device)
    check_params_device(params, dev)
    prompt = torch.as_tensor(prompt_tokens, device=dev).to(torch.int32)
    B, S = prompt.shape
    n_front = 0
    if model.cfg.family == "vlm" and extra_batch:
        n_front = extra_batch["vision_embeds"].shape[1]
    cache = zero_cache(model, B, S + n_front + n_new, dev)
    prefill_fn, decode_fn = build_serve_fns(model)
    batch = {"tokens": prompt}
    if extra_batch:
        batch.update({k: torch.as_tensor(v, device=dev)
                      for k, v in extra_batch.items()})
    logits, cache = prefill_fn(params, batch, cache)
    out = [logits.argmax(-1).to(torch.int32)]
    idx = S + n_front
    for i in range(n_new - 1):
        logits, cache = decode_fn(params, out[-1], cache, idx + i)
        out.append(logits.argmax(-1).to(torch.int32))
    return torch.cat(out, dim=1)
