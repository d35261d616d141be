"""Uniform model API over the zoo families: dense, MoE and VLM
(``transformer``), SSM (``mamba2``), hybrid (``hybrid``) and enc-dec
(``encdec``).

``Model`` wraps a config with family-dispatched functions:

  param_shapes / init_params(seed, device)
  loss(params, batch)                        -> scalar LM loss
  prefill(params, batch, cache)              -> (logits, cache)
  decode_step(params, tokens, cache, index)  -> (logits, cache)
  cache_shapes(batch, max_len) / cache_batch_axes()

Copied from ``repro.models.registry``.  Batch layout: ``{"tokens": (B, S)
int}`` plus, per family, ``"vision_embeds"`` (VLM: (B, n_front,
frontend_dim), put before the tokens) or ``"frames"`` (enc-dec: (B, T,
frontend_dim) for the encoder).  Caches are written in place.
``backend`` is the kernels' switch: ``auto`` launches the CUDA kernels
(flash attention in prefill and in the enc-dec's encoder and cross
attention, the SSD scan in a Mamba2 layer's prefill) on CUDA tensors and
runs their plain versions on CPU tensors; ``torch`` runs the plain versions
on any device.  ``loss`` is next-token cross-entropy over the tokens
(frontend positions excluded), differentiable through every family: the
trainer turns gradients on for the parameters (created without; their
module's ``tree()`` gives them as the reference's tree), and on the card
the attention kernel's and the SSD scan kernel's gradients are their
backward kernels (``flash_attn/ops.FlashAttention``,
``ssd_scan/ops.SSDScan``; under remat the forward kernels run again).
``prefill`` and ``decode_step`` run without autograd, whatever the
parameters.
"""
from __future__ import annotations

import dataclasses
from types import ModuleType
from typing import Optional, Union

import torch

from . import encdec, hybrid, mamba2, transformer
from ..configs.base import ModelConfig
from ..configs import base as _cfg_base
from ..kernels._common import resolve_backend, resolve_device

_FAMILIES = {"dense": transformer, "moe": transformer, "vlm": transformer,
             "ssm": mamba2, "hybrid": hybrid, "encdec": encdec}


def xent(logits: torch.Tensor, labels: torch.Tensor,
         mask: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over the mask, on float32 log-softmax
    (``repro.models.registry._xent``)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def family_module(cfg: ModelConfig) -> ModuleType:
    """The port's module of the config's family (``param_shapes``,
    ``new_params``, ``init_rule``, ``STACKED``, ``init_params``,
    ``forward``, ``cache_shapes``, ``cache_batch_axes``)."""
    mod = _FAMILIES.get(cfg.family)
    if mod is None:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    return mod


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    backend: str = "auto"

    def __post_init__(self):
        family_module(self.cfg)
        resolve_backend(self.backend)

    @property
    def _mod(self) -> ModuleType:
        return family_module(self.cfg)

    def param_shapes(self):
        return self._mod.param_shapes(self.cfg)

    def init_params(self, seed: Union[int, torch.Generator] = 0,
                    device: Optional[Union[str, torch.device]] = None):
        """Random parameters on ``device`` (``None``: CUDA, raising without
        a card), drawn from ``seed`` or a ``torch.Generator`` on that
        device by the family's init rule."""
        dev = resolve_device(device)
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(seed))
        return self._mod.init_params(self.cfg, gen, dev)

    def cache_shapes(self, batch: int, max_len: int):
        """The cache's tree of ``(shape, dtype)`` leaves."""
        return self._mod.cache_shapes(self.cfg, batch, max_len)

    def cache_batch_axes(self):
        """The batch axis of each cache leaf, in the tree of
        ``cache_shapes``."""
        return self._mod.cache_batch_axes(self.cfg)

    # ---- forward paths -----------------------------------------------------
    def _fwd(self, params, batch, **kw):
        fam = self.cfg.family
        if fam == "encdec":
            kw["frames"] = batch.get("frames")
        elif fam == "vlm":
            kw["vision_embeds"] = batch.get("vision_embeds")
        return self._mod.forward(self.cfg, params, batch["tokens"],
                                 backend=self.backend, **kw)

    def loss(self, params, batch):
        logits = self._fwd(params, batch, mode="train")
        tokens = batch["tokens"]
        S = tokens.shape[1]
        # frontend positions (vision/audio) are excluded from the loss: the
        # logits tail [-S:] aligns with the token stream.
        logits = logits[:, -S:]
        labels = tokens[:, 1:]
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
        return xent(logits[:, :-1], labels, mask)

    @torch.no_grad()
    def prefill(self, params, batch, cache):
        return self._fwd(params, batch, mode="prefill", cache=cache,
                         cache_index=0)

    @torch.no_grad()
    def decode_step(self, params, tokens, cache, index: int):
        return self._fwd(params, {"tokens": tokens}, mode="decode",
                         cache=cache, cache_index=index)


get_config = _cfg_base.get_config
list_architectures = _cfg_base.list_architectures


def get_model(name: str, smoke: bool = False, backend: str = "auto") -> Model:
    return Model(get_config(name, smoke), backend)
