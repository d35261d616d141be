"""Uniform model API over the zoo families; the dense family is ported.

``Model`` wraps a config with family-dispatched functions:

  param_shapes / init_params(seed, device)
  prefill(params, batch, cache)              -> (logits, cache)
  decode_step(params, tokens, cache, index)  -> (logits, cache)
  cache_shapes(batch, max_len)

Copied from ``repro.models.registry``.  Caches are written in place.
``attn_backend`` picks the attention of prefill: ``auto`` launches the CUDA
flash-attention kernel on CUDA tensors (the plain version on CPU tensors),
``torch`` runs the plain version on any device.  Training (``loss``) is not
ported yet; the other families (MoE, MLA, VLM, SSM, hybrid, enc-dec) raise
``NotImplementedError`` naming their ``ROADMAP.md`` item.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from . import transformer
from ..configs.base import ModelConfig
from ..configs import base as _cfg_base
from ..kernels._common import resolve_backend, resolve_device


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    attn_backend: str = "auto"

    def __post_init__(self):
        transformer.check_supported(self.cfg)
        resolve_backend(self.attn_backend)

    def param_shapes(self):
        return transformer.param_shapes(self.cfg)

    def init_params(self, seed: Union[int, torch.Generator] = 0,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> transformer.Transformer:
        """Random parameters on ``device`` (``None``: CUDA, raising without
        a card), drawn from ``seed`` or a ``torch.Generator`` on that
        device."""
        dev = resolve_device(device)
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(seed))
        return transformer.init_params(self.cfg, gen, dev)

    def cache_shapes(self, batch: int, max_len: int):
        return transformer.cache_shapes(self.cfg, batch, max_len)

    # ---- forward paths -----------------------------------------------------
    def _fwd(self, params, batch, **kw):
        return transformer.forward(self.cfg, params, batch["tokens"],
                                   attn_backend=self.attn_backend, **kw)

    def prefill(self, params, batch, cache):
        return self._fwd(params, batch, mode="prefill", cache=cache,
                         cache_index=0)

    def decode_step(self, params, tokens, cache, index: int):
        return self._fwd(params, {"tokens": tokens}, mode="decode",
                         cache=cache, cache_index=index)


get_config = _cfg_base.get_config
list_architectures = _cfg_base.list_architectures


def get_model(name: str, smoke: bool = False,
              attn_backend: str = "auto") -> Model:
    return Model(get_config(name, smoke), attn_backend)
