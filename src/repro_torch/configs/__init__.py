"""Assigned architecture configs (public-literature specs; see each file).

Configs self-register into ``base._REGISTRY`` on import; use
``repro_torch.configs.base.get_config(name)`` / ``list_architectures()`` (both
lazy-load every arch module).
"""
from .base import (ModelConfig, ShapeConfig, SHAPES, applicable_shapes,
                   get_config, list_architectures, register)
