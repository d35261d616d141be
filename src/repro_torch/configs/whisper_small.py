"""Whisper-small [arXiv:2212.04356; unverified]: enc-dec; conv frontend is a
stub (precomputed 1500-frame embeddings via input_specs)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, n_encoder_layers=12,
    d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51968, head_dim=64,   # vocab 51865 padded to a
    # multiple of 128 for tensor-parallel logits sharding (weights beyond
    # 51865 are dead; standard practice)
    n_frontend_tokens=1500, frontend_dim=768,
    optimizer="adamw", microbatch=8,
))
