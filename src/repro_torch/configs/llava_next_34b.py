"""LLaVA-NeXT-34B [hf:llava-hf/llava-v1.6; unverified]: dense 60L backbone;
anyres vision tiling stubbed as precomputed patch embeddings (2880 tokens)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, head_dim=128,
    n_frontend_tokens=2880, frontend_dim=1024,
    rope_theta=5000000.0, optimizer="adafactor", microbatch=8,
))
