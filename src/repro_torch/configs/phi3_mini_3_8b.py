"""phi3-mini-3.8B [arXiv:2404.14219; unverified]: dense, MHA (kv == heads)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064, head_dim=96,
    rope_theta=10000.0, optimizer="adamw", microbatch=4,
))
