"""Mamba2-130M [arXiv:2405.21060; unverified]: SSD, attention-free."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50304,                    # 50280 padded to %128 for TP
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    tie_embeddings=True, optimizer="adamw", microbatch=2,
))
