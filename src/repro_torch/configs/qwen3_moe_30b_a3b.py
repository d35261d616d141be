"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B; hf]: 128 experts top-8, GQA kv=4."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, moe_d_ff=768, vocab=151936, head_dim=128,
    n_experts=128, experts_per_tok=8, n_dense_layers=0,
    rope_theta=1000000.0, optimizer="adamw", microbatch=4,
))
