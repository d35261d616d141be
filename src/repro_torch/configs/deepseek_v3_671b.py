"""DeepSeek-V3 671B [arXiv:2412.19437; hf]: MLA + 1 shared + 256 routed
top-8 MoE; 3 leading dense layers; MTP noted out of scope (orthogonal to the
paper's network technique)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432,                     # dense-layer FFN width
    vocab=129280, head_dim=128,
    n_experts=256, experts_per_tok=8, n_shared_experts=1,
    moe_d_ff=2048, n_dense_layers=3,
    mla=True, q_lora_rank=1536, kv_lora_rank=512,
    rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
    rope_theta=10000.0, optimizer="adafactor", microbatch=8,
    fsdp_over_pod=True,
))
