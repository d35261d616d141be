"""Model / run configuration system (plain dataclasses and the registry).

Every assigned architecture is a ``ModelConfig`` in ``repro_torch/configs/<id>.py``;
``repro_torch.configs.get_config(name)`` resolves either a full config or its reduced
smoke-test variant.  Input shapes are the four assigned cells; ``long_500k``
only applies to sub-quadratic (SSM/hybrid) families.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # --- MoE ---
    n_experts: int = 0
    experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    n_dense_layers: int = 0        # leading dense layers (DeepSeek-V3: 3)
    capacity_factor: float = 1.25
    moe_impl: str = "a2a"          # a2a | rotation | dense

    # --- MLA (DeepSeek) ---
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # --- SSM (Mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_conv: int = 4

    # --- hybrid (Zamba2) ---
    shared_attn_every: int = 0     # apply the shared attention block every N

    # --- enc-dec (Whisper) ---
    n_encoder_layers: int = 0
    n_frontend_tokens: int = 0     # stub frontend sequence (audio frames /
    frontend_dim: int = 0          # vision patches), pre-embedded

    # --- training ---
    optimizer: str = "adamw"       # adamw | adafactor
    remat: bool = True
    microbatch: int = 0            # 0 = auto
    # dry-run probe flag of the model zoo: unroll layer scans so a cost
    # analysis counts every layer
    scan_unroll: bool = False
    # 100B+ archs: FSDP params/grads across pods too (ZeRO-3 over the DCN)
    fsdp_over_pod: bool = False
    # remat policy: 'nothing' (recompute all) | 'dots' (save matmul outputs)
    remat_policy: str = "nothing" 

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def is_subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode path

    def scaled_down(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        def shrink(v, lo, fac):
            return max(lo, v // fac)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4 if self.shared_attn_every else 2),
            n_encoder_layers=min(self.n_encoder_layers, 2),
            d_model=128, d_ff=256, moe_d_ff=64 if self.moe_d_ff else 0,
            n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=32, vocab=512,
            n_experts=min(self.n_experts, 8),
            experts_per_tok=min(self.experts_per_tok, 2),
            n_dense_layers=min(self.n_dense_layers, 1),
            q_lora_rank=64 if self.q_lora_rank else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            rope_head_dim=16 if self.mla else self.rope_head_dim,
            nope_head_dim=32 if self.mla else self.nope_head_dim,
            v_head_dim=32 if self.mla else self.v_head_dim,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            shared_attn_every=2 if self.shared_attn_every else 0,
            n_frontend_tokens=min(self.n_frontend_tokens, 16),
            frontend_dim=128 if self.frontend_dim else 0,
            dtype="float32", microbatch=1,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> Tuple[str, ...]:
    """The assigned cells for this arch.  ``long_500k`` needs sub-quadratic
    attention: run for SSM/hybrid, skip for full-attention archs."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.is_subquadratic:
        names.append("long_500k")
    return tuple(names)


# ---------------------------------------------------------------------------
# Registry (configs register themselves on import; loaded lazily to avoid
# circular imports with the model modules).
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}
_ARCH_MODULES = (
    "phi4_mini_3_8b", "phi3_mini_3_8b", "yi_6b", "qwen1_5_4b",
    "deepseek_v3_671b", "qwen3_moe_30b_a3b", "mamba2_130m", "whisper_small",
    "zamba2_2_7b", "llava_next_34b",
)


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _load_all():
    import importlib
    for mod in _ARCH_MODULES:
        importlib.import_module(f"{__package__}.{mod}")


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _REGISTRY:
        _load_all()
    cfg = _REGISTRY[name]
    return cfg.scaled_down() if smoke else cfg


def list_architectures():
    _load_all()
    return sorted(_REGISTRY)
