"""qwen3-moe-235b-a22b — 128-expert top-8 MoE.
[hf:Qwen/Qwen3-30B-A3B family scaling] 94L d_model=4096 64H (GQA kv=4)
expert d_ff=1536 vocab=151936."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        head_dim=128,
        d_ff=1536,
        vocab_size=151936,
        num_experts=128,
        experts_per_token=8,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=512,
        num_experts=8,
        experts_per_token=2,
    )
