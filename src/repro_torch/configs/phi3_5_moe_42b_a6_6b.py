"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE.
[hf:microsoft/Phi-3.5-MoE-instruct] 32L d_model=4096 32H (GQA kv=8)
expert d_ff=6400 vocab=32064."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=6400,
        vocab_size=32064,
        num_experts=16,
        experts_per_token=2,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        num_experts=4,
        experts_per_token=2,
    )
