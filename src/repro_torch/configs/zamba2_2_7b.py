"""zamba2-2.7b — hybrid Mamba2 backbone + one SHARED attention block
applied periodically.  [arXiv:2411.15242] 54L d_model=2560 32H (kv=32)
d_ff=10240 vocab=32000 ssm_state=64."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab_size=32000,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_groups=1,
        hybrid_attn_every=6,  # shared block fires 9 times over 54 layers
        norm_eps=1e-5,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        family="hybrid",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_expand=2,
        ssm_groups=1,
        hybrid_attn_every=2,
    )
