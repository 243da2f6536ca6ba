"""mamba2-1.3b — attention-free SSM (state-space duality) LM.
[arXiv:2405.21060] 48L d_model=2048 d_ff=0 vocab=50280 ssm_state=128."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_groups=1,
        tie_embeddings=True,
        norm_eps=1e-5,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=512,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_expand=2,
        ssm_groups=1,
        tie_embeddings=True,
    )
