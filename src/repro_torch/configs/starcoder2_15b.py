"""starcoder2-15b — dense GQA + RoPE code LM.
[arXiv:2402.19173; hf] 40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b",
        family="dense",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=4,
        head_dim=128,
        d_ff=24576,
        vocab_size=49152,
        activation="gelu",
        norm_eps=1e-5,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        activation="gelu",
    )
