"""phi3-medium-14b — dense RoPE/SwiGLU/GQA transformer.
[arXiv:2404.14219] 40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
40 heads % 16 TP != 0 -> structurally-padded to 48 (see DESIGN.md)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=10,
        head_dim=128,
        d_ff=17920,
        vocab_size=100352,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
    )
