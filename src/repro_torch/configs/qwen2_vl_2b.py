"""qwen2-vl-2b — VLM transformer BACKBONE with M-RoPE.
[arXiv:2409.12191; hf] 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936.  The vision frontend is a STUB: input_specs() provides
precomputed patch embeddings merged into the token stream plus 3-D
M-RoPE position ids."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b",
        family="vlm",
        num_layers=28,
        d_model=1536,
        num_heads=12,
        num_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151936,
        use_mrope=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        use_mrope=True,
        tie_embeddings=True,
    )
