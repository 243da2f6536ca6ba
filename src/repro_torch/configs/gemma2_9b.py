"""gemma2-9b — dense GQA with alternating local/global attention and
logit soft-capping.  [arXiv:2408.00118; hf] 42L d_model=3584 16H (kv=8)
d_ff=14336 vocab=256000, head_dim=256, window=4096."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        num_layers=42,
        d_model=3584,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256_000,
        activation="geglu",
        alt_local_global=True,
        attn_window=4096,
        logit_softcap=50.0,
        final_softcap=30.0,
        sandwich_norm=True,
        scale_embed=True,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        activation="geglu",
        alt_local_global=True,
        attn_window=16,
        logit_softcap=50.0,
        final_softcap=30.0,
        sandwich_norm=True,
        scale_embed=True,
        tie_embeddings=True,
    )
