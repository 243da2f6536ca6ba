"""whisper-small — encoder-decoder audio transformer backbone.
[arXiv:2212.04356] 12L(enc)+12L(dec) d_model=768 12H d_ff=3072 vocab=51865.
The conv audio frontend is a STUB: input_specs() provides precomputed
1500-frame embeddings (B, 1500, d_model)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="encdec",
        num_layers=12,
        encoder_layers=12,
        encoder_seq=1500,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=51865,
        activation="gelu",
        use_rope=False,  # learned absolute positions
        norm_eps=1e-5,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        family="encdec",
        num_layers=2,
        encoder_layers=2,
        encoder_seq=32,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        activation="gelu",
        use_rope=False,
    )
