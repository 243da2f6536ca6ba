"""Model/config system: the port's own copy of ``repro.configs.base``.

One frozen dataclass describes every architecture family the framework
supports (dense / MoE / SSM / hybrid / enc-dec / VLM backbones).  Each
assigned architecture contributes a module in repro_torch/configs with
``config()`` (the exact published shape) and ``smoke_config()`` (a
reduced same-family shape for CPU tests).  The modules are pure data and
equal to the reference's field for field; the two packages share no
module.  Of the families, the port serves hybrid, ssm, dense and vlm.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Dict, Optional, Tuple

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")

# Production TP padding targets (see DESIGN.md: heads/vocab must divide
# the model-parallel axis of the production mesh).
TP_AXIS = 16
VOCAB_PAD = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # --- SSM (mamba2 / hybrid) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_conv_width: int = 4

    # --- hybrid (zamba2-style shared attention) ---
    hybrid_attn_every: int = 0  # apply the shared attn block every N ssm layers

    # --- attention features ---
    rope_theta: float = 10_000.0
    use_mrope: bool = False          # qwen2-vl
    attn_window: int = 0             # sliding-window size for local layers
    alt_local_global: bool = False   # gemma2: alternate local/global layers
    logit_softcap: float = 0.0       # gemma2 attention soft-cap
    final_softcap: float = 0.0       # gemma2 final-logit soft-cap
    sandwich_norm: bool = False      # gemma2 pre+post block norms
    scale_embed: bool = False        # gemma2 sqrt(d_model) embedding scale

    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0             # whisper: 1500 precomputed frames
    use_rope: bool = True            # whisper uses learned absolute pos

    # --- misc ---
    activation: str = "swiglu"       # "swiglu" | "gelu"
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context (500k) decode is supported (SSM/hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def padded_vocab(self) -> int:
        return math.ceil(self.vocab_size / VOCAB_PAD) * VOCAB_PAD

    @property
    def padded_heads(self) -> int:
        """Q heads padded to the TP axis multiple (structural-zero heads;
        see DESIGN.md §hardware-adaptation).  Padding preserves the GQA
        group structure (padded % group == 0) so real query heads keep
        their original KV-head mapping."""
        if self.num_heads % TP_AXIS == 0:
            return self.num_heads
        group = self.num_heads // max(self.num_kv_heads, 1)
        step = TP_AXIS * group // math.gcd(TP_AXIS, group)  # lcm
        return math.ceil(self.num_heads / step) * step

    @property
    def padded_kv_heads(self) -> int:
        """KV heads are padded with the same group structure when padding
        Q heads; otherwise left as-is (replicated over TP if indivisible)."""
        if self.padded_heads == self.num_heads:
            return self.num_kv_heads
        group = self.num_heads // self.num_kv_heads
        return self.padded_heads // group

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (unpadded), for 6ND model-FLOP math."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        n = emb
        hd = self.head_dim

        def attn_params():
            return d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
                + self.num_heads * hd * d

        def mlp_params(ff):
            mults = 3 if self.activation in ("swiglu", "geglu") else 2
            return mults * d * ff

        if self.family in ("dense", "vlm"):
            n += self.num_layers * (attn_params() + mlp_params(f) + 2 * d)
        elif self.family == "moe":
            n += self.num_layers * (
                attn_params() + self.num_experts * mlp_params(f)
                + d * self.num_experts + 2 * d
            )
        elif self.family == "ssm":
            di, g, s, h = self.ssm_inner, self.ssm_groups, self.ssm_state, self.ssm_heads
            in_proj = d * (2 * di + 2 * g * s + h)
            n += self.num_layers * (in_proj + di * d + 2 * d + h)
        elif self.family == "hybrid":
            di, g, s, h = self.ssm_inner, self.ssm_groups, self.ssm_state, self.ssm_heads
            in_proj = d * (2 * di + 2 * g * s + h)
            n += self.num_layers * (in_proj + di * d + 2 * d + h)
            n += attn_params() + mlp_params(f) + 2 * d  # one shared block
        elif self.family == "encdec":
            n += self.encoder_layers * (attn_params() + mlp_params(f) + 2 * d)
            # decoder: self-attn + cross-attn + mlp
            n += self.num_layers * (2 * attn_params() + mlp_params(f) + 3 * d)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mults = 3 if self.activation in ("swiglu", "geglu") else 2
        dense_experts = self.num_layers * self.num_experts * mults * d * f
        active_experts = self.num_layers * self.experts_per_token * mults * d * f
        return self.param_count() - dense_experts + active_experts


# ---------------------------------------------------------------------------
# Input shapes (assigned shape set for the LM families)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = (
    "mamba2-1.3b",
    "whisper-small",
    "qwen3-moe-235b-a22b",
    "phi3.5-moe-42b-a6.6b",
    "zamba2-2.7b",
    "phi3-medium-14b",
    "starcoder2-15b",
    "phi4-mini-3.8b",
    "gemma2-9b",
    "qwen2-vl-2b",
)

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(_MODULES[arch])
    return mod.config()


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(_MODULES[arch])
    return mod.smoke_config()


def cells(arch: str) -> Tuple[str, ...]:
    """The dry-run cells (shape names) assigned to this arch: decode/long
    rules from the assignment (see DESIGN.md §Arch-applicability)."""
    cfg = get_config(arch)
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return tuple(out)
