"""Forward passes of the hybrid family (zamba2: Mamba-2 layers with one
shared attention block applied every ``hybrid_attn_every`` layers):
full-sequence logits, prefill that returns the decode cache, and
single-token decode.  The counterpart of ``repro.models.transformer`` on
one device; the reference's ``lax.scan`` over stacked layers is a Python
loop over the stacked parameters here.  Every other family raises
``NotImplementedError`` (ROADMAP.md item 16).

Compute dtype: the config's (``bfloat16`` unless a caller replaces it),
with float32 master weights cast at each use, as the reference does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    activate, embed_lookup, gated, lm_logits, rms_norm,
)
from repro_torch.models.schema import require_ported


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _norm(cfg: ModelConfig, x, w):
    return rms_norm(x, w, eps=cfg.norm_eps, plus_one=cfg.sandwich_norm)


def mlp_block(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    up = torch.matmul(x, p["w_up"].to(x.dtype))
    if gated(cfg.activation):
        g = torch.matmul(x, p["w_gate"].to(x.dtype))
        h = activate(g, up, cfg.activation)
    else:
        h = activate(up, None, cfg.activation)
    return torch.matmul(h, p["w_down"].to(x.dtype))


def _dense_layer_fwd(cfg, p, x, pos):
    h = _norm(cfg, x, p["ln1"])
    x = x + attn_mod.attention(cfg, p, h, pos)
    h = _norm(cfg, x, p["ln2"])
    return x + mlp_block(cfg, p, h)


def _ssm_layer_fwd(cfg, p, x):
    h = rms_norm(x, p["ln"], eps=cfg.norm_eps)
    return x + ssm_mod.ssm_block(cfg, p, h)


def layer_params(params: Dict, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i`` of the stacked ``layers`` subtree."""
    return {k: v[i] for k, v in params["layers"].items()}


def _groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(groups, layers per group): the shared block opens each group."""
    k = cfg.hybrid_attn_every
    return cfg.num_layers // k, k


def trunk(cfg: ModelConfig, params: Dict, x: torch.Tensor,
          pos: torch.Tensor) -> torch.Tensor:
    """Token embeddings (B, S, D) -> final hidden states (hybrid)."""
    require_ported(cfg)
    groups, k = _groups(cfg)
    sp = params["shared_attn"]
    for gi in range(groups):
        x = _dense_layer_fwd(cfg, sp, x, pos)
        for li in range(gi * k, (gi + 1) * k):
            x = _ssm_layer_fwd(cfg, layer_params(params, li), x)
    return x


def _embed_in(cfg: ModelConfig, params, tokens, dtype):
    return embed_lookup(params["embed"], tokens, dtype, scale=cfg.scale_embed)


def _head_out(cfg: ModelConfig, params, x):
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps,
                 plus_one=cfg.sandwich_norm)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return lm_logits(x, head, cap=cfg.final_softcap)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def forward_logits(cfg: ModelConfig, params: Dict, batch: Dict
                   ) -> Tuple[torch.Tensor, float]:
    """Full-sequence logits (B, S, Vp) float32, and the auxiliary loss (0.0
    for this family).  batch: tokens (B, S)."""
    require_ported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed_in(cfg, params, tokens, compute_dtype(cfg))
    h = trunk(cfg, params, x, _positions(b, s, tokens.device))
    return _head_out(cfg, params, h), 0.0


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Decode cache (hybrid): per-layer conv and SSM state in float32, one
    K/V pair per shared-block application in ``dtype``.  ``len`` is the
    number of positions filled, a Python int (the reference keeps an int32
    device scalar)."""
    require_ported(cfg)
    b, L = batch_size, cfg.num_layers
    groups, _ = _groups(cfg)
    conv_c = cfg.ssm_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    hkv, dh = cfg.padded_kv_heads, cfg.head_dim
    f32 = torch.float32
    return {
        "len": 0,
        "conv": torch.zeros((L, b, cfg.ssm_conv_width - 1, conv_c),
                            dtype=f32, device=device),
        "ssm": torch.zeros((L, b, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state), dtype=f32, device=device),
        "k": torch.zeros((groups, b, hkv, max_seq, dh), dtype=dtype,
                         device=device),
        "v": torch.zeros((groups, b, hkv, max_seq, dh), dtype=dtype,
                         device=device),
    }


def prefill_forward(cfg: ModelConfig, params: Dict, batch: Dict, *,
                    max_seq: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process a full prompt and RETURN THE DECODE CACHE.  batch: tokens
    (B, S).  Returns (last-token logits (B, Vp) float32, cache ready for
    ``decode_step`` at position S).  ``max_seq`` reserves cache room beyond
    the prompt (default S).  Each shared-block application goes through
    the ``flash_attention`` kernel (below 2048**2 query-key pairs) and each
    Mamba-2 layer through the ``ssd_scan`` kernel."""
    require_ported(cfg)
    dtype = compute_dtype(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    max_seq = max_seq or s
    if max_seq < s:
        raise ValueError(f"prefill_forward: max_seq={max_seq} < prompt {s}")
    x = _embed_in(cfg, params, tokens, dtype)
    pos = _positions(b, s, tokens.device)
    cache = init_cache(cfg, b, max_seq, dtype=dtype, device=tokens.device)
    cache["len"] = s
    groups, k = _groups(cfg)
    sp = params["shared_attn"]
    for gi in range(groups):
        hh = _norm(cfg, x, sp["ln1"])
        a, (kh, vh) = attn_mod.attention(cfg, sp, hh, pos, return_kv=True)
        cache["k"][gi, :, :, :s] = kh
        cache["v"][gi, :, :, :s] = vh
        x = x + a
        hh = _norm(cfg, x, sp["ln2"])
        x = x + mlp_block(cfg, sp, hh)
        for li in range(gi * k, (gi + 1) * k):
            pl = layer_params(params, li)
            hn = rms_norm(x, pl["ln"], eps=cfg.norm_eps)
            y, cache["conv"][li], cache["ssm"][li] = ssm_mod.ssm_block(
                cfg, pl, hn, return_state=True)
            x = x + y
    logits = _head_out(cfg, params, x[:, -1:])[:, 0]
    return logits, cache


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                batch: Dict) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step.  batch: tokens (B, 1).  Returns (logits (B, Vp)
    float32, cache).  The cache is updated IN PLACE, its tensors and its
    ``len`` (one more), and the same dict is returned (the reference
    returns new arrays; a copy of the whole cache per token would double
    its traffic)."""
    require_ported(cfg)
    dtype = compute_dtype(cfg)
    tokens = batch["tokens"]
    b = tokens.shape[0]
    x = _embed_in(cfg, params, tokens, dtype)
    clen = int(cache["len"])
    pos = torch.full((b, 1), clen, dtype=torch.int64, device=tokens.device)
    groups, k = _groups(cfg)
    sp = params["shared_attn"]
    for gi in range(groups):
        hh = _norm(cfg, x, sp["ln1"])
        a, _, _ = attn_mod.decode_attention(
            cfg, sp, hh, pos, cache["k"][gi], cache["v"][gi], clen)
        x = x + a
        hh = _norm(cfg, x, sp["ln2"])
        x = x + mlp_block(cfg, sp, hh)
        for li in range(gi * k, (gi + 1) * k):
            pl = layer_params(params, li)
            hn = rms_norm(x, pl["ln"], eps=cfg.norm_eps)
            y, conv_l, ssm_l = ssm_mod.ssm_decode(
                cfg, pl, hn, cache["conv"][li], cache["ssm"][li])
            cache["conv"][li] = conv_l
            cache["ssm"][li] = ssm_l
            x = x + y
    cache["len"] = clen + 1
    logits = _head_out(cfg, params, x)[:, 0]
    return logits, cache
