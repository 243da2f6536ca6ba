"""Forward passes of the families the port serves: full-sequence logits,
prefill that returns the decode cache, and single-token decode.

- ``dense`` (gemma2, phi3, phi4, starcoder2) and ``vlm`` (qwen2-vl, the
  dense trunk with M-RoPE positions ``batch["pos"]`` (B, S, 3)): a stack of
  attention + MLP blocks; gemma2 alternates a local layer (2i, sliding
  window ``attn_window``) with a global one (2i + 1) and wraps attention and
  MLP in sandwich norms.  Their KV cache may be int8
  (``init_cache(kv_quant=True)``).
- ``ssm`` (mamba2): a stack of Mamba-2 layers.
- ``hybrid`` (zamba2): Mamba-2 layers with one shared attention block
  applied every ``hybrid_attn_every`` layers.

The counterpart of ``repro.models.transformer`` on one device; the
reference's ``lax.scan`` over stacked layers is a Python loop over the
stacked parameters here.  ``moe`` and ``encdec`` raise
``NotImplementedError`` (ROADMAP.md item 16).

Compute dtype: the config's (``bfloat16`` unless a caller replaces it),
with float32 master weights cast at each use, as the reference does.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

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


def _dense_block(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                 attend: Callable[[torch.Tensor], torch.Tensor]
                 ) -> torch.Tensor:
    """One attention + MLP block; ``attend`` maps the normed input to the
    attention output.  Sandwich norms (gemma2) after attention and MLP."""
    a = attend(_norm(cfg, x, p["ln1"]))
    if cfg.sandwich_norm:
        a = _norm(cfg, a, p["ln1_post"])
    x = x + a
    m = mlp_block(cfg, p, _norm(cfg, x, p["ln2"]))
    if cfg.sandwich_norm:
        m = _norm(cfg, m, p["ln2_post"])
    return x + m


def _ssm_layer_fwd(cfg, p, x):
    h = rms_norm(x, p["ln"], eps=cfg.norm_eps)
    return x + ssm_mod.ssm_block(cfg, p, h)


def layer_params(params: Dict, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i`` of the stacked ``layers`` subtree."""
    return {k: v[i] for k, v in params["layers"].items()}


def layer_window(cfg: ModelConfig, i: int) -> int:
    """The sliding window of dense layer ``i``: gemma2's layer 2i is local
    (``attn_window``), 2i + 1 global; 0 (full attention) elsewhere."""
    return cfg.attn_window if cfg.alt_local_global and i % 2 == 0 else 0


def _groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(groups, layers per group) of the hybrid family: the shared block
    opens each group."""
    k = cfg.hybrid_attn_every
    return cfg.num_layers // k, k


def trunk(cfg: ModelConfig, params: Dict, x: torch.Tensor,
          pos: torch.Tensor) -> torch.Tensor:
    """Token embeddings (B, S, D) -> final hidden states."""
    require_ported(cfg)
    if cfg.family in ("dense", "vlm"):
        for li in range(cfg.num_layers):
            pl, win = layer_params(params, li), layer_window(cfg, li)
            x = _dense_block(cfg, pl, x, lambda h: attn_mod.attention(
                cfg, pl, h, pos, window=win))
        return x
    if cfg.family == "ssm":
        for li in range(cfg.num_layers):
            x = _ssm_layer_fwd(cfg, layer_params(params, li), x)
        return x
    groups, k = _groups(cfg)
    sp = params["shared_attn"]
    for gi in range(groups):
        x = _dense_block(cfg, sp, x,
                         lambda h: attn_mod.attention(cfg, sp, h, pos))
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


def _positions(cfg: ModelConfig, batch: Dict, b: int, s: int,
               device) -> torch.Tensor:
    """``batch["pos"]`` (B, S, 3) under M-RoPE, else 0..S-1 per row."""
    if cfg.use_mrope:
        return batch["pos"]
    return torch.arange(s, device=device)[None].expand(b, s)


def forward_logits(cfg: ModelConfig, params: Dict, batch: Dict
                   ) -> Tuple[torch.Tensor, float]:
    """Full-sequence logits (B, S, Vp) float32, and the auxiliary loss (0.0
    for these families).  batch: tokens (B, S) [+ pos (B, S, 3) vlm]."""
    require_ported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed_in(cfg, params, tokens, compute_dtype(cfg))
    h = trunk(cfg, params, x, _positions(cfg, batch, b, s, tokens.device))
    return _head_out(cfg, params, h), 0.0


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int,
               dtype=torch.bfloat16, device=None,
               kv_quant: bool = False) -> Dict[str, Any]:
    """Decode cache.  dense / vlm: one K/V pair per layer in ``dtype``, or
    with ``kv_quant=True`` int8 K/V plus per-position float32 scales
    ``k_scale`` / ``v_scale`` (L, B, Hkv, Smax, 1) (``serve/kvquant.py``;
    the other families keep their cache as it is, as in the reference).
    ssm: per-layer conv and SSM state in float32.  hybrid: both, with one
    K/V pair per shared-block application.  ``len`` is the number of
    positions filled, a Python int (the reference keeps an int32 device
    scalar)."""
    require_ported(cfg)
    b, L = batch_size, cfg.num_layers
    hkv, dh = cfg.padded_kv_heads, cfg.head_dim
    f32 = torch.float32
    cache: Dict[str, Any] = {"len": 0}
    if cfg.family in ("dense", "vlm"):
        kv_dtype = torch.int8 if kv_quant else dtype
        for key in ("k", "v"):
            cache[key] = torch.zeros((L, b, hkv, max_seq, dh), dtype=kv_dtype,
                                     device=device)
        if kv_quant:
            for key in ("k_scale", "v_scale"):
                cache[key] = torch.zeros((L, b, hkv, max_seq, 1), dtype=f32,
                                         device=device)
        return cache
    conv_c = cfg.ssm_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    cache["conv"] = torch.zeros((L, b, cfg.ssm_conv_width - 1, conv_c),
                                dtype=f32, device=device)
    cache["ssm"] = torch.zeros((L, b, cfg.ssm_heads, cfg.ssm_head_dim,
                                cfg.ssm_state), dtype=f32, device=device)
    if cfg.family == "hybrid":
        groups, _ = _groups(cfg)
        for key in ("k", "v"):
            cache[key] = torch.zeros((groups, b, hkv, max_seq, dh),
                                     dtype=dtype, device=device)
    return cache


def _ssm_prefill(cfg, params, cache, li, x):
    """Mamba-2 layer ``li`` over the prompt; its states into the cache."""
    pl = layer_params(params, li)
    hn = rms_norm(x, pl["ln"], eps=cfg.norm_eps)
    y, cache["conv"][li], cache["ssm"][li] = ssm_mod.ssm_block(
        cfg, pl, hn, return_state=True)
    return x + y


def prefill_forward(cfg: ModelConfig, params: Dict, batch: Dict, *,
                    max_seq: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process a full prompt and RETURN THE DECODE CACHE.  batch: tokens
    (B, S) [+ pos (B, S, 3) vlm].  Returns (last-token logits (B, Vp)
    float32, cache ready for ``decode_step`` at position S, in the compute
    dtype: only ``init_cache`` makes an int8 cache, as in the reference).
    ``max_seq`` reserves cache room beyond the prompt (default S).  Each
    attention layer goes through the ``flash_attention`` kernel at every
    length (with the layer's window) and each Mamba-2 layer through the
    ``ssd_scan`` kernel."""
    require_ported(cfg)
    dtype = compute_dtype(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    max_seq = max_seq or s
    if max_seq < s:
        raise ValueError(f"prefill_forward: max_seq={max_seq} < prompt {s}")
    x = _embed_in(cfg, params, tokens, dtype)
    pos = _positions(cfg, batch, b, s, tokens.device)
    cache = init_cache(cfg, b, max_seq, dtype=dtype, device=tokens.device)
    cache["len"] = s

    def attend_into(p, slot, window=0):
        def attend(h):
            a, (kh, vh) = attn_mod.attention(cfg, p, h, pos, window=window,
                                             return_kv=True)
            cache["k"][slot, :, :, :s] = kh
            cache["v"][slot, :, :, :s] = vh
            return a
        return attend

    if cfg.family in ("dense", "vlm"):
        for li in range(cfg.num_layers):
            pl = layer_params(params, li)
            x = _dense_block(cfg, pl, x,
                             attend_into(pl, li, layer_window(cfg, li)))
    elif cfg.family == "ssm":
        for li in range(cfg.num_layers):
            x = _ssm_prefill(cfg, params, cache, li, x)
    else:
        groups, k = _groups(cfg)
        sp = params["shared_attn"]
        for gi in range(groups):
            x = _dense_block(cfg, sp, x, attend_into(sp, gi))
            for li in range(gi * k, (gi + 1) * k):
                x = _ssm_prefill(cfg, params, cache, li, x)
    logits = _head_out(cfg, params, x[:, -1:])[:, 0]
    return logits, cache


def _ssm_step(cfg, params, cache, li, x):
    """Mamba-2 layer ``li`` on one token; its states updated in place."""
    pl = layer_params(params, li)
    hn = rms_norm(x, pl["ln"], eps=cfg.norm_eps)
    y, cache["conv"][li], cache["ssm"][li] = ssm_mod.ssm_decode(
        cfg, pl, hn, cache["conv"][li], cache["ssm"][li])
    return x + y


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                batch: Dict) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step.  batch: tokens (B, 1) [+ pos (B, 1, 3) vlm].
    Returns (logits (B, Vp) float32, cache).  The cache is updated IN
    PLACE, its tensors and its ``len`` (one more), and the same dict is
    returned (the reference returns new arrays; a copy of the whole cache
    per token would double its traffic)."""
    require_ported(cfg)
    dtype = compute_dtype(cfg)
    tokens = batch["tokens"]
    b = tokens.shape[0]
    x = _embed_in(cfg, params, tokens, dtype)
    clen = int(cache["len"])
    if cfg.use_mrope:
        pos = batch["pos"]
    else:
        pos = torch.full((b, 1), clen, dtype=torch.int64,
                         device=tokens.device)

    def attend_at(p, slot, window=0):
        scales = {}
        if "k_scale" in cache:
            scales = dict(k_scale=cache["k_scale"][slot],
                          v_scale=cache["v_scale"][slot])

        def attend(h):
            return attn_mod.decode_attention(
                cfg, p, h, pos, cache["k"][slot], cache["v"][slot], clen,
                window=window, **scales)[0]
        return attend

    if cfg.family in ("dense", "vlm"):
        for li in range(cfg.num_layers):
            pl = layer_params(params, li)
            x = _dense_block(cfg, pl, x,
                             attend_at(pl, li, layer_window(cfg, li)))
    elif cfg.family == "ssm":
        for li in range(cfg.num_layers):
            x = _ssm_step(cfg, params, cache, li, x)
    else:
        groups, k = _groups(cfg)
        sp = params["shared_attn"]
        for gi in range(groups):
            x = _dense_block(cfg, sp, x, attend_at(sp, gi))
            for li in range(gi * k, (gi + 1) * k):
                x = _ssm_step(cfg, params, cache, li, x)
    cache["len"] = clen + 1
    logits = _head_out(cfg, params, x)[:, 0]
    return logits, cache
