"""GQA attention block: full-sequence attention (causal prefill, the
non-causal encoder, cross-attention over an encoder's output) through the
``flash_attention`` kernel at every length, and single-token decode against
a KV cache (bf16 / float32, or int8 with per-position scales), with RoPE or
M-RoPE, sliding windows and softcap.  The counterpart of
``repro.models.attention`` on one device, for the six families.  The
reference leaves its kernel for a plain chunked version at
``s * sk >= 2048**2``; the port's kernel takes any length in O(S) memory,
so there is no such branch here.

Where the reference reads a ``REPRO_PERF`` flag (``flash_vjp``,
``decode_pet``, ``local_kv_update``) the port takes the default branch:
it has no environment switches.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_mrope, apply_rope
from repro_torch.serve import kvquant


def _rope(cfg: ModelConfig, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """pos (B, S), or (B, S, 3) position streams under M-RoPE."""
    if not cfg.use_rope:
        return x
    if cfg.use_mrope:
        return apply_mrope(x, pos, cfg.rope_theta)
    return apply_rope(x, pos, cfg.rope_theta)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, D) @ (D, H, Dh) -> (B, S, H, Dh) in x's dtype."""
    return torch.einsum("bsd,dhk->bshk", x, w.to(x.dtype))


def attention(cfg: ModelConfig, p: Dict, x: torch.Tensor, pos: torch.Tensor,
              *, causal: bool = True, window: int = 0,
              kv_x: Optional[torch.Tensor] = None,
              kv_pos: Optional[torch.Tensor] = None,
              return_kv: bool = False):
    """Full-sequence attention (prefill, encoder).  x (B, S, D), pos
    (B, S) or (B, S, 3); ``window`` > 0 lets each query see its last
    ``window`` keys only.  Cross-attention: K / V come from ``kv_x``
    (B, Sk, D), RoPE'd at ``kv_pos``.  With ``return_kv=True`` also
    returns the (B, Hkv, Sk, Dh) post-RoPE K/V pair that fills the decode
    cache."""
    src = x if kv_x is None else kv_x
    q = _rope(cfg, _proj(x, p["wq"]), pos)
    k = _rope(cfg, _proj(src, p["wk"]), pos if kv_pos is None else kv_pos)
    v = _proj(src, p["wv"])
    qh = q.transpose(1, 2).contiguous()
    kh = k.transpose(1, 2).contiguous()
    vh = v.transpose(1, 2).contiguous()
    out = ops.flash_attention(qh, kh, vh, causal=causal, window=window,
                              softcap=cfg.logit_softcap)
    out = out.transpose(1, 2)                            # (B, S, Hp, Dh)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    if return_kv:
        return y, (kh, vh)
    return y


def decode_attention(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                     pos: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cache_len: int, *,
                     window: int = 0, update_cache: bool = True,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None):
    """One-token decode: writes the new K/V at ``cache_len`` (unless
    ``update_cache=False``: the encdec cross cache, written once by the
    prefill) and attends over positions <= cache_len (and > cache_len -
    window where window > 0).  x (B, 1, D), pos (B, 1) or (B, 1, 3),
    caches (B, Hkv, Smax, Dh).  With ``k_scale`` / ``v_scale`` (B, Hkv,
    Smax, 1) float32 the caches are int8: the new entry is quantized per
    position (``kvquant.quantize``) and the scales fold into the
    contractions (``attend_q8`` / ``combine_q8``).  The reference returns
    new cache arrays; here the entry and its scales are written IN PLACE
    (no copy of the cache per token), and the tensors are returned.
    Returns (y (B, 1, D), cache_k, cache_v[, k_scale, v_scale])."""
    b = x.shape[0]
    smax, dh = cache_k.shape[2], cache_k.shape[3]
    if not 0 <= cache_len < smax:
        raise ValueError(f"decode_attention: position {cache_len} is outside "
                         f"the cache (max_seq {smax})")
    quant = k_scale is not None
    q = _rope(cfg, _proj(x, p["wq"]), pos)
    if update_cache:
        k_new = _rope(cfg, _proj(x, p["wk"]), pos)[:, 0]  # (B, Hkv, Dh)
        v_new = _proj(x, p["wv"])[:, 0]
        if quant:
            k_new, k_scale[:, :, cache_len] = kvquant.quantize(k_new)
            v_new, v_scale[:, :, cache_len] = kvquant.quantize(v_new)
        cache_k[:, :, cache_len] = k_new.to(cache_k.dtype)
        cache_v[:, :, cache_len] = v_new.to(cache_v.dtype)

    hq, hkv = q.shape[2], cache_k.shape[1]
    group = hq // hkv
    q32 = q.float() * (dh ** -0.5)                       # (B, 1, Hq, Dh)
    qg = q32.reshape(b, hkv, group, dh)
    if quant:
        logits = kvquant.attend_q8(qg, cache_k, k_scale)
    else:
        logits = torch.einsum("bhgk,bhsk->bhgs", qg, cache_k.float())
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    kpos = torch.arange(smax, device=x.device)
    valid = kpos <= cache_len
    if window > 0:
        valid &= kpos > cache_len - window
    logits = torch.where(valid, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    if quant:
        out = kvquant.combine_q8(probs, cache_v, v_scale)
    else:
        out = torch.einsum("bhgs,bhsk->bhgk", probs, cache_v.float())
    out = out.reshape(b, 1, hq, dh).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    if quant:
        return y, cache_k, cache_v, k_scale, v_scale
    return y, cache_k, cache_v
