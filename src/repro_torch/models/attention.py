"""GQA attention block: causal prefill through the ``flash_attention``
kernel at every length, and single-token decode against a KV cache, with
RoPE and softcap.  The counterpart of ``repro.models.attention`` on one
device, for the hybrid family.  The reference leaves its kernel for a
plain chunked version at ``s * sk >= 2048**2``; the port's kernel takes
any length in O(S) memory, so there is no such branch here.

Where the reference reads a ``REPRO_PERF`` flag (``flash_vjp``,
``decode_pet``, ``local_kv_update``) the port takes the default branch:
it has no environment switches.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope


def _rope(cfg: ModelConfig, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    if not cfg.use_rope:
        return x
    if cfg.use_mrope:
        raise NotImplementedError("M-RoPE is not ported yet (ROADMAP.md "
                                  "item 16)")
    return apply_rope(x, pos, cfg.rope_theta)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, D) @ (D, H, Dh) -> (B, S, H, Dh) in x's dtype."""
    return torch.einsum("bsd,dhk->bshk", x, w.to(x.dtype))


def attention(cfg: ModelConfig, p: Dict, x: torch.Tensor, pos: torch.Tensor,
              *, return_kv: bool = False):
    """Full-sequence causal self-attention (prefill).  x (B, S, D), pos
    (B, S).  With ``return_kv=True`` also returns the (B, Hkv, S, Dh)
    post-RoPE K/V pair that fills the decode cache.  The sliding window and
    cross-attention of other families are not ported (ROADMAP.md item
    16)."""
    q = _rope(cfg, _proj(x, p["wq"]), pos)
    k = _rope(cfg, _proj(x, p["wk"]), pos)
    v = _proj(x, p["wv"])
    qh = q.transpose(1, 2).contiguous()
    kh = k.transpose(1, 2).contiguous()
    vh = v.transpose(1, 2).contiguous()
    out = ops.flash_attention(qh, kh, vh, softcap=cfg.logit_softcap)
    out = out.transpose(1, 2)                            # (B, S, Hp, Dh)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    if return_kv:
        return y, (kh, vh)
    return y


def decode_attention(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                     pos: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cache_len: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode: writes the new K/V at ``cache_len`` and attends
    over positions <= cache_len.  x (B, 1, D), pos (B, 1), caches
    (B, Hkv, Smax, Dh).  The reference returns new cache arrays; here the
    entry is written into ``cache_k`` / ``cache_v`` IN PLACE (no copy of the
    cache per token), and they are returned.  Returns (y (B, 1, D),
    cache_k, cache_v)."""
    b = x.shape[0]
    smax, dh = cache_k.shape[2], cache_k.shape[3]
    if not 0 <= cache_len < smax:
        raise ValueError(f"decode_attention: position {cache_len} is outside "
                         f"the cache (max_seq {smax})")
    q = _rope(cfg, _proj(x, p["wq"]), pos)
    k_new = _rope(cfg, _proj(x, p["wk"]), pos)
    v_new = _proj(x, p["wv"])
    cache_k[:, :, cache_len] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, :, cache_len] = v_new[:, 0].to(cache_v.dtype)

    hq, hkv = q.shape[2], cache_k.shape[1]
    group = hq // hkv
    q32 = q.float() * (dh ** -0.5)                       # (B, 1, Hq, Dh)
    qg = q32.reshape(b, hkv, group, dh)
    logits = torch.einsum("bhgk,bhsk->bhgs", qg, cache_k.float())
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    kpos = torch.arange(smax, device=x.device)
    logits = torch.where(kpos <= cache_len, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bhsk->bhgk", probs, cache_v.float())
    out = out.reshape(b, 1, hq, dh).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return y, cache_k, cache_v
