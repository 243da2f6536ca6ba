"""GQA attention block: full-sequence attention (causal prefill, the
non-causal encoder, cross-attention over an encoder's output) through the
``flash_attention`` kernel at every length, and single-token decode against
a KV cache (bf16 / float32, or int8 with per-position scales), with RoPE or
M-RoPE, sliding windows and softcap.  The counterpart of
``repro.models.attention``, for the six families.  The
reference leaves its kernel for a plain chunked version at
``s * sk >= 2048**2``; the port's kernel takes any length in O(S) memory,
so there is no such branch here.

Where the reference reads a ``REPRO_PERF`` flag (``flash_vjp``,
``decode_pet``, ``local_kv_update``) the port takes the default branch:
it has no environment switches.

On a mesh (``ctx``) the heads are local: this rank holds its slice of the
query heads (``heads``) and of ``wo``'s rows, the output is the rank's
partial sum, ``reduce_from`` over the head axes.  KV heads that do not
divide the mesh stay replicated: every rank computes and caches all of
them and attends with the one each local query head uses.
A sequence-sharded cache (``seq_sharded``, the ``seq_shard`` rule: each
``data`` rank holds a slab of the positions) is written by the owning
shard only (``_sharded_kv_update``) and attended flash-decoding style: a
global max, then ``psum`` of the weighted values and of the denominators.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Axes, ShardCtx, apply_mrope, apply_rope
from repro_torch.serve import kvquant

_NO_MESH = ShardCtx()


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


def head_axes(cfg: ModelConfig, ctx: ShardCtx) -> Tuple[Axes, Axes]:
    """(query-head axes, KV-head axes) of ``cfg`` on ``ctx``'s mesh (None:
    replicated)."""
    kv = ctx.checked("kv_heads", cfg.padded_kv_heads)
    return ctx.checked("heads", cfg.padded_heads), kv


def _kv_of_local_heads(cfg: ModelConfig, ctx: ShardCtx, hq_local: int,
                       q_ax: Axes, kv_ax: Axes) -> Optional[torch.Tensor]:
    """The KV head each of this rank's query heads reads, where the KV
    tensor holds every KV head while the query heads are sharded (KV
    replicated): an index of one KV head a local query head (a rank's
    heads may straddle a group: whole groups would need the KV heads to
    divide the mesh, and then they are sharded).  None: as stored."""
    if ctx.size(q_ax) == 1 or kv_ax is not None:
        return None
    group = cfg.padded_heads // cfg.padded_kv_heads
    return (ctx.index(q_ax) * hq_local + torch.arange(hq_local)) // group


def _select_heads(x: torch.Tensor, sel: Optional[torch.Tensor]
                  ) -> torch.Tensor:
    return x if sel is None else x.index_select(1, sel.to(x.device))


def attention(cfg: ModelConfig, p: Dict, x: torch.Tensor, pos: torch.Tensor,
              *, causal: bool = True, window: int = 0,
              kv_x: Optional[torch.Tensor] = None,
              kv_pos: Optional[torch.Tensor] = None,
              return_kv: bool = False, ctx: ShardCtx = _NO_MESH):
    """Full-sequence attention (prefill, encoder).  x (B, S, D), pos
    (B, S) or (B, S, 3); ``window`` > 0 lets each query see its last
    ``window`` keys only.  Cross-attention: K / V come from ``kv_x``
    (B, Sk, D), RoPE'd at ``kv_pos``.  With ``return_kv=True`` also
    returns the (B, Hkv, Sk, Dh) post-RoPE K/V pair that fills the decode
    cache (on a mesh: the rank's KV heads, all of them where they are
    replicated)."""
    q_ax, kv_ax = head_axes(cfg, ctx)
    xc = ctx.copy_to(x, q_ax)
    src = xc if kv_x is None else ctx.copy_to(kv_x, q_ax)
    wk, wv = p["wk"], p["wv"]
    if kv_ax is None:
        # replicated KV weights feed rank-local heads: psum their grads
        wk, wv = ctx.copy_to(wk, q_ax), ctx.copy_to(wv, q_ax)
    q = _rope(cfg, _proj(xc, p["wq"]), pos)
    k = _rope(cfg, _proj(src, wk), pos if kv_pos is None else kv_pos)
    v = _proj(src, wv)
    qh = q.transpose(1, 2).contiguous()
    kh = k.transpose(1, 2).contiguous()
    vh = v.transpose(1, 2).contiguous()
    sel = _kv_of_local_heads(cfg, ctx, qh.shape[1], q_ax, kv_ax)
    out = ops.flash_attention(qh, _select_heads(kh, sel).contiguous(),
                              _select_heads(vh, sel).contiguous(),
                              causal=causal, window=window,
                              softcap=cfg.logit_softcap)
    out = out.transpose(1, 2)                            # (B, S, Hp, Dh)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    y = ctx.reduce_from(y, q_ax)
    if return_kv:
        return y, (kh, vh)
    return y


def _sharded_kv_update(cache: torch.Tensor, new: torch.Tensor,
                       cache_len: int, ctx: ShardCtx, axes: Axes) -> None:
    """Write one entry (B, H, ...) at position ``cache_len`` of a cache
    (B, H, S_loc, ...) whose positions are split over ``axes``: only the
    shard owning the position writes, in place, at its local index."""
    s_loc = cache.shape[2]
    local = cache_len - ctx.index(axes) * s_loc
    if 0 <= local < s_loc:
        cache[:, :, local] = new.to(cache.dtype)


def decode_attention(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                     pos: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cache_len: int, *,
                     window: int = 0, update_cache: bool = True,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     seq_sharded: bool = False,
                     ctx: ShardCtx = _NO_MESH):
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
    ``seq_sharded``: the caches hold this rank's slab of the positions
    (``seq_shard`` axes), every KV head.
    Returns (y (B, 1, D), cache_k, cache_v[, k_scale, v_scale])."""
    b = x.shape[0]
    s_loc, dh = cache_k.shape[2], cache_k.shape[3]
    s_ax = ctx.axes("seq_shard") if seq_sharded else None
    slab_lo = ctx.index(s_ax) * s_loc
    smax = s_loc * ctx.size(s_ax)
    if not 0 <= cache_len < smax:
        raise ValueError(f"decode_attention: position {cache_len} is outside "
                         f"the cache (max_seq {smax})")
    q_ax, kv_w_ax = head_axes(cfg, ctx)
    # A cache entry of every KV head (KV replicated, the sequence-sharded
    # cache, the encdec cross cache: cache_specs) under sharded KV
    # weights takes the rank's new heads gathered, and is read as a
    # replicated one.
    all_heads = cache_k.shape[1] == cfg.padded_kv_heads
    kv_ax = None if all_heads else kv_w_ax
    quant = k_scale is not None
    xc = ctx.copy_to(x, q_ax)
    q = _rope(cfg, _proj(xc, p["wq"]), pos)
    if update_cache:
        k_new = _rope(cfg, _proj(xc, p["wk"]), pos)[:, 0]  # (B, Hkv, Dh)
        v_new = _proj(xc, p["wv"])[:, 0]
        if all_heads:
            k_new = ctx.all_gather(k_new, kv_w_ax, dim=1)
            v_new = ctx.all_gather(v_new, kv_w_ax, dim=1)
        if quant:
            k_new, ks = kvquant.quantize(k_new)
            v_new, vs = kvquant.quantize(v_new)
            _sharded_kv_update(k_scale, ks, cache_len, ctx, s_ax)
            _sharded_kv_update(v_scale, vs, cache_len, ctx, s_ax)
        _sharded_kv_update(cache_k, k_new, cache_len, ctx, s_ax)
        _sharded_kv_update(cache_v, v_new, cache_len, ctx, s_ax)

    hq = q.shape[2]
    sel = _kv_of_local_heads(cfg, ctx, hq, q_ax, kv_ax)
    ck, cv = _select_heads(cache_k, sel), _select_heads(cache_v, sel)
    ks_l = _select_heads(k_scale, sel) if quant else None
    vs_l = _select_heads(v_scale, sel) if quant else None
    hkv = ck.shape[1]
    group = hq // hkv
    q32 = q.float() * (dh ** -0.5)                       # (B, 1, Hq, Dh)
    qg = q32.reshape(b, hkv, group, dh)
    if quant:
        logits = kvquant.attend_q8(qg, ck, ks_l)
    else:
        logits = torch.einsum("bhgk,bhsk->bhgs", qg, ck.float())
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    kpos = slab_lo + torch.arange(s_loc, device=x.device)
    valid = kpos <= cache_len
    if window > 0:
        valid &= kpos > cache_len - window
    logits = torch.where(valid, logits, -1e30)
    if ctx.size(s_ax) == 1:
        probs = torch.softmax(logits, dim=-1)
        out = (kvquant.combine_q8(probs, cv, vs_l) if quant else
               torch.einsum("bhgs,bhsk->bhgk", probs, cv.float()))
    else:
        # flash-decoding over the slabs: global max, then psum of the
        # weighted values and of the denominators
        m = ctx.all_gather(logits.amax(dim=-1, keepdim=True), s_ax)
        w = torch.exp(logits - m.amax(dim=0))
        num = (kvquant.combine_q8(w, cv, vs_l) if quant else
               torch.einsum("bhgs,bhsk->bhgk", w, cv.float()))
        num = ctx.psum(num, s_ax)
        out = num / ctx.psum(w.sum(dim=-1, keepdim=True), s_ax)
    out = out.reshape(b, 1, hq, dh).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    y = ctx.reduce_from(y, q_ax)
    if quant:
        return y, cache_k, cache_v, k_scale, v_scale
    return y, cache_k, cache_v
