"""Forward passes of the six LM families: full-sequence logits, prefill
that returns the decode cache, and single-token decode.

- ``dense`` (gemma2, phi3, phi4, starcoder2) and ``vlm`` (qwen2-vl, the
  dense trunk with M-RoPE positions ``batch["pos"]`` (B, S, 3)): a stack of
  attention + MLP blocks; gemma2 alternates a local layer (2i, sliding
  window ``attn_window``) with a global one (2i + 1) and wraps attention and
  MLP in sandwich norms.
- ``moe`` (phi3.5-moe, qwen3-moe): the dense block with the routed experts
  (``models/moe.py``) in place of the MLP; ``forward_logits`` returns their
  load-balance loss.  The KV cache of these three may be int8
  (``init_cache(kv_quant=True)``).
- ``ssm`` (mamba2): a stack of Mamba-2 layers.
- ``hybrid`` (zamba2): Mamba-2 layers with one shared attention block
  applied every ``hybrid_attn_every`` layers.
- ``encdec`` (whisper): an encoder over precomputed frame embeddings
  ``batch["frames"]`` (B, encoder_seq, D) with learned positions, then
  decoder layers of causal self-attention, cross-attention over the
  encoder's output and an MLP, with learned decoder positions.  The cache
  holds the cross K / V (``xk``, ``xv``) beside the self K / V.

The counterpart of ``repro.models.transformer``; the
reference's ``lax.scan`` over stacked layers is a Python loop over the
stacked parameters here.

Training: ``train_loss`` (the cross-entropy of ``forward_logits`` plus the
moe load-balance loss).  ``remat`` recomputes each layer body in the
backward pass, the unit the reference's ``_maybe_remat`` wraps (a layer;
gemma2's local + global pair; zamba2's group of the shared block and its
Mamba-2 layers): ``"none"`` keeps every activation, ``"full"`` keeps only
the body's inputs (``torch.utils.checkpoint``), ``"dots"`` also keeps the
outputs of the matrix products without batch dims (a selective
checkpoint; the counterpart of ``dots_with_no_batch_dims_saveable``).  The
kernels are no dispatcher ops: a recomputed body launches them again.

Compute dtype: the config's (``bfloat16`` unless a caller replaces it),
with float32 master weights cast at each use, as the reference does.

The model mesh: every entry point takes ``ctx`` (a ``ShardCtx``; the
default ``ShardCtx()`` is the single-device path, bit for bit).  On a mesh
the parameters, caches and batches are the rank's blocks
(``layers.ShardCtx``): the batch rows over ``batch``, the vocab over
``vocab`` (the embedding a masked lookup + ``reduce_from``, the logits
the rank's vocab slice, the loss ``xent_loss``'s vocab-parallel form),
attention heads, MLP columns / rows, experts and Mamba-2 heads over
``model`` with a ``reduce_from`` closing each block.  ``forward_logits``,
``prefill_forward`` and ``decode_step`` return the rank's vocab slice of
the logits; ``train_loss`` returns the global mean over the whole batch
on every rank.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint as torch_ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    ShardCtx, Spec, activate, embed_lookup, gated, lm_logits, rms_norm,
    xent_loss,
)
from repro_torch.models.schema import require_ported

_NO_MESH = ShardCtx()

# The weight of the moe family's load-balance loss (the reference's).
AUX_LOSS_COEF = 0.01
_KV_FAMILIES = ("dense", "vlm", "moe")


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _norm(cfg: ModelConfig, x, w):
    return rms_norm(x, w, eps=cfg.norm_eps, plus_one=cfg.sandwich_norm)


def mlp_block(cfg: ModelConfig, p: Dict, x: torch.Tensor,
              ctx: ShardCtx = _NO_MESH) -> torch.Tensor:
    """Column-parallel up / gate, row-parallel down on a mesh."""
    ax = ctx.checked("mlp", cfg.d_ff)
    x = ctx.copy_to(x, ax)
    up = torch.matmul(x, p["w_up"].to(x.dtype))
    if gated(cfg.activation):
        g = torch.matmul(x, p["w_gate"].to(x.dtype))
        h = activate(g, up, cfg.activation)
    else:
        h = activate(up, None, cfg.activation)
    return ctx.reduce_from(torch.matmul(h, p["w_down"].to(x.dtype)), ax)


def _ffn(cfg: ModelConfig, p: Dict, h: torch.Tensor,
         auxs: Optional[List[torch.Tensor]],
         ctx: ShardCtx = _NO_MESH) -> torch.Tensor:
    """The block's feed-forward: the MLP, or the moe layer's routed experts
    (their load-balance loss appended to ``auxs`` where given)."""
    if cfg.family != "moe":
        return mlp_block(cfg, p, h, ctx)
    y, aux = moe_mod.moe_block(cfg, p, h, ctx=ctx)
    if auxs is not None:
        auxs.append(aux)
    return y


def _dense_block(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                 attend: Callable[[torch.Tensor], torch.Tensor],
                 auxs: Optional[List[torch.Tensor]] = None,
                 ctx: ShardCtx = _NO_MESH) -> torch.Tensor:
    """One attention + feed-forward block; ``attend`` maps the normed input
    to the attention output.  Sandwich norms (gemma2) after attention and
    MLP."""
    a = attend(_norm(cfg, x, p["ln1"]))
    if cfg.sandwich_norm:
        a = _norm(cfg, a, p["ln1_post"])
    x = x + a
    m = _ffn(cfg, p, _norm(cfg, x, p["ln2"]), auxs, ctx)
    if cfg.sandwich_norm:
        m = _norm(cfg, m, p["ln2_post"])
    return x + m


def _dec_block(cfg: ModelConfig, p: Dict, x: torch.Tensor,
               attend: Callable[[torch.Tensor], torch.Tensor],
               cross: Callable[[torch.Tensor, Dict], torch.Tensor],
               ctx: ShardCtx = _NO_MESH) -> torch.Tensor:
    """One encdec decoder layer: self-attention (``attend``), then
    cross-attention over the encoder's output (``cross``, given the normed
    input and the layer's ``x``-prefixed weights without the prefix), then
    the MLP."""
    x = x + attend(_norm(cfg, x, p["ln1"]))
    xp = {k[1:]: v for k, v in p.items() if k.startswith("x")}
    x = x + cross(_norm(cfg, x, p["ln_x"]), xp)
    return x + mlp_block(cfg, p, _norm(cfg, x, p["ln2"]), ctx)


def _ssm_layer_fwd(cfg, p, x, ctx=_NO_MESH):
    h = rms_norm(x, p["ln"], eps=cfg.norm_eps)
    return x + ssm_mod.ssm_block(cfg, p, h, ctx=ctx)


_aten = torch.ops.aten
REMAT_MODES = ("none", "dots", "full")


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the outputs of matrix products without batch dims: ``mm``,
    ``addmm``, and ``bmm`` over a batch of one (what ``torch.einsum`` makes
    of a contraction with no batch dims); recompute everything else."""
    if op in (_aten.mm.default, _aten.addmm.default) or (
            op is _aten.bmm.default and args[0].shape[0] == 1):
        return torch_ckpt.CheckpointPolicy.MUST_SAVE
    return torch_ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn: Callable, remat: str) -> Callable:
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(torch_ckpt.checkpoint, fn,
                                 use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            torch_ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                torch_ckpt.create_selective_checkpoint_contexts,
                _dots_policy))
    raise ValueError(f"remat={remat!r}: one of {REMAT_MODES}")


def layer_params(params: Dict, i: int,
                 stack: str = "layers") -> Dict[str, torch.Tensor]:
    """Layer ``i`` of a stacked subtree (``layers``, ``enc_layers``)."""
    return {k: v[i] for k, v in params[stack].items()}


def layer_window(cfg: ModelConfig, i: int) -> int:
    """The sliding window of dense layer ``i``: gemma2's layer 2i is local
    (``attn_window``), 2i + 1 global; 0 (full attention) elsewhere."""
    return cfg.attn_window if cfg.alt_local_global and i % 2 == 0 else 0


def _groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(groups, layers per group) of the hybrid family: the shared block
    opens each group."""
    k = cfg.hybrid_attn_every
    return cfg.num_layers // k, k


def _seq_positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def encoder(cfg: ModelConfig, params: Dict, frames: torch.Tensor, *,
            remat: str = "none", ctx: ShardCtx = _NO_MESH) -> torch.Tensor:
    """The encdec encoder over precomputed frame embeddings (B, S, D), in
    their dtype: learned positions, non-causal dense blocks, a final
    norm."""
    b, s, _ = frames.shape
    x = frames + params["enc_pos"][:s][None].to(frames.dtype)
    pos = _seq_positions(b, s, frames.device)

    def body(h, li):
        pl = layer_params(params, li, "enc_layers")
        return _dense_block(cfg, pl, h, lambda hh: attn_mod.attention(
            cfg, pl, hh, pos, causal=False, ctx=ctx), ctx=ctx)

    body = _maybe_remat(body, remat)
    for li in range(cfg.encoder_layers):
        x = body(x, li)
    return rms_norm(x, params["enc_final_norm"], eps=cfg.norm_eps)


def _cross(cfg: ModelConfig, enc_out: torch.Tensor, pos: torch.Tensor,
           return_kv: bool = False, ctx: ShardCtx = _NO_MESH):
    """Cross-attention of the decoder (queries at ``pos``) over
    ``enc_out``, its keys at 0..Se-1."""
    epos = _seq_positions(enc_out.shape[0], enc_out.shape[1],
                          enc_out.device)
    return lambda h, xp: attn_mod.attention(
        cfg, xp, h, pos, causal=False, kv_x=enc_out, kv_pos=epos,
        return_kv=return_kv, ctx=ctx)


def _body_units(cfg: ModelConfig) -> Tuple[int, int]:
    """(units, layers a unit) of the trunk: the bodies ``remat`` wraps."""
    if cfg.family == "hybrid":
        return _groups(cfg)
    if cfg.family in _KV_FAMILIES and cfg.alt_local_global:
        return cfg.num_layers // 2, 2
    return cfg.num_layers, 1


def trunk(cfg: ModelConfig, params: Dict, x: torch.Tensor,
          pos: torch.Tensor, *, enc_out: Optional[torch.Tensor] = None,
          auxs: Optional[List[torch.Tensor]] = None,
          remat: str = "none", ctx: ShardCtx = _NO_MESH) -> torch.Tensor:
    """Token embeddings (B, S, D) -> final hidden states.  encdec attends
    over ``enc_out``; moe appends each layer's load-balance loss to
    ``auxs``.  ``remat``: see the module docstring."""
    require_ported(cfg)
    units, per = _body_units(cfg)
    cross = (_cross(cfg, enc_out, pos, ctx=ctx) if cfg.family == "encdec"
             else None)

    def body(h, ui):
        """Unit ``ui``: (hidden, the moe layers' aux losses stacked, or
        None)."""
        unit_auxs: List[torch.Tensor] = []
        if cfg.family == "hybrid":
            sp = params["shared_attn"]
            h = _dense_block(cfg, sp, h, lambda hh: attn_mod.attention(
                cfg, sp, hh, pos, ctx=ctx), ctx=ctx)
        for li in range(ui * per, (ui + 1) * per):
            pl = layer_params(params, li)
            if cfg.family in _KV_FAMILIES:
                win = layer_window(cfg, li)
                h = _dense_block(cfg, pl, h, lambda hh: attn_mod.attention(
                    cfg, pl, hh, pos, window=win, ctx=ctx), unit_auxs, ctx)
            elif cfg.family == "encdec":
                h = _dec_block(cfg, pl, h, lambda hh: attn_mod.attention(
                    cfg, pl, hh, pos, ctx=ctx), cross, ctx)
            else:
                h = _ssm_layer_fwd(cfg, pl, h, ctx)
        return h, (torch.stack(unit_auxs) if unit_auxs else None)

    body = _maybe_remat(body, remat)
    for ui in range(units):
        x, unit_aux = body(x, ui)
        if unit_aux is not None and auxs is not None:
            auxs.extend(unit_aux.unbind(0))
    return x


def vocab_axes(cfg: ModelConfig, ctx: ShardCtx):
    """The axes the vocab (embedding rows, logits) splits over."""
    return ctx.checked("vocab", cfg.padded_vocab)


def _embed_in(cfg: ModelConfig, params, tokens, dtype, ctx=_NO_MESH):
    return embed_lookup(params["embed"], tokens, dtype, scale=cfg.scale_embed,
                        ctx=ctx, v_axes=vocab_axes(cfg, ctx))


def _head_out(cfg: ModelConfig, params, x, ctx=_NO_MESH):
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps,
                 plus_one=cfg.sandwich_norm)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return lm_logits(x, head, cap=cfg.final_softcap, ctx=ctx,
                     v_axes=vocab_axes(cfg, ctx))


def _positions(cfg: ModelConfig, batch: Dict, b: int, s: int,
               device) -> torch.Tensor:
    """``batch["pos"]`` (B, S, 3) under M-RoPE, else 0..S-1 per row."""
    if cfg.use_mrope:
        return batch["pos"]
    return _seq_positions(b, s, device)


def _decoder_in(cfg: ModelConfig, params: Dict, batch: Dict, dtype,
                remat: str = "none", ctx: ShardCtx = _NO_MESH
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The token embeddings (B, S, D) and, for encdec, the encoder's output
    over ``batch["frames"]`` in ``dtype``, the learned decoder positions
    0..S-1 added to the embeddings."""
    tokens = batch["tokens"]
    x = _embed_in(cfg, params, tokens, dtype, ctx)
    if not cfg.is_encdec:
        return x, None
    enc_out = encoder(cfg, params, batch["frames"].to(dtype), remat=remat,
                      ctx=ctx)
    s = tokens.shape[1]
    return x + params["dec_pos"][:s][None].to(dtype), enc_out


def forward_logits(cfg: ModelConfig, params: Dict, batch: Dict, *,
                   remat: str = "none", ctx: ShardCtx = _NO_MESH
                   ) -> Tuple[torch.Tensor, Any]:
    """Full-sequence logits (B, S, Vp) float32, and the auxiliary loss:
    for moe the layers' mean load-balance loss times ``AUX_LOSS_COEF``, a
    0-dim float32 tensor; 0.0 for the other families.  batch: tokens
    (B, S) [+ pos (B, S, 3) vlm] [+ frames (B, Se, D) encdec]."""
    require_ported(cfg)
    if remat not in REMAT_MODES:
        raise ValueError(f"remat={remat!r}: one of {REMAT_MODES}")
    tokens = batch["tokens"]
    b, s = tokens.shape
    x, enc_out = _decoder_in(cfg, params, batch, compute_dtype(cfg), remat,
                             ctx)
    auxs: List[torch.Tensor] = []
    h = trunk(cfg, params, x, _positions(cfg, batch, b, s, tokens.device),
              enc_out=enc_out, auxs=auxs, remat=remat, ctx=ctx)
    aux = torch.stack(auxs).mean() * AUX_LOSS_COEF if auxs else 0.0
    return _head_out(cfg, params, h, ctx), aux


def train_loss(cfg: ModelConfig, params: Dict, batch: Dict, *,
               remat: str = "dots", ctx: ShardCtx = _NO_MESH
               ) -> Tuple[torch.Tensor, Dict]:
    """(loss + aux, {"loss", "aux_loss"}): the mean cross-entropy of
    ``forward_logits`` over the labels >= 0 (``batch["labels"]`` (B, S),
    the padded vocab masked) plus the moe load-balance loss (0 for the
    other families), every value a 0-dim float32 tensor."""
    logits, aux = forward_logits(cfg, params, batch, remat=remat, ctx=ctx)
    loss = xent_loss(logits, batch["labels"], real_vocab=cfg.vocab_size,
                     ctx=ctx, v_axes=vocab_axes(cfg, ctx),
                     b_axes=ctx.axes("batch"))
    aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
    return loss + aux, {"loss": loss, "aux_loss": aux}


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, ctx: ShardCtx, *,
                seq_sharded: bool = False) -> Dict[str, Spec]:
    """The spec tree matching ``init_cache`` (the reference's, entry for
    entry; ``len`` has none)."""
    batch = ctx.axes("batch")
    kv = ctx.axes("kv_heads")
    seq = ctx.axes("seq_shard") if seq_sharded else None
    if seq and batch:
        # guard against duplicate mesh axes (long-context decode shards
        # the sequence on the axis normally used for batch)
        batch = tuple(a for a in batch if a not in seq) or None

    def kv_spec(n_heads):
        heads = None
        if kv is not None and ctx.mesh is not None and not seq_sharded:
            heads = kv if n_heads % ctx.size(kv) == 0 else None
        return (None, batch, heads, seq, None)

    specs: Dict[str, Any] = {"len": ()}
    fam = cfg.family
    if fam in ("dense", "vlm", "moe", "encdec", "hybrid"):
        specs["k"] = kv_spec(cfg.padded_kv_heads)
        specs["v"] = kv_spec(cfg.padded_kv_heads)
    if fam == "encdec":
        specs["xk"] = (None, batch, None, None, None)
        specs["xv"] = (None, batch, None, None, None)
    if fam in ("ssm", "hybrid"):
        specs["conv"] = (None, batch, None, ctx.axes("mlp"))
        specs["ssm"] = (None, batch, ctx.axes("ssm_heads"), None, None)
    return specs


def _local_cache_shape(cfg: ModelConfig, ctx: ShardCtx, key: str, shape,
                       spec) -> Tuple[int, ...]:
    """A rank's block of cache entry ``key``: the spec's block, but the
    conv state holds the rank's d_inner slice of the x channels then every
    B/C channel (``models/ssm.py``)."""
    if key != "conv" or ctx.size(spec[3]) == 1:
        return ctx.local_shape(shape, spec)
    bc = 2 * cfg.ssm_groups * cfg.ssm_state
    lead = ctx.local_shape(shape[:3], spec[:3])
    return lead + (cfg.ssm_inner // ctx.size(spec[3]) + bc,)


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int,
               dtype=torch.bfloat16, device=None,
               kv_quant: bool = False, *, ctx: ShardCtx = _NO_MESH,
               seq_sharded: bool = False,
               abstract: bool = False) -> Dict[str, Any]:
    """Decode cache.  dense / vlm / moe: one K/V pair per layer in
    ``dtype``, or with ``kv_quant=True`` int8 K/V plus per-position float32
    scales ``k_scale`` / ``v_scale`` (L, B, Hkv, Smax, 1)
    (``serve/kvquant.py``; the other families keep their cache as it is, as
    in the reference).  encdec: the self K/V pair per layer and the cross
    K/V ``xk`` / ``xv`` (L, B, Hkv, encoder_seq, Dh).  ssm: per-layer conv
    and SSM state in float32.  hybrid: both, with one K/V pair per
    shared-block application.  ``len`` is the number of positions filled,
    a Python int (the reference keeps an int32 device scalar).  On a mesh
    (``ctx``; ``batch_size`` and ``max_seq`` global) each entry is the
    rank's block by ``cache_specs`` (``seq_sharded``: the positions split
    over ``seq_shard``); the scales follow K / V.  ``abstract=True``: on
    the ``meta`` device."""
    require_ported(cfg)
    b, L = batch_size, cfg.num_layers
    hkv, dh = cfg.padded_kv_heads, cfg.head_dim
    f32 = torch.float32
    if abstract:
        device = "meta"
    specs = cache_specs(cfg, ctx, seq_sharded=seq_sharded)
    cache: Dict[str, Any] = {"len": 0}

    def put(key, shape, dt, spec_key=None):
        spec = specs[spec_key or key]
        cache[key] = torch.zeros(_local_cache_shape(cfg, ctx, key, shape,
                                                    spec),
                                 dtype=dt, device=device)

    if cfg.family == "encdec":
        for key, n in (("k", max_seq), ("v", max_seq),
                       ("xk", cfg.encoder_seq), ("xv", cfg.encoder_seq)):
            put(key, (L, b, hkv, n, dh), dtype)
        return cache
    if cfg.family in _KV_FAMILIES:
        kv_dtype = torch.int8 if kv_quant else dtype
        for key in ("k", "v"):
            put(key, (L, b, hkv, max_seq, dh), kv_dtype)
        if kv_quant:
            for key in ("k_scale", "v_scale"):
                put(key, (L, b, hkv, max_seq, 1), f32, key[0])
        return cache
    conv_c = cfg.ssm_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    put("conv", (L, b, cfg.ssm_conv_width - 1, conv_c), f32)
    put("ssm", (L, b, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), f32)
    if cfg.family == "hybrid":
        groups, _ = _groups(cfg)
        for key in ("k", "v"):
            put(key, (groups, b, hkv, max_seq, dh), dtype)
    return cache


def local_cache(cfg: ModelConfig, cache: Dict[str, Any], ctx: ShardCtx, *,
                seq_sharded: bool = False) -> Dict[str, Any]:
    """A full cache (one device's) cut to this rank's blocks (copies)."""
    specs = cache_specs(cfg, ctx, seq_sharded=seq_sharded)
    out: Dict[str, Any] = {"len": cache["len"]}
    for key, x in cache.items():
        if key == "len":
            continue
        spec = specs[key if key in specs else key[0]]
        if key == "conv" and ctx.size(spec[3]) > 1:
            di = cfg.ssm_inner
            xs = ctx.local(x[..., :di], spec)
            x = torch.cat([xs, ctx.local(x[..., di:], spec[:3])], dim=-1)
        else:
            x = ctx.local(x, spec)
        out[key] = x.clone()
    return out


def _ssm_prefill(cfg, params, cache, li, x, ctx=_NO_MESH):
    """Mamba-2 layer ``li`` over the prompt; its states into the cache."""
    pl = layer_params(params, li)
    hn = rms_norm(x, pl["ln"], eps=cfg.norm_eps)
    y, cache["conv"][li], cache["ssm"][li] = ssm_mod.ssm_block(
        cfg, pl, hn, return_state=True, ctx=ctx)
    return x + y


def gather_kv_heads(cfg: ModelConfig, ctx: ShardCtx, kv: torch.Tensor,
                    cache: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """K or V of the rank's KV heads, gathered over the KV-head axes where
    ``cache`` holds every head (a replicated-head cache entry)."""
    ax = attn_mod.head_axes(cfg, ctx)[1]
    if ax and kv.shape[dim] != cache.shape[dim]:
        return ctx.all_gather(kv.contiguous(), ax, dim=dim)
    return kv


def prefill_forward(cfg: ModelConfig, params: Dict, batch: Dict, *,
                    max_seq: Optional[int] = None, ctx: ShardCtx = _NO_MESH
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process a full prompt and RETURN THE DECODE CACHE.  batch: tokens
    (B, S) [+ pos (B, S, 3) vlm] [+ frames (B, encoder_seq, D) encdec].
    Returns (last-token logits (B, Vp) float32, cache ready for
    ``decode_step`` at position S, in the compute dtype: only
    ``init_cache`` makes an int8 cache, as in the reference).  ``max_seq``
    reserves cache room beyond the prompt (default S).  Each attention
    layer (encoder, self and cross) goes through the ``flash_attention``
    kernel at every length (with the layer's window) and each Mamba-2
    layer through the ``ssd_scan`` kernel.  On a mesh: the rank's rows,
    vocab slice and cache blocks (``batch`` its rows)."""
    require_ported(cfg)
    dtype = compute_dtype(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    max_seq = max_seq or s
    if max_seq < s:
        raise ValueError(f"prefill_forward: max_seq={max_seq} < prompt {s}")
    if cfg.is_encdec and batch["frames"].shape[1] != cfg.encoder_seq:
        raise ValueError(
            f"prefill_forward: the decode cache holds {cfg.encoder_seq} "
            f"encoder frames, got {tuple(batch['frames'].shape)}")
    x, enc_out = _decoder_in(cfg, params, batch, dtype, ctx=ctx)
    pos = _positions(cfg, batch, b, s, tokens.device)
    nb = ctx.size(ctx.axes("batch"))
    cache = init_cache(cfg, b * nb, max_seq, dtype=dtype,
                       device=tokens.device, ctx=ctx)
    cache["len"] = s

    def attend_into(p, slot, window=0):
        def attend(h):
            a, (kh, vh) = attn_mod.attention(cfg, p, h, pos, window=window,
                                             return_kv=True, ctx=ctx)
            cache["k"][slot, :, :, :s] = kh
            cache["v"][slot, :, :, :s] = vh
            return a
        return attend

    cross = _cross(cfg, enc_out, pos, return_kv=True, ctx=ctx) \
        if cfg.is_encdec else None

    def cross_into(li):
        def attend(h, xp):
            a, (xk, xv) = cross(h, xp)
            cache["xk"][li] = gather_kv_heads(cfg, ctx, xk, cache["xk"][li])
            cache["xv"][li] = gather_kv_heads(cfg, ctx, xv, cache["xv"][li])
            return a
        return attend

    if cfg.family in _KV_FAMILIES:
        for li in range(cfg.num_layers):
            pl = layer_params(params, li)
            x = _dense_block(cfg, pl, x,
                             attend_into(pl, li, layer_window(cfg, li)),
                             ctx=ctx)
    elif cfg.family == "encdec":
        for li in range(cfg.num_layers):
            pl = layer_params(params, li)
            x = _dec_block(cfg, pl, x, attend_into(pl, li), cross_into(li),
                           ctx)
    elif cfg.family == "ssm":
        for li in range(cfg.num_layers):
            x = _ssm_prefill(cfg, params, cache, li, x, ctx)
    else:
        groups, k = _groups(cfg)
        sp = params["shared_attn"]
        for gi in range(groups):
            x = _dense_block(cfg, sp, x, attend_into(sp, gi), ctx=ctx)
            for li in range(gi * k, (gi + 1) * k):
                x = _ssm_prefill(cfg, params, cache, li, x, ctx)
    logits = _head_out(cfg, params, x[:, -1:], ctx)[:, 0]
    return logits, cache


def _ssm_step(cfg, params, cache, li, x, ctx=_NO_MESH):
    """Mamba-2 layer ``li`` on one token; its states updated in place."""
    pl = layer_params(params, li)
    hn = rms_norm(x, pl["ln"], eps=cfg.norm_eps)
    y, cache["conv"][li], cache["ssm"][li] = ssm_mod.ssm_decode(
        cfg, pl, hn, cache["conv"][li], cache["ssm"][li], ctx=ctx)
    return x + y


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                batch: Dict, *, ctx: ShardCtx = _NO_MESH,
                seq_sharded: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step.  batch: tokens (B, 1) [+ pos (B, 1, 3) vlm].
    Returns (logits (B, Vp) float32, cache).  The cache is updated IN
    PLACE, its tensors and its ``len`` (one more), and the same dict is
    returned (the reference returns new arrays; a copy of the whole cache
    per token would double its traffic).  moe routes the step's B tokens
    (capacity over B: it drops differently from a prefill, as in the
    reference); encdec adds the learned position ``len`` and attends over
    the whole cross cache.  On a mesh: the rank's rows, vocab slice and
    cache blocks; ``seq_sharded``: the K / V positions split over
    ``seq_shard`` (``init_cache(seq_sharded=True)``)."""
    require_ported(cfg)
    dtype = compute_dtype(cfg)
    tokens = batch["tokens"]
    b = tokens.shape[0]
    x = _embed_in(cfg, params, tokens, dtype, ctx)
    clen = int(cache["len"])
    if cfg.use_mrope:
        pos = batch["pos"]
    else:
        pos = torch.full((b, 1), clen, dtype=torch.int64,
                         device=tokens.device)
    if cfg.is_encdec:
        x = x + params["dec_pos"][clen][None, None].to(dtype)

    def attend_at(p, slot, window=0):
        scales = {}
        if "k_scale" in cache:
            scales = dict(k_scale=cache["k_scale"][slot],
                          v_scale=cache["v_scale"][slot])

        def attend(h):
            return attn_mod.decode_attention(
                cfg, p, h, pos, cache["k"][slot], cache["v"][slot], clen,
                window=window, seq_sharded=seq_sharded, ctx=ctx,
                **scales)[0]
        return attend

    def cross_at(li):
        def attend(h, xp):
            return attn_mod.decode_attention(
                cfg, xp, h, pos, cache["xk"][li], cache["xv"][li],
                cfg.encoder_seq - 1, update_cache=False, ctx=ctx)[0]
        return attend

    if cfg.family in _KV_FAMILIES:
        for li in range(cfg.num_layers):
            pl = layer_params(params, li)
            x = _dense_block(cfg, pl, x,
                             attend_at(pl, li, layer_window(cfg, li)),
                             ctx=ctx)
    elif cfg.family == "encdec":
        for li in range(cfg.num_layers):
            pl = layer_params(params, li)
            x = _dec_block(cfg, pl, x, attend_at(pl, li), cross_at(li), ctx)
    elif cfg.family == "ssm":
        for li in range(cfg.num_layers):
            x = _ssm_step(cfg, params, cache, li, x, ctx)
    else:
        groups, k = _groups(cfg)
        sp = params["shared_attn"]
        for gi in range(groups):
            x = _dense_block(cfg, sp, x, attend_at(sp, gi), ctx=ctx)
            for li in range(gi * k, (gi + 1) * k):
                x = _ssm_step(cfg, params, cache, li, x, ctx)
    cache["len"] = clen + 1
    logits = _head_out(cfg, params, x, ctx)[:, 0]
    return logits, cache
