"""Serving engine: batched generation over ``decode_step``.  The
counterpart of ``repro.serve.engine``.

As in the reference, ``prefill_cache`` feeds the prompt through decode
steps one token at a time (no kernel); ``transformer.prefill_forward`` is
the prefill that runs the whole prompt at once through the kernels.
Generation is greedy at temperature 0, else Gumbel-max sampling (what
``jax.random.categorical`` does) with noise from an explicit
``torch.Generator``: randomness is an input.  Under M-RoPE (qwen2-vl)
each step's three position streams equal the cache length
(``_mrope_pos``), as in the reference.  An encoder-decoder model
(whisper) needs its encoder frames: ``prefill_cache(frames=)`` runs the
encoder and fills the cross cache, and without frames it raises, as does
``generate``, which takes none (the reference's ``generate`` passes no
frames and stops at an assert).  ``batch_requests`` left-pads uneven
requests and ``generate`` does not mask the padding, which is the
reference's behaviour.

On the model mesh (``ctx``, ``models/layers.ShardCtx``) ``prompts`` are
the rank's rows, the logits are gathered over the vocab axes before
``sample``, and every rank draws the noise of the whole batch from the
same seed and keeps its rows': the ranks of a data shard emit the same
tokens, the single device's for those rows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ShardCtx
from repro_torch.models.transformer import (
    compute_dtype, decode_step, encoder, gather_kv_heads, init_cache,
    vocab_axes,
)

_NO_MESH = ShardCtx()


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seq: int = 512
    temperature: float = 0.0   # 0 => greedy
    seed: int = 0


def _mrope_pos(b: int, t: int, device) -> torch.Tensor:
    """(B, 1, 3) position ids of a decode step at position ``t``: the three
    M-RoPE streams equal, as for text."""
    return torch.full((b, 1, 3), t, dtype=torch.int32, device=device)


def step(cfg: ModelConfig, params, cache: Dict, tok: torch.Tensor,
         ctx: ShardCtx = _NO_MESH):
    """The engine's decode step: ``decode_step`` of tokens (B, 1), with
    the engine's M-RoPE positions where the config uses them."""
    batch = {"tokens": tok}
    if cfg.use_mrope:
        batch["pos"] = _mrope_pos(tok.shape[0], cache["len"], tok.device)
    return decode_step(cfg, params, cache, batch, ctx=ctx)


def prefill_cache(cfg: ModelConfig, params, prompts: torch.Tensor,
                  scfg: ServeConfig, frames: Optional[torch.Tensor] = None,
                  ctx: ShardCtx = _NO_MESH) -> Tuple[Dict, torch.Tensor]:
    """Feed the prompt tokens (B, P) through decode steps.  Returns (cache,
    last logits (B, Vp)).  encdec: first the encoder over ``frames`` (B,
    encoder_seq, D), in their dtype, and the cross cache from its output
    by the float32 ``xwk`` / ``xwv``, cast to the cache's dtype."""
    b, plen = prompts.shape
    if plen < 1:
        raise ValueError("prefill_cache needs at least one prompt token")
    nb = ctx.size(ctx.axes("batch"))
    cache = init_cache(cfg, b * nb, scfg.max_seq, dtype=compute_dtype(cfg),
                       device=prompts.device, ctx=ctx)
    if cfg.is_encdec:
        if frames is None:
            raise ValueError(
                f"{cfg.name} is an encoder-decoder model: serving it needs "
                f"its encoder frames (B, {cfg.encoder_seq}, {cfg.d_model}), "
                f"passed as prefill_cache(frames=); generate takes none")
        enc_out = encoder(cfg, params, frames, ctx=ctx).float()
        for key, w in (("xk", "xwk"), ("xv", "xwv")):
            kv = torch.einsum("bsd,ldhk->lbhsk", enc_out,
                              params["layers"][w].float())
            cache[key] = gather_kv_heads(cfg, ctx, kv, cache[key], dim=2).to(
                cache[key].dtype)
    logits = None
    for t in range(plen):
        logits, cache = step(cfg, params, cache, prompts[:, t:t + 1], ctx)
    return cache, logits


def sample(cfg: ModelConfig, logits: torch.Tensor, temperature: float,
           generator: torch.Generator, *,
           rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Next tokens (B,) int32 from logits (B, Vp): argmax over the real
    vocab at temperature 0, else argmax of logits / T plus Gumbel noise
    drawn from ``generator``.  ``rows`` = (first, total): the logits are
    rows first..first+B of a batch of ``total``, and the noise is drawn
    for the whole batch (as one device draws it) and cut to them."""
    logits = logits[..., : cfg.vocab_size]
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    shape = tuple(logits.shape)
    if rows is not None:
        shape = (rows[1],) + shape[1:]
    u = torch.rand(shape, generator=generator,
                   device=generator.device).to(logits.device)
    if rows is not None:
        u = u[rows[0]: rows[0] + logits.shape[0]]
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(logits / temperature + gumbel, dim=-1).to(torch.int32)


def generate(cfg: ModelConfig, params, prompts: torch.Tensor,
             scfg: ServeConfig, num_tokens: int,
             generator: Optional[torch.Generator] = None,
             ctx: ShardCtx = _NO_MESH) -> torch.Tensor:
    """Greedy / temperature generation.  prompts (B, P) -> (B, num_tokens)
    int32.  Pass ``generator`` to thread an explicit random stream; callers
    serving many requests must keep one per request stream, otherwise
    every call with the same ServeConfig replays the same noise (the
    seed-derived generator exists for one-shot and test use).  On a mesh
    ``prompts`` and the result are the rank's rows (see the module
    docstring)."""
    cache, logits = prefill_cache(cfg, params, prompts, scfg, ctx=ctx)
    if generator is None:
        generator = torch.Generator(prompts.device).manual_seed(scfg.seed)
    b_ax, b = ctx.axes("batch"), prompts.shape[0]
    rows = None
    if ctx.size(b_ax) > 1:
        rows = (ctx.index(b_ax) * b, ctx.size(b_ax) * b)
    v_ax = vocab_axes(cfg, ctx)
    toks = []
    for _ in range(num_tokens):
        full = ctx.all_gather(logits, v_ax, dim=-1)
        tok = sample(cfg, full, scfg.temperature, generator, rows=rows)
        toks.append(tok)
        logits, cache = step(cfg, params, cache, tok[:, None], ctx)
    if not toks:
        return torch.empty((prompts.shape[0], 0), dtype=torch.int32,
                           device=prompts.device)
    return torch.stack(toks, dim=1)


def batch_requests(prompt_lists: List[List[int]], pad_id: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Left-pad uneven requests into one batch (B, Pmax) + lengths."""
    if not prompt_lists:
        raise ValueError("batch_requests needs at least one prompt")
    lens = np.asarray([len(p) for p in prompt_lists])
    pmax = int(lens.max())
    out = np.full((len(prompt_lists), pmax), pad_id, np.int32)
    for i, p in enumerate(prompt_lists):
        out[i, pmax - len(p):] = p
    return out, lens
