"""Model inputs: real batches (tests, examples) and shape-only stand-ins,
per architecture.

With ``abstract=True`` the tensors lie on the ``meta`` device (shapes and
dtypes, no storage): the counterpart of the reference's
``jax.ShapeDtypeStruct``.  ``batch_specs`` and ``input_specs`` give the
spec trees of a cell's inputs on the model mesh (``layers.ShardCtx``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.layers import ShardCtx, Spec
from repro_torch.models.transformer import cache_specs, init_cache


def _mk(abstract: bool, device):
    dev = "meta" if abstract else resolve_device(device)
    return lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=dev)


def train_batch(cfg: ModelConfig, batch: int, seq: int, *,
                abstract: bool = False, device=None) -> Dict[str, Any]:
    """On ``device`` (default: the GPU): int32 tokens and labels (B, S)
    [+ pos (B, S, 3) int32 under M-RoPE] [+ frames (B, encoder_seq, D)
    bf16 for encdec], zeros."""
    mk = _mk(abstract, device)
    out = {
        "tokens": mk((batch, seq), torch.int32),
        "labels": mk((batch, seq), torch.int32),
    }
    if cfg.use_mrope:
        out["pos"] = mk((batch, seq, 3), torch.int32)
    if cfg.is_encdec:
        out["frames"] = mk((batch, cfg.encoder_seq, cfg.d_model),
                           torch.bfloat16)
    return out


def decode_batch(cfg: ModelConfig, batch: int, *, abstract: bool = False,
                 device=None) -> Dict[str, Any]:
    mk = _mk(abstract, device)
    out = {"tokens": mk((batch, 1), torch.int32)}
    if cfg.use_mrope:
        out["pos"] = mk((batch, 1, 3), torch.int32)
    return out


def batch_specs(cfg: ModelConfig, ctx: ShardCtx, *, kind: str
                ) -> Dict[str, Spec]:
    b = ctx.axes("batch")
    out = {"tokens": (b, None)}
    if kind == "train":
        out["labels"] = (b, None)
    if cfg.use_mrope:
        out["pos"] = (b, None, None)
    if cfg.is_encdec and kind != "decode":
        out["frames"] = (b, None, None)
    return out


def input_specs(cfg: ModelConfig, shape: InputShape, ctx: ShardCtx
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Dry-run inputs for one cell: (abstract args on ``meta``, spec
    tree).  train/prefill -> (batch,), decode -> (cache, batch); the
    cache's shapes are the global ones (``init_cache`` without a mesh).
    The ``long_500k`` cell shards its cache's sequence."""
    seq_sharded = shape.name == "long_500k"
    if shape.kind in ("train", "prefill"):
        batch = train_batch(cfg, shape.global_batch, shape.seq_len,
                            abstract=True)
        kind = "train" if shape.kind == "train" else "prefill"
        if kind == "prefill":
            batch.pop("labels", None)
        return {"batch": batch}, {"batch": batch_specs(cfg, ctx, kind=kind)}

    # decode: cache sized to the context length
    cache = init_cache(cfg, shape.global_batch, shape.seq_len, abstract=True)
    batch = decode_batch(cfg, shape.global_batch, abstract=True)
    return ({"cache": cache, "batch": batch},
            {"cache": cache_specs(cfg, ctx, seq_sharded=seq_sharded),
             "batch": batch_specs(cfg, ctx, kind="decode")})
