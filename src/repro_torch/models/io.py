"""Model inputs: real batches (tests, examples) and shape-only stand-ins,
per architecture.

With ``abstract=True`` the tensors lie on the ``meta`` device (shapes and
dtypes, no storage): the counterpart of the reference's
``jax.ShapeDtypeStruct``.  The reference's ``batch_specs`` /
``input_specs`` (shardings of a dry-run cell) belong to the LM model mesh
(ROADMAP.md item 16).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig


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
