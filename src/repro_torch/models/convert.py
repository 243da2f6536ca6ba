"""Carry the reference's LM parameters over into the port.

``params_from_numpy`` takes the reference's parameter pytree with numpy
leaves (``jax.tree.map(np.asarray, params)`` on the reference's side) and
returns the port's nested dict of tensors, checking every leaf's shape
against the port's own schema.  Knows nothing of JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import schema


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                      device=None, ctx=None) -> Dict[str, Any]:
    """Numpy pytree -> tensors on ``device`` (default: the GPU), dtype
    kept.  Raises on a missing, extra or mis-shaped leaf.  On a model mesh
    (``ctx``, a ``layers.ShardCtx``) this rank's blocks of them
    (``schema.shard_params``)."""
    if ctx is not None and ctx.mesh is not None:
        return schema.shard_params(params_from_numpy(cfg, tree, device),
                                   cfg, ctx)
    device = resolve_device(device)
    shapes = schema.param_shapes(cfg)

    def rec(want, got, path):
        if not isinstance(want, dict):
            arr = np.asarray(got)
            if tuple(arr.shape) != tuple(want):
                raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, the "
                                 f"schema wants {tuple(want)}")
            return torch.from_numpy(np.array(arr)).to(device)
        if not isinstance(got, dict) or set(got) != set(want):
            have = sorted(got) if isinstance(got, dict) else type(got)
            raise ValueError(f"{'/'.join(path) or 'params'}: keys {have}, "
                             f"the schema wants {sorted(want)}")
        return {k: rec(want[k], got[k], path + (k,)) for k in want}

    return rec(shapes, tree, ())
