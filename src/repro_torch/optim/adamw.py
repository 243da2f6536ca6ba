"""AdamW over a nested dict of parameters, with optional update hooks
(gradient clipping, Ranky-GaLore low-rank projection).

The counterpart of ``repro.optim.adamw`` on one device: state = {m, v,
step}, float32 moments and an int32 step counter.  The arithmetic is the
reference's, in its order: clip by the global norm first, then the float32
moments, the bias correction, decoupled weight decay on matrices only
(``ndim >= 2``), the new value cast back to the leaf's dtype.

A functional update, not ``torch.optim``: ``apply_updates`` writes the new
parameters and moments IN PLACE (under ``torch.no_grad()``) and returns
the same dicts, where the reference returns new arrays and donates the old
ones (``donate_argnums``).  The ZeRO-sharded moments of the reference
(``abstract_state`` and the ``opt_shard`` axis) belong to the LM model
mesh (ROADMAP.md item 16).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.optim import tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _device(params) -> torch.device:
    first = tree.leaves(params)
    return first[0].device if first else torch.device("cpu")


def init_state(params) -> Dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {
        "m": tree.tree_map(zeros, params),
        "v": tree.tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=_device(params)),
    }


def global_norm(grads) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in tree.leaves(grads)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads * min(1, max_norm / |grads|) in float32, |grads|)."""
    gn = global_norm(grads)
    scale = clip_scale(gn, max_norm)
    return tree.tree_map(lambda g: g.to(torch.float32) * scale, grads), gn


def bias_corrections(cfg: AdamWConfig, step: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(1 - b1^t, 1 - b2^t) in float32 at the new step t."""
    t = step.to(torch.float32)
    return 1.0 - cfg.b1 ** t, 1.0 - cfg.b2 ** t


def moments(cfg: AdamWConfig, m: torch.Tensor, v: torch.Tensor,
            g: torch.Tensor, bc1, bc2) -> torch.Tensor:
    """m <- b1 m + (1 - b1) g and v <- b2 v + (1 - b2) g g in place; returns
    the Adam direction (m / bc1) / (sqrt(v / bc2) + eps)."""
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
    return (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)


def write_param(cfg: AdamWConfig, p: torch.Tensor, delta: torch.Tensor,
                lr_scale) -> None:
    """p <- p - lr * lr_scale * delta, in float32, cast back to p's dtype."""
    new = p.to(torch.float32) - cfg.lr * lr_scale * delta
    p.copy_(new.to(p.dtype))


@torch.no_grad()
def apply_updates(
    cfg: AdamWConfig,
    params,
    grads,
    state: Dict[str, Any],
    *,
    lr_scale=1.0,
    transform: Optional[Callable] = None,
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  ``transform(grads) -> grads`` lets
    compression hooks rewrite the clipped float32 gradient tree before the
    moment update.  Returns (params, state, {"grad_norm"})."""
    gn = global_norm(grads)
    scale = clip_scale(gn, cfg.grad_clip)
    if transform is not None:
        grads = transform(tree.tree_map(
            lambda g: g.to(torch.float32) * scale, grads))
        scale = None
    state["step"].add_(1)
    bc1, bc2 = bias_corrections(cfg, state["step"])
    for p, g, m, v in zip(tree.leaves(params), tree.leaves(grads),
                          tree.leaves(state["m"]), tree.leaves(state["v"])):
        g = g.to(torch.float32)
        if scale is not None:
            g = g * scale           # clipped one leaf at a time
        delta = moments(cfg, m, v, g, bc1, bc2)
        # decoupled weight decay on matrices only (ndim >= 2)
        if p.ndim >= 2:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        write_param(cfg, p, delta, lr_scale)
    return params, state, {"grad_norm": gn}
