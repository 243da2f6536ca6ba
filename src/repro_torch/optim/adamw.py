"""AdamW over a nested dict of parameters, with optional update hooks
(gradient clipping, Ranky-GaLore low-rank projection).

The counterpart of ``repro.optim.adamw``: state = {m, v, step}, float32
moments and an int32 step counter.  The arithmetic is the
reference's, in its order: clip by the global norm first, then the float32
moments, the bias correction, decoupled weight decay on matrices only
(``ndim >= 2``), the new value cast back to the leaf's dtype.

A functional update, not ``torch.optim``: ``apply_updates`` writes the new
parameters and moments IN PLACE (under ``torch.no_grad()``) and returns
the same dicts, where the reference returns new arrays and donates the old
ones (``donate_argnums``).

On the model mesh (``ctx``, ``models/layers.ShardCtx``) the parameters and
gradients are the rank's blocks under the spec tree ``specs``: the global
norm sums the squares of the sharded leaves over their axes (``psum``)
and counts a replicated leaf once.  ZeRO-1: a leaf's moments split
further over the ``opt_shard`` axes on the first dimension that its spec
leaves whole and the axes divide (``zero_spec``, on the GLOBAL shape);
each rank updates that slice of m, v and the parameter, then
``all_gather``s the parameter over those axes.
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


def zero_spec(spec, shape, ctx) -> tuple:
    """A moment's spec: ``spec`` (a parameter's) with the ``opt_shard``
    axes added on the first dimension that is unsharded and divisible by
    them (the reference's ``state_shardings``' ``zero_shard``)."""
    opt_axes = ctx.axes("opt_shard")
    parts = list(spec) + [None] * (len(shape) - len(spec))
    if not opt_axes:
        return tuple(spec)
    size = ctx.size(opt_axes)
    for i, (ax, dim) in enumerate(zip(parts, shape)):
        if ax is None and dim % size == 0:
            parts[i] = opt_axes
            break
    return tuple(parts)


def zero_split(pspec, mspec) -> Optional[Tuple[int, tuple]]:
    """(dim, axes) where a moment's spec splits what its parameter's
    leaves whole, or None."""
    for i, (a, b) in enumerate(zip(tuple(pspec) + (None,) * len(mspec),
                                   mspec)):
        if a != b:
            return i, b
    return None


def _chunk(x: torch.Tensor, split, ctx) -> torch.Tensor:
    if split is None:
        return x
    dim, axes = split
    c = x.shape[dim] // ctx.size(axes)
    return x.narrow(dim, ctx.index(axes) * c, c)


def _splits(params, ctx, specs, mspecs):
    n = len(tree.leaves(params))
    if ctx is None or ctx.mesh is None or mspecs is None:
        return [None] * n
    return [zero_split(ps, ms) for ps, ms in zip(
        tree.leaves(specs, dicts_only=True),
        tree.leaves(mspecs, dicts_only=True))]


def init_state(params, *, ctx=None, specs=None,
               mspecs=None) -> Dict[str, Any]:
    """Zero moments of each parameter's shape; on a mesh (``ctx``, the
    parameters' ``specs`` and the moments' ``mspecs``) of the rank's
    ZeRO slice of its block."""
    flat = tree.leaves(params)
    splits = _splits(params, ctx, specs, mspecs)

    def zeros():
        return tree.unflatten(params, [
            torch.zeros(_chunk(p, sp, ctx).shape, dtype=torch.float32,
                        device=p.device) for p, sp in zip(flat, splits)])

    return {
        "m": zeros(),
        "v": zeros(),
        "step": torch.zeros((), dtype=torch.int32, device=_device(params)),
    }


def abstract_state(params) -> Dict[str, Any]:
    """The state's shapes on the ``meta`` device."""
    def zeros(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    return {"m": tree.tree_map(zeros, params),
            "v": tree.tree_map(zeros, params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def global_norm(grads, *, ctx=None, specs=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf.  On a mesh the sharded
    leaves' squares are ``psum``med over their axes (one collective a set
    of axes), the replicated ones counted once; the sum runs in leaf
    order either way."""
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in tree.leaves(grads)]
    if ctx is not None and ctx.mesh is not None and specs is not None:
        groups: Dict[tuple, list] = {}
        for i, sp in enumerate(tree.leaves(specs, dicts_only=True)):
            axes = tuple(a for ax in sp if ax for a in ax)
            if axes:
                groups.setdefault(axes, []).append(i)
        for axes, idx in groups.items():
            red = ctx.psum(torch.stack([sq[i] for i in idx]), axes)
            for j, i in enumerate(idx):
                sq[i] = red[j]
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
    ctx=None,
    specs=None,
    mspecs=None,
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  ``transform(grads) -> grads`` lets
    compression hooks rewrite the clipped float32 gradient tree before the
    moment update.  On a mesh: ``ctx``, the parameters' ``specs`` and the
    moments' ``mspecs`` (see the module docstring).  Returns (params,
    state, {"grad_norm"})."""
    gn = global_norm(grads, ctx=ctx, specs=specs)
    scale = clip_scale(gn, cfg.grad_clip)
    if transform is not None:
        grads = transform(tree.tree_map(
            lambda g: g.to(torch.float32) * scale, grads))
        scale = None
    state["step"].add_(1)
    bc1, bc2 = bias_corrections(cfg, state["step"])
    splits = _splits(params, ctx, specs, mspecs)
    for p_full, g, m, v, split in zip(
            tree.leaves(params), tree.leaves(grads), tree.leaves(state["m"]),
            tree.leaves(state["v"]), splits):
        p = _chunk(p_full, split, ctx)
        g = _chunk(g, split, ctx).to(torch.float32)
        if scale is not None:
            g = g * scale           # clipped one leaf at a time
        delta = moments(cfg, m, v, g, bc1, bc2)
        # decoupled weight decay on matrices only (ndim >= 2)
        if p.ndim >= 2:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        write_param(cfg, p, delta, lr_scale)
        if split is not None:       # ZeRO-1: every rank's slice back
            p_full.copy_(ctx.all_gather(p.contiguous(), split[1],
                                        dim=split[0]))
    return params, state, {"grad_norm": gn}
