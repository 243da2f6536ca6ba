"""The training step: loss and gradients (with micro-batched
accumulation), the LR schedule, then AdamW or Ranky-GaLore.

The counterpart of ``repro.train.step``.  The train state is
{"params", "opt", "seed"}: the reference's ``rng`` key becomes an integer
``seed``, the root of a seed chain (step t's GaLore repair draws come
from ``derive_seed(seed, t)``), as ``StreamingSVDState`` chains its own;
``checkpoint_tree`` writes it as the reference's ``uint32[2]`` key, so a
train-state file crosses between the two packages.  Gradients are
``torch.autograd.grad`` over the parameter leaves; the update writes the
parameters and moments in place (``optim/adamw.py``).

On the model mesh (``ctx``, ``models/layers.ShardCtx``) the state holds
the rank's blocks: the parameters by ``param_specs``, the AdamW moments
and the GaLore state by ``state_shardings`` (ZeRO-1 over ``opt_shard``).
The step's gradients are the rank's blocks of the global loss's (the
model's collectives carry the tensor-parallel part) and are ``psum``med
over the batch axes; GaLore forms each basis from the whole gradient
(``compression/galore.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.ckpt import _key_to_seed, _seed_to_key
from repro_torch.compression import galore as galore_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.core.ranky import derive_seed
from repro_torch.models.layers import ShardCtx
from repro_torch.models.schema import abstract_params, init_params, \
    map_specs, param_specs
from repro_torch.models.transformer import train_loss
from repro_torch.optim import adamw, schedule, tree

# The reference's ``rng = PRNGKey(1)`` of a fresh train state.
DEFAULT_TRAIN_SEED = 1
# The subtrees stacked over layers (``models/schema.map_schema``).
STACKED = ("layers", "enc_layers")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"          # "adamw" | "galore"
    remat: str = "dots"               # "none" | "dots" | "full"
    microbatches: int = 1             # grad-accumulation steps
    warmup_steps: int = 100
    total_steps: int = 10_000
    adamw: adamw.AdamWConfig = adamw.AdamWConfig()
    galore: galore_mod.GaloreConfig = galore_mod.GaloreConfig()


_NO_MESH = ShardCtx()


def init_opt_state(tcfg: TrainConfig, params, cfg: ModelConfig = None,
                   ctx: ShardCtx = _NO_MESH) -> Dict[str, Any]:
    sh = state_shardings(cfg, tcfg, ctx)
    if tcfg.optimizer == "galore":
        return galore_mod.init_state(
            params, tcfg.galore, ctx=ctx,
            specs=None if sh is None else sh["params"])
    if sh is None:
        return adamw.init_state(params)
    return adamw.init_state(params, ctx=ctx, specs=sh["params"],
                            mspecs=sh["opt"]["m"])


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                     gen: torch.Generator, device=None, *,
                     seed: int = DEFAULT_TRAIN_SEED,
                     ctx: ShardCtx = _NO_MESH) -> Dict[str, Any]:
    """Float32 parameters drawn from ``gen`` onto ``device`` (default: the
    GPU), the optimizer's state and the seed; on a mesh the rank's
    blocks (the parameters drawn whole, as on one device, then cut)."""
    params = init_params(cfg, gen, resolve_device(device), ctx=ctx)
    return {"params": params, "opt": init_opt_state(tcfg, params, cfg, ctx),
            "seed": seed}


def abstract_train_state(cfg: ModelConfig, tcfg: TrainConfig
                         ) -> Dict[str, Any]:
    """The train state's shapes on the ``meta`` device, in the
    reference's layout (``rng`` a uint32[2] key)."""
    params = abstract_params(cfg)
    if tcfg.optimizer == "galore":
        opt = galore_mod.init_state(params, tcfg.galore)
    else:
        opt = adamw.abstract_state(params)
    return {"params": params, "opt": opt,
            "rng": torch.empty((2,), dtype=torch.uint32, device="meta")}


def state_shardings(cfg: ModelConfig, tcfg: TrainConfig, ctx: ShardCtx):
    """The spec tree of the train state (None without a mesh): parameters
    by ``param_specs``; AdamW's moments further ZeRO-split over
    ``opt_shard`` on their first unsharded, divisible dim (``adamw.
    zero_spec``); GaLore's state leaves ZeRO-split alone; ``step`` and
    ``rng`` replicated."""
    if ctx.mesh is None:
        return None
    pspecs = param_specs(cfg, ctx)
    state = abstract_train_state(cfg, tcfg)
    if tcfg.optimizer == "galore":
        opt = {"leaves": tree.tree_map(
            lambda x: adamw.zero_spec((), x.shape, ctx),
            state["opt"]["leaves"]), "step": ()}
    else:
        m = map_specs(lambda sp, x: adamw.zero_spec(sp, x.shape, ctx),
                      pspecs, state["opt"]["m"])
        opt = {"m": m, "v": m, "step": ()}
    return {"params": pspecs, "opt": opt, "rng": ()}


def checkpoint_tree(state: Dict[str, Any]) -> Dict[str, Any]:
    """The state as the reference writes it: ``seed`` as ``rng``, a
    ``uint32[2]`` key."""
    return {"params": state["params"], "opt": state["opt"],
            "rng": _seed_to_key(state["seed"])}


def state_from_checkpoint(saved: Dict[str, Any]) -> Dict[str, Any]:
    return {"params": saved["params"], "opt": saved["opt"],
            "seed": _key_to_seed(saved["rng"])}


def _live_params(params):
    """Parameters autograd can differentiate, sharing storage with
    ``params``: a stacked leaf becomes a list of its layers, each a leaf of
    its own (the model reads layer i as ``leaf[i]`` either way), so that
    each layer's gradient is its own tensor; slicing the stacked leaf would
    make every layer's gradient a zero-filled tensor of the whole stack,
    summed L times."""
    def live(p):
        return p.detach().requires_grad_(True)

    return {key: (tree.tree_map(lambda p: [live(x) for x in p.unbind(0)],
                                sub) if key in STACKED
                  else tree.tree_map(live, sub))
            for key, sub in params.items()}


def _restack(live_params, grads):
    """The gradients of ``_live_params``'s leaves (None: not reached, a
    zero gradient) as a tree of ``params``' structure, the stacked leaves
    stacked again."""
    built = tree.unflatten(live_params, grads)

    def fill(p, g):
        return torch.zeros_like(p) if g is None else g

    def restack(layers, grads_of):
        return torch.stack([fill(x, g) for x, g in zip(layers, grads_of)])

    return {key: ({k: restack(v, built[key][k]) for k, v in sub.items()}
                  if key in STACKED else tree.tree_map(fill, sub, built[key]))
            for key, sub in live_params.items()}


def _psum_tree(grads, ctx: ShardCtx, axes):
    """Every leaf ``psum``med over ``axes``, in one collective (float32)."""
    if ctx.mesh is None or not axes:
        return grads
    flat = tree.leaves(grads)
    buf = ctx.psum(torch.cat([g.reshape(-1).to(torch.float32)
                              for g in flat]), axes)
    out, at = [], 0
    for g in flat:
        out.append(buf[at: at + g.numel()].view(g.shape).to(g.dtype))
        at += g.numel()
    return tree.unflatten(grads, out)


def _grads(cfg: ModelConfig, tcfg: TrainConfig, params, batch,
           ctx: ShardCtx = _NO_MESH
           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss + aux, metrics, grads): gradients of every parameter leaf (a
    leaf the loss does not reach gets zeros).  With ``microbatches`` n > 1
    the batch is split in n along its first dim, the gradients summed in
    float32 and divided by n, the loss the mean of the n totals and
    ``aux_loss`` 0, as in the reference."""
    live_params = _live_params(params)
    live = tree.leaves(live_params)

    def value_and_grad(b):
        total, metrics = train_loss(cfg, live_params, b, remat=tcfg.remat,
                                    ctx=ctx)
        gs = torch.autograd.grad(total, live, allow_unused=True)
        return total.detach(), metrics, _restack(live_params, gs)

    n = tcfg.microbatches
    if n <= 1:
        loss, metrics, grads = value_and_grad(batch)
        return loss, {k: v.detach() for k, v in metrics.items()}, grads
    flat = tree.leaves(params)
    micro = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
             for k, v in batch.items()}
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in flat]
    lsum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    for i in range(n):
        loss, _, grads = value_and_grad({k: v[i] for k, v in micro.items()})
        for a, g in zip(acc, tree.leaves(grads)):
            a.add_(g.to(torch.float32))
        lsum = lsum + loss
        del grads
    grads = [a / n for a in acc]
    loss = lsum / n
    return loss, {"loss": loss, "aux_loss": torch.zeros_like(loss)}, \
        tree.unflatten(params, grads)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    ctx: ShardCtx = _NO_MESH) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``: the loss, the
    gradients, the schedule's scale at the optimizer's step, then AdamW or
    GaLore (clipping first), in place.  Metrics: ``loss``, ``aux_loss``,
    ``grad_norm``, ``lr_scale`` (0-dim tensors).  On a mesh ``state`` and
    ``batch`` are the rank's blocks (``state_shardings``,
    ``data.tokens.shard_batch``)."""
    sh = state_shardings(cfg, tcfg, ctx)
    mesh_kw = {} if sh is None else dict(ctx=ctx, specs=sh["params"])
    if sh is not None and tcfg.optimizer == "adamw":
        mesh_kw["mspecs"] = sh["opt"]["m"]

    def step(state, batch):
        params = state["params"]
        _, metrics, grads = _grads(cfg, tcfg, params, batch, ctx)
        grads = _psum_tree(grads, ctx, ctx.axes("batch"))
        opt = state["opt"]
        lr_scale = schedule.warmup_cosine(
            opt["step"], warmup=tcfg.warmup_steps, total=tcfg.total_steps)
        if tcfg.optimizer == "galore":
            step_seed = derive_seed(state["seed"], int(opt["step"]))
            _, _, om = galore_mod.apply_updates(
                tcfg.adamw, tcfg.galore, params, grads, opt,
                lr_scale=lr_scale, seed=step_seed, **mesh_kw)
        else:
            _, _, om = adamw.apply_updates(tcfg.adamw, params, grads, opt,
                                           lr_scale=lr_scale, **mesh_kw)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["lr_scale"] = lr_scale
        return state, metrics

    return step
