"""Parameter schema and initialisation: the counterpart of
``repro.models.schema`` for the six families (``dense``, ``vlm``, ``moe``,
``ssm``, ``hybrid``, ``encdec``).

Parameters are a nested dict of tensors in the reference's layout: the
``layers`` subtree is stacked with a leading (num_layers,) dim and the
encoder's ``enc_layers`` with (encoder_layers,), so that carrying the
reference's weights over is a map over leaves (``models/convert.py``).
The init rules are the reference's (``normal`` scaled by 1/sqrt(fan_in),
``embed``, ``conv``, ``a_log``, ``dt_bias``, ``ones``, ``zeros``); the
random leaves are drawn from one explicit ``torch.Generator`` in schema
order, so they do not equal the reference's draws (randomness is an
input: the parity tests carry the reference's weights over instead).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ShardCtx, gated

PORTED_FAMILIES = ("hybrid", "ssm", "dense", "vlm", "moe", "encdec")


def require_ported(cfg: ModelConfig) -> None:
    """Raise for a family the port does not run."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not one the port runs "
            f"{PORTED_FAMILIES}")


@dataclasses.dataclass(frozen=True)
class PD:
    """Param descriptor: shape, logical axes, init rule."""

    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"   # normal | zeros | ones | a_log | dt_bias | embed | conv
    fan_in: Optional[int] = None


def _attn(cfg: ModelConfig) -> Dict[str, PD]:
    d, hp, hkv, dh = (cfg.d_model, cfg.padded_heads, cfg.padded_kv_heads,
                      cfg.head_dim)
    return {
        "wq": PD((d, hp, dh), (None, "heads", None), fan_in=d),
        "wk": PD((d, hkv, dh), (None, "kv_heads", None), fan_in=d),
        "wv": PD((d, hkv, dh), (None, "kv_heads", None), fan_in=d),
        "wo": PD((hp, dh, d), ("heads", None, None), fan_in=hp * dh),
    }


def _mlp(cfg: ModelConfig) -> Dict[str, PD]:
    d, f = cfg.d_model, cfg.d_ff
    out = {"w_up": PD((d, f), (None, "mlp"), fan_in=d),
           "w_down": PD((f, d), ("mlp", None), fan_in=f)}
    if gated(cfg.activation):
        out["w_gate"] = PD((d, f), (None, "mlp"), fan_in=d)
    return out


def _norm(cfg: ModelConfig) -> PD:
    return PD((cfg.d_model,), (None,),
              init="zeros" if cfg.sandwich_norm else "ones")


def _dense_layer(cfg: ModelConfig) -> Dict[str, PD]:
    out = {"ln1": _norm(cfg), "ln2": _norm(cfg), **_attn(cfg), **_mlp(cfg)}
    if cfg.sandwich_norm:
        out["ln1_post"] = _norm(cfg)
        out["ln2_post"] = _norm(cfg)
    return out


def _moe_layer(cfg: ModelConfig) -> Dict[str, PD]:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.d_ff
    return {
        "ln1": _norm(cfg), "ln2": _norm(cfg), **_attn(cfg),
        "router": PD((d, e), (None, None), fan_in=d),
        "w_gate": PD((e, d, f), ("expert", None, None), fan_in=d),
        "w_up": PD((e, d, f), ("expert", None, None), fan_in=d),
        "w_down": PD((e, f, d), ("expert", None, None), fan_in=f),
    }


def _encdec_dec_layer(cfg: ModelConfig) -> Dict[str, PD]:
    """Self-attention, the ``x``-prefixed cross-attention, the MLP."""
    return {"ln1": _norm(cfg), "ln_x": _norm(cfg), "ln2": _norm(cfg),
            **_attn(cfg), **{"x" + k: v for k, v in _attn(cfg).items()},
            **_mlp(cfg)}


def _ssm_layer(cfg: ModelConfig) -> Dict[str, PD]:
    d, di = cfg.d_model, cfg.ssm_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    w = cfg.ssm_conv_width
    return {
        "ln": PD((d,), (None,), init="ones"),
        "wz": PD((d, di), (None, "mlp"), fan_in=d),
        "wx": PD((d, di), (None, "mlp"), fan_in=d),
        "wbc": PD((d, 2 * g * n), (None, None), fan_in=d),
        "wdt": PD((d, h), (None, "ssm_heads"), fan_in=d),
        "conv_x_w": PD((w, di), (None, "mlp"), init="conv"),
        "conv_x_b": PD((di,), ("mlp",), init="zeros"),
        "conv_bc_w": PD((w, 2 * g * n), (None, None), init="conv"),
        "conv_bc_b": PD((2 * g * n,), (None,), init="zeros"),
        "dt_bias": PD((h,), ("ssm_heads",), init="dt_bias"),
        "a_log": PD((h,), ("ssm_heads",), init="a_log"),
        "d_skip": PD((h,), ("ssm_heads",), init="ones"),
        "norm_w": PD((di,), ("mlp",), init="ones"),
        "out_proj": PD((di, d), ("mlp", None), fan_in=di),
    }


def param_schema(cfg: ModelConfig) -> Dict[str, Any]:
    """Nested schema.  The ``layers`` and ``enc_layers`` subtrees are
    per-layer and get stacked (``map_schema``)."""
    require_ported(cfg)
    d, vp = cfg.d_model, cfg.padded_vocab
    schema: Dict[str, Any] = {
        "embed": PD((vp, d), ("vocab", "embed"), init="embed"),
        "final_norm": _norm(cfg),
    }
    if not cfg.tie_embeddings:
        schema["lm_head"] = PD((d, vp), ("embed", "vocab"), fan_in=d)
    if cfg.family in ("dense", "vlm"):
        schema["layers"] = _dense_layer(cfg)
    elif cfg.family == "moe":
        schema["layers"] = _moe_layer(cfg)
    elif cfg.family == "ssm":
        schema["layers"] = _ssm_layer(cfg)
    elif cfg.family == "encdec":
        # learned positions; the decoder's sized for the reference's
        # largest decode shape (32,768), past whisper's published 448
        schema["enc_pos"] = PD((cfg.encoder_seq, d), (None, "embed"),
                               init="embed")
        schema["dec_pos"] = PD((32_768, d), (None, "embed"), init="embed")
        schema["enc_layers"] = _dense_layer(cfg)
        schema["enc_final_norm"] = _norm(cfg)
        schema["layers"] = _encdec_dec_layer(cfg)
    else:                                   # hybrid
        schema["layers"] = _ssm_layer(cfg)
        schema["shared_attn"] = {"ln1": _norm(cfg), "ln2": _norm(cfg),
                                 **_attn(cfg), **_mlp(cfg)}
    return schema


def map_schema(cfg: ModelConfig,
               fn: Callable[[PD, Tuple[int, ...], Tuple[str, ...]], Any]):
    """``fn(pd, shape, path)`` over the schema, ``shape`` with the leading
    stacked dim in the stacked subtrees (``layers``: num_layers,
    ``enc_layers``: encoder_layers) -> the same nesting."""
    stack = {"layers": cfg.num_layers, "enc_layers": cfg.encoder_layers}

    def rec(node, stacked, path):
        if isinstance(node, PD):
            shape = node.shape if stacked is None else (stacked,) + node.shape
            return fn(node, shape, path)
        return {k: rec(v, stack.get(k, stacked), path + (k,))
                for k, v in node.items()}

    return rec(param_schema(cfg), None, ())


def _linspace(start: float, stop: float, num: int) -> torch.Tensor:
    """``jnp.linspace`` in float32, term for term: start (1 - t) + stop t
    with t = i / (num - 1), the last point set to ``stop``."""
    lo = torch.tensor(start, dtype=torch.float32)
    hi = torch.tensor(stop, dtype=torch.float32)
    if num == 1:
        return lo[None]
    t = torch.arange(num - 1, dtype=torch.float32) / float(num - 1)
    return torch.cat([lo * (1 - t) + hi * t, hi[None]])


def _init_leaf(pd: PD, shape, gen: torch.Generator, dtype) -> torch.Tensor:
    """One leaf on the generator's device (the stacked dims come first in
    ``shape``; deterministic rules repeat over them)."""
    dev = gen.device
    if pd.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if pd.init == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    if pd.init == "a_log":
        row = torch.log(_linspace(1.0, 16.0, shape[-1]))
        return row.to(dtype).expand(shape).to(dev).contiguous()
    if pd.init == "dt_bias":
        # inverse-softplus of dt in [1e-3, 1e-1], log-spaced
        dt = torch.exp(_linspace(math.log(1e-3), math.log(1e-1), shape[-1]))
        row = torch.log(torch.expm1(dt))
        return row.to(dtype).expand(shape).to(dev).contiguous()
    if pd.init == "embed":
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)
    if pd.init == "conv":
        u = torch.rand(shape, generator=gen, device=dev) * 2.0 - 1.0
        return (u / math.sqrt(pd.shape[0])).to(dtype)
    fan = pd.fan_in or pd.shape[0]
    return (torch.randn(shape, generator=gen, device=dev)
            / math.sqrt(fan)).to(dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                dtype=torch.float32, *, ctx: Optional[ShardCtx] = None
                ) -> Dict[str, Any]:
    """Materialised parameters (float32 master weights by default) on
    ``device`` (default: the GPU).  Random leaves are drawn on the
    generator's device, in schema order, then moved.  On a mesh
    (``ctx``) each leaf is drawn whole, as on one device, and this rank
    keeps its block of it (``param_specs``)."""
    device = resolve_device(device)
    specs = param_specs(cfg, ctx) if ctx is not None else None

    def build(pd, shape, path):
        leaf = _init_leaf(pd, shape, generator, dtype).to(device)
        if specs is None or ctx.mesh is None:
            return leaf
        return ctx.local(leaf, _at(specs, path)).clone()

    return map_schema(cfg, build)


def abstract_params(cfg: ModelConfig, dtype=torch.float32) -> Dict[str, Any]:
    """The parameters' shapes and dtype on the ``meta`` device (no
    storage): the counterpart of the reference's ShapeDtypeStructs."""
    return map_schema(cfg, lambda pd, shape, path: torch.empty(
        shape, dtype=dtype, device="meta"))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def param_specs(cfg: ModelConfig, ctx: ShardCtx):
    """The spec tree (a spec: one entry a dim, None or a tuple of mesh
    axes; stacked subtrees get a leading replicated dim).  Dims whose size
    doesn't divide the assigned mesh axes fall back to replicated (e.g. 10
    KV heads on a 16-way model axis)."""

    def build(pd: PD, shape, path):
        axes = tuple(ctx.checked(lg, s)
                     for lg, s in zip(pd.logical, pd.shape))
        if len(shape) > len(pd.shape):
            axes = (None,) + axes
        return axes

    return map_schema(cfg, build)


def param_shardings(cfg: ModelConfig, ctx: ShardCtx):
    """The spec tree on a mesh, None without one (the reference's
    NamedShardings are specs over its mesh; here the mesh is ctx's)."""
    if ctx.mesh is None:
        return None
    return param_specs(cfg, ctx)


def map_specs(fn: Callable, specs, *trees):
    """``fn(spec, *leaves)`` over a spec tree and trees of its nesting
    (dicts; a spec is a tuple, so the trees' own ``tree_map`` would walk
    into it)."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    return fn(specs, *trees)


def shard_params(params, cfg: ModelConfig, ctx: ShardCtx):
    """Full parameters -> this rank's blocks (copies)."""
    return map_specs(lambda sp, x: ctx.local(x, sp).clone(),
                     param_specs(cfg, ctx), params)


def gather_params(params, cfg: ModelConfig, ctx: ShardCtx):
    """This rank's blocks -> the full parameters (every rank)."""
    return map_specs(lambda sp, x: ctx.gather(x, sp),
                     param_specs(cfg, ctx), params)


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The shape of every leaf, nested as the parameters are."""
    return map_schema(cfg, lambda pd, shape, path: shape)


def param_count_actual(params) -> int:
    def count(node):
        if isinstance(node, dict):
            return sum(count(v) for v in node.values())
        return node.numel()
    return count(params)
