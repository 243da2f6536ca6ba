"""Mixture-of-Experts layer: top-K routing with capacity dropping.  The
counterpart of ``repro.models.moe``.

Each token's router picks K experts (float32 softmax, the top K
renormalised); each (token, k) takes the next place in its expert's
queue, over the flattened (T * K) order, and is dropped when that place is
at or past the expert's capacity ``ceil(K * T * capacity_factor / E)``.
The kept rows go into an (E * C, D) buffer, every expert's FFN runs as one
batched product over its C slots, and each token sums its K experts'
outputs weighted by the gates.  A dropped (token, k) contributes zero.

Where the reference reads ``REPRO_PERF=moe_sort_dispatch`` the port takes
the default branch, the (T * K, E) one-hot cumsum (the sort branch gives
the same integer places): the port has no environment switches.  Two
differences of form, same numbers:

- ``lax.top_k`` keeps the lower expert index on equal values and
  ``torch.topk`` promises no order on ties, so the top K are the first K
  of a stable descending sort;
- the reference scatter-adds the (token, k) rows onto a zero buffer; each
  slot receives at most one row, so the port gathers each slot's token row
  (an index copy of token ids, then ``index_select``), the same values.

The block is differentiable (``train_loss``), its load-balance loss
included.  Capacity is reckoned over the tokens of the call: a decode
step of B tokens drops differently from a prefill of B * S, as in the
reference.

**Expert parallel** (``ctx`` on a mesh, the reference's ``shard_map``
branch): each rank holds E / ep experts (the ``expert`` rule) and its data
shard's tokens.  Routing runs redundantly on every rank of the expert
axes (the activations are the same there), so dispatch needs no
communication: each rank fills its local experts' slots, and the layer
ends in one ``reduce_from`` over the expert axes.  Capacity is reckoned
over the data shard's tokens (``_capacity(cfg, t_local)``), so with
``data`` > 1 the drops differ from one device unless nothing drops, as in
the reference.  The load-balance loss is averaged over the batch axes.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ShardCtx, activate

_NO_MESH = ShardCtx()


def _capacity(cfg: ModelConfig, t: int) -> int:
    """Slots per expert for ``t`` tokens, at least 1 and at most t * K."""
    c = math.ceil(cfg.experts_per_token * t * cfg.capacity_factor
                  / cfg.num_experts)
    return max(1, min(c, t * cfg.experts_per_token))


def _route(cfg: ModelConfig, router_w: torch.Tensor, x_flat: torch.Tensor):
    """(T, D) -> (gates (T, K) float32, expert idx (T, K) int64, the
    Switch-style load-balance loss E * sum_e f_e * p_e, 0-dim float32)."""
    logits = torch.matmul(x_flat.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    k, e = cfg.experts_per_token, cfg.num_experts
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]
    gates = gates / gates.sum(dim=-1, keepdim=True)
    frac = F.one_hot(idx, e).float().mean(dim=(0, 1)) * k
    aux = e * torch.sum(frac * probs.mean(dim=0))
    return gates, idx, aux


def _slots(cfg: ModelConfig, idx: torch.Tensor, e_lo: int = 0,
           e_local: Optional[int] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Expert idx (T, K) -> (slot (T * K,), valid (T * K,), capacity C).
    ``slot`` is (expert - e_lo) * C + the (token, k)'s place in its
    expert's queue, or E_local * C where the place is past the capacity or
    the expert is not one of the rank's [e_lo, e_lo + E_local) (``valid``
    False)."""
    t, k = idx.shape
    e = cfg.num_experts
    e_local = e if e_local is None else e_local
    flat = idx.reshape(t * k)
    oh = F.one_hot(flat, e)
    pos = (torch.cumsum(oh, dim=0) - 1).gather(1, flat[:, None])[:, 0]
    cap = _capacity(cfg, t)
    valid = pos < cap
    lid = flat - e_lo
    if e_local != e:
        valid &= (lid >= 0) & (lid < e_local)
    slot = torch.where(valid, lid * cap + pos,
                       torch.full_like(flat, e_local * cap))
    return slot, valid, cap


def moe_block(cfg: ModelConfig, p: Dict, x: torch.Tensor, *,
              ctx: ShardCtx = _NO_MESH
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D) in x's dtype, aux load-balance loss).
    p: router (D, E), w_gate / w_up (E, D, F), w_down (E, F, D), float32
    master weights cast to x's dtype; on a mesh the rank's experts
    (E_local, ...) and x the rank's rows."""
    b, s, d = x.shape
    t, k, e = b * s, cfg.experts_per_token, cfg.num_experts
    ep = ctx.axes("expert")
    n_ep = ctx.size(ep)
    if e % n_ep:
        raise ValueError(f"num_experts={e} not divisible by EP={n_ep}")
    e_local = e // n_ep
    e_lo = ctx.index(ep) * e_local
    x_flat = x.reshape(t, d)
    gates, idx, aux = _route(cfg, p["router"], x_flat)
    slot, _, cap = _slots(cfg, idx, e_lo, e_local)
    # routing is the same on every expert rank; its use is not
    gates = ctx.copy_to(gates, ep)
    xs = ctx.copy_to(x_flat, ep)

    # Dispatch: each slot's token id (t, the zero row, for an empty slot;
    # the dropped pairs all land on the extra slot E * C, cut off).
    tok = torch.arange(t * k, device=x.device) // k
    src = torch.full((e_local * cap + 1,), t, dtype=tok.dtype,
                     device=x.device)
    src.index_copy_(0, slot, tok)
    x_pad = torch.cat([xs, xs.new_zeros((1, d))])
    buf = x_pad.index_select(0, src[:-1]).reshape(e_local, cap, d)

    # Expert FFN: one batched product over the E experts' C slots.
    gate = torch.bmm(buf, p["w_gate"].to(x.dtype))
    up = torch.bmm(buf, p["w_up"].to(x.dtype))
    h = activate(gate, up, cfg.activation)
    y_buf = torch.bmm(h, p["w_down"].to(x.dtype)).reshape(e_local * cap, d)

    # Combine: each (token, k) reads its slot back (the zero row if
    # dropped or another rank's), weighted by its gate.
    y_all = torch.cat([y_buf, y_buf.new_zeros((1, d))])
    gathered = y_all.index_select(0, slot).reshape(t, k, d)
    y = (gathered * gates.reshape(t, k, 1).to(y_buf.dtype)).sum(dim=1)
    y = ctx.reduce_from(y, ep)
    b_ax = ctx.axes("batch")
    if ctx.size(b_ax) > 1:
        aux = ctx.reduce_from(aux, b_ax) / ctx.size(b_ax)
    return y.reshape(b, s, d), aux
