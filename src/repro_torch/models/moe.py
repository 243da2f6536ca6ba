"""Mixture-of-Experts layer on one device: top-K routing with capacity
dropping.  The counterpart of ``repro.models.moe`` for ``mesh=None``.

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

The expert-parallel branch of the reference's ``moe_block`` (a
``shard_map`` over the model mesh) belongs to the LM model mesh, which
serving and training share (ROADMAP.md item 16); on one device the block
is differentiable (``train_loss``), its load-balance loss included.  Capacity is reckoned over the tokens of the call: a decode step
of B tokens drops differently from a prefill of B * S, as in the
reference.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import activate


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


def _slots(cfg: ModelConfig, idx: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Expert idx (T, K) -> (slot (T * K,), valid (T * K,), capacity C).
    ``slot`` is expert * C + the (token, k)'s place in its expert's queue,
    or E * C where the place is past the capacity (``valid`` False)."""
    t, k = idx.shape
    e = cfg.num_experts
    flat = idx.reshape(t * k)
    oh = F.one_hot(flat, e)
    pos = (torch.cumsum(oh, dim=0) - 1).gather(1, flat[:, None])[:, 0]
    cap = _capacity(cfg, t)
    valid = pos < cap
    slot = torch.where(valid, flat * cap + pos,
                       torch.full_like(flat, e * cap))
    return slot, valid, cap


def moe_block(cfg: ModelConfig, p: Dict, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D) in x's dtype, aux load-balance loss).
    p: router (D, E), w_gate / w_up (E, D, F), w_down (E, F, D), float32
    master weights cast to x's dtype."""
    b, s, d = x.shape
    t, k, e = b * s, cfg.experts_per_token, cfg.num_experts
    x_flat = x.reshape(t, d)
    gates, idx, aux = _route(cfg, p["router"], x_flat)
    slot, _, cap = _slots(cfg, idx)

    # Dispatch: each slot's token id (t, the zero row, for an empty slot;
    # the dropped pairs all land on the extra slot E * C, cut off).
    tok = torch.arange(t * k, device=x.device) // k
    src = torch.full((e * cap + 1,), t, dtype=tok.dtype, device=x.device)
    src.index_copy_(0, slot, tok)
    x_pad = torch.cat([x_flat, x_flat.new_zeros((1, d))])
    buf = x_pad.index_select(0, src[:-1]).reshape(e, cap, d)

    # Expert FFN: one batched product over the E experts' C slots.
    gate = torch.bmm(buf, p["w_gate"].to(x.dtype))
    up = torch.bmm(buf, p["w_up"].to(x.dtype))
    h = activate(gate, up, cfg.activation)
    y_buf = torch.bmm(h, p["w_down"].to(x.dtype)).reshape(e * cap, d)

    # Combine: each (token, k) reads its slot back (the zero row if
    # dropped), weighted by its gate.
    y_all = torch.cat([y_buf, y_buf.new_zeros((1, d))])
    gathered = y_all.index_select(0, slot).reshape(t, k, d)
    y = (gathered * gates.reshape(t, k, 1).to(y_buf.dtype)).sum(dim=1)
    return y.reshape(b, s, d), aux

