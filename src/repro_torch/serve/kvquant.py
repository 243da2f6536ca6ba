"""Symmetric int8 quantization with one float32 scale per slice.

    q[s] = round(x[s] / scale[s]),   scale[s] = amax|x[s]| / 127

The serving path quantizes the item factors ``v`` (N, k) with
``axis=-1``, so each item row's scale folds into the score contraction
(``(q . v_q[j]) * scale[j]``) and no dequantized factor matrix is ever
resident.  ``torch.round`` rounds half to even, as ``jnp.round`` does.

The LM's int8 KV cache (``transformer.init_cache(kv_quant=True)``) keeps
one scale per cached position (``axis=-1`` over the head dim), so the
scale folds into the decode contractions the same way:

    logits[s] = (q . k_q[s]) * scale_k[s]
    out = sum_s (p[s] * scale_v[s]) . v_q[s]

(``attend_q8`` / ``combine_q8``): the scales are not applied to the
cache, which is only widened to float32 for the products, as in the
reference.
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantize(x: torch.Tensor, axis: int = -1
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over ``axis``: -> int8 values + float32 scales with
    a keepdims-1 scale axis (default (.., S, 1)).  ``axis`` is the reduced
    dimension: each slice along it shares one scale.  Max round-trip error
    per element is scale/2 = amax/254 along its slice."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize`; scale broadcasts over its 1-axis."""
    return q.to(torch.float32) * scale


def attend_q8(qg: torch.Tensor, k_q: torch.Tensor,
              k_scale: torch.Tensor) -> torch.Tensor:
    """Decode logits against an int8 K cache.  qg (B, Hkv, G, Dh) float32,
    k_q (B, Hkv, S, Dh) int8, k_scale (B, Hkv, S, 1) float32 -> (B, Hkv, G,
    S) float32."""
    logits = torch.einsum("bhgk,bhsk->bhgs", qg, k_q.to(torch.float32))
    return logits * k_scale[..., 0][:, :, None, :]


def combine_q8(probs: torch.Tensor, v_q: torch.Tensor,
               v_scale: torch.Tensor) -> torch.Tensor:
    """probs (B, Hkv, G, S) float32 against an int8 V cache (B, Hkv, S, Dh)
    with its scales (B, Hkv, S, 1) -> (B, Hkv, G, Dh) float32."""
    p_scaled = probs * v_scale[..., 0][:, :, None, :]
    return torch.einsum("bhgs,bhsk->bhgk", p_scaled, v_q.to(torch.float32))
