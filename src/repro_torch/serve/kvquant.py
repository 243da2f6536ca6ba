"""Symmetric int8 quantization with one float32 scale per slice.

    q[s] = round(x[s] / scale[s]),   scale[s] = amax|x[s]| / 127

The serving path quantizes the item factors ``v`` (N, k) with
``axis=-1``, so each item row's scale folds into the score contraction
(``(q . v_q[j]) * scale[j]``) and no dequantized factor matrix is ever
resident.  ``torch.round`` rounds half to even, as ``jnp.round`` does.
The int8 KV-cache attention helpers of the reference belong to the LM
side and are not ported yet.
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
