"""Shared model layers: norms, activations, RoPE and M-RoPE, embeddings
and the logit head.  The counterpart of ``repro.models.layers`` without its
``ShardCtx``: the port runs on one device and has no mesh."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMS norm in float32, returned in ``x``'s dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if plus_one else w.float()
    return (y * scale).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap > 0 else x


def activate(gate: torch.Tensor, up: Optional[torch.Tensor],
             kind: str) -> torch.Tensor:
    """swiglu/geglu are gated (need ``up``); gelu is the plain 2-matrix MLP."""
    if kind == "swiglu":
        return F.silu(gate) * up
    if kind == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    if kind == "gelu":
        return F.gelu(gate, approximate="tanh")
    raise ValueError(kind)


def gated(kind: str) -> bool:
    return kind in ("swiglu", "geglu")


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); pos: (B, S) integer -> rotary-embedded x."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # (Dh/2,)
    ang = pos[..., None].float() * freqs                     # (B, S, Dh/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., : dh // 2], x32[..., dh // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, pos3: torch.Tensor,
                theta: float) -> torch.Tensor:
    """M-RoPE (qwen2-vl): pos3 (B, S, 3) = (temporal, height, width) ids.
    The Dh/2 frequency pairs are split into three contiguous sections,
    each rotated by its own position stream."""
    dh = x.shape[-1]
    half = dh // 2
    s1 = half - 2 * (half // 3)
    sections = (s1, half // 3, half // 3)
    freqs = rope_freqs(dh, theta, x.device)
    parts, lo = [], 0
    for i, sec in enumerate(sections):
        parts.append(pos3[..., i][..., None].float() * freqs[lo: lo + sec])
        lo += sec
    ang = torch.cat(parts, dim=-1)                           # (B, S, Dh/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding + logits
# ---------------------------------------------------------------------------

def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor, dtype, *,
                 scale: bool = False) -> torch.Tensor:
    """Rows of the embedding table in ``dtype``.  The reference casts the
    whole table and then gathers; gathering first and casting the rows
    gives the same values without a cast copy of the table."""
    x = embed[tokens.long()].to(dtype)
    if scale:
        x = (x.float() * float(embed.shape[1]) ** 0.5).to(dtype)
    return x


def lm_logits(x: torch.Tensor, head: torch.Tensor, *,
              cap: float = 0.0) -> torch.Tensor:
    """x: (..., D) @ head (D, V) -> float32 logits."""
    logits = torch.matmul(x.float(), head.float())
    return softcap(logits, cap)


def xent_loss(logits: torch.Tensor, labels: torch.Tensor, *,
              real_vocab: int) -> torch.Tensor:
    """Mean cross-entropy over the valid labels of a (possibly padded)
    logits tensor (..., Vp): padded vocab slots are masked to -1e30,
    labels < 0 are ignored."""
    v = logits.shape[-1]
    if real_vocab < v:
        pad = torch.arange(v, device=logits.device) >= real_vocab
        logits = torch.where(pad, -1e30, logits)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.long().clamp(min=0)[..., None])[..., 0]
    nll = lse - gold
    ok = (labels >= 0).to(torch.float32)
    return torch.sum(nll * ok) / torch.clamp(torch.sum(ok), min=1.0)
