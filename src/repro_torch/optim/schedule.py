"""LR schedules (pure functions of the step counter), in float32.  The
step is an int or a 0-dim tensor; the result is a 0-dim float32 tensor on
the step's device (the CPU for an int)."""
from __future__ import annotations

import math

import torch


def _step32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def warmup_cosine(step, *, warmup: int = 100, total: int = 10_000,
                  min_ratio: float = 0.1) -> torch.Tensor:
    t = _step32(step)
    warm = t / max(warmup, 1)
    prog = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(t < warmup, warm, cos)


def constant(step) -> torch.Tensor:
    return torch.ones_like(_step32(step))
