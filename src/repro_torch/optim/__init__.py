"""Optimizers of the LM trainer: AdamW over nested dicts of tensors and
the LR schedules."""
from repro_torch.optim import adamw, schedule  # noqa: F401
from repro_torch.optim.adamw import AdamWConfig  # noqa: F401
