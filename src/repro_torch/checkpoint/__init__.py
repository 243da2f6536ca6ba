"""Checkpoints of trees of tensors and of the port's containers, in the
reference's on-disk format (files cross between the two packages)."""
from repro_torch.checkpoint.ckpt import Checkpointer, tree_signature  # noqa: F401
