"""Production and host meshes of the LM.

The counterpart of ``repro.launch.mesh``.  Kept as FUNCTIONS, never
module-level constants, as in the reference.

The reference's production mesh is 256 (or 512) devices in one program;
the port runs one mesh slot a process (``core/collectives.
ProcessGroupMesh``).  So the production mesh here is ONE SLOT of that
layout on the ``meta`` device: :class:`CountingMesh`, a ``BlockMesh`` in
the ``ProcessGroupMesh`` form (one local slot, collectives over a leading
dimension of 1) whose collectives move nothing.  ``psum`` and
``all_gather`` check their input as a process group's would and return
empty ``meta`` results of the right shapes, and record their result
bytes with the open cost counters (``launch/hlocost.py``) as
``all-reduce`` and ``all-gather``.  A rank's step on it is what the dry
run (``launch/dryrun.py``) prices: the model code sees the real layout
(its blocks, its collectives), and a shape that does not fit a block or a
collective raises, as a partitioner error does in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.collectives import BlockMesh
from repro_torch.launch import hlocost


class CountingMesh(BlockMesh):
    """Slot ``slot`` of a mesh of ``shape`` on ``meta``: collectives are
    shape-checked and counted, never run."""

    def __init__(self, shape, slot: int = 0):
        super().__init__(shape, "meta", (slot,))
        if not 0 <= slot < self.size:
            raise ValueError(f"slot {slot} is not in a mesh of {self.size}")

    def _one_slot(self, x: torch.Tensor, what: str) -> None:
        if x.device.type != "meta":
            raise ValueError(f"{what} on the counting mesh takes meta "
                             f"tensors, got one on {x.device}")
        if x.dim() < 1 or x.shape[0] != 1:
            raise ValueError(f"{what}: a rank holds one slot: leading "
                             f"dimension 1, got {tuple(x.shape)}")

    def psum(self, x, axes=None, *, over=None):
        axes, over, rest = self._split(axes, over)
        self._one_slot(x, "psum")
        self._tally("psum")
        hlocost.record_collective("all-reduce", hlocost.tensor_bytes(x[0]))
        return torch.empty_like(x)

    def all_gather(self, x, axes=None, *, over=None):
        axes, over, rest = self._split(axes, over)
        self._one_slot(x, "all_gather")
        self._tally("all_gather")
        out = torch.empty((1, self.axis_size(axes)) + tuple(x.shape[1:]),
                          dtype=x.dtype, device="meta")
        hlocost.record_collective("all-gather",
                                  hlocost.tensor_bytes(out[0]))
        return out


def make_production_mesh(*, multi_pod: bool = False) -> CountingMesh:
    """One slot of the target deployment: (16, 16) = 256 cards,
    ("data", "model"); two pods (2, 16, 16) = 512 cards with the "pod"
    axis outermost."""
    if multi_pod:
        return CountingMesh({"pod": 2, "data": 16, "model": 16})
    return CountingMesh({"data": 16, "model": 16})


def make_host_mesh(model_parallel: int = 1, device=None):
    """What this host has, the way both launchers build it
    (``launch/ranks.py``): ``plan_mesh`` over the slots present (the
    process group's ranks where one is initialized, else one slot on
    ``device``), with ``model_parallel`` on ``model``.  None on a rank that
    the plan leaves idle."""
    from repro_torch.core import collectives
    from repro_torch.launch.ranks import model_mesh

    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        pool = collectives.ProcessGroupMesh(
            {"blocks": dist.get_world_size()}, device=device)
    else:
        pool = collectives.LocalMesh(1, device)
    return model_mesh(pool, model_parallel, log=lambda line: None)
