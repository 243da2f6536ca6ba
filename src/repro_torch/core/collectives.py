"""Collectives over the block axis: the port's counterpart of the
reference's ``compat.axis_size`` and of ``jax.lax.psum`` / ``all_gather``
/ ``axis_index`` inside ``shard_map``.

A :class:`BlockMesh` names the block slots of a sharded solve: one slot a
column block, laid out over named axes (``{"blocks": 8}``, or ``{"pod": 2,
"model": 4}`` for the two-level merge), the flat slot index row-major over
the axes in mesh order.  A process holds ``local_slots`` of them, and every
shard function of the engine (``core/distributed.py``, the sharded ingest
and window, the sharded ranker) is written ONCE over the process's
``(n_local, ...)`` stack of blocks:

* :class:`LocalMesh`: one process holds every slot, as a leading batch
  axis (``n_local = D``) on one device.  The counterpart of the reference's
  forced host devices: each kernel launches once over the D-stack, as the
  single-host engine launches it.
* :class:`ProcessGroupMesh`: one slot a rank of a ``torch.distributed``
  process group (``n_local = 1``).  NCCL when the ranks own a GPU each;
  gloo runs several ranks on one card (or on the CPU, in the tests).

Every collective takes the tensor's ``over`` axes: the axes it still
varies over (the others it is the same along, having been reduced or
gathered over them before).  Its leading dimension holds, on a local mesh,
one entry per combination of the ``over`` axes (row-major in mesh order),
and on a process group one entry, this rank's.  So

* ``psum(x, axes)`` sums over the slots of ``axes``: the result varies over
  ``over - axes`` (a leading 1 when nothing is left: the sum over the whole
  mesh);
* ``all_gather(x, axes)`` stacks the slots of ``axes`` in their row-major
  order behind the leading dimension: ``(G, D_axes, ...)``, G the entries
  of ``over - axes``;
* ``axis_index(axes)`` is each local slot's flat index over ``axes``
  (row-major, as in the reference's ``distributed._flat_index``).

Determinism.  Within one backend a repeat gives the same bits: a local
mesh sums its slots one after the other in ascending slot order, and a
process group's reduction runs in the fixed order of its backend for a
fixed world.  Across backends the sums run in different orders, so their
results agree to float32 rounding, not bit for bit.  A replicated result
(a psum over the whole mesh, the merge that follows it) is computed once on
a local mesh, not once a slot.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Iterable, Sequence, Tuple, Union

import torch

from repro_torch import resolve_device

Axes = Union[None, str, Sequence[str]]
Shape = Union[int, Dict[str, int], Sequence[Tuple[str, int]]]


def _as_shape(shape: Shape) -> Dict[str, int]:
    if isinstance(shape, int):
        shape = {"blocks": shape}
    out = dict(shape)
    if not out:
        raise ValueError("a BlockMesh needs at least one axis")
    for name, size in out.items():
        if int(size) < 1:
            raise ValueError(f"mesh axis {name!r} has size {size}; want >= 1")
    return {str(k): int(v) for k, v in out.items()}


class BlockMesh:
    """The block slots of a sharded solve over named axes (see the module
    docstring).  Subclasses move the data; this class holds the layout."""

    def __init__(self, shape: Shape, device, local_slots: Iterable[int]):
        self.shape: Dict[str, int] = _as_shape(shape)
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.size: int = math.prod(self.shape.values())
        self.device: torch.device = torch.device(device)
        self.local_slots: Tuple[int, ...] = tuple(int(s) for s in local_slots)
        # Collectives run so far, by kind.
        self.counts: Dict[str, int] = {"psum": 0, "all_gather": 0}

    def __repr__(self) -> str:
        return (f"{type(self).__name__}({self.shape}, device="
                f"{str(self.device)!r}, local_slots={self.local_slots})")

    # -- layout ------------------------------------------------------------
    @property
    def n_local(self) -> int:
        return len(self.local_slots)

    def axes(self, axes: Axes = None) -> Tuple[str, ...]:
        """``axes`` as a tuple of this mesh's axis names (``None``: all)."""
        if axes is None:
            return self.axis_names
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(axes)
        for ax in axes:
            if ax not in self.shape:
                raise ValueError(
                    f"unknown mesh axis {ax!r}; the mesh has "
                    f"{self.axis_names}")
        if len(set(axes)) != len(axes):
            raise ValueError(f"mesh axes {axes} repeat an axis")
        return axes

    def axis_size(self, axes: Axes = None) -> int:
        """Product of the sizes of ``axes`` (the reference's
        ``compat.axis_size`` over several axes)."""
        return math.prod(self.shape[ax] for ax in self.axes(axes))

    def coords(self, slot: int) -> Dict[str, int]:
        """The per-axis coordinates of a flat slot index."""
        out = {}
        for ax in reversed(self.axis_names):
            out[ax] = slot % self.shape[ax]
            slot //= self.shape[ax]
        return out

    def flat_index(self, slot: int, axes: Axes = None) -> int:
        """Row-major flat index of ``slot`` over ``axes`` (in their order)."""
        c = self.coords(slot)
        idx = 0
        for ax in self.axes(axes):
            idx = idx * self.shape[ax] + c[ax]
        return idx

    def axis_index(self, axes: Axes = None) -> torch.Tensor:
        """(n_local,) int64 flat indices of the local slots over ``axes``."""
        return torch.tensor([self.flat_index(s, axes) for s in
                             self.local_slots], dtype=torch.int64,
                            device=self.device)

    def _split(self, axes: Axes, over: Axes):
        axes, over = self.axes(axes), self.axes(over)
        if not set(axes) <= set(over):
            raise ValueError(
                f"collective over {axes}: the tensor varies only over "
                f"{over} (it is already the same along the others)")
        rest = tuple(ax for ax in self.axis_names
                     if ax in over and ax not in axes)
        return axes, tuple(ax for ax in self.axis_names if ax in over), rest

    def block_mesh(self, axes: Axes = None) -> "BlockMesh":
        """The mesh of a solve whose column blocks split over ``axes`` only
        (a non-empty subset of the axes, in mesh order): one slot a block,
        the block index the flat index over ``axes`` (the reference's
        ``distributed._flat_index``).  The slots along the other axes hold
        the same block, so a solve runs once a block: on a local mesh over
        the D-stack of distinct blocks, on a rank over its own block within
        the sub-group of the block axes.  Its collectives are tallied in
        this mesh's ``counts``; the whole mesh is its own block mesh."""
        axes = self.axes(axes)
        if not axes:
            raise ValueError("block_axes must name at least one mesh axis")
        if axes != tuple(ax for ax in self.axis_names if ax in axes):
            raise ValueError(
                f"block_axes={axes} must name mesh axes in the mesh's order "
                f"{self.axis_names}")
        if axes == self.axis_names:
            return self
        return self._block_view(axes)

    def _block_view(self, axes: Tuple[str, ...]) -> "BlockMesh":
        raise NotImplementedError

    # -- collectives (backends) -------------------------------------------
    def psum(self, x: torch.Tensor, axes: Axes = None, *,
             over: Axes = None) -> torch.Tensor:
        raise NotImplementedError

    def all_gather(self, x: torch.Tensor, axes: Axes = None, *,
                   over: Axes = None) -> torch.Tensor:
        raise NotImplementedError

    def _tally(self, kind: str) -> None:
        self.counts[kind] += 1


class LocalMesh(BlockMesh):
    """Every slot in this process, as a leading batch axis on ``device``
    (``None``: the GPU): one card stands for D devices."""

    def __init__(self, shape: Shape, device=None):
        super().__init__(shape, resolve_device(device), range(
            math.prod(_as_shape(shape).values())))

    def _block_view(self, axes):
        # One stack of the distinct blocks: a replicated block is computed
        # once, not once a replica.
        view = LocalMesh({ax: self.shape[ax] for ax in axes}, self.device)
        view.counts = self.counts
        return view

    def _grid(self, x: torch.Tensor, over: Tuple[str, ...]) -> torch.Tensor:
        lead = math.prod(self.shape[ax] for ax in over)
        if x.shape[0] != lead:
            raise ValueError(
                f"a tensor varying over {over} has a leading dimension of "
                f"{lead} on this local mesh; got shape {tuple(x.shape)}")
        return x.reshape(tuple(self.shape[ax] for ax in over)
                         + tuple(x.shape[1:]))

    def _moved(self, x, axes, over, rest):
        """(G, D_axes, ...): ``rest`` first, then ``axes`` in their order."""
        g = self._grid(x, over)
        perm = ([over.index(ax) for ax in rest]
                + [over.index(ax) for ax in axes]
                + list(range(len(over), g.dim())))
        g = g.permute(perm)
        n_rest = math.prod(self.shape[ax] for ax in rest)
        return g.reshape((n_rest, self.axis_size(axes)) + tuple(x.shape[1:]))

    def psum(self, x, axes=None, *, over=None):
        axes, over, rest = self._split(axes, over)
        self._tally("psum")
        y = self._moved(x, axes, over, rest)
        # Slot by slot in ascending order: the same bits on every call, and
        # the same as a loop that adds block after block.
        acc = y[:, 0].clone()
        for i in range(1, y.shape[1]):
            acc += y[:, i]
        return acc

    def all_gather(self, x, axes=None, *, over=None):
        axes, over, rest = self._split(axes, over)
        self._tally("all_gather")
        return self._moved(x, axes, over, rest)


def make_subgroups(shape: Shape, global_ranks: Sequence[int]):
    """The sub-groups of a process-group mesh of ``shape`` over
    ``global_ranks`` (slot s on rank ``global_ranks[s]``): for every proper
    subset of the axes, one group a combination of the other axes'
    coordinates, holding the slots that share it.  Yields ``(axes, slots,
    group)``.  ``new_group`` is collective over the default group, so
    every process of it runs this, in this order, member or not."""
    import torch.distributed as dist

    layout = BlockMesh(shape, "cpu", ())
    names = layout.axis_names
    for n in range(1, len(names)):
        for sub in itertools.combinations(names, n):
            other = [ax for ax in names if ax not in sub]
            buckets: Dict[Tuple[int, ...], list] = {}
            for slot in range(layout.size):
                c = layout.coords(slot)
                buckets.setdefault(tuple(c[ax] for ax in other),
                                   []).append(slot)
            for key in sorted(buckets):
                slots = buckets[key]
                yield sub, slots, dist.new_group(
                    [global_ranks[s] for s in slots])


class ProcessGroupMesh(BlockMesh):
    """One slot a rank of an initialized ``torch.distributed`` group (the
    slot is the rank within ``group``).  ``psum`` is ``all_reduce(SUM)``
    and ``all_gather`` is ``all_gather_into_tensor`` on NCCL, ``all_gather``
    on gloo, within the ranks of the collective's axes (sub-groups made
    once, here, for every proper subset of the axes: ``new_group`` must be
    called by every rank in the same order).

    Transport: NCCL moves device tensors directly; gloo takes CUDA tensors
    for these two collectives and stages them through host memory itself
    (``all_reduce`` and ``all_gather`` of CUDA tensors over gloo, checked
    on an H100 by ``chip_smoke.py``, phase ``distributed``)."""

    def __init__(self, shape: Shape, group=None, device=None):
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "ProcessGroupMesh needs an initialized torch.distributed "
                "process group (init_process_group first)")
        self._dist = dist
        self.group = group if group is not None else dist.group.WORLD
        world = dist.get_world_size(self.group)
        rank = dist.get_rank(self.group)
        shape = _as_shape(shape)
        if math.prod(shape.values()) != world:
            raise ValueError(
                f"mesh shape {shape} has {math.prod(shape.values())} slots "
                f"but the process group has {world} ranks (one slot a rank)")
        super().__init__(shape, resolve_device(device), (rank,))
        self.backend = dist.get_backend(self.group)
        global_ranks = [dist.get_global_rank(self.group, r)
                        if self.group is not dist.group.WORLD else r
                        for r in range(world)]
        self._groups: Dict[Tuple[str, ...], object] = {
            self.axis_names: self.group}
        for sub, slots, g in make_subgroups(self.shape, global_ranks):
            if rank in slots:
                self._groups[sub] = g

    def _block_view(self, axes):
        view = object.__new__(ProcessGroupMesh)
        BlockMesh.__init__(view, {ax: self.shape[ax] for ax in axes},
                           self.device, (self.flat_index(self.rank, axes),))
        view.counts = self.counts
        view._dist, view.backend = self._dist, self.backend
        # The members of a sub-group of this mesh share their coordinates
        # on the axes outside it, the non-block axes among them.
        view._groups = {sub: g for sub, g in self._groups.items()
                        if set(sub) <= set(axes)}
        view.group = view._groups[axes]
        return view

    @property
    def rank(self) -> int:
        return self.local_slots[0]

    def _group(self, axes: Tuple[str, ...]):
        return self._groups[tuple(ax for ax in self.axis_names
                                  if ax in axes)]

    def psum(self, x, axes=None, *, over=None):
        axes, over, rest = self._split(axes, over)
        self._tally("psum")
        if x.shape[0] != 1:
            raise ValueError(
                f"a rank holds one slot: leading dimension 1, got "
                f"{tuple(x.shape)}")
        y = x.clone()
        self._dist.all_reduce(y, group=self._group(axes))
        return y

    def all_gather(self, x, axes=None, *, over=None):
        axes, over, rest = self._split(axes, over)
        self._tally("all_gather")
        if x.shape[0] != 1:
            raise ValueError(
                f"a rank holds one slot: leading dimension 1, got "
                f"{tuple(x.shape)}")
        group = self._group(axes)
        n = self.axis_size(axes)
        src = x[0].contiguous()
        if self.backend == "nccl":
            out = torch.empty((n,) + tuple(src.shape), dtype=src.dtype,
                              device=src.device)
            self._dist.all_gather_into_tensor(out, src, group=group)
        else:
            parts = [torch.empty_like(src) for _ in range(n)]
            self._dist.all_gather(parts, src, group=group)
            out = torch.stack(parts)
        # Group ranks ascend with the global slot, which ascends with the
        # flat index over ``axes`` when they are named in mesh order; put
        # each part at its flat index whatever order ``axes`` came in.
        members = [s for s in range(self.size)
                   if all(self.coords(s)[ax] == self.coords(self.rank)[ax]
                          for ax in self.axis_names if ax not in axes)]
        order = [self.flat_index(s, axes) for s in members]
        if order != sorted(order):
            out = out[torch.tensor(sorted(range(n), key=order.__getitem__),
                                   device=out.device)]
        return out[None]
