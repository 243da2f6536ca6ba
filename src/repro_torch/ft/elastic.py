"""Elastic scaling: rebuild the block mesh after a device loss (or growth)
and restore streaming state onto it.

Recovery contract (synchronous SPMD, checkpoint-based):

  1. Failure detected (a fault surfaced as an exception in the ingest
     loop, or a straggler eviction).
  2. Survivors agree on the new slot set: ``plan_mesh`` picks the largest
     (data x model) grid that fits the survivors, preserving the model
     axis if possible; ``plan_stream_mesh`` the 1-D ``STREAM_AXIS`` grid
     of the streaming engines.  ``build_mesh`` makes the survivors'
     :class:`~repro_torch.core.collectives.BlockMesh`.
  3. The survivors restore the latest checkpoint placed for the NEW mesh
     (``checkpoint/ckpt.py`` saves gathered, so restore is
     mesh-agnostic).
  4. The stream rewinds to the checkpoint's batch (the seed chain keys on
     ``batches_seen``, so no replay buffer is needed).

The mesh math is device-count-agnostic and unit-tested on the CPU.

**What the port cannot do.**  torch cannot shrink a live communicator in
place: after a real process death, NCCL and gloo leave the group's
collectives hanging or raising, and the survivors must re-initialize the
process group among themselves (a restart with a new world size and
rendezvous), then restore.  This module handles *simulated* losses, which
leave every process alive: on a :class:`LocalMesh` the survivors' mesh is
a smaller local mesh on the same card, and on a
:class:`ProcessGroupMesh` it is a new sub-group of the surviving ranks
(``torch.distributed.new_group``, which every rank of the default group
calls).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import collectives
from repro_torch.stream import state as stream_state
from repro_torch.stream.state import STREAM_AXIS

# Canonical elastic mesh axes (the reference's names).
POD_AXIS = "pod"
DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    dropped_devices: int

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def plan_mesh(num_devices: int, *, model_parallel: int = 16,
              multi_pod_threshold: int = 512) -> ElasticPlan:
    """Largest usable (pod, data, model) grid <= num_devices.

    Keeps the model axis fixed (activation/weight layouts depend on it)
    and shrinks data parallelism; drops remainder devices.  Falls back to
    smaller TP only when fewer than ``model_parallel`` devices survive.
    """
    mp = min(model_parallel, num_devices)
    while num_devices % mp and mp > 1:
        mp -= 1
    dp = num_devices // mp
    used = dp * mp
    if used >= multi_pod_threshold and dp % 2 == 0:
        return ElasticPlan((2, dp // 2, mp),
                           (POD_AXIS, DATA_AXIS, MODEL_AXIS),
                           num_devices - used)
    return ElasticPlan((dp, mp), (DATA_AXIS, MODEL_AXIS),
                       num_devices - used)


def plan_stream_mesh(num_devices: int, num_blocks: int) -> ElasticPlan:
    """The stream-shaped sibling of :func:`plan_mesh`: a 1-D
    ``(num_blocks,)`` grid over the streaming engines' single
    ``STREAM_AXIS``: one column block per device, no model axis.

    When fewer than ``num_blocks`` devices survive there is no layout
    with one block per device, so the plan degrades honestly to a
    single-host ``(1,)`` grid (planner rule R8 prices what that costs;
    ``ft.supervise.StreamSupervisor`` records why).  ``dropped_devices``
    counts the healthy survivors the grid leaves idle.
    """
    if num_devices < 1:
        raise ValueError(
            f"plan_stream_mesh needs >= 1 surviving device, got "
            f"{num_devices}")
    if num_blocks < 1:
        raise ValueError(
            f"plan_stream_mesh needs num_blocks >= 1, got {num_blocks}")
    if num_devices >= num_blocks and num_blocks > 1:
        return ElasticPlan((num_blocks,), (STREAM_AXIS,),
                           num_devices - num_blocks)
    return ElasticPlan((1,), (STREAM_AXIS,), num_devices - 1)


def active_pool() -> collectives.BlockMesh:
    """The stream pool as a BlockMesh: the one set with
    ``stream.state.set_stream_devices``, else the ranks of the process
    group, else one slot a visible GPU (one slot on the CPU without one)."""
    if stream_state._STREAM_POOL is not None:
        return stream_state._STREAM_POOL
    slots = stream_state.stream_devices()
    if stream_state._process_group():
        return collectives.ProcessGroupMesh(
            {STREAM_AXIS: len(slots)}, device=stream_state._rank_device())
    return collectives.LocalMesh({STREAM_AXIS: len(slots)}, slots[0].device)


def build_mesh(plan: ElasticPlan, devices: Optional[
        collectives.BlockMesh] = None, *,
        slots: Optional[Sequence[int]] = None
        ) -> Optional[collectives.BlockMesh]:
    """The survivors' mesh of ``plan``, from the pool ``devices`` (a
    BlockMesh; default :func:`active_pool`) and its surviving slot indices
    ``slots`` (default: every slot), the first ``plan.num_devices`` of
    them taken.

    * A :class:`LocalMesh` pool gives a LocalMesh of ``plan.shape`` on the
      same device (one card stands for the survivors).
    * A :class:`ProcessGroupMesh` pool gives a ProcessGroupMesh over a
      ``new_group`` of the surviving ranks (slots in ascending rank order).
      Every rank of the default group must call this, in the same order;
      a rank outside the plan gets ``None``: it holds no slot.
    """
    pool = devices if devices is not None else active_pool()
    slots = list(range(pool.size)) if slots is None else list(slots)
    if len(slots) < plan.num_devices:
        raise ValueError(
            f"plan needs {plan.num_devices} devices, got {len(slots)} "
            f"— re-plan with plan_mesh(len(survivors))")
    slots = slots[:plan.num_devices]
    shape = dict(zip(plan.axis_names, plan.shape))
    if isinstance(pool, collectives.LocalMesh):
        return collectives.LocalMesh(shape, pool.device)
    dist = torch.distributed
    ranks = sorted(s if pool.group is dist.group.WORLD
                   else dist.get_global_rank(pool.group, s) for s in slots)
    group = dist.new_group(ranks)
    if pool.rank in slots:
        return collectives.ProcessGroupMesh(shape, group=group,
                                            device=pool.device)
    for _ in collectives.make_subgroups(shape, ranks):
        pass                    # new_group is collective: take part in each
    return None


def recover(checkpointer, cfg=None, tcfg=None, survivors: Sequence = (), *,
            shardings_fn=None, model_parallel: int = 16):
    """Full recovery path: survivors -> new mesh -> restored state.
    Returns ``(mesh, ctx, state, meta)``.

    ``survivors`` is the BlockMesh of the surviving slots (every slot of it
    survives); ``ctx`` is ``ShardCtx(mesh)``, the LM's context on the new
    mesh (so a ``LocalMesh`` of survivors must plan to one slot: the LM
    runs one slot a process).  ``shardings_fn(ctx) -> shardings`` builds
    the restore placement for the new mesh (``Checkpointer.restore(
    shardings=)``: a BlockMesh, or dicts of them keyed like the tree) and
    the module never touches the train stack (the tests run without it).
    When omitted, the train path: ``train.step.state_shardings(cfg, tcfg,
    ctx)``, imported here, and the state restored as each rank's blocks of
    it (``restore(shardings=, ctx=)``).  Every rank of the pool calls
    this; one outside the plan gets ``mesh`` None and a full state.
    """
    from repro_torch.models.layers import ShardCtx

    if not isinstance(survivors, collectives.BlockMesh):
        if not survivors:
            raise ValueError("recover needs a non-empty survivor list")
        raise TypeError(
            f"recover takes the survivors as a BlockMesh (LocalMesh / "
            f"ProcessGroupMesh); got {type(survivors)}")
    plan = plan_mesh(survivors.size, model_parallel=model_parallel)
    mesh = build_mesh(plan, survivors)
    ctx = ShardCtx(mesh=mesh)
    device = survivors.device if mesh is None else mesh.device
    if shardings_fn is not None:
        state, meta = checkpointer.restore(device=device,
                                           shardings=shardings_fn(ctx))
        return mesh, ctx, state, meta
    from repro_torch.train.step import state_shardings

    state, meta = checkpointer.restore(
        device=device, shardings=state_shardings(cfg, tcfg, ctx), ctx=ctx)
    return mesh, ctx, state, meta
