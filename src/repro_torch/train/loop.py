"""The training loop: the train step, periodic async checkpoints, resume
from the latest one, straggler monitoring, metrics logging.

The counterpart of ``repro.train.loop``.  Step times are on the host
clock up to a synchronize (reading the step's loss waits for its work).
Over a mesh (``mesh=``, a ``BlockMesh`` of one slot a process) the state
is the rank's blocks (``train.step.state_shardings``), each step takes the
rank's rows of the batch (``data.tokens.shard_batch``), and checkpoints
are saved gathered (rank 0 writes) and restored onto the rank's blocks.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.ckpt import Checkpointer, tree_signature
from repro_torch.configs.base import ModelConfig
from repro_torch.data import tokens as data_mod
from repro_torch.ft.straggler import StragglerConfig, StragglerMonitor
from repro_torch.models.layers import ShardCtx
from repro_torch.train.step import (
    TrainConfig, checkpoint_tree, init_train_state, make_train_step,
    state_from_checkpoint, state_shardings,
)


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    resume: bool = True


def train(cfg: ModelConfig, tcfg: TrainConfig, lcfg: LoopConfig,
          data_cfg: data_mod.DataConfig, *, device=None,
          log: Callable[[str], None] = print,
          state: Optional[Dict[str, Any]] = None,
          mesh=None) -> Dict[str, Any]:
    """Run the loop on ``device`` (default: the GPU; on a mesh the mesh's
    device); returns the final state.  Without ``state``, a fresh one
    (parameters from a generator seeded 0 on the device), or the latest
    checkpoint of ``lcfg.ckpt_dir`` when ``lcfg.resume`` and one exists.
    ``mesh``: see the module docstring (every rank calls ``train``)."""
    ctx = ShardCtx(mesh=mesh)
    if device is None and mesh is not None:
        device = mesh.device
    device = resolve_device(device)
    step_fn = make_train_step(cfg, tcfg, ctx)
    st_sh = state_shardings(cfg, tcfg, ctx)
    ckpt = Checkpointer(lcfg.ckpt_dir) if lcfg.ckpt_dir else None
    start_step = 0
    if state is None:
        state = init_train_state(
            cfg, tcfg, torch.Generator(device).manual_seed(0), device,
            ctx=ctx)
        if ckpt and lcfg.resume and ckpt.latest_step() is not None:
            signature = tree_signature(checkpoint_tree(state), ctx=ctx,
                                       shardings=st_sh)
            state = None                  # free it before the restore
            saved, meta = ckpt.restore(device=device,
                                       expect_signature=signature,
                                       shardings=st_sh, ctx=ctx)
            state = state_from_checkpoint(saved)
            start_step = meta["step"]
            log(f"resumed from step {start_step}")

    monitor = StragglerMonitor(StragglerConfig(), 1)
    it = data_mod.iterate(data_cfg, start_step)
    for step in range(start_step, lcfg.steps):
        batch = data_mod.shard_batch(next(it), device, mesh)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])     # waits for the step's work
        dt = time.perf_counter() - t0
        monitor.observe({0: dt})

        if step % lcfg.log_every == 0 or step == lcfg.steps - 1:
            log(f"step {step:5d} loss={loss:.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
        if ckpt and ((step + 1) % lcfg.ckpt_every == 0
                     or step == lcfg.steps - 1):
            ckpt.save(step + 1, checkpoint_tree(state), shardings=st_sh,
                      ctx=ctx)
    if ckpt:
        ckpt.wait()
    return state
