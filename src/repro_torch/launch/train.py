"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \
      --smoke --steps 100 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b

Runs on the GPU unless ``--device`` says otherwise.  The mesh is
``ft.elastic.plan_mesh`` over the processes present, with
``--model-parallel`` ranks on the ``model`` axis, then ``build_mesh``: one
process alone plans (1, 1), as the reference does on one device.  Ranks
(``launch/ranks.py``): one process a mesh slot, started the same way on
every host with ``--coordinator host:port --num-hosts N --host-id i
[--ranks-per-host R]``; NCCL where every rank of a host has a card of its
own, gloo where ranks share one or run on the CPU:

  for i in 0 1 2 3; do python -m repro_torch.launch.train --arch zamba2-2.7b \
      --model-parallel 2 --global-batch 4 --coordinator localhost:29511 \
      --num-hosts 4 --host-id $i & done
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data import tokens as data_mod
from repro_torch.launch.ranks import (add_rank_args, model_mesh, start_ranks,
                                      stop_ranks)
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.step import TrainConfig


def main(argv=None, log=print):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", default="dots",
                    choices=["none", "dots", "full"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "galore"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    add_rank_args(ap)
    args = ap.parse_args(argv)

    device, pool = start_ranks(args.coordinator, args.num_hosts,
                               args.host_id, args.device,
                               args.ranks_per_host)
    try:
        mesh = model_mesh(pool, args.model_parallel, log)
        if mesh is None:
            return None
        cfg = (get_smoke_config(args.arch) if args.smoke
               else get_config(args.arch))
        tcfg = TrainConfig(
            optimizer=args.optimizer, remat=args.remat,
            microbatches=args.microbatches,
            adamw=AdamWConfig(lr=args.lr),
            warmup_steps=max(10, args.steps // 20), total_steps=args.steps)
        dcfg = data_mod.DataConfig(cfg.vocab_size, args.seq,
                                   args.global_batch)
        lcfg = LoopConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                          ckpt_dir=args.ckpt_dir)
        return train(cfg, tcfg, lcfg, dcfg, device=device, log=log,
                     mesh=mesh)
    finally:
        stop_ranks(args.coordinator)


if __name__ == "__main__":
    main()
