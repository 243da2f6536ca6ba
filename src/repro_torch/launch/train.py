"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \
      --smoke --steps 100 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b

Runs on the GPU unless ``--device`` says otherwise; one process, one
device.  ``--model-parallel`` above 1 and the multi-host arguments
(``--coordinator``) raise ``NotImplementedError``: the LM's model mesh is
ROADMAP.md item 16.
"""
from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data import tokens as data_mod
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
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    if args.model_parallel > 1 or args.coordinator or args.num_hosts > 1:
        raise NotImplementedError(
            "--model-parallel > 1 and multi-host training: the LM's model "
            "mesh is not ported yet (ROADMAP.md item 16)")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(
        optimizer=args.optimizer, remat=args.remat,
        microbatches=args.microbatches,
        adamw=AdamWConfig(lr=args.lr),
        warmup_steps=max(10, args.steps // 20), total_steps=args.steps)
    dcfg = data_mod.DataConfig(cfg.vocab_size, args.seq, args.global_batch)
    lcfg = LoopConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir)
    return train(cfg, tcfg, lcfg, dcfg, device=resolve_device(args.device),
                 log=log)


if __name__ == "__main__":
    main()
