"""Ranky-GaLore gradient compression (PyTorch/CUDA port): train the same
model with AdamW and with SVD-projected low-rank moments, compare loss and
optimizer memory.

    PYTHONPATH=src python examples/gradient_compression_torch.py [--steps 120]
        [--device cpu]

The model is phi4-mini's smoke family at d_model 256, 4 layers, vocab
8,192; GaLore at rank 16 refreshes its bases every 20 steps (an eigh of
each eligible gradient's m-side gram: 8,192 x 8,192 for the embedding).
Attention goes through the ``flash_attention`` kernel on the GPU.  Runs on
the GPU unless ``--device`` says otherwise; the last line is ``summary
{...}`` with the kernel launches and each run's first and last logged
losses and optimizer bytes.
"""
import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.compression import galore
from repro_torch.configs.base import get_smoke_config
from repro_torch.data import tokens as data_mod
from repro_torch.kernels import launch_counts
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim import tree
from repro_torch.train.step import TrainConfig, init_train_state, \
    make_train_step


def main(steps: int = 120, device=None, vocab: int = 8192,
         seq: int = 256) -> dict:
    device = resolve_device(device)
    cfg = dataclasses.replace(
        get_smoke_config("phi4-mini-3.8b"),
        num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=1024, vocab_size=vocab)
    dcfg = data_mod.DataConfig(cfg.vocab_size, seq, 8, alphabet=32)

    results = {}
    for name, tcfg in {
        "adamw": TrainConfig(remat="none", adamw=AdamWConfig(lr=1e-3),
                             warmup_steps=10, total_steps=steps),
        "ranky-galore(r=16)": TrainConfig(
            optimizer="galore", remat="none", adamw=AdamWConfig(lr=1e-3),
            galore=galore.GaloreConfig(rank=16, update_every=20),
            warmup_steps=10, total_steps=steps),
    }.items():
        state = init_train_state(cfg, tcfg,
                                 torch.Generator(device).manual_seed(0),
                                 device)
        if tcfg.optimizer == "galore":
            mem = galore.state_bytes(state["opt"])
        else:
            mem = sum(x.numel() * x.element_size()
                      for x in tree.leaves(state["opt"]))
        step = make_train_step(cfg, tcfg)
        losses, logged = [], []
        for i in range(steps):
            batch = data_mod.shard_batch(data_mod.batch_at(dcfg, i), device)
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            if i % 20 == 0 or i == steps - 1:
                logged.append(losses[-1])
                print(f"  [{name}] step {i:4d} loss={losses[-1]:.4f}",
                      flush=True)
        results[name] = dict(first_loss=logged[0], last_loss=logged[-1],
                             final_loss=float(np.mean(losses[-10:])),
                             optimizer_bytes=mem)
        del state

    print("\nsummary:")
    for name, r in results.items():
        print(f"  {name:22s} final loss={r['final_loss']:.4f} "
              f"optimizer state={r['optimizer_bytes'] / 1e6:.1f}MB")
    return {"launches": launch_counts(), "runs": results}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args()
    print("summary " + json.dumps(main(args.steps, args.device)))
