"""End-to-end example (PyTorch/CUDA port): train a ~100M-parameter LM for a
few hundred steps on synthetic data, with checkpoints and resume.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]
        [--arch ARCH] [--galore] [--device cpu]

The config is a scaled phi4-mini (d_model 512, 8 layers, vocab 32,000,
~100M parameters mostly in the embedding and the trunk).  The loss on the
synthetic Markov stream drops from ~ln(vocab) toward the stream's entropy,
visibly within a few hundred steps.  The trunk's attention layers go
through the ``flash_attention`` kernel on the GPU (its forward, with the
recompute backward) and Mamba-2 layers (``--arch mamba2-1.3b`` /
``zamba2-2.7b``) through ``ssd_scan``.  Checkpoints go to ``--ckpt-dir``
(default: a temporary directory, removed at the end).  Runs on the GPU
unless ``--device`` says otherwise; the last line is ``summary {...}``
with the kernel launches and the first and last logged losses.
"""
import argparse
import dataclasses
import json
import re
import tempfile

from repro_torch import resolve_device
from repro_torch.compression.galore import GaloreConfig
from repro_torch.configs.base import ARCH_IDS, get_smoke_config
from repro_torch.data import tokens as data_mod
from repro_torch.kernels import launch_counts
from repro_torch.models.schema import param_count_actual
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.step import TrainConfig


def lm_100m(arch: str):
    base = get_smoke_config(arch)
    return dataclasses.replace(
        base,
        name=f"{arch}-100m",
        num_layers=8,
        d_model=512,
        num_heads=8 if base.num_heads else 0,
        num_kv_heads=4 if base.num_kv_heads else 0,
        head_dim=64,
        d_ff=2048 if base.d_ff else 0,
        vocab_size=32_000,
        num_experts=base.num_experts and 8,
        experts_per_token=base.experts_per_token and 2,
    )


def main(arch: str = "phi4-mini-3.8b", steps: int = 300, seq: int = 512,
         batch: int = 8, galore: bool = False, ckpt_dir=None,
         device=None) -> dict:
    device = resolve_device(device)
    cfg = lm_100m(arch)
    tcfg = TrainConfig(
        optimizer="galore" if galore else "adamw",
        remat="none",
        adamw=AdamWConfig(lr=1e-3),
        galore=GaloreConfig(rank=32, update_every=25),
        warmup_steps=20,
        total_steps=steps,
    )
    dcfg = data_mod.DataConfig(cfg.vocab_size, seq, batch, alphabet=64,
                               noise=0.15)
    lines = []

    def log(line):
        lines.append(line)
        print(line, flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        lcfg = LoopConfig(steps=steps, ckpt_every=100,
                          ckpt_dir=ckpt_dir or tmp, log_every=10)
        state = train(cfg, tcfg, lcfg, dcfg, device=device, log=log)
    n = param_count_actual(state["params"])
    print(f"arch={cfg.name} params={n / 1e6:.1f}M")
    losses = [float(m.group(1)) for m in
              (re.search(r"loss=(\S+)", s) for s in lines) if m]
    return {"launches": launch_counts(), "params": n,
            "first_loss": losses[0], "last_loss": losses[-1]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="phi4-mini-3.8b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--galore", action="store_true",
                    help="Ranky-GaLore low-rank gradient compression")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args()
    print("summary " + json.dumps(main(args.arch, args.steps, args.seq,
                                       args.batch, args.galore,
                                       args.ckpt_dir, args.device)))
