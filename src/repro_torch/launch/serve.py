"""Serving launcher: batched generation requests against an architecture.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
      --smoke --device cpu --requests 4 --tokens 32

Runs on the GPU unless ``--device`` says otherwise.  The port serves the
``ssm`` (mamba2-1.3b), ``dense`` (gemma2-9b, phi3-medium-14b,
phi4-mini-3.8b, starcoder2-15b), ``vlm`` (qwen2-vl-2b, text requests: the
three M-RoPE streams equal), ``hybrid`` (zamba2-2.7b) and ``moe``
(phi3.5-moe-42b-a6.6b, qwen3-moe-235b-a22b) families.  whisper-small
(``encdec``) raises ``ValueError``: its requests carry no encoder frames,
as in the reference, whose launcher stops at the same point.
``--model-parallel`` above 1 raises ``NotImplementedError``: the LM's
model mesh, one slice for serving and training (``launch/train.py``), is
ROADMAP.md item 16.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models.schema import init_params
from repro_torch.serve.engine import ServeConfig, batch_requests, generate


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1: the LM's model mesh is not ported yet "
            "(ROADMAP.md item 16)")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)
    gen = torch.Generator(device).manual_seed(0)
    params = init_params(cfg, gen, device)
    rng = np.random.default_rng(0)
    reqs = [list(rng.integers(1, cfg.vocab_size, size=rng.integers(2, 12)))
            for _ in range(args.requests)]
    prompts, _ = batch_requests(reqs)
    scfg = ServeConfig(max_seq=prompts.shape[1] + args.tokens,
                       temperature=args.temperature)
    t0 = time.perf_counter()
    out = generate(cfg, params, torch.from_numpy(prompts).to(device), scfg,
                   args.tokens)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"{args.requests} requests x {args.tokens} tokens in {dt:.2f}s "
          f"({args.requests * args.tokens / dt:.1f} tok/s) on {device}; "
          f"tokens {tuple(out.shape)}")


if __name__ == "__main__":
    main()
