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
``--model-parallel`` sets the ``model`` axis of the mesh, planned as
``launch/train.py`` plans it (one process alone: (1, 1)), and ranks start
as there (``launch/ranks.py``: ``--coordinator host:port --num-hosts N
--host-id i``); each rank serves its rows of the requests (the batch over
``data``) through ``engine.generate`` and prints their tokens:

  for i in 0 1; do python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b \
      --model-parallel 2 --coordinator localhost:29512 --num-hosts 2 \
      --host-id $i & done
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch.ranks import (add_rank_args, model_mesh, start_ranks,
                                      stop_ranks)
from repro_torch.models.layers import ShardCtx
from repro_torch.models.schema import init_params
from repro_torch.serve.engine import ServeConfig, batch_requests, generate


def main(argv=None, log=print):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    add_rank_args(ap)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device, pool = start_ranks(args.coordinator, args.num_hosts,
                               args.host_id, args.device,
                               args.ranks_per_host)
    try:
        mesh = model_mesh(pool, args.model_parallel, log)
        if mesh is None:
            return None
        ctx = ShardCtx(mesh=mesh)
        b_ax = ctx.axes("batch")
        if args.requests % ctx.size(b_ax):
            raise ValueError(f"--requests {args.requests} does not divide "
                             f"over the mesh's {ctx.size(b_ax)} data "
                             f"shards")
        gen = torch.Generator(device).manual_seed(0)
        params = init_params(cfg, gen, device, ctx=ctx)
        rng = np.random.default_rng(0)
        reqs = [list(rng.integers(1, cfg.vocab_size,
                                  size=rng.integers(2, 12)))
                for _ in range(args.requests)]
        prompts, _ = batch_requests(reqs)
        n = args.requests // ctx.size(b_ax)
        mine = prompts[ctx.index(b_ax) * n:(ctx.index(b_ax) + 1) * n]
        scfg = ServeConfig(max_seq=prompts.shape[1] + args.tokens,
                           temperature=args.temperature)
        t0 = time.perf_counter()
        out = generate(cfg, params, torch.from_numpy(mine).to(device), scfg,
                       args.tokens, ctx=ctx)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        log(f"{args.requests} requests x {args.tokens} tokens in {dt:.2f}s "
            f"({args.requests * args.tokens / dt:.1f} tok/s) on {device}; "
            f"tokens {tuple(out.shape)}; mesh "
            f"{tuple(mesh.shape.values())}")
        log(f"tokens: {out.tolist()}")
        return out
    finally:
        stop_ranks(args.coordinator)


if __name__ == "__main__":
    main()
