"""Serving example (PyTorch/CUDA port): batched generation with prefill +
decode.

    PYTHONPATH=src python examples/serve_lm_torch.py [--arch mamba2-1.3b] [--device cpu]

Batches uneven requests, prefills them in one pass, then decodes.  Runs
the architecture's smoke config (narrow widths, random weights from a
seeded generator).  The port serves the ``ssm`` family (mamba2-1.3b, the
default), ``dense`` (gemma2-9b, phi3-medium-14b, phi4-mini-3.8b,
starcoder2-15b), ``vlm`` (qwen2-vl-2b, text prompts: the three M-RoPE
streams equal), ``hybrid`` (zamba2-2.7b) and ``moe``
(phi3.5-moe-42b-a6.6b, qwen3-moe-235b-a22b).  whisper-small (``encdec``)
raises ``ValueError``: these text requests carry no encoder frames, and
the reference's example stops at the same point.

The whole-prompt prefill (``prefill_forward``) goes through the
model's kernels on the GPU (``ssd_scan`` for Mamba-2 layers,
``flash_attention`` for attention layers); it is checked in float32
against the engine's token-by-token prefill of the same prompts (decode
steps, no kernel), last logits and every cache entry; a moe model is
checked at a capacity factor that drops no token (E / K), since a decode
step routes B tokens and the prefill B * P.  Runs on the GPU unless
``--device`` says otherwise.
"""
import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ARCH_IDS, get_smoke_config
from repro_torch.kernels import launch_counts
from repro_torch.models import transformer
from repro_torch.models.schema import init_params
from repro_torch.serve.engine import (ServeConfig, batch_requests, generate,
                                      prefill_cache)

REQUESTS = [
    [5, 17, 256, 33],
    [101, 7],
    [42, 42, 42, 42, 42, 42],
    [9],
]
# The float32 prefill check: every logit and cache entry within this much
# of max|.| (the two paths sum in other orders; chip_smoke.py holds the
# full-width model to the same limit).
PREFILL_REL = 3e-4


def _rel(got, want) -> float:
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def main(arch: str = "mamba2-1.3b", tokens: int = 32,
         temperature: float = 0.8, device=None) -> dict:
    cfg = get_smoke_config(arch)
    device = resolve_device(device)
    params = init_params(cfg, torch.Generator(device).manual_seed(0), device)

    prompts_np, lens = batch_requests(REQUESTS)
    prompts = torch.from_numpy(prompts_np).to(device)
    print(f"arch={cfg.name}: {len(REQUESTS)} requests, "
          f"lens={lens.tolist()} -> padded batch {tuple(prompts.shape)}")

    # The kernels inside the model: the whole-prompt prefill against the
    # token-by-token one, in a float32 copy of the config (same weights).
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    if cfg.family == "moe":
        cfg32 = dataclasses.replace(
            cfg32, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    want_cache, want = prefill_cache(
        cfg32, params, prompts, ServeConfig(max_seq=prompts.shape[1]))
    batch = {"tokens": prompts}
    if cfg.use_mrope:     # text: the three position streams equal
        batch["pos"] = torch.arange(prompts.shape[1], device=device)[
            None, :, None].expand(*prompts.shape, 3)
    got, cache = transformer.prefill_forward(cfg32, params, batch)
    errs = {"logits": _rel(got, want)}
    errs.update({key: _rel(cache[key], want_cache[key])
                 for key in cache if key != "len"})
    print("prefill_forward vs token-by-token prefill (float32, of max): "
          + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()))
    assert max(errs.values()) <= PREFILL_REL, errs

    scfg = ServeConfig(max_seq=prompts.shape[1] + tokens,
                       temperature=temperature)
    t0 = time.perf_counter()
    out = generate(cfg, params, prompts, scfg, tokens)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    assert tuple(out.shape) == (len(REQUESTS), tokens)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size
    total = len(REQUESTS) * tokens
    print(f"generated {total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s)")
    for i, row in enumerate(out.cpu().tolist()):
        print(f"  req{i}: {row}")
    return {"launches": launch_counts(), "prefill_rel_err": errs}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="mamba2-1.3b")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args()
    print("summary " + json.dumps(main(args.arch, args.tokens,
                                       args.temperature, args.device)))
