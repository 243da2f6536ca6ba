"""Synthetic deterministic LM data.

A reproducible token stream (numpy, addressed by (seed, step), so any
batch can be made on its own) with learnable structure: a noisy order-2
Markov chain over a small alphabet lifted into the vocab, so that a small
model trained for a few hundred steps shows a cleanly falling loss.  The
arrays are the reference's (``repro.data.tokens``) bit for bit.

``shard_batch`` puts a host batch on one device, or on the model mesh
this rank's rows of it (the reference's sharded loader builds global
arrays from each host's slice; here each rank holds its block).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    alphabet: int = 64      # size of the underlying Markov alphabet
    noise: float = 0.15     # fraction of uniform-random tokens


def _transition(cfg: DataConfig) -> np.ndarray:
    """Deterministic order-2 transition table a[t-2], a[t-1] -> a."""
    rng = np.random.default_rng(cfg.seed + 7)
    return rng.integers(0, cfg.alphabet,
                        (cfg.alphabet, cfg.alphabet)).astype(np.int32)


def batch_at(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """The full global batch for a given step (deterministic): int32
    ``tokens`` (B, S) and next-token ``labels``, the last one -1."""
    rng = np.random.default_rng((cfg.seed, step))
    b, s = cfg.global_batch, cfg.seq_len
    trans = _transition(cfg)
    toks = np.empty((b, s), np.int32)
    toks[:, 0] = rng.integers(0, cfg.alphabet, b)
    toks[:, 1] = rng.integers(0, cfg.alphabet, b)
    for t in range(2, s):
        toks[:, t] = trans[toks[:, t - 2], toks[:, t - 1]]
    noise = rng.random((b, s)) < cfg.noise
    toks = np.where(noise, rng.integers(0, cfg.alphabet, (b, s)), toks)
    # lift into the vocab (spread over the embedding table)
    stride = max(1, cfg.vocab_size // cfg.alphabet)
    toks = (toks * stride) % cfg.vocab_size
    labels = np.concatenate([toks[:, 1:], -np.ones((b, 1), np.int32)], axis=1)
    return {"tokens": toks, "labels": labels.astype(np.int32)}


def iterate(cfg: DataConfig, start_step: int = 0
            ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield batch_at(cfg, step)
        step += 1


def shard_batch(batch: Dict[str, np.ndarray], device, mesh=None,
                batch_axes=("pod", "data")) -> Dict[str, torch.Tensor]:
    """The host batch as tensors on ``device`` (dtypes kept).  With
    ``mesh`` (a ``BlockMesh`` of one slot in this process) each leaf's
    first dim splits over the mesh's ``batch_axes`` and this rank takes
    its rows (flat index over those axes, in their order)."""
    if mesh is not None:
        if mesh.n_local != 1:
            raise ValueError(
                f"shard_batch: {mesh!r} holds {mesh.n_local} slots in this "
                f"process; the LM runs one slot a process")
        axes = tuple(a for a in batch_axes if a in mesh.axis_names)
        n = mesh.axis_size(axes) if axes else 1
        i = mesh.flat_index(mesh.local_slots[0], axes) if axes else 0

        def rows(v):
            if v.shape[0] % n:
                raise ValueError(
                    f"shard_batch: {v.shape[0]} rows do not split over "
                    f"{axes} ({n} ranks)")
            step = v.shape[0] // n
            return v[i * step:(i + 1) * step]

        batch = {k: rows(v) for k, v in batch.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
