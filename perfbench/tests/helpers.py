"""Small sizes of the benchmark's cells for the CPU: the same code paths,
at shapes a test run holds in seconds."""
from __future__ import annotations

import copy
import time

import torch

from perfbench import spec

TINY_CONFIG = {
    "sparse-2048x1m": dict(rows=64, cols=4096, density=0.02),
}
SEED = 2 ** 31 + 12345


def tiny(name: str, **root) -> dict:
    """The cell ``name`` of BENCHMARK.json cut to the CPU's size."""
    cell = copy.deepcopy(spec.cell(name, **root))
    cell["config"].update(TINY_CONFIG.get(cell["entry"]["config"], {}))
    return cell


def run_tiny(name: str, *, seconds: float = 0.3, trace: bool = False,
             seed: int = SEED, cell=None) -> dict:
    """One run of the cell's harness on the CPU, past the look for a
    card: set-up, window, check, the result's line."""
    from perfbench import run as run_mod

    cell = tiny(name) if cell is None else cell
    return run_mod.run_cell(cell, seed=seed, seconds=seconds, trace=trace,
                            device=torch.device("cpu"),
                            t_start=time.perf_counter())
