"""Small sizes of the benchmark's cells for the CPU: the same code paths,
at shapes a test run holds in seconds.

Each configuration brings its CPU size as ``cpu_sizes/<config>.json``:
the keys of ``configs/<config>.json`` that a CPU run overrides.  A
configuration without one is refused, never run at its full size."""
from __future__ import annotations

import copy
import json
import pathlib
import time

import torch

from perfbench import spec

SEED = 2 ** 31 + 12345


def cpu_size_file(config: str, root: pathlib.Path = spec.ROOT
                  ) -> pathlib.Path:
    return root / "perfbench" / "tests" / "cpu_sizes" / f"{config}.json"


def cpu_size(config: str, root: pathlib.Path = spec.ROOT) -> dict:
    """The overrides that cut configuration ``config`` to the CPU's size."""
    path = cpu_size_file(config, root)
    if not path.is_file():
        raise FileNotFoundError(
            f"configuration {config!r} has no CPU size: add {path} with the "
            f"keys of its configs/ file that a CPU run overrides")
    return json.loads(path.read_text())


def tiny(name: str, root: pathlib.Path = spec.ROOT) -> dict:
    """The cell ``name`` of BENCHMARK.json cut to the CPU's size."""
    cell = copy.deepcopy(spec.cell(name, root=root))
    cell["config"].update(cpu_size(cell["entry"]["config"], root))
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
