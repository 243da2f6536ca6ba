"""What the traffic modules share: the run's context, the window's
result, and a reservoir that samples the window's answers from the seed.

A traffic module (``traffic/<kind>.py``) has these functions:

* ``setup(ctx)`` makes the cell's data from the seed and warms up every
  shape the window uses; it returns the module's state;
* ``window(ctx, state)`` runs the timed window of ``ctx.seconds`` and
  returns a :class:`Window` (its end-to-end metrics, the operations
  attempted and failed, and the answers sampled for the check), logging
  each operation to ``ctx.ops`` for the per-layer readers;
* ``free_program(state)`` drops what only the program needs;
* ``check(ctx, state, window)`` then judges the sampled answers with the
  plain reference and returns ``{number: value}``, each held to the
  cell's limit;
* ``control(ctx, state, window)``: the same numbers of the control, the
  reference in TF32 in the program's place (``calibrate.py`` only).
"""
from __future__ import annotations

import dataclasses
import random
import sys
from typing import Any, Callable, Dict, List

import torch

from perfbench import bipartite

# Purposes of the seeded streams (``bipartite.mix`` tags).
TAG_MATRIX, TAG_DRAWS, TAG_OMEGA, TAG_SAMPLE = range(4)


@dataclasses.dataclass
class Context:
    name: str
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    config: dict
    workload: dict
    ops: List[dict] = dataclasses.field(default_factory=list)

    def generator(self, *tags: int) -> torch.Generator:
        return bipartite.generator(self.device, self.seed, *tags)

    def reservoir(self, k: int, tag: int = 0) -> "Reservoir":
        return Reservoir(k, bipartite.mix(self.seed, TAG_SAMPLE, tag))


@dataclasses.dataclass
class Window:
    attempted: int
    failed: int
    seconds: float
    metrics: Dict[str, float]
    samples: Any
    # What the run's line shows besides its metrics (counts of the
    # window's side work), for a reader of the run.
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)


class Reservoir:
    """``k`` items drawn uniformly from all offered, the draw fixed by the
    seed (Algorithm R); ``make`` is called only for an item that is
    kept."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items: List[Any] = []
        self.seen = 0

    def offer(self, make: Callable[[], Any]) -> None:
        i = self.seen
        self.seen += 1
        if i < self.k:
            self.items.append(make())
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            self.items[j] = make()


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest reading of each number over several answers."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out
