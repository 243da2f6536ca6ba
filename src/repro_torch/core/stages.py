"""Opt-in wall times of a solve's stages, taken where the stages run.

    with stages.record() as times:
        api.svd(a, config)
    # times: {"split_and_repair": [ms], "sketch": [ms, ms, ms], ...}

The solver wraps each of its stages in :func:`stage`.  Outside
:func:`record` that costs one comparison and nothing else: no clock is read
and the device is not waited for.  Inside it, the device is synchronized
before and after every stage, so the times add up to the solve's wall time
but the solve itself runs slower than an unrecorded one (the host can no
longer run ahead of the device).  Stages do not nest; a stage that runs
several times (a sketch pass) lists each run.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, Optional

import torch

_sink: Optional[Dict[str, List[float]]] = None


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def record() -> Iterator[Dict[str, List[float]]]:
    """Collect the stage times (milliseconds, in order of first run) of
    every solve made inside the block."""
    global _sink
    if _sink is not None:
        raise RuntimeError("stages.record() does not nest")
    _sink = {}
    try:
        yield _sink
    finally:
        _sink = None


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    if _sink is None:
        yield
        return
    _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        _sink.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
