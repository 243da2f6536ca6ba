"""Time-aware freshness: timestamps -> the per-ingest ``history_decay``.

``SolveConfig.history_decay`` multiplies the retained singular values
before every merge, but a constant factor treats a batch from one
minute ago like one from last week.  The natural schedule is
exponential half-life decay over WALL time: when a batch stamped
``t_batch`` is ingested at ``now``,

    history_decay = 0.5 ** ((now - t_batch) / half_life)

so history loses half its weight every ``half_life`` seconds of real
elapsed time, independently of how many batches arrived in between
(decays compose: two gaps of dt1 and dt2 decay exactly like one gap of
dt1 + dt2).  The result always satisfies the front door's
``0 < history_decay <= 1`` contract (``SolveConfig.__post_init__``):
a non-positive gap clamps to 1.0 (never amplify history — clocks skew)
and huge gaps clamp to the smallest positive float32 instead of
underflowing to the invalid 0.0.

Pure Python, the reference's function as it is.
"""
from __future__ import annotations

import math

import numpy as np

# Floor for extreme gaps: the smallest positive NORMAL float32, so the
# scalar survives a float32 cast in the merge without flushing to zero.
_MIN_DECAY = float(np.finfo(np.float32).tiny)


def decay_from_timestamps(now: float, t_batch: float,
                          half_life: float) -> float:
    """The ``history_decay`` scalar for a batch stamped ``t_batch``
    ingested at ``now``, with history half-life ``half_life`` (same
    time unit as the stamps; all plain floats — e.g. ``time.time()``
    seconds).  Feed it straight to
    ``SolveConfig(history_decay=..., truncate_rank=k)``.
    """
    for name, val in (("now", now), ("t_batch", t_batch),
                      ("half_life", half_life)):
        if not math.isfinite(val):
            raise ValueError(
                f"decay_from_timestamps: {name}={val!r} must be finite")
    if half_life <= 0:
        raise ValueError(
            f"decay_from_timestamps: half_life={half_life} must be > 0")
    dt = now - t_batch
    if dt <= 0:
        return 1.0
    return max(0.5 ** (dt / half_life), _MIN_DECAY)
