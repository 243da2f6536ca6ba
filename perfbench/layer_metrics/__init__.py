"""Readers of the per-layer metrics, one file a metric
(``<metric>.py``), each with ``read(td) -> float | None`` over a
``perfbench.trace.TraceData``.  A reader that finds nothing to read
returns None and the metric is left out of the run's line; a share of a
roofline is never given as 0 for want of a reading.  The helpers below
are what most readers are made of."""
from __future__ import annotations

from typing import Callable, Optional, Sequence

from perfbench import spec


def per_op_ms(td, spans: Sequence[str], op: str) -> Optional[float]:
    """Device milliseconds of the spans ``spans`` over the window's
    operations ``op`` (a total over a count, never a mean of means)."""
    n = td.count(op)
    if n == 0 or not any(td.span_count(s) for s in spans):
        return None
    return td.span_seconds(spans) * 1e3 / n


def roofline(td, kernel: str, op: str,
             least: Callable[[dict], float]) -> Optional[float]:
    """Percent: the least time of the window's calls of ``kernel`` (from
    its frozen counts, one call an operation ``op``) over the device time
    its kernels took."""
    names = spec.counts(kernel).KERNELS
    device = td.kernel_seconds(names)
    calls = [o for o in td.ops if o["op"] == op]
    if device <= 0.0 or not calls:
        return None
    return 100.0 * sum(least(o) for o in calls) / device


def idle_share(td) -> Optional[float]:
    """Percent of the traced window in which no operation ran on the
    device."""
    if td.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - td.busy_s / td.window_s)
