"""The obs clock and the compile-time probe.

Every host timestamp of the observability layer and of the front doors'
``Diagnostics`` routes through this module, so spans, metrics and wall
times share ONE monotonic timebase and traces stay coherent.

The compile probe splits a call's wall time into compile vs run.  The
port compiles nothing at trace time: its one compile step is the ``nvcc``
build of the CUDA kernels (``kernels/build.py``), which runs at the first
use of a kernel in a process and reports its seconds here
(:func:`record_compile`).  ``compile_seconds()`` deltas around a call
attribute that first-call build to the call that paid for it
(``Diagnostics.compile_time_s``), separately from the execution
(``run_time_s``): the counterpart of the reference's ``jax.monitoring``
compile events.
"""
from __future__ import annotations

import threading
import time

_EPOCH = time.perf_counter()


def now() -> float:
    """Monotonic seconds since the obs epoch (process start-ish)."""
    return time.perf_counter() - _EPOCH


def now_us() -> float:
    """Monotonic microseconds — the trace-event timebase."""
    return (time.perf_counter() - _EPOCH) * 1e6


def wall() -> float:
    """Wall-clock unix seconds (snapshot age / staleness only — never
    used for durations)."""
    return time.time()


# ---------------------------------------------------------------------------
# Compile-time probe (the kernels' nvcc build)
# ---------------------------------------------------------------------------

_COMPILE = {"secs": 0.0}
_LOCK = threading.Lock()


def record_compile(secs: float) -> None:
    """Add ``secs`` of compilation (called by the kernel build)."""
    with _LOCK:
        _COMPILE["secs"] += float(secs)


def install_compile_probe() -> bool:
    """Always live: the kernel build reports itself through
    :func:`record_compile`, so there is nothing to register (kept for the
    reference's interface).  Returns True."""
    return True


def compile_seconds() -> float:
    """Cumulative seconds this process spent building kernels.  Delta it
    around a call."""
    with _LOCK:
        return _COMPILE["secs"]
