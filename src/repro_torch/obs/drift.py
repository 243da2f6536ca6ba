"""Plan-vs-measured drift monitor.

The planner prices every hot path with a closed form (R5 streaming, R6
windows, R7 serving).  This module checks those forms at run time: at
each instrumented call the monitor measures the peak bytes the call
actually allocated on the card for the *exact shapes in flight*, sets
``drift_measured_bytes`` / ``drift_estimated_bytes`` / ``drift_ratio``
gauges (labelled by rule), and emits a one-shot :class:`DriftWarning`
when measured exceeds estimate by the configured factor
(``obs.enable(drift_factor=...)``, default 1.3).

Measurement is of the FIRST call per (rule, label, component, shape
key), not compile-only: the port has no compiler to ask for a buffer
plan (the reference reads XLA's ``memory_analysis()``), so the probe
measures the real call the way ``chip_smoke.py`` measures a window
against R6: ``torch.cuda.reset_peak_memory_stats()``, then
``memory_allocated()`` before and ``max_memory_allocated()`` after; the
difference is what the call allocated at its peak.  The caching
allocator keeps these counts on the host, so the probe adds no
synchronize and no kernel; later calls of a measured shape are a dict
hit.  On the CPU there is no allocator peak: the probe records nothing
and returns None, as the reference does on a backend without memory
statistics.
"""
from __future__ import annotations

import dataclasses
import threading
import warnings
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.obs import gate, metrics


class DriftWarning(UserWarning):
    """Measured peak bytes exceeded the planner estimate by more than
    the configured drift factor."""


def shape_key(*args) -> Tuple:
    """Hashable signature of the tensors in ``args``: (shape, dtype) of
    every tensor, found through tuples, lists, dicts and dataclasses
    (whose non-tensor fields, like the reference's pytree aux data, are
    left out); other top-level values by ``repr``."""
    out = []

    def rec(a, top: bool):
        if isinstance(a, torch.Tensor):
            out.append((tuple(a.shape), str(a.dtype)))
        elif isinstance(a, (tuple, list)):
            for x in a:
                rec(x, top)
        elif isinstance(a, dict):
            for k in sorted(a):
                rec(a[k], top)
        elif dataclasses.is_dataclass(a) and not isinstance(a, type):
            for f in dataclasses.fields(a):
                rec(getattr(a, f.name), False)
        elif top and a is not None:
            out.append(("scalar", repr(a)))

    for a in args:
        rec(a, True)
    return tuple(out)


def resident_bytes(tensors: Iterable[Optional[torch.Tensor]]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def measured_peak_bytes(call: Callable[[], Any], device, *,
                        resident: Iterable[Optional[torch.Tensor]] = (),
                        component: str = "temp") -> Tuple[Any, Optional[int]]:
    """``(call(), bytes)``: the peak bytes ``call`` allocated on
    ``device`` above what was allocated when it started — the reference's
    ``"temp"`` component (R5: inputs stream in, the transient working set
    is what the closed form prices) — plus, for ``"total"`` (R6 / R7),
    the bytes of the call's device-resident arguments ``resident`` (the
    state's or the snapshot's factors), as the reference's convention
    counts arguments.  ``bytes`` is None off the GPU.

    RESETS the device's peak-memory counter (process-wide): a caller that
    measures peaks itself must run with obs off around its measurement.
    cuBLAS's handle for the current stream is made first: its workspace
    (32 MiB on an H100) is allocated once, lazily, at the first product on
    a stream, persists, and belongs to no call's working set.
    """
    if component not in ("temp", "total"):
        raise ValueError(f"unknown component {component!r}")
    device = torch.device(device)
    if device.type != "cuda":
        return call(), None
    with torch.cuda.device(device):
        torch.cuda.current_blas_handle()
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    out = call()
    peak = torch.cuda.max_memory_allocated(device) - before
    if component == "total":
        peak += resident_bytes(resident)
    return out, int(peak)


class DriftMonitor:
    """Shape-memoized measured-vs-planned recorder."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cache: Dict[Tuple, Tuple[int, int, float]] = {}
        self._ratios: Dict[str, float] = {}
        self._warned: set = set()

    # -- recording --------------------------------------------------------
    def record(self, rule: str, measured: int, estimated: int, *,
               label: str = "") -> float:
        """Record one measured/estimated pair; returns the ratio.  Sets
        the three gauges and fires the one-shot warning past threshold."""
        estimated = max(int(estimated), 1)
        ratio = measured / estimated
        labels = {"rule": rule}
        if label:
            labels["site"] = label
        reg = metrics.registry()
        reg.gauge_set("drift_measured_bytes", measured, labels)
        reg.gauge_set("drift_estimated_bytes", estimated, labels)
        reg.gauge_set("drift_ratio", ratio, labels)
        rkey = f"{rule}/{label}" if label else rule
        with self._lock:
            self._ratios[rkey] = max(self._ratios.get(rkey, 0.0), ratio)
        factor = gate.drift_factor()
        if ratio > factor:
            warn_key = (rule, label)
            with self._lock:
                first = warn_key not in self._warned
                self._warned.add(warn_key)
            if first:
                warnings.warn(
                    f"[{rule}{'/' + label if label else ''}] measured peak "
                    f"{measured} B exceeds planner estimate {estimated} B "
                    f"by {ratio:.2f}x (threshold {factor:.2f}x) — the "
                    f"closed form is under-pricing this path",
                    DriftWarning, stacklevel=3)
        return ratio

    def observe_call(self, rule: str, call: Callable[[], Any],
                     estimated: int, *, device, component: str = "temp",
                     label: str = "", shape_key: Tuple = (),
                     resident: Iterable[Optional[torch.Tensor]] = ()):
        """Run ``call()`` and return its result; the first call of each
        (rule, label, component, shape_key) on the GPU is measured
        (:func:`measured_peak_bytes`) and recorded against ``estimated``.
        Not compile-only (the reference prices a compiled twin without
        running it): the port can only measure a real call, so the probe
        wraps the production call itself and runs nothing extra."""
        key = (rule, label, component, shape_key)
        with self._lock:
            hit = key in self._cache
        if hit:
            return call()
        out, measured = measured_peak_bytes(call, device, resident=resident,
                                            component=component)
        if measured is None:
            return out
        ratio = self.record(rule, measured, estimated, label=label)
        with self._lock:
            self._cache[key] = (measured, int(estimated), ratio)
        return out

    # -- reads ------------------------------------------------------------
    def ratios(self) -> Dict[str, float]:
        """{'R6' or 'R6/site': ratio} for every rule recorded so far
        (worst ratio per key) — the digest Diagnostics carries."""
        with self._lock:
            return dict(self._ratios)

    def records(self) -> list:
        """Every measured call so far: one dict per (rule, label,
        component, shape key) with its measured and estimated bytes."""
        with self._lock:
            return [dict(rule=k[0], label=k[1], component=k[2],
                         shapes=[list(x) for x in k[3]], measured=m,
                         estimated=e, ratio=r)
                    for k, (m, e, r) in self._cache.items()]

    def reset(self) -> None:
        with self._lock:
            self._cache.clear()
            self._ratios.clear()
            self._warned.clear()


_MONITOR = DriftMonitor()


def monitor() -> DriftMonitor:
    return _MONITOR
