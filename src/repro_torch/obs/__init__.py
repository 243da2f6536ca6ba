"""Runtime observability: span tracing, metrics, plan-vs-measured drift.

Off by default.  ``obs.enable()`` (or ``SolveConfig(observe=True)``)
turns on all three recorders at once; with obs disabled every
instrumentation point in the solve/stream/serve paths is one
``obs.enabled()`` boolean check — zero extra kernel launches, zero extra
host syncs, bit-identical numerics (pinned by tests/test_torch_obs.py
and, on the card, by ``chip_smoke.py``'s ``observe`` phase).  With obs
on, spans still add no host sync: their durations come from CUDA events
resolved when the trace is read (:mod:`repro_torch.obs.trace`).

Quick tour::

    from repro_torch import obs
    obs.enable()
    ... run svd_stream / serve_topk ...
    obs.write_chrome_trace("trace.json")      # open in ui.perfetto.dev
    print(obs.export_text())                  # Prometheus text format
    print(obs.drift_ratios())                 # {'R6/single': 0.97, ...}

Submodules: :mod:`repro_torch.obs.gate` (the one enabled() gate),
:mod:`repro_torch.obs.clock` (timebase + compile probe),
:mod:`repro_torch.obs.trace` (span ring buffer + Perfetto export),
:mod:`repro_torch.obs.metrics` (counter/gauge/histogram registry),
:mod:`repro_torch.obs.drift` (measured-vs-planned peak bytes).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Tuple

from repro_torch.obs import clock, drift, gate, metrics, trace
from repro_torch.obs.drift import DriftWarning, measured_peak_bytes
from repro_torch.obs.gate import enabled
from repro_torch.obs.trace import (chrome_trace, event, span, span_summary,
                                   validate_chrome_trace, write_chrome_trace)

__all__ = [
    "enable", "disable", "reset", "enabled",
    "span", "event", "span_summary",
    "chrome_trace", "write_chrome_trace", "validate_chrome_trace",
    "counter_add", "gauge_set", "histogram_observe",
    "export_text", "export_json", "registry",
    "drift_ratios", "observe_call", "record_drift",
    "DriftWarning", "measured_peak_bytes",
    "clock", "trace", "metrics", "drift", "gate",
]


def enable(*, ring_capacity: Optional[int] = None,
           drift_factor: Optional[float] = None) -> None:
    """Switch the observability layer on (process-wide, sticky)."""
    if ring_capacity is not None:
        gate._STATE["ring_capacity"] = int(ring_capacity)
        trace.set_capacity(int(ring_capacity))
    if drift_factor is not None:
        gate._STATE["drift_factor"] = float(drift_factor)
    gate._STATE["enabled"] = True
    clock.install_compile_probe()


def disable() -> None:
    """Stop recording.  Already-collected events/metrics are kept until
    :func:`reset`."""
    gate._STATE["enabled"] = False


def reset() -> None:
    """Drop all recorded events, metrics and drift state (enabled flag
    and thresholds are untouched)."""
    trace.clear()
    metrics.registry().reset()
    drift.monitor().reset()


# ---------------------------------------------------------------------------
# Gated instrument wrappers — THE hot-path API.  Each is one enabled()
# check when obs is off; call sites never touch the registry directly.
# ---------------------------------------------------------------------------

def counter_add(name: str, value: float = 1.0,
                labels: Optional[Dict[str, str]] = None) -> None:
    if gate.enabled():
        metrics.registry().counter_add(name, value, labels)


def gauge_set(name: str, value: float,
              labels: Optional[Dict[str, str]] = None) -> None:
    if gate.enabled():
        metrics.registry().gauge_set(name, value, labels)


def histogram_observe(name: str, value: float,
                      labels: Optional[Dict[str, str]] = None) -> None:
    if gate.enabled():
        metrics.registry().histogram_observe(name, value, labels)


def observe_call(rule: str, call: Callable[[], Any], estimated: int, *,
                 device, component: str = "temp", label: str = "",
                 shape_key: Tuple = (),
                 resident: Iterable = ()) -> Any:
    """``call()``, its first run per shape measured against the plan's
    ``estimated`` bytes when obs is on (:meth:`DriftMonitor.observe_call`:
    the port measures the real call's peak on the card, where the
    reference prices a compiled twin without running it).  Off, it is
    ``call()`` after one boolean check."""
    if not gate.enabled():
        return call()
    return drift.monitor().observe_call(
        rule, call, estimated, device=device, component=component,
        label=label, shape_key=shape_key, resident=resident)


def record_drift(rule: str, measured: int, estimated: int, *,
                 label: str = "") -> Optional[float]:
    if not gate.enabled():
        return None
    return drift.monitor().record(rule, measured, estimated, label=label)


# -- reads (ungated: reading recorded state is always allowed) --------------

def registry() -> metrics.MetricsRegistry:
    return metrics.registry()


def export_text() -> str:
    return metrics.registry().export_text()


def export_json() -> dict:
    return metrics.registry().export_json()


def drift_ratios() -> Dict[str, float]:
    return drift.monitor().ratios()
