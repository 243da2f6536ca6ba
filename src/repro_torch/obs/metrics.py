"""Process-local metrics registry: counters, gauges, histograms.

The reference's ``repro.obs.metrics``, unchanged but for this docstring
(it imports only the standard library; the port keeps its own copy).
Everything is host-side Python — an instrument update is a dict/deque
write under one lock, never a device op or a host sync.  All updates go
through the ``obs.enabled()``-gated wrappers in ``repro_torch.obs``
(``counter_add`` etc.), so the disabled-mode cost is one boolean check.

Metric families the wiring populates (the README "Observability"
section is the user-facing catalog):

========================  =========  =================================
``ingest_rows_total``      counter    rows absorbed by ingest/windows
``ingest_batches_total``   counter    delta batches merged
``window_dispatch_total``  counter    ingest_window calls
``window_compile_total``   counter    window calls of a new step shape
``jit_cache_size``         gauge      stream.window.trace_count()
``snapshot_version``       gauge      last published snapshot version
``snapshot_age_seconds``   gauge      staleness of the front buffer
``serve_requests_total``   counter    serve_topk waves answered
``serve_latency_us``       histogram  per-wave latency reservoir
``drift_ratio{rule=...}``  gauge      measured/estimated peak bytes
========================  =========  =================================

Exporters: :meth:`MetricsRegistry.export_text` (Prometheus exposition
format; histograms rendered as summaries with quantile labels) and
:meth:`export_json`.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

DEFAULT_RESERVOIR = 4096
_QUANTILES = (0.5, 0.9, 0.99)


def _fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


def _key(name: str, labels: Optional[Dict[str, str]]) -> Tuple:
    lab = tuple(sorted((labels or {}).items()))
    return (name, lab)


class Histogram:
    """Sliding-window reservoir: keeps the last ``capacity`` samples and
    reports exact quantiles over that window (a serving p99 should track
    *recent* traffic, not the whole process lifetime)."""

    def __init__(self, capacity: int = DEFAULT_RESERVOIR):
        self._samples: deque = deque(maxlen=capacity)
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        self._samples.append(float(value))
        self.count += 1
        self.sum += float(value)

    def quantile(self, q: float) -> float:
        if not self._samples:
            return 0.0
        data = sorted(self._samples)
        idx = min(len(data) - 1, max(0, int(round(q * (len(data) - 1)))))
        return data[idx]

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "quantiles": {str(q): self.quantile(q) for q in _QUANTILES},
        }


class MetricsRegistry:
    """Threadsafe name+labels -> instrument map."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple, float] = {}
        self._gauges: Dict[Tuple, float] = {}
        self._hists: Dict[Tuple, Histogram] = {}

    # -- updates ----------------------------------------------------------
    def counter_add(self, name: str, value: float = 1.0,
                    labels: Optional[Dict[str, str]] = None) -> None:
        k = _key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + value

    def gauge_set(self, name: str, value: float,
                  labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._gauges[_key(name, labels)] = float(value)

    def histogram_observe(self, name: str, value: float,
                          labels: Optional[Dict[str, str]] = None) -> None:
        k = _key(name, labels)
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = Histogram()
            h.observe(value)

    # -- reads ------------------------------------------------------------
    def counter_value(self, name: str,
                      labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._counters.get(_key(name, labels), 0.0)

    def gauge_value(self, name: str,
                    labels: Optional[Dict[str, str]] = None
                    ) -> Optional[float]:
        with self._lock:
            return self._gauges.get(_key(name, labels))

    def histogram_quantile(self, name: str, q: float,
                           labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            h = self._hists.get(_key(name, labels))
            return h.quantile(q) if h is not None else 0.0

    def gauges_with_prefix(self, prefix: str) -> Dict[str, float]:
        """{rendered_name: value} for every gauge whose name starts with
        ``prefix`` — how drift ratios are harvested for Diagnostics."""
        with self._lock:
            return {
                name + _fmt_labels(lab): v
                for (name, lab), v in sorted(self._gauges.items())
                if name.startswith(prefix)
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    # -- exporters --------------------------------------------------------
    def export_text(self) -> str:
        """Prometheus exposition format.  Deterministic ordering (sorted
        by name then labels) so tests can golden-match it."""
        lines: List[str] = []
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            hists = sorted(self._hists.items())
        seen_type: set = set()
        for (name, lab), value in counters:
            if name not in seen_type:
                lines.append(f"# TYPE {name} counter")
                seen_type.add(name)
            lines.append(f"{name}{_fmt_labels(lab)} {_fmt_value(value)}")
        for (name, lab), value in gauges:
            if name not in seen_type:
                lines.append(f"# TYPE {name} gauge")
                seen_type.add(name)
            lines.append(f"{name}{_fmt_labels(lab)} {_fmt_value(value)}")
        for (name, lab), hist in hists:
            if name not in seen_type:
                lines.append(f"# TYPE {name} summary")
                seen_type.add(name)
            for q in _QUANTILES:
                qlab = lab + (("quantile", str(q)),)
                lines.append(
                    f"{name}{_fmt_labels(qlab)} "
                    f"{_fmt_value(hist.quantile(q))}")
            lines.append(f"{name}_sum{_fmt_labels(lab)} "
                         f"{_fmt_value(hist.sum)}")
            lines.append(f"{name}_count{_fmt_labels(lab)} {hist.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def export_json(self) -> dict:
        with self._lock:
            return {
                "counters": {
                    name + _fmt_labels(lab): v
                    for (name, lab), v in sorted(self._counters.items())
                },
                "gauges": {
                    name + _fmt_labels(lab): v
                    for (name, lab), v in sorted(self._gauges.items())
                },
                "histograms": {
                    name + _fmt_labels(lab): h.snapshot()
                    for (name, lab), h in sorted(self._hists.items())
                },
            }


def _fmt_value(v: float) -> str:
    """Integers render without a trailing .0 (golden-output stability)."""
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY
