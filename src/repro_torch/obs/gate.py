"""The ONE observability gate every instrumentation point goes through.

Hot-path call sites (stream/ingest.py, stream/window.py, serve/*.py,
core/*.py) guard every span, metric and drift probe with
``obs.enabled()`` — a single dict lookup — so the disabled-mode cost of
the whole subsystem is one boolean check per instrumentation point:
zero extra kernel launches, zero extra host syncs, zero ring-buffer
writes (pinned by tests/test_torch_obs.py's dispatch-count test).
``api.serve_topk`` reads ``_STATE["enabled"]`` in place (no call): its
obs-off branch is held to 1 % of the direct ranker call's p99.

This module is a dependency leaf on purpose: ``trace``/``metrics``/
``drift`` all import the gate, the package ``__init__`` re-exports it,
and nothing here imports torch or any other module of the package.
"""
from __future__ import annotations

DEFAULT_RING_CAPACITY = 65536
DEFAULT_DRIFT_FACTOR = 1.3   # the reference's memory-checker slack:
                             # past 1.3 the planner is under-pricing
                             # the path

_STATE = {
    "enabled": False,
    "ring_capacity": DEFAULT_RING_CAPACITY,
    "drift_factor": DEFAULT_DRIFT_FACTOR,
}


def enabled() -> bool:
    """True when the observability layer records anything at all."""
    return _STATE["enabled"]


def ring_capacity() -> int:
    return _STATE["ring_capacity"]


def drift_factor() -> float:
    return _STATE["drift_factor"]
