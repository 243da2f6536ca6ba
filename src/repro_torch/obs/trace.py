"""Structured span tracing with a fixed-capacity event ring buffer.

``span("ingest.window", bucket=..., batches=...)`` is a context manager
that records one complete trace event — name, start, duration, thread,
nesting depth, small key=value args, and its place in the call tree —
into a process-local ring buffer.  The buffer is bounded
(``obs.enable(ring_capacity=...)``) with a DROP-OLDEST overflow policy:
a long-lived stream keeps the most recent window of events and counts
what it shed (``dropped()``), so tracing can stay on for days without
growing.

Recording discipline:

* everything is gated on :func:`repro_torch.obs.gate.enabled` — a
  disabled span is one boolean check and a shared no-op context;
* spans never record while the current CUDA stream captures a graph
  (``torch.cuda.is_current_stream_capturing()``): a span inside a
  captured region would time the capture, not the replay;
* the start ``ts_us`` comes from the obs clock (one host timebase for
  every event, so the Perfetto timeline stays coherent);
* the DURATION comes from two CUDA events recorded on the current
  stream when CUDA is initialized: it is the device timeline between the
  span's two points, not the host's.  The events are resolved LAZILY —
  when the ring is read, summarized or exported, or when
  ``Event.query()`` says the end event has completed (checked, never
  waited for, as later spans are appended) — so a span adds no host
  sync to the code it wraps.  On the CPU the obs clock gives the
  duration at the span's exit;
* every record carries a ``span_id`` (unique in the process), its
  ``parent`` (the span open around it on its thread, None at the top of
  the thread's stack) and its ``call``: the ``span_id`` of the root of
  its tree, so that every span of one front-door call (``api.svd`` opens
  the root ``svd.call``) carries that call's id, and a reader can take a
  span's self time as its duration less its children's;
* while ``torch.profiler`` records, a span also opens a profiler range
  of its own name (``record_function``) around its body, so the span
  stands on the profiler's timeline beside the device's work, and an
  idle gap there can be put down to the innermost span open over it.
  With the profiler off that is one check; with obs off, none.

A span's body may register ``sp.then(fn)`` (``with span(...) as sp:``):
``fn(dur_us)`` runs once the duration is known (how ``serve_topk`` folds
a wave's device time into the latency histogram without waiting for the
wave).  ``fn`` runs under the ring's lock and must record no span.

Export is Chrome/Perfetto trace-event JSON (:func:`chrome_trace` /
:func:`write_chrome_trace`): load the file at https://ui.perfetto.dev
or chrome://tracing.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import threading
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.obs import clock, gate


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One recorded span (ph="X") or instant marker (ph="i")."""

    name: str
    ph: str                      # "X" complete span | "i" instant
    ts_us: float                 # start, obs-clock microseconds
    dur_us: float                # 0.0 for instants
    tid: int
    depth: int                   # span nesting depth on its thread
    args: Tuple[Tuple[str, object], ...]
    span_id: int                 # unique in the process
    parent: Optional[int]        # the enclosing span's id; None at the top
    call: int                    # the span_id of the root of its tree


class _Pending:
    """A span whose duration waits on its two CUDA events."""

    __slots__ = ("fields", "start", "end", "callbacks", "event")

    def __init__(self, fields: dict, start, end,
                 callbacks: List[Callable[[float], None]]):
        self.fields = fields
        self.start = start
        self.end = end
        self.callbacks = callbacks
        self.event: Optional[TraceEvent] = None

    def done(self) -> bool:
        return bool(self.end.query())

    def resolve(self) -> TraceEvent:
        if self.event is None:
            if not self.end.query():       # only a read ever waits
                self.end.synchronize()
            dur = float(self.start.elapsed_time(self.end)) * 1e3
            self.event = TraceEvent(dur_us=dur, **self.fields)
            self.start = self.end = None
            for fn in self.callbacks:
                fn(dur)
        return self.event


class TraceBuffer:
    """Bounded event ring: append is O(1), overflow drops the OLDEST
    event and bumps the dropped counter (tested overflow policy).  Spans
    timed by CUDA events wait in a FIFO until resolved (see the module
    docstring); a pending span that the ring drops is still resolved, so
    its callbacks run."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._pending: deque = deque()
        self._dropped = 0
        self._appended = 0
        self._lock = threading.Lock()

    def append(self, record) -> None:
        with self._lock:
            if len(self._ring) == self.capacity:
                self._dropped += 1
            self._ring.append(record)
            self._appended += 1
            if isinstance(record, _Pending):
                self._pending.append(record)
            self._settle(wait=False)

    def _settle(self, wait: bool) -> None:
        """Resolve pending spans oldest first: all of them (``wait``), or
        those whose end event has completed, up to the first that has
        not."""
        while self._pending:
            rec = self._pending[0]
            if not wait and not rec.done():
                return
            rec.resolve()
            self._pending.popleft()

    def resolve(self) -> None:
        """Resolve every pending span now (may wait for the device)."""
        with self._lock:
            self._settle(wait=True)

    def _snapshot(self) -> List[TraceEvent]:
        self._settle(wait=True)
        return [r.event if isinstance(r, _Pending) else r for r in self._ring]

    def events(self) -> List[TraceEvent]:
        """Snapshot, oldest first (append order == span-exit order), every
        duration resolved."""
        with self._lock:
            return self._snapshot()

    def appended(self) -> int:
        """Events appended since the buffer was made or cleared (dropped
        ones included): a mark for :meth:`events_since`."""
        with self._lock:
            return self._appended

    def events_since(self, mark: int) -> List[TraceEvent]:
        """The events appended after ``appended()`` returned ``mark``
        (those the ring still holds)."""
        with self._lock:
            evs = self._snapshot()
            n = self._appended - mark
        return evs[len(evs) - min(max(n, 0), len(evs)):]

    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._pending.clear()
            self._dropped = 0
            self._appended = 0


_BUFFER = TraceBuffer(gate.ring_capacity())
_TLS = threading.local()
_IDS = itertools.count(1)


def buffer() -> TraceBuffer:
    return _BUFFER


def set_capacity(capacity: int) -> None:
    """Swap in a fresh ring of the given capacity (drops history)."""
    global _BUFFER
    _BUFFER = TraceBuffer(capacity)


def events() -> List[TraceEvent]:
    return _BUFFER.events()


def resolve() -> None:
    _BUFFER.resolve()


def mark() -> int:
    return _BUFFER.appended()


def events_since(mark_: int) -> List[TraceEvent]:
    return _BUFFER.events_since(mark_)


def dropped() -> int:
    return _BUFFER.dropped()


def clear() -> None:
    _BUFFER.clear()


def _span_stack() -> list:
    """The spans open on this thread, outermost first."""
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def _place(stack: list) -> Tuple[int, Optional[int], int]:
    """(span_id, parent, call) of a record made inside the open spans
    ``stack``."""
    sid = next(_IDS)
    if not stack:
        return sid, None, sid
    top = stack[-1]
    return sid, top.span_id, top.call


def _capturing() -> bool:
    """True while the current CUDA stream captures a graph."""
    return torch.cuda.is_initialized() \
        and torch.cuda.is_current_stream_capturing()


def _recording() -> bool:
    return gate.enabled() and not _capturing()


def _norm_args(kw: Dict[str, object]) -> Tuple[Tuple[str, object], ...]:
    return tuple(sorted((k, v) for k, v in kw.items()))


def _timing_event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _profiler_range(name: str):
    """An open ``torch.profiler`` range named ``name`` while the profiler
    records; None otherwise."""
    if not torch.autograd._profiler_enabled():
        return None
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


class _Span:
    """One open span (see :func:`span`)."""

    __slots__ = ("name", "args", "callbacks", "span_id", "parent", "call",
                 "_t0", "_ev0", "_depth", "_range")

    def __init__(self, name: str, args: Dict[str, object]):
        self.name = name
        self.args = args
        self.callbacks: List[Callable[[float], None]] = []

    def then(self, fn: Callable[[float], None]) -> None:
        """Run ``fn(duration_us)`` once the span's duration is known."""
        self.callbacks.append(fn)

    def __enter__(self) -> "_Span":
        stack = _span_stack()
        self._depth = len(stack)
        self.span_id, self.parent, self.call = _place(stack)
        stack.append(self)
        self._range = _profiler_range(self.name)
        self._t0 = clock.now_us()
        self._ev0 = _timing_event() if torch.cuda.is_initialized() else None
        return self

    def __exit__(self, *exc) -> bool:
        end = _timing_event() if self._ev0 is not None else None
        host_dur = clock.now_us() - self._t0
        if self._range is not None:
            self._range.__exit__(None, None, None)
        _span_stack().pop()
        fields = dict(name=self.name, ph="X", ts_us=self._t0,
                      tid=threading.get_ident(), depth=self._depth,
                      args=_norm_args(self.args), span_id=self.span_id,
                      parent=self.parent, call=self.call)
        if end is not None:
            _BUFFER.append(_Pending(fields, self._ev0, end, self.callbacks))
        else:
            _BUFFER.append(TraceEvent(dur_us=host_dur, **fields))
            for fn in self.callbacks:
                fn(host_dur)
        return False


class _NoSpan:
    """The disabled span: enters, records and calls back nothing."""

    __slots__ = ()

    def then(self, fn) -> None:
        pass

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


def span(name: str, **args):
    """Record one complete span around the ``with`` body (see the module
    docstring).  A no-op when obs is disabled or a graph is being
    captured."""
    if not _recording():
        return _NO_SPAN
    return _Span(name, args)


def _append_inside(name: str, ph: str, ts_us: float, dur_us: float,
                   args: Dict[str, object]) -> None:
    """Append a record made now inside this thread's open spans."""
    stack = _span_stack()
    sid, parent, call = _place(stack)
    _BUFFER.append(TraceEvent(
        name=name, ph=ph, ts_us=ts_us, dur_us=dur_us,
        tid=threading.get_ident(), depth=len(stack),
        args=_norm_args(args), span_id=sid, parent=parent, call=call))


def event(name: str, **args) -> None:
    """Record one instant marker."""
    if _recording():
        _append_inside(name, "i", clock.now_us(), 0.0, args)


def add_complete(name: str, ts_us: float, dur_us: float, **args) -> None:
    """Record a span whose start/duration the caller measured itself
    (on the obs clock)."""
    if _recording():
        _append_inside(name, "X", ts_us, dur_us, args)


# ---------------------------------------------------------------------------
# Summaries + Chrome/Perfetto export
# ---------------------------------------------------------------------------

def span_summary(
    evs: Optional[Iterable[TraceEvent]] = None,
) -> Tuple[Tuple[str, int, float], ...]:
    """((name, count, total_us), ...) sorted by descending total time —
    the compact per-call digest ``Diagnostics.span_summary`` carries.
    Nested spans are listed beside their parents (a total is not a share
    of the wall time)."""
    agg: Dict[str, List[float]] = {}
    for ev in (events() if evs is None else evs):
        if ev.ph != "X":
            continue
        cell = agg.setdefault(ev.name, [0, 0.0])
        cell[0] += 1
        cell[1] += ev.dur_us
    return tuple(sorted(
        ((name, int(c), float(t)) for name, (c, t) in agg.items()),
        key=lambda row: -row[2]))


def chrome_trace(evs: Optional[Iterable[TraceEvent]] = None, *,
                 process_name: str = "ranky") -> dict:
    """The ring's contents as a Chrome trace-event JSON object
    (Perfetto/chrome://tracing both load it)."""
    out = [{
        "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
        "args": {"name": process_name},
    }]
    for ev in (events() if evs is None else evs):
        rec = {
            "name": ev.name,
            "ph": ev.ph,
            "ts": ev.ts_us,
            "pid": 1,
            "tid": ev.tid,
            "cat": ev.name.split(".", 1)[0],
            "args": dict(ev.args, depth=ev.depth, span_id=ev.span_id,
                         parent=ev.parent, call=ev.call),
        }
        if ev.ph == "X":
            rec["dur"] = ev.dur_us
        else:
            rec["s"] = "t"
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, *, process_name: str = "ranky") -> int:
    """Dump the ring to ``path`` as trace-event JSON; returns the event
    count written."""
    doc = chrome_trace(process_name=process_name)
    with open(path, "w") as f:
        json.dump(doc, f, default=str)
    return len(doc["traceEvents"]) - 1   # minus the process_name meta


def validate_chrome_trace(doc: dict) -> None:
    """Assert ``doc`` is schema-valid trace-event JSON.  Raises
    AssertionError with the offending record otherwise."""
    assert isinstance(doc, dict) and "traceEvents" in doc, \
        f"trace JSON must be an object with a traceEvents list, got " \
        f"{type(doc)}"
    evs = doc["traceEvents"]
    assert isinstance(evs, list) and evs, "traceEvents is empty"
    for rec in evs:
        for field in ("name", "ph", "pid", "tid"):
            assert field in rec, f"trace event lacks {field!r}: {rec!r}"
        if rec["ph"] == "X":
            assert "ts" in rec and "dur" in rec and rec["dur"] >= 0, \
                f"complete event needs ts + non-negative dur: {rec!r}"
        elif rec["ph"] == "i":
            assert "ts" in rec, f"instant event needs ts: {rec!r}"
