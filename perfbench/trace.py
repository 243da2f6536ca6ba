"""What a traced run (``--trace 1``) reads: the device's activity from
``torch.profiler`` over the timed window, the program's ``obs`` spans
recorded in it, and the harness's log of the window's operations.  The
per-layer readers (``layer_metrics/``) take their numbers from a
:class:`TraceData`.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

WINDOW_LABEL = "perfbench.window"
TOP = 10


@dataclasses.dataclass
class Interval:
    name: str
    start_ns: int
    end_ns: int


@dataclasses.dataclass
class TraceData:
    """``device``: the device's operations (kernels, copies, sets) inside
    the window; ``host``: the host's operations and labels; ``spans``:
    the program's ``obs`` spans of the window (``name``, ``dur_us``,
    ``depth``, ``tid``, in the order they closed); ``ops``: the harness's
    log, one dict an operation of the cell."""

    window_ns: Tuple[int, int]
    device: List[Interval]
    host: List[Interval]
    spans: list
    ops: List[dict]
    workload: dict
    config: dict

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in merged(self.device)) * 1e-9

    def count(self, op: str) -> int:
        return sum(1 for o in self.ops if o["op"] == op)

    def kernel_seconds(self, names: Sequence[str]) -> float:
        """Device seconds of the kernels whose name holds one of
        ``names``."""
        return sum(iv.end_ns - iv.start_ns for iv in self.device
                   if any(k in iv.name for k in names)) * 1e-9

    def span_seconds(self, names: Iterable[str]) -> float:
        names = set(names)
        return sum(ev.dur_us for ev in self.spans
                   if ev.name in names) * 1e-6

    def span_count(self, name: str) -> int:
        return sum(1 for ev in self.spans if ev.name == name)


def merged(ivs: Iterable[Interval]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted((iv.start_ns, iv.end_ns) for iv in ivs):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _short(name: str) -> str:
    return name[:160]


def from_profiler(prof, spans, ops, workload, config) -> TraceData:
    """Reduce a finished ``torch.profiler.profile`` whose timed window is
    labelled ``WINDOW_LABEL`` (``record_function``)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    device, host = [], []
    window: Optional[Tuple[int, int]] = None
    labels = {e.name() for e in events
              if e.device_type() != cuda and e.is_user_annotation()}
    for e in events:
        iv = Interval(e.name(), int(e.start_ns()),
                      int(e.start_ns()) + int(e.duration_ns()))
        if e.device_type() == cuda:
            # A host label (record_function) is mirrored on the device's
            # timeline over the work it launched: not an operation.
            if not (e.is_user_annotation() or iv.name in labels):
                device.append(iv)
        else:
            host.append(iv)
            if iv.name == WINDOW_LABEL:
                window = (iv.start_ns, iv.end_ns)
    if window is None:
        raise RuntimeError(f"the profile has no {WINDOW_LABEL!r} label")
    lo, hi = window
    clipped = [Interval(iv.name, max(iv.start_ns, lo), min(iv.end_ns, hi))
               for iv in device if iv.end_ns > lo and iv.start_ns < hi]
    return TraceData(window_ns=window, device=clipped, host=host,
                     spans=list(spans), ops=list(ops), workload=workload,
                     config=config)


def device_ops(td: TraceData) -> List[List]:
    """The device operations that took most time: [[name, seconds]]."""
    acc: Dict[str, int] = {}
    for iv in td.device:
        key = _short(iv.name)
        acc[key] = acc.get(key, 0) + iv.end_ns - iv.start_ns
    top = sorted(acc.items(), key=lambda kv: -kv[1])[:TOP]
    return [[k, v * 1e-9] for k, v in top]


def idle_gaps(td: TraceData) -> List[List]:
    """The device's idle time inside the window by what the host was
    doing at the middle of each gap (the innermost host operation or
    label open then): [[name, seconds]], most first."""
    lo, hi = td.window_ns
    busy = merged(td.device)
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    host = sorted((iv for iv in td.host if iv.name != WINDOW_LABEL),
                  key=lambda iv: iv.start_ns)
    starts = [iv.start_ns for iv in host]
    acc: Dict[str, int] = {}
    open_: list = []               # (length, start, end, name), shortest first
    i = 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) // 2):
        mid = (a + b) // 2
        j = bisect.bisect_right(starts, mid)
        while i < j:
            iv = host[i]
            heapq.heappush(open_, (iv.end_ns - iv.start_ns, iv.start_ns,
                                   iv.end_ns, iv.name))
            i += 1
        # Midpoints only grow: an entry ended at one has ended at every
        # later one, so the shortest entry left once the ended ones on
        # top are gone is the innermost open operation.
        while open_ and open_[0][2] < mid:
            heapq.heappop(open_)
        name = _short(open_[0][3]) if open_ else "host (no operation)"
        acc[name] = acc.get(name, 0) + (b - a)
    top = sorted(acc.items(), key=lambda kv: -kv[1])[:TOP]
    return [[k, v * 1e-9] for k, v in top]
