"""Deterministic fault injection for the streaming engines.

Chaos tests and the chaos scenarios (``scripts/chaos_run_torch.py``) need
to script device failures, stragglers, and dropped collectives on demand:
no real hardware dies on demand, and a nondeterministic failure is
useless for asserting bit-identical recovery.  The seam lives in
``stream/ingest.py`` (``install_fault_seam``): the engines call it at
three eager points, ``"ingest.batch"`` / ``"ingest.window"`` at engine
entry and ``"ingest.merge"`` just before the merge/collective dispatch,
and it is inert unless a :class:`FaultInjector` is installed.

The port's seam runs on the host between launches and has no tracing to
guard against (the reference's skips itself under jit tracing).  A CUDA
graph capture of an ingest must not run with an injector installed: a
raise inside a capture leaves the capture broken, not a fault simulated.

Three fault shapes, mirroring the ways real meshes fail:

* :class:`FailDeviceAt`: device ``device`` (an index into the
  supervisor's device pool) dies when the ingest covering batch
  ``at_batch`` dispatches.  Fires ONCE: after recovery the device is
  evicted and the replayed batches must not re-kill it.
* :class:`DelayDevice`: device runs ``factor``x slow from
  ``from_batch`` (until ``until_batch``, exclusive, when given).  This
  never raises; the supervisor reads :meth:`FaultInjector.delay_factor`
  and feeds the skew into ``StragglerMonitor.observe_window``.
* :class:`DropCollective`: the merge collective covering batch
  ``at_batch`` fails transiently, once.  The supervisor retries the
  uncommitted batches (the seed chain keys on ``batches_seen``, so the
  retry is bit-identical by construction).

Batch accounting is the supervisor's: it calls
:meth:`FaultInjector.begin_batches` with the half-open batch range of
each dispatch, and faults fire when their batch falls in the current
range (window dispatches cover several batches; the kill surfaces at
the dispatch covering it, which is exactly where a real device loss
would surface).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
from typing import Optional, Sequence, Tuple

# ``repro_torch.stream`` re-exports a FUNCTION named ``ingest``; resolve
# the submodule explicitly so we get the module (and its seam installer).
stream_ingest = importlib.import_module("repro_torch.stream.ingest")


class DeviceLostError(RuntimeError):
    """A (simulated) permanent device loss: the device is gone and the
    stream must re-plan onto the survivors."""

    def __init__(self, device: int, batch: int):
        super().__init__(
            f"device {device} lost at batch {batch} (injected)")
        self.device = device
        self.batch = batch


class CollectiveDropError(RuntimeError):
    """A (simulated) transient collective failure: no device died; the
    dispatch may simply be retried."""

    def __init__(self, batch: int):
        super().__init__(
            f"collective dropped at batch {batch} (injected, transient)")
        self.batch = batch


@dataclasses.dataclass(frozen=True)
class FailDeviceAt:
    device: int          # index into the supervisor's device pool
    at_batch: int        # global batch index (state.batches_seen space)
    phase: str = "entry"  # "entry" = as the ingest starts; "merge" =
    #                       at the merge/collective dispatch


@dataclasses.dataclass(frozen=True)
class DelayDevice:
    device: int
    factor: float        # slowdown multiplier, > 1
    from_batch: int = 0
    until_batch: Optional[int] = None   # exclusive; None = forever


@dataclasses.dataclass(frozen=True)
class DropCollective:
    at_batch: int


# Seam phases that mark "an ingest is starting" vs "the merge is
# dispatching" (stream/ingest.py and stream/window.py fire these).
_ENTRY_PHASES = ("ingest.batch", "ingest.window")
_MERGE_PHASES = ("ingest.merge",)


class FaultInjector:
    """Deterministic replay of a fault script against the stream seams.

    The injector is pure bookkeeping: same faults + same batch ranges =
    same raises, every run.  ``fired`` records what actually happened
    (for assertions and the recovery-event artifact).
    """

    def __init__(self, faults: Sequence):
        self.faults: Tuple = tuple(faults)
        for f in self.faults:
            if not isinstance(f, (FailDeviceAt, DelayDevice,
                                  DropCollective)):
                raise TypeError(f"unknown fault {f!r}")
            if isinstance(f, DelayDevice) and f.factor <= 1.0:
                raise ValueError(
                    f"DelayDevice.factor must be > 1, got {f.factor}")
        for f in self.faults:
            if isinstance(f, FailDeviceAt) and f.phase not in ("entry",
                                                               "merge"):
                raise ValueError(
                    f"FailDeviceAt.phase must be 'entry' or 'merge', "
                    f"got {f.phase!r}")
        self._lo = 0          # current dispatch's batch range [lo, hi)
        self._hi = 0
        self._fired = set()   # faults that already fired (fire once)
        self.fired: list = []

    def begin_batches(self, lo: int, hi: int) -> None:
        """Declare the half-open global-batch range the next dispatch
        covers (the supervisor calls this before each chunk)."""
        self._lo, self._hi = lo, hi

    def _covers(self, batch: int) -> bool:
        return self._lo <= batch < self._hi

    def fire(self, phase: str) -> None:
        """The seam callable (installed via
        ``stream.ingest.install_fault_seam``).  Raises the scripted
        fault whose batch falls in the current dispatch range."""
        for f in self.faults:
            if f in self._fired:
                continue
            if isinstance(f, FailDeviceAt) and self._covers(f.at_batch):
                want = (_ENTRY_PHASES if f.phase == "entry"
                        else _MERGE_PHASES)
                if phase in want:
                    self._fired.add(f)
                    self.fired.append(f)
                    raise DeviceLostError(f.device, f.at_batch)
            if (isinstance(f, DropCollective) and phase in _MERGE_PHASES
                    and self._covers(f.at_batch)):
                self._fired.add(f)
                self.fired.append(f)
                raise CollectiveDropError(f.at_batch)

    def delay_factor(self, device: int, batch: int) -> float:
        """Product of the active slowdowns for ``device`` at ``batch``
        (1.0 = healthy speed).  Never raises — delays are observed, not
        fatal."""
        factor = 1.0
        for f in self.faults:
            if (isinstance(f, DelayDevice) and f.device == device
                    and f.from_batch <= batch
                    and (f.until_batch is None or batch < f.until_batch)):
                factor *= f.factor
        return factor

    @contextlib.contextmanager
    def installed(self):
        """Install :meth:`fire` on the stream seam for the duration."""
        stream_ingest.install_fault_seam(self.fire)
        try:
            yield self
        finally:
            stream_ingest.install_fault_seam(None)
