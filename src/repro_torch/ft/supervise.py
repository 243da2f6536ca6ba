"""StreamSupervisor: mid-stream recovery for the streaming engines.

The ``shard_map`` streaming backend assumes a fixed healthy mesh for the
life of a stream: one lost or slow device kills a week-long ingest.  The
supervisor turns that into a recoverable event::

    sup = StreamSupervisor(config, ckpt_dir, state=svd_init(n, config))
    state = sup.run(batches)          # survives kills / stragglers
    sup.events                        # what happened, machine-readable

It wraps ``api.svd_stream`` in commit-sized chunks
(``SolveConfig.checkpoint_every`` batches per chunk), checkpoints after
every successful chunk, and on a fault:

1. **drain**: flush the async checkpoint writer; the last committed
   batch is the resume point (``obs`` span ``recover.drain``).
2. **re-plan**: drop the dead slot from the healthy pool, pick the new
   layout with ``elastic.plan_stream_mesh`` (1-D ``STREAM_AXIS`` grid
   when enough survive, honest single-host degrade otherwise) and price
   it with planner rule R8: the recovery event carries the R8 reasons,
   so a degrade is explained, not silent (``recover.replan``).
3. **restore**: ``Checkpointer.restore(reshard=False)`` plus an explicit
   ``reshard_for_restore`` against the surviving pool
   (``stream.state.set_stream_devices`` with ``elastic.build_mesh``'s
   mesh), so the state lands sharded over the survivors or gathered on
   one of them (``recover.restore``).  The restore's device peak is held
   against R8's ``recovery_restore`` term by the obs drift probe
   (``R8``; measured on the card only).
4. **resume**: replay the uncommitted batches.  The seed chain keys on
   ``batches_seen`` (batch b always draws ``derive_seed(root, b)``), so
   the resumed stream is bit-identical to an uninterrupted run of the
   same batch sequence: the chaos tests assert bitwise equality.

Transient faults (a dropped collective) skip the restore: the in-flight
chunk's partial work is discarded and the chunk replays from the
supervisor's committed state, bounded by ``SolveConfig.max_retries``
with ``retry_backoff_s * 2**(attempt - 1)`` seconds of backoff before
retry ``attempt``.

**The commit.**  A chunk's state is copied to the host in ONE device to
host copy (u, s and v packed into one buffer) and written by the
checkpointer's background thread.  That copy is the one host sync the
supervisor adds to a chunk, and the chunk's duration is read right after
it: the straggler monitor adds no sync of its own.

**Straggler detection**: each chunk's duration, fanned by per-slot skew
factors and scaled by the worst plan-vs-measured drift ratio, feeds
``StragglerMonitor.observe_window``.  On a :class:`LocalMesh` every slot
runs on one card's clock, so the skew is synthetic: it comes from the
injector's ``delay_factor``, as it comes on the reference's forced host
devices (a multi-host deployment reads per-host spans instead).  A
flagged slot with ``backup_ingest=True`` gets **backup-shard
duplicate-ingest**: an idle healthy device outside the mesh shadows the
slow slot's shard, and the chunk completes at the backup's (median)
speed, accounted as ``straggler_backup_total`` / ``backup_saved_seconds``
(on one card the saving is accounting, not wall time: the POLICY, which
slots evict vs shadow, is what is under test).  A slot whose time stays
flagged for ``patience`` consecutive windows under ``policy="evict"`` is
evicted through the same recovery path as a kill.

**Pools.**  The pool is a local mesh: the supervisor re-meshes within one
process.  A pool of ranks (a ``ProcessGroupMesh``) is refused: a rank
dropped from the plan would have to leave the loop while the others go
on, and a real rank loss needs a restart (``ft/elastic.py``).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.core import collectives, planner
from repro_torch.core.planner import ASpec
from repro_torch.ft import elastic
from repro_torch.ft.inject import CollectiveDropError, DeviceLostError
from repro_torch.ft.straggler import StragglerConfig, StragglerMonitor
from repro_torch.obs import clock
from repro_torch.stream import state as stream_state


class NoSurvivorsError(RuntimeError):
    """Every device in the pool is dead: nothing to recover onto."""


@dataclasses.dataclass(frozen=True)
class RecoveryEvent:
    """One machine-readable recovery record (``write_events`` writes the
    list as the chaos scenarios' artifact)."""

    kind: str                 # "device_lost" | "straggler_evict" |
    #                           "collective_retry" | "collective_escalate"
    batch: int                # global batch index where the fault surfaced
    device: Optional[int]     # pool index of the lost/evicted device
    survivors: int            # healthy pool size after the event
    backend_before: str       # "shard_map" | "single"
    backend_after: str
    resumed_from_batch: int   # batches_seen at the resume point
    retries: int              # attempts consumed (transient faults)
    wall_s: float             # recovery wall time (drain..resume-ready)
    r8_peak_bytes: int        # post-shrink peak the R8 plan prices
    reasons: Tuple[str, ...]  # the R8 plan's reasons (degrade explained)

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d["reasons"] = list(self.reasons)
        return d


def host_state(state: stream_state.StreamingSVDState
               ) -> stream_state.StreamingSVDState:
    """The state gathered on the host in one device to host copy: u, s and
    v are packed into one buffer on their device, copied, and split again
    (views of the host buffer, the same bits)."""
    state = stream_state.gather_state(state)
    parts = (state.u, state.s, state.v)
    flat = torch.cat([p.reshape(-1) for p in parts]).cpu()
    out, at = [], 0
    for p in parts:
        out.append(flat[at:at + p.numel()].view(p.shape))
        at += p.numel()
    return dataclasses.replace(state, u=out[0], s=out[1], v=out[2])


class StreamSupervisor:
    """Wrap a streaming solve with fault recovery (module docstring).

    ``config`` is a streaming ``SolveConfig`` (``truncate_rank`` set;
    ``checkpoint_every`` / ``max_retries`` / ``retry_backoff_s`` are the
    recovery knobs).  ``state`` seeds the stream (``api.svd_init`` result
    or a checkpoint restore).  ``devices`` is the device pool, a
    :class:`~repro_torch.core.collectives.LocalMesh` whose slots the
    healthy list indexes (default: the active stream pool,
    ``elastic.active_pool``); ``injector`` an optional
    ``ft.inject.FaultInjector``.  The supervisor owns the stream pool
    (``stream.state.set_stream_devices``) between ``run`` calls: use it as
    a context manager (or call :meth:`close`) to reset the pool to None.
    """

    def __init__(self, config, checkpoint_dir: str, *, state,
                 devices: Optional[collectives.BlockMesh] = None,
                 straggler: Optional[StragglerConfig] = None,
                 injector=None, backup_ingest: bool = True, keep: int = 3):
        if config.truncate_rank is None:
            raise ValueError(
                "StreamSupervisor needs a streaming SolveConfig "
                "(truncate_rank=k)")
        self.config = config
        self.state = state
        self.pool = devices if devices is not None else elastic.active_pool()
        if not isinstance(self.pool, collectives.LocalMesh):
            raise NotImplementedError(
                f"StreamSupervisor re-meshes a LocalMesh pool; got "
                f"{type(self.pool).__name__} (a rank dropped from the plan "
                f"cannot leave the loop while its group goes on; a real "
                f"rank loss needs a restart with the survivors)")
        self.healthy: List[int] = list(range(self.pool.size))
        self.injector = injector
        self.backup_ingest = backup_ingest
        self.straggler_cfg = straggler or StragglerConfig()
        self.ckpt = Checkpointer(checkpoint_dir, keep=keep)
        self.events: List[RecoveryEvent] = []
        # (first batch, end batch, seconds) of every committed chunk: the
        # time the straggler monitor reads (svd_stream and the commit).
        self.chunk_seconds: List[Tuple[int, int, float]] = []
        self.backup_saved_s = 0.0
        self._base = int(state.batches_seen)
        self._state0 = stream_state.gather_state(state, self.pool.device)
        self._monitor: Optional[StragglerMonitor] = None
        self._apply_placement()

    # -- device pool / placement -----------------------------------------

    def _active_plan(self) -> elastic.ElasticPlan:
        return elastic.plan_stream_mesh(len(self.healthy),
                                        self.state.num_blocks)

    def _apply_placement(self, reset_monitor: bool = False) -> None:
        """Point the stream pool at the active slice of the healthy
        slots: exactly ``num_blocks`` slots when the 1-D mesh fits (so
        planner rule R5d picks shard_map), exactly one when degraded to
        single-host."""
        if not self.healthy:
            raise NoSurvivorsError(
                "no surviving devices in the supervisor's pool")
        active = elastic.build_mesh(self._active_plan(), self.pool,
                                    slots=self.healthy)
        stream_state.set_stream_devices(active)
        slots = active.size
        if (reset_monitor or self._monitor is None
                or self._monitor.num_hosts != slots):
            # Fresh EWMAs after ANY recovery, even at unchanged slot
            # count: slot s now maps to a different pool device, and
            # inheriting the evicted straggler's flag streak would get
            # a healthy survivor evicted on the next window.
            self._monitor = StragglerMonitor(self.straggler_cfg, slots)
        obs.gauge_set("stream_healthy_devices", float(len(self.healthy)))

    @property
    def backend(self) -> str:
        """What the active placement runs: "shard_map" when one device
        per column block is registered, else "single"."""
        return ("shard_map"
                if stream_state.stream_device_count()
                == self.state.num_blocks
                and self.state.num_blocks > 1 else "single")

    def close(self) -> None:
        """Reset the stream pool and flush the checkpointer."""
        self.ckpt.wait()
        stream_state.set_stream_devices(None)

    def __enter__(self) -> "StreamSupervisor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- obs-fed straggler observation ------------------------------------

    def _observe_window(self, dur_s: float, batch: int) -> Dict[str, list]:
        """Feed one chunk's duration + drift into the monitor and apply
        the backup-shard mitigation policy.  Returns the verdict (the
        caller handles ``evict``)."""
        slots = self._monitor.num_hosts
        factors = [
            self.injector.delay_factor(self.healthy[s], batch)
            if self.injector is not None else 1.0
            for s in range(slots)]
        ratios = obs.drift_ratios()
        drift = max((r for k, r in ratios.items()
                     if k.startswith("R5") or k.startswith("R6")),
                    default=None)
        verdict = self._monitor.observe_window(dur_s, factors, drift=drift)
        for slot in verdict["flagged"]:
            obs.counter_add("straggler_flagged_total")
            if self.backup_ingest and slot not in verdict["evict"]:
                # Backup-shard duplicate-ingest: shadow the flagged
                # slot's shard on an idle healthy device; the chunk
                # completes at healthy speed, so the straggler costs
                # duplicate work, not wall time.
                saved = dur_s * max(0.0, factors[slot] - 1.0)
                self.backup_saved_s += saved
                obs.counter_add("straggler_backup_total")
                obs.counter_add("backup_saved_seconds", saved)
        return verdict

    # -- recovery ----------------------------------------------------------

    def _recovery_plan(self, m_hint: int):
        spec = ASpec(m=max(1, m_hint), n=self.state.n,
                     nnz=max(1, m_hint) * self.state.n,
                     num_blocks=self.state.num_blocks, kind="stream")
        return planner.make_recovery_plan(spec, self.config,
                                          survivors=len(self.healthy))

    def _restore(self, step: Optional[int]):
        """The last commit (the initial state before the first) placed on
        the current pool."""
        if step is not None:
            restored, _meta = self.ckpt.restore(step,
                                                device=self.pool.device,
                                                reshard=False)
        else:
            restored = self._state0
        restored = restored.reshard_for_restore()
        if stream_state.stream_device_count() == 1:
            restored = stream_state.gather_state(restored)
        return restored

    def _recover(self, kind: str, batch: int, device: Optional[int],
                 m_hint: int, retries: int = 0) -> None:
        """The four-step recovery path (drain / re-plan / restore /
        resume-ready); appends the RecoveryEvent."""
        t0 = clock.now()
        backend_before = self.backend
        t_us = clock.now_us()
        self.ckpt.wait()                          # drain
        obs.trace.add_complete("recover.drain", t_us,
                               clock.now_us() - t_us, kind=kind)

        if device is not None and device in self.healthy:
            self.healthy.remove(device)
        if not self.healthy:
            raise NoSurvivorsError(
                f"device {device} was the last healthy device")

        t_us = clock.now_us()
        rplan = self._recovery_plan(m_hint)       # re-plan (R8)
        self._apply_placement(reset_monitor=True)
        obs.trace.add_complete(
            "recover.replan", t_us, clock.now_us() - t_us,
            survivors=len(self.healthy), backend=rplan.backend,
            r8_peak_bytes=rplan.peak_bytes)

        t_us = clock.now_us()
        step = self.ckpt.latest_step()            # restore
        restored = obs.observe_call(
            "R8", lambda: self._restore(step),
            rplan.estimates["recovery_restore"], device=self.pool.device,
            component="temp", label=rplan.backend,
            shape_key=(("survivors", len(self.healthy)), ("step", step)))
        self.state = restored
        obs.trace.add_complete(
            "recover.restore", t_us, clock.now_us() - t_us,
            resumed_from_batch=int(restored.batches_seen))

        wall = clock.now() - t0
        event = RecoveryEvent(
            kind=kind, batch=batch, device=device,
            survivors=len(self.healthy),
            backend_before=backend_before, backend_after=rplan.backend,
            resumed_from_batch=int(restored.batches_seen),
            retries=retries, wall_s=wall,
            r8_peak_bytes=rplan.peak_bytes, reasons=rplan.reasons)
        self.events.append(event)
        obs.counter_add("recovery_events_total", labels={"kind": kind})
        obs.event("recover.resume", kind=kind,
                  survivors=len(self.healthy),
                  resumed_from_batch=int(restored.batches_seen))

    # -- the supervised stream loop ---------------------------------------

    def _commit(self) -> None:
        """Checkpoint the current state: one device to host copy now, the
        file written in the background."""
        self.ckpt.save(int(self.state.batches_seen), host_state(self.state),
                       blocking=False)

    def run(self, batches: Sequence, *, draws=None, omegas=None):
        """Ingest every batch, surviving faults; returns the final
        state.  ``batches`` must be a re-indexable sequence: recovery
        replays the batches after the last commit (a generator cannot
        rewind; spool it first).  ``draws`` / ``omegas`` inject each
        batch's random inputs as callables of its global batch index
        (``api.svd_stream``'s), so a replayed batch takes the same ones."""
        from repro_torch.core import api

        batches = list(batches)
        every = self.config.checkpoint_every or 1
        i = int(self.state.batches_seen) - self._base
        if i < 0:
            raise ValueError(
                f"state.batches_seen={self.state.batches_seen} is behind "
                f"the supervisor's base {self._base}")
        attempt = 0
        while i < len(batches):
            chunk = batches[i:i + every]
            lo = self._base + i
            hi = lo + len(chunk)
            if self.injector is not None:
                self.injector.begin_batches(lo, hi)
            t0 = clock.now()
            try:
                result = api.svd_stream(chunk, self.config,
                                        state=self.state, draws=draws,
                                        omegas=omegas)
            except CollectiveDropError as e:
                attempt += 1
                obs.counter_add("ingest_retries_total")
                if attempt > self.config.max_retries:
                    # Bounded retry exhausted: escalate to the full
                    # device-loss path (re-plan + restore), the honest
                    # reading of a collective that will not come back.
                    self._recover("collective_escalate", e.batch, None,
                                  self._m_hint(chunk), retries=attempt)
                    i = int(self.state.batches_seen) - self._base
                    attempt = 0
                    continue
                self.events.append(RecoveryEvent(
                    kind="collective_retry", batch=e.batch, device=None,
                    survivors=len(self.healthy),
                    backend_before=self.backend,
                    backend_after=self.backend,
                    resumed_from_batch=int(self.state.batches_seen),
                    retries=attempt, wall_s=clock.now() - t0,
                    r8_peak_bytes=0, reasons=(
                        f"transient collective drop at batch {e.batch}; "
                        f"replaying the uncommitted chunk (attempt "
                        f"{attempt}/{self.config.max_retries}) — the "
                        f"PRNG chain keys on batches_seen, so the retry "
                        f"is bit-identical",)))
                obs.counter_add("recovery_events_total",
                                labels={"kind": "collective_retry"})
                if self.config.retry_backoff_s:
                    time.sleep(self.config.retry_backoff_s
                               * (2 ** (attempt - 1)))
                continue
            except DeviceLostError as e:
                self._recover("device_lost", e.batch, e.device,
                              self._m_hint(chunk))
                i = int(self.state.batches_seen) - self._base
                attempt = 0
                continue
            attempt = 0
            self.state = result.state
            i += len(chunk)
            self._commit()
            self.chunk_seconds.append((lo, hi, clock.now() - t0))
            verdict = self._observe_window(self.chunk_seconds[-1][2], hi - 1)
            if verdict["evict"]:
                # Evict the slowest flagged slot at this (just
                # committed) boundary; remaining evictees get caught on
                # later windows against the re-meshed monitor.
                slot = verdict["evict"][0]
                obs.counter_add("straggler_evictions_total")
                self._recover("straggler_evict", hi - 1,
                              self.healthy[slot], self._m_hint(chunk))
                i = int(self.state.batches_seen) - self._base
        self.ckpt.wait()
        return self.state

    @staticmethod
    def _m_hint(chunk) -> int:
        try:
            return int(stream_state.delta_shape(chunk[0])[0])
        except (TypeError, ValueError, AttributeError):
            return 1

    def events_json(self) -> List[Dict]:
        return [e.to_json() for e in self.events]

    def write_events(self, path: str, **extra) -> None:
        """The chaos artifact: recovery events + pool summary as JSON."""
        doc = dict(events=self.events_json(),
                   healthy=len(self.healthy), pool=self.pool.size,
                   backend=self.backend,
                   backup_saved_s=self.backup_saved_s, **extra)
        with open(path, "w") as f:
            json.dump(doc, f, indent=2)
