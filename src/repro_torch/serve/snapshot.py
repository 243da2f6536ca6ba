"""Double-buffered serving snapshots over a :class:`StreamingSVDState`.

Serving and ingestion run concurrently: queries score against the
current factorization while ``svd_update`` folds the next batch in.
Readers must never observe a torn state: ``s`` from one ingest and ``v``
from another scores garbage silently.  The contract is the classic
double buffer:

* :class:`ServingSnapshot` is a FROZEN dataclass holding everything a
  query needs, ``(u_rows?, s, v)`` plus the int8 twin, captured from one
  state.  It is never mutated; freshness is a new snapshot.
* :class:`SnapshotBuffer` holds a front (serving) and a back (staged)
  snapshot.  Ingests :meth:`~SnapshotBuffer.stage` into the back buffer
  (an arbitrarily slow operation that readers never see) and
  :meth:`~SnapshotBuffer.publish` flips one reference between request
  waves.  Reads return the whole front snapshot via a single attribute
  load, which Python guarantees atomic, so every query scores against
  exactly one state version.

On the GPU the ingest may run on a CUDA stream of its own: ``stage``
waits for the staging thread's current stream before the snapshot can be
published, so a reader on another stream never sees factors that are
still being written.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.obs import clock
from repro_torch.serve import kvquant
from repro_torch.stream.state import StreamingSVDState


@dataclasses.dataclass(frozen=True)
class ServingSnapshot:
    """One immutable, internally-consistent serving view of a state.

    ``s`` (k,) and ``v`` (n_pad, k), padded column order, are the scoring
    pair; ``v_q`` / ``v_scale`` are the int8 twin (per-item symmetric
    scales, folded into the score contraction by the ranker) and replace
    ``v`` when ``quantize=True`` so the f32 factors are not resident
    twice.  ``u_rows`` optionally carries the row factors for user-id
    lookups.  ``version`` is the publish counter.  A snapshot of a
    sharded state keeps its ``mesh``: ``v`` / ``v_q`` / ``v_scale`` then
    hold the rows of the process's slots (the sharded ranker scores each
    slot's (W, k) slice).
    """

    s: torch.Tensor
    v: Optional[torch.Tensor]
    v_q: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    u_rows: Optional[torch.Tensor]
    n: int
    num_blocks: int
    version: int
    mesh: Optional[object] = dataclasses.field(default=None, compare=False)

    @property
    def rank(self) -> int:
        return int(self.s.shape[0])

    @property
    def quantized(self) -> bool:
        return self.v_q is not None

    @property
    def device(self) -> torch.device:
        return self.s.device

    @property
    def width(self) -> int:
        """Column-block width W = ceil(n / num_blocks)."""
        return -(-self.n // self.num_blocks)

    @classmethod
    def from_state(
        cls,
        state: StreamingSVDState,
        *,
        quantize: bool = False,
        keep_u: bool = False,
        version: int = 0,
    ) -> "ServingSnapshot":
        """Capture one state into a serving view.

        ``quantize=True`` stores int8 factors + per-item scales instead
        of the f32 ``v`` (kvquant axis=-1: each item row shares one
        scale, exactly the fold the kernel consumes).
        """
        if state.rank == 0:
            raise ValueError(
                "cannot serve a rank-0 state: ingest at least one batch "
                "before serve_init")
        v = v_q = v_scale = None
        if quantize:
            v_q, v_scale = kvquant.quantize(state.v, axis=-1)
        else:
            # The state's v is a column slice of the merge's output, a
            # strided view: the snapshot keeps a contiguous copy, made once
            # here rather than by the kernel's wrapper at every wave (what
            # R7's drift probe showed on the card: twice the planned bytes
            # a wave).
            v = state.v.contiguous()
        return cls(
            s=state.s,
            v=v,
            v_q=v_q,
            v_scale=v_scale,
            u_rows=state.u if keep_u else None,
            n=state.n,
            num_blocks=state.num_blocks,
            version=version,
            mesh=state.mesh,
        )


class SnapshotBuffer:
    """Front/back snapshot pair with an atomic publish flip.

    ``read()`` is wait-free (one attribute load); ``stage`` and
    ``publish`` serialize on a lock so concurrent ingest threads cannot
    interleave a half-staged back buffer into a flip.
    """

    def __init__(self, snapshot: ServingSnapshot):
        self._front = snapshot
        self._back: Optional[ServingSnapshot] = None
        self._lock = threading.Lock()
        # Wall stamp of the last publish: staleness is answerable
        # (ServeHandle.metrics) without any observability layer.
        self._published_at = clock.wall()

    def read(self) -> ServingSnapshot:
        """The current serving snapshot: always one consistent state."""
        return self._front

    @property
    def version(self) -> int:
        return self._front.version

    def age_seconds(self) -> float:
        """Seconds since the front snapshot was published."""
        return clock.wall() - self._published_at

    def stage(self, state: StreamingSVDState, *,
              quantize: Optional[bool] = None,
              keep_u: Optional[bool] = None) -> ServingSnapshot:
        """Build the next snapshot into the back buffer.

        Inherits quantize/keep_u from the front snapshot unless
        overridden; readers are untouched until :meth:`publish`.  On the
        GPU it returns only when the staging thread's current stream has
        finished the work that produced the snapshot.
        """
        front = self._front
        if quantize is None:
            quantize = front.quantized
        if keep_u is None:
            keep_u = front.u_rows is not None
        with obs.span("snapshot.stage", version=front.version + 1,
                      quantize=quantize):
            snap = ServingSnapshot.from_state(
                state, quantize=quantize, keep_u=keep_u,
                version=front.version + 1)
            if snap.device.type == "cuda":
                torch.cuda.current_stream(snap.device).synchronize()
            with self._lock:
                self._back = snap
        return snap

    def publish(self) -> ServingSnapshot:
        """Flip the staged back buffer to the front.  No-op (returns the
        current front) when nothing is staged."""
        with self._lock:
            if self._back is not None:
                self._front = self._back
                self._back = None
                self._published_at = clock.wall()
            front = self._front
        obs.event("snapshot.publish", version=front.version)
        obs.gauge_set("snapshot_version", front.version)
        return front

    def commit(self, state: StreamingSVDState, **stage_kw) -> ServingSnapshot:
        """stage + publish in one call: the per-ingest convenience."""
        self.stage(state, **stage_kw)
        return self.publish()
