"""The state of a long-lived streaming Ranky SVD.

A streaming solve never sees the whole matrix: rows arrive in batches
(a day of user-item interactions, a window of network logs) and the
service must keep serving an up-to-date truncated factorization of
everything ingested so far.  :class:`StreamingSVDState` is the entire
state of such a service:

* ``u`` (rows_seen, k) / ``s`` (k,) / ``v`` (n_pad, k): the truncated
  factorization of every row ingested so far (after ``history_decay``
  weighting).  ``v`` is load-bearing for ingestion: ``diag(s) @ v.T`` is
  the rank-k proxy of the whole history that the next merge-and-truncate
  folds the next batch into.  ``u`` rows are in ingestion order, so it
  grows with ``rows_seen``; the merge itself never touches anything
  bigger than O(batch + (k+p) * N) (planner rule R5).
* the *column universe*: ``n`` global columns split into ``num_blocks``
  column blocks of width ``ceil(n / num_blocks)``, the one
  block-splitting convention of ``core/sparse.py``.  ``v`` rows are in
  padded column order (n_pad = num_blocks * width).
* the Ranky repair side-band, accumulated: ``lonely_rows_seen`` /
  ``repaired_rows_seen``.
* the seed chain: ``seed`` is the root; ingest ``b`` draws from
  ``ranky.derive_seed(seed, b)`` (the port's counterpart of the
  reference's ``fold_in(key, b)``), so a replayed stream re-draws the
  same repair columns and sketch matrices.

A frozen dataclass of tensors; the state lives on the device of its
tensors (``device``).  The device pool, the stream mesh and the sharded
layout (``shard_state`` / ``gather_state``) belong to the distributed
slice and are not here yet.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import ranky, sparse


@dataclasses.dataclass(frozen=True)
class StreamingSVDState:
    """Everything a streaming SVD service needs to go on.

    ``rank`` is ``s.shape[0]``: it grows batch by batch until it reaches
    the configured ``truncate_rank`` and stays there.
    """

    u: torch.Tensor     # (rows_seen, k) left vectors, ingestion order
    s: torch.Tensor     # (k,) singular values (history-decayed)
    v: torch.Tensor     # (n_pad, k) right vectors, padded column order
    seed: int           # seed chain root; batch b uses derive_seed(seed, b)
    n: int              # column universe (unpadded)
    num_blocks: int     # column-block count D of the universe
    rows_seen: int      # total rows ingested
    batches_seen: int   # total svd_update calls folded in
    lonely_rows_seen: int    # cumulative lonely rows across batches
    repaired_rows_seen: int  # cumulative Ranky side-band repairs

    @property
    def rank(self) -> int:
        """Current truncation rank k (0 for a freshly initialized state)."""
        return int(self.s.shape[0])

    @property
    def width(self) -> int:
        """Column-block width W = ceil(n / num_blocks)."""
        return sparse.block_width(self.n, self.num_blocks)

    @property
    def n_pad(self) -> int:
        """Padded column count D*W that ``v`` rows are indexed by."""
        return self.num_blocks * self.width

    @property
    def device(self) -> torch.device:
        return self.v.device

    def trimmed_v(self) -> torch.Tensor:
        """``v`` with the padding columns trimmed back off: rows in
        ORIGINAL column order, the front-door convention."""
        return self.v[:self.n]


def init_state(n: int, *, num_blocks: int, seed: ranky.Key = None,
               device=None) -> StreamingSVDState:
    """A rank-0 state over an ``n``-column universe split ``num_blocks``
    ways, on ``device`` (``None``: the GPU).  The first ingest grows it to
    the batch's rank; no special-casing anywhere (empty panels
    concatenate away)."""
    if n < 1:
        raise ValueError(f"init_state needs n >= 1 columns, got {n}")
    if num_blocks < 1:
        raise ValueError(f"init_state needs num_blocks >= 1, got {num_blocks}")
    device = resolve_device(device)
    w = sparse.block_width(n, num_blocks)
    return StreamingSVDState(
        u=torch.zeros((0, 0), dtype=torch.float32, device=device),
        s=torch.zeros((0,), dtype=torch.float32, device=device),
        v=torch.zeros((num_blocks * w, 0), dtype=torch.float32,
                      device=device),
        seed=ranky.seed_of(seed),
        n=n, num_blocks=num_blocks,
        rows_seen=0, batches_seen=0,
        lonely_rows_seen=0, repaired_rows_seen=0)


# ---------------------------------------------------------------------------
# Delta normalization: one adapter for the three accepted representations
# ---------------------------------------------------------------------------

Delta = Union[np.ndarray, torch.Tensor, "sparse.COOMatrix", "sparse.BlockEll"]


def delta_shape(delta: Delta) -> Tuple[int, int]:
    """(batch rows, columns) of any accepted delta representation."""
    if isinstance(delta, sparse.BlockEll):
        return delta.m, delta.n
    if isinstance(delta, sparse.COOMatrix):
        return delta.shape
    shape = tuple(delta.shape) if isinstance(delta, torch.Tensor) \
        else np.shape(delta)
    if len(shape) != 2:
        raise ValueError(f"dense delta must be 2-D, got shape {shape}")
    return shape[0], shape[1]


def _dense_on(delta, device: torch.device) -> torch.Tensor:
    if not isinstance(delta, torch.Tensor):
        # np.array copies: the tensor owns writable memory, whatever held
        # the rows.
        delta = torch.from_numpy(np.array(delta, dtype=np.float32))
    return delta.to(device=device, dtype=torch.float32)


def as_delta(delta: Delta, state: StreamingSVDState, *, device=None):
    """Normalize a batch of new rows into the state's column universe, on
    ``device`` (``None``: the state's device; the window driver normalizes
    on the host and stacks a window before one copy to the card).

    * dense (m_b, n) rows (ndarray or tensor): zero-padded to the
      universe's block multiple (lossless), a float32 tensor;
    * ``COOMatrix``: converted to a ``BlockEll`` over the universe's
      ``num_blocks`` (sparse-native; the batch is never densified);
    * ``BlockEll``: passed through (its universe must match), moved.

    Every representation must already be indexed by the state's column
    universe.  Dense rows already in padded column order (n_pad columns)
    are taken as they are, so normalizing twice changes nothing.
    """
    device = state.device if device is None else torch.device(device)
    m_b, n_d = delta_shape(delta)
    if m_b < 1:
        raise ValueError(f"delta has {m_b} rows; an ingest needs >= 1")
    if n_d != state.n:
        if (n_d == state.n_pad
                and not isinstance(delta, (sparse.BlockEll,
                                           sparse.COOMatrix))):
            return _dense_on(delta, device)
        raise ValueError(
            f"delta has {n_d} columns but the streaming state's column "
            f"universe is n={state.n}; deltas must be indexed by the "
            f"universe (pad new-column data into it up front)")
    if isinstance(delta, sparse.BlockEll):
        if delta.num_blocks != state.num_blocks:
            raise ValueError(
                f"BlockEll delta has {delta.num_blocks} blocks but the "
                f"state's universe has num_blocks={state.num_blocks}")
        return delta.to(device)
    if isinstance(delta, sparse.COOMatrix):
        return sparse.block_ell_from_coo(delta, state.num_blocks,
                                         device=device)
    t = _dense_on(delta, device)
    rem = state.n_pad - n_d
    return torch.nn.functional.pad(t, (0, rem)) if rem else t
