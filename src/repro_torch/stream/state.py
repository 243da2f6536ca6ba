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
tensors (``device``).

**Sharded residency** (``stream_backend="shard_map"``): ``v`` rows are in
padded column order, so one column block's (W, k) slice belongs to each
slot of the stream mesh (``core/collectives.py``), the layout of
``core/distributed.py``.  A sharded state carries its ``mesh`` and holds in
``v`` the rows of the process's slots only: the whole ``v`` on a
:class:`~repro_torch.core.collectives.LocalMesh` (one card standing for D
devices keeps the (D, W, k) stack), one (W, k) block on a rank of a
:class:`~repro_torch.core.collectives.ProcessGroupMesh`.
:func:`shard_state` / :func:`gather_state` move a state between the two
layouts without changing a value; checkpoints are saved gathered and
``Checkpointer.restore`` re-shards onto the CURRENT pool through
:meth:`StreamingSVDState.reshard_for_restore`.

**The stream pool** (:func:`set_stream_devices`): the block slots the
streaming engines may place work on.  By default, the ranks of an
initialized process group, else the visible GPUs (one slot on the CPU).
``set_stream_devices(LocalMesh(...))`` lets one card stand for D devices.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import collectives, ranky, sparse

# The one mesh-axis name of the streaming engines (one column block a
# slot, like core/distributed.py's block axes).
STREAM_AXIS = "blocks"

# ---------------------------------------------------------------------------
# The active stream pool
# ---------------------------------------------------------------------------
_STREAM_POOL: Optional[collectives.BlockMesh] = None
_PG_MESHES: dict = {}


class Slot(NamedTuple):
    """One entry of the stream pool: a block slot, its device and the rank
    that holds it."""

    index: int
    device: str
    rank: int


def set_stream_devices(devices) -> None:
    """Set (or with ``None`` reset) the pool the streaming engines draw
    from: a :class:`~repro_torch.core.collectives.BlockMesh` whose slots
    make up the pool (``LocalMesh`` to let one card stand for D devices).
    ``stream_mesh(D)`` takes the first D slots of a local pool."""
    global _STREAM_POOL
    if devices is not None and not isinstance(devices,
                                              collectives.BlockMesh):
        raise TypeError(
            f"the stream pool is a BlockMesh (LocalMesh / "
            f"ProcessGroupMesh) or None; got {type(devices)}")
    _STREAM_POOL = devices


def _process_group() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def explicit_pool() -> bool:
    """Whether the pool was set, or comes from a process group (rather
    than from the visible GPUs)."""
    return _STREAM_POOL is not None or _process_group()


def stream_devices() -> Tuple[Slot, ...]:
    """The active pool's slots (see the module docstring)."""
    if _STREAM_POOL is not None:
        mesh = _STREAM_POOL
        one_a_rank = isinstance(mesh, collectives.ProcessGroupMesh)
        return tuple(Slot(i, str(mesh.device), i if one_a_rank else 0)
                     for i in range(mesh.size))
    if _process_group():
        world = torch.distributed.get_world_size()
        return tuple(Slot(r, "rank", r) for r in range(world))
    n = torch.cuda.device_count()
    if n == 0:
        return (Slot(0, "cpu", 0),)
    return tuple(Slot(i, f"cuda:{i}", 0) for i in range(n))


def stream_device_count() -> int:
    """``len(stream_devices())``: what the planner's R5d / R6 / R7 backend
    gates and the sharded engines see as "the device count"."""
    return len(stream_devices())


def stream_devices_key() -> Tuple[int, ...]:
    """Hashable identity of the active pool: its slot indices, and the
    pool's own identity when one is set."""
    return tuple(s.index for s in stream_devices()) + (
        (id(_STREAM_POOL),) if _STREAM_POOL is not None else ())


def stream_mesh(num_blocks: int, devices=None) -> collectives.BlockMesh:
    """The one-axis (num_blocks,) mesh the sharded stream engines run on,
    one column block a slot.  From a local pool (``devices`` or the active
    one) it is a LocalMesh of its first ``num_blocks`` slots; from a
    process group (the pool's, or the default WORLD) the group itself,
    which must have ``num_blocks`` ranks."""
    pool = devices if devices is not None else _STREAM_POOL
    if pool is not None:
        if pool.size < num_blocks:
            raise ValueError(
                f"sharded streaming needs one device per column block: "
                f"num_blocks={num_blocks} but only {pool.size} healthy "
                f"device(s) in the stream pool")
        if isinstance(pool, collectives.LocalMesh):
            if pool.size == num_blocks and pool.axis_names == (STREAM_AXIS,):
                return pool
            return collectives.LocalMesh({STREAM_AXIS: num_blocks},
                                         pool.device)
        if pool.size != num_blocks:
            raise ValueError(
                f"sharded streaming over a process group needs one rank per "
                f"column block: num_blocks={num_blocks} but the pool has "
                f"{pool.size} ranks")
        return pool
    if _process_group():
        world = torch.distributed.get_world_size()
        if world != num_blocks:
            raise ValueError(
                f"sharded streaming needs one device per column block: "
                f"num_blocks={num_blocks} but device_count={world}")
        if num_blocks not in _PG_MESHES:
            _PG_MESHES[num_blocks] = collectives.ProcessGroupMesh(
                {STREAM_AXIS: num_blocks}, device=_rank_device())
        return _PG_MESHES[num_blocks]
    raise ValueError(
        f"sharded streaming needs one device per column block: "
        f"num_blocks={num_blocks}, and this process is not in a process "
        f"group; start one process a GPU (torch.distributed) or let one "
        f"card stand for the blocks: set_stream_devices(LocalMesh("
        f"{num_blocks}))")


def _rank_device():
    return (torch.device("cuda", torch.cuda.current_device())
            if torch.cuda.is_available() else torch.device("cpu"))


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
    # The stream mesh of a sharded state (``v`` then holds the rows of the
    # process's slots only); None for the single-device layout.
    mesh: Optional[collectives.BlockMesh] = dataclasses.field(
        default=None, compare=False)

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

    @property
    def sharded_rows(self) -> bool:
        """Whether ``v`` holds only some slots' rows (a rank's block)."""
        return self.mesh is not None and self.mesh.n_local < self.num_blocks

    def trimmed_v(self) -> torch.Tensor:
        """``v`` with the padding columns trimmed back off: rows in
        ORIGINAL column order, the front-door convention.  On a rank of a
        process group, this rank's block's rows (those below ``n``)."""
        if self.sharded_rows:
            first = self.mesh.local_slots[0] * self.width
            return self.v[:max(0, min(self.width, self.n - first))]
        return self.v[:self.n]

    def reshard_for_restore(self) -> "StreamingSVDState":
        """Called by ``Checkpointer.restore`` after the rebuild: re-shard
        ``v`` onto the CURRENT pool when it has one slot a column block
        (checkpoints are saved gathered, so a state saved on 8 slots
        restores onto 1, and the other way round, without the file
        knowing either layout)."""
        if (stream_device_count() == self.num_blocks
                and stream_device_count() > 1 and explicit_pool()):
            return shard_state(self)
        return self


def shard_state(state: StreamingSVDState, mesh=None) -> StreamingSVDState:
    """The state in the sharded layout of ``mesh`` (the stream mesh of its
    column blocks by default): ``v`` keeps the rows of the mesh's local
    slots, on the mesh's device; values are untouched."""
    if mesh is None:
        mesh = stream_mesh(state.num_blocks)
    if mesh.size != state.num_blocks:
        raise ValueError(
            f"a state of {state.num_blocks} column blocks shards over a "
            f"mesh of as many slots, got {mesh.size}")
    if state.mesh is mesh:
        return state
    if state.sharded_rows:
        state = gather_state(state)
    dev = mesh.device
    v = state.v.to(dev)
    if mesh.n_local < state.num_blocks:
        w = state.width
        v = torch.cat([v[d * w:(d + 1) * w] for d in mesh.local_slots])
    return dataclasses.replace(state, u=state.u.to(dev), s=state.s.to(dev),
                               v=v, mesh=mesh)


def gather_state(state: StreamingSVDState, device=None) -> StreamingSVDState:
    """Every row of ``v`` on one device (``device``, or the state's own):
    the single-device layout, the inverse of :func:`shard_state`.  On a
    process group every rank must call it (an all-gather of ``v``)."""
    v = state.v
    if state.sharded_rows:
        mesh = state.mesh
        k = v.shape[1]
        v = mesh.all_gather(v.reshape(mesh.n_local, state.width, k)
                            )[0].reshape(state.num_blocks * state.width, k)
    dev = state.device if device is None else torch.device(device)
    return dataclasses.replace(state, u=state.u.to(dev), s=state.s.to(dev),
                               v=v.to(dev), mesh=None)


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
