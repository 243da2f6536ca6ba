"""One front door for the Ranky distributed SVD: ``svd(a, config)``.

* :class:`SolveConfig`: a frozen dataclass holding EVERY knob of the
  reference's ``repro.core.api.SolveConfig`` (so configs written for the
  reference construct unchanged), with all cross-field validation in
  ``__post_init__`` (invalid configs cannot be constructed; every error
  names the offending fields).
* :func:`svd`: normalizes any input representation (dense array or
  tensor, ``sparse.COOMatrix``, ``sparse.BlockEll``) through one
  :func:`as_block_input` adapter, asks the planner (``core/planner.py``)
  for an explainable :class:`~repro_torch.core.planner.Plan`, runs the
  single-host engine or the hierarchical tree merge, and wraps the result
  in :class:`SVDResult` with the plan and diagnostics (lonely/repaired row
  counts, estimated peak bytes, wall time).
* :func:`plan`: the planner alone: what WOULD ``svd`` do for a matrix
  of this shape, and why.
* :func:`svd_init` / :func:`svd_update`: the STREAMING front door
  (``repro_torch.stream`` underneath): fold batches of new rows into a
  long-lived truncated factorization by merge-and-truncate, with
  :func:`plan_update` answering rule R5's "does one ingest fit this
  device" from the batch shape alone; :func:`svd_stream` folds a whole
  sequence of batches, same-bucket batches in windows (rule R6,
  ``repro_torch.stream.window``).
* :func:`serve_init` / :func:`serve_topk`: the SERVING front door (rule
  R7): a double-buffered snapshot of a streamed state, answered in
  request waves by the fused score + top-k kernel.

Device: the entry points run on the GPU.  ``device=None`` resolves to the
current CUDA device and RAISES when there is none; pass ``device="cpu"``
to run on the host (the tests do).  A ``BlockEll`` or tensor input that
already lies on a device is moved to the resolved one.

Backends: ``single``, ``hierarchical`` and ``shard_map`` (one column
block a slot of a ``core.collectives.BlockMesh``: ``mesh=`` names it, else
the active stream pool's, ``stream.state.set_stream_devices``).  The
planner's backend gates count the pool's slots
(``stream.state.stream_device_count()``), not the visible CUDA devices.

Determinism: ``key=None`` everywhere resolves to the ONE documented
default seed ``ranky.DEFAULT_SEED``, so repeated solves of the same input
are reproducible.  The random inputs of a solve may also be injected
(``draws=``, ``omega=``), which is how the port is held against the
reference.

Usage::

    from repro_torch.core.api import svd, SolveConfig

    res = svd(coo, SolveConfig(method="neighbor_random", rank=16))
    res.u, res.s, res.v      # factors (v None unless want_right=True)
    print(res.plan.explain())            # why this strategy
    res.diagnostics.repaired_rows        # Ranky side-band counts
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.core import planner, ranky, sparse
from repro_torch.core import svd as lsvd
from repro_torch.core.planner import ASpec, Plan, PlanError  # noqa: F401  (re-export)
from repro_torch.core.ranky import Key, RepairDraws  # noqa: F401  (re-export)
from repro_torch.obs import clock
from repro_torch.obs.gate import _STATE as _OBS_GATE
from repro_torch.serve import ranker as ranker_mod

BACKENDS = ("single", "hierarchical", "shard_map", "auto")
STREAM_BACKENDS = ("single", "shard_map", "auto")
LOCAL_MODES = ("gram", "svd")
MERGE_MODES = ("proxy", "gram")

# Above this M the repaired-row diagnostic for method="neighbor" is
# skipped (it needs the O(M^2) row adjacency); the count is exact and
# O(M) for the other methods at any scale.
_REPAIR_DIAG_MAX_M = 4096

MatrixInput = Union[np.ndarray, torch.Tensor, "sparse.COOMatrix",
                    "sparse.BlockEll"]


def _bad(field_a: str, val_a, field_b: str, val_b, why: str,
         kind: str = "SolveConfig") -> ValueError:
    return ValueError(
        f"invalid {kind}: {field_a}={val_a!r} with {field_b}={val_b!r} "
        f"— {why}")


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """Every knob of the unified solver, validated on construction.

    Fields (all optional; the defaults give the fast beyond-paper exact
    path with NeighborRandomChecker repair and an auto-planned backend):

    * ``method`` — rank-repair checker, one of ``ranky.METHODS``.
    * ``backend`` — ``"single"`` (one-level, one host),
      ``"hierarchical"`` (host-orchestrated tree merge),
      ``"shard_map"`` (one column block per mesh device) or ``"auto"``
      (the planner decides; see ``core/planner.py`` for the rules).
    * ``local_mode`` — per-block factorization for the proxy merge:
      ``"gram"`` (gram+eigh) or ``"svd"`` (paper dgesvd
      analogue; dense input only).
    * ``merge_mode`` — ``"gram"`` (beyond-paper psum/sum of grams) or
      ``"proxy"`` (paper-faithful proxy-panel SVD).  The hierarchical
      backend merges panels by construction and ignores this.
    * ``rank`` / ``oversample`` / ``power_iters`` — ``rank=k`` requests
      a truncated top-k solve; on the single/shard_map backends that is
      the randomized (k+p)-row sketch (``core/randomized.py``), on the
      hierarchical backend the truncated tree merge.
    * ``num_blocks`` — column-block count D; ``None`` derives it from
      the input (BlockEll carries its D), the mesh, or the planner
      default.
    * ``fanout`` — tree-merge group size (hierarchical backend).
    * ``sketch`` — hierarchical backend only: randomized truncated leaf
      panels instead of exact gram+eigh leaves.
    * ``want_right`` — also recover right vectors V (all backends).
    * ``use_kernel`` — route the grams through the hand-written CUDA kernels
      (``False`` leaves them to plain ``torch.matmul`` products; the
      sparse sketch always runs through the ``sketch_panel`` kernel).
      ``None`` (the default) means the kernels for an operand on a CUDA
      device and the plain products on the CPU, and ``False`` under
      ``local_mode="svd"``, which forms no gram
      (``svd.resolve_use_kernel``).
    * ``undetermined_tail`` — emulate the paper's rank problem (single
      backend, proxy merge, exact only).
    * ``two_level`` — shard_map backend: two-level (intra/inter pod)
      proxy merge over two mesh block axes.
    * ``truncate_rank`` — streaming only (``svd_update`` /
      ``svd_stream``): the rank k the merge-and-truncate state is
      re-truncated to after every ingest.  Required for streaming.
    * ``history_decay`` — streaming only: multiply the retained
      singular values by this factor before every merge (1.0 = plain
      concatenation semantics; < 1 forgets old rows exponentially).
    * ``stream_backend`` — streaming only: ``"single"`` (one-host
      merge-and-truncate), ``"shard_map"`` (the state's ``v`` and the
      merge panel sharded one column block per device — planner rule
      R5d; degrades honestly to single-host when the device count does
      not match ``num_blocks``) or ``"auto"`` (shard_map exactly when
      one device per column block is available).
    * ``window`` — streaming only (``svd_stream``): scan-window length
      for the one-compilation stream loop (planner rule R6).  ``None``
      lets the planner pick (target ``planner.DEFAULT_WINDOW``, shrunk
      to fit the budget); ``1`` forces the per-batch loop (each batch
      its own dispatch — same jitted step, so loop and scan results are
      bit-identical); ``T`` folds up to T same-bucket batches into one
      scan dispatch.
    * ``adaptive_width`` — streaming only: pick the exact batch
      factorization's merge width ``l_b = k + p_eff`` from the observed
      spectral tail of the running state (``stream.window.
      adaptive_oversample``) instead of the static ``k + oversample``;
      a width change re-buckets (and retraces) the scan.
    * ``memory_budget_bytes`` — planner budget (default 4 GiB).
    * ``checkpoint_every`` — streaming only: commit granularity of a
      supervised stream (``ft.StreamSupervisor``): the supervisor
      checkpoints after every N successfully ingested batches, and
      recovery resumes from the last committed one.  ``None`` (the
      default) means "supervisor default" (every batch).
    * ``max_retries`` / ``retry_backoff_s`` — streaming only: the
      supervisor's bounded retry policy.  A transient fault (dropped
      collective) replays the uncommitted batches up to ``max_retries``
      times, sleeping ``retry_backoff_s * 2**attempt`` between tries,
      before escalating to a full device-loss recovery.
    * ``observe`` — switch on the runtime observability layer
      (``obs``: span traces, metrics, plan-vs-measured drift) for
      this and every later call; sticky process-wide, off by default.
      Disabled mode costs one boolean check per instrumentation point —
      zero extra dispatches, bit-identical results.
    * ``key`` — integer seed or ``torch.Generator`` (its initial seed is
      used); ``None`` means ``ranky.DEFAULT_SEED``.
    """

    method: str = "neighbor_random"
    backend: str = "auto"
    local_mode: str = "gram"
    merge_mode: str = "gram"
    rank: Optional[int] = None
    oversample: int = 8
    power_iters: int = 2
    num_blocks: Optional[int] = None
    fanout: int = 4
    sketch: bool = False
    want_right: bool = False
    use_kernel: Optional[bool] = None
    undetermined_tail: bool = False
    two_level: bool = False
    truncate_rank: Optional[int] = None
    history_decay: float = 1.0
    stream_backend: str = "auto"
    window: Optional[int] = None
    adaptive_width: bool = False
    memory_budget_bytes: Optional[int] = None
    checkpoint_every: Optional[int] = None
    max_retries: int = 2
    retry_backoff_s: float = 0.0
    observe: bool = False
    key: Key = None

    def __post_init__(self):
        # --- single-field domains -----------------------------------
        if self.method not in ranky.METHODS:
            raise ValueError(f"invalid SolveConfig: method={self.method!r} "
                             f"must be one of {ranky.METHODS}")
        if self.backend not in BACKENDS:
            raise ValueError(f"invalid SolveConfig: backend={self.backend!r} "
                             f"must be one of {BACKENDS}")
        if self.local_mode not in LOCAL_MODES:
            raise ValueError(
                f"invalid SolveConfig: local_mode={self.local_mode!r} "
                f"must be one of {LOCAL_MODES}")
        if self.merge_mode not in MERGE_MODES:
            raise ValueError(
                f"invalid SolveConfig: merge_mode={self.merge_mode!r} "
                f"must be one of {MERGE_MODES}")
        if self.rank is not None and self.rank < 1:
            raise ValueError(f"invalid SolveConfig: rank={self.rank} "
                             f"must be >= 1 (or None for the exact solve)")
        if self.oversample < 0:
            raise ValueError(f"invalid SolveConfig: oversample="
                             f"{self.oversample} must be >= 0")
        if self.power_iters < 0:
            raise ValueError(f"invalid SolveConfig: power_iters="
                             f"{self.power_iters} must be >= 0")
        if self.num_blocks is not None and self.num_blocks < 1:
            raise ValueError(f"invalid SolveConfig: num_blocks="
                             f"{self.num_blocks} must be >= 1")
        if self.fanout < 2:
            raise ValueError(f"invalid SolveConfig: fanout={self.fanout} "
                             f"must be >= 2")
        if self.truncate_rank is not None and self.truncate_rank < 1:
            raise ValueError(
                f"invalid SolveConfig: truncate_rank={self.truncate_rank} "
                f"must be >= 1 (or None outside the streaming path)")
        if not 0.0 < self.history_decay <= 1.0:
            raise ValueError(
                f"invalid SolveConfig: history_decay={self.history_decay} "
                f"must be in (0, 1] (1.0 = no forgetting)")
        if self.stream_backend not in STREAM_BACKENDS:
            raise ValueError(
                f"invalid SolveConfig: stream_backend="
                f"{self.stream_backend!r} must be one of {STREAM_BACKENDS}")
        if (self.memory_budget_bytes is not None
                and self.memory_budget_bytes < 1):
            raise ValueError(
                f"invalid SolveConfig: memory_budget_bytes="
                f"{self.memory_budget_bytes} must be >= 1")
        if self.window is not None and self.window < 1:
            raise ValueError(
                f"invalid SolveConfig: window={self.window} must be >= 1 "
                f"(1 = per-batch loop) or None for the planner default")
        if self.checkpoint_every is not None and self.checkpoint_every < 1:
            raise ValueError(
                f"invalid SolveConfig: checkpoint_every="
                f"{self.checkpoint_every} must be >= 1 (or None for the "
                f"supervisor default)")
        if self.max_retries < 0:
            raise ValueError(
                f"invalid SolveConfig: max_retries={self.max_retries} "
                f"must be >= 0")
        if self.retry_backoff_s < 0.0:
            raise ValueError(
                f"invalid SolveConfig: retry_backoff_s="
                f"{self.retry_backoff_s} must be >= 0")

        # --- cross-field constraints (each names both fields) -------
        if self.undetermined_tail and self.merge_mode == "gram":
            raise _bad("undetermined_tail", True, "merge_mode", "gram",
                       "the emulation fills dead proxy PANEL columns with "
                       "noise and the gram merge never builds panels; use "
                       "merge_mode='proxy'")
        if self.undetermined_tail and self.rank is not None:
            raise _bad("undetermined_tail", True, "rank", self.rank,
                       "the randomized rank-k path never builds proxy "
                       "panels; drop rank= to use the proxy merge")
        if self.undetermined_tail and self.backend in ("hierarchical",
                                                       "shard_map"):
            raise _bad("undetermined_tail", True, "backend", self.backend,
                       "the rank-problem emulation only exists in the "
                       "single-host proxy merge; use backend='single' or "
                       "'auto'")
        if self.sketch and self.backend in ("single", "shard_map"):
            raise _bad("sketch", True, "backend", self.backend,
                       "sketch leaves belong to the hierarchical tree "
                       "merge; for the single/shard_map randomized path "
                       "set rank=k instead")
        if self.two_level and self.backend != "shard_map":
            raise _bad("two_level", True, "backend", self.backend,
                       "the two-level merge schedules shard_map "
                       "collectives over two mesh axes; use "
                       "backend='shard_map' with a two-axis mesh")
        if self.local_mode == "svd" and self.backend == "hierarchical":
            raise _bad("local_mode", "svd", "backend", "hierarchical",
                       "the tree merge computes gram+eigh leaves; "
                       "local_mode only applies to the single/shard_map "
                       "proxy merge")
        if self.local_mode == "svd" and self.rank is not None:
            raise _bad("local_mode", "svd", "rank", self.rank,
                       "the randomized rank-k sketch replaces the local "
                       "factorization entirely; drop rank= or use "
                       "local_mode='gram'")
        if self.local_mode == "svd" and self.use_kernel:
            raise _bad("local_mode", "svd", "use_kernel", True,
                       # (the reference's wording, kept so that both
                       # packages raise the same message)
                       "the Pallas kernels accelerate the gram path; "
                       "local_mode='svd' never forms a gram")
        if self.truncate_rank is not None and self.undetermined_tail:
            raise _bad("truncate_rank", self.truncate_rank,
                       "undetermined_tail", True,
                       "the streaming merge-and-truncate never builds "
                       "proxy panels, so the rank-problem emulation "
                       "cannot apply; drop one of the two")
        if self.history_decay != 1.0 and self.truncate_rank is None:
            raise _bad("history_decay", self.history_decay,
                       "truncate_rank", None,
                       "history decay only applies to the streaming "
                       "merge (svd_update / svd_stream); set "
                       "truncate_rank=k to stream")
        if self.stream_backend != "auto" and self.truncate_rank is None:
            raise _bad("stream_backend", self.stream_backend,
                       "truncate_rank", None,
                       "stream_backend picks the svd_update / svd_stream "
                       "engine; set truncate_rank=k to stream (one-shot "
                       "solves pick their backend with backend=)")
        if self.window is not None and self.truncate_rank is None:
            raise _bad("window", self.window, "truncate_rank", None,
                       "the scan-window loop folds streaming ingests; "
                       "set truncate_rank=k to stream")
        if self.adaptive_width and self.truncate_rank is None:
            raise _bad("adaptive_width", True, "truncate_rank", None,
                       "the tail-adaptive merge width reads the streaming "
                       "state's spectrum; set truncate_rank=k to stream")
        if self.checkpoint_every is not None and self.truncate_rank is None:
            raise _bad("checkpoint_every", self.checkpoint_every,
                       "truncate_rank", None,
                       "the supervised commit cadence applies to streaming "
                       "ingests; set truncate_rank=k to stream")
        if self.adaptive_width and self.rank is not None:
            raise _bad("adaptive_width", True, "rank", self.rank,
                       "rank= forces the randomized batch factorization "
                       "whose width IS rank; the adaptive width picks the "
                       "EXACT path's merge width — drop one of the two")

    def resolved_key(self) -> int:
        """The integer seed this solve runs with (``ranky.DEFAULT_SEED`` if
        unset): the one documented ``key=None`` behaviour."""
        return ranky.seed_of(self.key)


@dataclasses.dataclass(frozen=True)
class Diagnostics:
    """Side-band observations of one solve.

    ``repaired_rows`` is exact for methods none/random/neighbor_random
    at any scale (those repair precisely the lonely rows); for
    ``neighbor`` it is derived from one more repair pass and is ``None``
    when M > 4096 (the pass needs the O(M^2) adjacency).

    ``wall_time_s = compile_time_s + run_time_s``: host wall time around
    the solve with the device synchronized at both ends.  The compile side
    is the time ``nvcc`` took to build the CUDA kernels during THIS call
    (the obs clock's compile probe), else 0, so a first call may report a
    large ``compile_time_s`` and a warm call 0; compare ``run_time_s``.

    With observability on (``SolveConfig(observe=True)`` or
    ``obs.enable()``): ``drift_ratios`` is the measured/planned peak-byte
    ratio per rule recorded so far, and ``span_summary`` the call's spans
    as ``(name, count, total_us)`` (durations from CUDA events on the
    card: device time between a span's two points).  Both ``None`` when
    obs is off.
    """

    lonely_rows_per_block: Tuple[int, ...]
    lonely_rows: int
    repaired_rows: Optional[int]
    strategy: str
    estimated_peak_bytes: int
    wall_time_s: float
    compile_time_s: float = 0.0
    run_time_s: float = 0.0
    drift_ratios: Optional[Dict[str, float]] = None
    span_summary: Optional[Tuple[Tuple[str, int, float], ...]] = None


@dataclasses.dataclass(frozen=True)
class SVDResult:
    """Factors + the plan that produced them + diagnostics.

    Unpacks like the legacy entry points' tuples: ``u, s = result`` (or
    ``u, s, v = result`` when ``want_right=True``).  ``v`` rows are in
    ORIGINAL column order (the adapter's zero-column padding is trimmed
    back off).  ``state`` is reserved for the streaming entry points and
    is ``None`` for one-shot solves.
    """

    u: torch.Tensor
    s: torch.Tensor
    v: Optional[torch.Tensor]
    plan: Plan
    diagnostics: Diagnostics
    state: Optional[Any] = None

    def __iter__(self):
        yield self.u
        yield self.s
        if self.v is not None:
            yield self.v


# ---------------------------------------------------------------------------
# Input normalization: one adapter for every representation
# ---------------------------------------------------------------------------

def describe(a: MatrixInput, num_blocks: int) -> ASpec:
    """Shape summary (M, N, nnz, D, kind) of any accepted input."""
    if isinstance(a, sparse.BlockEll):
        # Containers built by block_ell_from_coo carry their exact nnz;
        # hand-built ones without it fall back to counting stored values.
        nnz = a.nnz if a.nnz is not None else int(
            torch.count_nonzero(a.col_vals))
        return ASpec(m=a.m, n=a.n, nnz=nnz, num_blocks=num_blocks,
                     kind="ell")
    if isinstance(a, sparse.COOMatrix):
        return ASpec(m=a.shape[0], n=a.shape[1], nnz=a.nnz,
                     num_blocks=num_blocks, kind="coo")
    if a.ndim != 2:
        raise ValueError(f"dense input must be 2-D, got shape {tuple(a.shape)}")
    nnz = int(torch.count_nonzero(a) if isinstance(a, torch.Tensor)
              else np.count_nonzero(a))
    return ASpec(m=a.shape[0], n=a.shape[1], nnz=nnz, num_blocks=num_blocks,
                 kind="dense")


def as_block_input(a: MatrixInput, num_blocks: int, *,
                   needs_dense: bool = False, device=None):
    """Normalize any accepted representation for the engine, on ``device``.

    * dense ndarray / tensor: zero-pad columns to the block multiple
      (lossless for U and S) and hand back a float32 tensor;
    * ``COOMatrix``: build the device-side ``BlockEll`` container
      (sparse-native), or densify+pad when the config needs the dense
      path (``needs_dense``, e.g. ``local_mode='svd'``);
    * ``BlockEll``: passed through (its block count must match).
    """
    device = resolve_device(device)
    if isinstance(a, sparse.BlockEll):
        if a.num_blocks != num_blocks:
            raise ValueError(
                f"BlockEll has {a.num_blocks} blocks, but the resolved "
                f"num_blocks is {num_blocks}")
        if needs_dense:
            raise ValueError(
                "the sparse BlockEll path is gram-native; this config "
                "needs the dense path (local_mode='svd') — pass a dense "
                "array or a COOMatrix instead")
        return a.to(device)
    if isinstance(a, sparse.COOMatrix):
        if needs_dense:
            # local_mode='svd' is the paper's exact small-problem oracle
            # and needs the dense operand.
            dense = a.todense()  # ranky-lint: disable=RL104 -- svd oracle
            return torch.from_numpy(sparse.pad_to_block_multiple(
                dense, num_blocks)).to(device)
        return sparse.block_ell_from_coo(a, num_blocks, device=device)
    t = torch.as_tensor(a).to(device=device, dtype=torch.float32)
    rem = (-t.shape[1]) % num_blocks
    return torch.nn.functional.pad(t, (0, rem)) if rem else t


def _device_count(device: torch.device) -> int:
    """Block slots a distributed solve could use from here: the stream
    pool's (``stream.state.stream_device_count()``: a set pool, the ranks
    of a process group, else the visible GPUs), and 1 for a solve on the
    CPU with neither a pool nor a process group."""
    from repro_torch.stream import state as stream_state

    if device.type == "cuda" or stream_state.explicit_pool():
        return stream_state.stream_device_count()
    return 1


def _device_env(mesh, block_axes, device) -> Tuple[int, bool]:
    if mesh is None:
        return _device_count(device), False
    return mesh.axis_size(block_axes), True


def _resolve_num_blocks(a: MatrixInput, config: "SolveConfig",
                        device: torch.device, mesh=None, block_axes=None
                        ) -> Tuple[int, Optional[str]]:
    """Resolution order: explicit config > BlockEll's D > mesh block
    axes > device count (>1) > DEFAULT_NUM_BLOCKS.  Returns (D, note)."""
    if config.num_blocks is not None:
        return config.num_blocks, None
    if isinstance(a, sparse.BlockEll):
        return a.num_blocks, None
    if mesh is not None:
        d = mesh.axis_size(block_axes)
        return d, f"num_blocks={d} derived from the mesh block axes"
    dev = _device_count(device)
    if dev > 1:
        return dev, f"num_blocks={dev} defaulted to the device count"
    return planner.DEFAULT_NUM_BLOCKS, (
        f"num_blocks defaulted to {planner.DEFAULT_NUM_BLOCKS}")


# ---------------------------------------------------------------------------
# Engine runner (shared by svd() and the legacy shim: one code path)
# ---------------------------------------------------------------------------

def _use_kernel(config: SolveConfig, a) -> bool:
    """``config.use_kernel`` resolved for the operand ``a`` (a tensor or a
    BlockEll) on its device (``svd.resolve_use_kernel``)."""
    return lsvd.resolve_use_kernel(config.use_kernel, a.device,
                                   local_mode=config.local_mode)


def _run_single(a, config: SolveConfig, *, draws=None, omega=None):
    return ranky.solve_single(
        a, num_blocks=config.num_blocks, method=config.method,
        local_mode=config.local_mode, merge_mode=config.merge_mode,
        undetermined_tail=config.undetermined_tail, rank=config.rank,
        oversample=config.oversample, power_iters=config.power_iters,
        want_right=config.want_right, use_kernel=_use_kernel(config, a),
        key=config.resolved_key(), draws=draws, omega=omega)


def _run_shard_map(a, mesh, config: SolveConfig, *, block_axes=None,
                   draws=None, omega=None):
    from repro_torch.core import distributed

    if block_axes is None:
        block_axes = mesh.axis_names
    return distributed.solve_shard_map(a, mesh, block_axes=tuple(block_axes),
                                       config=config, draws=draws,
                                       omega=omega)


def _run_hierarchical(a, config: SolveConfig, *, sketch_override=...,
                      draws=None, omega=None):
    from repro_torch.core import hierarchy

    sketch = config.sketch if sketch_override is ... else sketch_override
    return hierarchy.solve_hierarchical(
        a, num_blocks=config.num_blocks, fanout=config.fanout,
        rank=config.rank, method=config.method, sketch=sketch,
        oversample=config.oversample, power_iters=config.power_iters,
        want_right=config.want_right, use_kernel=_use_kernel(config, a),
        key=config.resolved_key(), draws=draws, omega=omega)


# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------

def _repaired_rows(a_norm, num_blocks: int, method: str, key: Key,
                   lonely_total: int, m: int, draws=None) -> Optional[int]:
    if method == "none":
        return 0
    if method in ("random", "neighbor_random"):
        # These repair EVERY lonely row (random fallback), exactly once.
        return lonely_total
    if m > _REPAIR_DIAG_MAX_M:
        return None  # neighbor count needs the O(M^2) adjacency
    repaired = ranky.split_and_repair(a_norm, num_blocks, method, key,
                                      draws=draws)
    if isinstance(repaired, sparse.RepairedSparseBlocks):
        return int(repaired.repair_mask.sum())
    after = sum(ranky.lonely_rows_per_block(
        repaired.permute(1, 0, 2).reshape(m, -1), num_blocks))
    return lonely_total - after


# ---------------------------------------------------------------------------
# The front door
# ---------------------------------------------------------------------------

def plan(a: Union[MatrixInput, ASpec], config: Optional[SolveConfig] = None,
         *, mesh=None, block_axes=None, device=None, **overrides) -> Plan:
    """What would :func:`svd` do for this input, and why.

    ``a`` may be an actual matrix (any accepted representation) or an
    :class:`~repro_torch.core.planner.ASpec`, so capacity planning needs
    no data, only shapes.
    """
    config = _reject_stream_knobs(_coerce_config(config, overrides), "plan")
    device = mesh.device if mesh is not None else resolve_device(device)
    if isinstance(a, ASpec):
        spec = (a if config.num_blocks in (None, a.num_blocks)
                else dataclasses.replace(a, num_blocks=config.num_blocks))
        note = None
    else:
        d, note = _resolve_num_blocks(a, config, device, mesh, block_axes)
        spec = describe(a, d)
    device_count, mesh_provided = _device_env(mesh, block_axes, device)
    p = planner.make_plan(spec, config, device_count=device_count,
                          mesh_provided=mesh_provided)
    if note:
        p = dataclasses.replace(p, reasons=p.reasons + (note,))
    return p


def _coerce_config(config: Optional[SolveConfig],
                   overrides: Dict[str, Any]) -> SolveConfig:
    if config is None:
        return SolveConfig(**overrides)
    if not isinstance(config, SolveConfig):
        raise TypeError(f"config must be a SolveConfig, got {type(config)}")
    return dataclasses.replace(config, **overrides) if overrides else config


def _reject_stream_knobs(config: SolveConfig, fn: str) -> SolveConfig:
    """One-shot entry points never consult the streaming knobs: raising
    beats silently returning an untruncated result."""
    # stream_backend needs no check of its own: __post_init__ couples a
    # non-"auto" stream_backend to truncate_rank, which is caught here.
    if config.truncate_rank is not None:
        raise ValueError(
            f"truncate_rank={config.truncate_rank} is a streaming knob "
            f"(svd_update / svd_stream) and {fn}() never truncates a "
            f"state; for a one-shot truncated solve set rank=k instead")
    return config


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _observe(config: Optional[SolveConfig]) -> None:
    """``config.observe=True`` stickily enables the full obs layer."""
    if config is not None and config.observe and not obs.enabled():
        obs.enable()


class _CallTimer:
    """Wall/compile/run split + obs digests for one front-door call, the
    device synchronized at both ends.

    The call's config turns obs on first (:func:`_observe`).  The
    compile side is the obs clock's compile seconds (the kernels' build)
    that appeared during the call, clamped so that ``run_time_s`` can
    never go negative.  The span digest covers the spans appended since
    the call began; they are read after the closing synchronize, so
    resolving their CUDA events waits for nothing.
    """

    def __init__(self, config: Optional[SolveConfig], device: torch.device):
        _observe(config)
        self._device = device
        _sync(device)
        self._mark = obs.trace.mark()
        self._t0 = clock.now()
        self._c0 = clock.compile_seconds()

    def finish(self) -> Dict[str, Any]:
        """The Diagnostics timing/obs kwargs for this call."""
        _sync(self._device)
        wall = clock.now() - self._t0
        comp = min(wall, max(0.0, clock.compile_seconds() - self._c0))
        out: Dict[str, Any] = dict(wall_time_s=wall, compile_time_s=comp,
                                   run_time_s=wall - comp)
        if obs.enabled():
            out["drift_ratios"] = obs.drift_ratios()
            out["span_summary"] = obs.span_summary(
                obs.trace.events_since(self._mark))
        return out


def svd(a: MatrixInput, config: Optional[SolveConfig] = None, *,
        mesh=None, block_axes=None, device=None,
        draws: Optional[RepairDraws] = None,
        omega: Optional[torch.Tensor] = None, **overrides) -> SVDResult:
    """Distributed Ranky SVD of ``a``: the one public entry point.

    Args:
      a: dense (M, N) ndarray or tensor, ``sparse.COOMatrix`` or
        ``sparse.BlockEll``.  Dense/COO inputs are normalized (padded /
        converted) by :func:`as_block_input`; BlockEll is consumed
        sparse-natively.
      config: a :class:`SolveConfig`; keyword ``overrides`` are applied
        on top (``svd(a, rank=16)`` works without building one).
      mesh / block_axes: only for the shard_map backend: the block mesh
        (``core.collectives.LocalMesh`` / ``ProcessGroupMesh``) and which
        of its axes the column blocks split over (default: all of them; a
        subset, in mesh order, leaves the other axes holding copies of the
        same blocks).  Passing a mesh makes ``backend="auto"`` prefer
        shard_map, and the solve runs on ``mesh.device``.  Without one a
        shard_map plan runs on the stream pool's mesh.
      device: where the solve runs.  ``None`` is the current CUDA device
        (an error when there is none); ``"cpu"`` runs on the host.
      draws / omega: inject the random inputs of the repair and of the
        sketch (see ``ranky.RepairDraws``, ``randomized.draw_omega``);
        by default they are drawn from ``config.key``.

    Returns an :class:`SVDResult`: U (M, r), S (r,), V (N, r) when
    ``want_right`` (rows in original column order; on a rank of a process
    group, the rows of this rank's column block), the explainable
    :class:`~repro_torch.core.planner.Plan`, and :class:`Diagnostics`.
    """
    config = _reject_stream_knobs(_coerce_config(config, overrides), "svd")
    if mesh is not None and config.backend not in ("shard_map", "auto"):
        raise ValueError(
            f"mesh= was provided but config.backend={config.backend!r}; a "
            f"mesh only applies to backend='shard_map' (or 'auto')")
    device = mesh.device if mesh is not None else resolve_device(device)
    _observe(config)
    # The call's root span, from the clock's first sync to the end of the
    # diagnostics: every span of the call carries its id.
    with obs.span("svd.call"):
        return _svd(a, config, mesh, block_axes, device, draws, omega)


def _svd(a, config: SolveConfig, mesh, block_axes, device, draws, omega):
    """The body of :func:`svd`, inside the call's root span."""
    timer = _CallTimer(config, device)
    with obs.span("describe_and_plan"):
        d, note = _resolve_num_blocks(a, config, device, mesh, block_axes)
        spec = describe(a, d)
        if config.rank is not None and config.rank > spec.m:
            raise ValueError(
                f"rank={config.rank} must be in [1, M={spec.m}]")
        device_count, mesh_provided = _device_env(mesh, block_axes, device)
        p = planner.make_plan(spec, config, device_count=device_count,
                              mesh_provided=mesh_provided)
    if note:
        p = dataclasses.replace(p, reasons=p.reasons + (note,))
    if p.backend == "shard_map" and mesh is None:
        from repro_torch.stream import state as stream_state

        if device_count != d:
            raise ValueError(
                f"backend='shard_map' with no mesh= needs one device per "
                f"block: num_blocks={d} but device_count={device_count}")
        mesh = stream_state.stream_mesh(d)
        block_axes = (stream_state.STREAM_AXIS,)
        device = mesh.device
    if p.backend == "shard_map":
        # One slot a distinct block: slots along axes outside block_axes
        # hold the same block and the solve runs once for them.
        mesh = mesh.block_mesh(block_axes)
        block_axes = mesh.axis_names

    # local_mode is only consumed by the exact proxy merge; under the
    # gram merge (or the randomized path) a local_mode='svd' config
    # still runs sparse-natively.
    needs_dense = (config.local_mode == "svd"
                   and p.strategy == "exact_proxy")
    if isinstance(a, sparse.BlockEll) and needs_dense:
        raise ValueError(
            "local_mode='svd' with the proxy merge needs the dense path "
            "but the input is a sparse.BlockEll (the sparse path is "
            "gram-native); pass a dense array or COOMatrix, or use "
            "local_mode='gram'")
    with obs.span("as_block_input"):
        a_norm = as_block_input(a, d, needs_dense=needs_dense, device=device)
    # Materialize the plan's decisions into the config the engine runs
    # with: p.rank is None when the plan is "solve exactly, truncate
    # after" (truncate_to).
    run_cfg = dataclasses.replace(config, num_blocks=d, backend=p.backend,
                                  rank=p.rank)

    with obs.span("svd.solve", backend=p.backend, strategy=p.strategy,
                  m=spec.m, n=spec.n):
        if p.backend == "hierarchical":
            out = _run_hierarchical(a_norm, run_cfg,
                                    sketch_override=p.sketch_leaves,
                                    draws=draws, omega=omega)
        elif p.backend == "shard_map":
            out = _run_shard_map(a_norm, mesh, run_cfg,
                                 block_axes=block_axes, draws=draws,
                                 omega=omega)
        else:
            out = _run_single(a_norm, run_cfg, draws=draws, omega=omega)

    u, s = out[0], out[1]
    v = out[2] if config.want_right else None
    if p.truncate_to is not None:
        k = p.truncate_to
        u, s = u[:, :k], s[:k]
        v = v[:, :k] if v is not None else None
    if v is not None and p.backend == "shard_map" and mesh.n_local < d:
        # A rank holds its block's rows: trim those past the last column.
        first = mesh.local_slots[0] * (v.shape[0] // mesh.n_local)
        v = v[:max(0, min(v.shape[0], spec.n - first))]
    elif v is not None:
        v = v[:spec.n]  # trim the adapter's zero-column padding back off
    timing = timer.finish()

    with obs.span("diagnostics"):       # after the clock: not in wall_time_s
        lonely = ranky.lonely_rows_per_block(a_norm, d)
        lonely_total = sum(lonely)
        repaired = _repaired_rows(a_norm, d, config.method,
                                  config.resolved_key(), lonely_total,
                                  spec.m, draws)
    diag = Diagnostics(
        lonely_rows_per_block=lonely,
        lonely_rows=lonely_total,
        repaired_rows=repaired,
        strategy=p.strategy,
        estimated_peak_bytes=p.estimated_peak_bytes,
        **timing,
    )
    return SVDResult(u=u, s=s, v=v, plan=p, diagnostics=diag)


# ---------------------------------------------------------------------------
# The streaming front door: svd_init / plan_update / svd_update
# ---------------------------------------------------------------------------

def _require_stream_config(config: SolveConfig) -> SolveConfig:
    if config.truncate_rank is None:
        raise ValueError(
            "streaming needs SolveConfig.truncate_rank=k — the rank the "
            "merge-and-truncate state is re-truncated to after every "
            "ingest (svd_update has no exact fallback; an untruncated "
            "stream would grow without bound)")
    if config.backend not in ("auto", "single"):
        raise ValueError(
            f"invalid streaming config: backend={config.backend!r} — "
            f"backend= picks the ONE-SHOT engine; streaming picks its "
            f"engine with stream_backend= ('single', 'shard_map' or "
            f"'auto'), so leave backend at 'auto'/'single'")
    if config.sketch:
        raise ValueError(
            "invalid streaming config: sketch=True belongs to the "
            "hierarchical tree merge; to force the randomized BATCH "
            "factorization set rank=r instead")
    if config.local_mode != "gram" or config.merge_mode != "gram":
        raise ValueError(
            f"invalid streaming config: local_mode="
            f"{config.local_mode!r} / merge_mode={config.merge_mode!r} "
            f"— the streaming batch factorization is gram-native and "
            f"its merge is the fixed panel SVD; neither knob applies "
            f"(and the plan would misreport what ran)")
    return config


def _delta_nnz_estimate(delta) -> int:
    """Cheap nnz for the R5 plan's ASpec.  No R5 byte estimate or
    decision consults nnz (it is informational, ``Plan.explain``), so the
    ingest hot path must not scan or device-to-host-copy the batch for
    it: exact O(1) for COO; exact O(1) for a BlockEll that recorded its
    true nnz at construction (``block_ell_from_coo`` always does);
    stored-slot capacity (an upper bound, no transfer) for one that did
    not; m*n for dense."""
    if isinstance(delta, sparse.COOMatrix):
        return delta.nnz
    if isinstance(delta, sparse.BlockEll):
        if delta.nnz is not None:
            return delta.nnz
        return int(np.prod(delta.col_vals.shape))
    shape = tuple(delta.shape) if isinstance(delta, torch.Tensor) \
        else np.shape(delta)
    return int(shape[0]) * int(shape[1])  # shape metadata, data untouched


def _batch_universe(delta) -> Tuple[int, Optional[int]]:
    """(n, num_blocks-or-None) a fresh stream should adopt from its
    first delta."""
    from repro_torch import stream as streaming

    _, n = streaming.delta_shape(delta)
    d = delta.num_blocks if isinstance(delta, sparse.BlockEll) else None
    return n, d


def svd_init(n: int, config: Optional[SolveConfig] = None, *,
             device=None, **overrides):
    """A fresh rank-0 streaming state over an ``n``-column universe, on
    ``device`` (``None``: the GPU).

    ``num_blocks`` resolves like everywhere else: explicit config wins,
    else the planner default.  The state's seed chain root is
    ``config.key`` (``ranky.DEFAULT_SEED`` when unset), so an unkeyed
    stream is reproducible like every other entry point.
    """
    from repro_torch import stream as streaming

    config = _require_stream_config(_coerce_config(config, overrides))
    d = config.num_blocks or planner.DEFAULT_NUM_BLOCKS
    return streaming.init_state(n, num_blocks=d, seed=config.resolved_key(),
                                device=device)


def plan_update(batch: Union[MatrixInput, ASpec],
                config: Optional[SolveConfig] = None, *,
                state=None, device=None, **overrides) -> Plan:
    """What would :func:`svd_update` do for this batch, and why (rules
    R5/R5d).  ``batch`` may be an :class:`~repro_torch.core.planner.ASpec`
    (so "can I fold a 1M-row day of data into this model on one device"
    is answerable with no data, only shapes) or an actual delta, in which
    case ``state`` supplies the column universe.  The device count of
    ``device`` (the state's device when a state is given; ``None``: the
    GPU) feeds rule R5d's backend choice."""
    from repro_torch import stream as streaming

    config = _require_stream_config(_coerce_config(config, overrides))
    if state is not None and device is None:
        device = state.device
    dev_count = _device_count(resolve_device(device))
    if isinstance(batch, ASpec):
        return planner.make_stream_plan(batch, config,
                                        device_count=dev_count)
    if state is None:
        raise ValueError(
            "plan_update needs state= (for the column universe) when "
            "batch is an actual delta; pass an ASpec to plan from "
            "shapes alone")
    m_b, _ = streaming.delta_shape(batch)
    spec = ASpec(m=m_b, n=state.n, nnz=_delta_nnz_estimate(batch),
                 num_blocks=state.num_blocks, kind="stream")
    p = planner.make_stream_plan(spec, config, device_count=dev_count)
    # R5's closed form covers the merge working set; with a real state
    # in hand the (linear-in-rows-seen) left-factor update is concrete,
    # so say it out loud.
    u_bytes = planner.BYTES_F32 * 2 * (state.rows_seen + m_b) \
        * config.truncate_rank
    return dataclasses.replace(p, reasons=p.reasons + (
        f"state has rows_seen={state.rows_seen}: updating its left "
        f"factor u touches a further ~{u_bytes:,}B (linear in rows "
        f"seen; excluded from the R5 peak)",))


def _state_to(state, device: torch.device):
    if state.device == device:
        return state
    return dataclasses.replace(state, u=state.u.to(device),
                               s=state.s.to(device), v=state.v.to(device))


def svd_update(state, delta, config: Optional[SolveConfig] = None, *,
               device=None, draws: Optional[RepairDraws] = None,
               omega: Optional[torch.Tensor] = None,
               **overrides) -> SVDResult:
    """Fold a batch of new rows into an existing streaming state: the
    incremental front door (``repro_torch.stream`` underneath).

    Args:
      state: a :class:`~repro_torch.stream.state.StreamingSVDState` from
        :func:`svd_init` or a previous result's ``.state``.
      delta: the new rows, in the state's column universe: dense
        (m_b, n) rows, a ``sparse.COOMatrix``, or a pre-split
        ``sparse.BlockEll`` (sparse deltas run sparse-natively).
      config: a :class:`SolveConfig` with ``truncate_rank=k`` set;
        ``history_decay`` < 1 forgets old rows exponentially;
        ``rank=r`` forces the randomized batch factorization.
      device: where the ingest runs; ``None`` is the state's own device
        (a state on another device is moved there first).
      draws / omega: inject this batch's random inputs (repair draws,
        the sketch's (L, m_b) test matrix); by default batch ``b`` draws
        from ``ranky.derive_seed(state.seed, b)``.

    Returns an :class:`SVDResult` whose factors cover EVERY row
    ingested so far (``u`` in ingestion order, ``v`` trimmed to the
    original columns when ``want_right``), with the R5 plan, per-batch
    diagnostics, and the updated ``state`` for the next call.
    """
    from repro_torch import stream as streaming

    config = _require_stream_config(_coerce_config(config, overrides))
    if not isinstance(state, streaming.StreamingSVDState):
        raise TypeError(
            f"svd_update needs a StreamingSVDState (from svd_init or a "
            f"previous result's .state); got {type(state)}")
    if (config.num_blocks is not None
            and config.num_blocks != state.num_blocks):
        raise ValueError(
            f"config.num_blocks={config.num_blocks} but the state's "
            f"column universe has num_blocks={state.num_blocks}; the "
            f"universe is fixed at svd_init time")
    device = state.device if device is None else resolve_device(device)
    state = _state_to(state, device)

    timer = _CallTimer(config, device)
    with obs.span("describe_and_plan"):
        p = plan_update(delta, config, state=state)
    new_state, info = streaming.ingest(state, delta, config, p,
                                       draws=draws, omega=omega)
    timing = timer.finish()

    diag = Diagnostics(
        lonely_rows_per_block=info.lonely_rows_per_block,
        lonely_rows=info.lonely_rows,
        repaired_rows=info.repaired_rows,
        strategy=p.strategy,
        estimated_peak_bytes=p.estimated_peak_bytes,
        **timing,
    )
    v = new_state.trimmed_v() if config.want_right else None
    return SVDResult(u=new_state.u, s=new_state.s, v=v, plan=p,
                     diagnostics=diag, state=new_state)


def _by_batch(src, b0: int):
    """Injected per-batch inputs as a callable of the global batch index:
    a sequence is indexed by the batch's place in this call's stream (its
    first batch has global index ``b0``), a callable is kept."""
    if src is None or callable(src):
        return src
    return lambda b: src[b - b0]


def svd_stream(batches, config: Optional[SolveConfig] = None, *,
               state=None, device=None, draws=None, omegas=None,
               **overrides) -> SVDResult:
    """Ingest a whole sequence of deltas and return the final result.

    ``batches`` may be any iterable (a list, a generator, a socket
    reader) and is consumed window by window, never materialized.  Two
    regimes, switched per batch:

    * while the state's rank is still growing toward ``truncate_rank``,
      each batch runs through the per-batch engine (the window's carry is
      fixed-shape, so the transient can't ride in it);
    * at steady rank, consecutive batches with the same
      ``stream.window.bucket_signature`` are grouped into windows of up
      to ``plan.window`` batches (planner rule R6; ``config.window``
      overrides, 1 = per-batch loop) and each window runs with the state
      on the device throughout and one host read at its end
      (``stream.window.ingest_window``).  ``config.adaptive_width``
      re-picks the exact merge width from the state's spectral tail at
      every window boundary.

    ``state`` resumes an existing stream; ``device`` is where a fresh one
    lives (``None``: the GPU; a given state's own device).  ``draws`` /
    ``omegas`` inject each batch's random inputs (``RepairDraws``, the
    sketch's Omega): a sequence indexed by the batch's place in this
    call's stream, or a callable of its global batch index.  A batch
    folded in a window takes them at its bucket's padded shape (see
    ``ingest_window``).

    Returns the final :class:`SVDResult` with CUMULATIVE diagnostics
    (lonely/repaired counts summed over THIS call's batches, a resumed
    stream's pre-existing history not re-counted, plus total wall time;
    ``lonely_rows_per_block`` stays the last batch's) and the last
    window's R6 plan (or the last per-batch R5 plan if the whole stream
    stayed in the rank-growth regime).
    """
    from repro_torch import stream as streaming
    from repro_torch.stream import window as swindow

    config = _require_stream_config(_coerce_config(config, overrides))
    it = iter(batches)
    try:
        first = next(it)
    except StopIteration:
        raise ValueError("svd_stream needs at least one batch")
    if state is None:
        n, d = _batch_universe(first)
        cfg0 = config if (d is None or config.num_blocks is not None) \
            else dataclasses.replace(config, num_blocks=d)
        state = svd_init(n, cfg0, device=device)
    else:
        state = _state_to(state, state.device if device is None
                          else resolve_device(device))
    if (config.num_blocks is not None
            and config.num_blocks != state.num_blocks):
        raise ValueError(
            f"config.num_blocks={config.num_blocks} but the state's "
            f"column universe has num_blocks={state.num_blocks}; the "
            f"universe is fixed at svd_init time")
    device = state.device
    dev_count = _device_count(device)
    timer = _CallTimer(config, device)
    base_lonely = state.lonely_rows_seen
    base_repaired = state.repaired_rows_seen
    draws = _by_batch(draws, state.batches_seen)
    omegas = _by_batch(omegas, state.batches_seen)
    k = config.truncate_rank

    last_plan = None
    last_pb: Tuple[int, ...] = ()
    pending: list = []          # host-normalized same-bucket deltas
    pending_sig = None
    pending_cfg = config        # the window's config (adaptive l_b)
    pending_plan = None

    def flush():
        nonlocal state, last_plan, last_pb, pending, pending_sig
        if not pending:
            return
        state, info = swindow.ingest_window(state, pending, pending_cfg,
                                            pending_plan, draws=draws,
                                            omegas=omegas)
        last_plan, last_pb = pending_plan, info.lonely_rows_per_block
        pending, pending_sig = [], None

    def pick(src, b):
        return None if src is None else src(b)

    for delta in itertools.chain([first], it):
        if state.rank != k:
            # Rank-growth prologue: the per-batch ingest until the carry
            # shape is steady (nothing is pending here: the rank only
            # grows, never shrinks back below k).
            p = plan_update(delta, config, state=state)
            b = state.batches_seen
            state, info = streaming.ingest(state, delta, config, p,
                                           draws=pick(draws, b),
                                           omega=pick(omegas, b))
            last_plan, last_pb = p, info.lonely_rows_per_block
            continue
        norm = streaming.as_delta(delta, state, device="cpu")
        sig = swindow.bucket_signature(norm)
        if pending and sig != pending_sig:
            flush()
        if not pending:
            pending_sig = sig
            pending_cfg = config
            if config.adaptive_width:
                eff = swindow.adaptive_oversample(state.s, k,
                                                  config.oversample)
                if eff != config.oversample:
                    pending_cfg = dataclasses.replace(config,
                                                      oversample=eff)
            spec = ASpec(m=sig[1], n=state.n,
                         nnz=_delta_nnz_estimate(norm),
                         num_blocks=state.num_blocks, kind="stream")
            pending_plan = planner.make_window_plan(
                spec, pending_cfg, device_count=dev_count,
                nnz_slots=swindow.bucket_nnz_slots(sig, state.num_blocks))
        pending.append(norm)
        if len(pending) >= pending_plan.window:
            flush()
    flush()
    timing = timer.finish()

    diag = Diagnostics(
        lonely_rows_per_block=last_pb,
        lonely_rows=state.lonely_rows_seen - base_lonely,
        repaired_rows=state.repaired_rows_seen - base_repaired,
        strategy=last_plan.strategy,
        estimated_peak_bytes=last_plan.estimated_peak_bytes,
        **timing)
    v = state.trimmed_v() if config.want_right else None
    return SVDResult(u=state.u, s=state.s, v=v, plan=last_plan,
                     diagnostics=diag, state=state)


# ---------------------------------------------------------------------------
# Serving front door: serve_init / serve_topk (planner rule R7)
# ---------------------------------------------------------------------------

SERVE_BACKENDS = ("single", "shard_map", "auto")


@dataclasses.dataclass(frozen=True)
class ServeTopKConfig:
    """Every knob of the top-k serving path, validated on construction
    (the ``SolveConfig`` contract: invalid configs cannot be built).

    * ``batch_size`` — the request-wave width B the plan prices; waves
      up to this many query rows are accepted per ``serve_topk`` call.
    * ``k_top`` — items returned per query.
    * ``block_n`` — score-tile width of the fused kernel (multiple of
      128); the per-wave working set is one (B, block_n) tile,
      independent of N.  On the GPU each thread block of the kernel
      scans a run of whole tiles.
    * ``quantize`` — serve int8 factors + per-item scales (kvquant
      axis=-1) instead of f32 ``v`` (~4x smaller residency; the scale
      folds into the score contraction, nothing is dequantized).
    * ``keep_u`` — carry the state's ``u`` rows in the snapshot for
      known-user lookups (``ranker.user_queries``); costs
      4 * rows_seen * k resident bytes.
    * ``use_kernel`` — fused score+top-k kernel vs the plain version
      that materializes the (B, N) score matrix (planner rule R7 prices
      both; results are bit-identical either way).
    * ``serve_backend`` — ``"single"``, ``"shard_map"`` (one column
      block per slot of the stream pool; degrades honestly to single
      when the slot count does not match) or ``"auto"``.
    * ``num_blocks`` — column-block count; ``None`` takes the state's.
    * ``memory_budget_bytes`` — R7 budget (default 4 GiB).
    """

    batch_size: int = 32
    k_top: int = 10
    block_n: int = 512
    quantize: bool = False
    keep_u: bool = False
    use_kernel: bool = True
    serve_backend: str = "auto"
    num_blocks: Optional[int] = None
    memory_budget_bytes: Optional[int] = None

    def __post_init__(self):
        # --- single-field domains -----------------------------------
        if self.batch_size < 1:
            raise ValueError(
                f"invalid ServeTopKConfig: batch_size={self.batch_size} "
                f"must be >= 1")
        if self.k_top < 1:
            raise ValueError(
                f"invalid ServeTopKConfig: k_top={self.k_top} must be >= 1")
        if self.block_n < 128 or self.block_n % 128:
            # (the reference's wording, kept so that both packages raise
            # the same message)
            raise ValueError(
                f"invalid ServeTopKConfig: block_n={self.block_n} must be "
                f"a positive multiple of 128 (the TPU lane width)")
        if self.serve_backend not in SERVE_BACKENDS:
            raise ValueError(
                f"invalid ServeTopKConfig: serve_backend="
                f"{self.serve_backend!r} must be one of {SERVE_BACKENDS}")
        if self.num_blocks is not None and self.num_blocks < 1:
            raise ValueError(
                f"invalid ServeTopKConfig: num_blocks={self.num_blocks} "
                f"must be >= 1")
        if (self.memory_budget_bytes is not None
                and self.memory_budget_bytes < 1):
            raise ValueError(
                f"invalid ServeTopKConfig: memory_budget_bytes="
                f"{self.memory_budget_bytes} must be >= 1")

        # --- cross-field constraints (each names both fields) -------
        if self.use_kernel and self.k_top > self.block_n:
            raise _bad("k_top", self.k_top, "block_n", self.block_n,
                       "the fused kernel's running top-k must fit one "
                       "score tile (its merge buffer is tile-bounded); "
                       "raise block_n or set use_kernel=False",
                       kind="ServeTopKConfig")


@dataclasses.dataclass(frozen=True)
class ServeHandle:
    """One live serving endpoint: the double-buffered snapshot cell plus
    the R7 plan and config that built it.  ``commit`` folds a freshly
    ingested state in (stage + atomic publish); reads via ``serve_topk``
    always see exactly one consistent snapshot.  The plan and config are
    fixed for the handle's life (``serve_init`` a new one to change
    them)."""

    buffer: Any          # serve.snapshot.SnapshotBuffer
    plan: Plan
    config: ServeTopKConfig

    def __post_init__(self):
        # The ranker call with this handle's fixed arguments: with obs
        # off, a wave is this one call (the obs-off gate times it against
        # the direct ranker call).
        object.__setattr__(self, "_score", functools.partial(
            ranker_mod.score_topk, block_n=self.config.block_n,
            sharded=self.plan.backend == "shard_map",
            use_kernel=self.config.use_kernel,
            max_batch=self.config.batch_size))

    def read(self):
        return self.buffer.read()

    @property
    def version(self) -> int:
        return self.buffer.version

    def commit(self, state):
        """Publish a new state to readers (between request waves), in the
        layout the plan's ranker reads (sharded over the stream mesh for
        ``shard_map``)."""
        from repro_torch.stream import state as stream_state

        if state.n != self.buffer.read().n:
            raise ValueError(
                f"state.n={state.n} does not match the serving "
                f"universe n={self.buffer.read().n}; serve_init a new "
                f"handle to change universes")
        if self.plan.backend == "shard_map":
            state = stream_state.shard_state(state, state.mesh)
        elif state.sharded_rows:
            state = stream_state.gather_state(state)
        return self.buffer.commit(state)

    def metrics(self) -> Dict[str, Any]:
        """Live endpoint health, always available (obs on or off):
        snapshot version + staleness from the buffer itself, plus — when
        observability is on — the serve-side counters, latency quantiles
        and R7 drift ratio from the obs registry.  The latencies are the
        waves' device times; reading them resolves the waves still in
        flight (a wait for the device, off the serving path)."""
        out: Dict[str, Any] = {
            "snapshot_version": self.buffer.version,
            "snapshot_age_s": self.buffer.age_seconds(),
            "planned_peak_bytes": self.plan.estimated_peak_bytes,
        }
        if obs.enabled():
            obs.trace.resolve()
            reg = obs.registry()
            out["serve_requests_total"] = reg.counter_value(
                "serve_requests_total")
            out["serve_queries_total"] = reg.counter_value(
                "serve_queries_total")
            out["serve_latency_us_p50"] = reg.histogram_quantile(
                "serve_latency_us", 0.5)
            out["serve_latency_us_p99"] = reg.histogram_quantile(
                "serve_latency_us", 0.99)
            out["drift_ratios"] = {
                k: v for k, v in obs.drift_ratios().items()
                if k.startswith("R7")}
        return out


def _coerce_serve_config(config: Optional[ServeTopKConfig],
                         overrides: Dict[str, Any]) -> ServeTopKConfig:
    if config is None:
        return ServeTopKConfig(**overrides)
    if overrides:
        return dataclasses.replace(config, **overrides)
    return config


def serve_init(state, config: Optional[ServeTopKConfig] = None,
               **overrides) -> ServeHandle:
    """Open a serving endpoint over a streamed state (planner rule R7).

    Builds the initial :class:`~repro_torch.serve.snapshot.ServingSnapshot`
    (quantized to int8 when configured) on the state's device and returns
    a :class:`ServeHandle` whose ``commit(new_state)`` publishes ingests
    to readers without ever exposing a torn state.  The R7 plan
    (closed-form serving bytes, fused vs fallback, backend) rides the
    handle; ``handle.plan.explain()`` narrates it.
    """
    from repro_torch.serve import snapshot as snapshot_mod

    config = _coerce_serve_config(config, overrides)
    if config.num_blocks is not None and config.num_blocks != state.num_blocks:
        raise _bad("num_blocks", config.num_blocks,
                   "state.num_blocks", state.num_blocks,
                   "the serving plan must price the state's own column "
                   "blocking; drop num_blocks= to take the state's",
                   kind="ServeTopKConfig")
    resolved = (config if config.num_blocks is not None
                else dataclasses.replace(config,
                                         num_blocks=state.num_blocks))
    from repro_torch.stream import state as stream_state

    plan = planner.make_serve_plan(
        state.n, state.rank, resolved,
        device_count=_device_count(state.device))
    if plan.backend == "shard_map":
        state = stream_state.shard_state(state, state.mesh)
    elif state.sharded_rows:
        state = stream_state.gather_state(state)
    snap = snapshot_mod.ServingSnapshot.from_state(
        state, quantize=resolved.quantize, keep_u=resolved.keep_u)
    return ServeHandle(buffer=snapshot_mod.SnapshotBuffer(snap),
                       plan=plan, config=resolved)


def serve_topk(handle: ServeHandle, queries,
               k_top: Optional[int] = None):
    """Answer one request wave against the handle's CURRENT snapshot.

    ``queries`` are factor-space rows (B, k), B up to the configured
    ``batch_size`` (the wave width the R7 plan priced); raw interaction
    rows project through ``ranker.project_rows`` first.  Returns a
    :class:`~repro_torch.serve.ranker.TopKResult`: scores descending,
    ties to the lowest item id, stamped with the snapshot version.
    """
    k_top = handle.config.k_top if k_top is None else k_top
    if not _OBS_GATE["enabled"]:
        # obs.enabled() read in place, then one ranker call, which checks
        # the wave (the planned batch_size too): with obs off a wave runs
        # no more Python than the direct ranker call (chip_smoke.py holds
        # its p99 within 1 % of that call's).
        return handle._score(handle.buffer.read(), queries, k_top)
    snap = handle.read()
    queries = torch.as_tensor(queries)
    ranker_mod.check_wave(queries, snap.rank, handle.config.batch_size)
    with obs.span("serve.topk", batch=int(queries.shape[0]),
                  version=snap.version) as sp:
        # The wave's latency is its device time: folded into the
        # histogram when the span's events resolve, never waited for here.
        sp.then(_observe_latency)
        res = handle._score(snap, queries, k_top,
                            plan_bytes=handle.plan.estimated_peak_bytes)
    obs.counter_add("serve_requests_total")
    obs.counter_add("serve_queries_total", float(queries.shape[0]))
    obs.gauge_set("snapshot_version", snap.version)
    obs.gauge_set("snapshot_age_seconds", handle.buffer.age_seconds())
    return res


def _observe_latency(dur_us: float) -> None:
    obs.registry().histogram_observe("serve_latency_us", dur_us)
