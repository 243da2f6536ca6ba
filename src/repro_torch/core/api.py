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
  single-host engine, and wraps the result in :class:`SVDResult` with the
  plan and diagnostics (lonely/repaired row counts, estimated peak bytes,
  wall time).
* :func:`plan`: the planner alone: what WOULD ``svd`` do for a matrix
  of this shape, and why.

Device: the entry points run on the GPU.  ``device=None`` resolves to the
current CUDA device and RAISES when there is none; pass ``device="cpu"``
to run on the host (the tests do).  A ``BlockEll`` or tensor input that
already lies on a device is moved to the resolved one.

Only ``backend="single"`` runs in this package so far: a plan whose
backend is ``hierarchical`` or ``shard_map`` raises
``NotImplementedError`` (never a silent single-host solve in its place).
The streaming and serving entry points arrive with their slices.

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
import time
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import planner, ranky, sparse
from repro_torch.core.planner import ASpec, Plan, PlanError  # noqa: F401  (re-export)
from repro_torch.core.ranky import Key, RepairDraws  # noqa: F401  (re-export)
from repro_torch.core.stages import stage
from repro_torch.kernels import build as kernel_build

BACKENDS = ("single", "hierarchical", "shard_map", "auto")
STREAM_BACKENDS = ("single", "shard_map", "auto")
LOCAL_MODES = ("gram", "svd")
MERGE_MODES = ("proxy", "gram")

# Above this M the repaired-row diagnostic for method="neighbor" is
# skipped (it needs the O(M^2) row adjacency); the count is exact and
# O(M) for the other methods at any scale.
_REPAIR_DIAG_MAX_M = 4096

# Where the backends that are not ported yet stand in ROADMAP.md.
_UNPORTED_BACKENDS = {
    "hierarchical": "Queue A item 6 (core/hierarchy.py)",
    "shard_map": "Queue A item 8 (core/distributed.py)",
}

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
    use_kernel: bool = False
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
    is the time ``nvcc`` took to build the CUDA kernels when THIS call
    triggered the build, else 0, so a first call may report a large
    ``compile_time_s`` and a warm call 0; compare ``run_time_s``.
    ``drift_ratios`` / ``span_summary`` belong to the observability layer,
    which is not ported yet: they stay ``None``.
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
            return torch.from_numpy(sparse.pad_to_block_multiple(
                a.todense(), num_blocks)).to(device)
        return sparse.block_ell_from_coo(a, num_blocks, device=device)
    t = torch.as_tensor(a).to(device=device, dtype=torch.float32)
    rem = (-t.shape[1]) % num_blocks
    return torch.nn.functional.pad(t, (0, rem)) if rem else t


def _device_count(device: torch.device) -> int:
    """Devices a distributed solve could use from here: the visible CUDA
    devices when running on the GPU, 1 on the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _resolve_num_blocks(a: MatrixInput, config: "SolveConfig",
                        device: torch.device) -> Tuple[int, Optional[str]]:
    """Resolution order: explicit config > BlockEll's D > device count
    (>1) > DEFAULT_NUM_BLOCKS.  Returns (D, note)."""
    if config.num_blocks is not None:
        return config.num_blocks, None
    if isinstance(a, sparse.BlockEll):
        return a.num_blocks, None
    dev = _device_count(device)
    if dev > 1:
        return dev, f"num_blocks={dev} defaulted to the device count"
    return planner.DEFAULT_NUM_BLOCKS, (
        f"num_blocks defaulted to {planner.DEFAULT_NUM_BLOCKS}")


# ---------------------------------------------------------------------------
# Engine runner (shared by svd() and the legacy shim: one code path)
# ---------------------------------------------------------------------------

def _run_single(a, config: SolveConfig, *, draws=None, omega=None):
    return ranky.solve_single(
        a, num_blocks=config.num_blocks, method=config.method,
        local_mode=config.local_mode, merge_mode=config.merge_mode,
        undetermined_tail=config.undetermined_tail, rank=config.rank,
        oversample=config.oversample, power_iters=config.power_iters,
        want_right=config.want_right, use_kernel=config.use_kernel,
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
         *, device=None, **overrides) -> Plan:
    """What would :func:`svd` do for this input, and why.

    ``a`` may be an actual matrix (any accepted representation) or an
    :class:`~repro_torch.core.planner.ASpec`, so capacity planning needs
    no data, only shapes.
    """
    config = _reject_stream_knobs(_coerce_config(config, overrides), "plan")
    device = resolve_device(device)
    if isinstance(a, ASpec):
        spec = (a if config.num_blocks in (None, a.num_blocks)
                else dataclasses.replace(a, num_blocks=config.num_blocks))
        note = None
    else:
        d, note = _resolve_num_blocks(a, config, device)
        spec = describe(a, d)
    p = planner.make_plan(spec, config, device_count=_device_count(device),
                          mesh_provided=False)
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


def svd(a: MatrixInput, config: Optional[SolveConfig] = None, *,
        device=None, draws: Optional[RepairDraws] = None,
        omega: Optional[torch.Tensor] = None, **overrides) -> SVDResult:
    """Distributed Ranky SVD of ``a``: the one public entry point.

    Args:
      a: dense (M, N) ndarray or tensor, ``sparse.COOMatrix`` or
        ``sparse.BlockEll``.  Dense/COO inputs are normalized (padded /
        converted) by :func:`as_block_input`; BlockEll is consumed
        sparse-natively.
      config: a :class:`SolveConfig`; keyword ``overrides`` are applied
        on top (``svd(a, rank=16)`` works without building one).
      device: where the solve runs.  ``None`` is the current CUDA device
        (an error when there is none); ``"cpu"`` runs on the host.
      draws / omega: inject the random inputs of the repair and of the
        sketch (see ``ranky.RepairDraws``, ``randomized.draw_omega``);
        by default they are drawn from ``config.key``.

    Returns an :class:`SVDResult`: U (M, r), S (r,), V (N, r) when
    ``want_right`` (rows in original column order), the explainable
    :class:`~repro_torch.core.planner.Plan`, and :class:`Diagnostics`.
    """
    config = _reject_stream_knobs(_coerce_config(config, overrides), "svd")
    device = resolve_device(device)

    _sync(device)
    t0 = time.perf_counter()
    built_before = kernel_build.build_seconds
    with stage("describe_and_plan"):
        d, note = _resolve_num_blocks(a, config, device)
        spec = describe(a, d)
        if config.rank is not None and config.rank > spec.m:
            raise ValueError(
                f"rank={config.rank} must be in [1, M={spec.m}]")
        p = planner.make_plan(spec, config,
                              device_count=_device_count(device),
                              mesh_provided=False)
    if note:
        p = dataclasses.replace(p, reasons=p.reasons + (note,))
    if p.backend != "single":
        raise NotImplementedError(
            f"the plan's backend is {p.backend!r}, which is not ported "
            f"yet: ROADMAP.md {_UNPORTED_BACKENDS[p.backend]}; only "
            f"backend='single' runs (plan: {'; '.join(p.reasons)})")

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
    with stage("as_block_input"):
        a_norm = as_block_input(a, d, needs_dense=needs_dense, device=device)
    # Materialize the plan's decisions into the config the engine runs
    # with: p.rank is None when the plan is "solve exactly, truncate
    # after" (truncate_to).
    run_cfg = dataclasses.replace(config, num_blocks=d, backend=p.backend,
                                  rank=p.rank)

    out = _run_single(a_norm, run_cfg, draws=draws, omega=omega)

    u, s = out[0], out[1]
    v = out[2] if config.want_right else None
    if p.truncate_to is not None:
        k = p.truncate_to
        u, s = u[:, :k], s[:k]
        v = v[:, :k] if v is not None else None
    if v is not None:
        v = v[:spec.n]  # trim the adapter's zero-column padding back off
    _sync(device)
    wall = time.perf_counter() - t0
    # The kernels are built at most once per process: this call paid for
    # the build exactly when the recorded build time appeared during it.
    compile_s = (kernel_build.build_seconds or 0.0) \
        if built_before is None else 0.0
    compile_s = min(wall, compile_s)

    with stage("diagnostics"):       # after the clock: not in wall_time_s
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
        wall_time_s=wall, compile_time_s=compile_s,
        run_time_s=wall - compile_s,
    )
    return SVDResult(u=u, s=s, v=v, plan=p, diagnostics=diag)
