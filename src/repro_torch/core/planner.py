"""The explainable auto-planner behind ``repro_torch.core.api.svd``.

Every Ranky strategy (exact gram/proxy, randomized sketch, hierarchical
tree merge, shard_map distribution) recovers the same (U, S[, V]); they
differ only in peak memory and FLOPs (Li-Kluger-Tygert 1612.08709,
Iwen-Ong 1601.07010).  The planner makes that trade-off explicit: it
estimates peak bytes for each strategy from ``(M, N, nnz, rank, device
count)`` with the closed-form dominant terms below, picks one, and
returns a :class:`Plan` whose ``reasons`` spell out the decision.  The
solve result (``api.SVDResult.plan``) echoes the plan back, so "why did
it sketch?" is always answerable from the result object.

This is the one-shot half (rules R1-R4) of the reference's
``repro.core.planner``, carried over as pure arithmetic: every estimate,
decision and reason string equals the reference's to the byte.  The
streaming, window, recovery and serving rules arrive with their slices.

Byte estimates (float32, dominant term only):

* ``exact_bytes``       = ``4 * D * M^2``: the single-host (D, M, M)
  gram stack; the proxy merge's M x (D*M) proxy is the same count.
* ``shard_map_bytes``   = ``4 * M^2`` for the gram merge (one reduction
  buffer per device) or ``4 * D * M^2`` for the proxy merge (the
  all-gathered proxy lands on every device).
* ``sketch_bytes``      = ``4 * (D*L*W + 2*M*L)`` with
  ``L = min(rank + oversample, M)``: per-block sketches G (L, W), the
  pullback T (L, M) and the (M, L) QR workspace.
* ``hierarchical_bytes``= ``4 * D * M * r``: the level-0 panel stack
  (r = rank or M).  Reported for explainability; the tree merge is
  selected by request (``backend="hierarchical"`` / ``sketch=True``),
  not by the auto rules.
* ``solve_repair_bytes`` = ``4 * 2 * M * N_pad``: the one-shot
  split-and-repair transient (split block view + repaired copy) that
  rides on TOP of every R1-R4 strategy term for dense inputs.

Auto rules (``config.backend == "auto"``), first match wins:

* R1 ``undetermined_tail=True``  -> single/proxy (the emulation only
  exists in the single-host proxy-panel merge).
* R2 ``sketch=True``             -> hierarchical with sketch leaves.
* R3 ``rank=k`` set: exact-then-truncate when the gram stack fits the
  budget AND ``M <= EXACT_TRUNC_MAX_M`` (more accurate than sketching
  and still cheap).  Otherwise the randomized sketch if ITS estimate
  fits the budget (the tall-row regime, where ``L*W << M^2``); if the
  sketch estimate does not fit but the gram stack does, exact-then-
  truncate; if neither fits, the cheaper of the two with a reason saying
  so.  Backend is shard_map when a matching mesh is available, else
  single.
* R4 ``rank=None``: exact, on shard_map when a matching mesh is
  available (per-device peak ``shard_map_bytes``) else single-host
  (``exact_bytes``).  If the chosen peak exceeds the budget the plan
  fails with :class:`PlanError` listing every estimate and suggesting
  ``rank=k``.

The memory budget defaults to :data:`DEFAULT_MEMORY_BUDGET` (4 GiB) and
is overridden per solve with ``SolveConfig(memory_budget_bytes=...)``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

BYTES_F32 = 4
DEFAULT_MEMORY_BUDGET = 4 << 30  # 4 GiB
DEFAULT_NUM_BLOCKS = 8           # dense auto default when nothing pins D
EXACT_TRUNC_MAX_M = 2048         # auto prefers exact+truncate below this M


class PlanError(ValueError):
    """No strategy satisfies the config within the memory budget."""


@dataclasses.dataclass(frozen=True)
class ASpec:
    """Shape summary of the input matrix the planner works from."""

    m: int            # global rows
    n: int            # global (unpadded) columns
    nnz: int          # stored nonzeros
    num_blocks: int   # resolved column-block count D
    kind: str = "dense"  # "dense" | "coo" | "ell"

    def __post_init__(self):
        if self.m < 1 or self.n < 1:
            raise ValueError(f"ASpec needs m, n >= 1; got ({self.m}, {self.n})")
        if self.num_blocks < 1:
            raise ValueError(f"ASpec.num_blocks={self.num_blocks} must be >= 1")

    @property
    def width(self) -> int:
        """Device block width W = ceil(N / D) (sparse.block_width)."""
        return -(-self.n // self.num_blocks)


def sketch_width(rank: int, oversample: int, m: int) -> int:
    """L = min(rank + oversample, M) — mirrors randomized.sketch_width
    without the validation (the config already validated)."""
    return min(rank + oversample, m)


def exact_bytes(spec: ASpec) -> int:
    """Single-host exact peak: the (D, M, M) gram/panel stack."""
    return BYTES_F32 * spec.num_blocks * spec.m * spec.m


def shard_map_bytes(spec: ASpec, merge_mode: str = "gram") -> int:
    """Per-device exact peak on a mesh: one M x M gram for the psum
    merge, or the whole M x (D*M) gathered proxy for the proxy merge."""
    per = spec.m * spec.m
    if merge_mode == "proxy":
        per *= spec.num_blocks
    return BYTES_F32 * per


def sketch_bytes(spec: ASpec, rank: int, oversample: int) -> int:
    """Randomized-path peak: per-block (L, W) sketches + the (L, M)
    pullback + the (M, L) QR workspace."""
    l = sketch_width(rank, oversample, spec.m)
    return BYTES_F32 * (spec.num_blocks * l * spec.width + 2 * spec.m * l)


def hierarchical_bytes(spec: ASpec, rank: Optional[int]) -> int:
    """Tree-merge level-0 panel stack (D, M, r)."""
    r = spec.m if rank is None else min(rank, spec.m)
    return BYTES_F32 * spec.num_blocks * spec.m * r


def solve_repair_bytes(spec: ASpec) -> int:
    """R1–R4 split-and-repair transient for DENSE one-shot inputs: the
    split (D, M, W) block view and the repaired copy, live while the
    chosen strategy builds its own stack — ``4 * 2 * M * N_pad``, the
    two block-stack-sized copies.  The
    measured-memory tests  price one-shot budgets as
    strategy bytes + this transient; the randomized path additionally
    keeps the repaired block stack (one more ``4 * M * N_pad``) live as
    the sketch's input.  ``Plan.peak_bytes`` keeps reporting the
    strategy's dominant term only, as documented above."""
    return BYTES_F32 * 2 * spec.m * spec.num_blocks * spec.width


@dataclasses.dataclass(frozen=True)
class Plan:
    """An explainable solve plan.  ``reasons`` narrate the decision;
    ``estimates`` carry every strategy's peak-byte estimate so the
    choice is auditable after the fact."""

    backend: str                  # "single" | "hierarchical" | "shard_map"
    strategy: str                 # "exact_gram" | "exact_proxy" | "randomized" | "hierarchical"
    method: str
    merge_mode: str
    local_mode: str
    rank: Optional[int]           # rank the ENGINE runs with (None = exact)
    truncate_to: Optional[int]    # post-hoc top-k slice of an exact solve
    sketch_leaves: bool           # hierarchical backend: randomized leaves?
    num_blocks: int
    spec: ASpec
    estimates: Dict[str, int]     # strategy -> estimated peak bytes
    budget: int
    reasons: Tuple[str, ...]
    peak_bytes: int = 0           # the chosen strategy's ACTUAL peak —
                                  # per device for shard_map, which is
                                  # what the budget decision used
    window: Optional[int] = None  # R6 scan-window length (streaming
                                  # only): None = not a window plan,
                                  # 1 = per-batch loop, T = one lax.scan
                                  # over T same-bucket batches

    @property
    def estimated_peak_bytes(self) -> int:
        return self.peak_bytes

    def explain(self) -> str:
        """Human-readable one-paragraph justification."""
        est = ", ".join(f"{k}={v:,}B" for k, v in sorted(self.estimates.items()))
        head = (f"backend={self.backend} strategy={self.strategy} "
                f"(M={self.spec.m}, N={self.spec.n}, nnz={self.spec.nnz}, "
                f"D={self.num_blocks}; budget={self.budget:,}B; {est})")
        return "\n".join((head,) + self.reasons)


def _estimates(spec: ASpec, config) -> Dict[str, int]:
    est = {
        "exact_gram": exact_bytes(spec),
        "exact_proxy": exact_bytes(spec),
        "hierarchical": hierarchical_bytes(spec, config.rank),
    }
    if config.rank is not None:
        est["randomized"] = sketch_bytes(spec, config.rank, config.oversample)
    return est


def make_plan(spec: ASpec, config, *, device_count: int = 1,
              mesh_provided: bool = False) -> Plan:
    """Turn (input spec, SolveConfig, environment) into a Plan.

    ``device_count`` is the number of devices a shard_map solve would
    use (the product of the mesh block axes, or the visible CUDA device count
    when no mesh was passed); shard_map is viable only when it equals
    ``spec.num_blocks`` (one column block per device).
    ``mesh_provided=True`` records that the caller handed an explicit
    mesh, which makes auto prefer shard_map.
    """
    budget = config.memory_budget_bytes or DEFAULT_MEMORY_BUDGET
    est = _estimates(spec, config)
    shard_ok = device_count == spec.num_blocks and (
        mesh_provided or device_count > 1)

    def exact_strategy():
        return "exact_gram" if config.merge_mode == "gram" else "exact_proxy"

    def finish(backend, strategy, reasons, *, rank=config.rank,
               truncate_to=None, sketch_leaves=False):
        if backend == "shard_map":
            est["shard_map"] = shard_map_bytes(spec, config.merge_mode)
        if backend == "shard_map" and strategy in ("exact_gram",
                                                   "exact_proxy"):
            peak = est["shard_map"]
        elif backend == "shard_map" and strategy == "randomized":
            # per-device sketch: one (L, W) block sketch + the (L, M)
            # pullback / (M, L) QR workspace (no D factor).
            l = sketch_width(config.rank, config.oversample, spec.m)
            peak = BYTES_F32 * (l * spec.width + 2 * spec.m * l)
        else:
            peak = est[strategy]
        return Plan(
            backend=backend, strategy=strategy, method=config.method,
            merge_mode=config.merge_mode, local_mode=config.local_mode,
            rank=rank, truncate_to=truncate_to, sketch_leaves=sketch_leaves,
            num_blocks=spec.num_blocks, spec=spec, estimates=dict(est),
            budget=budget, reasons=tuple(reasons), peak_bytes=peak)

    if config.backend != "auto":
        if config.backend == "hierarchical":
            strategy = "hierarchical"
        elif config.rank is not None:
            strategy = "randomized"
        else:
            strategy = exact_strategy()
        return finish(config.backend, strategy,
                      [f"backend={config.backend!r} requested explicitly"],
                      sketch_leaves=config.sketch)

    # --- auto rules, first match wins --------------------------------
    if config.undetermined_tail:  # R1
        return finish("single", "exact_proxy", [
            "R1: undetermined_tail=True — the rank-problem emulation only "
            "exists in the single-host proxy-panel merge"])

    if config.sketch:  # R2
        return finish("hierarchical", "hierarchical", [
            "R2: sketch=True — hierarchical tree merge with randomized "
            "truncated leaves"], sketch_leaves=True)

    if config.rank is not None:  # R3
        eb, sb = est["exact_gram"], est["randomized"]
        backend = "shard_map" if shard_ok else "single"
        exact_reason_tail = (
            f"so solve exactly and truncate to the top-{config.rank}")
        if eb <= budget and spec.m <= EXACT_TRUNC_MAX_M:
            return finish(backend, exact_strategy(), [
                f"R3: rank={config.rank} with a small exact solve — the "
                f"gram stack ({eb:,}B) fits the budget ({budget:,}B) and "
                f"M={spec.m} <= {EXACT_TRUNC_MAX_M}, {exact_reason_tail} "
                f"(more accurate than the sketch)"],
                rank=None, truncate_to=config.rank)
        why = (f"exceeds the budget ({budget:,}B)" if eb > budget
               else f"M={spec.m} > exact-truncate ceiling {EXACT_TRUNC_MAX_M}")
        if sb <= budget:
            return finish(backend, "randomized", [
                f"R3: rank={config.rank} — the exact gram stack needs "
                f"{eb:,}B which {why}; the (k+p)-row sketch fits the "
                f"budget at {sb:,}B (tall-row regime, Li–Kluger–Tygert)"])
        if eb <= budget:
            # Short-and-fat blocks: the D*L*W sketch term outgrows the
            # gram stack, so the exact path is the one that fits.
            return finish(backend, exact_strategy(), [
                f"R3: rank={config.rank} — the sketch estimate ({sb:,}B) "
                f"exceeds the budget ({budget:,}B) but the gram stack "
                f"({eb:,}B) fits, {exact_reason_tail}"],
                rank=None, truncate_to=config.rank)
        # Neither fits; rank=k was explicit, so degrade to the cheaper
        # strategy honestly instead of erroring.
        if sb <= eb:
            return finish(backend, "randomized", [
                f"R3: rank={config.rank} — NO strategy fits the budget "
                f"({budget:,}B): gram stack {eb:,}B, sketch {sb:,}B; "
                f"proceeding with the cheaper sketch"])
        return finish(backend, exact_strategy(), [
            f"R3: rank={config.rank} — NO strategy fits the budget "
            f"({budget:,}B): gram stack {eb:,}B, sketch {sb:,}B; "
            f"proceeding with the cheaper exact solve, truncated"],
            rank=None, truncate_to=config.rank)

    # R4: exact full factorization.
    backend = "shard_map" if shard_ok else "single"
    peak = (shard_map_bytes(spec, config.merge_mode) if backend == "shard_map"
            else est[exact_strategy()])
    if peak > budget:
        raise PlanError(
            f"no exact strategy fits the memory budget: peak {peak:,}B > "
            f"budget {budget:,}B for backend={backend!r} "
            f"merge_mode={config.merge_mode!r} (estimates: "
            + ", ".join(f"{k}={v:,}B" for k, v in sorted(est.items()))
            + "). Set rank=k to use the randomized sketch "
            "(O(nnz*k) per block), raise memory_budget_bytes, or shard "
            "over more devices.")
    reasons = [f"R4: exact factorization — peak {peak:,}B fits the "
               f"budget ({budget:,}B)"]
    if backend == "shard_map":
        reasons.append(
            f"shard_map over {device_count} devices (one column block "
            f"per device)")
    return finish(backend, exact_strategy(), reasons)
