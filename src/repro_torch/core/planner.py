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

This is the reference's ``repro.core.planner`` for the one-shot rules
R1-R4, the streaming rules R5/R5d (:func:`make_stream_plan`), the
scan-window rule R6 (:func:`make_window_plan`), the serving rule R7
(:func:`make_serve_plan`) and the elastic-recovery rule R8
(:func:`make_recovery_plan`: the stream re-planned onto the devices that
survive a fault, the post-shrink peak priced and a degrade to the
single-host engine explained, plus the one-time restore transient
:func:`recovery_restore_bytes`), carried over as pure arithmetic: every
estimate, decision and reason string equals the reference's to the byte
(R6's "one lax.scan folds ..." included, though the port's window is the
same step run T times, ``stream/window.py``).

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

from repro_torch import obs

BYTES_F32 = 4
DEFAULT_MEMORY_BUDGET = 4 << 30  # 4 GiB
DEFAULT_NUM_BLOCKS = 8           # dense auto default when nothing pins D
EXACT_TRUNC_MAX_M = 2048         # auto prefers exact+truncate below this M
DEFAULT_WINDOW = 16              # R6 auto window target (halved to fit)


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


def stream_panel_width(rank: int, oversample: int, batch_m: int) -> int:
    """l_b = min(rank + oversample, batch rows): the batch's merge-panel
    width (how many columns the batch contributes to the R5 merge)."""
    return min(rank + oversample, batch_m)


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


def stream_repair_bytes(batch: ASpec) -> int:
    """R5 repair transient: ``split_and_repair`` materializes the split
    (D, m, W) block view and the repaired copy before the masked blocks
    reach the factorization: two batch-sized temporaries."""
    return BYTES_F32 * 2 * batch.m * batch.num_blocks * batch.width


def stream_repair_bytes_per_device(batch: ASpec) -> int:
    """R5d repair transient per device: the (m, W) nonzero mask plus
    the repaired block copy, and the two (m, m) buffers of the summed
    global adjacency."""
    return BYTES_F32 * 2 * (batch.m * batch.width + batch.m * batch.m)


def _batch_rank(rank: int, oversample: int, batch: ASpec,
                batch_rank: Optional[int]) -> int:
    return (stream_panel_width(rank, oversample, batch.m)
            if batch_rank is None else min(batch_rank, batch.m))


def stream_merge_bytes(batch: ASpec, rank: int, oversample: int, *,
                       batch_rank: Optional[int] = None) -> int:
    """R5 merge term: the (N_pad, k + r_b) stacked panel
    [V diag(s) | B^T U_b] plus an equal-sized SVD workspace, with
    ``r_b = l_b`` by default or an explicitly forced ``batch_rank``.
    No term depends on the rows already ingested."""
    r_b = _batch_rank(rank, oversample, batch, batch_rank)
    n_pad = batch.num_blocks * batch.width
    return BYTES_F32 * 2 * n_pad * (rank + r_b)


def stream_merge_bytes_per_device(batch: ASpec, rank: int, oversample: int,
                                  *, batch_rank: Optional[int] = None) -> int:
    """R5d merge term: the per-device (W, k + r_b) slice of the stacked
    panel plus its same-sized output shard (``stream_merge_bytes`` with
    N_pad replaced by the block width W)."""
    r_b = _batch_rank(rank, oversample, batch, batch_rank)
    return BYTES_F32 * 2 * batch.width * (rank + r_b)


def streaming_bytes_per_device(batch: ASpec, rank: int, oversample: int, *,
                               exact: bool,
                               batch_rank: Optional[int] = None) -> int:
    """R5d total: one sharded ``svd_update``'s PER-DEVICE peak = batch
    factorization (exact: one local (m, m) gram + the reduction buffer;
    sketch: the per-device (L, W) block sketch + (L, m) pullback / (m, L)
    QR workspace) + the per-device repair transient + the per-device
    merge slice.  Independent of the rows already ingested, like R5."""
    r_b = _batch_rank(rank, oversample, batch, batch_rank)
    if exact:
        base = BYTES_F32 * batch.m * batch.m
    else:
        l = sketch_width(r_b, oversample, batch.m)
        base = BYTES_F32 * (l * batch.width + 2 * batch.m * l)
    return (base + stream_repair_bytes_per_device(batch)
            + stream_merge_bytes_per_device(batch, rank, oversample,
                                            batch_rank=batch_rank))


def streaming_bytes(batch: ASpec, rank: int, oversample: int, *,
                    exact: bool, batch_rank: Optional[int] = None) -> int:
    """R5 total: one ``svd_update`` peak = batch factorization (exact
    gram stack or randomized sketch of the BATCH: ``batch.m`` is the
    batch row count, not the rows seen) + the split-and-repair transient
    + the merge panel.  The sketch term is estimated at rank ``r_b``
    (internal width ``min(r_b + oversample, m)``), the width the engine
    allocates."""
    r_b = _batch_rank(rank, oversample, batch, batch_rank)
    base = (exact_bytes(batch) if exact
            else sketch_bytes(batch, r_b, oversample))
    return (base + stream_repair_bytes(batch)
            + stream_merge_bytes(batch, rank, oversample,
                                 batch_rank=batch_rank))


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
    obs.counter_add("planner_plans_total", labels={"rule": "R1-R4"})
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


# ---------------------------------------------------------------------------
# Rules R5 / R5d: one streaming ingest (api.svd_update)
# ---------------------------------------------------------------------------

def make_stream_plan(batch: ASpec, config, *, device_count: int = 1) -> Plan:
    """Rules R5/R5d: plan one streaming ``svd_update`` from the BATCH
    shape plus the device environment.

    ``batch`` describes the incoming delta (``m`` = batch rows, ``n`` /
    ``num_blocks`` = the state's column universe).  Two decisions:

    * **backend** (R5d): ``config.stream_backend`` picks the engine.
      ``"shard_map"`` (or ``"auto"`` when one device per column block is
      available) shards the state's ``v`` and the merge panel; peak bytes
      are then PER DEVICE.  A requested shard_map that the environment
      cannot honor degrades honestly to the single-host engine with a
      reason saying so.
    * **batch factorization**: the returned plan's ``rank`` field:
      ``None`` = exact per-block gram stack + eigh, ``r`` = randomized
      rank-r sketch.  ``config.rank``, when set, forces the sketch.

    Like R3, R5/R5d never raise: when nothing fits the budget the
    planner degrades honestly to the cheaper batch factorization and
    says so.
    """
    obs.counter_add("planner_plans_total", labels={"rule": "R5"})
    k = config.truncate_rank
    if k is None:
        raise ValueError(
            "make_stream_plan needs SolveConfig.truncate_rank=k (the "
            "streaming truncation rank); got truncate_rank=None")
    budget = config.memory_budget_bytes or DEFAULT_MEMORY_BUDGET
    l_b = stream_panel_width(k, config.oversample, batch.m)
    est = {
        "stream_exact": streaming_bytes(batch, k, config.oversample,
                                        exact=True),
        "stream_sketch": streaming_bytes(batch, k, config.oversample,
                                         exact=False),
    }

    stream_backend = getattr(config, "stream_backend", "auto")
    shard_ok = device_count == batch.num_blocks and device_count > 1
    use_shard = shard_ok and stream_backend in ("auto", "shard_map")
    degrade_reasons = []
    if stream_backend == "shard_map" and not shard_ok:
        why_not = (f"only {device_count} device is available"
                   if device_count == batch.num_blocks else
                   f"device_count={device_count} != num_blocks="
                   f"{batch.num_blocks}")
        degrade_reasons.append(
            f"R5d: stream_backend='shard_map' requested but {why_not} "
            f"(sharded ingest needs one column block per device, more "
            f"than one device total); degrading honestly to the "
            f"single-host merge")

    if use_shard:
        est["stream_exact_per_device"] = streaming_bytes_per_device(
            batch, k, config.oversample, exact=True)
        est["stream_sketch_per_device"] = streaming_bytes_per_device(
            batch, k, config.oversample, exact=False)
        backend, exact_key, sketch_key = ("shard_map",
                                          "stream_exact_per_device",
                                          "stream_sketch_per_device")
        merge = stream_merge_bytes_per_device(batch, k, config.oversample)
        rule = (f"R5d: sharded streaming merge-and-truncate over "
                f"{device_count} devices (v column-block-sharded, batch "
                f"partials psum'd, the (k + l_b)-sized rotation from one "
                f"psum'd Gram) — PER-DEVICE peak = batch factorization + "
                f"{merge:,}B merge slice (2 * W * (k={k} + l_b={l_b}) "
                f"floats), independent of rows already ingested")
    else:
        backend, exact_key, sketch_key = ("single", "stream_exact",
                                          "stream_sketch")
        merge = stream_merge_bytes(batch, k, config.oversample)
        rule = (f"R5: streaming merge-and-truncate — per-update peak = "
                f"batch factorization + {merge:,}B merge panel "
                f"(2 * N_pad * (k={k} + l_b={l_b}) floats), independent "
                f"of rows already ingested (excludes the state's "
                f"left-factor update, ~8*rows_seen*k B, linear in rows "
                f"seen)")
    head = [rule] + degrade_reasons

    def finish(rank, peak, reasons):
        return Plan(
            backend=backend, strategy="streaming", method=config.method,
            merge_mode=config.merge_mode, local_mode=config.local_mode,
            rank=rank, truncate_to=None, sketch_leaves=False,
            num_blocks=batch.num_blocks, spec=batch, estimates=dict(est),
            budget=budget, reasons=tuple(head + reasons), peak_bytes=peak)

    if config.rank is not None:
        # The forced sketch runs at rank=config.rank, not l_b: estimate
        # the width the engine will actually allocate.
        est["stream_sketch"] = streaming_bytes(
            batch, k, config.oversample, exact=False,
            batch_rank=config.rank)
        if use_shard:
            est["stream_sketch_per_device"] = streaming_bytes_per_device(
                batch, k, config.oversample, exact=False,
                batch_rank=config.rank)
        return finish(min(config.rank, batch.m), est[sketch_key], [
            f"rank={config.rank} requested explicitly — randomized "
            f"batch factorization ({est[sketch_key]:,}B)"])
    if est[exact_key] <= budget and batch.m <= EXACT_TRUNC_MAX_M:
        return finish(None, est[exact_key], [
            f"exact batch factorization — {est[exact_key]:,}B "
            f"fits the budget ({budget:,}B) and batch rows "
            f"{batch.m} <= {EXACT_TRUNC_MAX_M} (more accurate than "
            f"the sketch)"])
    why = (f"exceeds the budget ({budget:,}B)"
           if est[exact_key] > budget
           else f"batch rows {batch.m} > exact ceiling {EXACT_TRUNC_MAX_M}")
    if est[sketch_key] <= budget:
        return finish(l_b, est[sketch_key], [
            f"the exact batch gram stack needs "
            f"{est[exact_key]:,}B which {why}; the "
            f"(k+p)-row batch sketch fits at "
            f"{est[sketch_key]:,}B"])
    cheaper_exact = est[exact_key] <= est[sketch_key]
    rank = None if cheaper_exact else l_b
    peak = est[exact_key] if cheaper_exact else est[sketch_key]
    return finish(rank, peak, [
        f"NO batch factorization fits the budget ({budget:,}B): "
        f"exact {est[exact_key]:,}B, sketch "
        f"{est[sketch_key]:,}B; proceeding with the cheaper "
        f"{'exact gram stack' if cheaper_exact else 'sketch'}"])


# ---------------------------------------------------------------------------
# Rule R8: elastic-recovery re-plan — post-shrink peak, priced not silent
# ---------------------------------------------------------------------------

def recovery_restore_bytes(batch: ASpec, rank: int) -> int:
    """The one-time restore transient of an elastic recovery:
    checkpoints store the right factor gathered, so while the survivors
    rebuild residency the (N_pad, k) restored copy and its re-placed
    (sharded or single-device) twin are live simultaneously —
    ``2 * N_pad * k`` floats."""
    return BYTES_F32 * 2 * batch.num_blocks * batch.width * rank


def make_recovery_plan(batch: ASpec, config, *, survivors: int) -> Plan:
    """Rule R8: re-plan a stream onto the surviving devices after a
    failure or eviction, pricing the post-shrink per-device peak so a
    degrade is explained, not silent.

    Two outcomes, both honest:

    * ``survivors >= num_blocks`` (and > 1 block) — the 1-D stream mesh
      rebuilds on ``num_blocks`` of the healthy devices; the R5d
      per-device closed form is unchanged (per-device peak never
      depended on which devices, only on the one-block-per-device
      layout).
    * otherwise — too few devices for one column block each: degrade to
      the single-host engine on one survivor, whose peak is the FULL R5
      working set (the reason quotes both numbers, so the operator sees
      exactly what the shrink costs).

    Either way the estimates carry ``recovery_restore`` — the one-time
    (N_pad, k)-sized restore transient — and the plan's ``peak_bytes``
    is the steady post-shrink peak the resumed stream runs at.
    """
    obs.counter_add("planner_plans_total", labels={"rule": "R8"})
    if survivors < 1:
        raise PlanError(
            f"R8: recovery needs at least one surviving device, got "
            f"{survivors}")
    k = config.truncate_rank
    if k is None:
        raise ValueError(
            "make_recovery_plan needs SolveConfig.truncate_rank=k; got "
            "truncate_rank=None")
    remesh = survivors >= batch.num_blocks and batch.num_blocks > 1
    base = make_stream_plan(
        batch, config, device_count=batch.num_blocks if remesh else 1)
    restore = recovery_restore_bytes(batch, k)
    est = dict(base.estimates)
    est["recovery_restore"] = restore
    if remesh and base.backend == "shard_map":
        head = (
            f"R8: recovery onto {survivors} survivor(s) — the 1-D stream "
            f"mesh rebuilds with num_blocks={batch.num_blocks} of the "
            f"healthy devices; post-shrink PER-DEVICE peak "
            f"{base.peak_bytes:,}B (the R5d closed form is unchanged — it "
            f"never depended on which devices, only on the layout); "
            f"one-time restore transient {restore:,}B (the gathered "
            f"(N_pad, k={k}) right factor plus its re-placed copy)")
    elif batch.num_blocks == 1 or remesh:
        # Single-host by construction (one column block) or by explicit
        # stream_backend="single" — the shrink changes placement, not
        # the engine.
        head = (
            f"R8: recovery onto {survivors} survivor(s) — the stream "
            f"runs the single-host engine (num_blocks={batch.num_blocks}, "
            f"stream_backend={getattr(config, 'stream_backend', 'auto')!r}); "
            f"peak {base.peak_bytes:,}B unchanged; one-time restore "
            f"transient {restore:,}B")
    else:
        pre = streaming_bytes_per_device(
            batch, k, config.oversample, exact=base.rank is None,
            batch_rank=base.rank)
        head = (
            f"R8: recovery onto {survivors} survivor(s) < num_blocks="
            f"{batch.num_blocks} — too few devices for one column block "
            f"each; degrading honestly to the single-host engine on one "
            f"survivor, post-shrink peak = the FULL R5 working set "
            f"{base.peak_bytes:,}B on that device (vs {pre:,}B per device "
            f"before the shrink); one-time restore transient {restore:,}B")
    return dataclasses.replace(
        base, estimates=est, reasons=(head,) + base.reasons)


# ---------------------------------------------------------------------------
# Rule R6: window bytes for the scan-window stream driver
# ---------------------------------------------------------------------------

def window_carry_bytes(batch: ASpec, rank: int, *,
                       per_device: bool = False) -> int:
    """The fixed-shape window carry: the state's ``(s, v)`` at the
    steady truncation rank plus the device-resident side-band counters
    (batch index, lonely/repaired accumulators, the (D,) per-block
    lonely vector).  ``v`` dominates: (N_pad, k) floats — or the
    per-device (W, k) shard under the sharded engine."""
    cols = batch.width if per_device else batch.num_blocks * batch.width
    return BYTES_F32 * (rank * (cols + 1) + batch.num_blocks + 3)


def window_input_bytes(batch: ASpec, window: int, *,
                       nnz_slots: Optional[int] = None,
                       per_device: bool = False) -> int:
    """Stacked device-resident deltas for one window of T batches.

    Dense: T * (m_b, N_pad) floats — the per-device slice is (m_b, W).
    Bucketed ELL (``nnz_slots`` = D * C_b * K_b stored slots of the
    canonical bucket shape): T * (rows + vals + ids) = T * (2 *
    nnz_slots + nnz_slots / K) entries; int32 and float32 are both 4B,
    and the ids term is bounded by the slots term, so the closed form
    charges 3 slots-worth per batch (per-device: slots / D).
    """
    if nnz_slots is not None:
        per = 3 * (nnz_slots // batch.num_blocks if per_device
                   else nnz_slots)
    else:
        per = batch.m * (batch.width if per_device
                         else batch.num_blocks * batch.width)
    return BYTES_F32 * window * per


def window_output_bytes(batch: ASpec, rank: int, oversample: int,
                        window: int, *,
                        batch_rank: Optional[int] = None) -> int:
    """Stacked per-step window outputs, replicated on every device: the
    small rotations ``uk`` (T, k + r_b, k), the batch left panels
    ``u_b`` (T, m_b, r_b) — ``u`` grows with rows_seen so it can never
    live in the fixed-shape carry; these are folded into it once, after
    the scan — and the (T, D) per-block lonely counts."""
    r_b = (stream_panel_width(rank, oversample, batch.m)
           if batch_rank is None else min(batch_rank, batch.m))
    per = (rank + r_b) * rank + batch.m * r_b + batch.num_blocks
    return BYTES_F32 * window * per


def window_bytes(batch: ASpec, rank: int, oversample: int, *, exact: bool,
                 window: int, batch_rank: Optional[int] = None,
                 nnz_slots: Optional[int] = None,
                 per_device: bool = False) -> int:
    """R6 total: one window's peak = fixed carry + stacked
    inputs + stacked outputs (all window-proportional and resident for
    the whole dispatch) + ONE step's R5/R5d working set (the per-batch
    factorization + merge panel; steps run sequentially inside the
    scan, so only one step's transient is live at a time).

    ``batch`` must describe the BUCKETED batch (m = padded bucket rows);
    the window engine and the benchmarks hand-compute this same form.
    """
    step = (streaming_bytes_per_device(batch, rank, oversample, exact=exact,
                                       batch_rank=batch_rank)
            if per_device else
            streaming_bytes(batch, rank, oversample, exact=exact,
                            batch_rank=batch_rank))
    return (window_carry_bytes(batch, rank, per_device=per_device)
            + window_input_bytes(batch, window, nnz_slots=nnz_slots,
                                 per_device=per_device)
            + window_output_bytes(batch, rank, oversample, window,
                                  batch_rank=batch_rank)
            + step)


def make_window_plan(batch: ASpec, config, *, device_count: int = 1,
                     nnz_slots: Optional[int] = None) -> Plan:
    """Rule R6 on top of R5/R5d: decide the scan-window length for the
    one-compilation stream driver.

    Starts from :func:`make_stream_plan`'s backend / batch-factorization
    decision (``batch`` already describes the bucketed delta), then
    picks the window length T: ``config.window`` when set (shrunk by
    halving if its R6 bytes exceed the budget, with a reason saying
    so), else the largest power of two <= :data:`DEFAULT_WINDOW` that
    fits.  When not even T=2 fits, the plan degrades honestly to the
    per-batch loop (``window=1``) — streaming was explicitly requested,
    so R6 never raises.  The chosen window and its closed-form bytes
    are echoed in ``Plan.explain`` and ``Plan.estimates``.
    """
    obs.counter_add("planner_plans_total", labels={"rule": "R6"})
    base = make_stream_plan(batch, config, device_count=device_count)
    k = config.truncate_rank
    exact = base.rank is None
    per_device = base.backend == "shard_map"
    batch_rank = None if exact else base.rank

    def wbytes(t: int) -> int:
        return window_bytes(batch, k, config.oversample, exact=exact,
                            window=t, batch_rank=batch_rank,
                            nnz_slots=nnz_slots, per_device=per_device)

    requested = getattr(config, "window", None)
    target = requested if requested is not None else DEFAULT_WINDOW
    reasons = []
    if requested == 1:
        reasons.append(
            "R6: window=1 requested explicitly — per-batch loop (each "
            "batch is its own dispatch; same jitted step as the scan)")
        chosen = 1
    else:
        chosen = max(1, target)
        while chosen > 1 and wbytes(chosen) > base.budget:
            chosen //= 2
        scope = "PER-DEVICE " if per_device else ""
        if chosen == 1:
            reasons.append(
                f"R6: not even a 2-batch window fits the budget "
                f"({wbytes(2):,}B {scope}> {base.budget:,}B); degrading "
                f"honestly to the per-batch loop (window=1)")
        else:
            how = (f"window={requested} requested" if requested is not None
                   else f"auto window (target {DEFAULT_WINDOW})")
            shrunk = ("" if chosen == target else
                      f", halved from {target} to fit the budget")
            reasons.append(
                f"R6: {how}{shrunk} — one lax.scan folds {chosen} "
                f"same-bucket batches per dispatch; {scope}window peak = "
                f"carry {window_carry_bytes(batch, k, per_device=per_device):,}B "
                f"+ stacked inputs "
                f"{window_input_bytes(batch, chosen, nnz_slots=nnz_slots, per_device=per_device):,}B "
                f"+ stacked uk/u_b outputs "
                f"{window_output_bytes(batch, k, config.oversample, chosen, batch_rank=batch_rank):,}B "
                f"+ one step's R5{'d' if per_device else ''} working set "
                f"= {wbytes(chosen):,}B <= budget {base.budget:,}B")
    est = dict(base.estimates)
    est["stream_window" + ("_per_device" if per_device else "")] = \
        wbytes(chosen)
    return dataclasses.replace(
        base, window=chosen, estimates=est,
        peak_bytes=wbytes(chosen) if chosen > 1 else base.peak_bytes,
        reasons=base.reasons + tuple(reasons))


# ---------------------------------------------------------------------------
# Rule R7: serving bytes for the top-k retrieval front end (api.serve_*)
# ---------------------------------------------------------------------------

def serve_factor_bytes(cols: int, rank: int, *, quantized: bool = False) -> int:
    """Resident item-factor bytes for ``cols`` rows of ``v`` at ``rank``:
    f32 is ``4 * cols * k``; int8 is ``cols * k`` plus ``4 * cols`` for
    the per-item dequant scales (kvquant axis=-1)."""
    if quantized:
        return cols * rank + BYTES_F32 * cols
    return BYTES_F32 * cols * rank


def serve_fused_bytes(batch: int, rank: int, k_top: int, block_n: int) -> int:
    """Fused score+top-k working set, INDEPENDENT of the universe size:
    the (B, k) queries, one (B, block_n) score tile, the (B, k_top)
    running value/index pair, and the (B, k_top + block_n) merge
    candidate pair (i32 indices are 4B like f32)."""
    return BYTES_F32 * batch * (
        rank + block_n + 2 * k_top + 2 * (k_top + block_n))


def serve_fallback_bytes(batch: int, rank: int, cols: int, k_top: int) -> int:
    """Plain fallback: materializes the FULL (B, cols) score matrix,
    plus the queries and the (B, k_top) output pair."""
    return BYTES_F32 * batch * (rank + cols + 2 * k_top)


def serving_bytes(n: int, rank: int, batch: int, k_top: int, *,
                  num_blocks: int = 1, quantized: bool = False,
                  fused: bool = True, block_n: int = 512,
                  per_device: bool = False) -> int:
    """R7 total: resident factors + the score/select working set, plus,
    under the sharded backend, the all-gathered (B, D*k_top) candidate
    pair every device holds for the final merge.  ``per_device=True``
    prices one device of the sharded engine (its (W, k) factor slice)."""
    width = -(-n // num_blocks)
    cols = width if per_device else num_blocks * width
    if fused:
        score = serve_fused_bytes(batch, rank, k_top, block_n)
    else:
        score = serve_fallback_bytes(batch, rank, cols, k_top)
    gather = (2 * BYTES_F32 * batch * num_blocks * k_top
              if per_device else 0)
    return serve_factor_bytes(cols, rank, quantized=quantized) + score + gather


def make_serve_plan(n: int, rank: int, config, *,
                    device_count: int = 1) -> Plan:
    """Rule R7: price and narrate the serving path for ``api.serve_init``.

    ``n`` is the column universe, ``rank`` the snapshot's truncation
    rank, ``config`` a ``ServeTopKConfig``.  Serving was explicitly
    requested, so like R5 this NEVER raises; every compromise is a reason
    on the plan:

    * backend: ``shard_map`` when the config asks for it (or ``auto``
      finds one device per column block) AND one device per column block
      is available; otherwise single, with a reason when a sharded
      request degraded.
    * fused vs fallback: the fused kernel's working set never contains
      the (B, N) score matrix; the plain fallback is chosen only when
      ``use_kernel=False``, priced at the full score matrix.
    * budget: when even the chosen path exceeds the budget there is no
      cheaper serving strategy, so the plan keeps it and says so.
    """
    obs.counter_add("planner_plans_total", labels={"rule": "R7"})
    budget = config.memory_budget_bytes or DEFAULT_MEMORY_BUDGET
    d = config.num_blocks
    b, k_top, block_n = config.batch_size, config.k_top, config.block_n
    quant = config.quantize
    reasons = []

    want_shard = config.serve_backend == "shard_map" or (
        config.serve_backend == "auto" and device_count == d
        and device_count > 1)
    shard_ok = device_count == d and device_count > 1
    if want_shard and not shard_ok:
        reasons.append(
            f"R7: serve_backend=shard_map needs one device per column "
            f"block (D={d}, devices={device_count}); degrading to the "
            f"single-device ranker")
    sharded = want_shard and shard_ok
    backend = "shard_map" if sharded else "single"
    tag = "_per_device" if sharded else ""
    scope = "PER-DEVICE " if sharded else ""

    def sbytes(fused: bool) -> int:
        return serving_bytes(n, rank, b, k_top, num_blocks=d,
                             quantized=quant, fused=fused, block_n=block_n,
                             per_device=sharded)

    est = {
        "serve_fused" + tag: sbytes(True),
        "serve_fallback" + tag: sbytes(False),
        "serve_factors" + tag: serve_factor_bytes(
            (-(-n // d)) if sharded else d * (-(-n // d)),
            rank, quantized=quant),
    }
    fused = bool(config.use_kernel)
    strategy = "serve_fused" if fused else "serve_fallback"
    peak = est[strategy + tag]
    factors = est["serve_factors" + tag]
    if fused:
        reasons.append(
            f"R7: fused score+top-k kernel — {scope}peak = factors "
            f"({'int8+scales' if quant else 'f32'}) {factors:,}B + "
            f"N-independent working set (queries + one (B={b}, "
            f"block_n={block_n}) score tile + running top-{k_top} + merge "
            f"candidates) = {peak:,}B; the (B, N) score matrix is never "
            f"materialized")
    else:
        reasons.append(
            f"R7: use_kernel=False — jnp fallback materializes the full "
            f"(B={b}, N={n:,}) score matrix; {scope}peak = {peak:,}B vs "
            f"{est['serve_fused' + tag]:,}B fused")
    if sharded:
        reasons.append(
            f"R7: sharded ranker — each of the {d} devices scores its "
            f"(W, k) factor slice and all-gathers a (B, D*k_top) "
            f"candidate pair ({2 * BYTES_F32 * b * d * k_top:,}B) for "
            f"the final merge; per-device peak is independent of the "
            f"total column count")
    if peak > budget:
        reasons.append(
            f"R7: {scope}peak {peak:,}B EXCEEDS budget {budget:,}B and "
            f"serving was explicitly requested — no cheaper strategy "
            f"exists"
            + ("" if quant else "; quantize=True would shrink the "
               "resident factors ~4x"))
    else:
        reasons.append(
            f"R7: {scope}peak {peak:,}B <= budget {budget:,}B")
    spec = ASpec(m=b, n=n, nnz=n * rank, num_blocks=d, kind="dense")
    return Plan(
        backend=backend, strategy=strategy, method="topk",
        merge_mode="none", local_mode="none", rank=rank,
        truncate_to=config.k_top, sketch_leaves=False, num_blocks=d,
        spec=spec, estimates=est, budget=budget, reasons=tuple(reasons),
        peak_bytes=peak)
