"""The incremental merge-and-truncate engine behind ``api.svd_update``.

One ingest folds a batch ``B`` of new rows into an existing truncated
factorization ``A_old ~ U diag(s) V^T`` without ever touching the rows
already seen:

1. **Normalize** the delta into the state's column universe
   (``stream.state.as_delta``): COO deltas become ``BlockEll`` and run
   sparse-natively end to end.
2. **Repair** the batch with the configured Ranky checker
   (``ranky.split_and_repair``) *before* anything is truncated: a
   rank-deficient batch block leaves its lonely rows with no weight in
   the truncated factors, and the merge can never recover components a
   leaf lost (the paper's rank problem, streaming edition).
3. **Factor** the repaired batch sparse-natively, per the plan's R5
   decision (``core/planner.py``): the exact per-block gram stack + eigh
   when the batch is small enough (the ``sparse_gram`` / ``blockgram``
   kernels underneath), otherwise the randomized (k+p)-row sketch
   (``core/randomized.py``, the ``sketch_panel`` kernel underneath).
   Either way the batch contributes an (n_pad, r_b) right panel
   ``P_b = B^T U_b`` (= ``V_b diag(s_b)``, computed without any 1/s
   division, so a rank-deficient batch stays finite).
4. **Merge and truncate**: with ``P_old = V diag(decay * s)`` the stacked
   matrix ``K = [diag(decay*s) V^T ; diag(s_b) V_b^T]`` satisfies
   ``[decay*A_old ; B] = blockdiag(U, U_b) @ K``, so one SVD of
   ``K^T = [P_old | P_b]`` (``hierarchy.merge_svd``) yields the new
   ``(V', s')`` plus the small rotation ``U_k`` that updates the left
   vectors: ``U' = [U @ U_k[:k] ; U_b @ U_k[k:]]``.  Truncation back to
   ``truncate_rank`` closes the loop.

Nothing in steps 3-4 depends on ``rows_seen``: the merge works on an
(n_pad, k + r_b) panel and the batch factorization on the batch alone
(planner rule R5's closed form).

Random inputs: batch ``b`` draws from ``ranky.derive_seed(state.seed,
b)``; ``draws=`` / ``omega=`` inject them (the parity tests hand in the
reference's own per-batch draws).

The distributed engine (``ingest_shard_map``, rule R5d) is not ported
yet: ROADMAP Queue A item 8.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.core import hierarchy, randomized, ranky, sparse
from repro_torch.core import svd as lsvd
from repro_torch.stream import state as stream_state
from repro_torch.stream.state import StreamingSVDState

# Fault-injection seam: ``fn(phase)`` is called at ``"ingest.batch"``
# (engine entry) and ``"ingest.merge"`` (just before the merge) and
# simulates a fault by raising.  ``None`` (the default) is production.
_fault_seam: Optional[Callable[[str], None]] = None


def install_fault_seam(fn: Optional[Callable[[str], None]]) -> None:
    """Install (or with ``None`` remove) the fault-injection callable."""
    global _fault_seam
    _fault_seam = fn


def _fire_seam(phase: str) -> None:
    if _fault_seam is not None:
        _fault_seam(phase)


@dataclasses.dataclass(frozen=True)
class IngestInfo:
    """Side-band observations of one ingest (per batch, not cumulative:
    the cumulative counters live on the state)."""

    batch_rows: int
    lonely_rows_per_block: Tuple[int, ...]
    lonely_rows: int
    repaired_rows: int


def _repaired_count(blocks, lonely_total: int) -> int:
    """Exact number of side-band repairs the checker made on this batch.

    Sparse blocks carry the repair mask explicitly; dense blocks were
    repaired in place, so the count is lonely-before minus lonely-after.
    """
    if isinstance(blocks, sparse.RepairedSparseBlocks):
        return int(blocks.repair_mask.sum())
    still_lonely = ~(blocks != 0).any(dim=2)          # (D, m)
    return lonely_total - int(still_lonely.sum())


def _factor_batch(blocks, m_b: int, config, plan, seed: int,
                  omega: Optional[torch.Tensor]):
    """(U_b (m_b, r_b), P_b (n_pad, r_b)) of the repaired batch, per the
    plan's R5 strategy.  ``P_b = B^T U_b`` exactly: the batch's
    contribution to the merge panel, carrying the batch singular values
    implicitly and formed without dividing by them."""
    if plan.rank is None:
        # Exact: per-block gram stack (sparse-native E+R grams) + eigh,
        # truncated to the merge width r_b = min(m_b, k + oversample).
        with obs.span("gram_stack"):
            grams = lsvd.gram_stack(blocks, use_kernel=config.use_kernel)
        with obs.span("merge_grams_eigh"):
            u_b, _ = lsvd.merge_grams_eigh(grams)
        r_b = min(m_b, config.truncate_rank + config.oversample)
        u_b = u_b[:, :r_b]
        with obs.span("right_vectors_stack"):
            panel_b = ranky.right_vectors_stack(
                blocks, u_b, torch.ones((r_b,), dtype=torch.float32,
                                        device=u_b.device))   # B^T U_b
    else:
        # Randomized (k+p)-row sketch (the tall-batch regime).  The
        # sketch path's right vectors come from the sketch statistics
        # (G^T vproj), so V_b diag(s_b) is finite by construction.
        u_b, s_b, v_b = randomized.randomized_svd_blocks(
            blocks, rank=plan.rank, oversample=config.oversample,
            power_iters=config.power_iters, key=seed, want_right=True,
            omega=omega)
        panel_b = v_b * s_b[None, :]
    return u_b, panel_b


def _ingest_math(a_norm, seed: int, s: torch.Tensor, v: torch.Tensor, *,
                 d: int, m_b: int, config, plan, draws=None, omega=None):
    """The device math of one single-host ingest (repair, batch
    factorization, merge-and-truncate) WITHOUT the left-factor update
    (``u`` grows with rows_seen; rule R5's closed form excludes it)."""
    # Repair BEFORE factorization/truncation (the rank problem).
    with obs.span("split_and_repair"):
        blocks = ranky.split_and_repair(a_norm, d, config.method, seed,
                                        draws=draws)

    u_b, panel_b = _factor_batch(blocks, m_b, config, plan, seed, omega)
    _fire_seam("ingest.merge")

    # Merge-and-truncate: one panel SVD of [V diag(decay*s) | B^T U_b],
    # nothing bigger than (n_pad, k + r_b).
    p = torch.cat([v * (s * float(config.history_decay))[None, :], panel_b],
                  dim=1)
    k_new = min(config.truncate_rank, p.shape[1])
    v_new, s_new, uk = hierarchy.merge_svd(p, k_new)  # uk: (k_old+r_b, k_new)
    return blocks, u_b, v_new, s_new, uk


def ingest(
    state: StreamingSVDState,
    delta,
    config,
    plan,
    *,
    draws: Optional[ranky.RepairDraws] = None,
    omega: Optional[torch.Tensor] = None,
) -> Tuple[StreamingSVDState, IngestInfo]:
    """Fold one batch of new rows into the state (see module docstring).

    ``config`` is an ``api.SolveConfig`` with ``truncate_rank`` set;
    ``plan`` is the R5 plan from ``planner.make_stream_plan`` (its
    ``rank`` field is the batch-factorization decision: ``None`` = exact
    gram stack, ``r`` = randomized sketch of rank r).  ``draws`` /
    ``omega`` inject this batch's random inputs.  Returns
    ``(new_state, IngestInfo)`` on the state's device.
    """
    if plan.backend == "shard_map":
        return ingest_shard_map(state, delta, config, plan)
    _fire_seam("ingest.batch")
    with obs.span("as_delta"):
        a_norm = stream_state.as_delta(delta, state)
    m_b, _ = stream_state.delta_shape(delta)
    d = state.num_blocks

    # The seed chain: batch b always draws derive_seed(root, b), so a
    # replayed stream re-draws the same repair columns and sketch
    # matrices as the uninterrupted one.
    seed_b = ranky.derive_seed(state.seed, state.batches_seen)

    def math():
        return _ingest_math(a_norm, seed_b, state.s, state.v, d=d, m_b=m_b,
                            config=config, plan=plan, draws=draws,
                            omega=omega)

    with obs.span("ingest.batch", rows=m_b, backend="single"):
        if obs.enabled():
            # R5 drift: the first ingest of each batch shape is measured
            # on the card (peak allocated above what was live before it)
            # against the plan's closed form.
            blocks, u_b, v_new, s_new, uk = obs.observe_call(
                "R5", math, plan.estimated_peak_bytes, device=state.device,
                component="temp", label="single",
                shape_key=obs.drift.shape_key(a_norm, state.s, state.v))
        else:
            blocks, u_b, v_new, s_new, uk = math()
        k_old = state.rank
        with obs.span("u_update"):
            u_new = torch.cat([state.u @ uk[:k_old], u_b @ uk[k_old:]],
                              dim=0)
    obs.counter_add("ingest_batches_total")
    obs.counter_add("ingest_rows_total", float(m_b))

    # Side-band diagnostics LAST: the device-to-host reads happen only
    # after the whole factor/merge pipeline is enqueued.
    with obs.span("diagnostics"):
        lonely_pb = ranky.lonely_rows_per_block(a_norm, d)
        lonely_total = sum(lonely_pb)
        repaired = _repaired_count(blocks, lonely_total)

    new_state = StreamingSVDState(
        u=u_new, s=s_new, v=v_new, seed=state.seed,
        n=state.n, num_blocks=d,
        rows_seen=state.rows_seen + m_b,
        batches_seen=state.batches_seen + 1,
        lonely_rows_seen=state.lonely_rows_seen + lonely_total,
        repaired_rows_seen=state.repaired_rows_seen + repaired)
    info = IngestInfo(
        batch_rows=m_b, lonely_rows_per_block=lonely_pb,
        lonely_rows=lonely_total, repaired_rows=repaired)
    return new_state, info


def ingest_shard_map(state, delta, config, plan):
    """The distributed twin of :func:`ingest` (rule R5d): not ported yet."""
    raise NotImplementedError(
        "the sharded streaming ingest (plan.backend='shard_map', rule R5d) "
        "is not ported yet: ROADMAP.md Queue A item 8 "
        "(core/distributed.py); use stream_backend='single'")
