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

The distributed engine :func:`ingest_shard_map` (rule R5d) runs the same
four steps over the stream mesh (``stream.state.stream_mesh``): each slot
repairs and factors its column block of the batch (block d draws what
``split_and_repair`` hands block d, so the repaired batch equals the
single-host one bit for bit), the batch gram or sketch statistics are
psummed, and the merge never forms the (N_pad, k + r_b) panel on one
device: the psummed (k_tot, k_tot) panel gram is eigh'd once and each slot
rotates its (W, k_tot) slice (:func:`_merge_truncate_local`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.core import distributed, hierarchy, randomized, ranky
from repro_torch.core import sparse
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
                  omega: Optional[torch.Tensor], v: torch.Tensor,
                  s_dec: torch.Tensor):
    """Factor the repaired batch per the plan's R5 strategy: ``(U_b (m_b,
    r_b), p)``, ``p`` the merge panel ``[V diag(s_dec) | P_b]``
    (:func:`merge_panel`) with ``P_b = B^T U_b`` written into its last r_b
    columns.  ``P_b`` is the batch's contribution to the merge, carrying
    the batch singular values implicitly and formed without dividing by
    them.  The panel is allocated once the factorization's own buffers are
    freed."""
    k = v.shape[-1]
    if plan.rank is None:
        # Exact: per-block gram stack (sparse-native E+R grams) + eigh,
        # truncated to the merge width r_b = min(m_b, k + oversample).
        with obs.span("gram_stack"):
            grams = lsvd.gram_stack(blocks, use_kernel=lsvd.resolve_use_kernel(
                config.use_kernel, v.device))
        with obs.span("merge_grams_eigh"):
            u_b, _ = lsvd.merge_grams_eigh(grams)
        del grams
        r_b = min(m_b, config.truncate_rank + config.oversample)
        u_b = u_b[:, :r_b]
        p = merge_panel(v, s_dec, r_b)
        with obs.span("right_vectors_stack"):
            ranky.right_vectors_stack(
                blocks, u_b, torch.ones((r_b,), dtype=torch.float32,
                                        device=u_b.device),
                out=p[:, k:])                                  # B^T U_b
    else:
        # Randomized (k+p)-row sketch (the tall-batch regime).  The
        # sketch path's right vectors come from the sketch statistics
        # (G^T vproj), so V_b diag(s_b) is finite by construction.
        u_b, s_b, v_b = randomized.randomized_svd_blocks(
            blocks, rank=plan.rank, oversample=config.oversample,
            power_iters=config.power_iters, key=seed, want_right=True,
            omega=omega)
        p = merge_panel(v, s_dec, v_b.shape[1])
        torch.mul(v_b, s_b[None, :], out=p[:, k:])
    return u_b, p


def merge_panel(v: torch.Tensor, s_dec: torch.Tensor, r_b: int
                ) -> torch.Tensor:
    """The (rows, k + r_b) merge panel ``[V diag(s_dec) | (batch part)]``,
    its first k columns written here; the batch writes the rest into
    ``p[..., k:]``.  One buffer, where a concatenation of two parts would
    hold the batch's part twice."""
    k = v.shape[-1]
    p = torch.empty(v.shape[:-1] + (k + r_b,), dtype=v.dtype,
                    device=v.device)
    torch.mul(v, s_dec, out=p[..., :k])
    return p


def _ingest_math(a_norm, seed: int, s: torch.Tensor, v: torch.Tensor, *,
                 d: int, m_b: int, config, plan, draws=None, omega=None):
    """The device math of one single-host ingest (repair, batch
    factorization, merge-and-truncate) WITHOUT the left-factor update
    (``u`` grows with rows_seen; rule R5's closed form excludes it)."""
    # Repair BEFORE factorization/truncation (the rank problem).
    with obs.span("split_and_repair"):
        blocks = ranky.split_and_repair(a_norm, d, config.method, seed,
                                        draws=draws)
    u_b, p = _factor_batch(blocks, m_b, config, plan, seed, omega, v,
                           s * float(config.history_decay))
    _fire_seam("ingest.merge")

    # Merge-and-truncate: one panel SVD of [V diag(decay*s) | B^T U_b],
    # nothing bigger than (n_pad, k + r_b).
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
        return ingest_shard_map(state, delta, config, plan, draws=draws,
                                omega=omega)
    if state.mesh is not None:
        state = stream_state.gather_state(state)
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


# ---------------------------------------------------------------------------
# The sharded engine (plan.backend == "shard_map", planner rule R5d)
# ---------------------------------------------------------------------------

def _merge_truncate_local(p_d: torch.Tensor, mesh, k_new: int):
    """Per-slot tail of the merge-and-truncate: from the local slots'
    (n_local, W, k_tot) panel slices, psum the (k_tot, k_tot) panel Gram,
    eigh it ONCE, and apply the small rotation locally.

    ``P = V' diag(s') W^T`` means ``P^T P = W diag(s'^2) W^T``, so the
    eigh of the psummed Gram yields the rotation ``W`` and the new singular
    values without any slot touching the (N_pad, k_tot) panel; the new
    ``v`` slices are ``P_d W diag(1/s')`` with a floor-masked inverse
    (rank-deficient merge directions get zero columns instead of noise:
    they carry zero weight into every later merge, like the single-host
    SVD's arbitrary null-space columns).  Returns (s_new (k_new,), w
    (k_tot, k_new): the ``uk`` rotation of ``hierarchy.merge_svd``, and
    v_new (n_local, W, k_new))."""
    k_tot = p_d.shape[-1]
    with obs.span("merge.gram", r_tot=k_tot, rank=k_new):
        g = mesh.psum(p_d.mT @ p_d)[0]                 # (k_tot, k_tot)
        evals, evecs = torch.linalg.eigh(g)            # ascending
    evals = torch.flip(evals, dims=(-1,))
    evecs = torch.flip(evecs, dims=(-1,))
    s_all = torch.sqrt(torch.clamp(evals, min=0.0))
    floor = torch.finfo(g.dtype).eps * torch.max(evals) * k_tot
    good = evals[:k_new] > floor
    inv = torch.where(good, 1.0 / torch.where(good, s_all[:k_new],
                                              torch.ones_like(s_all[:k_new])),
                      torch.zeros_like(s_all[:k_new]))
    w = evecs[:, :k_new]
    return s_all[:k_new], w, p_d @ (w * inv[None, :])


def shard_step(kind: str, local, mesh, *, m: int, width: int, config,
               r_b: int, k_new: int, sk_rank: Optional[int], seed: int,
               v_d: torch.Tensor, s_dec: torch.Tensor,
               valid: Optional[torch.Tensor] = None, draws=None, omega=None):
    """One batch folded into the sharded state, over the local slots:
    repair (``distributed``'s shard repair, on this batch's seed), mask
    the padded rows (``valid``, the window's), factor (psummed gram +
    eigh, or the sketch over the mesh), merge (:func:`_merge_truncate_local`).

    ``local`` is the (n_local, m, W) dense stack of the batch's blocks or a
    BlockEll of them; ``v_d`` (n_local, W, k) the state's slices and
    ``s_dec`` its decayed singular values.  Returns ``(u_b, s_new, w,
    v_new (n_local, W, k_new), lonely (n_local,), repaired)``, the counts
    as device tensors (lonely per local block, repaired summed over the
    mesh)."""
    axes = mesh.axis_names
    with obs.span("split_and_repair"):
        if kind == "dense":
            lonely = ~(local != 0).any(dim=2)
            blocks = distributed._local_repair(local, mesh, axes,
                                               config.method, seed, draws)
            if valid is not None:
                lonely &= valid[None, :]
                blocks.masked_fill_(~valid[None, :, None], 0.0)
            still = ~(blocks != 0).any(dim=2)
            if valid is not None:
                still &= valid[None, :]
            lonely_d = lonely.sum(dim=1)
            repaired = mesh.psum(lonely_d - still.sum(dim=1))[0]
        else:
            rep = distributed._sparse_local_repair(local, mesh, axes,
                                                   config.method, seed,
                                                   draws)
            lonely = ranky.sparse_lonely_rows(local.col_rows, local.col_vals,
                                              m)
            rm = rep.repair_mask
            if valid is not None:
                lonely &= valid[None, :]
                rm = rm & valid[None, :]
            blocks = sparse.RepairedSparseBlocks(local, rep.repair_cols, rm)
            lonely_d = lonely.sum(dim=1)
            repaired = mesh.psum(rm.sum(dim=1))[0]

    k = v_d.shape[-1]
    if sk_rank is None:
        with obs.span("gram_stack"):
            g = mesh.psum(lsvd.gram_stack(
                blocks, use_kernel=lsvd.resolve_use_kernel(
                    config.use_kernel, v_d.device)))[0]
        with obs.span("merge_grams_eigh"):
            u_b, _ = lsvd.eigh_to_svd(g)
        del g
        u_b = u_b[:, :r_b]
        p_d = merge_panel(v_d, s_dec, r_b)
        with obs.span("right_vectors_stack"):
            ranky.right_vectors_stack(
                blocks, u_b, torch.ones((r_b,), dtype=torch.float32,
                                        device=u_b.device),
                out=_flat_cols(p_d, k))
    else:
        _, sketch, pullback = randomized._stack_ops(blocks, summed=False)
        u_b, s_b, v_b = randomized.randomized_tail_over(
            sketch, pullback, mesh, m, rank=sk_rank,
            oversample=config.oversample, power_iters=config.power_iters,
            key=seed, want_right=True, omega=omega)
        p_d = merge_panel(v_d, s_dec, v_b.shape[-1])
        torch.mul(v_b, s_b, out=p_d[..., k:])
    del blocks
    s_new, w, v_new = _merge_truncate_local(p_d, mesh, k_new)
    return u_b, s_new, w, v_new, lonely_d, repaired


def _flat_cols(p_d: torch.Tensor, k: int) -> torch.Tensor:
    """The batch columns of an (n_local, W, k_tot) panel as the (n_local *
    W, r_b) rows that ``right_vectors_stack`` writes (a view)."""
    n_local, w, k_tot = p_d.shape
    return p_d.view(n_local * w, k_tot)[:, k:]


def local_batch(a_norm, mesh, num_blocks: int):
    """The local slots' blocks of a normalized batch (dense (m, n_pad)
    rows or a BlockEll): ``(kind, local)``."""
    kind = "ell" if isinstance(a_norm, sparse.BlockEll) else "dense"
    return kind, distributed.local_blocks(a_norm, mesh, num_blocks)


def ingest_shard_map(
    state: StreamingSVDState,
    delta,
    config,
    plan,
    *,
    draws: Optional[ranky.RepairDraws] = None,
    omega: Optional[torch.Tensor] = None,
    mesh=None,
) -> Tuple[StreamingSVDState, IngestInfo]:
    """The distributed twin of :func:`ingest` (rule R5d): the same four
    steps over the stream mesh (``mesh``, else the state's, else
    ``stream_state.stream_mesh``).  The repaired batch is bit-identical to
    the single-host engine's (same per-block seeds, same global adjacency),
    and the factors agree with the single-host result up to reduction-order
    float error and column signs.  Returns the state sharded over the
    mesh."""
    d = state.num_blocks
    mesh = mesh if mesh is not None else state.mesh
    if mesh is None:
        if stream_state.stream_device_count() < d:
            raise ValueError(
                f"plan.backend='shard_map' needs one device per column "
                f"block: num_blocks={d} but only "
                f"{stream_state.stream_device_count()} healthy device(s)")
        mesh = stream_state.stream_mesh(d)
    state = stream_state.shard_state(state, mesh)
    _fire_seam("ingest.batch")
    with obs.span("as_delta"):
        a_norm = stream_state.as_delta(delta, state)
    m_b, _ = stream_state.delta_shape(delta)
    seed_b = ranky.derive_seed(state.seed, state.batches_seen)

    k_old = state.rank
    r_b = (min(m_b, config.truncate_rank + config.oversample)
           if plan.rank is None else plan.rank)
    k_new = min(config.truncate_rank, k_old + r_b)
    w = state.width
    kind, local = local_batch(a_norm, mesh, d)
    v_d = state.v.view(mesh.n_local, w, k_old)
    s_dec = state.s * float(config.history_decay)

    def math():
        return shard_step(kind, local, mesh, m=m_b, width=w, config=config,
                          r_b=r_b, k_new=k_new, sk_rank=plan.rank,
                          seed=seed_b, v_d=v_d, s_dec=s_dec, draws=draws,
                          omega=omega)

    # The merge seam brackets the sharded step, as the reference's does
    # its compiled region.
    _fire_seam("ingest.merge")
    with obs.span("ingest.batch", rows=m_b, backend="shard_map"):
        if obs.enabled():
            # R5d drift: each rank against the per-device closed form; a
            # local mesh holds the D slots' working sets on one card, so
            # it is held to D times that form, labelled "local".
            local_mesh = mesh.n_local > 1
            u_b, s_new, uk, v_new, _, repaired = obs.observe_call(
                "R5d", math, plan.estimated_peak_bytes * mesh.n_local,
                device=state.device, component="temp",
                label="local" if local_mesh else "shard_map",
                shape_key=obs.drift.shape_key(a_norm, state.s, state.v))
        else:
            u_b, s_new, uk, v_new, _, repaired = math()
        # The left-factor update stays outside the sharded step: u is in
        # ingestion order and only the small (k_tot, k_new) rotation ever
        # touches it.
        with obs.span("u_update"):
            u_new = torch.cat([state.u @ uk[:k_old], u_b @ uk[k_old:]],
                              dim=0)
    obs.counter_add("ingest_batches_total")
    obs.counter_add("ingest_rows_total", float(m_b))

    with obs.span("diagnostics"):
        lonely_pb = ranky.lonely_rows_per_block(a_norm, d)
        lonely_total = sum(lonely_pb)
        repaired = int(repaired)
    new_state = StreamingSVDState(
        u=u_new, s=s_new, v=v_new.reshape(mesh.n_local * w, k_new),
        seed=state.seed, n=state.n, num_blocks=d,
        rows_seen=state.rows_seen + m_b,
        batches_seen=state.batches_seen + 1,
        lonely_rows_seen=state.lonely_rows_seen + lonely_total,
        repaired_rows_seen=state.repaired_rows_seen + repaired,
        mesh=mesh)
    info = IngestInfo(
        batch_rows=m_b, lonely_rows_per_block=lonely_pb,
        lonely_rows=lonely_total, repaired_rows=repaired)
    return new_state, info
