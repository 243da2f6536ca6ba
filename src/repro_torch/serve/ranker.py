"""Batched latent-factor top-k retrieval over a :class:`ServingSnapshot`.

The query path of the recommender front end: a batch of factor-space
queries ``q`` (B, k) scores every item as ``q . diag(s) V^T`` and keeps
the top ``k_top``; the kernel (``kernels/topk_score.py``) never writes the
(B, N) score matrix to device memory.  One call covers the whole
(n_pad, k) factor matrix, ``valid_n`` masking the block padding.

The int8 path scores ``(q . v_q[j]) * scale[j]``: the per-item kvquant
scale folds into the contraction, no dequantized factor matrix is ever
resident.  Raw interaction rows project into factor space through
``V diag(1/s)`` (:func:`project_rows`).

The sharded ranker (``sharded=True``, a snapshot of a state sharded over
the stream mesh): each slot scores its (W, k) slice of ``v`` with its
global column offset (``index_offset = d * W``, ``valid_n`` its columns
below n), one kernel launch a slot; the (B, k_top) winners are gathered
slot-major and merged with one stable sort, so ties still go to the
lowest global index and the answer is bit-identical to the dense path's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.kernels import ops as kops
from repro_torch.kernels import topk_score as tk
from repro_torch.serve.snapshot import ServingSnapshot


@dataclasses.dataclass(frozen=True)
class TopKResult:
    """One answered request wave: per-query item ids + scores, stamped
    with the snapshot version that produced them (freshness audit)."""

    scores: torch.Tensor   # (B, k_top) f32, descending
    indices: torch.Tensor  # (B, k_top) i32 global item ids
    version: int


def fold_queries(snapshot: ServingSnapshot,
                 queries: torch.Tensor) -> torch.Tensor:
    """(B, k) factor-space queries -> ``q * s`` (diag(s) folded in)."""
    return (queries.to(torch.float32)
            * snapshot.s.to(torch.float32)[None, :])


def project_rows(snapshot: ServingSnapshot,
                 rows: torch.Tensor) -> torch.Tensor:
    """(B, n) raw interaction rows -> (B, k) queries via ``V diag(1/s)``.

    A user's fresh interaction vector lands in the same factor space as
    ``u`` rows: ``a_b V diag(1/s)`` (the row-factor identity
    ``U = A V diag(1/s)``).  On the int8 snapshot the per-item scale
    folds into the rows: the f32 factor matrix is never materialized.
    Trailing padding rows of ``v`` meet zero-padded row entries.  The
    product is a plain ``torch.matmul``.
    """
    rows = torch.as_tensor(rows).to(device=snapshot.device,
                                    dtype=torch.float32)
    if rows.shape[1] != snapshot.n:
        raise ValueError(
            f"rows have {rows.shape[1]} columns but the snapshot's "
            f"universe has n={snapshot.n}")
    if snapshot.quantized:
        n_pad = snapshot.v_q.shape[0]
        rows = torch.nn.functional.pad(rows, (0, n_pad - snapshot.n))
        scaled = rows * snapshot.v_scale[:, 0][None, :]
        proj = scaled @ snapshot.v_q.to(torch.float32)
    else:
        n_pad = snapshot.v.shape[0]
        rows = torch.nn.functional.pad(rows, (0, n_pad - snapshot.n))
        proj = rows @ snapshot.v
    return proj / snapshot.s.to(torch.float32)[None, :]


def user_queries(snapshot: ServingSnapshot, row_ids) -> torch.Tensor:
    """Known-user queries: the stored ``u`` rows for ``row_ids``."""
    if snapshot.u_rows is None:
        raise ValueError(
            "snapshot has no u_rows: build it with keep_u=True for "
            "user-id lookups")
    idx = torch.as_tensor(row_ids, dtype=torch.int64,
                          device=snapshot.u_rows.device)
    return snapshot.u_rows[idx]


def _factor_pair(
    snapshot: ServingSnapshot,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(factor matrix, per-item scale or None) for the score contraction."""
    if snapshot.quantized:
        return snapshot.v_q, snapshot.v_scale[:, 0]
    return snapshot.v, None


def _local_topk(qs, v, k_top, *, scale, valid_n, index_offset, block_n,
                use_kernel):
    """The fused top-k; ``use_kernel=False`` runs the plain version on the
    device (the full score matrix) that planner rule R7 prices as
    ``serve_fallback_bytes``."""
    if not use_kernel:
        return tk.topk_score_ref(qs, v, k_top, scale=scale,
                                 valid_n=valid_n, index_offset=index_offset)
    return kops.topk_score(qs, v, k_top, scale=scale, valid_n=valid_n,
                           index_offset=index_offset, block_n=block_n)


def _sharded_topk(snapshot: ServingSnapshot, qs, factors, scale, k_top, *,
                  block_n, use_kernel):
    """Each local slot's fused top-k over its (W, k) slice, with its
    global offset and valid columns; the (B, k_top) winners all-gathered
    slot-major, then one stable merge: ties to the lowest global index."""
    mesh, w, n = snapshot.mesh, snapshot.width, snapshot.n
    vals, idx = [], []
    for i, d in enumerate(mesh.local_slots):
        off = d * w
        rows = slice(i * w, (i + 1) * w)
        v_i, i_i = _local_topk(
            qs, factors[rows], k_top,
            scale=None if scale is None else scale[rows],
            valid_n=max(0, min(w, n - off)), index_offset=off,
            block_n=block_n, use_kernel=use_kernel)
        vals.append(v_i)
        idx.append(i_i)
    b = qs.shape[0]
    cand_v = mesh.all_gather(torch.stack(vals))[0]        # (D, B, k_top)
    cand_i = mesh.all_gather(torch.stack(idx))[0]
    cand_v = cand_v.transpose(0, 1).reshape(b, -1)
    cand_i = cand_i.transpose(0, 1).reshape(b, -1)
    fv, pos = torch.sort(cand_v, dim=1, descending=True, stable=True)
    return (fv[:, :k_top].contiguous(),
            torch.gather(cand_i, 1, pos[:, :k_top]))


def check_wave(queries: torch.Tensor, rank: int,
               max_batch: Optional[int] = None) -> None:
    """Raise ``ValueError`` unless ``queries`` is a (B, rank) wave of at
    most ``max_batch`` rows (the wave width a serving plan priced)."""
    shape = queries.shape
    if len(shape) == 2 and max_batch is not None and shape[0] > max_batch:
        raise ValueError(
            f"wave of {shape[0]} queries exceeds the planned "
            f"batch_size={max_batch}; split the wave or serve_init "
            f"with a larger batch_size")
    if len(shape) != 2 or shape[1] != rank:
        raise ValueError(
            f"queries must be (B, {rank}) factor-space rows, got "
            f"{tuple(shape)}")


def score_topk(
    snapshot: ServingSnapshot,
    queries: torch.Tensor,
    k_top: int,
    *,
    block_n: int = 512,
    sharded: bool = False,
    use_kernel: bool = True,
    plan_bytes: Optional[int] = None,
    max_batch: Optional[int] = None,
) -> TopKResult:
    """Answer one request wave: top ``k_top`` items per query row.

    ``queries`` are factor-space rows (B, k): use :func:`project_rows`
    for raw interaction deltas or :func:`user_queries` for known users.
    They are moved to the snapshot's device; ``max_batch`` caps B
    (``check_wave``).

    ``plan_bytes`` (the R7 closed-form estimate, threaded down by
    ``api.serve_topk``) arms the drift monitor when observability is
    on: the first wave of each shape is measured on the card (its peak
    plus the resident snapshot factors and folded queries) and recorded
    as the ``drift_ratio{rule="R7"}`` gauge.
    """
    if sharded and snapshot.mesh is None:
        raise ValueError(
            "sharded=True needs a snapshot of a sharded state (serve_init "
            "with serve_backend='shard_map' over the stream mesh)")
    queries = torch.as_tensor(queries).to(snapshot.device)
    check_wave(queries, snapshot.rank, max_batch)
    if not 0 < k_top <= snapshot.n:
        raise ValueError(
            f"k_top={k_top} must be in (0, n={snapshot.n}]")
    qs = fold_queries(snapshot, queries)
    factors, scale = _factor_pair(snapshot)
    if factors.is_cuda:
        # The snapshot may have been made on an ingest thread's stream:
        # its memory must not be handed out again there while this wave
        # still reads it.
        stream = torch.cuda.current_stream(factors.device)
        for t in (factors, scale, snapshot.s):
            if t is not None:
                t.record_stream(stream)
    def wave():
        if sharded:
            return _sharded_topk(snapshot, qs, factors, scale, k_top,
                                 block_n=block_n, use_kernel=use_kernel)
        return _local_topk(
            qs, factors, k_top,
            scale=scale, valid_n=snapshot.n, index_offset=0,
            block_n=block_n, use_kernel=use_kernel)

    if plan_bytes is not None and obs.enabled():
        # A sharded wave is priced per device: each rank against the form,
        # a local mesh (its D slots on one card) against D times it.
        n_local = snapshot.mesh.n_local if sharded else 1
        label = ("local" if n_local > 1 else "shard_map") if sharded \
            else "dense"
        vals, idx = obs.observe_call(
            "R7", wave, plan_bytes * n_local, device=factors.device,
            component="total", label=label,
            shape_key=obs.drift.shape_key(qs, factors, scale),
            resident=(qs, factors, scale, snapshot.s))
    else:
        vals, idx = wave()
    return TopKResult(vals, idx, snapshot.version)
