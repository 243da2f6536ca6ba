"""Distributed randomized truncated rank-k SVD (the tall-row regime).

Every exact Ranky path recovers (U, S) through an M x M gram (or an
M x (D*M) proxy) plus a dense eigh/SVD: O(M^2 * nnz/M) compute and
O(M^3) factorization, which hard-caps the row dimension far below
production scale.  Following Li, Kluger & Tygert ("Randomized
algorithms for distributed computation of PCA and SVD"), this module
computes the top-k factorization from an (k+p)-row sketch instead:

  L = k + p (oversampled),  Omega ~ N(0, 1) of shape (L, M)
  G   = Omega @ A                      per column block, O(nnz * L)
  repeat q times (power iteration, re-orthonormalized):
      T = G @ A^T  (sum over blocks)   (L, M)
      Q = qr(T^T).Q                    (M, L), the only M-sized QR
      G = Q^T @ A                      per column block
  T = G @ A^T (sum),  H = G @ G^T (sum, (L, L))
  whiten H (eigh, floor-masked)  ->  Vtilde = G^T @ W orthonormal
  B = A @ Vtilde = T^T @ W (M, L);  svd(B) -> top-k (U, S, V)

Nothing bigger than (L, M) is ever reduced across blocks and the only
dense factorizations are (M, L) QR/SVD and an (L, L) eigh, so M can grow
to hundreds of thousands of rows.  Because G = Omega @ A sketches through
A itself, every pass applies one extra power of A A^T for free.

Per sparse block the contractions are gather/scatter index algebra over
the padded-ELL arrays: ``kernels.ops.sketch_panel`` for Omega @ E (the
hand-written kernel on the GPU, O(nnz * L)) plus the <=1-entry-per-row
repair side-band terms; a block is never densified to (M, W).  Every sum
that more than one non-zero term reaches (a row of the pullback, a column
that several repairs hit) runs in a fixed order (``sparse.segment_sum``),
never through float atomics, so a solve gives the same bits on every run.

Rank repair runs BEFORE sketching (the shared split_and_repair
prologue): a rank-deficient block leaves lonely rows with no weight in
the sketch, so the components repair would have created are truncated
away unrecoverably.

``randomized_tail_over`` (the same loop with collectives over a mesh)
belongs to the distributed slice and is not here yet.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import sparse
from repro_torch.core.ranky import Key, _generator, derive_seed, seed_of
from repro_torch.core.stages import stage

# Seed tag of the test matrix: every solver derives the identical Omega
# for a given key.
_SKETCH_TAG = 0x5EED


def sketch_width(rank: int, oversample: int, m: int) -> int:
    """L = min(rank + oversample, M), validating the requested rank."""
    if rank < 1 or rank > m:
        raise ValueError(f"rank={rank} must be in [1, M={m}]")
    if oversample < 0:
        raise ValueError(f"oversample={oversample} must be >= 0")
    return min(rank + oversample, m)


def draw_omega(key: Key, l: int, m: int, *, device="cpu") -> torch.Tensor:
    """(L, M) gaussian test matrix, identical for a given key on every
    device (drawn on the host from a generator seeded with the key and the
    sketch tag, then moved)."""
    gen = _generator(derive_seed(seed_of(key), _SKETCH_TAG))
    return torch.randn((l, m), generator=gen, dtype=torch.float32).to(device)


# ---------------------------------------------------------------------------
# Per-block contractions (dense twin is the oracle for the sparse one)
# ---------------------------------------------------------------------------

def sketch_block_dense(omega: torch.Tensor, blk: torch.Tensor) -> torch.Tensor:
    """(L, M) @ (M, W) -> (L, W): the dense-twin sketch of one block."""
    return omega @ blk.to(torch.float32)


def pullback_block_dense(g: torch.Tensor, blk: torch.Tensor) -> torch.Tensor:
    """(L, W) @ (W, M) -> (L, M): G_d @ B_d^T (summed over blocks by the
    caller)."""
    return g @ blk.to(torch.float32).T


def repair_col_segments(blocks: "sparse.RepairedSparseBlocks"):
    """``sparse.sorted_segments`` of every block's repaired rows by the
    column they land on, over the D * W columns of the stack (the repair
    side-band of the sketch; the same for every pass of a solve)."""
    ell = blocks.ell
    d, w = ell.num_blocks, ell.width
    base = torch.arange(d, device=ell.device)[:, None] * w
    keys = torch.where(blocks.repair_mask,
                       blocks.repair_cols.long() + base, d * w)
    return sparse.sorted_segments(keys.reshape(-1), d * w)


def sketch_stack_sparse(omega: torch.Tensor,
                        blocks: "sparse.RepairedSparseBlocks", *,
                        repair_segments=None) -> torch.Tensor:
    """Sparse-native Omega_d @ (E_d + R_d) for every repaired block ->
    (D, L, W), with ONE sketch_panel launch over the stack.  ``omega`` is
    one (L, M) test matrix for every block or a (D, L, M) stack.

    E part: the (D, L, C) stored-column panels (kernels.ops.sketch_panel)
    scattered to local column ids; the live columns' ids are distinct and
    padding columns add exact zeros, so the scatter gives the same bits in
    any order.  R part: row r contributes omega_d[:, r] at column
    repair_cols[d, r] iff repair_mask[d, r]; the rows that share a column
    are summed in row order (``repair_segments``, from
    :func:`repair_col_segments`, which this computes when not given).  Both
    are O(nnz * L); the (M, W) block is never materialized.
    """
    from repro_torch.kernels import ops as kops

    ell = blocks.ell
    d, w, m = ell.num_blocks, ell.width, ell.m
    l = omega.shape[-2]
    panel = kops.sketch_panel(omega, ell.col_rows, ell.col_vals)  # (D, L, C)
    g = torch.zeros((d, l, w), dtype=torch.float32, device=omega.device)
    g.scatter_add_(2, ell.col_ids.long()[:, None, :].expand_as(panel), panel)
    order, offsets = (repair_col_segments(blocks) if repair_segments is None
                      else repair_segments)
    rows = omega.mT.expand(d, m, l).reshape(d * m, l)      # row r of block d
    hit = sparse.segment_sum(rows[order], offsets)          # (D * W, L)
    return g + hit.view(d, w, l).transpose(1, 2)


def sketch_block_sparse(
    omega: torch.Tensor,
    col_ids: torch.Tensor,
    col_rows: torch.Tensor,
    col_vals: torch.Tensor,
    repair_cols: torch.Tensor,
    repair_mask: torch.Tensor,
    width: int,
) -> torch.Tensor:
    """Sparse-native Omega @ (E + R) for one repaired block -> (L, W)
    (:func:`sketch_stack_sparse` on a stack of one)."""
    ell = sparse.BlockEll(col_ids[None], col_rows[None], col_vals[None],
                          m=omega.shape[1], width=width, n=width)
    one = sparse.RepairedSparseBlocks(ell, repair_cols[None],
                                      repair_mask[None])
    return sketch_stack_sparse(omega, one)[0]


def slot_row_segments(col_rows: torch.Tensor, col_vals: torch.Tensor,
                      m: int):
    """``sparse.sorted_segments`` of one block's non-zero ELL slots by row,
    over its M rows (padding slots go nowhere): the row index of the
    pullback, the same for every pass of a solve."""
    keys = torch.where(col_vals != 0, col_rows.long(), m)
    return sparse.sorted_segments(keys.reshape(-1), m)


def pullback_block_sparse(
    g: torch.Tensor,
    col_ids: torch.Tensor,
    col_rows: torch.Tensor,
    col_vals: torch.Tensor,
    repair_cols: torch.Tensor,
    repair_mask: torch.Tensor,
    m: int,
    *,
    row_segments=None,
) -> torch.Tensor:
    """Sparse-native G_d @ (E + R)^T for one repaired block -> (L, M).

    E part: T[:, r] sums G[:, col_ids[c]] * vals[c, k] over the slots
    (c, k) that name row r, in ascending slot order: the slots sorted by
    row (``row_segments``, from :func:`slot_row_segments`, which this
    computes when not given) and each row's run summed in order, so the
    result is the same bits on every call.  R part: T[l, r] += mask_r *
    G[l, c_r].
    """
    k = col_rows.shape[-1]
    order, offsets = (slot_row_segments(col_rows, col_vals, m)
                      if row_segments is None else row_segments)
    terms = (g.T.contiguous().index_select(0, col_ids.long()[order // k])
             * col_vals.reshape(-1)[order][:, None])       # (C K, L) by row
    t = sparse.segment_sum(terms, offsets)                 # (M, L)
    rmask = repair_mask.to(torch.float32)
    return t.T + g.index_select(1, repair_cols.long()) * rmask[None, :]


# ---------------------------------------------------------------------------
# The (k+p)-sized tail factorization (shared by all solvers)
# ---------------------------------------------------------------------------

def truncate_sketch(
    t: torch.Tensor, h: torch.Tensor, rank: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k factorization from the reduced sketch statistics.

    t = G @ A^T (L, M), h = G @ G^T (L, L), both already summed over
    blocks.  Whitens the sketch rows through a floor-masked eigh of h
    (rank-deficient sketch directions are dropped, not inverted), so
    Vtilde = G^T @ w has orthonormal columns and B = A @ Vtilde = t^T @ w.
    Returns (U (M, k), S (k,), vproj (L, k)) where a block's slice of the
    right vectors is V_d = G_d^T @ vproj.  A leading batch axis on ``t``
    and ``h`` factors every sketch of the batch apart (the hierarchical
    tree's per-block leaves).
    """
    l = h.shape[-1]
    evals, evecs = torch.linalg.eigh(h)               # ascending
    floor = (torch.finfo(h.dtype).eps
             * torch.amax(evals, dim=-1, keepdim=True) * l)
    good = evals > floor
    inv_sqrt = torch.where(
        good, 1.0 / torch.sqrt(torch.where(good, evals,
                                           torch.ones_like(evals))),
        torch.zeros_like(evals))
    w = evecs * inv_sqrt[..., None, :]                # (L, L)
    b = t.mT @ w                                      # (M, L) = A @ Vtilde
    u_b, s, w_bt = torch.linalg.svd(b, full_matrices=False)
    return (u_b[..., :rank], s[..., :rank],
            w @ w_bt.mT[..., :rank])


def _range_finder(
    sketch: Callable[[torch.Tensor], torch.Tensor],
    pullback: Callable[[torch.Tensor], torch.Tensor],
    omega: torch.Tensor,
    power_iters: int,
):
    """The shared sketch loop: returns (G, T) after q re-orthonormalized
    power passes.  ``pullback`` must already include the cross-block
    reduction; or it returns a (D, L, M) stack, one range finder a block,
    and the QR runs batched over the blocks."""
    def timed_sketch(om):
        with stage("sketch"):
            return sketch(om)

    def timed_pullback(g):
        with stage("pullback"):
            return pullback(g)

    g = timed_sketch(omega)
    for _ in range(power_iters):
        t = timed_pullback(g)                         # (L, M)
        with stage("qr"):
            q, _ = torch.linalg.qr(t.mT)              # (M, L) orthonormal
        g = timed_sketch(q.mT)
    return g, timed_pullback(g)


# ---------------------------------------------------------------------------
# Single-host solver (over a repaired block stack, either representation)
# ---------------------------------------------------------------------------

def _stack_ops(blocks, *, summed: bool = True):
    """(m, sketch, pullback) of a repaired block stack: ``sketch`` maps
    an (L, M) Omega, or a (D, L, M) stack of them, to (D, L, W);
    ``pullback`` maps (D, L, W) -> (L, M) summed over blocks, or with
    ``summed=False`` the (D, L, M) stack of each block's own.  The sparse
    side runs one block at a time (its (C K, L) intermediate is per block),
    through row and repair indexes sorted once here for every pass."""
    if isinstance(blocks, sparse.RepairedSparseBlocks):
        ell = blocks.ell
        rep_seg = repair_col_segments(blocks)
        row_seg = [slot_row_segments(ell.col_rows[d], ell.col_vals[d], ell.m)
                   for d in range(ell.num_blocks)]

        def sketch(om):
            return sketch_stack_sparse(om, blocks, repair_segments=rep_seg)

        def one(g, d):
            return pullback_block_sparse(
                g[d], ell.col_ids[d], ell.col_rows[d], ell.col_vals[d],
                blocks.repair_cols[d], blocks.repair_mask[d], ell.m,
                row_segments=row_seg[d])

        def pullback(g):
            if not summed:
                return torch.stack([one(g, d)
                                    for d in range(ell.num_blocks)])
            t = one(g, 0)
            for d in range(1, ell.num_blocks):
                t += one(g, d)
            return t

        return ell.m, sketch, pullback

    b32 = blocks.to(torch.float32)

    def sketch(om):
        return torch.einsum("lm,dmw->dlw" if om.dim() == 2 else
                            "dlm,dmw->dlw", om, b32)

    def pullback(g):
        return torch.einsum("dlw,dmw->lm" if summed else "dlw,dmw->dlm",
                            g, b32)

    return blocks.shape[1], sketch, pullback


def randomized_svd_blocks(
    blocks,
    *,
    rank: int,
    oversample: int = 8,
    power_iters: int = 2,
    key: Key = None,
    want_right: bool = False,
    omega: Optional[torch.Tensor] = None,
):
    """Top-k (U, S[, V]) of a repaired block stack: dense (D, M, W)
    tensor or sparse.RepairedSparseBlocks (sparse-native, the dense stack
    is the oracle twin).  V, when requested, is (D*W, k) in padded
    column order (zero-pad columns carry zero rows).  ``omega`` injects
    the (L, M) test matrix; otherwise it is drawn from ``key``."""
    m, sketch, pullback = _stack_ops(blocks)
    l = sketch_width(rank, oversample, m)
    if omega is None:
        dev = (blocks.ell.device
               if isinstance(blocks, sparse.RepairedSparseBlocks)
               else blocks.device)
        omega = draw_omega(key, l, m, device=dev)
    elif tuple(omega.shape) != (l, m):
        raise ValueError(
            f"omega has shape {tuple(omega.shape)}, want (L, M) = ({l}, {m})")
    g, t = _range_finder(sketch, pullback, omega, power_iters)
    with stage("sketch_gram"):
        h = torch.einsum("dlw,dkw->lk", g, g)
    with stage("truncate_sketch"):
        u, s, vproj = truncate_sketch(t, h, rank)
    if not want_right:
        return u, s
    with stage("right_vectors"):
        v = torch.einsum("dlw,lk->dwk", g, vproj)     # (D, W, k)
    return u, s, v.reshape(-1, rank)


def block_truncated_panels(
    blocks,
    *,
    rank: int,
    oversample: int = 8,
    power_iters: int = 2,
    key: Key = None,
    omega: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(D, M, rank) truncated ``U_d S_d`` leaf panels via an independent
    per-block sketch: the randomized leaves that feed the hierarchical
    tree merge in place of the O(M^3)-per-block gram+eigh leaves.  Every
    block sketches with the same Omega (``omega``, or drawn from ``key``);
    the power passes give each block its own Q_d.  The blocks run as one
    stack, the counterpart of the reference's ``vmap`` over blocks: a pass
    is one sketch over the whole stack (one ``sketch_panel`` launch on
    sparse input, with the (D, L, M) stack of the Q_d as Omega), a batched
    QR and per-block pullbacks."""
    m, sketch, pullback = _stack_ops(blocks, summed=False)
    l = sketch_width(rank, oversample, m)
    if omega is None:
        omega = draw_omega(
            key, l, m,
            device=(blocks.ell.device
                    if isinstance(blocks, sparse.RepairedSparseBlocks)
                    else blocks.device))
    g, t = _range_finder(sketch, pullback, omega, power_iters)
    with stage("truncate_sketch"):
        u, s, _ = truncate_sketch(t, g @ g.mT, rank)
    return u * s[..., None, :]
