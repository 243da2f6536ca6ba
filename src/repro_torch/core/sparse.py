"""Sparse-matrix containers and block-decomposition utilities for Ranky.

Two representations, one convention:

* ``COOMatrix``: host-side numpy COO triples.  The data pipeline builds
  matrices here; the *dense* execution path densifies it once and never
  looks back.
* ``BlockEll``: the device-side blocked sparse container for the
  sparse-native execution path.  The matrix is split column-wise into
  ``D`` blocks (the paper's ``A = [A^1 | ... | A^D]``) and each block is
  stored as padded ELL **by column**: every stored (= nonempty) column
  carries up to ``K`` (row, value) slots.  All per-block arrays have the
  same capacity so they stack on a leading block axis ``D``.

Rank repair never mutates the ELL arrays: every block reserves a
fixed-capacity *repair side-band* of at most one entry per row (that is
exactly what the paper's checkers add: one 1-valued entry per lonely
row per block).  ``RepairedSparseBlocks`` pairs the immutable ELL with
the per-block ``(repair_cols, repair_mask)`` tensors; core/svd.py knows
how to form exact grams of ``E + R`` without ever densifying a block.

Block-splitting convention (single source of truth for host slicing,
device reshaping, and the sparse container): block width
``W = ceil(N / D)``; block ``d`` owns columns ``[d*W, min((d+1)*W, N))``.
Device paths zero-pad the final block to ``W`` columns
(``pad_to_block_multiple``); zero columns change nothing about
``A A^T``, ``U`` or ``S``.

The host-side numpy parts are the reference's, unchanged; the device
containers are frozen dataclasses of tensors with an explicit ``.to``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class COOMatrix:
    """Minimal COO container (host-side; the dense path densifies it,
    the sparse path converts it to a BlockEll)."""

    rows: np.ndarray  # (nnz,) int32
    cols: np.ndarray  # (nnz,) int32
    vals: np.ndarray  # (nnz,) float32
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def todense(self) -> np.ndarray:
        # Duplicate (row, col) triples ACCUMULATE: the same multigraph
        # semantics as BlockEll.todense_blocks / stored_col_panel, so the
        # dense and sparse execution paths always factor the same matrix
        # (block_ell_from_coo coalesces duplicates by summing).
        out = np.zeros(self.shape, dtype=np.float32)
        np.add.at(out, (self.rows, self.cols), self.vals)
        return out

    def density(self) -> float:
        return self.nnz / (self.shape[0] * self.shape[1])


def random_bipartite(
    m: int,
    n: int,
    density: float,
    *,
    seed: int = 0,
    weighted: bool = False,
    power_law: bool = True,
) -> COOMatrix:
    """Generate a sparse bipartite adjacency matrix like the paper's dataset.

    The paper's matrix is a 539 x 170897 job-candidate bipartite graph.
    Real bipartite interaction graphs are popularity-skewed;
    ``power_law=True`` draws heavy-tailed *row* popularity (a few jobs
    receive most applications) with columns chosen uniformly.  Unpopular
    rows then own very few entries, so a column block can easily miss
    them entirely: exactly the *lonely rows* that appear once the
    matrix is split column-wise into blocks.
    """
    rng = np.random.default_rng(seed)
    nnz_target = max(1, int(round(m * n * density)))

    if power_law:
        # Heavy-tailed row popularity: some jobs get most applications.
        row_p = rng.pareto(1.5, size=m) + 1.0
        row_p /= row_p.sum()
    else:
        row_p = np.full(m, 1.0 / m)

    rows = rng.choice(m, size=nnz_target, p=row_p).astype(np.int32)
    cols = rng.integers(0, n, size=nnz_target).astype(np.int32)

    # Dedup (i, j) pairs.
    key = rows.astype(np.int64) * n + cols
    _, idx = np.unique(key, return_index=True)
    rows, cols = rows[idx], cols[idx]

    if weighted:
        vals = rng.uniform(0.5, 2.0, size=rows.shape[0]).astype(np.float32)
    else:
        vals = np.ones(rows.shape[0], dtype=np.float32)
    return COOMatrix(rows=rows, cols=cols, vals=vals, shape=(m, n))


def ensure_full_row_rank(coo: COOMatrix, *, seed: int = 0) -> COOMatrix:
    """Make sure the *global* matrix has full row rank M (paper assumes
    rank(A) = M for the short-and-fat case) by giving every empty global
    row at least two entries."""
    rng = np.random.default_rng(seed + 1)
    m, n = coo.shape
    have = np.zeros(m, dtype=bool)
    have[coo.rows] = True
    missing = np.nonzero(~have)[0]
    if missing.size == 0:
        return coo
    extra_rows, extra_cols, extra_vals = [], [], []
    for r in missing:
        cs = rng.choice(n, size=2, replace=False)
        extra_rows += [r, r]
        extra_cols += list(cs)
        extra_vals += [1.0, 1.0]
    return COOMatrix(
        rows=np.concatenate([coo.rows, np.asarray(extra_rows, np.int32)]),
        cols=np.concatenate([coo.cols, np.asarray(extra_cols, np.int32)]),
        vals=np.concatenate([coo.vals, np.asarray(extra_vals, np.float32)]),
        shape=coo.shape,
    )


# ---------------------------------------------------------------------------
# Block decomposition (one convention for host and device paths)
# ---------------------------------------------------------------------------

def block_width(n: int, num_blocks: int) -> int:
    """Uniform device block width W = ceil(N / D)."""
    return -(-n // num_blocks)


def block_col_bounds(n: int, num_blocks: int, block_idx: int) -> Tuple[int, int]:
    """Column range [lo, hi) of block ``block_idx`` out of ``num_blocks``.

    Uses the uniform-width convention W = ceil(N / D): block d owns
    ``[d*W, min((d+1)*W, N))`` so it lines up exactly with the device
    paths, which zero-pad N to D*W (``pad_to_block_multiple``) and
    reshape into equal (M, W) blocks.  Only the final block can be
    narrower than W on the host side (its device twin carries the zero
    padding).
    """
    w = block_width(n, num_blocks)
    lo = min(w * block_idx, n)
    hi = min(w * (block_idx + 1), n)
    return lo, hi


def split_blocks(dense: np.ndarray, num_blocks: int) -> list:
    """Column-wise block decomposition A = [A^1 | ... | A^D]."""
    n = dense.shape[1]
    return [
        dense[:, slice(*block_col_bounds(n, num_blocks, d))]
        for d in range(num_blocks)
    ]


def pad_to_block_multiple(dense: np.ndarray, num_blocks: int) -> np.ndarray:
    """Zero-pad columns so N divides evenly by num_blocks (all blocks
    must be equal-sized on the device). Zero columns do not change AA^T,
    singular values, or left vectors."""
    m, n = dense.shape
    rem = (-n) % num_blocks
    if rem == 0:
        return dense
    return np.concatenate([dense, np.zeros((m, rem), dtype=dense.dtype)], axis=1)


# ---------------------------------------------------------------------------
# Device-side blocked sparse container (padded ELL by column)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockEll:
    """Blocked padded-ELL sparse matrix: D column blocks of (M, W) each.

    Per block, only nonempty columns are stored; stored column ``c`` of
    block ``d`` keeps its local column index ``col_ids[d, c]`` and up to
    K (row, value) slots ``col_rows[d, c, :] / col_vals[d, c, :]``.
    Padding slots (both whole padding columns and unused row slots of a
    real column) carry ``val == 0`` with ``row == 0`` / ``col_id == 0``
    so every consumer can treat them as structural zeros.  A slot with
    ``val != 0`` names a row in [0, M) of a column in [0, W): the constructors
    check this on the host (:func:`check_ell_arrays`), the kernels rely
    on it.

    C (stored-column capacity) and K (slots per column) are uniform
    across blocks so the tensors stack on a leading D axis, which the
    kernels take as a grid axis.
    """

    col_ids: torch.Tensor   # (D, C) int32 local column index within block
    col_rows: torch.Tensor  # (D, C, K) int32 row indices
    col_vals: torch.Tensor  # (D, C, K) float32 values (0 = padding slot)
    m: int                  # global row count M
    width: int              # block width W (columns per device block)
    n: int                  # original (unpadded) global column count
    nnz: Optional[int] = None  # TRUE stored nonzeros (after coalescing),
                               # recorded at construction so planners get
                               # an exact count without scanning device
                               # tensors; None for hand-built containers

    @property
    def num_blocks(self) -> int:
        return self.col_ids.shape[0]

    @property
    def capacity(self) -> Tuple[int, int]:
        """(C, K): stored-column capacity and slots per stored column."""
        return self.col_rows.shape[1], self.col_rows.shape[2]

    @property
    def padded_shape(self) -> Tuple[int, int]:
        """(M, D*W): shape of the zero-padded dense equivalent."""
        return self.m, self.num_blocks * self.width

    @property
    def device(self) -> torch.device:
        return self.col_vals.device

    def to(self, device) -> "BlockEll":
        return dataclasses.replace(
            self, col_ids=self.col_ids.to(device),
            col_rows=self.col_rows.to(device),
            col_vals=self.col_vals.to(device))

    def todense_blocks(self) -> torch.Tensor:
        """(D, M, W) dense blocks; oracle/debug only, never the hot path."""
        d, c, k = self.col_rows.shape
        bidx = torch.arange(d, device=self.device)[:, None, None].expand(d, c, k)
        cids = self.col_ids.long()[:, :, None].expand(d, c, k)
        out = torch.zeros((d, self.m, self.width), dtype=torch.float32,
                          device=self.device)
        return out.index_put_((bidx, self.col_rows.long(), cids),
                              self.col_vals, accumulate=True)

    def todense(self) -> torch.Tensor:
        """(M, D*W) dense matrix, identical to
        ``pad_to_block_multiple(coo.todense(), D)``; oracle/debug only."""
        blocks = self.todense_blocks()
        return blocks.permute(1, 0, 2).reshape(self.padded_shape)


@dataclasses.dataclass(frozen=True)
class RepairedSparseBlocks:
    """A BlockEll plus the rank-repair side-band.

    Each checker adds at most ONE 1-valued entry per (block, row): row
    ``r`` of block ``d`` gains an entry at local column
    ``repair_cols[d, r]`` iff ``repair_mask[d, r]``.  Keeping repairs in
    this fixed-capacity side-band (instead of splicing them into the ELL
    arrays) keeps the container immutable on device AND keeps grams
    exact: a repair column may already be stored in the ELL part, and
    core/svd.py:sparse_gram_block accounts for the E/R cross terms.
    """

    ell: BlockEll
    repair_cols: torch.Tensor  # (D, M) int32 local repair column per row
    repair_mask: torch.Tensor  # (D, M) bool   row actually repaired?

    def to(self, device) -> "RepairedSparseBlocks":
        return RepairedSparseBlocks(self.ell.to(device),
                                    self.repair_cols.to(device),
                                    self.repair_mask.to(device))

    def todense_blocks(self) -> torch.Tensor:
        """(D, M, W) dense repaired blocks; oracle/debug only."""
        d, m = self.repair_mask.shape
        out = self.ell.todense_blocks()
        bidx = torch.arange(d, device=out.device)[:, None].expand(d, m)
        ridx = torch.arange(m, device=out.device)[None, :].expand(d, m)
        # Repaired rows are all-zero inside their block, so add == set.
        return out.index_put_((bidx, ridx, self.repair_cols.long()),
                              self.repair_mask.to(torch.float32),
                              accumulate=True)

    def todense(self) -> torch.Tensor:
        blocks = self.todense_blocks()
        return blocks.permute(1, 0, 2).reshape(self.ell.padded_shape)


def stored_col_panel(
    col_rows: torch.Tensor,
    col_vals: torch.Tensor,
    m: int,
    *,
    binarize: bool = False,
) -> torch.Tensor:
    """(C, M) panel of one block's stored columns: entry [c, r] is the
    value of stored column c at row r (or its 0/1 presence with
    ``binarize=True``).  This is the nnz-proportional dense intermediate
    the sparse-native routines share: C ~ nnz, never M x W.
    """
    c = col_rows.shape[0]
    v = (col_vals != 0).to(torch.float32) if binarize \
        else col_vals.to(torch.float32)
    out = torch.zeros((c, m), dtype=torch.float32, device=col_vals.device)
    return out.scatter_add_(1, col_rows.long(), v)


def sorted_segments(keys: torch.Tensor, num: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(order, offsets)`` of a segmented sum over ``num`` segments.

    ``keys`` (n,) names the segment in [0, num) of each value, or ``num``
    for a value that goes nowhere.  ``order`` is a stable sort of the keys
    (so a segment's values keep their order, and the sentinel's come last)
    and ``offsets`` (num + 1,) the start of every segment in it.  Shapes are
    fixed by ``keys`` and ``num``, so nothing waits for the device."""
    keys = keys.long()
    order = torch.sort(keys, stable=True).indices
    counts = torch.zeros(num + 1, dtype=torch.long, device=keys.device)
    counts.scatter_add_(0, keys, torch.ones_like(keys))
    offsets = torch.zeros(num + 1, dtype=torch.long, device=keys.device)
    torch.cumsum(counts[:num], 0, out=offsets[1:])
    return order, offsets


def segment_sum(values: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(num, F): the sums of the segments of ``values`` (n, F), already in
    the order of :func:`sorted_segments`; values past ``offsets[-1]`` (the
    sentinel's) are left out.  Each sum runs over its segment in order, one
    add after the other, so the result is the same bits on every call on
    any device: the deterministic counterpart of a float ``index_add_``,
    whose atomic adds on the GPU land in whatever order they arrive."""
    return torch.segment_reduce(values, "sum", offsets=offsets, axis=0,
                                unsafe=True)


def check_ell_arrays(col_ids: np.ndarray, col_rows: np.ndarray,
                     col_vals: np.ndarray, *, m: int, width: int) -> None:
    """Hold host ELL arrays to the precondition of every device consumer:
    a slot whose value is non-zero names a row in [0, M), and the stored
    column it belongs to a local column in [0, W).  Called where a
    container is built from host arrays (``block_ell_from_coo``,
    ``convert.block_ell_from_numpy``): the kernels do not bounds-check per
    slot beyond trapping, and a ``BlockEll`` put together directly from
    tensors is taken at its word."""
    live = col_vals != 0
    rows = col_rows[live]
    if rows.size and (rows.min() < 0 or rows.max() >= m):
        raise ValueError(
            f"BlockEll: a non-zero slot names row {int(rows.min())} .. "
            f"{int(rows.max())}, outside [0, {m})")
    ids = col_ids[live.any(axis=-1)]
    if ids.size and (ids.min() < 0 or ids.max() >= width):
        raise ValueError(
            f"BlockEll: a stored column has local id {int(ids.min())} .. "
            f"{int(ids.max())}, outside [0, {width})")


def block_ell_from_coo(
    coo: COOMatrix,
    num_blocks: int,
    *,
    capacity_multiple: int = 8,
    device=None,
) -> BlockEll:
    """Build the device container from host COO triples.

    Capacity is sized to the data: C = max stored columns per block
    (rounded up to ``capacity_multiple``), K = max nonzeros in any single
    column.  Padding slots carry val 0.  The arrays are built on the host
    with numpy (set-up work, outside any timed solve) and moved to
    ``device`` once (``None``: the GPU, see ``repro_torch.resolve_device``).

    Duplicate (row, col) triples are coalesced here by SUMMING their
    values.  The device consumers (todense_blocks / stored_col_panel /
    the sparse_gram kernel) all scatter-ADD, so summed coalescing is an
    identity for them, and COOMatrix.todense accumulates the same way,
    keeping the sparse and dense paths on the same matrix even for
    multigraph inputs.

    The coalesced triple count is recorded as ``BlockEll.nnz`` so
    downstream planners (``api.describe``) see the EXACT stored-nonzero
    count instead of the padded slot capacity.
    """
    device = resolve_device(device)
    m, n = coo.shape
    pair = coo.rows.astype(np.int64) * n + coo.cols.astype(np.int64)
    uniq_pair, inv = np.unique(pair, return_inverse=True)
    if uniq_pair.size != pair.size:
        summed = np.zeros(uniq_pair.size, np.float32)
        np.add.at(summed, inv, coo.vals)
        coo = COOMatrix(rows=(uniq_pair // n).astype(np.int32),
                        cols=(uniq_pair % n).astype(np.int32),
                        vals=summed, shape=coo.shape)
    w = block_width(n, num_blocks)
    blk_of = coo.cols // w
    local = (coo.cols % w).astype(np.int64)

    per_block = []
    c_max, k_max = 1, 1
    for d in range(num_blocks):
        sel = blk_of == d
        lc, lr, lv = local[sel], coo.rows[sel], coo.vals[sel]
        order = np.argsort(lc, kind="stable")
        lc, lr, lv = lc[order], lr[order], lv[order]
        uniq, start, counts = np.unique(lc, return_index=True,
                                        return_counts=True)
        per_block.append((uniq, start, counts, lr, lv))
        if uniq.size:
            c_max = max(c_max, uniq.size)
            k_max = max(k_max, int(counts.max()))

    c_cap = -(-c_max // capacity_multiple) * capacity_multiple
    col_ids = np.zeros((num_blocks, c_cap), np.int32)
    col_rows = np.zeros((num_blocks, c_cap, k_max), np.int32)
    col_vals = np.zeros((num_blocks, c_cap, k_max), np.float32)
    for d, (uniq, start, counts, lr, lv) in enumerate(per_block):
        if not uniq.size:
            continue
        col_ids[d, :uniq.size] = uniq
        slot_col = np.repeat(np.arange(uniq.size), counts)
        slot_k = np.arange(lr.size) - np.repeat(start, counts)
        col_rows[d, slot_col, slot_k] = lr
        col_vals[d, slot_col, slot_k] = lv
    check_ell_arrays(col_ids, col_rows, col_vals, m=m, width=w)
    return BlockEll(col_ids=torch.from_numpy(col_ids).to(device),
                    col_rows=torch.from_numpy(col_rows).to(device),
                    col_vals=torch.from_numpy(col_vals).to(device),
                    m=m, width=w, n=n, nnz=coo.nnz)
