"""Ranky rank-repair methods (the paper's core contribution) + the
single-host pipeline.

The paper's per-row pseudocode loops are re-expressed as vectorized mask
algebra on tensors (semantics preserved; see the literal numpy reference
implementations ``ref_*`` used by the tests).

Terminology (paper): a *lonely node/row* is a row that is all-zero inside
one column block (it may have entries in other blocks).  Lonely rows make
``rank(A^i) < rank(A)`` which breaks the proxy-matrix SVD recovery.

Methods:
  * random   - RandomChecker: each lonely row gets a 1 at a uniformly
               random column inside the block.
  * neighbor - NeighborChecker: a lonely row m gets a 1 at a column of
               this block where one of m's graph neighbors (rows sharing
               a nonzero column with m *anywhere* in A) has a nonzero.
               If m has no neighbor with entries in this block, the row
               stays lonely (this is the paper's observed weakness).
  * neighbor_random - NeighborRandomChecker: neighbor first, random
               fallback for rows the neighbor pass could not fix.

Randomness: draws are inputs.  Every checker takes the draw it consumes
as a tensor (the random column per row, the uniform score per candidate);
``split_and_repair`` either receives them (``draws=``, which is how the
tests hold the port against the reference given the reference's own
draws) or makes them with ``torch.Generator``s seeded deterministically
from ``key`` and the block index.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import sparse

METHODS = ("none", "random", "neighbor", "neighbor_random")

# The ONE documented deterministic default: every entry point resolves
# key=None to this seed, so unkeyed solves are reproducible.
DEFAULT_SEED = 0

Key = Union[None, int, torch.Generator]

_MASK64 = (1 << 64) - 1
_TAIL_TAG = 0xDEAD


def seed_of(key: Key) -> int:
    """The integer seed a ``key`` stands for: ``None`` is DEFAULT_SEED, a
    ``torch.Generator`` its ``initial_seed()`` (its state is never
    consumed, so the same generator always means the same draws)."""
    if key is None:
        return DEFAULT_SEED
    if isinstance(key, torch.Generator):
        return int(key.initial_seed())
    return int(key)


def derive_seed(seed: int, *counters: int) -> int:
    """Chain ``seed`` with counters (block index, purpose tag) into a new
    63-bit seed (splitmix64 steps): the port's counterpart of
    ``jax.random.split`` / ``fold_in``.  Deterministic, and distinct
    counters give unrelated streams."""
    x = seed & _MASK64
    for c in counters:
        x = (x + 0x9E3779B97F4A7C15 + (int(c) & _MASK64)) & _MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
        x ^= x >> 31
    return x >> 1


def _generator(seed: int, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


@dataclasses.dataclass(frozen=True)
class RepairDraws:
    """The random inputs of ``split_and_repair``, one row per block.

    ``random_cols`` (D, M) int32: the uniformly random in-block column of
    every row (methods random and neighbor_random).  ``neighbor_scores``
    (D, M, C) for a BlockEll input / (D, M, W) for a dense one: the
    uniform score of every candidate column, the arg-max of which among a
    row's candidates is its neighbor column (methods neighbor and
    neighbor_random).  A field a method does not consume may be None."""

    random_cols: Optional[torch.Tensor] = None
    neighbor_scores: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# The port's own draws (deterministic in (key, block index))
# ---------------------------------------------------------------------------

def _block_seeds(seed: int, method: str, d: int) -> Tuple[int, int]:
    """(score seed, random-column seed) of block d.  neighbor_random
    splits the block's seed in two, as the reference splits its key."""
    blk = derive_seed(seed, d)
    if method == "neighbor_random":
        return derive_seed(blk, 0), derive_seed(blk, 1)
    return blk, blk


def draw_random_cols(seed: int, method: str, num_blocks: int, m: int,
                     width: int, device, *, slots=None) -> torch.Tensor:
    """(D, M) int32 uniform columns in [0, W), or with ``slots`` the rows
    of those blocks only.  Drawn on the host (it is small), so the same key
    repairs the same columns on every device, for the dense and the sparse
    representation alike, and for block d wherever it is repaired."""
    slots = range(num_blocks) if slots is None else slots
    out = torch.empty((len(slots), m), dtype=torch.int32)
    for i, d in enumerate(slots):
        _, s_rand = _block_seeds(seed, method, d)
        out[i] = torch.randint(0, width, (m,), generator=_generator(s_rand),
                               dtype=torch.int32)
    return out.to(device)


def draw_neighbor_scores(seed: int, method: str, d: int, shape, device
                         ) -> torch.Tensor:
    """Uniform [0, 1) scores of one block, drawn on ``device`` (the draw
    is as large as the candidate mask, so it is made where it is used)."""
    s_nb, _ = _block_seeds(seed, method, d)
    return torch.rand(shape, generator=_generator(s_nb, device),
                      dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Mask helpers
# ---------------------------------------------------------------------------

def lonely_rows(a_blk: torch.Tensor) -> torch.Tensor:
    """Boolean (M,) mask of rows that are all-zero inside this block."""
    return ~torch.any(a_blk != 0, dim=1)


def row_adjacency(a_dense: torch.Tensor) -> torch.Tensor:
    """Global boolean row-adjacency R[m, m'] = rows m and m' share a
    nonzero column somewhere in A.  Diagonal is cleared."""
    b = (a_dense != 0).to(torch.float32)
    adj = (b @ b.T) > 0
    return adj & ~torch.eye(adj.shape[0], dtype=torch.bool, device=adj.device)


def _choose_masked_col(scores: torch.Tensor, mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row, choose the candidate column of ``mask`` (M, N) with the
    highest score (uniform scores: a uniform choice).

    Returns (cols (M,), has_candidate (M,)).  Rows without candidates get
    an arbitrary column index (all their scores tie at -1, and which index
    arg-max returns for a full tie is not promised on every device), so
    callers must gate on has_candidate.
    """
    scores = torch.where(mask, scores, -1.0)
    return torch.argmax(scores, dim=1), torch.any(mask, dim=1)


def _fill_rows(a_blk: torch.Tensor, rows_mask: torch.Tensor,
               cols: torch.Tensor) -> torch.Tensor:
    """A copy of the block with A[m, cols[m]] += 1 for every row m with
    rows_mask[m].  A scatter of the mask, one entry a row (an exact 0 where
    the row is not filled): no (M, W) one-hot, and shapes fixed by the
    block's, so nothing waits for the device."""
    out = a_blk.clone()
    # Rows being filled are all-zero inside the block, so add == set.
    return out.scatter_add_(1, cols.long()[:, None],
                            rows_mask[:, None].to(out.dtype))


def _choose_for_lonely(lonely: torch.Tensor, row_adj: torch.Tensor,
                       present: torch.Tensor, scores: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The neighbor pass for the LONELY rows only (no other row's choice is
    ever used): candidate[m, n] = some neighbor of m has an entry at column
    n, ``present`` being the (M, N) 0/1 presence matrix of the block's
    columns.  Returns (cols (M,) int64, has_candidate (M,)), zero / False on
    rows that are not lonely.  The candidate mask is (lonely rows, N), not
    (M, N): a block usually has few lonely rows or none."""
    m = lonely.shape[0]
    cols = torch.zeros((m,), dtype=torch.int64, device=lonely.device)
    has_cand = torch.zeros((m,), dtype=torch.bool, device=lonely.device)
    idx = torch.nonzero(lonely).squeeze(1)
    if idx.numel():
        cand = (row_adj[idx].to(torch.float32) @ present) > 0
        cols[idx], has_cand[idx] = _choose_masked_col(scores[idx], cand)
    return cols, has_cand


# ---------------------------------------------------------------------------
# Dense checkers
# ---------------------------------------------------------------------------

def random_checker(a_blk: torch.Tensor, random_cols: torch.Tensor
                   ) -> torch.Tensor:
    """RandomChecker: lonely rows get a 1 at their random in-block column."""
    return _fill_rows(a_blk, lonely_rows(a_blk), random_cols)


def neighbor_checker(a_blk: torch.Tensor, row_adj: torch.Tensor,
                     scores: torch.Tensor) -> torch.Tensor:
    """NeighborChecker: lonely rows get a 1 at a random column where one
    of their graph neighbors has an entry inside this block."""
    lonely = lonely_rows(a_blk)
    cols, has_cand = _choose_for_lonely(
        lonely, row_adj, (a_blk != 0).to(torch.float32), scores)
    return _fill_rows(a_blk, has_cand, cols)


def neighbor_random_checker(a_blk: torch.Tensor, row_adj: torch.Tensor,
                            scores: torch.Tensor, random_cols: torch.Tensor
                            ) -> torch.Tensor:
    """NeighborRandomChecker: neighbor pass, then random fallback for rows
    still lonely (no neighbor had entries inside this block)."""
    lonely = lonely_rows(a_blk)
    nb_cols, has_cand = _choose_for_lonely(
        lonely, row_adj, (a_blk != 0).to(torch.float32), scores)
    cols = torch.where(has_cand, nb_cols, random_cols.long())
    return _fill_rows(a_blk, lonely, cols)


def repair_block(
    a_blk: torch.Tensor,
    method: str,
    *,
    random_cols: Optional[torch.Tensor] = None,
    scores: Optional[torch.Tensor] = None,
    row_adj: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dispatch one of the Ranky methods on a dense block, given the
    draws the method consumes."""
    if method == "none":
        return a_blk
    if method == "random":
        return random_checker(a_blk, random_cols)
    if method not in METHODS:
        raise ValueError(f"unknown Ranky method {method!r}; want one of {METHODS}")
    if row_adj is None:
        raise ValueError(f"method {method!r} needs the row adjacency")
    if method == "neighbor":
        return neighbor_checker(a_blk, row_adj, scores)
    return neighbor_random_checker(a_blk, row_adj, scores, random_cols)


# ---------------------------------------------------------------------------
# Sparse-native checkers (index-array algebra; the dense checkers above
# are the semantic oracles)
# ---------------------------------------------------------------------------

def sparse_row_counts(col_rows: torch.Tensor, col_vals: torch.Tensor,
                      m: int) -> torch.Tensor:
    """Per-row nonzero counts of ELL slots (padding slots inert): (C, K)
    arrays of one block -> (M,) int32, or stacked (D, C, K) -> (D, M).
    Integer adds, so exact whatever order the device adds them in."""
    lead = col_rows.shape[:-2]
    present = (col_vals != 0).to(torch.int32).reshape(*lead, -1)
    idx = col_rows.reshape(*lead, -1).long()
    out = torch.zeros((*lead, m), dtype=torch.int32, device=col_vals.device)
    return out.scatter_add_(-1, idx, present)


def sparse_lonely_rows(col_rows: torch.Tensor, col_vals: torch.Tensor,
                       m: int) -> torch.Tensor:
    """Boolean lonely mask straight from the index arrays ((M,) for one
    block, (D, M) for a stack)."""
    return sparse_row_counts(col_rows, col_vals, m) == 0


def lonely_rows_per_block(a_norm, num_blocks: int) -> Tuple[int, ...]:
    """Per-block lonely-row counts of a normalized input: dense
    (M, N_pad) tensor (N_pad divisible by num_blocks) or BlockEll.  The
    diagnostics helper behind ``api.svd`` (host-side tuple of ints)."""
    if isinstance(a_norm, sparse.BlockEll):
        lonely = sparse_lonely_rows(a_norm.col_rows, a_norm.col_vals, a_norm.m)
        return tuple(int(x) for x in lonely.sum(dim=1).tolist())
    m, n = a_norm.shape
    blocks = torch.as_tensor(a_norm).reshape(m, num_blocks, n // num_blocks)
    lonely = ~(blocks != 0).any(dim=2)
    return tuple(int(x) for x in lonely.sum(dim=0).tolist())


def row_adjacency_sparse(ell: "sparse.BlockEll") -> torch.Tensor:
    """Global row adjacency from the blocked sparse container: sum of
    per-block binarized grams (counts of shared stored columns), identical
    in semantics to ``row_adjacency`` on the dense matrix.  One block at a
    time: the (C, M) presence panel of a single block is the largest
    intermediate."""
    counts = torch.zeros((ell.m, ell.m), dtype=torch.float32,
                         device=ell.device)
    for d in range(ell.num_blocks):
        p = sparse.stored_col_panel(ell.col_rows[d], ell.col_vals[d], ell.m,
                                    binarize=True)
        counts += p.T @ p
    return (counts > 0) & ~torch.eye(ell.m, dtype=torch.bool,
                                     device=ell.device)


def sparse_random_checker(col_rows: torch.Tensor, col_vals: torch.Tensor,
                          m: int, random_cols: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RandomChecker on index arrays: (repair_cols, repair_mask).

    Consumes the same random columns as the dense checker, so for given
    draws the sparse and dense repairs are identical.
    """
    return random_cols, sparse_lonely_rows(col_rows, col_vals, m)


def sparse_neighbor_checker(col_ids: torch.Tensor, col_rows: torch.Tensor,
                            col_vals: torch.Tensor, row_adj: torch.Tensor,
                            m: int, scores: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NeighborChecker on index arrays.

    Candidate columns of a lonely row are columns of this block where a
    graph neighbor has an entry; all such columns are *stored* columns,
    so the choice runs over the stored-column candidate mask and maps back
    through col_ids.  Same candidate set as the dense checker (non-stored
    columns are all-zero and never candidates).  ``repair_cols`` of a row
    that is not repaired is 0 (the reference leaves an arbitrary column
    there; ``repair_mask`` gates it on both sides).
    """
    lonely = sparse_lonely_rows(col_rows, col_vals, m)
    if not bool(lonely.any()):
        return torch.zeros_like(lonely, dtype=torch.int32), lonely
    presence = sparse.stored_col_panel(col_rows, col_vals, m, binarize=True)
    stored_idx, has_cand = _choose_for_lonely(lonely, row_adj, presence.T,
                                              scores)
    return torch.where(has_cand, col_ids[stored_idx],
                       torch.zeros_like(col_ids[:1])), has_cand


def sparse_neighbor_random_checker(
    col_ids: torch.Tensor, col_rows: torch.Tensor, col_vals: torch.Tensor,
    row_adj: torch.Tensor, m: int, scores: torch.Tensor,
    random_cols: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Neighbor pass, random fallback for rows without reachable columns."""
    nb_cols, nb_mask = sparse_neighbor_checker(
        col_ids, col_rows, col_vals, row_adj, m, scores)
    lonely = sparse_lonely_rows(col_rows, col_vals, m)
    cols = torch.where(nb_mask, nb_cols, random_cols)
    return cols, lonely


def repair_block_sparse(
    col_ids: torch.Tensor,
    col_rows: torch.Tensor,
    col_vals: torch.Tensor,
    method: str,
    *,
    m: int,
    random_cols: Optional[torch.Tensor] = None,
    scores: Optional[torch.Tensor] = None,
    row_adj: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch one Ranky method on one sparse block; returns the repair
    side-band (repair_cols (M,) int32, repair_mask (M,) bool): the
    at-most-one 1-valued entry per row the checker adds, landing in the
    reserved capacity of sparse.RepairedSparseBlocks instead of mutating
    the ELL."""
    dev = col_vals.device
    if method == "none":
        return (torch.zeros((m,), dtype=torch.int32, device=dev),
                torch.zeros((m,), dtype=torch.bool, device=dev))
    if method == "random":
        return sparse_random_checker(col_rows, col_vals, m, random_cols)
    if method not in METHODS:
        raise ValueError(f"unknown Ranky method {method!r}; want one of {METHODS}")
    if row_adj is None:
        raise ValueError(f"method {method!r} needs the row adjacency")
    if method == "neighbor":
        return sparse_neighbor_checker(
            col_ids, col_rows, col_vals, row_adj, m, scores)
    return sparse_neighbor_random_checker(
        col_ids, col_rows, col_vals, row_adj, m, scores, random_cols)


# ---------------------------------------------------------------------------
# Literal per-row numpy references (paper pseudocode transliterated).
# Used only by the tests to pin the vectorized semantics.
# ---------------------------------------------------------------------------

def ref_lonely_rows(a_blk: np.ndarray) -> np.ndarray:
    out = np.ones(a_blk.shape[0], dtype=bool)
    for m in range(a_blk.shape[0]):
        for n in range(a_blk.shape[1]):
            if a_blk[m, n] != 0:
                out[m] = False
                break
    return out


def ref_random_checker(a_blk: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    a = a_blk.copy()
    for m in range(a.shape[0]):
        if not a[m].any():
            a[m, rng.integers(0, a.shape[1])] = 1.0
    return a


def ref_neighbor_candidates(
    a_full: np.ndarray, blk_lo: int, blk_hi: int, m: int
) -> np.ndarray:
    """Paper NeighborChecker inner loops: the set of columns inside block
    [blk_lo, blk_hi) where any graph-neighbor of row m has a nonzero."""
    mcount = a_full.shape[0]
    neighbors = set()
    for n1 in range(a_full.shape[1]):
        if blk_lo <= n1 < blk_hi:
            continue  # other blocks only (d1 == d is skipped in the paper)
        if a_full[m, n1] != 0:
            for m1 in range(mcount):
                if m1 != m and a_full[m1, n1] != 0:
                    neighbors.add(m1)
    cols = set()
    for m1 in neighbors:
        for n2 in range(blk_lo, blk_hi):
            if a_full[m1, n2] != 0:
                cols.add(n2 - blk_lo)
    return np.asarray(sorted(cols), dtype=np.int64)


# ---------------------------------------------------------------------------
# Shared prologue + single-host end-to-end pipeline
# ---------------------------------------------------------------------------

BlockInput = Union[torch.Tensor, "sparse.BlockEll"]


def repair_blocks(
    blocks,
    slots,
    method: str,
    seed: int,
    *,
    m: int,
    width: int,
    row_adj: Optional[torch.Tensor] = None,
    draws: Optional[RepairDraws] = None,
):
    """Repair the blocks ``slots`` of a column-split input, given the
    global row adjacency (methods neighbor / neighbor_random).

    ``blocks`` is the (n, M, W) dense stack of those blocks, or a
    ``BlockEll`` of n blocks; block i is global block ``slots[i]`` and
    consumes that block's draws: the rows ``slots`` of injected ``draws``
    (which cover every block), or its own generators seeded from ``seed``
    and its global index.  So a block is repaired the same, bit for bit,
    in a single-host solve and on whichever slot of a mesh holds it.
    Returns the repaired dense stack, or ``(repair_cols, repair_mask)``
    (n, M) for an ELL input."""
    needs_adj = method in ("neighbor", "neighbor_random")
    needs_rand = method in ("random", "neighbor_random")
    is_sparse = isinstance(blocks, sparse.BlockEll)
    dev = blocks.device
    slots = [int(d) for d in slots]
    rand = draws.random_cols if draws is not None else None
    if needs_rand:
        rand = (draw_random_cols(seed, method, None, m, width, dev,
                                 slots=slots)
                if rand is None else rand[slots])
    given_scores = draws.neighbor_scores if draws is not None else None

    def block_draws(i, d, score_shape):
        sc = None
        if needs_adj:
            sc = (given_scores[d] if given_scores is not None else
                  draw_neighbor_scores(seed, method, d, score_shape, dev))
        return dict(random_cols=rand[i] if needs_rand else None, scores=sc)

    if is_sparse:
        rc = torch.empty((len(slots), m), dtype=torch.int32, device=dev)
        rm = torch.empty((len(slots), m), dtype=torch.bool, device=dev)
        for i, d in enumerate(slots):
            rc[i], rm[i] = repair_block_sparse(
                blocks.col_ids[i], blocks.col_rows[i], blocks.col_vals[i],
                method, m=m, row_adj=row_adj,
                **block_draws(i, d, (m, blocks.capacity[0])))
        return rc, rm
    out = torch.empty((len(slots), m, width), dtype=blocks.dtype, device=dev)
    for i, d in enumerate(slots):
        out[i] = repair_block(blocks[i], method, row_adj=row_adj,
                              **block_draws(i, d, (m, width)))
    return out


def dense_block_stack(a: torch.Tensor, num_blocks: int) -> torch.Tensor:
    """The (D, M, W) block view of a dense (M, D*W) matrix: block d is
    ``a[:, d*W:(d+1)*W]``."""
    m, n = a.shape
    return a.reshape(m, num_blocks, n // num_blocks).permute(1, 0, 2)


def split_and_repair(
    a: BlockInput,
    num_blocks: int,
    method: str,
    key: Key = None,
    *,
    draws: Optional[RepairDraws] = None,
):
    """The block-split -> row-adjacency -> per-block repair prologue.

    * dense (M, N) tensor -> repaired (D, M, N/D) block stack
      (N must already divide by num_blocks: sparse.pad_to_block_multiple)
    * sparse.BlockEll     -> sparse.RepairedSparseBlocks (the immutable
      ELL plus the per-block repair side-band; nothing is densified)

    ``draws`` injects the random inputs (see :class:`RepairDraws`);
    without it they come from generators seeded from ``key`` and the block
    index.  Blocks are repaired one after the other (:func:`repair_blocks`):
    the candidate mask and the score draw of a block are (M, C) (sparse) or
    (M, W) (dense), and a batch over D of those is the largest thing this
    function could allocate.
    """
    if method not in METHODS:
        raise ValueError(f"unknown Ranky method {method!r}; want one of {METHODS}")
    seed = seed_of(key)
    needs_adj = method in ("neighbor", "neighbor_random")

    if isinstance(a, sparse.BlockEll):
        if a.num_blocks != num_blocks:
            raise ValueError(
                f"BlockEll has {a.num_blocks} blocks, got num_blocks={num_blocks}")
        m, dev = a.m, a.device
        adj = None
        if needs_adj:
            # Only lonely rows consult the adjacency: when no block has one
            # (common once M is small against the block's nnz) the D panel
            # products are skipped and an empty adjacency stands in.
            if bool(sparse_lonely_rows(a.col_rows, a.col_vals, m).any()):
                adj = row_adjacency_sparse(a)
            else:
                adj = torch.zeros((m, m), dtype=torch.bool, device=dev)
        rc, rm = repair_blocks(a, range(num_blocks), method, seed, m=m,
                               width=a.width, row_adj=adj, draws=draws)
        return sparse.RepairedSparseBlocks(a, rc, rm)

    m, n = a.shape
    if n % num_blocks:
        raise ValueError("pad columns so N % num_blocks == 0")
    adj = row_adjacency(a) if needs_adj else None
    return repair_blocks(dense_block_stack(a, num_blocks), range(num_blocks),
                         method, seed, m=m, width=n // num_blocks,
                         row_adj=adj, draws=draws)


def right_vectors_stack(blocks, u: torch.Tensor, s: torch.Tensor, *,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Right vectors of the REPAIRED matrix from a repaired block stack:
    per block ``V_blk = A_blk^T U diag(1/S)``, stacked to (D*W, r) in
    padded column order; a sparse stack in one ``kops.right_vectors`` call.
    ``out`` (D*W, r), which may be a column slice of a wider panel,
    receives the result in place of a new tensor (the streaming merge
    writes the batch's part of its panel this way)."""
    from repro_torch.core import svd as lsvd
    from repro_torch.kernels import ops as kops

    if isinstance(blocks, sparse.RepairedSparseBlocks):
        ell = blocks.ell
        return kops.right_vectors(ell.col_ids, ell.col_rows, ell.col_vals,
                                  blocks.repair_cols, blocks.repair_mask,
                                  ell.width, u, s, out=out)
    d, _, w = blocks.shape
    inv = lsvd.masked_inverse(s)
    if out is None:
        return ((blocks.mT @ u) * inv[None, None, :]).reshape(d * w, -1)
    torch.mul(blocks.mT @ u, inv[None, None, :], out=out.view(d, w, -1))
    return out


def solve_single(
    a: BlockInput,
    *,
    num_blocks: int,
    method: str = "neighbor_random",
    local_mode: str = "gram",  # "gram" (gram + eigh) | "svd" (paper dgesvd)
    merge_mode: str = "proxy",  # "proxy" (paper) | "gram" (beyond-paper)
    undetermined_tail: bool = False,
    rank: Optional[int] = None,
    oversample: int = 8,
    power_iters: int = 2,
    want_right: bool = False,
    use_kernel: bool = False,
    key: Key = None,
    draws: Optional[RepairDraws] = None,
    omega: Optional[torch.Tensor] = None,
    tail_noise: Optional[torch.Tensor] = None,
):
    """One-level Ranky distributed SVD, single host: the ``backend="single"``
    engine behind ``repro_torch.core.api.svd`` (and the legacy ``ranky_svd``
    shim).  Returns (U, S) of A, or (U, S, V) with ``want_right``, V in
    padded column order.

    ``a`` is either a dense (M, N) tensor (N must divide by num_blocks,
    pad with zero columns first; lossless for U and S) or a
    sparse.BlockEll container, in which case the whole pipeline is
    sparse-native (gram local mode only; no (M, N/D) block is ever
    materialized).  It runs on the device ``a`` lies on.

    ``rank=k`` switches to the randomized truncated path
    (core/randomized.py): rank repair still runs first, then the top-k
    (U (M, k), S (k,)) come from a (k+oversample)-row sketch with
    ``power_iters`` re-orthonormalized power passes.

    ``undetermined_tail`` emulates the rank problem the paper fixes: a
    rank-deficient block's SVD has zero singular values whose left-vector
    columns are numerically UNDETERMINED.  With the flag on, dead panel
    columns are filled with sqrt(eps)-scale noise, the exact failure
    Ranky's checkers prevent by making every block full-rank.  The
    emulation lives in the proxy-panel merge: requesting it under
    ``merge_mode="gram"`` or ``rank=k`` is an error in ``api.SolveConfig``.

    Random inputs: ``draws`` (repair), ``omega`` (the (L, M) test matrix
    of the sketch) and ``tail_noise`` ((D, M, M) standard normal, for
    ``undetermined_tail``) may be injected; otherwise they are drawn from
    generators seeded from ``key``.
    """
    from repro_torch.core import svd as lsvd

    is_sparse = isinstance(a, sparse.BlockEll)
    seed = seed_of(key)

    with obs.span("split_and_repair"):
        blocks = split_and_repair(a, num_blocks, method, seed, draws=draws)

    if rank is not None:
        from repro_torch.core import randomized

        return randomized.randomized_svd_blocks(
            blocks, rank=rank, oversample=oversample,
            power_iters=power_iters, key=seed, want_right=want_right,
            omega=omega)

    if merge_mode == "gram":
        with obs.span("gram_stack"):
            grams = lsvd.gram_stack(blocks, use_kernel=use_kernel)
        with obs.span("merge_grams_eigh"):
            u, s = lsvd.merge_grams_eigh(grams)
    elif merge_mode == "proxy":
        if local_mode == "gram":
            # local_svd_gram_stack, its two halves timed apart.
            with obs.span("gram_stack"):
                grams = lsvd.gram_stack(blocks, use_kernel=use_kernel)
            with obs.span("eigh_to_svd"):
                u_all, s_all = lsvd.eigh_to_svd(grams)
        elif local_mode == "svd":
            if is_sparse:
                raise ValueError(
                    "the sparse path is gram-native; use local_mode='gram'")
            with obs.span("local_svd_exact"):
                u_all, s_all = lsvd.local_svd_exact(blocks)
        else:
            raise ValueError(f"unknown local_mode {local_mode!r}")
        panels = lsvd.proxy_panel(u_all, s_all)  # (D, M, M)
        if undetermined_tail:
            smax = torch.max(s_all, dim=1, keepdim=True).values      # (D, 1)
            dead = s_all <= 1e-9 * smax                              # (D, M)
            if tail_noise is None:
                tail_noise = torch.randn(
                    panels.shape, dtype=panels.dtype,
                    generator=_generator(derive_seed(seed, _TAIL_TAG)),
                ).to(panels.device)
            eps_scale = torch.finfo(panels.dtype).eps ** 0.5
            panels = torch.where(dead[:, None, :],
                                 tail_noise * smax[:, :, None] * eps_scale,
                                 panels)
        with obs.span("merge_panels_svd"):
            u, s = lsvd.merge_panels_svd(panels)
    else:
        raise ValueError(f"unknown merge_mode {merge_mode!r}")

    if not want_right:
        return u, s
    with obs.span("right_vectors_stack"):
        v = right_vectors_stack(blocks, u, s)
    return u, s, v


def ranky_svd(
    a: BlockInput,
    *,
    num_blocks: int,
    method: str = "neighbor_random",
    local_mode: str = "gram",
    merge_mode: str = "proxy",
    undetermined_tail: bool = False,
    rank: Optional[int] = None,
    oversample: int = 8,
    power_iters: int = 2,
    want_right: bool = False,
    key: Key = None,
):
    """DEPRECATED legacy entry point: use ``repro_torch.core.api.svd``
    with a ``SolveConfig(backend="single", ...)``.

    Thin shim: builds the SolveConfig (centralized validation) and runs
    the same ``solve_single`` engine ``api.svd`` dispatches to.  Returns
    the legacy (U, S) tuple, or (U, S, V) with ``want_right=True`` (V in
    padded column order).
    """
    import warnings

    from repro_torch.core import api

    warnings.warn(
        "ranky_svd is deprecated; use repro_torch.core.api.svd with "
        "SolveConfig(backend='single', ...)", DeprecationWarning,
        stacklevel=2)
    cfg = api.SolveConfig(
        backend="single", method=method, local_mode=local_mode,
        merge_mode=merge_mode, undetermined_tail=undetermined_tail,
        rank=rank, oversample=oversample, power_iters=power_iters,
        want_right=want_right, num_blocks=num_blocks, key=key)
    return api._run_single(a, cfg)
