"""Seeded sparse 0/1 bipartite matrices, made on the device in bulk.

The model is ``repro_torch.core.sparse.random_bipartite``'s (the paper's
job x candidate graph): row popularity heavy-tailed (Lomax of exponent
1.5 plus one, numpy's ``pareto(1.5) + 1``), columns uniform,
``round(m * n * density)`` draws of which repeated (row, column) pairs
count once; a row left empty gets two entries (``ensure_full_row_rank``).
One change: the m rows' popularities are the distribution's m quantiles
(at (i + 1/2) / m), dealt to the rows in an order drawn from the seed,
where the original draws them independently.  The heaviest row of an
independent draw varies several-fold between seeds, and with it the work
of a solve (the sketch's pullback sums each row's entries in turn); with
the quantiles every seed has the same popularities in another order.
It is written again here with ``torch`` generators on the card, so that a
change to the program cannot move the data and so that set-up makes
millions of entries in a few large calls rather than on the host.

The triples come back sorted by (column, row), the order in which
:func:`block_ell` lays out the container the program takes
(``repro_torch.core.sparse.BlockEll``): per column block, the stored
columns in ascending order, each column's rows ascending, padding slots
zero.  The reference reads the triples only, never the container.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

POPULARITY_EXPONENT = 1.5
_MASK64 = (1 << 64) - 1


def mix(seed: int, *tags: int) -> int:
    """``seed`` chained with ``tags`` into a 63-bit seed (splitmix64
    steps): one independent stream per (seed, purpose, index)."""
    x = int(seed) & _MASK64
    for t in tags:
        x = (x + 0x9E3779B97F4A7C15 + (int(t) & _MASK64)) & _MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
        x ^= x >> 31
    return x >> 1


def generator(device, seed: int, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, *tags))


def random_bipartite(m: int, n: int, density: float, gen: torch.Generator,
                     device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, cols) int64 of a random 0/1 matrix (see the module
    docstring), sorted by (column, row), every row non-empty."""
    draws = max(1, int(round(m * n * density)))
    u = (torch.randperm(m, generator=gen, device=device).double()
         + 0.5) / m
    popularity = (1.0 - u) ** (-1.0 / POPULARITY_EXPONENT)
    rows = torch.multinomial(popularity / popularity.sum(), draws,
                             replacement=True, generator=gen)
    cols = torch.randint(0, n, (draws,), generator=gen, device=device)
    empty = torch.bincount(rows, minlength=m) == 0
    if bool(empty.any()):
        lone = torch.nonzero(empty).squeeze(1).repeat(2)
        rows = torch.cat([rows, lone])
        cols = torch.cat([cols, torch.randint(0, n, lone.shape,
                                              generator=gen,
                                              device=device)])
    key = torch.unique(cols * m + rows)
    return key % m, key // m


@dataclasses.dataclass(frozen=True)
class Stats:
    """What a matrix's kernels need, counted from its non-zeros: ``pairs``
    = sum over columns of (entries in the column) squared, ``stored_cols``
    = non-empty columns over all blocks."""

    m: int
    n: int
    num_blocks: int
    nnz: int
    pairs: int
    stored_cols: int


def stats(rows: torch.Tensor, cols: torch.Tensor, m: int, n: int,
          num_blocks: int) -> Stats:
    _, per_col = torch.unique_consecutive(cols, return_counts=True)
    return Stats(m=m, n=n, num_blocks=num_blocks, nnz=int(rows.numel()),
                 pairs=int((per_col * per_col).sum()),
                 stored_cols=int(per_col.numel()))


def width(n: int, num_blocks: int) -> int:
    return -(-n // num_blocks)


def capacity(cols: torch.Tensor, n: int, num_blocks: int) -> Tuple[int, int]:
    """(C, K): the most stored columns of a block, the most entries of a
    column."""
    ucols, per_col = torch.unique_consecutive(cols, return_counts=True)
    per_block = torch.bincount(ucols // width(n, num_blocks),
                               minlength=num_blocks)
    return int(per_block.max()), int(per_col.max())


def block_ell(rows: torch.Tensor, cols: torch.Tensor, m: int, n: int,
              num_blocks: int, *, c_cap: Optional[int] = None,
              k_cap: Optional[int] = None):
    """The ``BlockEll`` of sorted triples, at capacity (``c_cap``,
    ``k_cap``) when given (at least the matrix's own), else its own C
    rounded up to a multiple of 8 and its own K."""
    from repro_torch.core import sparse

    dev = rows.device
    w = width(n, num_blocks)
    ucols, per_col = torch.unique_consecutive(cols, return_counts=True)
    c_own, k_own = capacity(cols, n, num_blocks)
    c_cap = -(-c_own // 8) * 8 if c_cap is None else c_cap
    k_cap = k_own if k_cap is None else k_cap
    if c_cap < c_own or k_cap < k_own:
        raise ValueError(f"capacity ({c_cap}, {k_cap}) below the matrix's "
                         f"own ({c_own}, {k_own})")
    blk = ucols // w
    first = torch.searchsorted(ucols, torch.arange(num_blocks, device=dev)
                               * w)
    pos = torch.arange(ucols.numel(), device=dev) - first[blk]
    col_of = torch.repeat_interleave(
        torch.arange(ucols.numel(), device=dev), per_col)
    start = torch.cumsum(per_col, 0) - per_col
    slot = torch.arange(rows.numel(), device=dev) - start[col_of]
    col_ids = torch.zeros((num_blocks, c_cap), dtype=torch.int32, device=dev)
    col_rows = torch.zeros((num_blocks, c_cap, k_cap), dtype=torch.int32,
                           device=dev)
    col_vals = torch.zeros((num_blocks, c_cap, k_cap), dtype=torch.float32,
                           device=dev)
    col_ids[blk, pos] = (ucols - blk * w).to(torch.int32)
    col_rows[blk[col_of], pos[col_of], slot] = rows.to(torch.int32)
    col_vals[blk[col_of], pos[col_of], slot] = 1.0
    return sparse.BlockEll(col_ids=col_ids, col_rows=col_rows,
                           col_vals=col_vals, m=m, width=w, n=n,
                           nnz=int(rows.numel()))


def repair_draws(gen: torch.Generator, num_blocks: int, m: int, c: int,
                 n: int, device):
    """The random inputs of the repair, handed to the program and to the
    reference alike: a uniform in-block column per (block, row), and a
    uniform score per (block, row, stored-column position).  Where the
    blocks of width ceil(n / num_blocks) overhang the n columns, the last
    block's columns are drawn among its real ones (a draw more from
    ``gen``), never in the padding past column n."""
    from repro_torch.core import ranky

    w = width(n, num_blocks)
    random_cols = torch.randint(0, w, (num_blocks, m), generator=gen,
                                device=device, dtype=torch.int32)
    if n < num_blocks * w:
        random_cols[-1] = torch.randint(
            0, n - (num_blocks - 1) * w, (m,), generator=gen, device=device,
            dtype=torch.int32)
    scores = torch.rand((num_blocks, m, c), generator=gen, device=device)
    return ranky.RepairDraws(random_cols=random_cols, neighbor_scores=scores)
