"""Plain arithmetic of a sparse 0/1 matrix held as (rows, cols) triples,
in float64 for the reference, or in float32 with every product's inputs
rounded to TF32 for the control (the precision just below the float32
with TF32 off that the configurations state).

It knows nothing of the program: no container, no kernel, no draw of its
own.  The triples are the benchmark's; the repair's random inputs are
handed to it as tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# Rows of a dense panel gathered at once by the sparse products.
_CHUNK = 1 << 16


@dataclasses.dataclass(frozen=True)
class Precision:
    """float64 (the reference) or float32 with TF32-rounded inputs to
    every product (the control)."""

    dtype: torch.dtype
    tf32: bool

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        return tf32_round(x) if self.tf32 else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.cast(a) @ self.cast(b)


REFERENCE = Precision(torch.float64, False)
CONTROL = Precision(torch.float32, True)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, to nearest, ties to
    even (what a tensor core does to the inputs of a TF32 product)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def block_width(n: int, num_blocks: int) -> int:
    """Columns a block, ceil(n / num_blocks): where ``num_blocks`` does not
    divide n, the last block ends at column n, short of a full width."""
    return -(-n // num_blocks)


def repair(rows: torch.Tensor, cols: torch.Tensor, *, m: int, n: int,
           num_blocks: int, random_cols: torch.Tensor,
           scores: torch.Tensor, valid_m: Optional[int] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """NeighborRandomChecker on (rows, cols) sorted by (column, row).

    Row r (< ``valid_m``) with no entry in column block d is lonely there.
    Its neighbors are the rows that share a column with it anywhere; its
    candidates the columns of block d where a neighbor has an entry.  It
    gets a 1 at the candidate of the highest score, the score of column c
    being ``scores[d, r, i]`` with i the place of c among block d's
    non-empty columns in ascending order, and at ``random_cols[d, r]``
    (an in-block column) when it has no candidate.  Returns the triples
    with the repairs, sorted again, and the number of repairs."""
    w = block_width(n, num_blocks)
    valid_m = m if valid_m is None else valid_m
    blk = cols // w
    add_r, add_c = [], []
    for d in range(num_blocks):
        in_d = blk == d
        present = torch.zeros(m, dtype=torch.bool, device=rows.device)
        present[rows[in_d]] = True
        lonely = torch.nonzero(~present[:valid_m]).squeeze(1)
        if lonely.numel() == 0:
            continue
        stored = torch.unique(cols[in_d])                    # ascending
        for r in lonely.tolist():
            mine = cols[rows == r]
            nbrs = torch.unique(rows[torch.isin(cols, mine)])
            nbrs = nbrs[nbrs != r]
            cand = torch.unique(cols[in_d & torch.isin(rows, nbrs)])
            if cand.numel():
                place = torch.searchsorted(stored, cand)
                pick = cand[torch.argmax(scores[d, r, place])]
            else:
                pick = d * w + random_cols[d, r].long()
            add_r.append(r)
            add_c.append(int(pick))
    if not add_r:
        return rows, cols, 0
    dev = rows.device
    rows = torch.cat([rows, torch.tensor(add_r, device=dev)])
    cols = torch.cat([cols, torch.tensor(add_c, device=dev)])
    key = torch.unique(cols * m + rows)
    return key % m, key // m, len(add_r)


def gram(rows: torch.Tensor, cols: torch.Tensor, m: int,
         dtype: torch.dtype) -> torch.Tensor:
    """A A^T (m x m): one count for every pair of entries that share a
    column (exact: the counts are integers)."""
    g = torch.zeros((m, m), dtype=dtype, device=rows.device)
    _, per_col = torch.unique_consecutive(cols, return_counts=True)
    start = torch.repeat_interleave(torch.cumsum(per_col, 0) - per_col,
                                    per_col)
    end = start + torch.repeat_interleave(per_col, per_col)
    idx = torch.arange(rows.numel(), device=rows.device)
    ones = torch.ones(rows.numel(), dtype=dtype, device=rows.device)
    for shift in range(-int(per_col.max()) + 1, int(per_col.max())):
        j = idx + shift
        ok = (j >= start) & (j < end)
        g.index_put_((rows[ok], rows[j[ok]]), ones[ok], accumulate=True)
    return g


def a_times(rows: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
            m: int, prec: Precision) -> torch.Tensor:
    """A x for a dense (n, r) panel x: (m, r)."""
    x = prec.cast(x)
    out = torch.zeros((m, x.shape[1]), dtype=prec.dtype, device=x.device)
    for lo in range(0, rows.numel(), _CHUNK):
        sl = slice(lo, lo + _CHUNK)
        out.index_add_(0, rows[sl], x[cols[sl]])
    return out


def at_times(rows: torch.Tensor, cols: torch.Tensor, y: torch.Tensor,
             col_lo: int, col_hi: int, prec: Precision) -> torch.Tensor:
    """Rows ``col_lo:col_hi`` of A^T y for a dense (m, r) panel y, with
    (rows, cols) sorted by column: (col_hi - col_lo, r)."""
    y = prec.cast(y)
    lo, hi = torch.searchsorted(
        cols, torch.tensor([col_lo, col_hi], device=cols.device)).tolist()
    out = torch.zeros((col_hi - col_lo, y.shape[1]), dtype=prec.dtype,
                      device=y.device)
    for a in range(lo, hi, _CHUNK):
        sl = slice(a, min(hi, a + _CHUNK))
        out.index_add_(0, cols[sl] - col_lo, y[rows[sl]])
    return out


def eigh_desc(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    evals, evecs = torch.linalg.eigh(g)
    return torch.flip(evals, (-1,)), torch.flip(evecs, (-1,))


def lowrank_gap(u1, s1, v1, u2, s2, v2) -> float:
    """||U1 S1 V1^T - U2 S2 V2^T||_F / ||U2 S2 V2^T||_F in float64 over
    every direction, from (r x r) products only: the factorization
    compared at once, blind to the signs and rotations an SVD is free to
    choose."""
    u1, s1, v1, u2, s2, v2 = (t.double() for t in (u1, s1, v1, u2, s2, v2))

    def inner(ua, sa, va, ub, sb, vb):
        return float(((sa[:, None] * (ua.T @ ub) * sb[None, :])
                      * (va.T @ vb)).sum())

    xx = inner(u1, s1, v1, u1, s1, v1)
    yy = inner(u2, s2, v2, u2, s2, v2)
    xy = inner(u1, s1, v1, u2, s2, v2)
    return max(xx + yy - 2.0 * xy, 0.0) ** 0.5 / max(yy, 1e-300) ** 0.5


def s_gap(s: torch.Tensor, s_ref: torch.Tensor) -> float:
    """max |S - S_ref| over S_ref's largest."""
    s, s_ref = s.double(), s_ref.double()
    if s.shape != s_ref.shape:
        return float("inf")
    return float((s - s_ref).abs().max() / s_ref.abs().max())
