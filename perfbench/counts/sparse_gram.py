"""``sparse_gram``: G_d = E_d E_d^T of every column block of a 0/1
matrix (``csrc/sparse_gram.cu``, five kernels a call).

Counted from the non-zeros, not the padded ELL slots: each stored
non-zero read once (its row index and its value, 4 + 4 bytes), each
output G_d (M x M float32) written once, and a multiply-add for every
pair of non-zeros that share a column (sum over columns of the column's
entries squared).  Frozen from ``chip_smoke.py``'s ``sparse_gram_bound``,
whose bytes counted the padded slots.

At the cells' shape the bound is bytes: 2,048 x 1,048,576 at density
5e-4 writes 8 x 2048^2 x 4 = 134 MB against ~2.8e6 pairs (5.6 MFLOP).
"""
from __future__ import annotations

from typing import Tuple

from perfbench.counts import peaks

# The names of the device kernels of one call (a profiler's kernel name
# holds one of them).
KERNELS = ("zero_counts", "count_cols", "scan_counts", "place_slots",
           "row_gram")


def work(nnz: int, pairs: int, m: int, num_blocks: int) -> Tuple[float, float]:
    """(operations, bytes) of one call over a matrix of ``m`` rows."""
    return 2.0 * pairs, 8.0 * nnz + 4.0 * num_blocks * m * m


def least_seconds(nnz: int, pairs: int, m: int,
                  num_blocks: int) -> Tuple[float, str]:
    return peaks.least_seconds(*work(nnz, pairs, m, num_blocks))
