"""``sketch_panel``: the (L, C) panel Omega E_d of every column block,
over the stored columns (``csrc/sketch_panel.cu``, one kernel a call).

Counted from the non-zeros: Omega (L x M float32) read once, each stored
non-zero read once (row index and value, 8 bytes), the panel of each
stored column written once (L x stored columns x 4 bytes; the padded
columns of the ELL are not needed), and a multiply-add per (row of Omega,
non-zero).  Frozen from ``chip_smoke.py``'s ``sketch_panel_bound``, whose
bytes counted the padded slots and columns.

At 2,048 x 1,048,576, L = 24: ~1.07e6 non-zeros (51 MFLOP) against
~8.6 MB read and 65 MB written: bytes bound it.
"""
from __future__ import annotations

from typing import Tuple

from perfbench.counts import peaks

KERNELS = ("sketch_panel_kernel",)


def work(nnz: int, stored_cols: int, l: int, m: int) -> Tuple[float, float]:
    return 2.0 * l * nnz, 4.0 * l * m + 8.0 * nnz + 4.0 * l * stored_cols


def least_seconds(nnz: int, stored_cols: int, l: int,
                  m: int) -> Tuple[float, str]:
    return peaks.least_seconds(*work(nnz, stored_cols, l, m))
