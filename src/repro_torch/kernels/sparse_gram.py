"""sparse_gram: G = E E^T of every padded-ELL block, on the GPU by
hand-written CUDA kernels (``csrc/sparse_gram.cu``).

Replaces the TPU kernel ``src/repro/kernels/sparse_gram.py``
(``_sparse_gram_kernel`` / ``sparse_gram``) and its wrapper
``ops.sparse_gram``.  The kernels build a row-major index of each block's
non-zero slots on the card (integer counts, an exclusive scan, a
placement), then own the output rows: a row of at most
``entries_per_warp(M)`` entries is one warp's, a longer one a block's, whose
up to ``WARPS`` warps (one per ``SPLIT`` entries) take fixed parts of its
list.  Each list is taken in ascending slot order (sorted in shared
memory, in pieces of ``SEG_CAP``); a warp's products go into its private
shared-memory copy of the row; the copies are summed in warp order and the
row is written once.  No floating-point atomic and no zeroed (D, M, M)
output: every G[r1, r2] is summed in an order that the data alone fixes,
so the same input gives the same bits on every call, weighted data
included (exact for 0/1 data).  See the note in the source;
``tests/test_torch_kernel_numerics.py`` models the order.

``sparse_gram`` takes the container's own stacked ``(D, C, K)`` arrays (all
D blocks in one call).  It uses the plain version ONLY for tensors
that lie on the CPU; for CUDA tensors it launches the kernels or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# Number of calls of ``sparse_gram`` that launched its kernels in this
# process (one per call).
launches = 0
# Device kernels a call launches: zero counts, count, scan, place, gram.
DEVICE_KERNELS = 5

# The launch plan (the order of every sum depends on it and on the data
# alone).  Warps a block; a row of at most ``entries_per_warp(M)`` entries
# is one warp's, a longer one n entries long takes min(WARPS, ceil(n /
# SPLIT)) warps of a block; entries of a list sorted at once (a power of
# two); r2 values a pass over the list (the row copies in shared memory).
WARPS = 8
SPLIT = 32
SEG_CAP = 1024
ROW_CHUNK = 2048


def entries_per_warp(m: int) -> int:
    """The longest row one warp takes.  A warp walks its row 32 entries at
    a time, one chain of loads after another; a block's warps share a row
    but zero and sum a copy of its M floats each.  So short output rows
    go to a block sooner: 64 entries up to M = 1024 (the paper's M = 539),
    128 above (M = 2048), the fastest of 64 / 128 / 512 at each on an
    H100."""
    return 64 if m <= 1024 else 128


_ARGS = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 9 + (ctypes.c_void_p,))


def sparse_gram_ref(col_rows: torch.Tensor, col_vals: torch.Tensor,
                    m: int) -> torch.Tensor:
    """Plain PyTorch version: (D, C, K) padded-ELL slots -> (D, M, M) f32.

    Per block, scatters the slots into the (C, M) stored-column panel and
    contracts over stored columns: G[r1, r2] = sum_c P[c, r1] P[c, r2].
    Padding slots carry val == 0 and are inert; duplicate (column, row)
    slots accumulate.  One block at a time, so that the panel of a single
    block is the largest intermediate."""
    _check(col_rows, col_vals, m)
    d, c, _ = col_rows.shape
    out = torch.empty((d, m, m), dtype=torch.float32, device=col_vals.device)
    for i in range(d):
        p = torch.zeros((c, m), dtype=torch.float32, device=col_vals.device)
        p.scatter_add_(1, col_rows[i].long(), col_vals[i])
        out[i] = p.T @ p
    return out


def _check(col_rows: torch.Tensor, col_vals: torch.Tensor, m: int) -> None:
    if col_rows.dim() != 3 or col_rows.shape != col_vals.shape:
        raise ValueError(
            f"sparse_gram wants (D, C, K) rows and vals of one shape, got "
            f"{tuple(col_rows.shape)} and {tuple(col_vals.shape)}")
    if col_rows.dtype != torch.int32 or col_vals.dtype != torch.float32:
        raise TypeError(
            f"sparse_gram wants int32 rows and float32 vals, got "
            f"{col_rows.dtype} and {col_vals.dtype}")
    if col_rows.device != col_vals.device:
        raise ValueError("sparse_gram: rows and vals lie on different devices")
    if m < 1:
        raise ValueError(f"sparse_gram: m={m} must be >= 1")


def workspace_ints(d: int, c: int, k: int, m: int) -> int:
    """int32 scratch of one call: 8 counters, D M + 1 list offsets, D M
    for the list of heavy rows, D C column lengths, a rank for every slot
    (D C K) and room for every slot in the lists (D C K), whatever the
    data."""
    return 2 * d * m + 9 + d * c + 2 * d * c * k


def sparse_gram(col_rows: torch.Tensor, col_vals: torch.Tensor,
                m: int) -> torch.Tensor:
    """G[d] = E_d E_d^T, (D, C, K) int32 / f32 -> (D, M, M) f32.  Row
    indices must lie in [0, M)."""
    global launches
    _check(col_rows, col_vals, m)
    if col_vals.device.type == "cpu":
        return sparse_gram_ref(col_rows, col_vals, m)
    if col_vals.device.type != "cuda":
        raise RuntimeError(f"sparse_gram: unsupported device {col_vals.device}")
    d, c, k = col_rows.shape
    if workspace_ints(d, c, k, m) >= 2 ** 31:
        raise ValueError(
            f"sparse_gram: (D, C, K, M) = {(d, c, k, m)} needs its workspace "
            f"below 2**31 int32 (slot indices and offsets)")
    rows = col_rows.contiguous()
    vals = col_vals.contiguous()
    fn = build.entry("ranky_sparse_gram", _ARGS)
    with torch.cuda.device(vals.device):
        out = torch.empty((d, m, m), dtype=torch.float32, device=vals.device)
        ws = torch.empty(workspace_ints(d, c, k, m), dtype=torch.int32,
                         device=vals.device)
        code = fn(rows.data_ptr(), vals.data_ptr(), out.data_ptr(),
                  ws.data_ptr(), d, c, k, m, WARPS, entries_per_warp(m), SPLIT,
                  SEG_CAP, ROW_CHUNK, torch.cuda.current_stream().cuda_stream)
    build.check(code, "sparse_gram")
    launches += 1
    return out
