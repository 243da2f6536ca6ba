"""sparse_gram: G = E E^T of every padded-ELL block, on the GPU by a
hand-written CUDA kernel (``csrc/sparse_gram.cu``).

Replaces the TPU kernel ``src/repro/kernels/sparse_gram.py``
(``_sparse_gram_kernel`` / ``sparse_gram``) and its wrapper
``ops.sparse_gram``.  On an H100 the function is bound by bytes (the
(D, M, M) output and 8 bytes per ELL slot; the arithmetic is a few
multiply-adds per stored column), so the kernel is the nnz-proportional
atomic form: one thread per stored column, one f32 ``atomicAdd`` per
ordered pair of its non-zero slots.  Bit-stable from run to run for 0/1
data (integer partial sums); for weighted data the order of the atomics
varies and results agree to f32 rounding.  See the note in the source.

``sparse_gram`` takes the container's own stacked ``(D, C, K)`` arrays (D
is a grid axis of the kernel).  It uses the plain version ONLY for tensors
that lie on the CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# Number of kernel launches made by ``sparse_gram`` in this process.
launches = 0

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


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
    rows = col_rows.contiguous()
    vals = col_vals.contiguous()
    fn = build.entry("ranky_sparse_gram", _ARGS)
    with torch.cuda.device(vals.device):
        out = torch.zeros((d, m, m), dtype=torch.float32, device=vals.device)
        code = fn(rows.data_ptr(), vals.data_ptr(), out.data_ptr(), d, c, k,
                  m, torch.cuda.current_stream().cuda_stream)
    build.check(code, "sparse_gram")
    launches += 1
    return out
