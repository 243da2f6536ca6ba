"""sketch_panel: S = Omega E over the stored columns of every padded-ELL
block, on the GPU by a hand-written CUDA kernel (``csrc/sketch_panel.cu``).

Replaces the TPU kernel ``src/repro/kernels/sketch_panel.py``
(``_sketch_panel_kernel`` / ``sketch_panel``) and its wrapper
``ops.sketch_panel``.  On an H100 the function is bound by bytes (one
gathered Omega value per multiply-add), so the kernel is the gather form:
a thread per (l, c), a loop over the K slots in order, with Omega passed
transposed and contiguous ``(M, L)`` so that the threads of a warp read
one contiguous vector per slot.  Deterministic (fixed slot order, no
atomics).  See the note in the source.

``sketch_panel`` uses the plain version ONLY for tensors that lie on the
CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# Number of kernel launches made by ``sketch_panel`` in this process.
launches = 0

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p)


def sketch_panel_ref(omega: torch.Tensor, col_rows: torch.Tensor,
                     col_vals: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (L, M) test matrix x (D, C, K) padded-ELL
    slots -> (D, L, C) panel.

    out[d, l, c] = sum_k omega[l, rows[d, c, k]] * vals[d, c, k], as an
    O(nnz * L) gather-and-reduce over the slots, one slot index at a time
    so that no (L, C, K) intermediate is formed.  Padding slots carry
    val == 0 and are inert; duplicate (column, row) slots accumulate."""
    _check(omega, col_rows, col_vals)
    d, c, k = col_rows.shape
    l = omega.shape[0]
    out = torch.zeros((d, l, c), dtype=torch.float32, device=omega.device)
    for i in range(d):
        for s in range(k):
            gathered = omega.index_select(1, col_rows[i, :, s].long())
            out[i] += gathered * col_vals[i, :, s][None, :]
    return out


def _check(omega: torch.Tensor, col_rows: torch.Tensor,
           col_vals: torch.Tensor) -> None:
    if omega.dim() != 2:
        raise ValueError(
            f"sketch_panel wants an (L, M) omega, got {tuple(omega.shape)}")
    if col_rows.dim() != 3 or col_rows.shape != col_vals.shape:
        raise ValueError(
            f"sketch_panel wants (D, C, K) rows and vals of one shape, got "
            f"{tuple(col_rows.shape)} and {tuple(col_vals.shape)}")
    if (omega.dtype != torch.float32 or col_rows.dtype != torch.int32
            or col_vals.dtype != torch.float32):
        raise TypeError(
            f"sketch_panel wants float32 omega, int32 rows and float32 "
            f"vals, got {omega.dtype}, {col_rows.dtype}, {col_vals.dtype}")
    if not (omega.device == col_rows.device == col_vals.device):
        raise ValueError("sketch_panel: inputs lie on different devices")


def sketch_panel(omega: torch.Tensor, col_rows: torch.Tensor,
                 col_vals: torch.Tensor) -> torch.Tensor:
    """out[d] = Omega E_d over stored columns: (L, M) f32, (D, C, K) int32
    / f32 -> (D, L, C) f32.  Row indices must lie in [0, M)."""
    global launches
    _check(omega, col_rows, col_vals)
    if omega.device.type == "cpu":
        return sketch_panel_ref(omega, col_rows, col_vals)
    if omega.device.type != "cuda":
        raise RuntimeError(f"sketch_panel: unsupported device {omega.device}")
    l, m = omega.shape
    d, c, k = col_rows.shape
    # (M, L) contiguous: the L threads of a column read one vector per slot.
    omega_t = omega.T.contiguous()
    rows = col_rows.contiguous()
    vals = col_vals.contiguous()
    fn = build.entry("ranky_sketch_panel", _ARGS)
    with torch.cuda.device(omega.device):
        out = torch.empty((d, l, c), dtype=torch.float32, device=omega.device)
        code = fn(omega_t.data_ptr(), rows.data_ptr(), vals.data_ptr(),
                  out.data_ptr(), d, l, m, c, k,
                  torch.cuda.current_stream().cuda_stream)
    build.check(code, "sketch_panel")
    launches += 1
    return out
