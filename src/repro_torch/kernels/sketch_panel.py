"""sketch_panel: S = Omega E over the stored columns of every padded-ELL
block, on the GPU by a hand-written CUDA kernel (``csrc/sketch_panel.cu``).
Omega is one (L, M) matrix for every block or a (D, L, M) stack, Omega_d for
block d (the power passes of per-block sketches, whose Q_d differ).

Replaces the TPU kernel ``src/repro/kernels/sketch_panel.py``
(``_sketch_panel_kernel`` / ``sketch_panel``) and its wrapper
``ops.sketch_panel``.  One launch: persistent blocks walk tiles of stored
columns whose slots reach shared memory through a ``cp.async`` ring; a
block covers all of L, so each slot is read once, and its threads run over
the flattened (column, l) tile, gathering each slot's L-vector of Omega
from L2 along l.  Omega is read through its strides (``omega_route``): its
own memory when that is (M, L)-contiguous, else, when it is
(L, M)-contiguous (as both callers in the solver pass it), a workspace the
kernel fills itself behind a grid barrier.  Only an Omega contiguous in
neither layout costs a copy (``device_kernels``).  Each output sums its
slots in ascending k, one rounded multiply and one rounded add a slot, as
``sketch_panel_ref`` does: the same bits on every call.  See the note in
the source.

``sketch_panel`` uses the plain version ONLY for tensors that lie on the
CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# Number of kernel launches made by ``sketch_panel`` in this process (one
# per call).
launches = 0

_ARGS = ((ctypes.c_void_p,) + (ctypes.c_longlong,) * 3 + (ctypes.c_int,)
         + (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,))


def sketch_panel_ref(omega: torch.Tensor, col_rows: torch.Tensor,
                     col_vals: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (L, M) test matrix (or a (D, L, M) stack, one
    a block) x (D, C, K) padded-ELL slots -> (D, L, C) panel.

    out[d, l, c] = sum_k omega_d[l, rows[d, c, k]] * vals[d, c, k], as an
    O(nnz * L) gather-and-reduce over the slots, one slot index at a time
    so that no (L, C, K) intermediate is formed.  Padding slots carry
    val == 0 and are inert; duplicate (column, row) slots accumulate."""
    _check(omega, col_rows, col_vals)
    d, c, k = col_rows.shape
    l = omega.shape[-2]
    out = torch.zeros((d, l, c), dtype=torch.float32, device=omega.device)
    for i in range(d):
        om = omega[i] if omega.dim() == 3 else omega
        for s in range(k):
            gathered = om.index_select(1, col_rows[i, :, s].long())
            out[i] += gathered * col_vals[i, :, s][None, :]
    return out


def _check(omega: torch.Tensor, col_rows: torch.Tensor,
           col_vals: torch.Tensor) -> None:
    if col_rows.dim() != 3 or col_rows.shape != col_vals.shape:
        raise ValueError(
            f"sketch_panel wants (D, C, K) rows and vals of one shape, got "
            f"{tuple(col_rows.shape)} and {tuple(col_vals.shape)}")
    if not (omega.dim() == 2
            or (omega.dim() == 3 and omega.shape[0] == col_rows.shape[0])):
        raise ValueError(
            f"sketch_panel wants an (L, M) omega or a (D, L, M) stack with "
            f"D = {col_rows.shape[0]}, got {tuple(omega.shape)}")
    if (omega.dtype != torch.float32 or col_rows.dtype != torch.int32
            or col_vals.dtype != torch.float32):
        raise TypeError(
            f"sketch_panel wants float32 omega, int32 rows and float32 "
            f"vals, got {omega.dtype}, {col_rows.dtype}, {col_vals.dtype}")
    if not (omega.device == col_rows.device == col_vals.device):
        raise ValueError("sketch_panel: inputs lie on different devices")


def omega_route(l: int, m: int, strides) -> str:
    """How the kernel reads an (L, M) Omega with element ``strides``:
    "gather" (its memory is (M, L)-contiguous), "transpose" (it is
    (L, M)-contiguous: the kernel transposes it into a workspace first) or
    "copy" (neither: the wrapper copies it to (M, L) first, a second
    launch)."""
    s_l, s_m = strides
    if s_m == l and (s_l == 1 or l == 1):
        return "gather"
    if s_m == 1 and s_l == m:
        return "transpose"
    return "copy"


def device_kernels(l: int, m: int, strides) -> int:
    """Device kernels that one call launches: 1, or 2 where Omega is copied
    first."""
    return 2 if omega_route(l, m, strides) == "copy" else 1


def sketch_panel(omega: torch.Tensor, col_rows: torch.Tensor,
                 col_vals: torch.Tensor) -> torch.Tensor:
    """out[d] = Omega_d E_d over stored columns: (L, M) or (D, L, M) f32,
    (D, C, K) int32 / f32 -> (D, L, C) f32.  Row indices must lie in
    [0, M)."""
    global launches
    _check(omega, col_rows, col_vals)
    if omega.device.type == "cpu":
        return sketch_panel_ref(omega, col_rows, col_vals)
    if omega.device.type != "cuda":
        raise RuntimeError(f"sketch_panel: unsupported device {omega.device}")
    l, m = omega.shape[-2:]
    d, c, k = col_rows.shape
    od = omega.shape[0] if omega.dim() == 3 else 1
    route = omega_route(l, m, omega.stride()[-2:])
    if route == "copy":
        omega = omega.mT.contiguous().mT      # (M, L) memory: "gather"
    rows = col_rows.contiguous()
    vals = col_vals.contiguous()
    fn = build.entry("ranky_sketch_panel", _ARGS)
    with torch.cuda.device(omega.device):
        out = torch.empty((d, l, c), dtype=torch.float32, device=omega.device)
        ws = (torch.empty((od, m, l), dtype=torch.float32,
                          device=omega.device)
              if route == "transpose" else None)
        s_l, s_m = omega.stride()[-2:]
        s_d = omega.stride(0) if od > 1 else 0
        code = fn(omega.data_ptr(), s_d, s_l, s_m, od, rows.data_ptr(),
                  vals.data_ptr(), out.data_ptr(),
                  None if ws is None else ws.data_ptr(), d, l, m, c, k,
                  torch.cuda.current_stream().cuda_stream)
    build.check(code, "sketch_panel")
    launches += 1
    return out
