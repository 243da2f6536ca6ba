"""right_vectors: V = A^T U diag(1/S) of every repaired padded-ELL block of a
stack, on the GPU by hand-written CUDA kernels (``csrc/right_vectors.cu``).

Replaces no TPU kernel: the JAX package computes this as a jnp product
(``src/repro/core/svd.py:195``, ``sparse_right_vectors``: the (C, M) panel
of the stored columns times U, scattered to the columns' ids, plus the
repair rows of U).  On the card that product was a dense float32 GEMM of a
panel > 99.9 % zeros.  What bounds the kernels is the bytes of V, (D*W, r)
floats written once; U (M, r) is read through L2.  They build an integer
index of each output row's non-zero terms on the card (counts, a scan, a
placement, each row's terms in the order the data fixes), then one owner
per output row sums ``value * U[row, :]`` over its terms, the stored
columns' non-zero slots in slot order and then the repair rows in
ascending row order, one rounded multiply and one rounded add a term,
multiplies by the masked 1/S and stores the row once, evict-first.  A row
without terms is written as zeros by the same pass.  No floating-point
atomic and no host sync: the same input gives the same bits on every call.
See the note in the source; ``tests/test_torch_right_vectors.py`` models
the order.

``right_vectors`` takes the whole (D, ...) stack in one call.  It uses the
plain version ONLY for tensors that lie on the CPU; for CUDA tensors it
launches the kernels or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# Number of calls of ``right_vectors`` that launched its kernels in this
# process (one per call).
launches = 0
# Device work a call puts on the stream: the memset of the counts, then
# count, tile sums, tile scan, place, fill, 1/S and the row sums; one more
# (a copy, ``rows_of``) where U's columns are strided.
DEVICE_KERNELS = 8

# The row pass (csrc/right_vectors.cu): threads a block, groups of floats a
# thread holds; the scan's tile.
ROW_THREADS = 256
GROUPS = 4
SCAN_TILE = 4096

_ARGS = ((ctypes.c_void_p,) * 6 + (ctypes.c_longlong, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_longlong,
                                   ctypes.c_void_p)
         + (ctypes.c_int,) * 7 + (ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p))


def right_vectors_ref(col_ids, col_rows, col_vals, repair_cols, repair_mask,
                      width: int, u: torch.Tensor, s: torch.Tensor, *,
                      rcond: float = 1e-7,
                      out: torch.Tensor = None) -> torch.Tensor:
    """Plain PyTorch version, block by block: the (C, M) stored-column panel
    times U scattered to the columns' ids, plus the repair rows of U summed
    in row order (``sparse.segment_sum``), times the masked 1/S.  Padding
    columns add exact zeros to local column 0."""
    from repro_torch.core import sparse
    from repro_torch.core.svd import masked_inverse

    d, w, r = _check(col_ids, col_rows, col_vals, repair_cols, repair_mask,
                     width, u, s, out)
    m = u.shape[0]
    if out is None:
        out = torch.empty((d * w, r), dtype=u.dtype, device=u.device)
    inv = masked_inverse(s, rcond=rcond)[None, :]
    view = out.view(d, w, r)
    for i in range(d):
        panel = sparse.stored_col_panel(col_rows[i], col_vals[i], m)
        atu = view[i].zero_()
        atu.index_add_(0, col_ids[i].long(), panel @ u)
        del panel
        order, offsets = sparse.sorted_segments(
            torch.where(repair_mask[i], repair_cols[i].long(), w), w)
        atu += sparse.segment_sum(u[order], offsets)
        atu.mul_(inv)
    return out


def _check(col_ids, col_rows, col_vals, repair_cols, repair_mask, width, u,
           s, out):
    """(D, W, r) of a call, or raise."""
    if (col_ids.dim() != 2 or col_rows.dim() != 3
            or col_rows.shape != col_vals.shape
            or col_rows.shape[:2] != col_ids.shape):
        raise ValueError(
            f"right_vectors wants (D, C) ids and (D, C, K) rows and vals, got "
            f"{tuple(col_ids.shape)}, {tuple(col_rows.shape)} and "
            f"{tuple(col_vals.shape)}")
    d = col_ids.shape[0]
    if (repair_cols.dim() != 2 or repair_cols.shape != repair_mask.shape
            or repair_cols.shape[0] != d):
        raise ValueError(
            f"right_vectors wants (D, Mr) repair cols and mask with D = {d}, "
            f"got {tuple(repair_cols.shape)} and {tuple(repair_mask.shape)}")
    if u.dim() != 2 or s.shape != (u.shape[1],):
        raise ValueError(
            f"right_vectors wants u (M, r) and s (r,), got {tuple(u.shape)} "
            f"and {tuple(s.shape)}")
    if repair_cols.shape[1] > u.shape[0]:
        raise ValueError(
            f"right_vectors: {repair_cols.shape[1]} repair rows, U has "
            f"{u.shape[0]}")
    if (col_ids.dtype != torch.int32 or col_rows.dtype != torch.int32
            or col_vals.dtype != torch.float32
            or repair_mask.dtype != torch.bool
            or u.dtype != torch.float32 or s.dtype != torch.float32):
        raise TypeError(
            f"right_vectors wants int32 ids and rows, float32 vals, u and s "
            f"and a bool mask, got {col_ids.dtype}, {col_rows.dtype}, "
            f"{col_vals.dtype}, {u.dtype}, {s.dtype}, {repair_mask.dtype}")
    if repair_cols.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"right_vectors wants integer repair cols, got "
                        f"{repair_cols.dtype}")
    tensors = (col_ids, col_rows, col_vals, repair_cols, repair_mask, u, s)
    if any(t.device != u.device for t in tensors):
        raise ValueError("right_vectors: inputs lie on different devices")
    r = u.shape[1]
    if out is not None and (out.shape != (d * width, r)
                            or out.dtype != torch.float32
                            or out.device != u.device
                            or (r > 1 and out.stride(1) != 1)):
        raise ValueError(
            f"right_vectors: out must be float32 ({d * width}, {r}) with "
            f"unit column stride on {u.device}, got {tuple(out.shape)} "
            f"{out.dtype} strides {out.stride()} on {out.device}")
    return d, width, r


def row_plan(r: int, vec4: bool):
    """(vec, tpr) of the row pass: floats a load and store (4 where U and
    V allow float4, else 1), and threads an output row, a power of two up
    to ROW_THREADS, enough that each holds at most GROUPS groups of vec
    floats (r = 2,048: 128 threads of 4 float4; r = 16: one thread)."""
    vec = 4 if vec4 else 1
    per = -(-(r // vec) // GROUPS)
    tpr = 1
    while tpr < per and tpr < ROW_THREADS:
        tpr *= 2
    return vec, tpr


def rows_of(u: torch.Tensor) -> torch.Tensor:
    """U as the kernel reads it: its own memory where its columns are
    contiguous (any row stride), else a contiguous copy (eigh's U is
    column-major: 16.8 MB at 2,048 x 2,048)."""
    return u if u.shape[1] <= 1 or u.stride(1) == 1 else u.contiguous()


def vec4_ok(r: int, u: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether the row pass may move U and V as float4: r, both row
    strides and both starts on 16 bytes."""
    return (r % 4 == 0 and u.stride(0) % 4 == 0 and out.stride(0) % 4 == 0
            and u.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)


def workspace_bytes(d: int, c: int, k: int, mr: int, w: int, r: int) -> int:
    """Scratch of one call, each part from a 16-byte boundary: packed counts
    (D*W + 1) and tile sums int64, an int4 and an int32 an entry (D*C +
    D*Mr entries), a term (int2) a slot or repair row, 1/S."""
    n = d * w + 1
    entries = d * c + d * mr
    parts = (8 * n, 8 * -(-n // SCAN_TILE), 16 * entries, 4 * entries,
             8 * (d * c * k + d * mr), 4 * r)
    return sum(-(-p // 16) * 16 for p in parts)


def right_vectors(col_ids, col_rows, col_vals, repair_cols, repair_mask,
                  width: int, u: torch.Tensor, s: torch.Tensor, *,
                  rcond: float = 1e-7,
                  out: torch.Tensor = None) -> torch.Tensor:
    """V[d*W + j] = (A_d^T U)[j] * (masked 1/S) for local column j of block
    d, A_d the ELL part of block d (ids (D, C), rows / vals (D, C, K)) plus
    its repair side-band (cols (D, Mr), mask (D, Mr)): (D*W, r) float32,
    into ``out`` where given (a strided column slice of a wider panel is
    taken).  U (M, r) may be a column slice; S (r,)."""
    global launches
    d, w, r = _check(col_ids, col_rows, col_vals, repair_cols, repair_mask,
                     width, u, s, out)
    if u.device.type == "cpu":
        return right_vectors_ref(col_ids, col_rows, col_vals, repair_cols,
                                 repair_mask, width, u, s, rcond=rcond,
                                 out=out)
    if u.device.type != "cuda":
        raise RuntimeError(f"right_vectors: unsupported device {u.device}")
    _, c, k = col_rows.shape
    mr = repair_cols.shape[1]
    m = u.shape[0]
    if max(d * w + 1, d * c + d * mr, d * c * k + d * mr) >= 2 ** 31:
        raise ValueError(
            f"right_vectors: (D, W, C, K, Mr) = {(d, w, c, k, mr)} needs its "
            f"bins, entries and terms below 2**31 (int32 offsets)")
    if out is None:
        out = torch.empty((d * w, r), dtype=torch.float32, device=u.device)
    if d * w == 0 or r == 0:
        return out
    u = rows_of(u)
    ids, rows, vals = (t.contiguous() for t in (col_ids, col_rows, col_vals))
    rcols = repair_cols.to(torch.int32).contiguous()
    rmask = repair_mask.contiguous()
    s = s.contiguous()
    vec, tpr = row_plan(r, vec4_ok(r, u, out))
    fn = build.entry("ranky_right_vectors", _ARGS)
    with torch.cuda.device(u.device):
        ws = torch.empty(workspace_bytes(d, c, k, mr, w, r),
                         dtype=torch.uint8, device=u.device)
        code = fn(ids.data_ptr(), rows.data_ptr(), vals.data_ptr(),
                  rcols.data_ptr(), rmask.data_ptr(), u.data_ptr(),
                  u.stride(0), s.data_ptr(), out.data_ptr(), out.stride(0),
                  ws.data_ptr(), d, c, k, mr, w, m, r, rcond, vec,
                  tpr.bit_length() - 1,
                  torch.cuda.current_stream().cuda_stream)
    build.check(code, "right_vectors")
    launches += 1
    return out
