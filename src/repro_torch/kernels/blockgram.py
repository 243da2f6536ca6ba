"""blockgram: G = A A^T for a stack of short-and-fat dense blocks, on the
GPU by a hand-written CUDA kernel (``csrc/blockgram.cu``).

Replaces the TPU kernel ``src/repro/kernels/blockgram.py``
(``_gram_kernel`` / ``blockgram``) and its wrapper ``ops.blockgram``.  A
pack pass reads A once into bf16 planes hi and (float32 input) mid and lo,
with hi + mid + lo = x exactly and 16-byte aligned rows, flagging where mid
and lo are non-zero; the gram runs on the tensor cores, one block per 128 x
128 tile on or above the diagonal and per slice of W (``launch_plan``),
with the six products hi.hi + hi.mid + mid.hi + mid.mid + hi.lo + lo.hi,
the mid and lo planes staged and multiplied only where flagged, float32
sums promoted out of the tensor cores every 16 columns, and the slices'
partial grams summed in a fixed order by a third small kernel.  The result
is the same bits from run to run and exactly symmetric.  The product is the kernel's own body; cuBLAS is not called.
See the note in the source.

``blockgram`` uses the plain version ONLY for tensors that lie on the CPU;
for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

# Number of kernel launches made by ``blockgram`` in this process (one per
# call, whatever the number of passes and slices).
launches = 0

TILE = 128              # output tile edge of the kernel
STAGE_COLS = 32         # columns of A per stage; slices are multiples
# The launch plan aims at about eleven blocks for each SM of an H100 SXM
# (two resident at a time), with slices of at least MIN_SLICE_COLS columns:
# at (8, 539, 21363) that is 12 slices, among the fastest of 4 to 24 slices
# timed on an H100.
PLAN_SMS = 132
PLAN_BLOCKS_PER_SM = 11
MIN_SLICE_COLS = 1024

_ARGS = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
_ENTRY = {torch.float32: "ranky_blockgram_f32",
          torch.bfloat16: "ranky_blockgram_bf16"}


def blockgram_ref(a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (D, M, W) -> (D, M, M) gram, the input
    widened to f32 first (f32 accumulation)."""
    _check(a)
    a32 = a.to(torch.float32)
    return a32 @ a32.mT


def launch_plan(d: int, m: int, w: int, dtype: torch.dtype
                ) -> Tuple[int, int]:
    """(slices, slice_cols): W cut into ``slices`` slices of ``slice_cols``
    columns (a multiple of ``STAGE_COLS``; the last may be shorter).  A
    function of the shape and type alone, so that the kernel sums in the
    same order on every call."""
    if dtype not in _ENTRY:
        raise TypeError(f"blockgram: no launch plan for {dtype}")
    tiles = -(-m // TILE)
    per_slice = max(1, d * tiles * (tiles + 1) // 2)
    want = round(PLAN_SMS * PLAN_BLOCKS_PER_SM / per_slice)
    slices = max(1, min(want, w // MIN_SLICE_COLS))
    cols = -(-max(w, 1) // slices)
    cols = -(-cols // STAGE_COLS) * STAGE_COLS
    return max(1, -(-w // cols)), cols


def work(d: int, m: int, w: int, itemsize: int) -> Tuple[float, float]:
    """The least work of one call, (bytes, operations), whatever the
    kernel's tiling: A read once at ``itemsize`` bytes and G written once
    in float32; a multiply and an add for each entry on or above the
    diagonal, per column of A: D M (M + 1) W."""
    return (float(d * m * w * itemsize + d * m * m * 4),
            float(d) * m * (m + 1) * w)


def _check(a: torch.Tensor) -> None:
    if a.dim() != 3:
        raise ValueError(
            f"blockgram wants a (D, M, W) stack, got {tuple(a.shape)}")
    if a.dtype not in _ENTRY:
        raise TypeError(
            f"blockgram wants float32 or bfloat16 input, got {a.dtype}")


def blockgram(a: torch.Tensor) -> torch.Tensor:
    """G[d] = A_d A_d^T, (D, M, W) f32 | bf16 -> (D, M, M) f32."""
    global launches
    _check(a)
    if a.device.type == "cpu":
        return blockgram_ref(a)
    if a.device.type != "cuda":
        raise RuntimeError(f"blockgram: unsupported device {a.device}")
    d, m, w = a.shape
    a = a.contiguous()
    slices, cols = launch_plan(d, m, w, a.dtype)
    stages = -(-w // STAGE_COLS)
    fn = build.entry(_ENTRY[a.dtype], _ARGS)
    with torch.cuda.device(a.device):
        def scratch(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device=a.device)
        out = scratch(d, m, m)
        part = scratch(slices, d, m, m) if slices > 1 else None
        # the packed planes (rows of stages * STAGE_COLS: hi, and mid and
        # lo for float32 input) and the mid / lo flags
        planes = [scratch(d, m, stages * STAGE_COLS, dtype=torch.bfloat16)
                  for _ in range(3 if a.dtype == torch.float32 else 1)]
        hi, mid, lo = (planes + [None, None])[:3]
        flags = torch.zeros((d, -(-m // TILE), stages), dtype=torch.int32,
                            device=a.device)

        def ptr(t):
            return None if t is None else t.data_ptr()
        code = fn(a.data_ptr(), out.data_ptr(), ptr(part), ptr(hi),
                  ptr(mid), ptr(lo), flags.data_ptr(), d, m, w, slices,
                  cols, torch.cuda.current_stream().cuda_stream)
    build.check(code, "blockgram")
    launches += 1
    return out
