"""blockgram: G = A A^T for a stack of short-and-fat dense blocks, on the
GPU by a hand-written CUDA kernel (``csrc/blockgram.cu``).

Replaces the TPU kernel ``src/repro/kernels/blockgram.py``
(``_gram_kernel`` / ``blockgram``) and its wrapper ``ops.blockgram``.  On
an H100 the function is bound by operations (about M/2 f32 operations per
byte read), so the kernel is a shared-memory tiled product: one thread
block per 64 x 64 output tile, the W axis streamed in chunks of 32, f32
accumulation in registers, bf16 converted on load, only the tiles on or
above the diagonal computed (each stored twice, mirrored).  The product is
the kernel's own body; cuBLAS is not called.  Deterministic (fixed
summation order, no atomics) and exactly symmetric.  See the note in the
source.

``blockgram`` uses the plain version ONLY for tensors that lie on the CPU;
for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# Number of kernel launches made by ``blockgram`` in this process.
launches = 0

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p)
_ENTRY = {torch.float32: "ranky_blockgram_f32",
          torch.bfloat16: "ranky_blockgram_bf16"}


def blockgram_ref(a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (D, M, W) -> (D, M, M) gram, the input
    widened to f32 first (f32 accumulation)."""
    _check(a)
    a32 = a.to(torch.float32)
    return a32 @ a32.mT


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
    fn = build.entry(_ENTRY[a.dtype], _ARGS)
    with torch.cuda.device(a.device):
        out = torch.empty((d, m, m), dtype=torch.float32, device=a.device)
        code = fn(a.data_ptr(), out.data_ptr(), d, m, w,
                  torch.cuda.current_stream().cuda_stream)
    build.check(code, "blockgram")
    launches += 1
    return out
