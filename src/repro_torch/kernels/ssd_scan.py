"""ssd_scan: the Mamba-2 SSD chunked scan on the GPU by a hand-written CUDA
kernel (``csrc/ssd_scan.cu``).

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py`` (``_ssd_kernel``
/ ``ssd_scan``) and its wrapper ``ops.ssd_scan``.  Per batch and head:
h_t = exp(dt_t a_h) h_{t-1} + (dt_t x_t) outer B_t, y_t = h_t C_t, heads
sharing B and C in groups of H // G.  x (B, L, H, P) and dt (B, L, H) in
x's dtype (float32 or bfloat16), a (H,) float32, B and C (B, L, G, N) in
x's dtype; returns y (B, L, H, P) in x's dtype and the final state
(B, H, P, N) in float32.

For bf16 inputs the kernel runs its four products on the tensor cores, with
the float32 intermediates (G, the state, x o w) split into bf16 hi + lo
terms; float32 inputs take a kernel of float32 FMAs on the CUDA cores.
P and N may be any multiple of 4 up to 128 (the reference takes any size;
no config of the repo needs more than 128: mamba2-1.3b has N = 128).  The
kernel walks the sequence in chunks (``chunk_for``) and masks a ragged
last chunk itself, so the reference wrapper's fallback to the
sequential oracle when ``L % chunk != 0`` does not carry over: on the card
every length goes to the kernel.  The plain version ``ssd_scan_ref`` is the
sequential recurrence of the reference's ``ref.ssd_scan``;
``ssd_scan`` takes it ONLY for tensors that lie on the CPU; for CUDA tensors
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

# Number of kernel launches made by ``ssd_scan`` in this process.
launches = 0

# Steps per chunk of the bf16 kernel (launched with 4 warps a block: of the
# launch shapes 64 x 2, 64 x 4 and 128 x 4, 64 x 4 measured fastest on an
# H100, PERF.md; the C entry refuses a chunk other than its MMA_CHUNK) and
# of the float32 kernel (128 steps for N <= 64; above, 64, so that its
# shared memory fits a block; the C entry refuses a float32 chunk over its
# budget, F32_SMEM_MAX).
CHUNK = 64
F32_CHUNK = 128
F32_CHUNK_WIDE = 64
MAX_HEAD_DIM = 128    # P
MAX_STATE = 128       # N
_DTYPES = (torch.float32, torch.bfloat16)
_ARGS = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)


def chunk_for(dtype: torch.dtype, n: int) -> int:
    """Steps per chunk of the kernel that takes inputs of ``dtype`` at
    state size ``n``."""
    if dtype == torch.bfloat16:
        return CHUNK
    return F32_CHUNK if n <= 64 else F32_CHUNK_WIDE


def work(b: int, seq: int, h: int, g: int, p: int, n: int,
         itemsize: int) -> Tuple[float, float]:
    """The least work of one call, (bytes, operations), whatever the
    kernel's tiling: x, dt, B and C read once and y written once at
    ``itemsize`` bytes, ``a`` read and the final state written in float32;
    the recurrence's 4 P N operations a step and head (h <- decay h +
    dt x outer B and y = h C, P N multiply-adds each).  Its B L H
    exponentials, under 1e-4 of the operations at P = N = 64, are left
    out."""
    nbytes = (2 * b * seq * h * p + b * seq * h + 2 * b * seq * g * n) \
        * itemsize + 4 * h + 4 * b * h * p * n
    return float(nbytes), 4.0 * b * seq * h * p * n


def _check(x, dt, a, b_mat, c_mat) -> None:
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b_mat.dim() != 4 \
            or c_mat.shape != b_mat.shape:
        raise ValueError(
            f"ssd_scan wants x (B, L, H, P), dt (B, L, H), a (H,), b, c "
            f"(B, L, G, N), got {tuple(x.shape)}, {tuple(dt.shape)}, "
            f"{tuple(a.shape)}, {tuple(b_mat.shape)}, {tuple(c_mat.shape)}")
    bsz, seq, h, _ = x.shape
    g = b_mat.shape[2]
    if dt.shape != (bsz, seq, h) or a.shape != (h,) \
            or b_mat.shape[:2] != (bsz, seq) or g < 1 or h % g:
        raise ValueError(
            f"ssd_scan: shapes do not fit: x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, a {tuple(a.shape)}, b {tuple(b_mat.shape)} "
            f"(H must be a multiple of G)")
    if x.dtype not in _DTYPES or dt.dtype != x.dtype \
            or b_mat.dtype != x.dtype or c_mat.dtype != x.dtype \
            or a.dtype != torch.float32:
        raise TypeError(
            f"ssd_scan wants x, dt, b, c all float32 or all bfloat16 and a "
            f"float32, got {x.dtype}, {dt.dtype}, {b_mat.dtype}, "
            f"{c_mat.dtype}, {a.dtype}")
    tensors = (x, dt, a, b_mat, c_mat)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan wants contiguous inputs")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("ssd_scan: inputs lie on different devices")


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b_mat: torch.Tensor, c_mat: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the sequential recurrence, one step at a
    time, in float32."""
    _check(x, dt, a, b_mat, c_mat)
    bsz, seq, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    x32 = x.float()
    dt32 = dt.float()
    b32 = b_mat.float().repeat_interleave(rep, dim=2)      # (B, L, H, N)
    c32 = c_mat.float().repeat_interleave(rep, dim=2)
    decay = torch.exp(dt32 * a.float()[None, None, :])       # (B, L, H)
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(seq):
        upd = (dt32[:, t, :, None, None] * x32[:, t, :, :, None]) \
            * b32[:, t, :, None, :]
        state = decay[:, t, :, None, None] * state + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, c32[:, t]))
    y = torch.stack(ys, dim=1).to(x.dtype)                   # (B, L, H, P)
    return y, state


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_mat: torch.Tensor, c_mat: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, L, H, P), final state (B, H, P, N) float32).  On the card:
    P <= 128 and N <= 128, each a multiple of 4."""
    global launches
    _check(x, dt, a, b_mat, c_mat)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, a, b_mat, c_mat)
    if x.device.type != "cuda":
        raise RuntimeError(f"ssd_scan: unsupported device {x.device}")
    bsz, seq, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if not (p % 4 == 0 and 4 <= p <= MAX_HEAD_DIM
            and n % 4 == 0 and 4 <= n <= MAX_STATE):
        raise ValueError(
            f"ssd_scan: head dim P={p} and state N={n} must be multiples of "
            f"4 in [4, {MAX_HEAD_DIM}] and [4, {MAX_STATE}] for the kernel")
    # cp.async copies 16-byte pieces of x, B and C: a view whose start is
    # not 16-byte aligned is copied into a fresh (aligned) tensor first
    x, b_mat, c_mat = (t if t.data_ptr() % 16 == 0 else t.clone()
                       for t in (x, b_mat, c_mat))
    fn = build.entry("ranky_ssd_scan", _ARGS)
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        h_fin = torch.empty((bsz, h, p, n), dtype=torch.float32,
                            device=x.device)
        code = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                  b_mat.data_ptr(), c_mat.data_ptr(), y.data_ptr(),
                  h_fin.data_ptr(), int(x.dtype == torch.bfloat16), bsz,
                  seq, h, g, p, n, chunk_for(x.dtype, n),
                  torch.cuda.current_stream().cuda_stream)
    build.check(code, "ssd_scan")
    launches += 1
    return y, h_fin
