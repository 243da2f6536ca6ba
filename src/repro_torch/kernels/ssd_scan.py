"""ssd_scan: the Mamba-2 SSD chunked scan on the GPU by a hand-written CUDA
kernel (``csrc/ssd_scan.cu``).

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py`` (``_ssd_kernel``
/ ``ssd_scan``) and its wrapper ``ops.ssd_scan``.  Per batch and head:
h_t = exp(dt_t a_h) h_{t-1} + (dt_t x_t) outer B_t, y_t = h_t C_t, heads
sharing B and C in groups of H // G.  x (B, L, H, P) and dt (B, L, H) in
x's dtype (float32 or bfloat16), a (H,) float32, B and C (B, L, G, N) in
x's dtype; returns y (B, L, H, P) in x's dtype and the final state
(B, H, P, N) in float32.

The kernel walks the sequence in chunks of ``CHUNK`` steps and masks a
ragged last chunk itself, so the reference wrapper's fallback to the
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

# Steps per chunk: the reference's default.  Within these the kernel's
# shared memory (x, B^T, C^T, G, the state: at most 178 KB) fits a thread
# block.
CHUNK = 128
MAX_HEAD_DIM = 64     # P
MAX_STATE = 64        # N
_DTYPES = (torch.float32, torch.bfloat16)
_ARGS = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)


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
    P <= 64 and N <= 64, each a multiple of 4."""
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
    fn = build.entry("ranky_ssd_scan", _ARGS)
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        h_fin = torch.empty((bsz, h, p, n), dtype=torch.float32,
                            device=x.device)
        code = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                  b_mat.data_ptr(), c_mat.data_ptr(), y.data_ptr(),
                  h_fin.data_ptr(), int(x.dtype == torch.bfloat16), bsz,
                  seq, h, g, p, n, CHUNK,
                  torch.cuda.current_stream().cuda_stream)
    build.check(code, "ssd_scan")
    launches += 1
    return y, h_fin
