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
it launches the kernel or raises.  On the ``meta`` device (the dry run,
``launch/dryrun.py``) it runs nothing: it returns empty outputs of the
kernel's shapes and charges the open cost counters the kernel's ``work``
once.  Any other device raises.

Gradients.  Where autograd needs them (grad mode on and an input that
requires grad), ``ssd_scan`` goes through ``SSDScan``, a
``torch.autograd.Function`` whose forward is the same kernel (the plain
version on the CPU).  It saves its inputs, and its backward recomputes
``ssd_scan_chunked`` (the port of the reference's own chunked twin of the
kernel, ``ref.ssd_scan_chunked``) under autograd in float32 and returns
its gradients for x, dt, a, B and C, given those of y and of the final
state.  The reference has no Pallas backward kernel (its backward is
autodiff of jnp), so this one is torch ops too.  Differences of form: the
port always takes the chunked recompute (the reference picks the chunked
scan with the ``REPRO_PERF=ssd_chunked`` switch; the port has no
switches), and a length that is no multiple of the chunk is padded with
x = 0 and dt = 0 (a step of decay exp(0) = 1 that adds nothing: y and the
final state are unchanged), where the reference falls back to the
sequential oracle.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch import kernels
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
# Steps per chunk of ``ssd_scan_chunked`` (the reference's default).
BWD_CHUNK = 128
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


def ssd_scan_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     b_mat: torch.Tensor, c_mat: torch.Tensor, *,
                     chunk: int = BWD_CHUNK
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD in torch ops, in float32: (y in x's dtype, final
    state float32).  Per chunk of ``min(chunk, L)`` steps (a ragged length
    padded with x = dt = 0): with la the cumulative sum of dt a in the
    chunk, y_i = sum_{j <= i} (C_i . B_j) exp(la_i - la_j) dt_j x_j +
    exp(la_i) C_i h_in, and the state carried to the next chunk h_out =
    exp(la_last) h_in + sum_j exp(la_last - la_j) dt_j x_j outer B_j.  The
    intra-chunk terms of every chunk are batched; only the (B, H, P, N)
    state walks the chunks.  exp(la_i - la_j) for j > i is taken as
    exp(-inf) = 0 (masked before the exponential), so that a large
    positive difference makes no inf in the backward pass."""
    bsz, seq, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    q = min(chunk, seq)
    nc = -(-seq // q)
    pad = nc * q - seq

    def chunked(t):
        t = t.float()
        if pad:
            t = torch.nn.functional.pad(
                t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape((bsz, nc, q) + t.shape[2:])

    x32, dt32 = chunked(x), chunked(dt)                    # (B, c, Q, H[, P])
    br = chunked(b_mat).repeat_interleave(rep, dim=3)      # (B, c, Q, H, N)
    cr = chunked(c_mat).repeat_interleave(rep, dim=3)
    la = torch.cumsum(dt32 * a.float(), dim=2)             # (B, c, Q, H)
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    lat = la.transpose(2, 3)                               # (B, c, H, Q)
    diff = torch.where(tri, lat[..., :, None] - lat[..., None, :],
                       float("-inf"))
    cb = torch.einsum("bcihn,bcjhn->bchij", cr, br)
    scores = cb * torch.exp(diff) * dt32.transpose(2, 3)[..., None, :]
    y = torch.einsum("bchij,bcjhp->bcihp", scores, x32)
    # each chunk's own contribution to the state it hands on
    w = torch.exp(la[:, :, -1:] - la) * dt32               # (B, c, Q, H)
    upd = torch.einsum("bcihp,bcihn->bchpn", x32 * w[..., None], br)
    last = torch.exp(la[:, :, -1])                         # (B, c, H)
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(state)
        state = last[:, c, :, None, None] * state + upd[:, c]
    ch = torch.einsum("bcihn,bchpn->bcihp", cr, torch.stack(h_in, dim=1))
    y = y + torch.exp(la)[..., None] * ch
    y = y.reshape(bsz, nc * q, h, p)[:, :seq]
    return y.to(x.dtype), state


def _meta(x, b_mat):
    """On ``meta``: empty outputs of the kernel's shapes, and the kernel's
    ``work`` charged to the open cost counters (``kernels.charge_meta``);
    nothing runs."""
    bsz, seq, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    kernels.charge_meta("ssd_scan", *work(bsz, seq, h, g, p, n,
                                          x.element_size()))
    return torch.empty_like(x), torch.empty((bsz, h, p, n),
                                            dtype=torch.float32,
                                            device="meta")


def _forward(x, dt, a, b_mat, c_mat):
    """The kernel on a CUDA tensor, the plain version on a CPU one, the
    kernel's shapes and charge on ``meta``."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, a, b_mat, c_mat)
    if x.device.type == "meta":
        return _meta(x, b_mat)
    if x.device.type != "cuda":
        raise RuntimeError(f"ssd_scan: unsupported device {x.device}")
    return _kernel(x, dt, a, b_mat, c_mat)


class SSDScan(torch.autograd.Function):
    """``ssd_scan`` with the chunked recompute backward."""

    @staticmethod
    def forward(ctx, x, dt, a, b_mat, c_mat):
        y, h_fin = _forward(x, dt, a, b_mat, c_mat)
        ctx.save_for_backward(x, dt, a, b_mat, c_mat)
        return y, h_fin

    @staticmethod
    def backward(ctx, gy, gh):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = ssd_scan_chunked(*inputs, chunk=BWD_CHUNK)
        pairs = [(o, g) for o, g in zip(outs, (gy, gh)) if g is not None]
        if not pairs:
            return (None,) * 5
        grads = torch.autograd.grad([o for o, _ in pairs],
                                    inputs, [g for _, g in pairs],
                                    allow_unused=True)
        return tuple(gr if need else None for gr, need
                     in zip(grads, ctx.needs_input_grad))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_mat: torch.Tensor, c_mat: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, L, H, P), final state (B, H, P, N) float32).  On the card:
    P <= 128 and N <= 128, each a multiple of 4.  Differentiable in every
    input."""
    _check(x, dt, a, b_mat, c_mat)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a, b_mat, c_mat)):
        return SSDScan.apply(x, dt, a, b_mat, c_mat)
    return _forward(x, dt, a, b_mat, c_mat)


def _kernel(x, dt, a, b_mat, c_mat):
    """The CUDA kernel: (y, final state)."""
    global launches
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
