"""flash_attention: fused multi-head attention (online softmax) on the GPU
by a hand-written CUDA kernel (``csrc/flash_attention.cu``), differentiable.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``
(``_attn_kernel`` / ``flash_attention``) and its wrapper
``ops.flash_attention``.  GQA (query head h reads KV head h // group),
queries right-aligned against the keys by ``sk - sq``, ``causal``, a
sliding ``window``, a tanh ``softcap`` and ``scale`` (default D ** -0.5).
Inputs (B, Hq, Sq, D) and (B, Hkv, Sk, D), float32 or bfloat16, sums in
float32, output in q's dtype.  A row that sees no key comes out as zeros,
as the TPU kernel's rows do when every tile of their block is skipped.

The kernel masks ragged edges itself, so the reference wrapper's padding of
Q and KV to a common block multiple and its ``sq < 8`` fallback do not
carry over: on the card every shape goes to the kernel (head dims that are
no multiple of 8 are zero-padded here, which changes no score).  It runs on
the tensor cores: bf16 products with float32 sums, P split into two bf16
terms for bf16 inputs and q, k, v, P into three for float32 inputs, so
that both stay within the plain version's limits (see the source).  The
plain version is ``flash_attention_ref`` (the reference's
``ref.flash_attention``, with zeros instead of NaN for rows that see no
key); ``flash_attention`` takes it ONLY for tensors that lie on the CPU;
for CUDA tensors it launches the kernel or raises.  On the ``meta`` device
(the dry run, ``launch/dryrun.py``) it runs nothing: it returns empty
outputs of the kernel's shapes and charges the open cost counters the
kernel's ``work`` once.  Any other device raises.

Gradients.  Where autograd needs them (grad mode on and an input that
requires grad), ``flash_attention`` goes through ``FlashAttention``, a
``torch.autograd.Function``: its forward is the same kernel (the plain
version on the CPU), which then also writes each row's log-sum-exp; it
saves (q, k, v, out, lse), and its backward is ``flash_attention_bwd``,
the port of the reference's recompute VJP (``ref.flash_attention_vjp``):
scores rebuilt chunk by chunk of keys in float32, no (Sq, Sk) matrix
kept.  The reference has no Pallas backward kernel (its backward is that
jnp VJP, or autodiff of the jnp oracle), so the backward here is torch
ops too, never an attention library.  Two differences of form: the port
always takes the recompute backward (the reference picks it with the
``REPRO_PERF=flash_vjp`` switch; the port has no switches), and a row that
sees no key has a zero gradient (the reference's finite -1e30 sentinel
gives such a row P = 1 over every key).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch import kernels
from repro_torch.kernels import build

# Number of kernel launches made by ``flash_attention`` in this process.
launches = 0

MAX_HEAD_DIM = 256     # gemma2-9b's head dim; the reference takes any
_DTYPES = (torch.float32, torch.bfloat16)
# Keys a chunk of the backward pass (the reference's block_k).
BWD_BLOCK_K = 1024
# q, k, v, out, lse (null when not wanted); is_bf16, B, Hq, Hkv, Sq, Sk, D,
# causal, window; softcap, scale; the stream.
_ARGS = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 9 + (
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
           softcap: float) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention wants q (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D), "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] < 1 \
            or hq % k.shape[1]:
        raise ValueError(
            f"flash_attention: k, v {tuple(k.shape)} do not fit q "
            f"{tuple(q.shape)} (same B and D, Hq a multiple of Hkv)")
    if min(sq, k.shape[2], d) < 1:
        raise ValueError("flash_attention: empty sequence or head dim")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention wants q, k, v all float32 or all bfloat16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention wants contiguous q, k, v")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention: inputs lie on different devices")
    if window < 0 or softcap < 0:
        raise ValueError(f"flash_attention: window={window} and "
                         f"softcap={softcap} must be >= 0")


def visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs that the mask shows (``_mask`` over all sk
    keys, summed), in closed form a query: query i sits at key position
    i + sk - sq and sees keys [max(0, pos - window + 1), min(pos, sk -
    1)] under ``causal`` and a ``window`` (either bound dropped without
    it)."""
    total = 0
    for pos in range(sk - sq, sk):
        hi = min(pos, sk - 1) if causal else sk - 1
        lo = max(0, pos - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def work(b: int, hq: int, hkv: int, sq: int, sk: int, d: int,
         itemsize: int, *, causal: bool = True, window: int = 0,
         lse: bool = False) -> Tuple[float, float]:
    """The least work of one call, (bytes, operations), whatever the
    kernel's tiling: q, k, v read once and the output written once at
    ``itemsize`` bytes (and the float32 ``lse`` where it is wanted); a
    multiply and an add per head dim for q.k and for p.v, per visible
    (query, key) pair, per query head.  The softmax's exponentials, under
    1/(4 d) of the operations, are left out."""
    nbytes = (2 * b * hq * sq * d + 2 * b * hkv * sk * d) * itemsize
    if lse:
        nbytes += 4 * b * hq * sq
    return float(nbytes), 4.0 * b * hq * d * visible_pairs(sq, sk, causal,
                                                            window)


def _mask(sq: int, k0: int, k1: int, sk: int, causal: bool, window: int,
          device) -> torch.Tensor:
    """(Sq, k1 - k0) bool: which of keys k0..k1-1 each query sees (queries
    right-aligned against the keys by sk - sq)."""
    qi = torch.arange(sq, device=device)[:, None] + (sk - sq)
    ki = torch.arange(k0, k1, device=device)[None, :]
    mask = torch.ones((sq, k1 - k0), dtype=torch.bool, device=device)
    if causal:
        mask &= qi >= ki
    if window > 0:
        mask &= (qi - ki) < window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, scale: Optional[float] = None,
                        return_lse: bool = False):
    """Plain PyTorch version: the full (Sq, Sk) float32 score matrix, a
    masked softmax, rows that see no key set to zero.  With
    ``return_lse=True`` also each row's float32 log-sum-exp of its visible
    scores (-inf where it sees none), the kernel's second output."""
    _check(q, k, v, window, softcap)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    kk = k.float().repeat_interleave(group, dim=1)
    vv = v.float().repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    mask = _mask(sq, 0, sk, sk, causal, window, q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask.any(dim=-1)[:, None], probs, 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vv).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def _kernel(q, k, v, causal, window, softcap, scale, want_lse):
    """The CUDA kernel: (out, lse or None)."""
    global launches
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} > {MAX_HEAD_DIM}, "
                         f"which the kernel does not take")
    # The kernel copies rows in whole 16-byte pieces: head dims padded with
    # zeros to a multiple of 8, and rows that start 16-byte aligned.
    dp = -(-d // 8) * 8
    q, k, v = (_aligned(x, dp) for x in (q, k, v))
    fn = build.entry("ranky_flash_attention", _ARGS)
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        lse = torch.empty((b, hq, sq), dtype=torch.float32,
                          device=q.device) if want_lse else None
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr() if want_lse else None,
                  int(q.dtype == torch.bfloat16), b, hq, hkv, sq, sk, dp,
                  int(causal), int(window), float(softcap), float(scale),
                  torch.cuda.current_stream().cuda_stream)
    build.check(code, "flash_attention")
    launches += 1
    return (out if dp == d else out[..., :d].contiguous()), lse


def _meta(q, k, causal, window, want_lse):
    """On ``meta``: empty outputs of the kernel's shapes, and the kernel's
    ``work`` charged to the open cost counters (``kernels.charge_meta``);
    nothing runs."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    kernels.charge_meta("flash_attention", *work(
        b, hq, hkv, sq, sk, d, q.element_size(), causal=causal,
        window=window, lse=want_lse))
    lse = torch.empty((b, hq, sq), dtype=torch.float32,
                      device="meta") if want_lse else None
    return torch.empty_like(q), lse


def _forward(q, k, v, causal, window, softcap, scale, want_lse):
    """(out, lse or None): the kernel on a CUDA tensor, the plain version
    on a CPU one, the kernel's shapes and charge on ``meta``."""
    if q.device.type == "cpu":
        out = flash_attention_ref(q, k, v, causal=causal, window=window,
                                  softcap=softcap, scale=scale,
                                  return_lse=want_lse)
        return out if want_lse else (out, None)
    if q.device.type == "meta":
        return _meta(q, k, causal, window, want_lse)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: unsupported device {q.device}")
    return _kernel(q, k, v, causal, window, softcap, scale, want_lse)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        scale: Optional[float] = None,
                        block_k: int = BWD_BLOCK_K):
    """(dq, dk, dv) in the inputs' dtypes, from the forward's output and
    row log-sum-exp: per chunk of ``min(block_k, Sk)`` keys (the last one
    ragged), in float32, P = exp(S - lse) on the visible keys, dV = P^T dO,
    dS = P o (dO V^T - delta) with delta = sum(dO o O), times the softcap's
    derivative 1 - (S_cap / cap)^2, dQ = dS K scale and dK = dS^T Q scale,
    the query heads of a group summed into their KV head.  A row that sees
    no key (lse = -inf) has P = 0: it adds nothing and gets a zero dQ."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    q32 = q.float() * scale
    do = dout.float()
    delta = torch.sum(do * out.float(), dim=-1, keepdim=True)
    lse4 = lse.float()[..., None]
    dq = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, hkv, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    blk = min(block_k, sk)
    for k0 in range(0, sk, blk):
        k1 = min(k0 + blk, sk)
        kb = k[:, :, k0:k1].float().repeat_interleave(group, dim=1)
        vb = v[:, :, k0:k1].float().repeat_interleave(group, dim=1)
        s_cap = torch.matmul(q32, kb.transpose(-1, -2))
        if softcap > 0.0:
            s_cap = softcap * torch.tanh(s_cap / softcap)
        mask = _mask(sq, k0, k1, sk, causal, window, q.device)
        p = torch.exp(torch.where(mask, s_cap - lse4, float("-inf")))
        dv_c = torch.matmul(p.transpose(-1, -2), do)
        ds = p * (torch.matmul(do, vb.transpose(-1, -2)) - delta)
        if softcap > 0.0:
            ds = ds * (1.0 - torch.square(s_cap / softcap))
        dq += torch.matmul(ds, kb) * scale
        dk_c = torch.matmul(ds.transpose(-1, -2), q32)
        # fold the query heads of a group back into their KV head
        dk[:, :, k0:k1] = dk_c.reshape(b, hkv, group, k1 - k0, d).sum(dim=2)
        dv[:, :, k0:k1] = dv_c.reshape(b, hkv, group, k1 - k0, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with the recompute backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        out, lse = _forward(q, k, v, causal, window, softcap, scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, softcap, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, softcap, scale = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=causal, window=window,
                                         softcap=softcap, scale=scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q (B, Hq, Sq, D) over k, v (B, Hkv, Sk, D); D <= 256 on
    the card.  Differentiable in q, k and v."""
    _check(q, k, v, window, softcap)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, softcap, scale)
    return _forward(q, k, v, causal, window, softcap, scale, False)[0]


def _aligned(x: torch.Tensor, dp: int) -> torch.Tensor:
    """``x`` with its last dim zero-padded to ``dp`` and its data 16-byte
    aligned (a copy only where either is not so already)."""
    if x.shape[-1] != dp:
        return torch.nn.functional.pad(x, (0, dp - x.shape[-1]))
    return x if x.data_ptr() % 16 == 0 else x.clone()
