"""flash_attention: fused multi-head attention (online softmax, forward
only) on the GPU by a hand-written CUDA kernel (``csrc/flash_attention.cu``).

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
for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

# Number of kernel launches made by ``flash_attention`` in this process.
launches = 0

MAX_HEAD_DIM = 256     # gemma2-9b's head dim; the reference takes any
_DTYPES = (torch.float32, torch.bfloat16)
_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p)


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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version: the full (Sq, Sk) float32 score matrix, a
    masked softmax, rows that see no key set to zero."""
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
    qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    ki = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window > 0:
        mask &= (qi - ki) < window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask.any(dim=-1)[:, None], probs, 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vv)
    return out.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q (B, Hq, Sq, D) over k, v (B, Hkv, Sk, D); D <= 256 on
    the card."""
    global launches
    _check(q, k, v, window, softcap)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: unsupported device {q.device}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} > {MAX_HEAD_DIM}, "
                         f"which the kernel does not take")
    if scale is None:
        scale = d ** -0.5
    # The kernel copies rows in whole 16-byte pieces: head dims padded with
    # zeros to a multiple of 8, and rows that start 16-byte aligned.
    dp = -(-d // 8) * 8
    q, k, v = (_aligned(x, dp) for x in (q, k, v))
    fn = build.entry("ranky_flash_attention", _ARGS)
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  int(q.dtype == torch.bfloat16), b, hq, hkv, sq, sk, dp,
                  int(causal), int(window), float(softcap), float(scale),
                  torch.cuda.current_stream().cuda_stream)
    build.check(code, "flash_attention")
    launches += 1
    return out if dp == d else out[..., :d].contiguous()


def _aligned(x: torch.Tensor, dp: int) -> torch.Tensor:
    """``x`` with its last dim zero-padded to ``dp`` and its data 16-byte
    aligned (a copy only where either is not so already)."""
    if x.shape[-1] != dp:
        return torch.nn.functional.pad(x, (0, dp - x.shape[-1]))
    return x if x.data_ptr() % 16 == 0 else x.clone()
