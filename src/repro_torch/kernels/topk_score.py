"""topk_score: the top k_top items of ``qs @ v^T`` per query, on the GPU
by a hand-written CUDA kernel (``csrc/topk_score.cu``), without the (B, N)
score matrix in device memory.

Replaces the TPU kernel ``src/repro/kernels/topk_score.py``
(``_topk_score_kernel`` / ``_select_topk`` / ``topk_score``) and its
wrapper ``ops.topk_score``.  On an H100 the function is bound by the
float32 operations (2·B·N·k) at serving batch sizes and by the bytes of
``v`` at small ones; the kernel scores (32 queries x 64 columns) tiles in
4 x 4 register tiles, offers a score only if it beats its query's current
k_top-th entry (value, then index) or a bound another block published,
merges the survivors into a running top-k list per query and column chunk
by a sorted merge, then a second pass merges the per-chunk lists.  See the
note in the source.

Bit-identity with the plain version (values AND indices): both sum the k
products of a score in ascending k, each rounded on its own (no FMA), then
multiply by the item's scale; both select by (value descending, index
ascending): the plain version with a stable descending sort.
``torch.topk`` does not promise that tie order, so it is not used.

``topk_score`` uses the plain version ONLY for tensors that lie on the
CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

# Number of kernel launches made by ``topk_score`` in this process (one
# per call: the scoring pass and the merge pass count as one).
launches = 0

# Shared memory a thread block may use on Hopper (bytes).
_SMEM_LIMIT = 232_448

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p)
# Queries per thread block of the scoring pass (QB), largest first: the
# kernel is built for these two.
QUERY_TILES = (32, 8)


def _check(qs: torch.Tensor, v: torch.Tensor, k_top: int,
           scale: Optional[torch.Tensor]) -> None:
    if qs.dim() != 2 or v.dim() != 2 or qs.shape[1] != v.shape[1]:
        raise ValueError(
            f"topk_score wants (B, k) queries and (N, k) factors, got "
            f"{tuple(qs.shape)} and {tuple(v.shape)}")
    if qs.dtype != torch.float32 or v.dtype not in (torch.float32,
                                                     torch.int8):
        raise TypeError(
            f"topk_score wants float32 queries and float32 or int8 factors, "
            f"got {qs.dtype} and {v.dtype}")
    if scale is not None and (scale.shape != (v.shape[0],)
                              or scale.dtype != torch.float32):
        raise ValueError(
            f"topk_score wants an (N,) float32 scale, got "
            f"{tuple(scale.shape)} {scale.dtype}")
    if not 1 <= k_top <= v.shape[0]:
        raise ValueError(
            f"topk_score: k_top={k_top} must be in [1, N={v.shape[0]}]")
    devices = {qs.device, v.device} | ({scale.device} if scale is not None
                                       else set())
    if len(devices) != 1:
        raise ValueError("topk_score: inputs lie on different devices")


@functools.lru_cache(maxsize=None)
def _fits(k: int, k_top: int, v_bytes: int) -> Dict[int, bool]:
    """Whether pass 1 with each query tile fits a block's shared memory."""
    smem_of = build.entry("ranky_topk_score_smem", (ctypes.c_int,) * 4)
    return {qb: 0 < smem_of(qb, k, k_top, v_bytes) <= _SMEM_LIMIT
            for qb in QUERY_TILES}


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_plan(b: int, n: int, block_n: int, sms: int,
                fits: Dict[int, bool]) -> Tuple[int, int, int]:
    """(query tile, columns a chunk, chunks) of the scoring pass: the
    smallest query tile that holds all B queries, or else the largest one
    whose shared memory fits (``fits[qb]``); column chunks of whole
    ``block_n`` tiles, about two blocks per SM over all query tiles (so v
    is read once from device memory and ceil(B / qb) times from L2)."""
    usable = [qb for qb in QUERY_TILES if fits.get(qb)]
    if not usable:
        raise ValueError(
            "topk_score: this k and k_top need more shared memory than a "
            f"thread block has ({_SMEM_LIMIT} bytes)")
    qb = min((t for t in usable if t >= b), default=usable[0])
    q_tiles = -(-b // qb)
    tiles = -(-n // block_n)
    target = max(1, -(-2 * sms // q_tiles))
    chunk_cols = -(-tiles // min(tiles, target)) * block_n
    return qb, chunk_cols, -(-n // chunk_cols)


def topk_score_ref(qs: torch.Tensor, v: torch.Tensor, k_top: int, *,
                   scale: Optional[torch.Tensor] = None,
                   valid_n: Optional[int] = None,
                   index_offset: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the full (B, N) score matrix, summed one
    product at a time in ascending k, times ``scale``, columns >= valid_n
    set to -inf, then a stable descending sort."""
    _check(qs, v, k_top, scale)
    vf = v.to(torch.float32)
    acc = torch.zeros((qs.shape[0], v.shape[0]), dtype=torch.float32,
                      device=qs.device)
    for i in range(qs.shape[1]):
        acc = acc + qs[:, i, None] * vf[None, :, i]
    if scale is not None:
        acc = acc * scale[None, :]
    if valid_n is not None and valid_n < v.shape[0]:
        acc[:, max(valid_n, 0):] = float("-inf")
    vals, pos = torch.sort(acc, dim=1, descending=True, stable=True)
    return (vals[:, :k_top].contiguous(),
            (pos[:, :k_top] + index_offset).to(torch.int32))


def topk_score(qs: torch.Tensor, v: torch.Tensor, k_top: int, *,
               scale: Optional[torch.Tensor] = None,
               valid_n: Optional[int] = None, index_offset: int = 0,
               block_n: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vals (B, k_top) f32 descending, idx (B, k_top) i32) of
    ``(qs @ v^T) * scale``; ties to the lowest index, columns >= ``valid_n``
    (default N) never selected ahead of a valid one, ``index_offset``
    added to the indices.  ``qs`` (B, k) f32, ``v`` (N, k) f32 or int8,
    ``scale`` (N,) f32 or None.  ``block_n`` is the column tile: each
    thread block of the kernel scans a run of whole tiles."""
    global launches
    _check(qs, v, k_top, scale)
    if qs.shape[0] == 0:               # an empty wave: nothing to launch
        return (torch.empty((0, k_top), dtype=torch.float32,
                            device=qs.device),
                torch.empty((0, k_top), dtype=torch.int32, device=qs.device))
    if qs.device.type == "cpu":
        return topk_score_ref(qs, v, k_top, scale=scale, valid_n=valid_n,
                              index_offset=index_offset)
    if qs.device.type != "cuda":
        raise RuntimeError(f"topk_score: unsupported device {qs.device}")
    if block_n < 1:
        raise ValueError(f"topk_score: block_n={block_n} must be >= 1")
    b, k = qs.shape
    n = v.shape[0]
    dev = qs.device
    qb, chunk_cols, chunks = launch_plan(
        b, n, block_n, _sm_count(dev), _fits(k, k_top, v.element_size()))
    qs_c = qs.contiguous()
    v_c = v.contiguous()
    sc = scale.contiguous() if scale is not None else None
    fn = build.entry("ranky_topk_score", _ARGS)
    with torch.cuda.device(dev):
        # (value, index) pairs: pass 1's lists, pass 2's input
        lists = torch.empty((b, chunks, k_top, 2), dtype=torch.int32,
                            device=dev)
        bounds = torch.empty((b,), dtype=torch.int64, device=dev)
        out_v = torch.empty((b, k_top), dtype=torch.float32, device=dev)
        out_i = torch.empty((b, k_top), dtype=torch.int32, device=dev)
        code = fn(qs_c.data_ptr(), v_c.data_ptr(),
                  int(v.dtype == torch.int8),
                  sc.data_ptr() if sc is not None else None,
                  lists.data_ptr(), bounds.data_ptr(),
                  out_v.data_ptr(),
                  out_i.data_ptr(), b, k, n,
                  n if valid_n is None else int(valid_n), int(index_offset),
                  k_top, chunk_cols, chunks, qb,
                  torch.cuda.current_stream().cuda_stream)
    build.check(code, "topk_score")
    launches += 1
    return out_v, out_i
