"""``topk_score``: the k_top best items of each query of a wave, scores
``q . diag(s) V^T`` over the N items, never writing the (B, N) scores
(``csrc/topk_score.cu``: a chunk kernel and a merge kernel a call).

Counted: V (N x k float32) read once, the folded queries (B x k float32)
read once, the answer (B x k_top scores and int32 indices) written once,
and a multiply-add per (query, item, factor).  Frozen from
``chip_smoke.py``'s ``topk_bound`` (the float32 snapshot: no scale).

At a wave of 256 queries over 1,048,576 items at k = 64: 34.4 GFLOP
(0.513 ms at 67 TFLOP/s) against 268 MB (0.080 ms): operations bound it.
No cell serves waves yet; a served cell's roofline reader takes these.
"""
from __future__ import annotations

from typing import Tuple

from perfbench.counts import peaks

KERNELS = ("topk_chunk_kernel", "topk_merge_kernel")


def work(b: int, n: int, k: int, k_top: int) -> Tuple[float, float]:
    return 2.0 * b * n * k, 4.0 * n * k + 4.0 * b * k + 8.0 * b * k_top


def least_seconds(b: int, n: int, k: int, k_top: int) -> Tuple[float, str]:
    return peaks.least_seconds(*work(b, n, k, k_top))
