"""Hierarchical / incremental Ranky SVD: the panel merge.

Only :func:`merge_svd` is here so far: the one merge primitive of the
incremental algorithm (Iwen & Ong), which the streaming
merge-and-truncate engine (``repro_torch.stream.ingest``) calls once per
batch.  The tree merge over column blocks (``_merge_group`` /
``solve_hierarchical``) is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.stages import stage

# The cuSOLVER driver of the merge SVD for CUDA tensors (``driver=`` of
# ``torch.linalg.svd``; None is torch's default, the Jacobi ``gesvdj``).
# ``chip_smoke.py`` (``merge_driver_ab``) runs whole streams under both: on
# an H100 the exact paper stream ended at ||U^T U - I|| 1.1e-4 to 1.3e-4
# with ``gesvdj`` on each of three seeds (limit 1e-4) and at <= 1.3e-5
# with ``gesvd``, which takes about 2x as long.
CUDA_SVD_DRIVER: Optional[str] = "gesvd"


def merge_svd(p: torch.Tensor, rank: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SVD-merge a wide (M, R) panel concatenation, truncated to ``rank``.

    Returns ``(U (M, rank), S (rank,), W (R, rank))`` with
    ``P = U diag(S) W^T + (discarded tail)``; all three are zero-padded
    when ``rank > min(M, R)`` so output shapes stay static.  ``W`` is what
    streaming needs: for ``P = [V_old diag(s_old) | B^T U_b]`` it is the
    small rotation that carries the old and batch left vectors into the
    merged basis.

    On the GPU the SVD uses the cuSOLVER driver ``CUDA_SVD_DRIVER`` for
    tall panels (streaming carries U and W into every later merge, so their
    orthogonality compounds).
    """
    m, rtot = p.shape
    driver = CUDA_SVD_DRIVER if p.is_cuda and m >= rtot else None
    with stage("merge.svd"):
        u, s, wt = torch.linalg.svd(p, full_matrices=False, driver=driver)
        k = min(m, rtot)
        if k < rank:
            u = torch.nn.functional.pad(u, (0, rank - k))
            s = torch.nn.functional.pad(s, (0, rank - k))
            wt = torch.nn.functional.pad(wt, (0, 0, 0, rank - k))
        return u[:, :rank], s[:rank], wt[:rank].T
