"""Hierarchical / incremental Ranky SVD (paper §V future work, and the
Iwen & Ong incremental algorithm the paper builds on).

Motivation: with thousands of blocks (D >> number of devices) the proxy
matrix M x (D*M) becomes the bottleneck.  The fix is a *tree merge*:
merge panels in groups of ``fanout`` per level (each merge produces a
single M x r panel) until one panel remains.  With truncation rank
r < M this is exactly Iwen & Ong's memory-bounded incremental algorithm,
and it exposes the paper's *rank problem*: if a block's rank falls below
r (lonely rows!), the truncated merge loses components it can never
recover.  Ranky's checkers run before level 0 to prevent that.

:func:`merge_svd` is the one merge primitive: the tree below, the
streaming merge-and-truncate engine (``repro_torch.stream.ingest``) and
the scan-window driver (``repro_torch.stream.window``) all call it.
:func:`solve_hierarchical` is the host-orchestrated tree (a Python loop
over levels, every level's groups in one batched SVD); the two-level
variant scheduled over a mesh is ``core/distributed.py``'s
``two_level`` merge.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.core import ranky, sparse

# The cuSOLVER driver of the merge SVD for CUDA tensors (``driver=`` of
# ``torch.linalg.svd``; None is torch's default, the Jacobi ``gesvdj``).
# ``chip_smoke.py`` (``merge_driver_ab``) runs whole streams under both: on
# an H100 the exact paper stream ended at ||U^T U - I|| 1.1e-4 to 1.3e-4
# with ``gesvdj`` on each of three seeds (limit 1e-4) and at <= 1.3e-5
# with ``gesvd``, which takes about 2x as long; the paper's exact tree
# (``hierarchical``) at 2.8e-4 with ``gesvdj`` on its wide panels and
# 4.3e-6 with ``gesvd`` through their transpose, 4x as long.
CUDA_SVD_DRIVER: Optional[str] = "gesvd"


# Below this many bytes a tall merge panel is reduced by the port's own
# Householder QR instead of cuSOLVER's geqrf (``torch.linalg.qr``), whose
# device workspace is a fixed 3 MiB (3,146,752 B above its outputs at
# every panel of 4,096 rows and 16 to 80 columns on an H100,
# ``scripts/drift_stages_torch.py``): more than such a panel itself, and
# more than rule R5's closed form prices a small batch's whole merge at.
# Above it geqrf's workspace grows with the panel at a fraction of it.
SMALL_PANEL_BYTES = 3 << 20


def householder_qr(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unblocked Householder QR of a tall (..., m, n) panel, m > n (the
    column-by-column form of LAPACK's ``geqr2``): ``(a, tau)`` with R in
    the upper triangle of ``a`` and the reflectors' tails below it,
    ``H_j = I - tau_j v_j v_j^T``, ``v_j = [1; a[j+1:, j]]``.  It works on
    one copy of the panel and needs no workspace beyond it (one rank-1
    update a column, in place), and nothing waits for the device."""
    a = p.clone()
    *lead, m, n = a.shape
    tau = a.new_zeros((*lead, n))
    for j in range(n):
        x = a[..., j:, j]                                  # (..., m - j)
        alpha = x[..., 0].clone()
        norm = torch.linalg.vector_norm(x, dim=-1)
        live = norm > 0
        beta = torch.where(alpha >= 0, -norm, norm)
        one = torch.ones_like(norm)
        tau[..., j] = torch.where(live, (beta - alpha)
                                  / torch.where(live, beta, one), 0.0)
        x /= torch.where(live, alpha - beta, one)[..., None]
        x[..., 0] = 1.0                                    # v_j, in place
        if j + 1 < n:
            t = a[..., j:, j + 1:]
            w = x.unsqueeze(-2) @ t                        # v^T T: (.., 1, *)
            vt = (x * tau[..., j, None]).unsqueeze(-1)
            if t.dim() == 2:
                t.addmm_(vt, w, alpha=-1.0)
            else:
                t.sub_(vt * w)
        x[..., 0] = torch.where(live, beta, alpha)         # R[j, j]
    return a, tau


def householder_apply(a: torch.Tensor, tau: torch.Tensor, c: torch.Tensor
                      ) -> torch.Tensor:
    """``Q @ [c; 0]`` for the Q of :func:`householder_qr` and an (..., n,
    r) ``c``: the reflectors applied last to first to an (..., m, r)
    buffer, in place."""
    *lead, m, n = a.shape
    out = c.new_zeros((*lead, m, c.shape[-1]))
    out[..., :n, :] = c
    for j in reversed(range(n)):
        v = a[..., j:, j].clone()
        v[..., 0] = 1.0
        o = out[..., j:, :]
        w = v.unsqueeze(-2) @ o
        vt = (v * tau[..., j, None]).unsqueeze(-1)
        if o.dim() == 2:
            o.addmm_(vt, w, alpha=-1.0)
        else:
            o.sub_(vt * w)
    return out


def svd_through_transpose(p: torch.Tensor, driver: Optional[str]
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The economy ``(U, S, W^T)`` of ``P``, from the SVD of ``P^T``
    (``P^T = W S U^T``): how a wide panel reaches a driver that takes only
    tall matrices."""
    w, s, ut = torch.linalg.svd(p.mT, full_matrices=False, driver=driver)
    return ut.mT, s, w.mT


def merge_svd(p: torch.Tensor, rank: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SVD-merge a wide (M, R) panel concatenation, truncated to ``rank``.

    Returns ``(U (M, rank), S (rank,), W (R, rank))`` with
    ``P = U diag(S) W^T + (discarded tail)``; all three are zero-padded
    when ``rank > min(M, R)`` so output shapes stay static.  ``W`` is what
    streaming needs: for ``P = [V_old diag(s_old) | B^T U_b]`` it is the
    small rotation that carries the old and batch left vectors into the
    merged basis.  A leading batch axis merges every panel of the batch in
    one call (a level of the tree).

    On the GPU the SVD uses the cuSOLVER driver ``CUDA_SVD_DRIVER``
    (streaming carries U and W into every later merge, so their
    orthogonality compounds).  ``gesvd`` takes only tall matrices, so a
    wide panel (the tree's (M, fanout r) groups) is factored through its
    transpose, ``P^T = W S U^T``.  A tall panel (the stream's
    (N_pad, k + r_b)) is reduced first, ``P = Q R``, and only the small R
    is factored (``U = Q U_R``): cuSOLVER's ``gesvd`` of the panel itself
    takes a workspace several times the panel, which put a scan window of
    the paper's rows over rule R6's closed form on an H100 (PERF.md),
    where the QR needs one panel-sized Q.  A panel below
    ``SMALL_PANEL_BYTES`` is reduced by :func:`householder_qr` instead:
    geqrf's fixed workspace is larger than such a panel.
    """
    m, rtot = p.shape[-2:]
    driver = CUDA_SVD_DRIVER if p.is_cuda else None
    with obs.span("merge.svd", m=m, r_tot=rtot, rank=rank):
        if m > rtot and p.numel() * p.element_size() < SMALL_PANEL_BYTES:
            # A small tall panel: the port's Householder QR, whose only
            # buffer is one copy of the panel (see SMALL_PANEL_BYTES).
            a, tau = householder_qr(p)
            r = a[..., :rtot, :].triu()
            u_r, s, wt = torch.linalg.svd(r, full_matrices=False,
                                          driver=driver)
            u = householder_apply(a, tau, u_r[..., :rank])
            del a
        elif m > rtot:
            # Only the kept columns of U = Q U_R are formed, and Q is freed
            # before the caller's next buffer.
            q, r = torch.linalg.qr(p)
            u_r, s, wt = torch.linalg.svd(r, full_matrices=False,
                                          driver=driver)
            del r
            u = q @ u_r[..., :rank]
            del q
        elif driver == "gesvd" and m < rtot:
            u, s, wt = svd_through_transpose(p, driver)
        else:
            u, s, wt = torch.linalg.svd(p, full_matrices=False,
                                        driver=driver)
        k = min(m, rtot)
        if k < rank:
            u = torch.nn.functional.pad(u, (0, rank - k))
            s = torch.nn.functional.pad(s, (0, rank - k))
            wt = torch.nn.functional.pad(wt, (0, 0, 0, rank - k))
        return u[..., :rank], s[..., :rank], wt[..., :rank, :].mT


def _merge_group(panels: torch.Tensor, rank: int) -> torch.Tensor:
    """SVD-merge (..., G, M, r) groups of panels into (..., M, rank)
    panels ``U S``: every group of a level in one batched SVD, the
    counterpart of the reference's ``vmap`` over groups."""
    *lead, g, m, r = panels.shape
    p = panels.transpose(-3, -2).reshape(*lead, m, g * r)
    u, s, _ = merge_svd(p, rank)
    return u * s[..., None, :]


def solve_hierarchical(
    a,
    *,
    num_blocks: int,
    fanout: int = 4,
    rank: Optional[int] = None,
    method: str = "neighbor_random",
    sketch: bool = False,
    oversample: int = 8,
    power_iters: int = 2,
    want_right: bool = False,
    use_kernel: bool = False,
    key: ranky.Key = None,
    draws: Optional[ranky.RepairDraws] = None,
    omega: Optional[torch.Tensor] = None,
):
    """Tree-merged Ranky SVD: the ``backend="hierarchical"`` engine behind
    ``repro_torch.core.api.svd`` (and the legacy ``hierarchical_ranky_svd``
    shim).  Returns (U, S) with S of length ``rank`` (defaults to M: exact;
    r < M gives the truncated incremental algorithm whose failure on
    rank-deficient blocks motivates Ranky), or (U, S, V) with
    ``want_right``, V (D*W, r) in padded column order recovered per block
    as ``A_blk^T U diag(1/S)``.

    ``a`` is a dense (M, N) tensor (N must divide by num_blocks) or a
    sparse.BlockEll container (sparse-native leaves, no block ever
    densified), the same shared prologue as ``ranky.solve_single``.

    ``sketch=True`` replaces the exact gram+eigh leaves with randomized
    truncated rank-``rank`` leaf panels (``randomized.
    block_truncated_panels``): each block's (M, r) panel comes from a
    per-block (r+oversample)-row sketch in O(nnz_d * r) instead of the
    O(M^2 W + M^3) gram+eigh, and the tree merge consumes the panels
    unchanged.  Repair runs first either way: a rank-deficient block's
    lonely rows carry no sketch weight, so the truncated leaves would lose
    their components unrecoverably.

    Random inputs: ``draws`` (repair) and ``omega`` (the (L, M) test matrix
    every leaf sketches with) may be injected; otherwise they are drawn
    from ``key``.
    """
    from repro_torch.core import randomized
    from repro_torch.core import svd as lsvd

    m = a.m if isinstance(a, sparse.BlockEll) else a.shape[0]
    r = m if rank is None else min(rank, m)
    seed = ranky.seed_of(key)

    with obs.span("split_and_repair"):
        blocks = ranky.split_and_repair(a, num_blocks, method, seed,
                                        draws=draws)

    # Level 0: per-block factorization -> (D, M, r) truncated proxy panels.
    if sketch:
        panels = randomized.block_truncated_panels(
            blocks, rank=r, oversample=oversample, power_iters=power_iters,
            key=seed, omega=omega)
    else:
        with obs.span("gram_stack"):
            grams = lsvd.gram_stack(blocks, use_kernel=use_kernel)
        with obs.span("eigh_to_svd"):
            us, ss = lsvd.eigh_to_svd(grams)
        panels = (us * ss[:, None, :])[:, :, :r]

    # Tree merge, groups of ``fanout`` per level.
    while panels.shape[0] > 1:
        pad = (-panels.shape[0]) % fanout
        if pad:
            panels = torch.cat([panels,
                                panels.new_zeros((pad,) + panels.shape[1:])])
        panels = _merge_group(panels.reshape(-1, fanout, m, r), r)

    # (M, r) == U * S of A (up to unitary, exactly if r = rank(A))
    u, s, _ = merge_svd(panels[0], r)
    if not want_right:
        return u, s
    with obs.span("right_vectors_stack"):
        return u, s, ranky.right_vectors_stack(blocks, u, s)


def hierarchical_ranky_svd(
    a,
    *,
    num_blocks: int,
    fanout: int = 4,
    rank: Optional[int] = None,
    method: str = "neighbor_random",
    sketch: bool = False,
    oversample: int = 8,
    power_iters: int = 2,
    want_right: bool = False,
    key: ranky.Key = None,
):
    """DEPRECATED legacy entry point: use ``repro_torch.core.api.svd`` with
    a ``SolveConfig(backend="hierarchical", ...)``.

    Thin shim: builds the SolveConfig (centralized validation) and runs
    the same ``solve_hierarchical`` engine ``api.svd`` dispatches to.
    Returns the legacy (U, S) tuple, or (U, S, V) with ``want_right=True``
    (V in padded column order).
    """
    import warnings

    from repro_torch.core import api

    warnings.warn(
        "hierarchical_ranky_svd is deprecated; use repro_torch.core.api.svd "
        "with SolveConfig(backend='hierarchical', ...)",
        DeprecationWarning, stacklevel=2)
    cfg = api.SolveConfig(
        backend="hierarchical", method=method, num_blocks=num_blocks,
        fanout=fanout, rank=rank, sketch=sketch, oversample=oversample,
        power_iters=power_iters, want_right=want_right, key=key)
    return api._run_hierarchical(a, cfg)
