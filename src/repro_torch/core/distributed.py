"""Distributed Ranky SVD over a block mesh: the ``backend="shard_map"``
engine.

The input matrix is column-split into one block a mesh slot, which *is* the
paper's block decomposition mapped onto the mesh
(``core/collectives.py``: a :class:`~repro_torch.core.collectives.LocalMesh`
holds every slot in one process, a
:class:`~repro_torch.core.collectives.ProcessGroupMesh` one slot a rank).
Everything (rank repair, local factorization, merge) runs in the shard
functions below, written once over the process's (n_local, ...) stack of
blocks: on a local mesh every kernel launches once over the D-stack, on a
rank once over its block.

Merge modes
  * ``proxy`` (paper-faithful): all-gather the M x M proxy panels
    ``U^i Sigma^i`` and SVD the proxy (once a process).
  * ``gram`` (beyond-paper): PP^T == sum_i G_i, so a single psum of the
    M x M local grams + one eigh replaces gather + proxy SVD.

Two-level merge (``hierarchical=True`` with two axes, e.g. ("pod",
"model")): merge within the inner axis first, then across the outer
axis, a 2-level tree scheduled to match the network hierarchy.

Draws.  Slot d repairs block d with ``ranky._block_seeds(seed, method,
d)``, exactly what ``split_and_repair`` hands block d, and the sketch's
Omega comes from the solve's key: for one seed the repair here equals the
single-host engine's bit for bit, and the factors agree to float32
rounding (the sums across blocks run in the collectives' order).  The
reference folds the flat device index into its key instead, so its
``shard_map`` and ``single`` draws differ; the parity tests inject the
reference's draws (``draws=`` covers every block, ``omega=`` the sketch).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.core import randomized, ranky, sparse
from repro_torch.core import svd as lsvd
from repro_torch.core.collectives import BlockMesh


def local_blocks(a, mesh: BlockMesh, num_blocks: int):
    """The local slots' blocks of a normalized input: the (n_local, M, W)
    dense stack of a (M, D*W) matrix, or a BlockEll of the local blocks
    (the input itself on a local mesh, which holds every slot)."""
    if not isinstance(a, sparse.BlockEll):
        a = ranky.dense_block_stack(a, num_blocks)
    if mesh.n_local == num_blocks:
        return a
    slots = list(mesh.local_slots)
    if isinstance(a, sparse.BlockEll):
        return sparse.BlockEll(a.col_ids[slots], a.col_rows[slots],
                               a.col_vals[slots], m=a.m, width=a.width,
                               n=a.n)
    return a[slots]


def _local_repair(blocks: torch.Tensor, mesh: BlockMesh, axes, method: str,
                  seed: int, draws=None) -> torch.Tensor:
    """Rank-repair the local dense blocks; neighbor methods need the
    *global* row adjacency = psum of the binarized local grams (the same
    booleans as ``ranky.row_adjacency`` of the whole matrix)."""
    _, m, w = blocks.shape
    adj = None
    if method in ("neighbor", "neighbor_random"):
        b = (blocks != 0).to(torch.float32)
        adj = mesh.psum(b @ b.mT, axes)[0]
        adj = (adj > 0) & ~torch.eye(m, dtype=torch.bool, device=adj.device)
    return ranky.repair_blocks(blocks, mesh.local_slots, method, seed, m=m,
                               width=w, row_adj=adj, draws=draws)


def _sparse_local_repair(ell: "sparse.BlockEll", mesh: BlockMesh, axes,
                         method: str, seed: int, draws=None
                         ) -> "sparse.RepairedSparseBlocks":
    """Sparse-native twin of :func:`_local_repair`: the global row
    adjacency is the psum of the binarized grams of the stored-column
    panels ((C, M) a block, nnz-proportional).  As in ``split_and_repair``
    it is formed only when some block of the mesh has a lonely row (a
    psum of the local counts decides, on every slot alike)."""
    m = ell.m
    adj = None
    if method in ("neighbor", "neighbor_random"):
        lonely = ranky.sparse_lonely_rows(ell.col_rows, ell.col_vals, m)
        if bool(mesh.psum(lonely.sum(dim=1), axes)[0] > 0):
            counts = torch.empty((mesh.n_local, m, m), dtype=torch.float32,
                                 device=ell.device)
            for i in range(mesh.n_local):
                p = sparse.stored_col_panel(ell.col_rows[i], ell.col_vals[i],
                                            m, binarize=True)
                counts[i] = p.T @ p
            adj = ((mesh.psum(counts, axes)[0] > 0)
                   & ~torch.eye(m, dtype=torch.bool, device=ell.device))
        else:
            adj = torch.zeros((m, m), dtype=torch.bool, device=ell.device)
    rc, rm = ranky.repair_blocks(ell, mesh.local_slots, method, seed, m=m,
                                 width=ell.width, row_adj=adj, draws=draws)
    return sparse.RepairedSparseBlocks(ell, rc, rm)


def _local_factorize(blocks, local_mode: str, use_kernel: bool):
    if local_mode == "gram":
        return lsvd.local_svd_gram_stack(blocks, use_kernel=use_kernel)
    if local_mode == "svd":
        return lsvd.local_svd_exact(blocks)
    raise ValueError(f"unknown local_mode {local_mode!r}")


def _merge_proxy_over(panels: torch.Tensor, mesh: BlockMesh, axes, *,
                      over=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-gather panels over ``axes`` and SVD each gathered proxy: (U, S)
    with a leading dimension of the axes the result still varies over."""
    gathered = mesh.all_gather(panels, axes, over=over)   # (G, D_axes, M, M)
    outs = [lsvd.merge_panels_svd(p) for p in gathered]
    return (torch.stack([u for u, _ in outs]),
            torch.stack([s for _, s in outs]))


def _merge(panels: torch.Tensor, mesh: BlockMesh, axes, hierarchical: bool
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The proxy merge of the local (n_local, M, M) panels: flat, or in two
    levels (inner axis, then the outer ones) over a two-axis mesh."""
    with obs.span("merge_panels_svd"):
        if hierarchical and len(axes) > 1:
            inner, outer = axes[-1:], axes[:-1]
            u1, s1 = _merge_proxy_over(panels, mesh, inner)   # per outer
            u, s = _merge_proxy_over(lsvd.proxy_panel(u1, s1), mesh, outer,
                                     over=outer)
        else:
            u, s = _merge_proxy_over(panels, mesh, axes)
    return u[0], s[0]


def _svd_shard_fn(blocks: torch.Tensor, mesh: BlockMesh, *, axes,
                  method: str, local_mode: str, merge_mode: str,
                  hierarchical: bool, use_kernel: bool, want_right: bool,
                  rank: Optional[int], oversample: int, power_iters: int,
                  seed: int, draws=None, omega=None):
    """The dense shard function over the local (n_local, M, W) stack."""
    with obs.span("split_and_repair"):
        blk = _local_repair(blocks, mesh, axes, method, seed, draws)
    m = blk.shape[1]

    if rank is not None:
        # Randomized truncated path: the (L, M) pullback / (L, L) sketch
        # gram are the only collectives; the merge modes do not apply.
        _, sketch, pullback = randomized._stack_ops(blk, summed=False)
        out = randomized.randomized_tail_over(
            sketch, pullback, mesh, m, rank=rank, oversample=oversample,
            power_iters=power_iters, key=seed, want_right=want_right,
            omega=omega, axes=axes)
        if not want_right:
            return out
        u, s, v = out
        return u, s, v.reshape(-1, rank)

    if merge_mode == "gram":
        with obs.span("gram_stack"):
            g = lsvd.gram_stack(blk, use_kernel=use_kernel)
        with obs.span("merge_grams_eigh"):
            u, s = lsvd.eigh_to_svd(mesh.psum(g, axes)[0])
    elif merge_mode == "proxy":
        u_i, s_i = _local_factorize(blk, local_mode, use_kernel)
        u, s = _merge(lsvd.proxy_panel(u_i, s_i), mesh, axes, hierarchical)
    else:
        raise ValueError(f"unknown merge_mode {merge_mode!r}")

    if not want_right:
        return u, s
    with obs.span("right_vectors_stack"):
        return u, s, ranky.right_vectors_stack(blk, u, s)


def _sparse_svd_shard_fn(ell: "sparse.BlockEll", mesh: BlockMesh, *, axes,
                         method: str, merge_mode: str, hierarchical: bool,
                         use_kernel: bool, want_right: bool,
                         rank: Optional[int], oversample: int,
                         power_iters: int, seed: int, draws=None,
                         omega=None):
    """The sparse shard function over the local blocks' ELL arrays: the
    merge is representation-agnostic (the same psum of grams / gather of
    panels as the dense shard function)."""
    with obs.span("split_and_repair"):
        rep = _sparse_local_repair(ell, mesh, axes, method, seed, draws)
    m = ell.m

    if rank is not None:
        _, sketch, pullback = randomized._stack_ops(rep, summed=False)
        out = randomized.randomized_tail_over(
            sketch, pullback, mesh, m, rank=rank, oversample=oversample,
            power_iters=power_iters, key=seed, want_right=want_right,
            omega=omega, axes=axes)
        if not want_right:
            return out
        u, s, v = out
        return u, s, v.reshape(-1, rank)

    with obs.span("gram_stack"):
        g_local = lsvd.gram_stack(rep, use_kernel=use_kernel)
    if merge_mode == "gram":
        with obs.span("merge_grams_eigh"):
            u, s = lsvd.eigh_to_svd(mesh.psum(g_local, axes)[0])
    elif merge_mode == "proxy":
        with obs.span("eigh_to_svd"):
            u_i, s_i = lsvd.eigh_to_svd(g_local)
        u, s = _merge(lsvd.proxy_panel(u_i, s_i), mesh, axes, hierarchical)
    else:
        raise ValueError(f"unknown merge_mode {merge_mode!r}")

    if not want_right:
        return u, s
    with obs.span("right_vectors_stack"):
        return u, s, ranky.right_vectors_stack(rep, u, s)


def solve_shard_map(a, mesh: BlockMesh, *, block_axes: Sequence[str],
                    config, draws=None, omega=None):
    """The ``backend="shard_map"`` engine behind ``repro_torch.core.api.svd``
    (and the legacy ``distributed_ranky_svd`` shim): unpacks the validated
    ``api.SolveConfig`` and runs the shard functions."""
    return _solve_shard_map(
        a, mesh,
        block_axes=tuple(block_axes),
        method=config.method,
        local_mode=config.local_mode,
        merge_mode=config.merge_mode,
        hierarchical=config.two_level,
        use_kernel=config.use_kernel,   # None: resolved on mesh.device
        want_right=config.want_right,
        rank=config.rank,
        oversample=config.oversample,
        power_iters=config.power_iters,
        key=config.resolved_key(),
        draws=draws, omega=omega,
    )


def _solve_shard_map(
    a,
    mesh: BlockMesh,
    *,
    block_axes: Sequence[str] = ("model",),
    method: str = "neighbor_random",
    local_mode: str = "gram",
    merge_mode: str = "gram",
    hierarchical: bool = False,
    use_kernel: Optional[bool] = None,
    want_right: bool = False,
    rank: Optional[int] = None,
    oversample: int = 8,
    power_iters: int = 2,
    key: ranky.Key = None,
    draws: Optional[ranky.RepairDraws] = None,
    omega: Optional[torch.Tensor] = None,
):
    """Distributed Ranky SVD of a column-split short-and-fat matrix.

    Args:
      a: dense (M, N) tensor (N must divide by the product of the block
        axes' sizes), or a sparse.BlockEll with one block a slot, in which
        case the whole pipeline is sparse-native (gram-local only; the
        merge collectives are the dense path's).  Every process passes the
        whole input; each takes its own slots' blocks.
      mesh: the block mesh; it runs on ``mesh.device``.
      block_axes: the mesh axes the columns (= paper blocks) split over:
        a non-empty subset of the axes, in mesh order; the block index is
        the flat index over them and the slots along the other axes hold
        the same block (``BlockMesh.block_mesh``).  ``("pod", "model")`` +
        ``hierarchical=True`` gives the two-level merge.
      rank: rank=k switches to the randomized truncated sketch path: rank
        repair still runs per slot, then the only collectives are an
        (L, M) psum per power pass plus one (L, L) psum.

    Returns (U, S), the same on every process, or (U, S, V) with V the
    local blocks' rows, (n_local * W, r) in padded column order: the whole
    V on a local mesh, this rank's block on a process group.
    """
    # Slots along the axes outside block_axes hold the same block: the
    # solve runs once a block, on the mesh of the block axes.
    mesh = mesh.block_mesh(block_axes)
    axes = mesh.axis_names
    use_kernel = lsvd.resolve_use_kernel(use_kernel, mesh.device,
                                         local_mode=local_mode)
    seed = ranky.seed_of(key)
    d_total = mesh.axis_size(axes)
    common = dict(axes=axes, method=method, merge_mode=merge_mode,
                  hierarchical=hierarchical, use_kernel=use_kernel,
                  want_right=want_right, rank=rank, oversample=oversample,
                  power_iters=power_iters, seed=seed, draws=draws,
                  omega=omega)

    if isinstance(a, sparse.BlockEll):
        if a.num_blocks != d_total:
            raise ValueError(
                f"BlockEll has {a.num_blocks} blocks; mesh axes {axes} "
                f"give {d_total} devices (one block per device)")
        if local_mode == "svd":
            raise ValueError(
                "the sparse path is gram-native; use local_mode='gram'")
        ell = local_blocks(a.to(mesh.device), mesh, d_total)
        return _sparse_svd_shard_fn(ell, mesh, **common)

    a = torch.as_tensor(a).to(device=mesh.device, dtype=torch.float32)
    if a.shape[1] % d_total:
        raise ValueError(
            f"dense a has N={a.shape[1]} columns; mesh axes {axes} give "
            f"{d_total} devices and N must divide evenly (pad with "
            f"sparse.pad_to_block_multiple first — zero columns change "
            f"nothing about U or S)")
    blocks = local_blocks(a, mesh, d_total)
    return _svd_shard_fn(blocks, mesh, local_mode=local_mode, **common)


def distributed_ranky_svd(
    a,
    mesh: BlockMesh,
    *,
    block_axes: Sequence[str] = ("model",),
    method: str = "neighbor_random",
    local_mode: str = "gram",
    merge_mode: str = "gram",
    hierarchical: bool = False,
    use_kernel: Optional[bool] = None,
    want_right: bool = False,
    rank: Optional[int] = None,
    oversample: int = 8,
    power_iters: int = 2,
    key: ranky.Key = None,
):
    """DEPRECATED legacy entry point: use ``repro_torch.core.api.svd``
    with a ``SolveConfig(backend="shard_map", ...)`` and ``mesh=`` /
    ``block_axes=``.

    Thin shim: builds the SolveConfig (centralized validation) and runs
    the same ``solve_shard_map`` engine ``api.svd`` dispatches to.
    """
    import warnings

    from repro_torch.core import api

    warnings.warn(
        "distributed_ranky_svd is deprecated; use repro_torch.core.api.svd "
        "with SolveConfig(backend='shard_map', ...) and mesh=",
        DeprecationWarning, stacklevel=2)
    cfg = api.SolveConfig(
        backend="shard_map", method=method, local_mode=local_mode,
        merge_mode=merge_mode, two_level=hierarchical,
        use_kernel=use_kernel, want_right=want_right, rank=rank,
        oversample=oversample, power_iters=power_iters, key=key)
    return solve_shard_map(a, mesh, block_axes=block_axes, config=cfg)
