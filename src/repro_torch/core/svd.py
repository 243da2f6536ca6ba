"""Local (per-block) SVD primitives, on either block representation.

Two interchangeable local factorizations of a short-and-fat block
``A_blk (M x N_b)``, both returning ``(U, S)`` with U: (M, M), S: (M,)
sorted descending:

* ``local_svd_gram``: ``G = A A^T`` (M x M) via one big product
  (optionally the hand-written blockgram kernel), then ``eigh(G)``.
  Cost: O(M^2 N) product + O(M^3) eigh.  This is the fast path; it squares
  the condition number, losing singular values below ~sqrt(eps)*smax.
* ``local_svd_exact``: ``torch.linalg.svd`` on the block (the paper's
  dgesvd analogue).  More accurate, slower.

The merge step needs only ``U @ diag(S)`` per block (the proxy panel).

Representation dispatch: ``gram_stack`` / ``local_svd_gram_stack``
accept either a dense (D, M, N_b) block stack or a
``sparse.RepairedSparseBlocks`` (the sparse-native path).  The sparse
gram is EXACT: ``G = (E + R)(E + R)^T = G_E + C + C^T + G_R`` where E is
the immutable ELL part (sparse_gram kernel or plain panel product), R the
<=1-entry-per-row repair side-band, and the cross/repair terms are
nnz-proportional tensor contractions; a block is never densified to
(M, N_b).

``use_kernel=False`` leaves the grams to plain ``torch.matmul`` products;
``use_kernel=True`` routes them through the hand-written CUDA kernels
(``repro_torch.kernels``), which take the whole (D, ...) stack in one
launch.  ``SolveConfig.use_kernel=None`` (the default) is resolved to one
of the two by :func:`resolve_use_kernel` where a config reaches the
engines: the kernels on a CUDA device, the plain products elsewhere.  ``eigh`` / ``svd`` results differ from LAPACK's in sign and in the
basis of degenerate subspaces: compare S by value and U / V by subspace.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.core import sparse


def resolve_use_kernel(use_kernel: Optional[bool], device, *,
                       local_mode: str = "gram") -> bool:
    """Whether the grams of an operand on ``device`` go through the hand
    kernels: ``SolveConfig.use_kernel`` as given when it is a bool; for
    ``None``, the kernels on a CUDA device and the plain products on any
    other (the CPU keeps the reference's ``False`` path bit for bit).
    ``local_mode="svd"`` forms no gram, so there ``None`` is ``False``."""
    if use_kernel is not None:
        return bool(use_kernel)
    return local_mode != "svd" and torch.device(device).type == "cuda"


def gram(a_blk: torch.Tensor, *, use_kernel: bool = False) -> torch.Tensor:
    """G = A_blk @ A_blk^T, optionally via the blockgram kernel."""
    if use_kernel:
        from repro_torch.kernels import ops as kops

        return kops.blockgram(a_blk[None])[0]
    return a_blk @ a_blk.T


def repair_gram_terms(
    col_ids: torch.Tensor,
    col_rows: torch.Tensor,
    col_vals: torch.Tensor,
    repair_cols: torch.Tensor,
    repair_mask: torch.Tensor,
    m: int,
) -> torch.Tensor:
    """``E R^T + (E R^T)^T + R R^T`` of one repaired sparse block, (M, M).

    * ``E R^T [r, j] = E[r, c_j] * mask_j``: a repair may hit a column E
      already stores; this is the cross term that an append-only ELL would
      silently drop.  A binary search of ``c_j`` among the sorted ids of
      the live stored columns finds the K slots of column ``c_j`` for every
      row j at once, and their values are scattered into column j of an
      (M, M) panel.  A row occurs at most once in a stored column (the
      container coalesces duplicates) and padding slots add exact zeros, so
      the scatter gives the same bits in any order.
    * ``R R^T [i, j] = mask_i mask_j [c_i == c_j]``: two repairs hitting
      the same column see each other.

    Every shape is fixed by the block's, so nothing here waits for the
    device (the scan-window step runs it once a block and batch).
    """
    c = col_ids.shape[0]
    rmask = repair_mask.to(torch.float32)
    g_r = (repair_cols[:, None] == repair_cols[None, :]).to(torch.float32) \
        * (rmask[:, None] * rmask[None, :])
    live = (col_vals != 0).any(dim=1)
    ids, perm = torch.sort(torch.where(
        live, col_ids.long(), torch.iinfo(torch.int64).max))
    at = torch.searchsorted(ids, repair_cols.long()).clamp(max=c - 1)
    hit = (ids[at] == repair_cols.long()) & repair_mask
    slot = perm[at]                                            # (M,)
    vals = col_vals[slot] * hit[:, None].to(torch.float32)     # (M, K)
    cross = torch.zeros((m, m), dtype=torch.float32, device=col_vals.device)
    cross.scatter_add_(0, col_rows[slot].long().T, vals.T)    # (M, M)
    return cross + cross.T + g_r


def sparse_gram_block(
    col_ids: torch.Tensor,
    col_rows: torch.Tensor,
    col_vals: torch.Tensor,
    repair_cols: torch.Tensor,
    repair_mask: torch.Tensor,
    m: int,
    *,
    use_kernel: bool = False,
) -> torch.Tensor:
    """Exact (M, M) gram of one repaired sparse block, never densified.

    With E the padded-ELL part and R the repair side-band (row j gains a
    1 at local column repair_cols[j] iff repair_mask[j]):

      G = E E^T  +  E R^T  +  (E R^T)^T  +  R R^T

    ``E E^T`` comes from the sparse_gram kernel (use_kernel) or from the
    (C, M) stored-column panel product; the other terms from
    :func:`repair_gram_terms`.
    """
    if use_kernel:
        from repro_torch.kernels import ops as kops

        g_e = kops.sparse_gram(col_rows[None], col_vals[None], m)[0]
    else:
        panel = sparse.stored_col_panel(col_rows, col_vals, m)  # (C, M)
        g_e = panel.T @ panel
    return g_e + repair_gram_terms(col_ids, col_rows, col_vals,
                                   repair_cols, repair_mask, m)


BlockStack = Union[torch.Tensor, "sparse.RepairedSparseBlocks"]


def gram_stack(blocks: BlockStack, *, use_kernel: bool = False) -> torch.Tensor:
    """(D, M, M) grams of a block stack, dispatching on representation:
    dense (D, M, N_b) tensor or sparse.RepairedSparseBlocks.  With
    ``use_kernel`` the E E^T (sparse) or A A^T (dense) part of every block
    comes from ONE kernel launch over the stack; the repair terms are added
    block by block with fixed shapes, so the host never waits for the
    device here."""
    if isinstance(blocks, sparse.RepairedSparseBlocks):
        ell = blocks.ell
        if use_kernel:
            from repro_torch.kernels import ops as kops

            grams = kops.sparse_gram(ell.col_rows, ell.col_vals, ell.m)
            for d in range(ell.num_blocks):
                grams[d] += repair_gram_terms(
                    ell.col_ids[d], ell.col_rows[d], ell.col_vals[d],
                    blocks.repair_cols[d], blocks.repair_mask[d], ell.m)
            return grams
        return torch.stack([
            sparse_gram_block(ell.col_ids[d], ell.col_rows[d],
                              ell.col_vals[d], blocks.repair_cols[d],
                              blocks.repair_mask[d], ell.m)
            for d in range(ell.num_blocks)])
    if use_kernel:
        from repro_torch.kernels import ops as kops

        return kops.blockgram(blocks)
    return blocks @ blocks.mT


def local_svd_gram_stack(
    blocks: BlockStack, *, use_kernel: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(U (D, M, M), S (D, M)) via gram + eigh for either representation."""
    return eigh_to_svd(gram_stack(blocks, use_kernel=use_kernel))


def eigh_to_svd(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Convert eigh(G) of a PSD gram matrix (or a (D, M, M) stack of them)
    into (U, S) sorted descending."""
    evals, evecs = torch.linalg.eigh(g)  # ascending
    evals = torch.flip(evals, dims=(-1,))
    evecs = torch.flip(evecs, dims=(-1,))
    s = torch.sqrt(torch.clamp(evals, min=0.0))
    return evecs, s


def local_svd_gram(
    a_blk: torch.Tensor, *, use_kernel: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(U, S) of a block via gram + eigh."""
    return eigh_to_svd(gram(a_blk, use_kernel=use_kernel))


def _pad_s(s: torch.Tensor, m: int) -> torch.Tensor:
    """Pad S with zeros up to M (when N_b < M) and cut it to M."""
    k = s.shape[-1]
    if k < m:
        s = torch.cat([s, s.new_zeros((*s.shape[:-1], m - k))], dim=-1)
    return s[..., :m]


def local_svd_exact(a_blk: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(U, S) of a block (or a (D, M, N_b) stack) via SVD (paper's dgesvd
    analogue), U (M, M), S padded with zeros up to M when N_b < M.

    The full form is asked for only when N_b < M (U must still be (M, M));
    otherwise the economy form gives the same U and S without the
    (N_b, N_b) right-vector buffer."""
    m, n = a_blk.shape[-2:]
    u, s, _ = torch.linalg.svd(a_blk, full_matrices=n < m)
    return u, _pad_s(s, m)


def proxy_panel(u: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The block's contribution to the proxy matrix: U @ diag(S) (one
    block, or a stack with a leading D axis)."""
    return u * s[..., None, :]


def merge_panels_svd(panels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paper-faithful merge: SVD of the proxy P = concat(panels, axis=1).

    panels: (D, M, M) stacked U^i Sigma^i panels.
    Returns (U, S) of P, equal to (U, S) of A up to block-diag unitary W.
    """
    d, m, _ = panels.shape
    p = panels.permute(1, 0, 2).reshape(m, d * m)
    # Economy SVD: V is discarded and M <= D*M, so U and S are the same
    # either way; the full form would allocate a dead (D*M, D*M)
    # right-vector buffer.
    u, s, _ = torch.linalg.svd(p, full_matrices=False)
    return u, _pad_s(s, m)


def merge_grams_eigh(grams: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beyond-paper merge: PP^T = sum_i G_i, so eigh of the summed gram
    replaces the proxy SVD entirely.

    grams: (D, M, M) local gram matrices (or a pre-reduced (M, M)).
    """
    g = grams.sum(dim=0) if grams.dim() == 3 else grams
    return eigh_to_svd(g)


def masked_inverse(s: torch.Tensor, *, rcond: float = 1e-7) -> torch.Tensor:
    """1/S where S > rcond * max(S), else 0: directions below the floor
    are dropped, never inverted (a plain 1/S gives inf on rank-deficient
    input)."""
    smax = torch.max(s)
    safe = torch.where(s == 0, torch.ones_like(s), s)
    return torch.where(s > rcond * smax, 1.0 / safe, torch.zeros_like(s))


def right_vectors(
    a_blk: torch.Tensor, u: torch.Tensor, s: torch.Tensor, *,
    rcond: float = 1e-7
) -> torch.Tensor:
    """Recover this block's slice of the right singular vectors:
    V_blk = A_blk^T @ U @ diag(1/S)  (rows of V for this block's columns).

    The paper lists right-vector recovery as future work; it falls out of
    the factorization with one local product per block (U is M x M and is
    broadcast, never the full V).
    """
    return (a_blk.T @ u) * masked_inverse(s, rcond=rcond)[None, :]


def sparse_right_vectors(
    col_ids: torch.Tensor,
    col_rows: torch.Tensor,
    col_vals: torch.Tensor,
    repair_cols: torch.Tensor,
    repair_mask: torch.Tensor,
    width: int,
    u: torch.Tensor,
    s: torch.Tensor,
    *,
    rcond: float = 1e-7,
    out: torch.Tensor = None,
) -> torch.Tensor:
    """Sparse-native right_vectors: V_blk (W, r) for one repaired sparse
    block, the stored columns' non-zeros and the repair rows of U summed
    into each row of V (``kops.right_vectors`` over a stack of one block:
    the kernel on a CUDA device, the plain panel product on the CPU).
    U may be square (exact paths) or truncated (M, r).  ``out`` (W, r),
    which may be a strided slice of a wider panel, receives the result.
    The same input gives the same bits on every call."""
    from repro_torch.kernels import ops as kops

    return kops.right_vectors(col_ids[None], col_rows[None], col_vals[None],
                              repair_cols[None], repair_mask[None], width,
                              u, s, rcond=rcond, out=out)
