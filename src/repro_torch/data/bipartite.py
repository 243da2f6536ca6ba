"""Paper-style bipartite datasets (the kariyer.net job-candidate matrix
is proprietary; this generator matches its published statistics: 539 jobs
x 170897 candidates, heavy-tailed degree distribution, full row rank).

Provides the workload in all three representations the pipeline accepts:
host COO (``paper_coo``), dense (``paper_matrix``: densified once for
the dense path), and the device-side blocked sparse container
(``paper_block_ell``: the sparse-native path; never densifies)."""
from __future__ import annotations

import numpy as np

from repro_torch.configs.ranky_paper import RankyPaperConfig
from repro_torch.core import sparse


def paper_coo(cfg: RankyPaperConfig) -> sparse.COOMatrix:
    coo = sparse.random_bipartite(cfg.rows, cfg.cols, cfg.density,
                                  seed=cfg.seed, power_law=True)
    return sparse.ensure_full_row_rank(coo, seed=cfg.seed)


def paper_matrix(cfg: RankyPaperConfig) -> np.ndarray:
    # The dense copy exists as the exactness oracle and as the input of
    # the dense path; the sparse path never builds it.
    return paper_coo(cfg).todense()  # ranky-lint: disable=RL104 -- oracle


def paper_block_ell(cfg: RankyPaperConfig, num_blocks: int, *,
                    device=None) -> sparse.BlockEll:
    """The paper matrix as a device-side blocked sparse container, ready
    for ``api.svd`` without densification."""
    return sparse.block_ell_from_coo(paper_coo(cfg), num_blocks,
                                     device=device)


def lonely_row_stats(a: np.ndarray, num_blocks: int) -> dict:
    """How many (block, row) pairs are lonely: the paper's rank problem
    surface area for a given block count."""
    blocks = sparse.split_blocks(a, num_blocks)
    lonely = [int((~(b != 0).any(axis=1)).sum()) for b in blocks]
    ranks = [int(np.linalg.matrix_rank(b)) for b in blocks]
    return {
        "lonely_per_block": lonely,
        "total_lonely": sum(lonely),
        "block_ranks": ranks,
        "deficient_blocks": sum(r < a.shape[0] for r in ranks),
    }
