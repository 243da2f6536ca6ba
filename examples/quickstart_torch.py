"""Quickstart (PyTorch/CUDA port): the SVD of a large sparse matrix through
the one front door, ``repro_torch.core.api.svd``.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Builds a paper-style sparse bipartite matrix and solves it with a single
call: ``svd(a, SolveConfig(...)) -> SVDResult``.  The input can be a
dense array or tensor, a host COO matrix, or a device BlockEll container
(one adapter normalizes them) and ``backend="auto"`` lets the planner
pick the strategy (exact gram, randomized sketch, hierarchical) from
memory estimates; ``backend="shard_map"`` splits the columns over a block
mesh.  The result carries the explainable plan and solve diagnostics.  Every result is checked against numpy's SVD of the same
matrix.  Runs on the GPU unless ``--device`` says otherwise.
"""
import argparse
import json

import numpy as np

from repro_torch.core import sparse
from repro_torch.core.api import ASpec, SolveConfig, plan, svd
from repro_torch.core.collectives import LocalMesh
from repro_torch.kernels import launch_counts

# Largest |S - S_numpy| accepted, relative to S[0]: the gram path squares
# the condition number (the limit chip_smoke.py holds exact solves to).
S_REL = 2e-3


def _np(x):
    return x.detach().cpu().numpy()


def main(device=None) -> dict:
    # A "short and fat" sparse matrix like the paper's job-candidate data.
    m, n, density = 128, 65_536, 1e-3
    coo = sparse.ensure_full_row_rank(
        sparse.random_bipartite(m, n, density, seed=0))
    print(f"matrix {coo.shape}, nnz={coo.nnz} (density {coo.density():.1e})")
    s_true = np.linalg.svd(coo.todense(), compute_uv=False)[:m]

    def check(name, s):
        err = float(np.abs(_np(s) - s_true).max())
        print(f"e_sigma ({name}) = {np.abs(_np(s) - s_true).sum():.3e} "
              f"(max {err:.2e})")
        assert err <= S_REL * s_true[0], (name, err)

    # One call.  COO input runs the sparse-native BlockEll path (the
    # matrix is never densified); method="none" skips repair so the
    # result is directly comparable to numpy on the same matrix.
    res = svd(coo, SolveConfig(method="none", num_blocks=8), device=device)
    print("--- plan ---")
    print(res.plan.explain())
    check(f"auto plan, {res.diagnostics.wall_time_s:.2f}s", res.s)

    # Explicit shard_map backend: one column block per slot of a block
    # mesh (one card standing for 8 devices), plus the right vectors (V
    # rows come back in original column order).
    mesh = LocalMesh({"blocks": 8}, device)
    res2 = svd(coo, SolveConfig(backend="shard_map", method="none",
                                merge_mode="gram", want_right=True),
               mesh=mesh)
    check("shard_map, gram, right vectors", res2.s)
    u, s, v = _np(res2.u), _np(res2.s), _np(res2.v)
    recon_s = np.linalg.svd((u * s) @ v.T, compute_uv=False)
    recon = float(np.abs(recon_s[:m] - s).sum())
    print(f"U S V^T self-consistency   = {recon:.3e}")
    assert np.abs(recon_s[:m] - s).max() <= S_REL * s[0]

    # The Ranky rank repair (the paper's contribution): the diagnostics
    # carry the lonely/repaired row counts from the repair side-band.
    res3 = svd(coo, SolveConfig(method="neighbor_random", num_blocks=8),
               device=device)
    d3 = res3.diagnostics
    print(f"lonely rows per block: {d3.lonely_rows_per_block}")
    print(f"repaired rows: {d3.repaired_rows} of {d3.lonely_rows} lonely "
          f"(rank problem fixed)")
    assert d3.repaired_rows == d3.lonely_rows == sum(d3.lonely_rows_per_block)

    # Capacity planning without data: in the tall-row regime the exact
    # gram stack stops fitting and the planner switches to the
    # randomized sketch; plan() answers "what would svd() do for a
    # matrix of this shape, and why" from an ASpec alone.
    p = plan(ASpec(m=32_768, n=4096, nnz=100_000, num_blocks=8),
             SolveConfig(method="random", rank=16), device=device)
    print(f"planned strategy for a 32768-row matrix: {p.strategy}")
    print("  " + p.reasons[-1])
    assert p.strategy == "randomized"
    return {"launches": launch_counts()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args()
    print("summary " + json.dumps(main(device=args.device)))
