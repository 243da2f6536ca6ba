"""Distributed SVD at "pod scale" through the unified front door
(PyTorch/CUDA port): the two-level merge over a (pod, model) block mesh,
then the elastic re-plan after a lost pod: ``ft.plan_mesh`` picks the
survivors' (data, model) grid, ``ft.build_mesh`` makes it, and the same
matrix is re-blocked over its model axis only (the data axis holds copies
of the same blocks).

    PYTHONPATH=src python examples/distributed_svd_torch.py [--device cpu]

One card stands for the reference's 16 forced host devices: a
``LocalMesh`` holds the 16 block slots as a batch axis, so every kernel
launches once over the stack of distinct blocks
(``core/collectives.py``).  Each result is checked against numpy's SVD of
the same matrix.  Runs on the GPU unless ``--device`` says
otherwise.
"""
import argparse
import json

import numpy as np

from repro_torch.core import sparse
from repro_torch.core.api import SolveConfig, svd
from repro_torch.core.collectives import LocalMesh
from repro_torch.ft.elastic import build_mesh, plan_mesh
from repro_torch.kernels import launch_counts

# Largest |S - S_numpy| accepted, relative to S[0] (the gram path squares
# the condition number; the limit chip_smoke.py holds exact solves to).
S_REL = 2e-3


def main(device=None) -> dict:
    m, n = 64, 32_768
    coo = sparse.ensure_full_row_rank(
        sparse.random_bipartite(m, n, 2e-3, seed=1))
    s_true = np.linalg.svd(coo.todense(), compute_uv=False)[:m]

    def check(name, res):
        s = res.s.detach().cpu().numpy()
        err = float(np.abs(s - s_true).max())
        print(f"{name}: e_sigma={np.abs(s - s_true).sum():.3e} "
              f"(max {err:.2e}) [{res.diagnostics.wall_time_s:.2f}s, "
              f"peak~{res.plan.estimated_peak_bytes:,}B per slot]")
        assert err <= S_REL * s_true[0], (name, err)

    # Two-level merge: 4 "pods" x 4 workers.  two_level=True merges within
    # the inner axis first, then across pods.  method="none" so the result
    # is directly comparable to numpy on the same matrix; local_mode="svd"
    # needs the dense path, so the adapter densifies the COO input itself.
    mesh = LocalMesh({"pod": 4, "model": 4}, device)
    res = svd(coo, SolveConfig(backend="shard_map", method="none",
                               merge_mode="proxy", local_mode="svd",
                               two_level=True),
              mesh=mesh, block_axes=("pod", "model"))
    assert res.plan.backend == "shard_map"
    check("hierarchical 4x4", res)

    # Losing a pod: re-plan the mesh with the 12 surviving slots.  The
    # adapter re-blocks (and re-pads) the same COO input for the surviving
    # block axis.
    mplan = plan_mesh(12, model_parallel=4, multi_pod_threshold=10**9)
    new_mesh = build_mesh(mplan, mesh, slots=range(12))
    print(f"after failure: plan={mplan.shape} {mplan.axis_names} "
          f"(dropped {mplan.dropped_devices})")
    res2 = svd(coo, SolveConfig(backend="shard_map", method="none",
                                merge_mode="gram"),
               mesh=new_mesh, block_axes=(mplan.axis_names[-1],))
    assert res2.plan.backend == "shard_map"
    check(f"recovered on {mplan.num_devices} slots", res2)
    return {"launches": launch_counts(),
            "collectives": dict(mesh.counts)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args()
    print("summary " + json.dumps(main(device=args.device)))
