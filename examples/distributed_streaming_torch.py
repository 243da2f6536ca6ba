"""Distributed streaming SVD (PyTorch/CUDA port): the "daily update" loop
over 8 block slots.

    PYTHONPATH=src python examples/distributed_streaming_torch.py [--device cpu]

The sibling of ``examples/streaming_svd_torch.py`` with the ingest engine
sharded (``stream_backend="shard_map"``, planner rule R5d): the state's
right factor ``v`` is split one column block a slot, each day's batch is
factored with psummed per-slot partials, and the merge applies a small
rotation locally, so the working set of a slot is bounded by the R5d
closed form however many rows the stream has seen.  One card stands for
the reference's 8 forced host devices: the stream pool is a ``LocalMesh``
of 8 slots (``stream.state.set_stream_devices``).  Checkpoints are saved
gathered and re-shard themselves onto the pool at restore.  Runs on the
GPU unless ``--device`` says otherwise.
"""
import argparse
import json
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.core import sparse
from repro_torch.core.api import (ASpec, SolveConfig, plan_update, svd,
                                  svd_init, svd_update)
from repro_torch.core.collectives import LocalMesh
from repro_torch.kernels import launch_counts
from repro_torch.stream import state as stream_state

N, DAYS, ROWS_PER_DAY, BLOCKS = 4096, 4, 64, 8

# Largest |S - S_oracle| of the top 16 accepted, relative to S[0]: the
# truncated stream against a from-scratch solve of every row.
TRACK_REL = 5e-2


def day_batch(day: int) -> sparse.COOMatrix:
    return sparse.ensure_full_row_rank(
        sparse.random_bipartite(ROWS_PER_DAY, N, 1e-2, seed=100 + day,
                                weighted=True), seed=100 + day)


def main(device=None) -> dict:
    cfg = SolveConfig(method="neighbor_random", truncate_rank=32,
                      oversample=16, num_blocks=BLOCKS,
                      stream_backend="shard_map")
    mesh = LocalMesh(BLOCKS, device)
    stream_state.set_stream_devices(mesh)
    try:
        print(f"stream pool: {stream_state.stream_device_count()} slots on "
              f"{mesh.device}")
        # Capacity planning from shapes alone: rule R5d answers "does one
        # day's ingest fit PER SLOT".
        p = plan_update(ASpec(m=ROWS_PER_DAY, n=N, nnz=ROWS_PER_DAY * 8,
                              num_blocks=BLOCKS), cfg, device=mesh.device)
        print("--- R5d plan for one day ---")
        print(p.explain())
        assert p.backend == "shard_map"

        with tempfile.TemporaryDirectory() as ckdir:
            ck = Checkpointer(ckdir)
            state = svd_init(N, cfg, device=mesh.device)
            for day in range(DAYS):
                res = svd_update(state, day_batch(day), cfg)
                state = res.state
                ck.save(day, state, blocking=True)
                print(f"day {day}: rows_seen={state.rows_seen} "
                      f"rank={state.rank} backend={res.plan.backend} "
                      f"per-slot peak {res.plan.estimated_peak_bytes} B "
                      f"[{res.diagnostics.wall_time_s * 1e3:.0f}ms]")
                assert res.plan.backend == "shard_map"

            # Crash, restore (saved gathered; restore re-shards v onto the
            # pool), continue: bit-identical to the uninterrupted stream.
            restored, meta = ck.restore(device=mesh.device)
            print(f"restored day {meta['step']} checkpoint onto "
                  f"{restored.mesh}")
            assert restored.mesh is not None
            nxt = day_batch(DAYS)
            res_a = svd_update(state, nxt, cfg)
            res_b = svd_update(restored, nxt, cfg)
            bitwise = all(torch.equal(getattr(res_a.state, f),
                                      getattr(res_b.state, f))
                          for f in ("u", "s", "v"))
            print(f"resumed stream bit-identical to uninterrupted: "
                  f"{bitwise}")
            assert bitwise
    finally:
        stream_state.set_stream_devices(None)

    # The sharded stream tracks a from-scratch solve of everything.
    state = res_a.state
    everything = np.concatenate(
        [day_batch(d).todense() for d in range(DAYS + 1)], axis=0)
    oracle = svd(everything, SolveConfig(method="none", num_blocks=BLOCKS,
                                         backend="single",
                                         merge_mode="gram"),
                 device=mesh.device)
    s_true = oracle.s[:16].cpu().numpy()
    rel = float(np.abs(state.s[:16].cpu().numpy() - s_true).max()
                / s_true[0])
    print(f"top-16 singular values vs from-scratch oracle: "
          f"rel_err={rel:.2e}")
    assert rel < TRACK_REL, rel
    print("distributed_streaming example OK")
    return {"launches": launch_counts(), "collectives": dict(mesh.counts)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args()
    print("summary " + json.dumps(main(device=args.device)))
