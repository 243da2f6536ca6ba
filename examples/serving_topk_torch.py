"""Top-k serving under live ingest (PyTorch/CUDA port): the recommender
front-end loop.

    PYTHONPATH=src python examples/serving_topk_torch.py [--device cpu] [--observe]

A serving endpoint answers request waves against the current snapshot
while an ingest thread keeps folding fresh interaction batches into the
streamed factorization and publishing them with the double-buffered
atomic swap: queries never see a torn (s from one ingest, v from
another) state, only whole versions.  On the GPU the ingest thread runs
on a CUDA stream of its own, and each commit follows a checkpoint of the
state (made on that stream).  The R7 plan narrates the memory story up
front: the fused score + top-k kernel's working set is one (B, block_n)
tile regardless of the universe size.

The endpoint then "crashes": the last checkpointed STATE is restored,
a new handle is served from it, and the answers match the pre-crash
endpoint exactly (snapshots are derived data, only the state needs
durability).  Every wave of the final snapshot is also checked against
numpy's scores of the same factors.

``--observe`` turns on ``repro_torch.obs`` for the serve-under-ingest
loop: ``handle.metrics()`` (snapshot version/staleness, request counters,
p50/p99 wave latency on the device, R7 drift ratio on the GPU) and the
Prometheus serve-side metric families print at the end.  Runs on the GPU
unless ``--device`` says otherwise.
"""
import argparse
import contextlib
import json
import tempfile
import threading

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import sparse
from repro_torch.core.api import (ServeTopKConfig, SolveConfig, serve_init,
                                  serve_topk, svd_init, svd_update)
from repro_torch.kernels import launch_counts
from repro_torch.serve import ranker

N, ROWS, BATCHES, K_TOP = 50_000, 64, 6, 5


def batch(i: int) -> sparse.COOMatrix:
    return sparse.ensure_full_row_rank(
        sparse.random_bipartite(ROWS, N, 2e-3, seed=40 + i, weighted=True),
        seed=40 + i)


def check_wave(snap, queries: np.ndarray, res) -> None:
    """The wave against numpy: q . diag(s) V^T over the snapshot's f32
    factors in float64.  Each returned item carries its own score, and
    none is beaten by an item left out (items whose scores lie within
    float32 rounding of each other may come in either order)."""
    v = snap.v[:snap.n].double().cpu().numpy()
    s = snap.s.double().cpu().numpy()
    scores = (queries.astype(np.float64) * s) @ v.T
    got_s = res.scores.cpu().numpy().astype(np.float64)
    got_i = res.indices.cpu().numpy()
    tol = 1e-5 * np.abs(scores).max()
    np.testing.assert_allclose(got_s, np.take_along_axis(scores, got_i, 1),
                               rtol=0, atol=tol)
    kth = -np.sort(-scores, axis=1)[:, got_i.shape[1] - 1]
    assert (got_s[:, -1] >= kth - tol).all()
    assert (np.diff(got_s, axis=1) <= 0).all()


def main(device=None, observe: bool = False) -> dict:
    device = resolve_device(device)
    if observe:
        obs.enable()
    cfg = SolveConfig(method="none", truncate_rank=16, num_blocks=8,
                      stream_backend="single", observe=observe)
    state = svd_init(N, cfg, device=device)
    state = svd_update(state, batch(0), cfg).state

    handle = serve_init(state, ServeTopKConfig(batch_size=16, k_top=K_TOP))
    print("--- R7 serving plan ---")
    print(handle.plan.explain())

    # --- concurrent ingest + queries ---------------------------------
    rng = np.random.default_rng(0)
    queries_np = rng.standard_normal((16, state.rank)).astype(np.float32)
    queries = torch.from_numpy(queries_np).to(device)
    with tempfile.TemporaryDirectory() as ckdir:
        ck = Checkpointer(ckdir)
        done = threading.Event()
        failed = []

        def ingest():
            stream = (torch.cuda.stream(torch.cuda.Stream(device))
                      if device.type == "cuda" else contextlib.nullcontext())
            try:
                with stream:
                    st = state
                    for i in range(1, BATCHES):
                        st = svd_update(st, batch(i), cfg).state
                        ck.save(i, st, blocking=True)  # durability first
                        handle.commit(st)              # atomic swap
            except Exception as e:  # raised again by the serving thread
                failed.append(e)
            finally:
                done.set()

        t = threading.Thread(target=ingest)
        t.start()
        waves = 0
        while not done.is_set():
            res = serve_topk(handle, queries)
            # a real server reads the wave's results before answering
            res.scores.cpu()
            waves += 1
        t.join()
        if failed:
            raise failed[0]
        res = serve_topk(handle, queries)  # one wave on the final version
        print(f"\nanswered {waves} request waves during {BATCHES - 1} "
              f"ingests; final snapshot version={res.version}")
        assert res.version == BATCHES - 1
        check_wave(handle.read(), queries_np, res)
        print("final wave holds against numpy's scores of the same factors")
        if observe:
            m = handle.metrics()
            drift = {k: round(v, 3) for k, v in m["drift_ratios"].items()}
            print(f"live endpoint metrics: version={m['snapshot_version']}"
                  f" age={m['snapshot_age_s'] * 1e3:.0f}ms "
                  f"requests={m['serve_requests_total']:.0f} "
                  f"p50={m['serve_latency_us_p50']:.0f}us "
                  f"p99={m['serve_latency_us_p99']:.0f}us "
                  f"drift={drift}")
        print(f"user 0 top-5 items: {res.indices[0].tolist()}")

        # --- crash: rebuild the endpoint from the checkpointed state --
        restored, meta = ck.restore(device=device)
        revived = serve_init(restored, handle.config)
        res2 = serve_topk(revived, queries)
        bitwise = (torch.equal(res.scores, res2.scores)
                   and torch.equal(res.indices, res2.indices))
        print(f"endpoint revived from checkpoint of ingest "
              f"{meta['step']}: answers bit-identical: {bitwise}")
        assert bitwise

    # --- int8 factors: ~4x smaller residency, near-identical top-k ---
    h8 = serve_init(restored, handle.config, quantize=True)
    q8 = serve_topk(h8, queries)
    i32, i8 = res.indices.cpu().numpy(), q8.indices.cpu().numpy()
    overlap = float(np.mean([len(set(i32[i]) & set(i8[i])) / K_TOP
                             for i in range(16)]))
    f32_b = handle.plan.estimates["serve_factors"]
    int8_b = h8.plan.estimates["serve_factors"]
    print(f"\nint8 serving: factors {f32_b:,}B -> {int8_b:,}B, "
          f"top-5 overlap {overlap:.2f}")

    # --- cold-start queries without a user id ------------------------
    fresh_rows = np.zeros((2, N), np.float32)
    fresh_rows[0, [10, 999, 31_000]] = (3.0, 1.5, 2.0)
    fresh_rows[1, [5, 77, 42_123]] = (1.0, 4.0, 0.5)
    q_fresh = ranker.project_rows(revived.read(), fresh_rows)
    res3 = serve_topk(revived, q_fresh)
    print(f"cold-start (projected raw rows) top-5: "
          f"{res3.indices.tolist()}")

    if observe:
        print("\n--- observability (--observe): serve-side families ---")
        for line in obs.export_text().splitlines():
            if "serve" in line or "snapshot" in line or "drift" in line:
                print(f"  {line}")
    return {"launches": launch_counts(), "waves": waves,
            "int8_overlap": overlap}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--observe", action="store_true")
    args = ap.parse_args()
    print("summary " + json.dumps(main(device=args.device,
                                       observe=args.observe)))
