"""Streaming SVD (PyTorch/CUDA port): a minimal "daily update" service loop.

    PYTHONPATH=src python examples/streaming_svd_torch.py [--device cpu] [--observe]

A day of new user-item interactions arrives as a batch of sparse rows;
``svd_update`` folds it into the running truncated factorization by
merge-and-truncate (cost independent of the rows already ingested) and
the state is checkpointed after every day.  Mid-stream the example
"crashes", restores the last checkpoint, and continues: the resumed
stream is bit-identical to the uninterrupted one (the state carries its
own seed chain, so repairs and sketches replay exactly).

``--observe`` turns on the observability layer (``repro_torch.obs``):
the run records ingest/merge/window spans and drift gauges against the
R5/R6 closed forms (measured on the GPU; the CPU has no allocator peak),
and prints the span summary + drift ratios at the end.

The second half switches to high-rate ticks: ``svd_stream`` consumes a
GENERATOR of mini-batches lazily and, once the rank is steady, groups
same-shape batches into windows of the same step with the state on the
device throughout and one host read a window (planner rule R6),
bit-identical to the per-batch loop (``window=1``).  Runs on the GPU
unless ``--device`` says otherwise.
"""
import argparse
import json
import tempfile

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import sparse
from repro_torch.core.api import (ASpec, SolveConfig, plan_update, svd,
                                  svd_init, svd_stream, svd_update)
from repro_torch.kernels import launch_counts
from repro_torch.stream import window as swindow

N, DAYS, ROWS_PER_DAY = 4096, 5, 64
# Largest |S - S_oracle| of the top 16 accepted, relative to S[0]: the
# truncated stream against a from-scratch solve of every row.
TRACK_REL = 0.02


def day_batch(day: int) -> sparse.COOMatrix:
    """One day of interactions: new rows over the fixed column universe."""
    return sparse.ensure_full_row_rank(
        sparse.random_bipartite(ROWS_PER_DAY, N, 1e-2, seed=100 + day,
                                weighted=True), seed=100 + day)


def _same(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("u", "s", "v"))


def main(device=None, observe: bool = False) -> dict:
    if observe:
        obs.enable()
    cfg = SolveConfig(method="neighbor_random", truncate_rank=32,
                      oversample=16, num_blocks=8, observe=observe)

    # Capacity planning before any data exists: rule R5 answers "does
    # one day's ingest fit this device" from the batch shape alone.
    p = plan_update(ASpec(m=ROWS_PER_DAY, n=N, nnz=ROWS_PER_DAY * 8,
                          num_blocks=8), cfg, device=device)
    print("--- R5 plan for one day ---")
    print(p.explain())

    with tempfile.TemporaryDirectory() as ckdir:
        ck = Checkpointer(ckdir)
        state = svd_init(N, cfg, device=device)
        for day in range(DAYS):
            res = svd_update(state, day_batch(day), cfg)
            state = res.state
            ck.save(day, state, blocking=True)
            print(f"day {day}: rows_seen={state.rows_seen} "
                  f"rank={state.rank} "
                  f"repaired={res.diagnostics.repaired_rows} lonely rows "
                  f"[{res.diagnostics.wall_time_s * 1e3:.0f}ms]")

        # --- crash and resume ---------------------------------------
        restored, meta = ck.restore(device=state.device)  # latest step
        print(f"restored checkpoint of day {meta['step']} "
              f"(rows_seen={restored.rows_seen})")
        next_day = day_batch(DAYS)
        res_a = svd_update(state, next_day, cfg)
        res_b = svd_update(restored, next_day, cfg)
        bitwise = _same(res_a.state, res_b.state)
        print(f"resumed stream bit-identical to uninterrupted: {bitwise}")
        assert bitwise

        # The streamed factors track a from-scratch solve of everything.
        state = res_a.state
        everything = np.concatenate(
            [day_batch(d).todense() for d in range(DAYS + 1)], axis=0)
        oracle = svd(everything, SolveConfig(method="none", num_blocks=8,
                                             backend="single",
                                             merge_mode="gram"),
                     device=device)
        s_true = oracle.s[:16].cpu().numpy()
        rel = float(np.abs(state.s[:16].cpu().numpy() - s_true).max()
                    / s_true[0])
        print(f"top-16 singular values vs from-scratch oracle: "
              f"rel_err={rel:.2e} (state rank {state.rank}, "
              f"{state.rows_seen} rows ingested)")
        assert rel <= TRACK_REL, rel

    # --- high-rate ticks: windows over a generator --------------------
    def ticks(num, rows=16):
        rng = np.random.default_rng(7)
        for _ in range(num):
            yield (rng.standard_normal((rows, N)).astype(np.float32)
                   * (rng.random((rows, N)) < 5e-3))

    swindow.reset_dispatch_counts()
    res = svd_stream(ticks(24), cfg, device=device)
    counts = swindow.dispatch_counts()
    print("\n--- R6 windows over a 24-tick generator ---")
    print(f"{counts['batches']} steady batches in {counts['windows']} "
          f"windows of the same step (plus the rank-growth prologue)")
    print(next(r for r in res.plan.reasons if r.startswith("R6")))
    assert counts["windows"] < counts["batches"]

    # window=1 forces the per-batch loop: the same step, so the factors
    # match the windows bit for bit
    res_loop = svd_stream(ticks(24), cfg, window=1, device=device)
    bitwise = _same(res.state, res_loop.state)
    print(f"windows bit-identical to the per-batch loop: {bitwise}")
    assert bitwise

    if observe:
        print("\n--- observability (--observe) ---")
        print("span summary (name, calls, total ms) for the window run:")
        for name, count, total_us in res.diagnostics.span_summary:
            print(f"  {name:<20} x{count:<4} {total_us / 1e3:9.1f}ms")
        ratios = {k: round(v, 3) for k, v in obs.drift_ratios().items()}
        print(f"measured/planned peak-byte drift: {ratios}")
        print(f"compile {res.diagnostics.compile_time_s:.2f}s + run "
              f"{res.diagnostics.run_time_s:.2f}s = wall "
              f"{res.diagnostics.wall_time_s:.2f}s")
    return {"launches": launch_counts(), "drift": obs.drift_ratios()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--observe", action="store_true")
    args = ap.parse_args()
    print("summary " + json.dumps(main(device=args.device,
                                       observe=args.observe)))
