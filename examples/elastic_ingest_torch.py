"""Elastic, straggler-tolerant sharded ingest (PyTorch/CUDA port): kill a
slot mid-stream and watch the supervisor recover.

    PYTHONPATH=src python examples/elastic_ingest_torch.py [--device cpu]

A supervised stream (``ft.StreamSupervisor``) over a ``LocalMesh`` of 8
slots (one card standing for the reference's 8 forced host devices)
ingests 12 batches with ``num_blocks=4``: one column block a slot, four
spare.  A scripted fault kills slot 2 while batch 5 is in flight:

  1. the async checkpoint writer drains (last commit = the resume point),
  2. planner rule R8 re-plans the 1-D stream mesh onto the 7 survivors
     (still one block a slot: no degrade; the plan says so),
  3. the state restores from the checkpoint and re-shards onto the
     survivors' mesh,
  4. the uncommitted batches replay: the seed chain keys on
     ``batches_seen``, so the resumed stream is BIT-IDENTICAL to an
     uninterrupted run of the same batch sequence (asserted below).

A second scripted fault slows slot 1 by 4x; the straggler monitor flags
it, backup-shard duplicate-ingest absorbs the slow windows, and
``patience`` consecutive flags evict it through the same recovery path.
Runs on the GPU unless ``--device`` says otherwise.
"""
import argparse
import json
import tempfile

import numpy as np
import torch

from repro_torch import ft, obs
from repro_torch.core.api import SolveConfig, svd_init
from repro_torch.core.collectives import LocalMesh
from repro_torch.ft.straggler import StragglerConfig
from repro_torch.kernels import launch_counts
from repro_torch.stream import state as stream_state

N, K, ROWS, BATCHES, BLOCKS, SLOTS = 64, 8, 16, 12, 4, 8


def make_batches():
    rng = np.random.default_rng(7)
    return [torch.from_numpy(rng.standard_normal((ROWS, N))
                             .astype(np.float32)) for _ in range(BATCHES)]


def supervised_run(cfg, batches, device, injector=None, straggler=None):
    pool = LocalMesh(SLOTS, device)
    with tempfile.TemporaryDirectory() as ckdir:
        sup = ft.StreamSupervisor(cfg, ckdir,
                                  state=svd_init(N, cfg, device=pool.device),
                                  devices=pool, injector=injector,
                                  straggler=straggler)
        try:
            if injector is not None:
                with injector.installed():
                    final = sup.run(batches)
            else:
                final = sup.run(batches)
        finally:
            sup.close()
    return stream_state.gather_state(final), sup


def main(device=None) -> dict:
    cfg = SolveConfig(truncate_rank=K, num_blocks=BLOCKS,
                      checkpoint_every=2, max_retries=2,
                      stream_backend="shard_map")
    batches = make_batches()
    obs.reset()
    obs.enable()

    # The oracle: the same supervised run, no faults.
    oracle, _ = supervised_run(cfg, batches, device)
    print(f"slots: {SLOTS} on {oracle.device}")

    # Kill slot 2 at batch 5 AND run slot 1 at 4x slow with an
    # evict-after-3-flags policy: one stream, two recoveries.
    inj = ft.FaultInjector([
        ft.FailDeviceAt(device=2, at_batch=5),
        ft.DelayDevice(device=1, factor=4.0),
    ])
    scfg = StragglerConfig(alpha=1.0, threshold=1.5, patience=3,
                           policy="evict")
    final, sup = supervised_run(cfg, batches, device, injector=inj,
                                straggler=scfg)

    print("\n--- recovery events ---")
    for ev in sup.events:
        print(f"[{ev.kind}] batch={ev.batch} device={ev.device} "
              f"survivors={ev.survivors} "
              f"{ev.backend_before}->{ev.backend_after} "
              f"resumed_from={ev.resumed_from_batch} "
              f"({ev.wall_s * 1e3:.1f}ms)")
        print(f"  R8: {ev.reasons[0][:140]}...")
    kinds = [e.kind for e in sup.events]
    assert "device_lost" in kinds and "straggler_evict" in kinds, kinds
    print(f"\nbackup-shard duplicate-ingest absorbed "
          f"~{sup.backup_saved_s:.4f}s of straggler skew before eviction")
    print(f"healthy at exit: {len(sup.healthy)}/{sup.pool.size} slots")

    bitwise = all(torch.equal(a, b) for a, b in
                  ((final.u, oracle.u), (final.s, oracle.s),
                   (final.v, oracle.v)))
    print(f"recovered stream bit-identical to uninterrupted run: "
          f"{bitwise}")
    assert bitwise

    spans = {e.name for e in obs.trace.events()}
    assert {"recover.drain", "recover.replan",
            "recover.restore"} <= spans, spans
    print("recovery visible in the obs span trace: "
          + ", ".join(sorted(s for s in spans if s.startswith("recover."))))
    obs.disable()
    print("elastic_ingest example OK")
    return {"launches": launch_counts(), "events": kinds}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args()
    print("summary " + json.dumps(main(device=args.device)))
