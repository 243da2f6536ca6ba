#!/usr/bin/env python
"""Scripted chaos scenarios for the streaming supervisor (PyTorch/CUDA
port).

    PYTHONPATH=src python scripts/chaos_run_torch.py \
        --scenario kill-at-batch --out recovery-events.json [--device cpu]

Each scenario runs a supervised stream (``ft.StreamSupervisor``) over a
``LocalMesh`` of 8 slots (one card, or the CPU with ``--device cpu``,
standing for the reference's 8 forced host devices) against a
deterministic fault script (``ft.inject``), asserts the recovery
contract, and writes the machine-readable recovery events:

* ``kill-at-batch``: a slot killed at ingest entry.  Leg A: num_blocks=4
  on 8 slots, the mesh rebuilds on the 7 survivors and the resumed
  factors are BIT-IDENTICAL to an uninterrupted run.  Leg B:
  num_blocks=8, cascade kills leave too few slots for one block each:
  the supervisor degrades honestly to single-host (planner rule R8 says
  so in the event), resumes bit-identically from the last commit, and
  the full run matches a pure single-host run to 1e-5 of S[0].
* ``persistent-straggler``: one slot runs 4x slow forever; the
  ``StragglerMonitor`` flags it (backup-shard duplicate-ingest absorbs
  the early windows), evicts it at ``patience`` consecutive flags, and
  the re-meshed stream finishes bit-identical to the unfaulted run.
* ``kill-during-merge``: a transiently dropped merge collective (bounded
  retry, bit-identical replay) followed by a slot lost at the merge
  dispatch (full recovery path).

Every scenario also asserts the recovery is visible in the obs span trace
(``recover.drain`` / ``recover.replan`` / ``recover.restore``).  The
scenario functions take the stream to run (:class:`Stream`; default: the
reference's eight (6, 16) gaussian batches at rank 4), so ``chip_smoke.py``
runs them on the paper's rows.  Exit 0 = contract holds; AssertionError
otherwise.  Runs on the GPU unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch import ft, obs                            # noqa: E402
from repro_torch.core import api                           # noqa: E402
from repro_torch.core.collectives import LocalMesh         # noqa: E402
from repro_torch.ft.straggler import StragglerConfig       # noqa: E402
from repro_torch.stream import state as stream_state       # noqa: E402

N, K, M_B, BATCHES = 16, 4, 6, 8
SLOTS = 8
# Leg B's degraded run against a pure single-host run: max |dS| / S[0]
# (the two differ by the order of the first chunk's sums).
LEG_B_REL = 1e-5


@dataclasses.dataclass(frozen=True)
class Stream:
    """A scenario's stream: the batches (any delta representation), the
    column universe n, the truncation rank and the device."""

    batches: Sequence
    n: int
    rank: int
    device: Optional[str] = None


def toy_stream(seed: int, device=None) -> Stream:
    rng = np.random.default_rng(seed)
    return Stream([torch.from_numpy(rng.standard_normal((M_B, N))
                                    .astype(np.float32))
                   for _ in range(BATCHES)], N, K, device)


def config(stream: Stream, num_blocks: int, every: int = 2, **kw):
    return api.SolveConfig(truncate_rank=stream.rank, num_blocks=num_blocks,
                           checkpoint_every=every, max_retries=2,
                           stream_backend="shard_map", **kw)


def supervised(cfg, stream: Stream, batches=None, injector=None,
               straggler=None):
    """One supervised run on a fresh 8-slot local pool in a throwaway
    checkpoint dir; returns (gathered final state, supervisor)."""
    batches = stream.batches if batches is None else batches
    mesh = LocalMesh(SLOTS, stream.device)
    with tempfile.TemporaryDirectory() as d:
        sup = ft.StreamSupervisor(
            cfg, d, state=api.svd_init(stream.n, cfg, device=mesh.device),
            devices=mesh, injector=injector, straggler=straggler)
        try:
            if injector is not None:
                with injector.installed():
                    final = sup.run(batches)
            else:
                final = sup.run(batches)
        finally:
            sup.close()
    return stream_state.gather_state(final), sup


def bitwise(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in
               ((a.u, b.u), (a.s, b.s), (a.v, b.v)))


def assert_recover_spans():
    names = {e.name for e in obs.trace.events()}
    for span in ("recover.drain", "recover.replan", "recover.restore"):
        assert span in names, \
            f"recovery ran but span {span!r} missing from the obs trace"


def scenario_kill_at_batch(stream: Optional[Stream] = None):
    stream = stream or toy_stream(SEEDS["kill-at-batch"])
    batches = stream.batches

    # Leg A: 4 column blocks on 8 slots; kill one -> 7 survivors still
    # fit a block each -> the 1-D mesh rebuilds, no degrade.
    cfg = config(stream, num_blocks=4)
    oracle, _ = supervised(cfg, stream)
    inj = ft.FaultInjector([ft.FailDeviceAt(device=2, at_batch=4)])
    final, sup = supervised(cfg, stream, injector=inj)
    ev = sup.events[0]
    assert ev.kind == "device_lost" and ev.survivors == 7
    assert ev.backend_before == "shard_map" == ev.backend_after, \
        f"7 survivors fit 4 blocks; got degrade to {ev.backend_after}"
    assert bitwise(final, oracle), \
        "re-meshed resume is not bit-identical to the uninterrupted run"
    assert_recover_spans()

    # Leg B: 8 blocks on 8 slots; cascade kills down to 4 survivors ->
    # too few for one block each -> honest single-host degrade, explained
    # by R8 on the first shrink and re-stated on each later loss.
    cfg8 = config(stream, num_blocks=8)
    inj2 = ft.FaultInjector([ft.FailDeviceAt(device=1, at_batch=3),
                             ft.FailDeviceAt(device=6, at_batch=5),
                             ft.FailDeviceAt(device=4, at_batch=6),
                             ft.FailDeviceAt(device=0, at_batch=7)])
    final8, sup8 = supervised(cfg8, stream, injector=inj2)
    kinds = [e.kind for e in sup8.events]
    assert kinds == ["device_lost"] * 4, kinds
    assert sup8.events[0].backend_after == "single"
    assert [e.survivors for e in sup8.events] == [7, 6, 5, 4]
    assert any("degrading honestly" in r
               for e in sup8.events for r in e.reasons), \
        "R8 degrade explanation missing from the recovery events"

    # Bitwise oracle: sharded to the last commit before the kill, then a
    # manual single-host continuation with the same chunking.
    head, _ = supervised(cfg8, stream, batches=batches[:2])
    cfg_single = api.SolveConfig(truncate_rank=stream.rank, num_blocks=8,
                                 stream_backend="single")
    st, i = head, 2
    while i < len(batches):
        st = api.svd_stream(batches[i:i + 2], cfg_single, state=st).state
        i += 2
    assert bitwise(final8, st), \
        "degraded resume is not bit-identical to the manual continuation"
    pure = api.svd_stream(batches, cfg_single, device=head.device).state
    rel = float((final8.s - pure.s).abs().max() / pure.s[0])
    assert rel <= LEG_B_REL, \
        f"degraded run drifted from the single-host run: {rel} of S[0]"
    return {"legA": sup.events_json(), "legB": sup8.events_json(),
            "legB_rel_err": rel}, sup8


def scenario_persistent_straggler(stream: Optional[Stream] = None):
    stream = stream or toy_stream(SEEDS["persistent-straggler"])
    cfg = config(stream, num_blocks=4, every=1)
    scfg = StragglerConfig(alpha=1.0, threshold=1.5, patience=3,
                           policy="evict")
    oracle, _ = supervised(cfg, stream, straggler=scfg)
    inj = ft.FaultInjector([ft.DelayDevice(device=1, factor=4.0)])
    final, sup = supervised(cfg, stream, injector=inj, straggler=scfg)
    evs = [e for e in sup.events if e.kind == "straggler_evict"]
    assert len(evs) == 1, \
        f"want exactly one eviction, got {[e.kind for e in sup.events]}"
    assert evs[0].device == 1 and evs[0].survivors == 7
    assert sup.backup_saved_s > 0, \
        "backup-shard duplicate-ingest never engaged on the flagged slot"
    assert bitwise(final, oracle), \
        "post-eviction stream is not bit-identical to the unfaulted run"
    assert_recover_spans()
    return {"events": sup.events_json(),
            "backup_saved_s": sup.backup_saved_s}, sup


def scenario_kill_during_merge(stream: Optional[Stream] = None):
    stream = stream or toy_stream(SEEDS["kill-during-merge"])
    cfg = config(stream, num_blocks=4)
    oracle, _ = supervised(cfg, stream)
    inj = ft.FaultInjector([
        ft.DropCollective(at_batch=3),
        ft.FailDeviceAt(device=3, at_batch=5, phase="merge")])
    final, sup = supervised(cfg, stream, injector=inj)
    kinds = [e.kind for e in sup.events]
    assert kinds == ["collective_retry", "device_lost"], kinds
    assert sup.events[0].retries == 1
    assert sup.events[1].survivors == 7
    assert bitwise(final, oracle), \
        "merge-fault recovery is not bit-identical to the unfaulted run"
    assert_recover_spans()
    return {"events": sup.events_json()}, sup


SCENARIOS = {
    "kill-at-batch": scenario_kill_at_batch,
    "persistent-straggler": scenario_persistent_straggler,
    "kill-during-merge": scenario_kill_during_merge,
}
# The seed of each scenario's default stream (the reference's).
SEEDS = {"kill-at-batch": 0, "persistent-straggler": 1,
         "kill-during-merge": 2}


def run(scenario: str, out: Optional[str] = None, device=None,
        stream: Optional[Stream] = None):
    """Run one scenario with obs on (the trace and metrics are reset
    first and left for the caller to read; obs is switched off after) and
    write its artifact to ``out``.  Returns (artifact dict, supervisor of
    the scenario's last faulted run)."""
    if stream is None:
        stream = toy_stream(SEEDS[scenario], device)
    obs.reset()
    obs.enable()
    try:
        doc, sup = SCENARIOS[scenario](stream)
    finally:
        obs.disable()
    doc = {"scenario": scenario, "devices": SLOTS,
           "device": str(LocalMesh(1, stream.device).device), **doc}
    if out:
        with open(out, "w") as f:
            json.dump(doc, f, indent=2)
    return doc, sup


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", required=True, choices=sorted(SCENARIOS))
    ap.add_argument("--out", default=None,
                    help="write the recovery-event JSON artifact here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    doc, sup = run(args.scenario, args.out, args.device)
    if args.out:
        print(f"wrote {args.out}")
    print(f"{args.scenario} OK: {len(sup.events)} recovery event(s), "
          f"{len(sup.healthy)}/{sup.pool.size} slots healthy at exit")
    return 0


if __name__ == "__main__":
    sys.exit(main())
