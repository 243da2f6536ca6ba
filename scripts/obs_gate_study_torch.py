"""How far the obs-off serving gate of ``chip_smoke.py`` (phase
``observe``) moves between runs on the card, and what moves it.

    python3 scripts/obs_gate_study_torch.py [--repeats N] [--designs LIST]
                                            [--out PATH]

Runs on the GPU (it exits 1 without one).  Builds the kernels and the
handle phase ``observe`` serves from (the paper rows through
``svd_stream`` at rank 16, 20 query waves of 32 rows), then runs the
gate's A/B (``chip_smoke.obs_off_ab``: ``chip_smoke.OBS_AB``'s rounds
of timed pairs, the least p99 of each arm) ``--repeats`` times in each
design of ``--designs`` (default: all four), in turn, so that a slow
drift of the host falls on all of them alike:

- ``served/fixed``: the gate as ``chip_smoke.py`` holds it:
  ``serve_topk`` against the direct ranker call, the direct call first in
  every pair (the reference's order);
- ``served/alternate``: the same, odd pairs ``serve_topk`` first;
- ``direct/fixed`` and ``direct/alternate``: the direct call against
  itself (A/A), the statistic's own noise in either order.

The garbage collector is off while pairs are timed in every design.  One
JSON line a run, then one with, for each design, the gate's ratios
(least p99 over least p99) and the p99 ratio of each round, their mean
and spread; the last lines are the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
import torch  # noqa: E402

DESIGNS = (("served", "fixed"), ("served", "alternate"),
           ("direct", "fixed"), ("direct", "alternate"))


def spread(xs) -> dict:
    xs = np.asarray(xs, dtype=np.float64)
    return dict(n=int(xs.size), mean=float(xs.mean()),
                sd=float(xs.std(ddof=1)) if xs.size > 1 else None,
                min=float(xs.min()), max=float(xs.max()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3,
                    help="runs of the A/B in each design (default 3)")
    ap.add_argument("--designs", default=",".join(
                        f"{arm}/{order}" for arm, order in DESIGNS),
                    help="comma-separated arm/order pairs (default: all "
                         "four)")
    ap.add_argument("--out", default=None,
                    help="also write every JSON line to this file")
    args = ap.parse_args(argv)
    designs = [tuple(d.split("/")) for d in args.designs.split(",")]
    if not set(designs) <= set(DESIGNS):
        ap.error(f"--designs: each of {args.designs!r} must be one of "
                 f"{[f'{a}/{o}' for a, o in DESIGNS]}")
    if not torch.cuda.is_available():
        print("obs_gate_study_torch: no CUDA device is available",
              file=sys.stderr)
        return 1
    lines = []

    def put(obj) -> None:
        lines.append(json.dumps(obj))
        print(lines[-1], flush=True)

    smi = smoke.nvidia_smi_line()
    smoke.kernel_build.load()
    coo = smoke.bipartite.paper_coo(smoke.RankyPaperConfig())
    sparse_b = smoke.paper_batches(coo)
    dense_b = [torch.from_numpy(x)
               for x in smoke.paper_batches(coo, dense=True)]
    gen = torch.Generator(smoke.DEVICE).manual_seed(19)
    queries = [torch.randn((32, 16), generator=gen, device=smoke.DEVICE)
               for _ in range(smoke.OBSERVE_WAVES)]
    (_, _, handle), _ = smoke.observe_pass(sparse_b, dense_b, queries)
    runs = {design: [] for design in designs}
    for rep in range(args.repeats):
        for arm, order in designs:
            ab = smoke.obs_off_ab(handle, queries, arm=arm, order=order,
                                  gate=False)
            runs[(arm, order)].append(ab)
            put(dict(run=rep, **ab))
    summary = {}
    for (arm, order), abs_ in runs.items():
        per_round = [r["p99_off_us"] / r["p99_base_us"]
                     for ab in abs_ for r in ab["by_round"]]
        gates = [ab["ratio"] for ab in abs_]
        summary[f"{arm}/{order}"] = dict(
            gate_ratios=gates, gate=spread(gates),
            round_ratio=spread(per_round),
            over_limit=sum(g > smoke.OBS_AB["limit"] for g in gates))
    put(dict(summary=summary, limit=smoke.OBS_AB["limit"],
             pairs=smoke.OBS_AB["pairs"], rounds=smoke.OBS_AB["rounds"],
             nvidia_smi=smi))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
