#!/usr/bin/env python
"""Capture a Chrome/Perfetto trace of a streaming + serving run
(PyTorch/CUDA port).

Runs a representative workload with observability on -- ``svd_stream``
over bucketed windows, then ``serve_topk`` request waves against a live
handle -- and writes:

* a trace-event JSON (open at https://ui.perfetto.dev or
  chrome://tracing) covering window execution, per-batch ingests,
  merge_svd, snapshot stage/publish and serving waves; span durations
  are device time between CUDA events on the GPU (host clock on the
  CPU);
* optionally a metrics export (Prometheus text via ``--metrics``,
  JSON if the path ends in .json) including the measured-vs-planned
  drift gauges for R5/R6/R7 (measured on the GPU only: the CPU has no
  allocator peak).

Usage:
    PYTHONPATH=src python scripts/ranky_trace_torch.py trace.json
    PYTHONPATH=src python scripts/ranky_trace_torch.py trace.json \
        --metrics metrics.prom --batches 24 --waves 32
    PYTHONPATH=src python scripts/ranky_trace_torch.py trace.json --device cpu

The workload is synthetic and seeded (the same numpy draws as
``scripts/ranky_trace.py``) -- the point is the trace shape, not the
factors.  The serve waves keep ``ServeTopKConfig``'s default
``use_kernel=True``: on the GPU each wave launches ``topk_score``.  The
last line printed is ``summary {json}``: kernel launches (the stream's,
the waves', and the run's), trace events, span names and categories,
drift ratios, host walls.  Runs on the GPU unless ``--device`` says
otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

WAVE = 8          # queries a wave
K_TOP = 5


def _launch_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", help="trace-event JSON output path")
    ap.add_argument("--metrics", default=None,
                    help="also export metrics (Prometheus text, or JSON "
                         "when the path ends in .json)")
    ap.add_argument("--batches", type=int, default=12,
                    help="streaming batches to ingest (default 12)")
    ap.add_argument("--waves", type=int, default=16,
                    help="serving request waves (default 16)")
    ap.add_argument("--rows", type=int, default=32,
                    help="rows per batch (default 32)")
    ap.add_argument("--n", type=int, default=2048,
                    help="column universe (default 2048)")
    ap.add_argument("--rank", type=int, default=8,
                    help="streaming truncate_rank (default 8)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import obs, resolve_device
    from repro_torch.core import api
    from repro_torch.kernels import launch_counts

    device = resolve_device(args.device)
    obs.enable()
    try:
        rng = np.random.default_rng(0)
        cfg = api.SolveConfig(method="none", truncate_rank=args.rank,
                              observe=True)
        batches = (torch.from_numpy(rng.normal(size=(args.rows, args.n))
                                    .astype(np.float32))
                   for _ in range(args.batches))
        at_start = launch_counts()
        t0 = time.perf_counter()
        res = api.svd_stream(batches, cfg, device=device)
        _sync(device)
        stream_s = time.perf_counter() - t0
        at_serve = launch_counts()
        d = res.diagnostics
        print(f"ingested {args.batches} batches -> rank {res.state.rank} "
              f"(compile {d.compile_time_s:.2f}s, run {d.run_time_s:.2f}s)")

        handle = api.serve_init(res.state,
                                api.ServeTopKConfig(batch_size=WAVE,
                                                    k_top=K_TOP))
        t0 = time.perf_counter()
        for w in range(args.waves):
            q = torch.from_numpy(rng.normal(size=(WAVE, args.rank))
                                 .astype(np.float32)).to(device)
            api.serve_topk(handle, q)
            if w == args.waves // 2:
                # one mid-run commit so the trace shows stage/publish
                handle.commit(res.state)
        _sync(device)
        serve_s = time.perf_counter() - t0
        at_end = launch_counts()
        print(f"served {args.waves} waves; endpoint metrics: "
              f"{handle.metrics()}")

        n_ev = obs.write_chrome_trace(args.out)
        print(f"wrote {n_ev} trace events -> {args.out} "
              f"(open at https://ui.perfetto.dev)")
        ratios = obs.drift_ratios()
        print(f"drift ratios (measured/planned peak bytes): "
              f"{ {k: round(v, 3) for k, v in ratios.items()} }")

        if args.metrics:
            with open(args.metrics, "w") as f:
                if args.metrics.endswith(".json"):
                    json.dump(obs.export_json(), f, indent=2)
                else:
                    f.write(obs.export_text())
            print(f"wrote metrics -> {args.metrics}")

        with open(args.out) as f:
            events = json.load(f)["traceEvents"]
        names = sorted({e["name"] for e in events if e["ph"] in ("X", "i")})
        summary = dict(
            device=str(device), batches=args.batches, waves=args.waves,
            rows=args.rows, n=args.n, rank=res.state.rank,
            launches=_launch_delta(at_start, at_end),
            stream_launches=_launch_delta(at_start, at_serve),
            serve_launches=_launch_delta(at_serve, at_end),
            trace_events=n_ev, span_names=names,
            span_categories=sorted({e["name"].split(".", 1)[0]
                                    for e in events if e["ph"] == "X"}),
            drift=ratios, stream_s=stream_s, serve_s=serve_s)
    finally:
        obs.disable()
        obs.reset()
    print("summary " + json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
