"""Where the streaming example's first ingest and first window spend their
peak bytes, stage by stage, beside the rule R5 / R6 terms that price them.

    python3 scripts/drift_stages_torch.py [--src DIR] [--out PATH]

Runs on the GPU (it exits 1 without one).  At the shapes of
``examples/streaming_svd_torch.py`` (N = 4096 columns in 8 blocks, rank
32, oversample 16; sparse days of 64 rows, then dense ticks of 16 rows
in windows) it

1. runs the example's flow with obs on and reports the drift ratios the
   monitor recorded (``R5``: measured peak over the plan's closed form,
   first ingest of each shape; ``R6``: first window),
2. runs it again with obs off and every ``obs.span`` wrapped by a probe
   that reads the allocator at each span boundary (``memory_allocated``,
   then ``max_memory_allocated`` since the previous boundary, then a peak
   reset): for each stage, the live bytes on entry, the peak above them
   while the stage ran, and what it left allocated, and
3. measures cuSOLVER's QR (``torch.linalg.qr``, ``torch.geqrf``) at tall
   panels of 4,096 rows: its peak above its own outputs.

``--src`` imports ``repro_torch`` from another checkout's ``src`` (to put
a parent tree's stages beside this one's in one run).  Every number is
printed as JSON (and written to ``--out``); ``chip_smoke.py`` runs it as
its phase ``drift_stages``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import warnings

# The R5 / R6 term each stage's buffers are priced by.
TERMS = {
    "as_delta": "inputs",
    "window.prologue": "inputs",
    "split_and_repair": "repair",
    "gram_stack": "batch factorization",
    "merge_grams_eigh": "batch factorization",
    "sketch": "batch factorization",
    "pullback": "batch factorization",
    "qr": "batch factorization",
    "sketch_gram": "batch factorization",
    "truncate_sketch": "batch factorization",
    "right_vectors": "merge panel (batch part)",
    "right_vectors_stack": "merge panel (batch part)",
    "merge.svd": "merge panel + workspace",
    "merge.gram": "merge panel + workspace",
    "u_update": "outside the form (u grows with rows seen)",
    "ingest.batch": "R5 total",
    "ingest.window": "R6 total",
    "diagnostics": "outputs (host reads)",
    "describe_and_plan": "none (host)",
}

N, ROWS_PER_DAY, TICK_ROWS = 4096, 64, 16


class StageProbe:
    """Wraps ``obs.span`` so that every span boundary reads the allocator
    (no synchronize: the caching allocator counts on the host)."""

    def __init__(self, torch, obs, device):
        self.torch, self.obs, self.device = torch, obs, device
        self.peaks = []          # peak of each interval between boundaries
        self.stack = []
        self.rows = []
        self._orig = None

    def _boundary(self) -> int:
        t = self.torch.cuda
        self.peaks.append(t.max_memory_allocated(self.device))
        now = t.memory_allocated(self.device)
        t.reset_peak_memory_stats(self.device)
        return now

    def install(self):
        self._orig = self.obs.span
        probe = self

        @contextlib.contextmanager
        def span(name, **kw):
            live = probe._boundary()
            probe.stack.append((name, live, len(probe.peaks)))
            try:
                with probe._orig(name, **kw) as sp:
                    yield sp
            finally:
                out = probe._boundary()
                name_, live_in, first = probe.stack.pop()
                peak = max(probe.peaks[first:] + [live_in])
                probe.rows.append(dict(
                    stage=name_, depth=len(probe.stack), term=TERMS.get(
                        name_, "?"), live_in=live_in,
                    peak_above_entry=peak - live_in,
                    left_allocated=out - live_in))

        self.obs.span = span
        return self

    def remove(self):
        self.obs.span = self._orig

    def take(self):
        rows, self.rows, self.peaks = self.rows, [], []
        return rows


def _summary(rows):
    """Per stage name: calls, the largest peak above entry, the largest
    live bytes on entry."""
    out = {}
    for r in rows:
        e = out.setdefault(r["stage"], dict(
            stage=r["stage"], term=r["term"], calls=0, peak_above_entry=0,
            live_in=0, depth=r["depth"]))
        e["calls"] += 1
        e["peak_above_entry"] = max(e["peak_above_entry"],
                                    r["peak_above_entry"])
        e["live_in"] = max(e["live_in"], r["live_in"])
    return sorted(out.values(), key=lambda e: -e["peak_above_entry"])


def run(device=None, src=None) -> dict:
    if src:
        sys.path.insert(0, os.path.abspath(src))
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.core import planner, sparse
    from repro_torch.core.api import SolveConfig, svd_init, svd_stream, \
        svd_update

    device = torch.device(device or "cuda")
    cfg = SolveConfig(method="neighbor_random", truncate_rank=32,
                      oversample=16, num_blocks=8)

    def day(d):
        return sparse.ensure_full_row_rank(
            sparse.random_bipartite(ROWS_PER_DAY, N, 1e-2, seed=100 + d,
                                    weighted=True), seed=100 + d)

    def ticks(num):
        rng = np.random.default_rng(7)
        for _ in range(num):
            yield (rng.standard_normal((TICK_ROWS, N)).astype(np.float32)
                   * (rng.random((TICK_ROWS, N)) < 5e-3))

    def flow():
        st = svd_init(N, cfg, device=device)
        for d in range(2):
            st = svd_update(st, day(d), cfg).state
        res = svd_stream(ticks(12), cfg, device=device)
        torch.cuda.synchronize(device)
        return st, res

    with torch.cuda.device(device):
        torch.cuda.current_blas_handle()
    flow()                                   # warm: kernels built, handles
    obs.disable()
    obs.reset()
    obs.enable()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        flow()
    drift = obs.drift_ratios()
    records = obs.drift.monitor().records()
    warned = [str(w.message) for w in caught
              if issubclass(w.category, obs.DriftWarning)]
    obs.disable()
    obs.reset()

    # Obs stays off: the wrapped span still reaches the probe, and no
    # drift measurement resets the peak counter under it.
    probe = StageProbe(torch, obs, device).install()
    try:
        st = svd_init(N, cfg, device=device)
        first = svd_update(st, day(0), cfg)
        ingest_first = probe.take()
        svd_update(first.state, day(1), cfg)
        ingest_second = probe.take()
        svd_stream(ticks(12), cfg, device=device)
        stream_rows = probe.take()
    finally:
        probe.remove()

    batch = planner.ASpec(m=ROWS_PER_DAY, n=N, nnz=ROWS_PER_DAY * N,
                          num_blocks=8, kind="stream")
    k, p = cfg.truncate_rank, cfg.oversample
    terms_r5 = dict(
        factorization=planner.exact_bytes(batch),
        repair=planner.stream_repair_bytes(batch),
        merge=planner.stream_merge_bytes(batch, k, p),
        total=planner.streaming_bytes(batch, k, p, exact=True))
    tick = planner.ASpec(m=TICK_ROWS, n=N, nnz=TICK_ROWS * N, num_blocks=8,
                         kind="stream")
    terms_r5_tick = dict(
        factorization=planner.exact_bytes(tick),
        repair=planner.stream_repair_bytes(tick),
        merge=planner.stream_merge_bytes(tick, k, p),
        total=planner.streaming_bytes(tick, k, p, exact=True))
    # The merge's QR (cuSOLVER geqrf + orgqr through torch.linalg.qr) at
    # the stages' tall panels: its peak above its own outputs is a
    # workspace the closed forms do not price.
    library = []
    for cols in (16, 48, 64, 80):
        p = torch.randn((N, cols), device=device)
        for name, call in (("linalg.qr", lambda: torch.linalg.qr(p)),
                           ("geqrf", lambda: torch.geqrf(p))):
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            before = torch.cuda.memory_allocated(device)
            out = call()
            torch.cuda.synchronize(device)
            peak = torch.cuda.max_memory_allocated(device) - before
            kept = torch.cuda.memory_allocated(device) - before
            library.append(dict(call=name, panel=[N, cols], peak=peak,
                                outputs=kept, workspace=peak - kept))
            del out
    return {
        "device": torch.cuda.get_device_name(device),
        "drift": drift,
        "drift_records": records,
        "library": library,
        "drift_warnings": warned,
        "r5_terms_day": terms_r5,
        "r5_terms_tick": terms_r5_tick,
        "ingest_first": _summary(ingest_first),
        "ingest_second": _summary(ingest_second),
        "stream_ticks": _summary(stream_rows),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("drift_stages_torch: no CUDA device", file=sys.stderr)
        return 1
    out = run(src=args.src)
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
