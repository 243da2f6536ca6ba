#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, on the card, at
the cell's own size:

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 \\
        [--seconds 3]

For each seed, one line of JSON on standard output: the control's
numbers (the plain reference put in the program's place, every product's
inputs rounded to TF32: the precision just below the float32 with TF32
off that the configurations state), and the program's numbers after a
short window at the cell's own load, judged as a run judges them.  One
process reads every seed, so the program's kernels are built once.  The
benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import run as _run


def readings(cell: dict, seed: int, seconds: float, device) -> dict:
    import torch

    from perfbench import common, spec

    wl = cell["workload"]
    traffic = spec.traffic(wl)
    ctx = common.Context(name=cell["name"], seed=seed, seconds=seconds,
                         trace=False, device=device, config=cell["config"],
                         workload=wl)
    t0 = time.perf_counter()
    st = traffic.setup(ctx)
    out = {"seed": seed, "setup_s": time.perf_counter() - t0}
    win = traffic.window(ctx, st)
    out["attempted"], out["failed"] = win.attempted, win.failed
    traffic.free_program(st)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["program"] = traffic.check(ctx, st, win)
    out["check_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["control"] = traffic.control(ctx, st, win)
    out["control_s"] = time.perf_counter() - t0
    out["limits"] = wl["limits"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    _run._fixed_caches()
    sys.path[:0] = [str(_run.ROOT), str(_run.ROOT / "src")]
    import torch

    from perfbench import spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        out = readings(cell, seed, args.seconds, torch.device("cuda", 0))
        print(json.dumps(out), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    forbidden = _run.loaded_forbidden()
    if forbidden:
        print(f"JAX or the JAX package was loaded: {forbidden}",
              file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
