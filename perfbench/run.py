#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card it is started on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Each run is a new process: it makes its
data from ``--seed``, warms up every shape the cell's traffic uses
(set-up, reported as ``setup_s``), runs the timed window for
``--seconds``, checks the window's answers against the plain reference,
and prints one JSON line last on standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``; with ``--trace 1``
also ``breakdown``, and the per-layer metrics in place of the end-to-end
ones, over a window of at most ``TRACE_SECONDS``).  The numbers compared
by the check, each beside its limit, are the last lines of standard
error and the last key of the line.

It exits non-zero and prints no result without enough CUDA devices,
without the program (``src/repro_torch``), or when JAX or the JAX package
was loaded.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# Spans the program may record in a traced window.
RING_CAPACITY = 1 << 21
# The longest window a traced run times: reading the profile of a 51 s
# window of some thousands of kernels a second took ~180 s on the card's
# host, and the whole run has to end within 360 s.
TRACE_SECONDS = 15.0


def _seconds_since_start() -> float:
    """Seconds since this process started (its start time in /proc, on
    the boot clock), so that set-up counts the interpreter's start."""
    with open("/proc/self/stat") as f:
        stat = f.read()
    start_ticks = int(stat[stat.rindex(")") + 2:].split()[19])
    return (time.clock_gettime(time.CLOCK_BOOTTIME)
            - start_ticks / os.sysconf("SC_CLK_TCK"))


def _fixed_caches() -> None:
    """Every kernel cache at a fixed path inside the checkout (the CUDA
    kernels build into ``build/repro_torch/`` by themselves)."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def loaded_forbidden() -> list:
    """Modules of JAX or of the JAX package in this process, compared by
    their whole top-level name (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _limits_met(checks: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def run_cell(cell: dict, *, seed: int, seconds: float, trace: bool,
             device, t_start: float) -> dict:
    """One run of ``cell`` (``spec.cell``) on ``device``; the result line
    as a dict.  ``t_start`` is the process's start on the
    ``time.perf_counter`` clock."""
    import torch

    from perfbench import common, spec
    from perfbench import trace as tr
    from repro_torch import obs
    from repro_torch.kernels import build

    wl = cell["workload"]
    traffic = spec.traffic(wl)
    if trace:
        seconds = min(seconds, TRACE_SECONDS)
    ctx = common.Context(name=cell["name"], seed=seed, seconds=seconds,
                         trace=trace, device=device, config=cell["config"],
                         workload=wl)
    if trace:
        obs.enable(ring_capacity=RING_CAPACITY)
    t_data = time.perf_counter()
    st = traffic.setup(ctx)
    common.sync(device)
    common.log(f"set-up: {t_data - t_start:.3f} s to the cell's set-up, "
               f"{time.perf_counter() - t_data:.3f} s in it (data, warm-up)")
    ctx.ops.clear()
    mark = obs.trace.mark()
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    setup_s = time.perf_counter() - t_start
    with torch.profiler.record_function(tr.WINDOW_LABEL):
        win = traffic.window(ctx, st)
        common.sync(device)
    td = None
    if prof is not None:
        prof.stop()
        td = tr.from_profiler(prof, obs.trace.events_since(mark), ctx.ops,
                              wl, cell["config"])
        del prof
        obs.disable()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    traffic.free_program(st)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = traffic.check(ctx, st, win)
    checks = {k: {"value": float(numbers.get(k, math.nan)), "limit": lim}
              for k, lim in wl["limits"].items()}
    correct = (win.failed == 0 and win.attempted > 0 and _limits_met(checks))

    metrics = {}
    if td is None:
        values = dict(win.metrics, setup_s=setup_s)
        for m in cell["end_to_end"]:
            # ``<quantity>.<group>``: the traffic's ``<quantity>`` in a
            # group of cells that a bound of its own holds.
            name = m["name"]
            key = name if name in values else name.split(".")[0]
            metrics[name] = {"value": values[key], "unit": m["unit"]}
    else:
        for m in cell["per_layer"]:
            value = spec.layer_reader(m["name"]).read(td)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["entry"]["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": win.attempted,
           "failed": win.failed, "metrics": metrics, "device": dev}
    if td is not None:
        dev["busy_s"] = td.busy_s
        dev["window_s"] = td.window_s
        out["breakdown"] = {"device_ops": tr.device_ops(td),
                            "idle_gaps": tr.idle_gaps(td)}
    out["compile_s"] = build.build_seconds or 0.0
    out["window_s"] = win.seconds
    out["window_info"] = win.info
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    t_start = time.perf_counter() - _seconds_since_start()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    _fixed_caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import common, spec

    cell = spec.cell(args.workload)
    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        common.log(f"{args.workload} needs {chips} CUDA device(s); "
                   f"{torch.cuda.device_count()} available: no result")
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        common.log(f"the program is not in this checkout ({exc}): no "
                   f"result")
        return 3
    out = run_cell(cell, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device=torch.device("cuda", 0),
                   t_start=t_start)
    # Once the window has closed (and the check run): modules stay loaded.
    forbidden = loaded_forbidden()
    if forbidden:
        common.log(f"JAX or the JAX package was loaded: {forbidden}: no "
                   f"result")
        return 4
    for name, c in out["checks"].items():
        common.log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
        if not math.isfinite(c["value"]):
            c["value"] = repr(c["value"])   # strict JSON has no inf or nan
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
