"""Traffic kind ``solve``: one caller, closed loop, ``api.svd`` back to
back over a pool of distinct matrices made from the seed.

Workload parameters: ``solve`` (the SolveConfig fields of the cell:
``rank``, ``oversample``, ``power_iters``, ``backend``, ``want_right``,
and the ``strategy`` the plan must choose), ``pool`` (distinct matrices,
taken in turn, all in ``BlockEll``s of one capacity, at least
``ell_slots`` slots a column), ``warmup`` (solves before the window),
``checked``
(one answer judged for each of as many of the pool's matrices, sampled
from the seed).
End-to-end: ``solve_ms``, the window's seconds over its solves.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from perfbench import bipartite, common
from perfbench.common import Context, Window
from perfbench.reference import solve as ref
from perfbench.reference.matrix import CONTROL


def _solve_config(ctx: Context):
    from repro_torch.core import api

    c, s = ctx.config, ctx.workload["solve"]
    return api.SolveConfig(
        method=c["method"], num_blocks=c["num_blocks"],
        backend=s.get("backend", "auto"), rank=s.get("rank"),
        oversample=s.get("oversample", 8),
        power_iters=s.get("power_iters", 2),
        want_right=s.get("want_right", False))


def make_data(ctx: Context) -> dict:
    """The pool of matrices (triples and ``BlockEll``s at one capacity),
    the repair's draws and Omega, all from the seed."""
    c, w = ctx.config, ctx.workload
    m, n, d = c["rows"], c["cols"], c["num_blocks"]
    gen = ctx.generator(common.TAG_MATRIX)
    mats = [bipartite.random_bipartite(m, n, c["density"], gen, ctx.device)
            for _ in range(w["pool"])]
    caps = [bipartite.capacity(cols, n, d) for _, cols in mats]
    c_cap = -(-max(cc for cc, _ in caps) // 8) * 8
    # At least ``ell_slots`` a column: the most entries of a column is 9
    # or 10 by the seed (Poisson(~1) counts over 1,048,576 columns), and
    # every solve walks the padded slots, so the seed would move the work.
    k_cap = max([k for _, k in caps] + [w["ell_slots"]])
    ells = [bipartite.block_ell(r, cl, m, n, d, c_cap=c_cap, k_cap=k_cap)
            for r, cl in mats]
    draws = bipartite.repair_draws(ctx.generator(common.TAG_DRAWS), d, m,
                                   c_cap, n, ctx.device)
    rank = w["solve"].get("rank")
    omega = None
    if rank is not None:
        l = min(rank + w["solve"].get("oversample", 8), m)
        omega = torch.randn((l, m), generator=ctx.generator(
            common.TAG_OMEGA), device=ctx.device)
    return dict(mats=mats, ells=ells, draws=draws, omega=omega,
                stats=[bipartite.stats(r, cl, m, n, d) for r, cl in mats],
                capacity=(c_cap, k_cap))


def setup(ctx: Context) -> dict:
    from repro_torch.core import api

    data = make_data(ctx)
    cfg = _solve_config(ctx)
    want = ctx.workload["solve"]["strategy"]
    for i in range(ctx.workload["warmup"]):
        res = api.svd(data["ells"][i % len(data["ells"])], cfg,
                      draws=data["draws"], omega=data["omega"],
                      device=ctx.device)
        if res.plan.strategy != want:
            raise RuntimeError(f"{ctx.name}: the plan chose "
                               f"{res.plan.strategy!r}, the cell wants "
                               f"{want!r}")
        del res
    data["cfg"] = cfg
    return data


def window(ctx: Context, st: dict) -> Window:
    from repro_torch.core import api

    pool = len(st["ells"])
    # One answer of each of the first ``checked`` matrices of the pool,
    # each drawn from its solves by the seed.
    kept = {j: ctx.reservoir(1, j)
            for j in range(min(ctx.workload["checked"], pool))}
    rank = ctx.workload["solve"].get("rank")
    done = failed = 0
    t0 = time.perf_counter()
    while True:
        j = done % pool
        try:
            with torch.profiler.record_function("perfbench.solve"):
                res = api.svd(st["ells"][j], st["cfg"], draws=st["draws"],
                              omega=st["omega"], device=ctx.device)
        except Exception as exc:               # a failed solve is counted
            common.log(f"solve {done} failed: {exc!r}")
            failed += 1
            res = None
        done += 1
        ctx.ops.append(dict(op="solve", stats=st["stats"][j], rank=rank,
                            l=None if st["omega"] is None
                            else st["omega"].shape[0]))
        if res is not None and j in kept:
            kept[j].offer(lambda: (j, res.u, res.s, res.v))
        del res
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    secs = time.perf_counter() - t0
    return Window(attempted=done, failed=failed, seconds=secs,
                  metrics={"solve_ms": secs * 1e3 / done},
                  samples=[x for r in kept.values() for x in r.items],
                  info={"ell_capacity": st["capacity"]})


def case(ctx: Context, st: dict, j: int) -> dict:
    """What the reference needs of pool matrix ``j``: the benchmark's own
    inputs, never the program's container."""
    c, s = ctx.config, ctx.workload["solve"]
    rows, cols = st["mats"][j]
    return dict(rows=rows, cols=cols, m=c["rows"], n=c["cols"],
                num_blocks=c["num_blocks"],
                random_cols=st["draws"].random_cols,
                scores=st["draws"].neighbor_scores, rank=s.get("rank"),
                omega=st["omega"], power_iters=s.get("power_iters", 2))


def check(ctx: Context, st: dict, win: Window) -> Dict[str, float]:
    readings = [ref.judge(case(ctx, st, j), (u, s, v))
                for j, u, s, v in win.samples]
    return common.worst(readings)


def control(ctx: Context, st: dict, win: Window) -> Dict[str, float]:
    """The control's numbers: the reference in TF32 in the program's place,
    on the matrices of the answers the run checked."""
    readings = []
    for j, *_ in win.samples:
        c = case(ctx, st, j)
        readings.append(ref.judge(c, ref.solve(c, CONTROL)))
    return common.worst(readings)


def free_program(st: dict) -> None:
    """Drop what only the program needs before the reference runs."""
    st.pop("ells", None)
