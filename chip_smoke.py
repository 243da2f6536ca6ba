#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU, end to end.

    python3 chip_smoke.py            # needs one CUDA device

What it does, one JSON line per phase:

1. ``device``: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions.
2. ``build``: compiles ``src/repro_torch/csrc/*.cu`` with ``nvcc`` into
   ``build/`` (this is the first use of the kernels) and reports the seconds.
3. ``kernels``: calls each hand-written kernel's wrapper on the paper
   matrix's own arrays and holds it against its plain PyTorch version on the
   same inputs, with variants (weighted values, bf16 input, ragged shapes, a
   block whose slots are all padding).  Times kernel, plain version and,
   where one PyTorch call computes the same function, that call, and works
   out the least time the card could take (``bound_ms``).
4. ``solve_sparse_exact`` / 5. ``solve_dense_exact`` / 6. ``solve_randomized``
   / 7. ``solve_scaled``: ``repro_torch.core.api.svd`` on the paper's
   539 x 170,897 matrix (COO and dense input, exact and rank-16) and on two
   larger matrices, each result held against a float64 (or scipy) reference
   of the repaired matrix.  Every kernel's launch counter is set to 0 just
   before each solve and read just after it; the counts are kept solve by
   solve and never added up across solves.  Stage times come from the
   solver's own stage timers (``repro_torch.core.stages``) around further
   warm solves.
8. One line ``{"kernels": [...]}`` with every kernel's numbers, then the card
   as ``nvidia-smi`` names it, then the last line
   ``{"ok": true, "device": {...}}``.

It takes no arguments, runs every phase, exits non-zero at the first phase
that fails, and right away when no CUDA device is present: nothing here runs
on the CPU instead.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs.ranky_paper import RankyPaperConfig  # noqa: E402
from repro_torch.core import api, ranky, sparse, stages  # noqa: E402
from repro_torch.data import bipartite  # noqa: E402
from repro_torch.kernels import blockgram as bg_mod  # noqa: E402
from repro_torch.kernels import build as kernel_build  # noqa: E402
from repro_torch.kernels import sketch_panel as sp_mod  # noqa: E402
from repro_torch.kernels import sparse_gram as sg_mod  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate
# and float32 rate outside the tensor cores.  bound_ms is stated against them.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

NUM_BLOCKS = 8
DEVICE = "cuda"
# (M, N) of the two matrices of phase 7; density 5e-4 like the paper's.
SCALED_EXACT = (2048, 1_048_576)
SCALED_TALL = (32_768, 262_144)
KERNEL_MODULES = {"sparse_gram": sg_mod, "blockgram": bg_mod,
                  "sketch_panel": sp_mod}
# ``launches_in``: the solve of the main path whose count is the kernel's
# ``launches`` (the first solve that should reach it).  The counts of every
# solve stand beside it under ``launches_by_solve``.
KERNEL_INFO = {
    "sparse_gram": dict(route="cuda",
                        source="src/repro_torch/csrc/sparse_gram.cu",
                        replaces="src/repro/kernels/sparse_gram.py:76",
                        launches_in="solve_sparse_exact[gram]"),
    "blockgram": dict(route="cuda",
                      source="src/repro_torch/csrc/blockgram.cu",
                      replaces="src/repro/kernels/blockgram.py:59",
                      launches_in="solve_dense_exact"),
    "sketch_panel": dict(route="cuda",
                         source="src/repro_torch/csrc/sketch_panel.cu",
                         replaces="src/repro/kernels/sketch_panel.py:82",
                         launches_in="solve_randomized[p=8,q=2]"),
}


class SmokeFailure(Exception):
    """A phase did not hold; the run ends with a non-zero exit code."""


def check(cond, what: str) -> None:
    if not bool(cond):
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[torch.cuda.current_device()]


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------

_flush_buf = None


def flush_l2() -> None:
    """Overwrite 128 MB so the next launch finds the 50 MB L2 cold, as the
    solver does (its inputs were produced by other work)."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=DEVICE)
    _flush_buf.zero_()


def time_ms(fn, *, iters: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn()`` over ``iters`` cold-cache launches."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush_l2()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(bytes_moved: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the f32 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sparse_gram_bound(rows, vals, m):
    d = rows.shape[0]
    per_col = (vals != 0).sum(dim=-1).double()
    pairs = float((per_col * per_col).sum())       # what THIS data needs
    nbytes = rows.numel() * 4 + vals.numel() * 4 + d * m * m * 4
    return bound(nbytes, 2.0 * pairs)


def blockgram_bound(a):
    """G = A A^T is symmetric: a multiply and an add for each of the
    M (M + 1) / 2 entries on or above the diagonal, per column of A."""
    d, m, w = a.shape
    nbytes = a.numel() * a.element_size() + d * m * m * 4
    return bound(nbytes, float(d) * m * (m + 1) * w)


def sketch_panel_bound(omega, rows, vals):
    l, m = omega.shape
    d, c, _ = rows.shape
    nnz = float((vals != 0).sum())
    nbytes = l * m * 4 + rows.numel() * 4 + vals.numel() * 4 + d * l * c * 4
    return bound(nbytes, 2.0 * l * nnz)


def max_err(x, y) -> float:
    return float((x.double() - y.double()).abs().max()) if x.numel() else 0.0


def reset_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0


def read_counts() -> dict:
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


# ---------------------------------------------------------------------------
# Phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------

def compare(name, got, want, rel_limit, results, case):
    """Hold ``got`` to ``want`` at ``rel_limit * max|want|`` (0 = exact)."""
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == torch.float32,
          f"{name}[{case}]: shape/dtype {tuple(got.shape)} {got.dtype}")
    check(torch.isfinite(got).all(), f"{name}[{case}]: non-finite output")
    err = max_err(got, want)
    limit = rel_limit * float(want.abs().max()) if want.numel() else 0.0
    results.append(dict(kernel=name, case=case, max_abs_err=err, limit=limit))
    check(err <= limit, f"{name}[{case}]: max abs err {err} > limit {limit}")
    return err


def synthetic_ell(rng, d, c, k, m, *, weighted, empty_block=None):
    """Random (D, C, K) ELL arrays with padding slots, duplicate rows inside
    a column, and optionally one block whose slots are all padding."""
    rows = rng.integers(0, m, size=(d, c, k)).astype(np.int32)
    vals = (rng.uniform(0.5, 2.0, size=(d, c, k)) if weighted
            else np.ones((d, c, k))).astype(np.float32)
    vals *= rng.random((d, c, k)) < 0.6            # padding slots
    rows[:, ::3, -1] = rows[:, ::3, 0]             # duplicates in a column
    if empty_block is not None:
        vals[empty_block] = 0.0
    rows[vals == 0] = 0
    return (torch.from_numpy(rows).to(DEVICE), torch.from_numpy(vals).to(DEVICE))


def phase_kernels(state) -> None:
    cfg = RankyPaperConfig()
    coo = state["coo"]
    ell = state["ell"]
    rows, vals, m = ell.col_rows, ell.col_vals, ell.m
    cases = []
    main = {}
    rng = np.random.default_rng(7)

    # --- sparse_gram ------------------------------------------------------
    want = sg_mod.sparse_gram_ref(rows, vals, m)
    got = sg_mod.sparse_gram(rows, vals, m)
    err = compare("sparse_gram", got, want, 0.0, cases, "paper 0/1 (exact)")
    again = sg_mod.sparse_gram(rows, vals, m)
    check(torch.equal(got, again), "sparse_gram: 0/1 data not bit-stable "
          "from run to run")
    b_ms, b_by = sparse_gram_bound(rows, vals, m)
    main["sparse_gram"] = dict(
        shape=f"rows/vals {tuple(rows.shape)} -> {tuple(got.shape)}",
        max_abs_err=err,
        ms=time_ms(lambda: sg_mod.sparse_gram(rows, vals, m)),
        plain_ms=time_ms(lambda: sg_mod.sparse_gram_ref(rows, vals, m)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

    wcoo = sparse.random_bipartite(cfg.rows, cfg.cols, cfg.density,
                                   seed=cfg.seed, weighted=True)
    well = sparse.block_ell_from_coo(wcoo, NUM_BLOCKS, device=DEVICE)
    w1 = sg_mod.sparse_gram(well.col_rows, well.col_vals, m)
    w2 = sg_mod.sparse_gram(well.col_rows, well.col_vals, m)
    compare("sparse_gram", w1,
            sg_mod.sparse_gram_ref(well.col_rows, well.col_vals, m), 1e-5,
            cases, "paper shape, weighted")
    state["sparse_gram_weighted_bit_stable"] = bool(torch.equal(w1, w2))
    r2, v2 = synthetic_ell(rng, 3, 37, 5, 67, weighted=True, empty_block=1)
    g2 = sg_mod.sparse_gram(r2, v2, 67)
    compare("sparse_gram", g2, sg_mod.sparse_gram_ref(r2, v2, 67), 1e-5,
            cases, "ragged D=3 C=37 K=5 M=67, duplicates, block 1 all padding")
    check(float(g2[1].abs().max()) == 0.0,
          "sparse_gram: an all-padding block must give a zero gram")

    # --- blockgram --------------------------------------------------------
    dense = torch.from_numpy(sparse.pad_to_block_multiple(
        coo.todense(), NUM_BLOCKS)).to(DEVICE)
    blocks = dense.reshape(m, NUM_BLOCKS, -1).permute(1, 0, 2).contiguous()
    del dense
    want = bg_mod.blockgram_ref(blocks)
    got = bg_mod.blockgram(blocks)
    err = compare("blockgram", got, want, 1e-5, cases,
                  f"paper dense {tuple(blocks.shape)}")
    check(torch.equal(got, got.mT), "blockgram: the gram is not exactly "
          "symmetric")
    b_ms, b_by = blockgram_bound(blocks)
    main["blockgram"] = dict(
        shape=f"{tuple(blocks.shape)} f32 -> {tuple(got.shape)}",
        max_abs_err=err,
        ms=time_ms(lambda: bg_mod.blockgram(blocks), iters=5, warmup=1),
        plain_ms=time_ms(lambda: bg_mod.blockgram_ref(blocks), iters=5,
                         warmup=1),
        bound_ms=b_ms, bound_by=b_by,
        # The yardstick only: the port never calls bmm for this product.
        library_ms=time_ms(lambda: torch.bmm(blocks, blocks.mT), iters=5,
                           warmup=1))
    del blocks, want, got
    a_w = torch.from_numpy(rng.standard_normal((3, 67, 203))
                           .astype(np.float32)).to(DEVICE)
    compare("blockgram", bg_mod.blockgram(a_w), bg_mod.blockgram_ref(a_w),
            1e-5, cases, "ragged D=3 M=67 W=203, gaussian f32")
    a_bf = a_w.to(torch.bfloat16)
    compare("blockgram", bg_mod.blockgram(a_bf), bg_mod.blockgram_ref(a_bf),
            1e-5, cases, "ragged D=3 M=67 W=203, bf16 input")
    a_one = torch.from_numpy(rng.standard_normal((1, 130, 31))
                             .astype(np.float32)).to(DEVICE)
    compare("blockgram", bg_mod.blockgram(a_one), bg_mod.blockgram_ref(a_one),
            1e-5, cases, "M=130 W=31 (W below one chunk)")

    # --- sketch_panel -----------------------------------------------------
    omega = torch.from_numpy(rng.standard_normal((24, m))
                             .astype(np.float32)).to(DEVICE)
    want = sp_mod.sketch_panel_ref(omega, rows, vals)
    got = sp_mod.sketch_panel(omega, rows, vals)
    err = compare("sketch_panel", got, want, 1e-5, cases,
                  "paper ELL, omega (24, 539)")
    b_ms, b_by = sketch_panel_bound(omega, rows, vals)
    main["sketch_panel"] = dict(
        shape=f"omega {tuple(omega.shape)}, rows/vals {tuple(rows.shape)} "
              f"-> {tuple(got.shape)}",
        max_abs_err=err,
        ms=time_ms(lambda: sp_mod.sketch_panel(omega, rows, vals)),
        plain_ms=time_ms(lambda: sp_mod.sketch_panel_ref(omega, rows, vals)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    compare("sketch_panel",
            sp_mod.sketch_panel(omega, well.col_rows, well.col_vals),
            sp_mod.sketch_panel_ref(omega, well.col_rows, well.col_vals),
            1e-5, cases, "paper shape, weighted")
    om2 = torch.from_numpy(rng.standard_normal((41, 67))
                           .astype(np.float32)).to(DEVICE)
    s2 = sp_mod.sketch_panel(om2, r2, v2)
    compare("sketch_panel", s2, sp_mod.sketch_panel_ref(om2, r2, v2), 1e-5,
            cases, "ragged L=41 M=67 C=37 K=5, duplicates, block 1 all padding")
    check(float(s2[1].abs().max()) == 0.0,
          "sketch_panel: an all-padding block must give a zero panel")

    state["kernel_main"] = main
    emit("kernels", cases=cases, main_shapes=main,
         sparse_gram_weighted_bit_stable=state[
             "sparse_gram_weighted_bit_stable"],
         tolerance="0 for 0/1 sparse_gram; else 1e-5 * max|plain| "
                   "(f32 summation order)")


# ---------------------------------------------------------------------------
# Float64 references of a repaired matrix
# ---------------------------------------------------------------------------

def dense_block64(blocks, d: int) -> torch.Tensor:
    """Block ``d`` of a repaired stack (either representation) as a dense
    float32 (M, W) tensor."""
    if isinstance(blocks, sparse.RepairedSparseBlocks):
        ell = blocks.ell
        one = sparse.RepairedSparseBlocks(
            sparse.BlockEll(ell.col_ids[d:d + 1], ell.col_rows[d:d + 1],
                            ell.col_vals[d:d + 1], m=ell.m, width=ell.width,
                            n=ell.width),
            blocks.repair_cols[d:d + 1], blocks.repair_mask[d:d + 1])
        return one.todense_blocks()[0]
    return blocks[d]


def reference_svals(blocks, num_blocks: int, chunk: int = 16384):
    """sqrt(eigvalsh(A64 A64^T)) of the repaired matrix, descending, the
    float64 gram accumulated block by block over column chunks so that the
    dense matrix is never held whole.  In float64 the gram's squared
    condition number costs about 1e-16 * S[0]^2 / S[i] in S[i]: far below
    every limit used here."""
    g = None
    for d in range(num_blocks):
        blk = dense_block64(blocks, d)
        if g is None:
            g = torch.zeros((blk.shape[0], blk.shape[0]),
                            dtype=torch.float64, device=blk.device)
        for c0 in range(0, blk.shape[1], chunk):
            a64 = blk[:, c0:c0 + chunk].double()
            g += a64 @ a64.T
        del blk
    ev = torch.linalg.eigvalsh(g)
    return torch.sqrt(torch.clamp(torch.flip(ev, dims=(0,)), min=0.0))


def check_exact_result(name, res, repaired, num_blocks, *, recon=True):
    """The checks phases 4, 5 and 7a share; returns the fields to print."""
    s_ref = reference_svals(repaired, num_blocks)
    s = res.s.double()
    check(res.s.shape == s_ref.shape and torch.isfinite(res.s).all()
          and torch.isfinite(res.u).all(), f"{name}: S/U shape or finiteness")
    ds = (s - s_ref).abs()
    limit = 2e-3 * float(s_ref[0])
    check(float(ds.max()) <= limit,
          f"{name}: max|dS| {float(ds.max())} > 2e-3*S[0] = {limit}")
    m = res.u.shape[0]
    ortho = float((res.u.T @ res.u
                   - torch.eye(m, device=res.u.device)).abs().max())
    check(ortho <= 1e-4, f"{name}: |U^T U - I|_max {ortho} > 1e-4")
    out = dict(s0=float(s[0]), s_last=float(s[-1]), max_abs_dS=float(ds.max()),
               dS_limit=limit, e_sigma=float(ds.sum()), ortho_err=ortho)
    if recon and res.v is not None:
        n = res.v.shape[0]
        num = 0.0
        den = 0.0
        us = res.u * res.s[None, :]
        for d in range(num_blocks):
            blk = dense_block64(repaired, d)
            w = blk.shape[1]
            lo, hi = d * w, min((d + 1) * w, n)
            if hi <= lo:
                continue
            approx = us @ res.v[lo:hi].T
            num += float(((approx - blk[:, :hi - lo]).double() ** 2).sum())
            den += float((blk[:, :hi - lo].double() ** 2).sum())
        rel = (num / den) ** 0.5
        check(rel <= 1e-3, f"{name}: |U S V^T - A|_F / |A|_F {rel} > 1e-3")
        out["recon_rel_fro"] = rel
    return out


def timed_svd(a, cfg, **kw):
    reset_counts()
    res = api.svd(a, cfg, **kw)
    counts = read_counts()
    return res, counts


def keep_counts(state, solve: str, counts) -> None:
    """File one solve's launch counts under its own name."""
    state.setdefault("launches_by_solve", {})[solve] = counts


def diag_fields(res, counts):
    dg = res.diagnostics
    return dict(backend=res.plan.backend, strategy=res.plan.strategy,
                wall_time_s=dg.wall_time_s, compile_time_s=dg.compile_time_s,
                lonely_rows=dg.lonely_rows, repaired_rows=dg.repaired_rows,
                launches=counts)


def stage_ms(a, cfg, reps: int = 3) -> dict:
    """Where a warm solve's time goes, from the solver's own stage timers:
    ``api.svd(a, cfg)`` is run ``reps`` more times inside
    ``stages.record()`` and the run with the least wall time is kept.  A
    stage that ran n times is summed and named ``stage xn``.  Recording
    synchronizes the device around every stage, so ``recorded_wall_ms`` (the
    same run's ``wall_time_s``) may exceed the unrecorded warm time;
    ``diagnostics`` runs after the solve's wall time ends.  Made after the
    solve it describes: the launches here are not the main path's."""
    best = None
    for _ in range(reps):
        with stages.record() as times:
            res = api.svd(a, cfg)
        wall = res.diagnostics.wall_time_s
        if best is None or wall < best[0]:
            best = (wall, times)
    wall, times = best
    out = {(f"{name} x{len(runs)}" if len(runs) > 1 else name): sum(runs)
           for name, runs in times.items()}
    out["recorded_wall_ms"] = wall * 1e3
    return out


# ---------------------------------------------------------------------------
# Phases 4-7: the solves
# ---------------------------------------------------------------------------

def phase_solve_sparse_exact(state) -> None:
    coo = state["coo"]
    for merge_mode in ("gram", "proxy"):
        cfg = api.SolveConfig(method="neighbor_random", num_blocks=NUM_BLOCKS,
                              merge_mode=merge_mode, use_kernel=True,
                              want_right=True)
        res, counts = timed_svd(coo, cfg)
        name = f"solve_sparse_exact[{merge_mode}]"
        keep_counts(state, name, counts)
        check(res.plan.backend == "single", f"{name}: backend")
        check(res.plan.strategy == f"exact_{merge_mode}", f"{name}: strategy")
        check(counts["sparse_gram"] >= 1,
              f"{name}: sparse_gram was not launched")
        check(res.diagnostics.lonely_rows == res.diagnostics.repaired_rows,
              f"{name}: lonely_rows != repaired_rows")
        check(res.v is not None and res.v.shape == (coo.shape[1],
                                                    coo.shape[0]),
              f"{name}: V shape")
        repaired = ranky.split_and_repair(state["ell"], NUM_BLOCKS,
                                          cfg.method, cfg.resolved_key())
        fields = check_exact_result(name, res, repaired, NUM_BLOCKS)
        res2, _ = timed_svd(coo, cfg)
        emit("solve_sparse_exact", merge_mode=merge_mode,
             warm_wall_time_s=res2.diagnostics.wall_time_s,
             stage_ms=stage_ms(coo, cfg),
             **diag_fields(res, counts), **fields)
    state["sparse_random_repair"] = ranky.split_and_repair(
        state["ell"], NUM_BLOCKS, "random", api.SolveConfig().resolved_key())


def phase_solve_dense_exact(state) -> None:
    coo = state["coo"]
    dense = coo.todense()                          # (539, 170897) f32, host
    cfg = api.SolveConfig(method="neighbor_random", num_blocks=NUM_BLOCKS,
                          merge_mode="gram", use_kernel=True, want_right=True)
    res, counts = timed_svd(dense, cfg)
    name = "solve_dense_exact"
    keep_counts(state, name, counts)
    check(res.plan.backend == "single" and res.plan.strategy == "exact_gram",
          f"{name}: plan")
    check(counts["blockgram"] >= 1, f"{name}: blockgram was not launched")
    check(res.diagnostics.lonely_rows == res.diagnostics.repaired_rows,
          f"{name}: lonely_rows != repaired_rows")
    a_norm = api.as_block_input(dense, NUM_BLOCKS, device=DEVICE)
    repaired = ranky.split_and_repair(a_norm, NUM_BLOCKS, cfg.method,
                                      cfg.resolved_key())
    fields = check_exact_result(name, res, repaired, NUM_BLOCKS)
    del repaired
    res2, _ = timed_svd(dense, cfg)

    # method="random", same key: the dense repair lands on the very columns
    # the sparse side-band names.
    rep_dense = ranky.split_and_repair(a_norm, NUM_BLOCKS, "random",
                                       cfg.resolved_key())
    rep_sparse = state["sparse_random_repair"]
    lonely = rep_sparse.repair_mask
    d_idx, r_idx = torch.nonzero(lonely, as_tuple=True)
    hit = rep_dense[d_idx, r_idx, rep_sparse.repair_cols[lonely].long()]
    check(bool((hit == 1).all()), f"{name}: dense and sparse random repairs "
          "differ on lonely rows")
    rows_sum = rep_dense[d_idx, r_idx].sum(dim=1)
    check(bool((rows_sum == 1).all()),
          f"{name}: a repaired lonely row holds more than its one entry")
    del a_norm, rep_dense
    emit("solve_dense_exact", warm_wall_time_s=res2.diagnostics.wall_time_s,
         stage_ms=stage_ms(dense, cfg),
         random_repair_parity_rows=int(lonely.sum()),
         **diag_fields(res, counts), **fields)


def check_topk(name, s, s_ref, k):
    s = s.double().cpu()
    s_ref = torch.as_tensor(np.asarray(s_ref, dtype=np.float64))[:k]
    check(s.shape == (k,) and torch.isfinite(s).all(), f"{name}: S shape")
    tol = 1e-3 * s_ref.abs() + 1e-3 * float(s_ref[0])
    err = (s - s_ref).abs()
    check(bool((err <= tol).all()),
          f"{name}: top-{k} S off by {float(err.max())} "
          f"(rtol 1e-3, atol 1e-3*S[0])")
    return dict(s0=float(s[0]), s_k=float(s[-1]), max_abs_dS=float(err.max()),
                max_rel_dS=float((err / s_ref).max()))


def phase_solve_randomized(state) -> None:
    """Rank-16 on the paper matrix, twice.  With the default sketch
    (oversample 8, 2 power passes) the paper matrix's slowly decaying
    spectrum (S[15] / S[24] is about 1.2) leaves the sketch itself several
    percent off in the lower of the 16 values, on any device; it is held to
    what a Rayleigh-Ritz sketch guarantees (never above the true value) and
    to 10 %.  With oversample 48 and 4 power passes (the tall-row settings of
    phase 7) it is held at rtol 1e-3, atol 1e-3 * S[0]."""
    coo = state["coo"]
    repaired = state["sparse_random_repair"]
    s_ref = reference_svals(repaired, NUM_BLOCKS).cpu().numpy()
    for oversample, power_iters, tight in ((8, 2, False), (48, 4, True)):
        cfg = api.SolveConfig(backend="single", method="random", rank=16,
                              oversample=oversample, power_iters=power_iters,
                              num_blocks=NUM_BLOCKS, want_right=True)
        res, counts = timed_svd(coo, cfg)
        name = f"solve_randomized[p={oversample},q={power_iters}]"
        keep_counts(state, name, counts)
        check(res.plan.strategy == "randomized"
              and res.plan.backend == "single", f"{name}: plan")
        passes = 1 + cfg.power_iters
        check(counts["sketch_panel"] == passes,
              f"{name}: sketch_panel launched {counts['sketch_panel']} "
              f"times, want {passes} (one per sketch pass, D is a grid axis)")
        check(res.u.shape == (coo.shape[0], 16)
              and res.v.shape == (coo.shape[1], 16), f"{name}: U/V shape")
        ortho = float((res.u.T @ res.u
                       - torch.eye(16, device=DEVICE)).abs().max())
        check(ortho <= 1e-4, f"{name}: |U^T U - I|_max {ortho}")
        if tight:
            fields = check_topk(name, res.s, s_ref, 16)
        else:
            s = res.s.double().cpu().numpy()
            rel = (s_ref[:16] - s) / s_ref[:16]
            check(np.isfinite(s).all() and rel.min() >= -1e-4
                  and rel.max() <= 0.10,
                  f"{name}: top-16 S outside [0.9, 1 + 1e-4] x reference "
                  f"(relative shortfall {rel.min()} .. {rel.max()})")
            fields = dict(s0=float(s[0]), s_k=float(s[-1]),
                          max_abs_dS=float(np.abs(s - s_ref[:16]).max()),
                          max_rel_dS=float(np.abs(rel).max()))
        res2, _ = timed_svd(coo, cfg)
        emit("solve_randomized", oversample=oversample,
             power_iters=power_iters,
             held_at=("rtol 1e-3, atol 1e-3*S[0]" if tight
                      else "0.9..1+1e-4 of the reference"),
             warm_wall_time_s=res2.diagnostics.wall_time_s, ortho_err=ortho,
             stage_ms=stage_ms(coo, cfg),
             **diag_fields(res, counts), **fields)


def host_repaired_csr(rep):
    """The repaired matrix as a scipy CSR (M, D*W), built on the host from
    the ELL arrays and the repair side-band alone."""
    import scipy.sparse as sp

    ell = rep.ell
    ids = ell.col_ids.cpu().numpy()
    rows = ell.col_rows.cpu().numpy()
    vals = ell.col_vals.cpu().numpy()
    rc = rep.repair_cols.cpu().numpy()
    rm = rep.repair_mask.cpu().numpy()
    d, c, k = rows.shape
    gcol = (np.arange(d)[:, None] * ell.width + ids)[:, :, None]
    gcol = np.broadcast_to(gcol, (d, c, k))
    keep = vals != 0
    r_d, r_r = np.nonzero(rm)
    all_rows = np.concatenate([rows[keep], r_r])
    all_cols = np.concatenate([gcol[keep], r_d * ell.width + rc[rm]])
    all_vals = np.concatenate([vals[keep], np.ones(r_r.size, np.float32)])
    return sp.csr_matrix((all_vals.astype(np.float64),
                          (all_rows, all_cols)),
                         shape=(ell.m, d * ell.width))


def scaled_coo(m, n, density, seed):
    coo = sparse.random_bipartite(m, n, density, seed=seed, power_law=True)
    return sparse.ensure_full_row_rank(coo, seed=seed)


def phase_solve_scaled(state) -> None:
    # (a) exact gram at M = 2048.
    m, n = SCALED_EXACT
    t0 = time.perf_counter()
    coo = scaled_coo(m, n, 5e-4, seed=11)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    ell = sparse.block_ell_from_coo(coo, NUM_BLOCKS, device=DEVICE)
    torch.cuda.synchronize()
    t_ell = time.perf_counter() - t0
    cfg = api.SolveConfig(num_blocks=NUM_BLOCKS, merge_mode="gram",
                          use_kernel=True)
    res, counts = timed_svd(coo, cfg)
    name = "solve_scaled[a]"
    keep_counts(state, name, counts)
    check(res.plan.backend == "single" and res.plan.strategy == "exact_gram",
          f"{name}: plan")
    check(counts["sparse_gram"] >= 1, f"{name}: sparse_gram was not launched")
    repaired = ranky.split_and_repair(ell, NUM_BLOCKS, cfg.method,
                                      cfg.resolved_key())
    fields = check_exact_result(name, res, repaired, NUM_BLOCKS, recon=False)
    del repaired
    res2, _ = timed_svd(ell, cfg)
    # The kernel at this shape, against its plain version.
    want = sg_mod.sparse_gram_ref(ell.col_rows, ell.col_vals, m)
    got = sg_mod.sparse_gram(ell.col_rows, ell.col_vals, m)
    torch.cuda.synchronize()
    k_err = max_err(got, want)
    check(k_err == 0.0, f"{name}: sparse_gram differs from plain by {k_err}")
    del want, got
    b_ms, b_by = sparse_gram_bound(ell.col_rows, ell.col_vals, m)
    emit("solve_scaled", case="a", m=m, n=n, nnz=coo.nnz,
         ell_capacity=list(ell.capacity), host_generate_s=t_gen,
         host_block_ell_from_coo_s=t_ell,
         warm_wall_time_s_ell_input=res2.diagnostics.wall_time_s,
         sparse_gram_ms=time_ms(lambda: sg_mod.sparse_gram(
             ell.col_rows, ell.col_vals, m), iters=5),
         sparse_gram_plain_ms=time_ms(lambda: sg_mod.sparse_gram_ref(
             ell.col_rows, ell.col_vals, m), iters=3, warmup=1),
         sparse_gram_bound_ms=b_ms, sparse_gram_bound_by=b_by,
         sparse_gram_max_abs_err=k_err, stage_ms=stage_ms(ell, cfg),
         **diag_fields(res, counts), **fields)
    del ell, res, res2
    torch.cuda.empty_cache()

    # (b) the tall-row case: the planner must choose the sketch.
    from scipy.sparse.linalg import svds

    m, n = SCALED_TALL
    t0 = time.perf_counter()
    coo = scaled_coo(m, n, 5e-4, seed=12)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    ell = sparse.block_ell_from_coo(coo, NUM_BLOCKS, device=DEVICE)
    torch.cuda.synchronize()
    t_ell = time.perf_counter() - t0
    cfg = api.SolveConfig(method="random", rank=16, oversample=48,
                          power_iters=4, num_blocks=NUM_BLOCKS)
    res, counts = timed_svd(coo, cfg)
    name = "solve_scaled[b]"
    keep_counts(state, name, counts)
    check(cfg.backend == "auto" and res.plan.backend == "single"
          and res.plan.strategy == "randomized", f"{name}: plan "
          f"{res.plan.backend}/{res.plan.strategy}")
    check(counts["sketch_panel"] == 1 + cfg.power_iters,
          f"{name}: sketch_panel launches {counts['sketch_panel']}")
    repaired = ranky.split_and_repair(ell, NUM_BLOCKS, cfg.method,
                                      cfg.resolved_key())
    t0 = time.perf_counter()
    s_ref = np.sort(svds(host_repaired_csr(repaired), k=16,
                         return_singular_vectors=False))[::-1]
    t_ref = time.perf_counter() - t0
    fields = check_topk(name, res.s, s_ref.copy(), 16)
    res2, _ = timed_svd(ell, cfg)
    # The kernel at this shape, against its plain version.
    omega = torch.randn((64, m), device=DEVICE,
                        generator=torch.Generator(DEVICE).manual_seed(3))
    want = sp_mod.sketch_panel_ref(omega, ell.col_rows, ell.col_vals)
    got = sp_mod.sketch_panel(omega, ell.col_rows, ell.col_vals)
    torch.cuda.synchronize()
    k_err = max_err(got, want)
    k_lim = 1e-5 * float(want.abs().max())
    check(k_err <= k_lim, f"{name}: sketch_panel err {k_err} > {k_lim}")
    del want, got
    b_ms, b_by = sketch_panel_bound(omega, ell.col_rows, ell.col_vals)
    emit("solve_scaled", case="b", m=m, n=n, nnz=coo.nnz,
         ell_capacity=list(ell.capacity), host_generate_s=t_gen,
         host_block_ell_from_coo_s=t_ell, host_scipy_svds_s=t_ref,
         warm_wall_time_s_ell_input=res2.diagnostics.wall_time_s,
         sketch_panel_ms=time_ms(lambda: sp_mod.sketch_panel(
             omega, ell.col_rows, ell.col_vals), iters=5),
         sketch_panel_plain_ms=time_ms(lambda: sp_mod.sketch_panel_ref(
             omega, ell.col_rows, ell.col_vals), iters=3, warmup=1),
         sketch_panel_bound_ms=b_ms, sketch_panel_bound_by=b_by,
         sketch_panel_max_abs_err=k_err, sketch_panel_err_limit=k_lim,
         stage_ms=stage_ms(ell, cfg),
         **diag_fields(res, counts), **fields)


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script only "
              "runs on the GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 must be off for matrix products")

    kernel_build.load()
    emit("build", nvcc_seconds=kernel_build.build_seconds,
         sources=[str(s.name) for s in kernel_build.sources()],
         flags=" ".join(kernel_build.NVCC_FLAGS))

    state = {}
    cfg = RankyPaperConfig()
    t0 = time.perf_counter()
    state["coo"] = bipartite.paper_coo(cfg)
    state["ell"] = sparse.block_ell_from_coo(state["coo"], NUM_BLOCKS,
                                             device=DEVICE)
    emit("data", shape=list(state["coo"].shape), nnz=state["coo"].nnz,
         num_blocks=NUM_BLOCKS, ell_capacity=list(state["ell"].capacity),
         host_seconds=time.perf_counter() - t0)

    for phase in (phase_kernels, phase_solve_sparse_exact,
                  phase_solve_dense_exact, phase_solve_randomized,
                  phase_solve_scaled):
        phase(state)
        torch.cuda.synchronize()

    by_solve = state["launches_by_solve"]
    kernels = []
    for name, info in KERNEL_INFO.items():
        launches = by_solve[info["launches_in"]][name]
        check(launches >= 1,
              f"{name} was never launched by {info['launches_in']}")
        kernels.append(dict(
            name=name, **info, launches=launches,
            launches_by_solve={solve: counts[name]
                               for solve, counts in by_solve.items()},
            **state["kernel_main"][name]))
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
