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
   block whose slots are all padding; for ``topk_score``: f32, int8 with
   kvquant scales, a valid width with an index offset, a ragged last tile and
   three-way ties, at the paper universe and at 256 x 1,048,576, compared
   with ``torch.equal``; ``sparse_gram`` against a float64 sum -- exactly
   on 0/1 data -- and the same bits over 10 calls, on the weighted paper
   matrix, a ragged case with duplicates and an all-padding block, a row
   longer than one sorted piece, K = 36, M = 33 and M above the row chunk;
   ``sketch_panel`` at L = 24, 41 and 64, K = 36 and 1,300, Omega in
   either contiguous layout and in neither, the same bits over 10 calls
   and one device kernel a call where Omega is contiguous).  Times kernel,
   plain version and, where one PyTorch
   call computes the same function, that call, and works out the least time
   the card could take (``bound_ms``) and the rates the kernel's time stands
   for (``achieved_tflops``, ``achieved_gb_s``), and counts the device
   kernels one call of each wrapper launches (``device_kernels``, from
   ``torch.profiler``; ``launches`` counts wrapper calls); ``topk_score``'s two passes
   are also timed apart (``pass_ms``, ``torch.profiler``),
   ``flash_attention`` is timed beside SDPA at the long prompt (2, 32, 3000,
   80), at head dim 128 and at gemma2-9b's widths (8, 16/8, 1024, 256, with
   window, softcap, ragged, right-aligned and keyless-row variants at head
   dim 256) too, and ``ssd_scan`` at the long prompt x (2, 3000, 80, 64) and
   at mamba2-1.3b's widths x (8, 1024, 64, 64), N 128 beside the prefill
   shape, with variants L = 1 and L = 11 (a chunk shorter than one 16-row
   MMA tile), G = 2, G = H = 8, ragged L = 1000, P = N = 16, P = N = 128
   and a decaying state, in bf16 and float32.  ``blockgram`` is held against a
   float64 sum at the dense solve's shape on the paper matrix (exactly), on
   gaussian float32 (twice: the same bits), bf16, the weighted paper matrix
   and the values its bf16 split serves worst, and on short, ragged and
   mixed rows, and timed beside ``torch.bmm``.
4. ``solve_sparse_exact`` / 5. ``solve_dense_exact`` / 6. ``solve_randomized``
   / 7. ``solve_scaled``: ``repro_torch.core.api.svd`` on the paper's
   539 x 170,897 matrix (COO and dense input, exact and rank-16) and on two
   larger matrices, each result held against a float64 (or scipy) reference
   of the repaired matrix; ``sparse_gram`` at (a)'s ELL (0/1 and with
   seeded weights) and ``sketch_panel`` at (b)'s (L = 64, K = 36, Omega in
   both layouts) are checked and timed there, under the ``kernels`` line's
   ``timed_variants``.  Every kernel's launch counter is set to 0 just
   before each solve and read just after it; the counts are kept solve by
   solve and never added up across solves.  Stage times come from the
   solver's own stage timers (``repro_torch.core.stages``) around further
   warm solves.
8. ``stream_exact``: ``svd_init`` + ``svd_update`` of the paper matrix in 4
   row batches at full rank, held against float64 singular values.
9. ``stream_serve``: the user's configuration: the paper rows in batches of
   64 at rank 16 (held against the same stream on the CPU), served by
   ``serve_init`` / ``serve_topk`` in waves of 32 (f32 and int8; every wave
   equal to the plain version bit for bit), one cold-start wave through
   ``project_rows``, 200 waves with no ingest beside them, then waves
   answered while an ingest thread on its own CUDA stream folds in the
   remaining batches and commits them.
10. ``serve_scaled``: a 1,048,576-item catalogue at rank 64 built by two
   ingests, served in waves of 256 with k_top 100, f32 and int8.
   Phases 8-10 also hold ``sparse_gram`` against its plain version on
   repaired batches that their ingests factor.
10b. ``hierarchical``: the tree merge (``backend="hierarchical"``, D = 8,
   fanout 4) on the paper matrix exact from COO (one ``sparse_gram``) and
   dense input (one ``blockgram``), with right vectors, against float64;
   the same at rank 16 against the same solve on the CPU; rule R2
   (``sketch=True``, rank 16) on phase 7b's 32,768 x 262,144 matrix (one
   ``sketch_panel`` a pass over the whole block stack), never above the
   truth and against the CPU; the wide group panels' orthogonality under
   both cuSOLVER drivers.
10c. ``stream_window``: ``svd_stream`` (rule R6) on a 1,048,576-item
   catalogue at rank 64 (48 ELL batches of 1,000-1,024 rows after the
   rank-growth batch) and on the paper's rows in dense batches of 50-64
   rows at rank 16: ``window`` auto against ``window=1`` (``torch.equal``)
   and against an ``svd_update`` loop (1e-3 * S[0]); ms per batch in each
   mode, the host syncs of a window and of its batches one by one (torch's
   sync debug mode), one window's measured peak against R6's closed form
   (must not exceed it), and the kernels on a padded bucket against the
   batch as it is (the same bits; times side by side).
11. ``merge_driver_ab``: the streams of phases 8 and 9 on three seeds under
   each cuSOLVER driver of the merge SVD, orthogonality and time.
12. ``lm_serve``: LM serving of zamba2-2.7b at full width (54 Mamba-2
   layers, d_model 2560, one shared attention block applied 9 times),
   weights drawn from a seeded generator on the card: (a) ``prefill_forward``
   of 8 prompts of 1,024 tokens in bf16 (``flash_attention`` launched 9
   times and ``ssd_scan`` 54 times, checked exactly), then 32 greedy
   ``decode_step``s, and a long prefill of 2 prompts of 3,000 tokens
   (the same launch counts: every length goes to the kernels); (b) in a
   float32 copy of the config, the kernels held inside the model:
   ``prefill_forward`` of 2 x 256 tokens against ``engine.prefill_cache``
   (decode steps, no kernel) of the same prompt, last logits and every
   cache entry, and a control (the kernels fed bf16-rounded inputs) that
   must exceed the same limit; (c) ``engine.generate`` of 4 short requests
   x 32 tokens, greedy and sampled from a seeded generator.
   Phase 3 holds ``flash_attention`` and ``ssd_scan`` against their plain
   versions at this path's shapes, in bf16 and float32, with variants.
13. ``stage_summary`` (one ingest, one serve wave), one line
   ``{"kernels": [...]}`` with every kernel's numbers, then the card as
   ``nvidia-smi`` names it, then the last line ``{"ok": true, "device":
   {...}}``.

It takes no arguments, runs every phase, exits non-zero at the first phase
that fails, and right away when no CUDA device is present: nothing here runs
on the CPU instead.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.ranky_paper import RankyPaperConfig  # noqa: E402
from repro_torch.core import api, hierarchy, ranky, sparse, stages  # noqa: E402
from repro_torch.data import bipartite  # noqa: E402
from repro_torch.kernels import blockgram as bg_mod  # noqa: E402
from repro_torch.kernels import build as kernel_build  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import ops as kernel_ops  # noqa: E402
from repro_torch.kernels import sketch_panel as sp_mod  # noqa: E402
from repro_torch.kernels import sparse_gram as sg_mod  # noqa: E402
from repro_torch.kernels import ssd_scan as ss_mod  # noqa: E402
from repro_torch.kernels import topk_score as tk_mod  # noqa: E402
from repro_torch.models import schema, transformer  # noqa: E402
from repro_torch.serve import engine, kvquant, ranker  # noqa: E402
from repro_torch.stream import state as stream_state  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory rate,
# float32 rate outside the tensor cores and the dense bf16 tensor-core rate.
# bound_ms is stated against them, by the type of the kernel's inputs.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

NUM_BLOCKS = 8
DEVICE = "cuda"
# (M, N) of the two matrices of phase 7; density 5e-4 like the paper's.
SCALED_EXACT = (2048, 1_048_576)
SCALED_TALL = (32_768, 262_144)
# Serving shapes: the paper universe answered in waves of 32 queries at the
# user stream's rank 16, and the scaled catalogue of phase 10.
TOPK_PAPER = dict(b=32, k=16, k_top=10)
STREAM_BATCH_ROWS = 64
SCALED_SERVE = dict(n=1_048_576, rows=1024, batches=2, density=1e-3,
                    rank=64, b=256, k_top=100)
# LM serving (phase 12): zamba2-2.7b at full width; the prefill of the main
# path, a long prefill (s * s above the 2048**2 at which the reference
# leaves its kernel), the float32 check of the kernels inside the model
# (10x its readings, 1.7e-5 - 3.1e-5 of max), the requests.
LM_ARCH = "zamba2-2.7b"
# The configs whose kernel widths phase 3 also holds: mamba2-1.3b's SSM
# state 128 and gemma2-9b's head dim 256 (the models are not served yet).
SSM_ARCH = "mamba2-1.3b"
WIDE_ATTN_ARCH = "gemma2-9b"
LM_PREFILL = dict(batch=8, seq=1024, decode=32)
LM_LONG = dict(batch=2, seq=3000)
LM_CHECK = dict(batch=2, seq=256, rel=3e-4)
LM_REQUESTS = dict(requests=4, tokens=32, temperature=0.8)
KERNEL_MODULES = {"sparse_gram": sg_mod, "blockgram": bg_mod,
                  "sketch_panel": sp_mod, "topk_score": tk_mod,
                  "flash_attention": fa_mod, "ssd_scan": ss_mod}
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
    "topk_score": dict(route="cuda",
                       source="src/repro_torch/csrc/topk_score.cu",
                       replaces="src/repro/kernels/topk_score.py:125",
                       launches_in="serve_topk[f32]"),
    "flash_attention": dict(route="cuda",
                            source="src/repro_torch/csrc/flash_attention.cu",
                            replaces="src/repro/kernels/flash_attention.py:125",
                            launches_in="lm_serve[prefill]"),
    "ssd_scan": dict(route="cuda",
                     source="src/repro_torch/csrc/ssd_scan.cu",
                     replaces="src/repro/kernels/ssd_scan.py:112",
                     launches_in="lm_serve[prefill]"),
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


def bound(bytes_moved: float, flops: float, peak: float = F32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of the inputs' type (float32 unless
    ``peak`` says otherwise)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sparse_gram_bound(rows, vals, m):
    d = rows.shape[0]
    per_col = (vals != 0).sum(dim=-1).double()
    pairs = float((per_col * per_col).sum())       # what THIS data needs
    nbytes = rows.numel() * 4 + vals.numel() * 4 + d * m * m * 4
    return bound(nbytes, 2.0 * pairs)


def sparse_gram_f64(rows, vals, m):
    """The yardstick of sparse_gram's weighted checks: each block's
    stored-column panel in float64, its gram summed in float64 and rounded
    once (the plain version sums in float32)."""
    out = torch.empty((rows.shape[0], m, m), dtype=torch.float32,
                      device=rows.device)
    for i in range(rows.shape[0]):
        p = torch.zeros((rows.shape[1], m), dtype=torch.float64,
                        device=rows.device)
        p.scatter_add_(1, rows[i].long(), vals[i].double())
        out[i] = (p.T @ p).float()
        del p
    return out


def reweighted(vals, seed):
    """The same slots with seeded weights in (0.5, 2) on the non-zero ones
    (padding stays 0)."""
    gen = torch.Generator(vals.device).manual_seed(seed)
    w = torch.rand(vals.shape, generator=gen, device=vals.device) * 1.5 + 0.5
    return torch.where(vals != 0, w, torch.zeros_like(w))


def check_bit_stable(name, case, first, call, calls: int = 10) -> bool:
    """``calls`` further calls give the same bits as ``first``
    (``torch.equal``); a difference fails the run."""
    for i in range(calls):
        again = call()
        torch.cuda.synchronize()
        check(torch.equal(first, again),
              f"{name}[{case}]: call {i + 2} differs from the first by "
              f"{max_err(first, again)}")
    return True


def cuda_events(fn, iters: int):
    """[(name, count, self device microseconds)] of the device-side events
    of ``iters`` warm calls of ``fn`` (``torch.profiler``).  The profiler can
    drop a call's events; the session is run again (three times at most)
    until every event shows once per call or a whole multiple of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [(ev.key, ev.count,
                   getattr(ev, "self_device_time_total",
                           getattr(ev, "self_cuda_time_total", 0.0)))
                  for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA]
        if events and all(count % iters == 0 for _, count, _ in events):
            break
    return events


def device_kernels_per_call(fn, iters: int = 4):
    """Device kernels (memsets and copies included) that one call of
    ``fn`` launches (``cuda_events`` over ``iters`` warm calls); None where
    the profiler saw no device activity, a fraction where it kept dropping
    events."""
    n = sum(count for _, count, _ in cuda_events(fn, iters))
    return n / iters if n else None


def check_device_kernels(name, case, got, want) -> None:
    """A whole count of device kernels a call must be ``want``; a profiler
    that saw nothing or dropped events (None, a fraction) checks nothing."""
    if got is not None and float(got).is_integer():
        check(got == want, f"{name}[{case}]: {got} device kernels a call, "
              f"want {want}")


def device_ms(fn):
    """Device time of one warm call of ``fn``: its kernels' times summed
    (``device_ms_by_kernel``), without the host's launch latency that an
    event pair around a single call also holds; None where the profiler saw
    no device time."""
    return sum(device_ms_by_kernel(fn).values()) or None


def sparse_gram_case(cases, case, rows, vals, m, *, exact=None,
                     calls: int = 10) -> dict:
    """sparse_gram held to a float64 sum at 1e-5 of max|G| (exactly where
    every value is 0 or 1: ``exact`` None decides from the data) and to its
    plain version at the same limit, and ``calls`` further calls giving the
    same bits.  Returns the case's numbers (``symmetric``: G equal to G^T
    bit for bit; ``max_asymmetry``: max |G - G^T|)."""
    if exact is None:
        exact = bool(((vals == 0) | (vals == 1)).all())
    got = sg_mod.sparse_gram(rows, vals, m)
    want = sparse_gram_f64(rows, vals, m)
    rel = 0.0 if exact else 1e-5
    err = compare("sparse_gram", got, want, rel, cases,
                  f"{case}, against a float64 sum")
    plain = sg_mod.sparse_gram_ref(rows, vals, m)
    plain_err = max_err(plain, want)
    compare("sparse_gram", got, plain, rel, cases,
            f"{case}, against the plain version")
    del plain
    check_bit_stable("sparse_gram", case, got,
                     lambda: sg_mod.sparse_gram(rows, vals, m), calls)
    fields = dict(case=case, max_abs_err=err, plain_max_abs_err=plain_err,
                  limit=rel * float(want.abs().max()), bit_stable_calls=calls,
                  symmetric=bool(torch.equal(got, got.mT)),
                  max_asymmetry=max_err(got, got.mT))
    del got, want
    return fields


def sketch_panel_case(cases, case, omega, rows, vals, *,
                      calls: int = 10) -> dict:
    """sketch_panel held to its plain version at 1e-5 of max|plain|
    (``equal`` says whether the bits agree), ``calls`` further calls giving
    the same bits, and the device kernels of one call."""
    got = sp_mod.sketch_panel(omega, rows, vals)
    want = sp_mod.sketch_panel_ref(omega, rows, vals)
    err = compare("sketch_panel", got, want, 1e-5, cases, case)
    equal = bool(torch.equal(got, want))
    check_bit_stable("sketch_panel", case, got,
                     lambda: sp_mod.sketch_panel(omega, rows, vals), calls)
    l, m = omega.shape[-2:]
    strides = omega.stride()[-2:]
    fields = dict(case=case, max_abs_err=err, equal_to_plain=equal,
                  limit=1e-5 * float(want.abs().max()),
                  omega_strides=list(omega.stride()),
                  omega_route=sp_mod.omega_route(l, m, strides),
                  bit_stable_calls=calls,
                  device_kernels=device_kernels_per_call(
                      lambda: sp_mod.sketch_panel(omega, rows, vals)))
    check_device_kernels("sketch_panel", case, fields["device_kernels"],
                         sp_mod.device_kernels(l, m, strides))
    del got, want
    return fields


def ell_csr(rows, vals, m):
    """The block-stacked (D*C, M) CSR of the stored columns (the cuSPARSE
    yardstick's operand), built from the ELL slots."""
    import warnings

    d, c, k = rows.shape
    live = vals.reshape(d * c, k) != 0
    counts = live.sum(dim=1)
    crow = torch.zeros(d * c + 1, dtype=torch.int64, device=rows.device)
    crow[1:] = counts.cumsum(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "beta" notices
        return torch.sparse_csr_tensor(
            crow, rows.reshape(d * c, k)[live].long(),
            vals.reshape(d * c, k)[live], size=(d * c, m),
            check_invariants=False)


def sketch_timed(cases, case, omega, rows, vals, *, iters=10) -> dict:
    """sketch_panel_case, then the kernel's time beside its bound and the
    library yardstick: one ``torch.sparse.mm`` (cuSPARSE) of the
    block-stacked (D*C, M) CSR of the stored columns by Omega^T (the CSR
    built outside the timed window; the port never calls it)."""
    fields = sketch_panel_case(cases, case, omega, rows, vals)
    b_ms, b_by = sketch_panel_bound(omega, rows, vals)
    csr = ell_csr(rows, vals, omega.shape[1])
    om_t = omega.T
    fields.update(
        ms=time_ms(lambda: sp_mod.sketch_panel(omega, rows, vals),
                   iters=iters),
        device_ms=device_ms(lambda: sp_mod.sketch_panel(omega, rows, vals)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.sparse.mm(csr, om_t), iters=iters),
        library="torch.sparse.mm((D*C, M) CSR, Omega^T), CSR built "
                "outside the timed window")
    del csr
    return fields


# bf16 products per product of float32 values that blockgram's kernel
# makes: hi.hi + hi.mid + mid.hi + mid.mid + hi.lo + lo.hi, the least set
# that holds 1e-5 of max|G| on every input
# (tests/test_torch_kernel_numerics.py).
BLOCKGRAM_F32_PRODUCTS = 6
# Float32 values that blockgram's split into bf16 terms serves worst (the
# same as the CPU tests' WORST): products of them lose 3.0e-5 (two terms),
# 1.5e-5 (no mid.mid) and 1.5e-5 (no lo) of x^2 when those products are
# left out.
BLOCKGRAM_WORST = {"two terms": 1.0038985013961792,
                   "no mid.mid": 1.0039061307907104,
                   "no lo": 1.0020065307617188}


def gram_f64(a):
    """The yardstick of blockgram's checks: the gram summed in float64 and
    rounded once.  The plain version sums in float32, as the reference
    does, and on an H100 that errs 9.4e-6 to 1.55e-5 of max|G| at W =
    21363 (PERF.md), as much as the kernel is held to."""
    a64 = a.to(torch.float64)
    return (a64 @ a64.mT).to(torch.float32)


def products(a) -> int:
    """bf16 products per product of ``a``'s values that the kernel makes
    on this input: 1 when every value is exact in bf16 (bf16 input, 0/1
    data; the kernel skips mid and lo), 4 when every value is exact in two
    bf16 terms (it skips lo), else ``BLOCKGRAM_F32_PRODUCTS``."""
    if a.dtype != torch.float32:
        return 1
    rest = a - a.to(torch.bfloat16).float()
    if not bool(rest.any()):
        return 1
    if not bool((rest - rest.to(torch.bfloat16).float()).any()):
        return 4
    return BLOCKGRAM_F32_PRODUCTS


def blockgram_bound(a):
    """``bg_mod.work``: A read once, G written once, and a multiply and an
    add for each entry on or above the diagonal per column of A, at the
    fastest rate the card offers to a float32-accurate product: the bf16
    tensor-core rate over the t bf16 products this input needs
    (``products``), or the float32 rate if that is higher."""
    nbytes, flops = bg_mod.work(*a.shape, a.element_size())
    return bound(nbytes, flops, max(F32_FLOPS, BF16_FLOPS / products(a)))


def blockgram_worst(shape, x, seed):
    """Rows of +-x scaled by powers of two, so that every product of the
    split errs the same way (as the CPU tests' ``_bg_worst``)."""
    gen = torch.Generator(DEVICE).manual_seed(seed)
    sign = torch.randint(0, 2, shape, generator=gen, device=DEVICE) * 2 - 1
    scale = torch.exp2(torch.randint(-3, 4, shape, generator=gen,
                                     device=DEVICE).float())
    return (x * sign * scale).float()


def bmm_ms(a) -> float:
    """The yardstick only (the port never calls bmm for this product): one
    ``torch.bmm`` of the float32 blocks by their transposes."""
    a32 = a.float()
    return time_ms(lambda: torch.bmm(a32, a32.mT), iters=5, warmup=1)


def blockgram_variants(cases, shape, *, wcoo) -> list:
    """At the solver's shape: gaussian float32 (twice: the same bits), the
    weighted paper matrix made dense, bf16 input and rows of the values the
    split serves worst, each within 1e-5 of max|G| (``gram_f64``) and
    exactly symmetric; the gaussian and bf16 cases timed beside their bound
    and ``torch.bmm``."""
    d, m, w = shape
    out = []
    gauss = torch.randn(shape, generator=torch.Generator(DEVICE)
                        .manual_seed(31), device=DEVICE)
    for tag, a in (("gaussian f32", gauss),
                   ("gaussian rounded to bf16, bf16 input",
                    gauss.to(torch.bfloat16))):
        got = bg_mod.blockgram(a)
        want = gram_f64(a)
        err = compare("blockgram", got, want, 1e-5, cases,
                      f"{tag} {tuple(shape)}")
        plain_err = max_err(bg_mod.blockgram_ref(a), want)
        check(torch.equal(got, got.mT),
              f"blockgram[{tag}]: the gram is not exactly symmetric")
        if a.dtype == torch.float32:
            check(torch.equal(got, bg_mod.blockgram(a)),
                  f"blockgram[{tag}]: two calls differ")
        b_ms, b_by = blockgram_bound(a)
        ms = time_ms(lambda: bg_mod.blockgram(a), iters=5, warmup=1)
        out.append(dict(case=f"{tag} {tuple(shape)}", max_abs_err=err,
                        plain_max_abs_err=plain_err,
                        limit=1e-5 * float(want.abs().max()), ms=ms,
                        bound_ms=b_ms, bound_by=b_by,
                        products=products(a),
                        achieved_tflops=bg_mod.work(
                            *shape, a.element_size())[1] / ms / 1e9,
                        library_ms=bmm_ms(a)))
        del got, want
    del gauss
    dense = torch.from_numpy(sparse.pad_to_block_multiple(
        wcoo.todense(), NUM_BLOCKS)).to(DEVICE)
    wb = dense.reshape(m, NUM_BLOCKS, -1).permute(1, 0, 2).contiguous()
    del dense
    got = bg_mod.blockgram(wb)
    compare("blockgram", got, gram_f64(wb), 1e-5, cases,
            f"paper weighted, dense {tuple(wb.shape)}")
    check(torch.equal(got, got.mT), "blockgram[weighted]: not symmetric")
    del wb, got
    worst = blockgram_worst(shape, BLOCKGRAM_WORST["two terms"], 33)
    compare("blockgram", bg_mod.blockgram(worst), gram_f64(worst), 1e-5,
            cases, f"values the split serves worst (two terms) "
            f"{tuple(shape)}")
    return out


def sketch_panel_bound(omega, rows, vals):
    l = omega.shape[-2]
    d, c, _ = rows.shape
    nnz = float((vals != 0).sum())
    nbytes = (omega.numel() * 4 + rows.numel() * 4 + vals.numel() * 4
              + d * l * c * 4)
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
    """Hold ``got`` to ``want`` (same shape and dtype) at
    ``rel_limit * max|want|`` (0 = exact)."""
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}[{case}]: shape/dtype {tuple(got.shape)} {got.dtype}, "
          f"want {tuple(want.shape)} {want.dtype}")
    check(torch.isfinite(got).all(), f"{name}[{case}]: non-finite output")
    err = max_err(got, want)
    limit = rel_limit * float(want.abs().max()) if want.numel() else 0.0
    results.append(dict(kernel=name, case=case, max_abs_err=err, limit=limit))
    check(err <= limit, f"{name}[{case}]: max abs err {err} > limit {limit}")
    return err


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 values at |x| (8 significant bits), 0 at 0."""
    _, e = torch.frexp(x.float().abs())
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)
    return torch.where(x == 0, 0.0, ulp)


def compare_bf16(name, got, want, f32_rel, results, case):
    """Hold a bfloat16 ``got`` to ``want`` element by element at one bf16
    ulp of |want| plus ``f32_rel * max|want|``: both sides sum in float32
    (in another order, which the second term covers) and round to bf16
    once, which moves a value by at most one ulp."""
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype
          == torch.bfloat16,
          f"{name}[{case}]: shape/dtype {tuple(got.shape)} {got.dtype}, "
          f"want {tuple(want.shape)} bfloat16")
    check(torch.isfinite(got).all(), f"{name}[{case}]: non-finite output")
    diff = (got.float() - want.float()).abs()
    atol = f32_rel * float(want.abs().max())
    tol = bf16_ulp(want) + atol
    err = float(diff.max())
    worst = float((diff / tol).max())
    results.append(dict(kernel=name, case=case, max_abs_err=err,
                        limit="1 bf16 ulp of |plain| + atol", atol=atol,
                        worst_err_over_limit=worst))
    check(worst <= 1.0, f"{name}[{case}]: an element errs {worst} times its "
          f"limit (1 bf16 ulp of |plain| + {atol}); max abs err {err}")
    return err


def synthetic_ell(rng, d, c, k, m, *, weighted, empty_block=None,
                  heavy_row=None):
    """Random (D, C, K) ELL arrays with padding slots, duplicate rows inside
    a column, optionally one block whose slots are all padding, and
    optionally ``heavy_row`` = (row, columns): that row in the first
    ``columns`` columns of every block."""
    rows = rng.integers(0, m, size=(d, c, k)).astype(np.int32)
    vals = (rng.uniform(0.5, 2.0, size=(d, c, k)) if weighted
            else np.ones((d, c, k))).astype(np.float32)
    vals *= rng.random((d, c, k)) < 0.6            # padding slots
    if heavy_row is not None:
        r, cols = heavy_row
        rows[:, :cols, 0] = r
        vals[:, :cols, 0] = rng.uniform(0.5, 2.0, (d, cols)) if weighted \
            else 1.0
    rows[:, ::3, -1] = rows[:, ::3, 0]             # duplicates in a column
    if empty_block is not None:
        vals[empty_block] = 0.0
    rows[vals == 0] = 0
    return (torch.from_numpy(rows).to(DEVICE), torch.from_numpy(vals).to(DEVICE))


def sparse_gram_rows(cases, main, ell, well, ragged, rng) -> None:
    """``sparse_gram`` at the paper's shape (``ell``, 0/1; ``well``, the
    same matrix weighted) and on synthetic cases (``ragged``: D=3 C=37 K=5
    M=67 with duplicates and an all-padding block 1)."""
    rows, vals, m = ell.col_rows, ell.col_vals, ell.m
    # The paper's 0/1 ELL: exact, the same bits over 10 calls; then the
    # weighted paper matrix, a ragged case with duplicates and an
    # all-padding block, a row longer than one sorted piece
    # (sg_mod.SEG_CAP) spread over all warps, K = 36 > 32, M = 33 (not a
    # multiple of 32) and M above the shared-memory row chunk
    # (sg_mod.ROW_CHUNK), each against a float64 sum at 1e-5 of max|G|.
    sg_cases = [sparse_gram_case(cases, "paper 0/1 (exact)", rows, vals, m)]
    b_ms, b_by = sparse_gram_bound(rows, vals, m)
    main["sparse_gram"] = dict(
        shape=f"rows/vals {tuple(rows.shape)} -> {(rows.shape[0], m, m)}",
        max_abs_err=sg_cases[0]["max_abs_err"],
        ms=time_ms(lambda: sg_mod.sparse_gram(rows, vals, m)),
        device_ms=device_ms(lambda: sg_mod.sparse_gram(rows, vals, m)),
        plain_ms=time_ms(lambda: sg_mod.sparse_gram_ref(rows, vals, m)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        device_kernels=device_kernels_per_call(
            lambda: sg_mod.sparse_gram(rows, vals, m)),
        timed_variants=[])
    check_device_kernels("sparse_gram", "paper 0/1",
                         main["sparse_gram"]["device_kernels"],
                         sg_mod.DEVICE_KERNELS)

    sg_cases.append(sparse_gram_case(cases, "paper shape, weighted",
                                     well.col_rows, well.col_vals, m))
    r2, v2 = ragged
    sg_cases.append(sparse_gram_case(
        cases, "ragged D=3 C=37 K=5 M=67, duplicates, block 1 all padding",
        r2, v2, 67))
    check(float(sg_mod.sparse_gram(r2, v2, 67)[1].abs().max()) == 0.0,
          "sparse_gram: an all-padding block must give a zero gram")
    heavy = sg_mod.SEG_CAP * 2 + 400
    rh, vh = synthetic_ell(rng, 2, heavy + 600, 3, 40, weighted=True,
                           heavy_row=(5, heavy))
    sg_cases.append(sparse_gram_case(
        cases, f"a row in {heavy} columns (pieces of {sg_mod.SEG_CAP}, "
        f"{sg_mod.WARPS} warps), D=2 K=3 M=40", rh, vh, 40))
    for tag, (d_, c_, k_, m_, kw) in {
            "K=36 > 32, M=100": (2, 300, 36, 100, {}),
            "M=33, K=1": (2, 64, 1, 33, {}),
            f"M=2500 > the row chunk {sg_mod.ROW_CHUNK}, a row in 2100 "
            f"columns": (1, 3000, 2, 2500, dict(heavy_row=(7, 2100))),
    }.items():
        rx, vx = synthetic_ell(rng, d_, c_, k_, m_, weighted=True, **kw)
        sg_cases.append(sparse_gram_case(cases, tag, rx, vx, m_))
    rx, vx = synthetic_ell(rng, 2, 300, 36, 100, weighted=False)
    sg_cases.append(sparse_gram_case(cases, "K=36 > 32, M=100, 0/1 (exact)",
                                     rx, vx, 100))
    main["sparse_gram"]["checked"] = sg_cases


def sketch_panel_rows(cases, main, ell, well, ragged, rng) -> None:
    """``sketch_panel`` on the paper's ELL (``ell``; ``well`` weighted) and
    on synthetic cases (``ragged`` as for ``sparse_gram_rows``)."""
    rows, vals, m = ell.col_rows, ell.col_vals, ell.m
    # Omega as draw_omega gives it ((L, M) contiguous) and as the transpose
    # of an (M, L)-contiguous tensor, at L = 24 (the paper's sketch), 41
    # and 64; weighted data; a ragged case with duplicates and an
    # all-padding block; K = 36 > 32 and K = 1300 (a column taken in
    # pieces) with Omega too large to stage, in both layouts and in
    # neither (the wrapper's copy).  Each within 1e-5 of max|plain| and the
    # same bits over 10 calls.
    omega = torch.from_numpy(rng.standard_normal((24, m))
                             .astype(np.float32)).to(DEVICE)
    main["sketch_panel"] = sketch_timed(cases, "paper ELL, omega (24, 539)",
                                        omega, rows, vals)
    main["sketch_panel"].update(
        shape=f"omega {tuple(omega.shape)}, rows/vals {tuple(rows.shape)} "
              f"-> {(rows.shape[0], 24, rows.shape[1])}",
        plain_ms=time_ms(lambda: sp_mod.sketch_panel_ref(omega, rows, vals)),
        timed_variants=[])
    sp_cases = [sketch_panel_case(
        cases, "paper ELL, omega (24, 539) as the transpose of (539, 24)",
        omega.T.contiguous().T, rows, vals)]
    sp_cases.append(sketch_panel_case(cases, "paper shape, weighted", omega,
                                      well.col_rows, well.col_vals))
    for l_ in (41, 64):
        om = torch.from_numpy(rng.standard_normal((l_, m))
                              .astype(np.float32)).to(DEVICE)
        sp_cases.append(sketch_panel_case(cases, f"paper ELL, L={l_}", om,
                                          rows, vals))
    r2, v2 = ragged
    om2 = torch.from_numpy(rng.standard_normal((41, 67))
                           .astype(np.float32)).to(DEVICE)
    sp_cases.append(sketch_panel_case(
        cases, "ragged L=41 M=67 C=37 K=5, duplicates, block 1 all padding",
        om2, r2, v2))
    check(float(sp_mod.sketch_panel(om2, r2, v2)[1].abs().max()) == 0.0,
          "sketch_panel: an all-padding block must give a zero panel")
    for k_, c_, l_ in ((36, 300, 64), (36, 300, 41), (1300, 40, 8)):
        m_ = 2000 if k_ == 36 else 5000
        rx, vx = synthetic_ell(rng, 2, c_, k_, m_, weighted=True)
        om = torch.randn((l_, m_), device=DEVICE)
        for layout, o in (("(L, M)", om), ("(M, L)", om.T.contiguous().T),
                          ("neither (every other column)",
                           torch.randn((l_, 2 * m_), device=DEVICE)[:, ::2])):
            sp_cases.append(sketch_panel_case(
                cases, f"K={k_} C={c_} M={m_} L={l_}, omega {layout}", o,
                rx, vx))
    # A (D, L, M) Omega stack, one Omega_d a block (the power passes of the
    # hierarchical tree's sketch leaves): as the batched QR's Q_d^T come
    # ((L, M) contiguous, transposed in the kernel), as (M, L)-contiguous
    # matrices and in neither layout; the paper's ELL and the ragged case.
    om3 = torch.from_numpy(rng.standard_normal((rows.shape[0], 24, m))
                           .astype(np.float32)).to(DEVICE)
    for layout, o in (("(L, M) each", om3), ("(M, L) each",
                                            om3.mT.contiguous().mT),
                      ("neither (every other column)",
                       torch.randn((rows.shape[0], 24, 2 * m),
                                   device=DEVICE)[:, :, ::2])):
        sp_cases.append(sketch_panel_case(
            cases, f"paper ELL, omega stack {tuple(om3.shape)} {layout}", o,
            rows, vals))
    om3r = torch.randn((r2.shape[0], 41, 67), device=DEVICE)
    sp_cases.append(sketch_panel_case(
        cases, "ragged L=41 M=67 C=37 K=5, omega stack (3, 41, 67)", om3r,
        r2, v2))
    main["sketch_panel"]["checked"] = sp_cases


def phase_kernels(state) -> None:
    cfg = RankyPaperConfig()
    coo = state["coo"]
    ell = state["ell"]
    rows, vals, m = ell.col_rows, ell.col_vals, ell.m
    cases = []
    main = {}
    rng = np.random.default_rng(7)

    wcoo = sparse.random_bipartite(cfg.rows, cfg.cols, cfg.density,
                                   seed=cfg.seed, weighted=True)
    well = sparse.block_ell_from_coo(wcoo, NUM_BLOCKS, device=DEVICE)
    ragged = synthetic_ell(rng, 3, 37, 5, 67, weighted=True, empty_block=1)
    sparse_gram_rows(cases, main, ell, well, ragged, rng)

    # --- blockgram --------------------------------------------------------
    # The paper matrix made dense, the solver's dense input: 0/1 values, so
    # one bf16 product each and an exact gram.
    dense = torch.from_numpy(sparse.pad_to_block_multiple(
        coo.todense(), NUM_BLOCKS)).to(DEVICE)
    blocks = dense.reshape(m, NUM_BLOCKS, -1).permute(1, 0, 2).contiguous()
    del dense
    want = gram_f64(blocks)
    got = bg_mod.blockgram(blocks)
    err = compare("blockgram", got, want, 0.0, cases,
                  f"paper dense {tuple(blocks.shape)} 0/1 (exact)")
    check(torch.equal(got, got.mT), "blockgram: the gram is not exactly "
          "symmetric")
    b_ms, b_by = blockgram_bound(blocks)
    main["blockgram"] = dict(
        shape=f"{tuple(blocks.shape)} f32 -> {tuple(got.shape)}, "
              f"{bg_mod.launch_plan(*blocks.shape, blocks.dtype)[0]} slices "
              f"of W",
        max_abs_err=err,
        ms=time_ms(lambda: bg_mod.blockgram(blocks), iters=5, warmup=1),
        plain_ms=time_ms(lambda: bg_mod.blockgram_ref(blocks), iters=5,
                         warmup=1),
        bound_ms=b_ms, bound_by=b_by, products=products(blocks),
        library_ms=bmm_ms(blocks),
        device_kernels=device_kernels_per_call(
            lambda: bg_mod.blockgram(blocks)),
        timed_variants=blockgram_variants(cases, blocks.shape, wcoo=wcoo))
    del blocks, want, got
    small = []
    a_w = torch.from_numpy(rng.standard_normal((3, 67, 203))
                           .astype(np.float32)).to(DEVICE)
    small += [("ragged D=3 M=67 W=203, gaussian f32", a_w),
              ("ragged D=3 M=67 W=203, bf16 input", a_w.to(torch.bfloat16))]
    for shape in ((1, 8, 5), (2, 40, 64)):
        g = torch.from_numpy(rng.standard_normal(shape)
                             .astype(np.float32)).to(DEVICE)
        small.append((f"short rows {shape}, gaussian f32", g))
        mixed = g.clone()
        mixed[:, :, ::2] = mixed[:, :, ::2].to(torch.bfloat16).float()
        small.append((f"short rows {shape}, mixed (every other column "
                      f"exact in bf16)", mixed))
    for name, x in BLOCKGRAM_WORST.items():
        small.append((f"(2, 40, 203), values the split serves worst "
                      f"({name})", blockgram_worst((2, 40, 203), x, 34)))
    small.append(("M=130 W=31 (W below one stage)",
                  torch.from_numpy(rng.standard_normal((1, 130, 31))
                                   .astype(np.float32)).to(DEVICE)))
    for tag, a in small:
        compare("blockgram", bg_mod.blockgram(a), gram_f64(a), 1e-5, cases,
                tag)
    a_sl = torch.randn((1, 539, 170_893), device=DEVICE,
                       generator=torch.Generator(DEVICE).manual_seed(32))
    compare("blockgram", bg_mod.blockgram(a_sl), gram_f64(a_sl),
            1e-5, cases, f"one block (1, 539, 170893), "
            f"{bg_mod.launch_plan(1, 539, 170_893, torch.float32)[0]} slices")
    del a_sl

    sketch_panel_rows(cases, main, ell, well, ragged, rng)
    topk_kernel_rows(state, cases, main)
    flash_kernel_rows(cases, main)
    ssd_kernel_rows(cases, main)

    state["kernel_main"] = main
    state["kernel_cases"] = cases
    emit("kernels", cases=cases, main_shapes=main,
         tolerance="0 for 0/1 sparse_gram and blockgram and for "
                   "topk_score (torch.equal on values and indices); else "
                   "1e-5 * max|plain| (f32 summation order; blockgram and "
                   "sparse_gram are held against the gram summed in "
                   "float64); sparse_gram and sketch_panel also the same "
                   "bits over 10 calls (torch.equal); "
                   "flash_attention 2e-5 and "
                   "ssd_scan 1e-4 of max|plain| in float32 (online against "
                   "direct softmax; chunked scan against the sequential "
                   "recurrence); a bf16 output element by element at one "
                   "bf16 ulp of |plain| plus that float32 term (each side "
                   "rounds its float32 result to bf16 once); the ssd_scan "
                   "state (float32) at 1e-4")


# ---------------------------------------------------------------------------
# Phase 3, LM kernels: flash_attention and ssd_scan
# ---------------------------------------------------------------------------

def peak_for(dtype) -> float:
    return BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS


def flash_bound(q, k, *, causal=True, window=0):
    """(bound_ms, bound_by, operations, bytes).  Bytes: q, k, v and the
    output once; operations: a multiply and an add per head dim for q.k and
    for p.v, per (query, key) pair that this mask shows, per query head."""
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    ki = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window > 0:
        mask &= (qi - ki) < window
    pairs = float(mask.sum())
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
    flops = 4.0 * b * hq * d * pairs
    return (*bound(nbytes, flops, peak_for(q.dtype)), flops, nbytes)


def achieved(flops, nbytes, ms) -> dict:
    """The rates a kernel time stands for: operations and bytes of the
    function (the same counts as its bound) over the time."""
    return dict(achieved_tflops=flops / ms / 1e9,
                achieved_gb_s=nbytes / ms / 1e6)


def device_ms_by_kernel(fn, iters: int = 10) -> dict:
    """Device time per call of each kernel ``fn`` launches, by name
    (``cuda_events`` over ``iters`` warm calls); {} where the profiler saw
    no device time."""
    return {key[:80]: dev / 1e3 / iters
            for key, _, dev in cuda_events(fn, iters) if dev > 0}


def lm_randn(shape, gen, dtype):
    return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)


def flash_case(cases, case, b, hq, hkv, sq, sk, d, dtype, gen, **kw):
    q = lm_randn((b, hq, sq, d), gen, dtype)
    k = lm_randn((b, hkv, sk, d), gen, dtype)
    v = lm_randn((b, hkv, sk, d), gen, dtype)
    got = fa_mod.flash_attention(q, k, v, **kw)
    want = fa_mod.flash_attention_ref(q, k, v, **kw)
    hold = compare_bf16 if dtype == torch.bfloat16 else compare
    err = hold("flash_attention", got, want, 2e-5, cases, case)
    del want
    return q, k, v, got, err


def sdpa_ms(q, k, v, causal) -> float:
    """The yardstick only (the port never calls SDPA): one SDPA call on the
    same inputs, K and V expanded to the query heads beforehand."""
    group = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    return time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, kk, vv, is_causal=causal))


def flash_timed(cases, case, shape, dtype, gen, causal=True) -> dict:
    """flash_case, then the kernel's time beside its bound and SDPA's."""
    q, k, v, _, err = flash_case(cases, case, *shape, dtype, gen,
                                 causal=causal)
    b_ms, b_by, flops, nbytes = flash_bound(q, k, causal=causal)
    ms = time_ms(lambda: fa_mod.flash_attention(q, k, v, causal=causal))
    return dict(case=case, max_abs_err=err, ms=ms, bound_ms=b_ms,
                bound_by=b_by, **achieved(flops, nbytes, ms),
                library_ms=sdpa_ms(q, k, v, causal))


def flash_kernel_rows(cases, main) -> None:
    """The main shape of the LM prefill, (8, 32, 1024, 80) causal, in bf16
    (the config's type) and float32, timed; the long prompt (2, 32, 3000,
    80) and a head-dim-128 GQA shape timed beside SDPA too; variants
    checked: GQA, window, softcap, non-causal, right-aligned, ragged, rows
    that see no key."""
    gen = torch.Generator(DEVICE).manual_seed(21)
    pf = LM_PREFILL
    cfg = get_config(LM_ARCH)
    shape = (pf["batch"], cfg.padded_heads, cfg.padded_kv_heads, pf["seq"],
             pf["seq"], cfg.head_dim)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).replace("torch.", "")
        q, k, v, _, err = flash_case(cases, f"main {shape} {tag} causal",
                                     *shape, dtype, gen)
        b_ms, b_by, flops, nbytes = flash_bound(q, k)
        ms = time_ms(lambda: fa_mod.flash_attention(q, k, v))
        rows[tag] = dict(
            shape=f"q, k, v {tuple(q.shape)} {tag}, causal", max_abs_err=err,
            ms=ms,
            plain_ms=time_ms(lambda: fa_mod.flash_attention_ref(q, k, v),
                             iters=3, warmup=1),
            bound_ms=b_ms, bound_by=b_by, **achieved(flops, nbytes, ms),
            library_ms=sdpa_ms(q, k, v, True),
            device_kernels=device_kernels_per_call(
                lambda: fa_mod.flash_attention(q, k, v)))
        del q, k, v
    variants = [
        ("GQA Hq 8 Hkv 2", (2, 8, 2, 1024, 1024, 80), {}),
        ("window 256", (2, 8, 8, 1024, 1024, 80), dict(window=256)),
        ("softcap 50", (2, 8, 8, 1024, 1024, 80), dict(softcap=50.0)),
        ("non-causal", (2, 8, 8, 1024, 1024, 80), dict(causal=False)),
        ("right-aligned sq 256 < sk 1024", (2, 8, 2, 256, 1024, 80), {}),
        ("ragged sq = sk = 1000", (2, 8, 2, 1000, 1000, 80), {}),
        ("ragged sq 1 sk 777", (3, 8, 2, 1, 777, 80), {}),
        ("head dim 128, window + softcap, non-causal",
         (1, 4, 2, 300, 300, 128),
         dict(causal=False, window=64, softcap=30.0)),
    ]
    timed = []
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).replace("torch.", "")
        for name, shp, kw in variants:
            flash_case(cases, f"{name} {tag}", *shp, dtype, gen, **kw)
        timed.append(flash_timed(
            cases, f"long prompt sq = sk = 3000 (lm_serve's long prefill) "
            f"{tag}", (LM_LONG["batch"], 32, 32, LM_LONG["seq"],
                       LM_LONG["seq"], 80), dtype, gen))
        timed.append(flash_timed(cases, f"head dim 128, GQA 32/8, causal "
                                 f"{tag}", (2, 32, 8, 1024, 1024, 128),
                                 dtype, gen))
    q, k, v, got, _ = flash_case(cases, "sq 100 > sk 60 (rows before every "
                                 "key)", 1, 4, 4, 100, 60, 80,
                                 torch.float32, gen)
    check(float(got[:, :, :40].abs().max()) == 0.0,
          "flash_attention: rows that see no key must be zeros")
    timed += flash_wide_rows(cases, gen)
    main["flash_attention"] = dict(rows["bfloat16"], float32=rows["float32"],
                                   timed_variants=timed)


def flash_wide_rows(cases, gen) -> list:
    """gemma2-9b's widths, q (8, 16, 1024, 256) over k, v (8, 8, 1024,
    256), causal, in bf16 and float32, timed beside SDPA; variants at head
    dim 256: window 256, softcap 50, ragged sq = sk = 1000, sq 256 < sk
    1024, and rows that see no key."""
    cfg = get_config(WIDE_ATTN_ARCH)
    shape = (LM_PREFILL["batch"], cfg.padded_heads, cfg.padded_kv_heads,
             LM_PREFILL["seq"], LM_PREFILL["seq"], cfg.head_dim)
    d = cfg.head_dim
    timed = []
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).replace("torch.", "")
        timed.append(flash_timed(cases, f"{WIDE_ATTN_ARCH} {shape} causal "
                                 f"{tag}", shape, dtype, gen))
        for name, shp, kw in (
                ("window 256", (2, 16, 8, 1024, 1024, d), dict(window=256)),
                (f"softcap {cfg.logit_softcap:g}", (2, 16, 8, 1024, 1024, d),
                 dict(softcap=cfg.logit_softcap)),
                ("ragged sq = sk = 1000", (2, 16, 8, 1000, 1000, d), {}),
                ("right-aligned sq 256 < sk 1024", (2, 16, 8, 256, 1024, d),
                 {})):
            flash_case(cases, f"head dim {d}, {name} {tag}", *shp, dtype, gen,
                       **kw)
        _, _, _, got, _ = flash_case(
            cases, f"head dim {d}, sq 100 > sk 60 (rows before every key) "
            f"{tag}", 1, 4, 2, 100, 60, d, dtype, gen)
        check(float(got[:, :, :40].float().abs().max()) == 0.0,
              f"flash_attention: rows that see no key must be zeros (head "
              f"dim {d}, {tag})")
    return timed


def ssd_inputs(b, seq, h, g, p, n, dtype, gen):
    x = lm_randn((b, seq, h, p), gen, dtype)
    dt = (torch.nn.functional.softplus(
        torch.randn((b, seq, h), generator=gen, device=DEVICE)) * 0.1
          ).to(dtype)
    a = -torch.exp(torch.randn((h,), generator=gen, device=DEVICE))
    bm = (torch.randn((b, seq, g, n), generator=gen, device=DEVICE)
          / n ** 0.5).to(dtype)
    cm = (torch.randn((b, seq, g, n), generator=gen, device=DEVICE)
          / n ** 0.5).to(dtype)
    return x, dt, a, bm, cm


def ssd_bound(x, bm):
    """(bound_ms, bound_by, operations, bytes) of ``ss_mod.work``: the
    bytes read and written once and the recurrence's operations, whatever
    the kernel's chunk."""
    b, seq, h, p = x.shape
    nbytes, flops = ss_mod.work(b, seq, h, bm.shape[2], p, bm.shape[3],
                                x.element_size())
    return (*bound(nbytes, flops, peak_for(x.dtype)), flops, nbytes)


def ssd_case(cases, case, shape, dtype, gen, inputs=None):
    args = inputs or ssd_inputs(*shape, dtype, gen)
    y, hf = ss_mod.ssd_scan(*args)
    yr, hr = ss_mod.ssd_scan_ref(*args)
    hold = compare_bf16 if dtype == torch.bfloat16 else compare
    err = hold("ssd_scan", y, yr, 1e-4, cases, case + " y")
    err_h = compare("ssd_scan", hf, hr, 1e-4, cases, case + " state")
    return args, max(err, err_h), hf


def ssd_timed(cases, case, shape, dtype, gen) -> dict:
    """ssd_case, then the kernel's time beside its bound and the rates."""
    args, err, _ = ssd_case(cases, case, shape, dtype, gen)
    b_ms, b_by, flops, nbytes = ssd_bound(args[0], args[3])
    ms = time_ms(lambda: ss_mod.ssd_scan(*args))
    return dict(case=case, max_abs_err=err, ms=ms, bound_ms=b_ms,
                bound_by=b_by, **achieved(flops, nbytes, ms))


def ssd_kernel_rows(cases, main) -> None:
    """The main shape of the LM prefill, x (8, 1024, 80, 64), G 1, N 64, in
    bf16 and float32, timed; the long prompt (2, 3000, 80, 64) timed
    beside it; variants: G = 2, G = H = 8, ragged L = 1000, L = 1 and
    L = 11 (a chunk shorter than one 16-row MMA tile), P = N = 16, and a
    decaying state that forgets its first half."""
    gen = torch.Generator(DEVICE).manual_seed(22)
    cfg = get_config(LM_ARCH)
    pf = LM_PREFILL
    shape = (pf["batch"], pf["seq"], cfg.ssm_heads, cfg.ssm_groups,
             cfg.ssm_head_dim, cfg.ssm_state)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).replace("torch.", "")
        args, err, _ = ssd_case(cases, f"main {shape} {tag}", shape, dtype,
                                gen)
        b_ms, b_by, flops, nbytes = ssd_bound(args[0], args[3])
        ms = time_ms(lambda: ss_mod.ssd_scan(*args))
        rows[tag] = dict(
            shape=f"x {tuple(args[0].shape)} {tag}, G {shape[3]}, N "
                  f"{shape[5]}, chunk {ss_mod.chunk_for(dtype, shape[5])}",
            max_abs_err=err,
            ms=ms,
            plain_ms=time_ms(lambda: ss_mod.ssd_scan_ref(*args), iters=2,
                             warmup=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            device_kernels=device_kernels_per_call(
                lambda: ss_mod.ssd_scan(*args)),
            **achieved(flops, nbytes, ms))
        del args
    timed = []
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).replace("torch.", "")
        timed.append(ssd_timed(
            cases, f"long prompt L 3000 (lm_serve's long prefill) {tag}",
            (LM_LONG["batch"], LM_LONG["seq"], cfg.ssm_heads,
             cfg.ssm_groups, cfg.ssm_head_dim, cfg.ssm_state), dtype, gen))
        ssd_case(cases, f"G 2 {tag}", (4, 1024, 80, 2, 64, 64), dtype, gen)
        ssd_case(cases, f"G = H = 8 {tag}", (4, 1024, 8, 8, 64, 64), dtype,
                 gen)
        ssd_case(cases, f"ragged L 1000 {tag}", (2, 1000, 80, 1, 64, 64),
                 dtype, gen)
        ssd_case(cases, f"L 1 {tag}", (4, 1, 80, 1, 64, 64), dtype, gen)
        ssd_case(cases, f"L 11 {tag}", (4, 11, 80, 2, 64, 64), dtype, gen)
        ssd_case(cases, f"smoke widths P 16 N 16, L 300 {tag}",
                 (2, 300, 8, 1, 16, 16), dtype, gen)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        for n in (64, 128):
            x, _, _, bm, cm = ssd_inputs(1, 256, 8, 1, 64, n, dtype, gen)
            dt = torch.full((1, 256, 8), 2.0, device=DEVICE, dtype=dtype)
            a = torch.full((8,), -10.0, device=DEVICE)
            _, _, h1 = ssd_case(cases, f"decaying state N {n} {tag}", None,
                                dtype, gen, inputs=(x, dt, a, bm, cm))
            x2 = x.clone()
            x2[:, :128] = lm_randn((1, 128, 8, 64), gen, dtype)
            h2 = ss_mod.ssd_scan(x2, dt, a, bm, cm)[1]
            check(torch.allclose(h1, h2, rtol=1e-4, atol=1e-4),
                  f"ssd_scan: a state with a = -10, dt = 2 must forget its "
                  f"first half (N {n}, {tag})")
    timed += ssd_wide_rows(cases, gen)
    main["ssd_scan"] = dict(rows["bfloat16"], float32=rows["float32"],
                            timed_variants=timed)


def ssd_wide_rows(cases, gen) -> list:
    """mamba2-1.3b's widths, x (8, 1024, 64, 64), G 1, N 128, in bf16 and
    float32, timed beside the bound; variants at N 128: ragged L 1000, L 1,
    L 11, G 2, and P 128 at a small batch."""
    cfg = get_config(SSM_ARCH)
    pf = LM_PREFILL
    shape = (pf["batch"], pf["seq"], cfg.ssm_heads, cfg.ssm_groups,
             cfg.ssm_head_dim, cfg.ssm_state)
    timed = []
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).replace("torch.", "")
        row = ssd_timed(cases, f"{SSM_ARCH} {shape} {tag}, chunk "
                        f"{ss_mod.chunk_for(dtype, shape[5])}", shape, dtype,
                        gen)
        timed.append(row)
        h, p, n = shape[2], shape[4], shape[5]
        ssd_case(cases, f"N {n} ragged L 1000 {tag}", (2, 1000, h, 1, p, n),
                 dtype, gen)
        ssd_case(cases, f"N {n} L 1 {tag}", (4, 1, h, 1, p, n), dtype, gen)
        ssd_case(cases, f"N {n} L 11 {tag}", (4, 11, h, 2, p, n), dtype, gen)
        ssd_case(cases, f"N {n} G 2 {tag}", (4, 1024, h, 2, p, n), dtype, gen)
        ssd_case(cases, f"P 128 N 128 {tag}", (2, 512, 8, 1, 128, 128),
                 dtype, gen)
    return timed


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
    # The kernel at this shape: 0/1 (exact) and with seeded weights in
    # (0.5, 2) on the non-zero slots, each the same bits over 10 calls,
    # timed beside its bound and its plain version (phase ``kernels``'
    # timed_variants).
    main = state["kernel_main"]["sparse_gram"]
    w_vals = reweighted(ell.col_vals, 13)
    for tag, vals in (("0/1 (exact)", ell.col_vals),
                      ("weights in (0.5, 2)", w_vals)):
        case = f"{name} ({m} x {n}) {tag}, rows/vals " \
               f"{tuple(ell.col_rows.shape)}"
        kf = sparse_gram_case(state["kernel_cases"], case, ell.col_rows,
                              vals, m)
        b_ms, b_by = sparse_gram_bound(ell.col_rows, vals, m)
        kf.update(
            ms=time_ms(lambda: sg_mod.sparse_gram(ell.col_rows, vals, m),
                       iters=10),
            device_ms=device_ms(
                lambda: sg_mod.sparse_gram(ell.col_rows, vals, m)),
            plain_ms=time_ms(lambda: sg_mod.sparse_gram_ref(
                ell.col_rows, vals, m), iters=3, warmup=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            device_kernels=device_kernels_per_call(
                lambda: sg_mod.sparse_gram(ell.col_rows, vals, m)))
        main["timed_variants"].append(kf)
    del w_vals
    emit("solve_scaled", case="a", m=m, n=n, nnz=coo.nnz,
         ell_capacity=list(ell.capacity), host_generate_s=t_gen,
         host_block_ell_from_coo_s=t_ell,
         warm_wall_time_s_ell_input=res2.diagnostics.wall_time_s,
         sparse_gram=main["timed_variants"][-2:],
         stage_ms=stage_ms(ell, cfg),
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
    state["tall"] = dict(coo=coo, ell=ell, s_ref=s_ref.copy(),
                         method=cfg.method)
    res2, _ = timed_svd(ell, cfg)
    # The kernel at this shape (L = 64 = rank + oversample, K = 36 > 32),
    # with Omega as the solver passes it ((L, M) contiguous) and as the
    # transpose of an (M, L)-contiguous tensor (phase ``kernels``'
    # timed_variants).
    omega = torch.randn((64, m), device=DEVICE,
                        generator=torch.Generator(DEVICE).manual_seed(3))
    main = state["kernel_main"]["sketch_panel"]
    for layout, om in (("(L, M)", omega),
                       ("(M, L) transposed", omega.T.contiguous().T)):
        kf = sketch_timed(
            state["kernel_cases"], f"{name} ({m} x {n}) omega "
            f"{tuple(omega.shape)} {layout}, rows/vals "
            f"{tuple(ell.col_rows.shape)}", om, ell.col_rows, ell.col_vals)
        kf["plain_ms"] = time_ms(lambda: sp_mod.sketch_panel_ref(
            om, ell.col_rows, ell.col_vals), iters=3, warmup=1)
        main["timed_variants"].append(kf)
    emit("solve_scaled", case="b", m=m, n=n, nnz=coo.nnz,
         ell_capacity=list(ell.capacity), host_generate_s=t_gen,
         host_block_ell_from_coo_s=t_ell, host_scipy_svds_s=t_ref,
         warm_wall_time_s_ell_input=res2.diagnostics.wall_time_s,
         sketch_panel=main["timed_variants"][-2:],
         stage_ms=stage_ms(ell, cfg),
         **diag_fields(res, counts), **fields)


# ---------------------------------------------------------------------------
# topk_score: the kernel against its plain version (phase 3)
# ---------------------------------------------------------------------------

def topk_bound(qs, v, k_top, scale):
    """(bound_ms, bound_by, operations, bytes).  Bytes: v, the scale, the
    queries and the two outputs once; operations: a multiply and an add per
    (query, item, factor)."""
    b, k = qs.shape
    n = v.shape[0]
    nbytes = (v.numel() * v.element_size() + (n * 4 if scale is not None
                                               else 0)
              + qs.numel() * 4 + b * k_top * 8)
    return (*bound(nbytes, 2.0 * b * n * k), 2.0 * b * n * k, nbytes)


def topk_case(cases, case, qs, v, k_top, *, scale=None, valid_n=None,
              index_offset=0, block_n=512, plain_iters=5, passes=False):
    """Kernel vs plain version with torch.equal on values and indices, and
    the times: kernel, plain version, one library call (timed only: its tie
    order differs) and the bound; with ``passes``, the device time of each
    of the kernel's two passes (``torch.profiler``)."""
    kw = dict(scale=scale, valid_n=valid_n, index_offset=index_offset)
    got = tk_mod.topk_score(qs, v, k_top, block_n=block_n, **kw)
    want = tk_mod.topk_score_ref(qs, v, k_top, **kw)
    torch.cuda.synchronize()
    equal = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
    err = max_err(got[0], want[0])
    cases.append(dict(kernel="topk_score", case=case, equal=equal,
                      max_abs_err=err, limit=0.0))
    check(equal, f"topk_score[{case}]: differs from the plain version "
          f"(max |dv| {err}, {int((got[1] != want[1]).sum())} indices)")
    def library():
        s = torch.mm(qs, v.float().T)
        return torch.topk(s * scale[None, :] if scale is not None else s,
                          k_top)

    b_ms, b_by, flops, nbytes = topk_bound(qs, v, k_top, scale)
    call = lambda: tk_mod.topk_score(qs, v, k_top, block_n=block_n,  # noqa
                                     **kw)
    ms = time_ms(call)
    return dict(
        case=case, shape=f"qs {tuple(qs.shape)}, v {tuple(v.shape)} "
                         f"{str(v.dtype).replace('torch.', '')}, "
                         f"k_top {k_top}",
        max_abs_err=err, ms=ms,
        plain_ms=time_ms(lambda: tk_mod.topk_score_ref(qs, v, k_top, **kw),
                         iters=plain_iters, warmup=1),
        bound_ms=b_ms, bound_by=b_by, **achieved(flops, nbytes, ms),
        library_ms=time_ms(library, iters=5, warmup=1),
        device_kernels=device_kernels_per_call(call),
        **(dict(pass_ms=device_ms_by_kernel(call)) if passes else {}))


def topk_variants(cases, b, k, n, k_top, *, n_valid, seed, plain_iters):
    """The five variants at one shape: f32; int8 + kvquant scale; valid_n <
    N with an index offset; a ragged last tile; all scores tied three ways."""
    gen = torch.Generator(DEVICE).manual_seed(seed)
    qs = torch.randn((b, k), generator=gen, device=DEVICE)
    v = torch.randn((n, k), generator=gen, device=DEVICE)
    tag = f"B={b} k={k} N={n}"
    rows = [topk_case(cases, f"{tag} f32, valid_n={n_valid}", qs, v, k_top,
                      valid_n=n_valid, plain_iters=plain_iters, passes=True)]
    v_q, v_scale = kvquant.quantize(v, axis=-1)
    rows.append(topk_case(cases, f"{tag} int8 + kvquant scale", qs, v_q,
                          k_top, scale=v_scale[:, 0].contiguous(),
                          valid_n=n_valid, plain_iters=plain_iters,
                          passes=True))
    rows.append(topk_case(cases, f"{tag} valid_n={n - 3001} offset=5000", qs,
                          v, k_top, valid_n=n - 3001, index_offset=5000,
                          plain_iters=plain_iters))
    n_rag = n - 37
    rows.append(topk_case(cases, f"{tag} ragged N={n_rag} block_n=128", qs,
                          v[:n_rag], k_top, block_n=128,
                          plain_iters=plain_iters))
    qi = torch.randint(-3, 4, (b, k), generator=gen, device=DEVICE).float()
    base = torch.randint(-3, 4, (n // 3, k), generator=gen,
                         device=DEVICE).float()
    rows.append(topk_case(cases, f"{tag} all ties (integer rows x 3)", qi,
                          base.repeat(3, 1), k_top, plain_iters=plain_iters))
    return rows


def topk_kernel_rows(state, cases, main) -> None:
    ell = state["ell"]
    n_pad = ell.num_blocks * ell.width
    paper = topk_variants(cases, TOPK_PAPER["b"], TOPK_PAPER["k"], n_pad,
                          TOPK_PAPER["k_top"], n_valid=ell.n, seed=11,
                          plain_iters=5)
    sc = SCALED_SERVE
    scaled = topk_variants(cases, sc["b"], sc["rank"], sc["n"], sc["k_top"],
                           n_valid=sc["n"], seed=12, plain_iters=2)
    torch.cuda.empty_cache()
    main["topk_score"] = dict(paper[0], variants=paper[1:],
                              scaled_shape=scaled)
    before = tk_mod.launches
    e_v, e_i = tk_mod.topk_score(torch.empty((0, 16), device=DEVICE),
                                 torch.ones((40, 16), device=DEVICE), 10)
    check(e_v.shape == e_i.shape == (0, 10) and tk_mod.launches == before,
          "topk_score: an empty wave must return (0, k_top) and launch "
          "nothing")


# ---------------------------------------------------------------------------
# Phases 8-10: streaming ingest and top-k serving
# ---------------------------------------------------------------------------

def coo_rows(coo, lo: int, hi: int) -> sparse.COOMatrix:
    """Rows [lo, hi) of a COO matrix, in the same column universe."""
    sel = (coo.rows >= lo) & (coo.rows < hi)
    return sparse.COOMatrix(rows=(coo.rows[sel] - lo).astype(np.int32),
                            cols=coo.cols[sel], vals=coo.vals[sel],
                            shape=(hi - lo, coo.shape[1]))


def ortho_err(x) -> float:
    return float((x.T @ x - torch.eye(x.shape[1], device=x.device))
                 .abs().max())


def sum_stages(times) -> dict:
    return {(f"{name} x{len(runs)}" if len(runs) > 1 else name): sum(runs)
            for name, runs in times.items()}


def stream_gram_case(cases, tag, st, delta, cfg, draws=None) -> None:
    """sparse_gram against its plain version on the repaired blocks that
    the ingest of ``delta`` into ``st`` factors (the same repair, key and
    draws): exact for 0/1 data, else 1e-5 * max|plain|."""
    blocks = ranky.split_and_repair(
        stream_state.as_delta(delta, st), st.num_blocks, cfg.method,
        ranky.derive_seed(st.seed, st.batches_seen), draws=draws)
    ell = blocks.ell
    zero_one = bool(((ell.col_vals == 0) | (ell.col_vals == 1)).all())
    compare("sparse_gram",
            sg_mod.sparse_gram(ell.col_rows, ell.col_vals, ell.m),
            sg_mod.sparse_gram_ref(ell.col_rows, ell.col_vals, ell.m),
            0.0 if zero_one else 1e-5, cases,
            f"{tag}: repaired batch, rows/vals {tuple(ell.col_rows.shape)}, "
            f"M={ell.m}, {'0/1 (exact)' if zero_one else 'weighted'}")


def phase_stream_exact(state) -> None:
    """The paper matrix in 4 row batches with the rank kept in full: the
    stream is exact, so S is held against float64 like a one-shot solve."""
    coo = state["coo"]
    m, n = coo.shape
    cfg = api.SolveConfig(method="none", truncate_rank=m,
                          num_blocks=NUM_BLOCKS, use_kernel=True,
                          want_right=True)
    st = api.svd_init(n, cfg, device=DEVICE)
    bounds = np.linspace(0, m, 5).astype(int)
    walls, merge_ms, per_batch, befores = [], [], [], []
    reset_counts()
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        befores.append(st)
        with stages.record() as times:
            res = api.svd_update(st, coo_rows(coo, int(lo), int(hi)), cfg)
        st = res.state
        walls.append(res.diagnostics.wall_time_s)
        merge_ms.append(times["merge.svd"][0])
        per_batch.append(sum_stages(times))
        check(res.plan.backend == "single" and res.plan.strategy ==
              "streaming" and res.plan.rank is None, "stream_exact: plan")
    counts = read_counts()
    keep_counts(state, "stream_exact", counts)
    check(counts["sparse_gram"] == 4, f"stream_exact: sparse_gram launches "
          f"{counts['sparse_gram']}, want one per batch")
    check(st.rank == m and st.rows_seen == m, "stream_exact: rank/rows")
    s_ref = reference_svals(ranky.split_and_repair(state["ell"], NUM_BLOCKS,
                                                   "none"), NUM_BLOCKS)
    ds = (st.s.double() - s_ref).abs()
    limit = 2e-3 * float(s_ref[0])
    check(float(ds.max()) <= limit,
          f"stream_exact: max|dS| {float(ds.max())} > 2e-3*S[0] = {limit}")
    u_err, v_err = ortho_err(st.u), ortho_err(st.v)
    check(u_err <= 1e-4 and v_err <= 1e-4,
          f"stream_exact: |U^T U - I| {u_err}, |V^T V - I| {v_err}")
    gram_cases = []
    for b, (before, lo, hi) in enumerate(zip(befores, bounds[:-1],
                                              bounds[1:])):
        stream_gram_case(gram_cases, f"stream_exact batch {b}", before,
                         coo_rows(coo, int(lo), int(hi)), cfg)
    emit("stream_exact", batches=[int(b) for b in np.diff(bounds)],
         merge_driver=hierarchy.CUDA_SVD_DRIVER or "default",
         wall_time_s=walls, merge_svd_ms=merge_ms, stage_ms=per_batch,
         s0=float(st.s[0]), s_last=float(st.s[-1]), max_abs_dS=float(ds.max()),
         dS_limit=limit, u_ortho_err=u_err, v_ortho_err=v_err,
         kernel_checks=gram_cases, launches=counts)


def port_draws(seed: int, method: str, ell) -> ranky.RepairDraws:
    """The repair draws the port makes for this batch on the CPU, moved to
    the GPU: its CUDA generator would draw other neighbor scores, and the GPU
    stream is held against the CPU one."""
    d, m, w, c = ell.num_blocks, ell.m, ell.width, ell.capacity[0]
    rc = ranky.draw_random_cols(seed, method, d, m, w, "cpu")
    sc = torch.stack([ranky.draw_neighbor_scores(seed, method, i, (m, c),
                                                 "cpu") for i in range(d)])
    return ranky.RepairDraws(rc.to(DEVICE), sc.to(DEVICE))


def expected_wave(snap, queries, k_top):
    """The plain version's answer on one snapshot, on the host."""
    qs = ranker.fold_queries(snap, queries.to(snap.device))
    if snap.quantized:
        out = tk_mod.topk_score_ref(qs, snap.v_q, k_top,
                                    scale=snap.v_scale[:, 0].contiguous(),
                                    valid_n=snap.n)
    else:
        out = tk_mod.topk_score_ref(qs, snap.v, k_top, valid_n=snap.n)
    return out[0].cpu(), out[1].cpu()


def same(res, want) -> bool:
    return (torch.equal(res.scores.cpu(), want[0])
            and torch.equal(res.indices.cpu(), want[1]))


def phase_stream_serve(state) -> None:
    """The user's configuration: the paper rows streamed in batches of 64,
    rank 16, served in waves of 32 while later batches are ingested."""
    import threading

    coo = state["coo"]
    m, n = coo.shape
    cfg = api.SolveConfig(method="neighbor_random", truncate_rank=16,
                          oversample=8, num_blocks=NUM_BLOCKS,
                          use_kernel=True)
    bounds = list(range(0, m, STREAM_BATCH_ROWS)) + [m]
    batches = [coo_rows(coo, lo, hi) for lo, hi in zip(bounds, bounds[1:])]
    nb = len(batches)

    # The same stream on the CPU, with the port's own draws.
    t0 = time.perf_counter()
    st_cpu = api.svd_init(n, cfg, device="cpu")
    for delta in batches:
        st_cpu = api.svd_update(st_cpu, delta, cfg).state
    cpu_s = time.perf_counter() - t0

    def draws_for(st, delta):
        ell = sparse.block_ell_from_coo(delta, NUM_BLOCKS, device="cpu")
        return port_draws(ranky.derive_seed(st.seed, st.batches_seen),
                          cfg.method, ell)

    st0 = st = api.svd_init(n, cfg, device=DEVICE)
    reset_counts()
    warm = []
    for delta in batches[:4]:
        res = api.svd_update(st, delta, cfg, draws=draws_for(st, delta))
        st = res.state
        warm.append(res.diagnostics.wall_time_s)
    keep_counts(state, "stream_serve[ingest x4]", read_counts())
    gram_cases = []
    for b, before in ((0, st0), (4, st)):
        stream_gram_case(gram_cases, f"stream_serve batch {b}", before,
                         batches[b], cfg, draws_for(before, batches[b]))
    with stages.record() as times:     # one more ingest, off the main path
        api.svd_update(st, batches[4], cfg, draws=draws_for(st, batches[4]))
    ingest_stages = sum_stages(times)

    h32 = api.serve_init(st, api.ServeTopKConfig(batch_size=32, k_top=10))
    h8 = api.serve_init(st, api.ServeTopKConfig(batch_size=32, k_top=10,
                                                quantize=True))
    check(h32.plan.backend == "single" and h32.plan.strategy == "serve_fused",
          "stream_serve: R7 plan")
    gen = torch.Generator(DEVICE).manual_seed(5)
    q = torch.randn((32, 16), generator=gen, device=DEVICE)
    reset_counts()
    r32 = api.serve_topk(h32, q)
    counts = read_counts()
    keep_counts(state, "serve_topk[f32]", counts)
    check(counts["topk_score"] == 1, "serve_topk[f32]: topk_score launches "
          f"{counts['topk_score']}")
    reset_counts()
    r8 = api.serve_topk(h8, q)
    keep_counts(state, "serve_topk[int8]", read_counts())
    check(same(r32, expected_wave(h32.read(), q, 10)),
          "serve_topk[f32] differs from the plain version")
    check(same(r8, expected_wave(h8.read(), q, 10)),
          "serve_topk[int8] differs from the plain version")
    i32, i8 = r32.indices.cpu().tolist(), r8.indices.cpu().tolist()
    overlap = float(np.mean([len(set(a) & set(b)) / 10
                             for a, b in zip(i32, i8)]))
    with stages.record() as times:
        api.serve_topk(h32, q)
    wave_stages = sum_stages(times)
    # Cold start: raw interaction rows projected into factor space.
    raw = torch.from_numpy(coo_rows(coo, 0, 8).todense()).to(DEVICE)
    cold_q = ranker.project_rows(h32.read(), raw)
    cold = api.serve_topk(h32, cold_q)
    check(torch.isfinite(cold_q).all() and cold.indices.shape == (8, 10)
          and same(cold, expected_wave(h32.read(), cold_q, 10)),
          "stream_serve: cold-start wave")

    def serve_waves(count=None, until=None):
        """Answer waves of ``q`` on h32 until ``count`` waves are done or
        ``until`` is set (and at least 50 waves); (waves, seconds)."""
        out = []
        t_start = time.perf_counter()
        while (len(out) < count if count is not None
               else not until.is_set() or len(out) < 50):
            t1 = time.perf_counter()
            res = api.serve_topk(h32, q)
            torch.cuda.current_stream().synchronize()
            lat = time.perf_counter() - t1
            out.append((res, lat, h32.metrics()["snapshot_age_s"],
                        until is not None and not until.is_set()))
        return out, time.perf_counter() - t_start

    def wave_stats(waves, seconds):
        lat_ms = np.array([w[1] for w in waves]) * 1e3
        return dict(waves=len(waves), waves_per_s=len(waves) / seconds,
                    p50_wave_ms=float(np.percentile(lat_ms, 50)),
                    p99_wave_ms=float(np.percentile(lat_ms, 99)))

    # The same waves with no ingest beside them: the baseline of the live
    # numbers below.
    idle = wave_stats(*serve_waves(count=200))

    # Serve under ingest: batches 4.. on a stream of their own, committed
    # between waves.  The snapshot each commit publishes is kept; the
    # answers every version should give are computed after the live window,
    # so that no check runs beside the timed waves and ingests.
    snaps = {h32.version: h32.read()}
    ingest_stream = torch.cuda.Stream()
    done = threading.Event()
    errors, update_ms, commit_ms, final = [], [], [], {}

    def ingest_loop():
        try:
            with torch.cuda.stream(ingest_stream):
                s = st
                for delta in batches[4:]:
                    final["before_last"] = s
                    res = api.svd_update(s, delta, cfg,
                                         draws=draws_for(s, delta))
                    t1 = time.perf_counter()
                    snap = h32.commit(res.state)
                    commit_ms.append((time.perf_counter() - t1) * 1e3)
                    update_ms.append(res.diagnostics.wall_time_s * 1e3)
                    snaps[snap.version] = snap
                    s = res.state
                final["state"] = s
        except Exception as exc:       # reported by the main thread
            errors.append(repr(exc))
        finally:
            done.set()

    worker = threading.Thread(target=ingest_loop, daemon=True)
    worker.start()
    waves, live_s = serve_waves(until=done)
    worker.join(timeout=600)
    check(not worker.is_alive() and not errors,
          f"stream_serve: ingest thread {errors or 'did not finish'}")
    expected = {ver: expected_wave(snap, q, 10) for ver, snap in snaps.items()}
    bad = [res.version for res, *_ in waves
           if not same(res, expected[res.version])]
    check(not bad, f"stream_serve: {len(bad)} waves differ from the answer "
          f"for their version (versions {sorted(set(bad))})")
    versions = sorted({w[0].version for w in waves})
    check(len(versions) > 1, "stream_serve: no wave saw a new version")
    stream_gram_case(gram_cases, f"stream_serve batch {nb - 1} (ragged)",
                     final["before_last"], batches[-1], cfg,
                     draws_for(final["before_last"], batches[-1]))

    st_gpu = final["state"]
    ds = float((st_gpu.s.cpu() - st_cpu.s).abs().max())
    check(ds <= 1e-3 * float(st_cpu.s[0]),
          f"stream_serve: GPU vs CPU max|dS| {ds}")
    u_err, v_err = ortho_err(st_gpu.u), ortho_err(st_gpu.v)
    check(u_err <= 1e-4 and v_err <= 1e-4,
          f"stream_serve: |U^T U - I| {u_err}, |V^T V - I| {v_err}")
    check((st_gpu.lonely_rows_seen, st_gpu.repaired_rows_seen)
          == (st_cpu.lonely_rows_seen, st_cpu.repaired_rows_seen),
          "stream_serve: lonely / repaired counts differ from the CPU run")
    state["stage_summary"] = dict(ingest=ingest_stages, serve_wave=wave_stages)
    emit("stream_serve", batches=nb, batch_rows=STREAM_BATCH_ROWS,
         first_ingest_wall_s=warm[0], warm_ingest_wall_s=warm[1:],
         cpu_stream_s=cpu_s, s0=float(st_gpu.s[0]), s15=float(st_gpu.s[-1]),
         max_abs_dS_vs_cpu=ds, u_ortho_err=u_err, v_ortho_err=v_err,
         lonely_rows=st_gpu.lonely_rows_seen,
         repaired_rows=st_gpu.repaired_rows_seen,
         int8_f32_top10_overlap=overlap,
         cold_start_wave_ok=True, ingest_stage_ms=ingest_stages,
         wave_stage_ms=wave_stages, kernel_checks=gram_cases,
         no_ingest=idle,
         live=dict(wave_stats(waves, live_s),
                   waves_during_ingest=sum(w[3] for w in waves),
                   versions_seen=versions,
                   svd_update_ms=update_ms, commit_ms=commit_ms,
                   snapshot_age_s_max=max(w[2] for w in waves)),
         clocks="waves: host clock around serve_topk, the serving stream "
                "synchronized; svd_update_ms: its own wall_time_s (the "
                "whole device synchronized at both ends, so it also waits "
                "for waves in flight); commit_ms: host clock around "
                "handle.commit (snapshot, ingest-stream synchronize, "
                "publish)")


def phase_serve_scaled(state) -> None:
    """A catalogue of 1,048,576 items at rank 64, served in waves of 256."""
    sc = SCALED_SERVE
    n = sc["n"]
    cfg = api.SolveConfig(method="neighbor_random", truncate_rank=sc["rank"],
                          num_blocks=NUM_BLOCKS, use_kernel=True)
    st = api.svd_init(n, cfg, device=DEVICE)
    ingest_s, ingested = [], []
    deltas = [sparse.random_bipartite(sc["rows"], n, sc["density"],
                                      seed=31 + b, power_law=True)
              for b in range(sc["batches"])]
    reset_counts()
    for delta in deltas:
        ingested.append((st, delta))
        res = api.svd_update(st, delta, cfg)
        st = res.state
        ingest_s.append(res.diagnostics.wall_time_s)
    counts = read_counts()
    keep_counts(state, f"serve_scaled[ingest x{sc['batches']}]", counts)
    check(st.rank == sc["rank"] and torch.isfinite(st.s).all(),
          "serve_scaled: state")
    check(counts["sparse_gram"] == sc["batches"], "serve_scaled: sparse_gram "
          f"launches {counts['sparse_gram']}, want one per batch")
    gram_cases = []
    for b, (before, delta) in enumerate(ingested):
        stream_gram_case(gram_cases, f"serve_scaled batch {b}", before,
                         delta, cfg)
    del ingested
    torch.cuda.empty_cache()
    gen = torch.Generator(DEVICE).manual_seed(6)
    q = torch.randn((sc["b"], sc["rank"]), generator=gen, device=DEVICE)
    out = {}
    for name, quant in (("f32", False), ("int8", True)):
        h = api.serve_init(st, api.ServeTopKConfig(
            batch_size=sc["b"], k_top=sc["k_top"], quantize=quant))
        reset_counts()
        res = api.serve_topk(h, q)
        keep_counts(state, f"serve_scaled[{name}]", read_counts())
        check(same(res, expected_wave(h.read(), q, sc["k_top"])),
              f"serve_scaled[{name}]: differs from the plain version")
        snap = h.read()
        qs = ranker.fold_queries(snap, q)
        v = snap.v_q if quant else snap.v
        scale = snap.v_scale[:, 0].contiguous() if quant else None
        b_ms, b_by, _, _ = topk_bound(qs, v, sc["k_top"], scale)
        out[name] = dict(
            wave_ms=time_ms(lambda: api.serve_topk(h, q)),
            ms=time_ms(lambda: tk_mod.topk_score(qs, v, sc["k_top"],
                                                 scale=scale, valid_n=n)),
            plain_ms=time_ms(lambda: tk_mod.topk_score_ref(
                qs, v, sc["k_top"], scale=scale, valid_n=n), iters=2,
                warmup=1),
            library_ms=time_ms(lambda: torch.topk(
                torch.mm(qs, v.float().T) * (scale[None, :] if quant else 1.0),
                sc["k_top"]), iters=5, warmup=1),
            bound_ms=b_ms, bound_by=b_by, plan_peak_bytes=h.plan.peak_bytes)
        del h, snap, res
    emit("serve_scaled", n=n, rank=sc["rank"], batches=sc["batches"],
         batch_rows=sc["rows"], density=sc["density"],
         ingest_wall_s=ingest_s, s0=float(st.s[0]), s_last=float(st.s[-1]),
         kernel_checks=gram_cases, waves=out)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 10b: the hierarchical tree merge (backend="hierarchical", rule R2)
# ---------------------------------------------------------------------------

def tree_fields(name, res, counts, want) -> dict:
    """The launch checks of one tree solve: ``want`` maps each kernel to
    the launches the solve must make (every other kernel: none)."""
    for kname, n in counts.items():
        check(n == want.get(kname, 0),
              f"{name}: {kname} launched {n} times, want "
              f"{want.get(kname, 0)}")
    check(res.plan.backend == "hierarchical", f"{name}: backend "
          f"{res.plan.backend}")
    return diag_fields(res, counts)


def phase_hierarchical(state) -> None:
    """The tree merge on the card: the paper matrix exact (r = M) from COO
    (``sparse_gram`` leaves) and dense input (``blockgram`` leaves), D = 8,
    fanout 4 (two levels), with right vectors; the same at rank 16 against
    the same inputs and draws run on the CPU; rule R2 (``sketch=True``,
    rank 16) on the tall 32,768 x 262,144 matrix of phase 7b
    (``sketch_panel`` leaves, one launch a pass over the whole stack), held
    like phase 6's default sketch.  The tree's wide (539, 4 x 539) group
    panels are merged on ``gesvd`` through their transpose; the exact
    sparse tree is also run under torch's default driver (``gesvdj``) for
    the record (``wide_merge_driver_ab``)."""
    coo, ell = state["coo"], state["ell"]
    m, n = coo.shape
    out = {}
    base = dict(backend="hierarchical", method="neighbor_random",
                num_blocks=NUM_BLOCKS, fanout=4, use_kernel=True,
                want_right=True)
    for kind, inp, kernel in (("exact sparse", coo, "sparse_gram"),
                              ("exact dense", coo.todense(), "blockgram")):
        cfg = api.SolveConfig(**base)
        res, counts = timed_svd(inp, cfg)
        name = f"hierarchical[{kind}]"
        # the repair the solve made (the dense and the sparse checkers draw
        # their neighbor scores over different candidate sets)
        repaired = ranky.split_and_repair(
            ell if kernel == "sparse_gram"
            else api.as_block_input(inp, NUM_BLOCKS, device=DEVICE),
            NUM_BLOCKS, cfg.method, cfg.resolved_key())
        keep_counts(state, name, counts)
        fields = tree_fields(name, res, counts, {kernel: 1})
        check(res.s.shape == (m,) and res.v.shape == (n, m),
              f"{name}: S / V shape")
        fields.update(check_exact_result(name, res, repaired, NUM_BLOCKS))
        v_err = ortho_err(res.v)
        check(v_err <= 1e-4, f"{name}: |V^T V - I|_max {v_err} > 1e-4")
        res2, _ = timed_svd(inp, cfg)
        out[kind] = dict(v_ortho_err=v_err,
                         warm_wall_time_s=res2.diagnostics.wall_time_s,
                         stage_ms=stage_ms(inp, cfg), **fields)
        del res, res2, repaired
    # The wide group panels under each driver (exact sparse tree).
    committed = hierarchy.CUDA_SVD_DRIVER
    ab = {}
    try:
        for drv in (None, "gesvd"):
            hierarchy.CUDA_SVD_DRIVER = drv
            with stages.record() as times:
                r = api.svd(coo, api.SolveConfig(**base))
            ab[drv or "default"] = dict(
                u_ortho_err=ortho_err(r.u), v_ortho_err=ortho_err(r.v),
                merge_svd_ms=times["merge.svd"])
    finally:
        hierarchy.CUDA_SVD_DRIVER = committed
    out["wide_merge_driver_ab"] = ab

    # Rank 16 (truncated leaves and merges), GPU against CPU on the same
    # inputs and the port's CPU draws.
    cfg16 = api.SolveConfig(**{**base, "rank": 16})
    draws = port_draws(cfg16.resolved_key(), cfg16.method,
                       sparse.block_ell_from_coo(coo, NUM_BLOCKS,
                                                 device="cpu"))
    res, counts = timed_svd(coo, cfg16, draws=draws)
    name = "hierarchical[rank 16]"
    keep_counts(state, name, counts)
    fields = tree_fields(name, res, counts, {"sparse_gram": 1})
    t0 = time.perf_counter()
    cpu = api.svd(coo, cfg16, device="cpu",
                  draws=ranky.RepairDraws(draws.random_cols.cpu(),
                                          draws.neighbor_scores.cpu()))
    cpu_s = time.perf_counter() - t0
    ds = float((res.s.cpu() - cpu.s).abs().max())
    check(res.s.shape == (16,) and torch.isfinite(res.s).all()
          and ds <= 1e-3 * float(cpu.s[0]),
          f"{name}: GPU vs CPU max|dS| {ds} > 1e-3*S[0]")
    u_err = ortho_err(res.u)
    check(u_err <= 1e-4, f"{name}: |U^T U - I| {u_err}")
    out["rank 16"] = dict(max_abs_dS_vs_cpu=ds, dS_limit=1e-3 * float(
        cpu.s[0]), u_ortho_err=u_err, cpu_solve_s=cpu_s, s0=float(res.s[0]),
        s15=float(res.s[-1]), **fields)
    del res, cpu

    # Rule R2: sketch leaves on the tall matrix.
    tall = state.pop("tall")
    cfg_r2 = api.SolveConfig(sketch=True, rank=16, method=tall["method"],
                             num_blocks=NUM_BLOCKS)
    res, counts = timed_svd(tall["coo"], cfg_r2)
    name = "hierarchical[R2 sketch]"
    keep_counts(state, name, counts)
    passes = 1 + cfg_r2.power_iters
    fields = tree_fields(name, res, counts, {"sketch_panel": passes})
    check(res.plan.sketch_leaves and res.plan.reasons[0].startswith("R2"),
          f"{name}: plan {res.plan.reasons}")
    # Each leaf keeps its block's top 16 only, so the tree's S is never
    # above the truth (every truncation is a projection) but its lower
    # values lose what the leaves dropped, however accurate the sketch
    # (the reference's tree has the same form).  So it is held at S[0] and
    # never above the truth, and to the same solve on the CPU (the same
    # key: the same draws and Omega).
    s = res.s.double().cpu().numpy()
    s_ref = tall["s_ref"]
    rel = (s_ref[:16] - s) / s_ref[:16]
    check(np.isfinite(s).all() and rel.min() >= -1e-4 and rel[0] <= 1e-3,
          f"{name}: top-16 S above the reference or S[0] off by more than "
          f"1e-3 (relative shortfall {rel.min()} .. {rel.max()})")
    t0 = time.perf_counter()
    cpu = api.svd(tall["ell"].to("cpu"), cfg_r2, device="cpu")
    cpu_s = time.perf_counter() - t0
    ds = float((res.s.cpu() - cpu.s).abs().max())
    check(ds <= 1e-3 * float(cpu.s[0]),
          f"{name}: GPU vs CPU max|dS| {ds} > 1e-3*S[0]")
    u_err = ortho_err(res.u)
    check(u_err <= 1e-4, f"{name}: |U^T U - I| {u_err}")
    res2, _ = timed_svd(tall["ell"], cfg_r2)
    out["R2 sketch"] = dict(
        m=tall["coo"].shape[0], n=tall["coo"].shape[1],
        oversample=cfg_r2.oversample, power_iters=cfg_r2.power_iters,
        held_at="S never above the reference (scipy svds) by 1e-4, S[0] "
                "within 1e-3 of it; GPU vs CPU within 1e-3*S[0]",
        s0=float(s[0]), s15=float(s[-1]), s_ref15=float(s_ref[15]),
        max_rel_shortfall=float(rel.max()), max_abs_dS_vs_cpu=ds,
        cpu_solve_s=cpu_s, u_ortho_err=u_err,
        warm_wall_time_s_ell_input=res2.diagnostics.wall_time_s,
        stage_ms=stage_ms(tall["ell"], cfg_r2), **fields)
    del res, res2, tall
    torch.cuda.empty_cache()
    emit("hierarchical", fanout=4, num_blocks=NUM_BLOCKS,
         merge_driver=hierarchy.CUDA_SVD_DRIVER or "default", **out)


# ---------------------------------------------------------------------------
# Phase 10c: the scan-window stream driver (svd_stream, rule R6)
# ---------------------------------------------------------------------------

# The catalogue stream: 1,048,576 items, D = 8, rank 64, one batch that
# grows the rank and 48 more of 1,000-1,024 rows (the 1,024-row bucket) at
# density 5e-4; a 16 GiB budget lets R6 pick a window (its closed form
# charges every batch a dense-sized repair transient).  The paper's rows
# in dense batches of 50-64 rows at rank 16.
STREAM_WINDOW = dict(n=1_048_576, rank=64, batches=48, rows=(1000, 1024),
                     density=5e-4, budget=16 << 30)
PAPER_WINDOW = dict(rank=16, rows=(50, 64))


def sync_sites(fn):
    """(result, {"file:line": count}) of the host syncs ``fn()`` makes, as
    torch's sync debug mode reports them."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites = {}
    for w in caught:
        if "synchroniz" not in str(w.message):
            continue
        where = f"{os.path.relpath(w.filename)}:{w.lineno}"
        sites[where] = sites.get(where, 0) + 1
    return out, sites


def stream_of(batches, cfg):
    """svd_stream over ``batches``: its result."""
    return api.svd_stream(iter(batches), cfg, device=DEVICE)


def update_loop(batches, cfg):
    """svd_init and one svd_update a batch: the final state."""
    st = api.svd_init(batches[0].shape[1], cfg, device=DEVICE)
    for b in batches:
        st = api.svd_update(st, b, cfg).state
    return st


def counted(state, label, fn):
    """(fn(), host seconds), the device synchronized at both ends, with the
    launch counts of the call kept under ``label``."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    keep_counts(state, label, read_counts())
    return out, secs


def stream_case(state, name, batches, cfg, kernel) -> dict:
    """One stream three ways: ``svd_stream`` with the R6 window, with
    ``window=1`` (torch.equal to each other) and a plain ``svd_update``
    loop (within 1e-3 * S[0]); the syncs of one window and of its batches
    one by one; the measured peak of one window against R6's closed form."""
    from repro_torch.stream import window as sw

    loop_cfg = dataclasses.replace(cfg, window=1)
    sw.clear_caches()
    auto, auto_s = counted(state, f"stream_window[{name} window]",
                           lambda: stream_of(batches, cfg))
    counts_auto = sw.dispatch_counts()
    sw.clear_caches()
    loop, loop_s = counted(state, f"stream_window[{name} window=1]",
                           lambda: stream_of(batches, loop_cfg))
    counts_loop = sw.dispatch_counts()
    sw.clear_caches()
    upd, upd_s = counted(state, f"stream_window[{name} svd_update]",
                         lambda: update_loop(batches, cfg))
    # The three again in the opposite order (timing only): the first run of
    # a mode pays first-use costs (pinned host buffers, library workspaces).
    again = {}
    for mode, fn in (("svd_update", lambda: update_loop(batches, cfg)),
                     ("loop", lambda: stream_of(batches, loop_cfg)),
                     ("window", lambda: stream_of(batches, cfg))):
        _, again[mode] = counted({}, mode, fn)
    nb = len(batches) - 1                          # after the growth batch
    check(auto.plan.window > 1, f"{name}: R6 chose window "
          f"{auto.plan.window} ({auto.plan.reasons[-1]})")
    for f in ("u", "s", "v"):
        a, b = getattr(auto.state, f), getattr(loop.state, f)
        check(torch.equal(a, b), f"{name}: window=auto and window=1 differ "
              f"in {f} by {max_err(a, b)}")
    ds = float((auto.s - upd.s).abs().max())
    check(ds <= 1e-3 * float(upd.s[0]), f"{name}: window vs svd_update "
          f"max|dS| {ds} > 1e-3*S[0]")
    check((auto.state.lonely_rows_seen, auto.state.repaired_rows_seen)
          == (upd.lonely_rows_seen, upd.repaired_rows_seen),
          f"{name}: lonely / repaired counts differ from svd_update")
    for label in (f"stream_window[{name} window]",
                  f"stream_window[{name} window=1]"):
        got = state["launches_by_solve"][label][kernel]
        check(got == len(batches), f"{label}: {kernel} launched {got} "
              f"times, want one per batch ({len(batches)})")
    u_err, v_err = ortho_err(auto.state.u), ortho_err(auto.state.v)
    check(u_err <= 1e-4 and v_err <= 1e-4,
          f"{name}: |U^T U - I| {u_err}, |V^T V - I| {v_err}")

    # One more window from the final state (the batches again, one bucket,
    # the plan's length): host syncs, peak memory against R6.
    st = auto.state
    norm = [stream_state.as_delta(b, st, device="cpu") for b in batches[1:]]
    sig = sw.bucket_signature(norm[0])
    group = [x for x in norm if sw.bucket_signature(x) == sig]
    spec = api.ASpec(m=sig[1], n=st.n, nnz=api._delta_nnz_estimate(group[0]),
                     num_blocks=st.num_blocks, kind="stream")
    slots = sw.bucket_nnz_slots(sig, st.num_blocks)
    plan = api.planner.make_window_plan(spec, cfg, nnz_slots=slots)
    group = group[:plan.window]
    t_len = len(group)
    closed = api.planner.window_bytes(
        spec, cfg.truncate_rank, cfg.oversample, exact=plan.rank is None,
        window=t_len, batch_rank=plan.rank, nnz_slots=slots)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    (_, _), win_sync = sync_sites(lambda: sw.ingest_window(st, group, cfg,
                                                           plan))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    check(peak <= closed, f"{name}: one window of {t_len} batches peaked at "
          f"{peak:,}B above R6's closed form {closed:,}B")

    def one_by_one():
        s = st
        for x in group:
            s, _ = sw.ingest_window(s, [x], cfg, plan)
        return s
    _, loop_sync = sync_sites(one_by_one)
    with stages.record() as times:          # where a window's time goes
        sw.ingest_window(st, group, cfg, plan)
    window_stages = sum_stages(times)
    with stages.record() as times:
        api.svd_update(st, batches[1], cfg)
    update_stages = sum_stages(times)
    _, upd_sync = sync_sites(
        lambda: api.svd_update(st, batches[1], cfg).state)
    return dict(
        batches=len(batches), growth_batches=1,
        window=auto.plan.window, r6_reason=auto.plan.reasons[-1],
        dispatch_auto=counts_auto, dispatch_loop=counts_loop,
        bucket=list(sig), plan_peak_bytes=auto.plan.peak_bytes,
        ms_per_batch={mode: [secs / len(batches) * 1e3, again[mode]
                             / len(batches) * 1e3]
                      for mode, secs in (("window", auto_s), ("loop", loop_s),
                                         ("svd_update", upd_s))},
        max_abs_dS_vs_svd_update=ds, dS_limit=1e-3 * float(upd.s[0]),
        u_ortho_err=u_err, v_ortho_err=v_err,
        lonely_rows=auto.state.lonely_rows_seen,
        repaired_rows=auto.state.repaired_rows_seen,
        window_stage_ms=window_stages, svd_update_stage_ms=update_stages,
        measured_window=dict(batches=t_len, peak_bytes=peak,
                             r6_window_bytes=closed,
                             peak_over_closed_form=peak / closed),
        host_syncs=dict(
            window=dict(total=sum(win_sync.values()), batches=t_len,
                        sites=win_sync),
            loop=dict(total=sum(loop_sync.values()), batches=t_len,
                      sites=loop_sync),
            svd_update=dict(total=sum(upd_sync.values()), batches=1,
                            sites=upd_sync)),
        clocks="ms_per_batch: host clock around the whole stream (its host "
               "prologue included), the device synchronized at both ends; "
               "[in the order window, loop, svd_update; then in the "
               "opposite order]")


def padded_kernel_times(st, delta, cases) -> dict:
    """The kernels on one catalogue batch as its bucket pads it (rows to
    m_pad, stored columns to C_pad, slots to K_pad, all padding zero) and
    as it is: sparse_gram's padded gram is the unpadded one bit for bit
    (padded rows and columns zero), sketch_panel's padded panel the
    unpadded one in its first C columns and zero beyond; times side by
    side with the slot counts."""
    from repro_torch.stream import window as sw

    e = stream_state.as_delta(delta, st, device="cpu")
    sig = sw.bucket_signature(e)
    _, m_pad, c_pad, k_pad = sig
    ids, rows, vals = (x[0] for x in sw.build_window([e], sig,
                                                     device=DEVICE))
    e = e.to(DEVICE)
    m, (c, k) = e.m, e.capacity
    g_pad = sg_mod.sparse_gram(rows, vals, m_pad)
    g = sg_mod.sparse_gram(e.col_rows, e.col_vals, m)
    check(torch.equal(g_pad[:, :m, :m], g)
          and float(g_pad[:, m:].abs().sum()) == 0.0
          and float(g_pad[:, :, m:].abs().sum()) == 0.0,
          "sparse_gram: the bucket's padding changed the gram")
    gen = torch.Generator(DEVICE).manual_seed(8)
    omega = torch.randn((72, m_pad), device=DEVICE, generator=gen)
    p_pad = sp_mod.sketch_panel(omega, rows, vals)
    p = sp_mod.sketch_panel(omega[:, :m].contiguous(), e.col_rows,
                            e.col_vals)
    check(torch.equal(p_pad[:, :, :c], p)
          and float(p_pad[:, :, c:].abs().sum()) == 0.0,
          "sketch_panel: the bucket's padding changed the panel")
    cases.append(dict(kernel="sparse_gram", case="catalogue batch, padded "
                      "bucket vs unpadded", max_abs_err=0.0, limit=0.0))
    cases.append(dict(kernel="sketch_panel", case="catalogue batch, padded "
                      "bucket vs unpadded", max_abs_err=0.0, limit=0.0))
    slots = dict(padded=int(rows.numel()), unpadded=int(e.col_rows.numel()),
                 nonzero=int((e.col_vals != 0).sum()))
    out = dict(bucket=list(sig), unpadded_capacity=[m, c, k], slots=slots,
               padded_over_unpadded_slots=slots["padded"]
               / slots["unpadded"])
    for kname, fp, fu in (
            ("sparse_gram", lambda: sg_mod.sparse_gram(rows, vals, m_pad),
             lambda: sg_mod.sparse_gram(e.col_rows, e.col_vals, m)),
            ("sketch_panel", lambda: sp_mod.sketch_panel(omega, rows, vals),
             lambda: sp_mod.sketch_panel(omega[:, :m].contiguous(),
                                         e.col_rows, e.col_vals))):
        tp, tu = time_ms(fp), time_ms(fu)
        out[kname] = dict(padded_ms=tp, unpadded_ms=tu,
                          padded_over_unpadded=tp / tu,
                          padded_device_ms=device_ms(fp),
                          unpadded_device_ms=device_ms(fu))
    return out


def phase_stream_window(state) -> None:
    """svd_stream on the card: (a) the catalogue continued from
    ``serve_scaled`` at rank 64 in ELL batches (``sparse_gram`` a step),
    (b) the paper's rows in dense batches at rank 16 (``blockgram`` a
    step); each window=auto against window=1 (the same bits) and against a
    plain svd_update loop."""
    sc = STREAM_WINDOW
    rng = np.random.default_rng(77)
    t0 = time.perf_counter()
    sizes = [1024] + [int(x) for x in rng.integers(sc["rows"][0],
                                                   sc["rows"][1] + 1,
                                                   sc["batches"])]
    cat = [sparse.random_bipartite(r, sc["n"], sc["density"], seed=500 + b,
                                   power_law=True)
           for b, r in enumerate(sizes)]
    t_gen = time.perf_counter() - t0
    cfg = api.SolveConfig(method="neighbor_random", truncate_rank=sc["rank"],
                          num_blocks=NUM_BLOCKS, use_kernel=True,
                          memory_budget_bytes=sc["budget"])
    cases = state["kernel_cases"]
    out = dict(catalogue=stream_case(state, "catalogue", cat, cfg,
                                     "sparse_gram"))
    st = api.svd_init(sc["n"], cfg, device=DEVICE)
    st = api.svd_update(st, cat[0], cfg).state
    out["catalogue"]["padding"] = padded_kernel_times(st, cat[1], cases)
    out["catalogue"]["host_generate_s"] = t_gen
    del cat, st
    torch.cuda.empty_cache()

    coo = state["coo"]
    m = coo.shape[0]
    bounds, lo = [0], 0
    while lo < m:
        lo = min(m, lo + (64 if lo == 0 else int(rng.integers(
            PAPER_WINDOW["rows"][0], PAPER_WINDOW["rows"][1] + 1))))
        bounds.append(lo)
    paper = [coo_rows(coo, a, b).todense() for a, b in zip(bounds, bounds[1:])]
    cfg = api.SolveConfig(method="neighbor_random",
                          truncate_rank=PAPER_WINDOW["rank"],
                          num_blocks=NUM_BLOCKS, use_kernel=True)
    out["paper_dense"] = stream_case(state, "paper dense", paper, cfg,
                                     "blockgram")
    out["paper_dense"]["batch_rows"] = list(np.diff(bounds).tolist())
    emit("stream_window", **out)
    torch.cuda.empty_cache()


MERGE_AB_SEEDS = (2020, 2021, 2022)


def run_stream(coo, cfg, bounds):
    """svd_init + one svd_update per row range; (state, merge.svd ms per
    batch)."""
    st = api.svd_init(coo.shape[1], cfg, device=DEVICE)
    merge_ms = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        with stages.record() as times:
            st = api.svd_update(st, coo_rows(coo, int(lo), int(hi)),
                                cfg).state
        merge_ms.append(times["merge.svd"][0])
    return st, merge_ms


def phase_merge_driver_ab(state) -> None:
    """The merge SVD's cuSOLVER driver, torch's default (``gesvdj``)
    against ``gesvd``, in one run: for paper-shaped matrices from three
    seeds, the exact stream (4 batches, full rank) and the user stream
    (batches of 64, rank 16) under each driver, the order of the drivers
    alternating from seed to seed.  Records ||U^T U - I||, ||V^T V - I||,
    the exact stream's max|dS| against float64, and merge.svd per batch.
    The committed driver (``hierarchy.CUDA_SVD_DRIVER``) is held to 1e-4;
    the other is only recorded."""
    committed = hierarchy.CUDA_SVD_DRIVER
    drivers = (None, "gesvd")
    warm = torch.randn((170_904, 40), device=DEVICE)
    for drv in drivers:                # cuSOLVER handles and workspaces
        torch.linalg.svd(warm, full_matrices=False, driver=drv)
    del warm
    runs = []
    try:
        for i, seed in enumerate(MERGE_AB_SEEDS):
            coo = bipartite.paper_coo(RankyPaperConfig(seed=seed))
            m, n = coo.shape
            ell = sparse.block_ell_from_coo(coo, NUM_BLOCKS, device=DEVICE)
            s_ref = reference_svals(ranky.split_and_repair(
                ell, NUM_BLOCKS, "none"), NUM_BLOCKS)
            del ell
            exact_cfg = api.SolveConfig(method="none", truncate_rank=m,
                                        num_blocks=NUM_BLOCKS,
                                        use_kernel=True)
            user_cfg = api.SolveConfig(method="neighbor_random",
                                       truncate_rank=16, oversample=8,
                                       num_blocks=NUM_BLOCKS,
                                       use_kernel=True)
            exact_bounds = np.linspace(0, m, 5).astype(int)
            user_bounds = list(range(0, m, STREAM_BATCH_ROWS)) + [m]
            for drv in (drivers if i % 2 == 0 else drivers[::-1]):
                hierarchy.CUDA_SVD_DRIVER = drv
                st, ex_ms = run_stream(coo, exact_cfg, exact_bounds)
                ex = dict(u_ortho_err=ortho_err(st.u),
                          v_ortho_err=ortho_err(st.v),
                          max_abs_dS=float((st.s.double() - s_ref)
                                           .abs().max()),
                          merge_svd_ms=ex_ms)
                st, us_ms = run_stream(coo, user_cfg, user_bounds)
                us = dict(u_ortho_err=ortho_err(st.u),
                          v_ortho_err=ortho_err(st.v), merge_svd_ms=us_ms)
                runs.append(dict(seed=seed, driver=drv or "default",
                                 exact=ex, user=us))
    finally:
        hierarchy.CUDA_SVD_DRIVER = committed
    summary = {}
    for drv in drivers:
        mine = [r for r in runs if r["driver"] == (drv or "default")]
        summary[drv or "default"] = {
            f"{kind}_{what}": max(r[kind][f"{what}_ortho_err"] for r in mine)
            for kind in ("exact", "user") for what in ("u", "v")}
        summary[drv or "default"].update(
            exact_merge_svd_ms_total=sum(sum(r["exact"]["merge_svd_ms"])
                                         for r in mine),
            user_merge_svd_ms_total=sum(sum(r["user"]["merge_svd_ms"])
                                        for r in mine))
    worst = max(v for k, v in summary[committed or "default"].items()
                if k.endswith(("_u", "_v")))
    check(worst <= 1e-4, f"merge_driver_ab: the committed driver "
          f"{committed or 'default'} reaches |X^T X - I| {worst} > 1e-4")
    emit("merge_driver_ab", committed=committed or "default",
         seeds=list(MERGE_AB_SEEDS), worst_ortho_err_and_ms=summary,
         runs=runs, ortho_limit=1e-4)


# ---------------------------------------------------------------------------
# Phase 12: LM serving of zamba2-2.7b at full width
# ---------------------------------------------------------------------------

def synced_ms(fn):
    """(result, host ms) of ``fn()`` between two device synchronizations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def profile_prefill(cfg, params, batch) -> dict:
    """Device time by kernel over one warm prefill (``torch.profiler``):
    the kernels' own records only (the operators that launch them carry
    the same time again and are left out), the ten largest, the port's
    two kernels wherever they rank (``port_kernels``), and their sum,
    beside the wall of that same profiled prefill (host clock between two
    synchronizations) and the busy share, their ratio; ``kernel_ms_total``
    is None where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_ms = synced_ms(
            lambda: transformer.prefill_forward(cfg, params, batch))
    rows, other = [], {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
        if ev.key.startswith("Command Buffer"):   # a CUPTI record, no kernel
            other[ev.key] = dict(device_ms=dev, count=ev.count)
        elif dev > 0:
            rows.append((dev, ev.key, ev.count))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows) if rows else None
    return dict(kernel_ms_total=total, profiled_wall_ms=wall_ms,
                busy_share_of_profiled_wall=(total / wall_ms if rows
                                             else None),
                kernels=len(rows), other_records=other,
                top=[dict(name=k[:80], device_ms=ms, calls=n)
                     for ms, k, n in rows[:10]],
                port_kernels=[dict(name=k[:80], device_ms=ms, calls=n)
                              for ms, k, n in rows
                              if "attn_kernel" in k or "ssd_kernel" in k])


def lm_requests(cfg, n: int, seed: int = 0):
    """Requests of 2-11 tokens, as ``launch/serve.py`` makes them."""
    rng = np.random.default_rng(seed)
    return [list(rng.integers(1, cfg.vocab_size, size=rng.integers(2, 12)))
            for _ in range(n)]


def phase_lm_serve(state) -> None:
    torch.cuda.empty_cache()
    cfg = get_config(LM_ARCH)
    pf, ck, rq = LM_PREFILL, LM_CHECK, LM_REQUESTS
    gen = torch.Generator(DEVICE).manual_seed(0)
    params, init_ms = synced_ms(lambda: schema.init_params(cfg, gen, DEVICE))
    n_params = schema.param_count_actual(params)
    check(n_params >= cfg.param_count(),
          f"lm_serve: {n_params} parameters < the config's {cfg.param_count()}")
    tokens = torch.randint(0, cfg.vocab_size, (pf["batch"], pf["seq"]),
                           generator=gen, device=DEVICE)
    batch = {"tokens": tokens}
    max_seq = pf["seq"] + pf["decode"]

    # (a) the main path: prefill through both kernels, then greedy decode
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    (logits, cache), prefill_ms = synced_ms(
        lambda: transformer.prefill_forward(cfg, params, batch,
                                            max_seq=max_seq))
    counts = read_counts()
    keep_counts(state, "lm_serve[prefill]", counts)
    groups = cfg.num_layers // cfg.hybrid_attn_every
    check(counts["flash_attention"] == groups and
          counts["ssd_scan"] == cfg.num_layers,
          f"lm_serve: a prefill launched flash_attention "
          f"{counts['flash_attention']} times (want {groups}) and ssd_scan "
          f"{counts['ssd_scan']} times (want {cfg.num_layers})")
    check(logits.shape == (pf["batch"], cfg.padded_vocab)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()),
          "lm_serve: prefill logits not finite (B, Vp) float32")
    check(cache["len"] == pf["seq"] and cache["k"].dtype == torch.bfloat16,
          "lm_serve: prefill cache")
    reset_counts()
    out_tokens = []

    def decode_all():
        nonlocal logits, cache
        for _ in range(pf["decode"]):
            tok = engine.sample(cfg, logits, 0.0, gen)
            out_tokens.append(tok)
            logits, cache = transformer.decode_step(
                cfg, params, cache, {"tokens": tok[:, None]})

    _, decode_ms = synced_ms(decode_all)
    decode_counts = read_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    toks = torch.stack(out_tokens, dim=1)
    check(bool(torch.isfinite(logits).all()), "lm_serve: decode logits")
    check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
          "lm_serve: decoded tokens outside the vocab")
    check(cache["len"] == max_seq, "lm_serve: cache length after decode")
    _, warm_prefill_ms = synced_ms(
        lambda: transformer.prefill_forward(cfg, params, batch,
                                            max_seq=max_seq))
    del cache, logits
    prof = profile_prefill(cfg, params, batch)

    # a long prefill: s * s = 3000**2 is past the 2048**2 at which the
    # reference leaves its kernel; the port's kernels take every length
    long_tokens = torch.randint(0, cfg.vocab_size,
                                (LM_LONG["batch"], LM_LONG["seq"]),
                                generator=gen, device=DEVICE)
    reset_counts()
    (long_logits, long_cache), long_ms = synced_ms(
        lambda: transformer.prefill_forward(cfg, params,
                                            {"tokens": long_tokens}))
    lcounts = read_counts()
    keep_counts(state, "lm_serve[long prefill]", lcounts)
    check(lcounts["flash_attention"] == groups
          and lcounts["ssd_scan"] == cfg.num_layers,
          f"lm_serve: the long prefill launched flash_attention "
          f"{lcounts['flash_attention']} times (want {groups}) and ssd_scan "
          f"{lcounts['ssd_scan']} times (want {cfg.num_layers})")
    check(long_logits.shape == (LM_LONG["batch"], cfg.padded_vocab)
          and bool(torch.isfinite(long_logits).all())
          and long_cache["len"] == LM_LONG["seq"],
          "lm_serve: long prefill logits not finite or cache length wrong")
    del long_logits, long_cache
    main_fields = dict(
        prompts=pf["batch"], prompt_tokens=pf["seq"],
        decode_steps=pf["decode"], dtype=cfg.dtype,
        init_params_ms=init_ms, params=n_params,
        launches_per_prefill=dict(flash_attention=counts["flash_attention"],
                                  ssd_scan=counts["ssd_scan"]),
        launches_in_decode=decode_counts,
        prefill_ms_first=prefill_ms, prefill_ms_warm=warm_prefill_ms,
        prefill_tokens_per_s=pf["batch"] * pf["seq"] / warm_prefill_ms * 1e3,
        decode_ms_per_step=decode_ms / pf["decode"],
        decode_tokens_per_s=pf["batch"] * pf["decode"] / decode_ms * 1e3,
        peak_memory_bytes=peak_bytes, prefill_profile=prof,
        long_prefill=dict(prompts=LM_LONG["batch"],
                          prompt_tokens=LM_LONG["seq"], ms=long_ms,
                          tokens_per_s=LM_LONG["batch"] * LM_LONG["seq"]
                          / long_ms * 1e3,
                          launches=dict(
                              flash_attention=lcounts["flash_attention"],
                              ssd_scan=lcounts["ssd_scan"])))

    # (b) the kernels inside the model, float32: whole-prompt prefill
    # (both kernels) against the engine's token-by-token prefill (none)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    toks32 = torch.randint(0, cfg.vocab_size, (ck["batch"], ck["seq"]),
                           generator=gen, device=DEVICE)
    reset_counts()
    (lg_k, c_k), check_prefill_ms = synced_ms(
        lambda: transformer.prefill_forward(cfg32, params,
                                            {"tokens": toks32}))
    kcounts = read_counts()
    check(kcounts["flash_attention"] == groups
          and kcounts["ssd_scan"] == cfg.num_layers,
          f"lm_serve[check]: the float32 prefill launched {kcounts}")
    reset_counts()
    (c_d, lg_d), steps_ms = synced_ms(
        lambda: engine.prefill_cache(cfg32, params, toks32,
                                     engine.ServeConfig(max_seq=ck["seq"])))
    dcounts = read_counts()
    check(dcounts["flash_attention"] == 0 and dcounts["ssd_scan"] == 0,
          f"lm_serve[check]: decode steps launched {dcounts}")
    def against_steps(lg, c):
        out = {}
        for key, got, want in [("logits", lg, lg_d)] + [
                (k, c[k], c_d[k]) for k in ("conv", "ssm", "k", "v")]:
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"lm_serve[check]: {key} shape/dtype")
            err = max_err(got, want)
            top = float(want.abs().max())
            out[key] = dict(max_abs_err=err, limit=ck["rel"] * top,
                            max_abs=top, err_over_max=err / top)
        return out

    errs = against_steps(lg_k, c_k)
    for key, e in errs.items():
        check(e["max_abs_err"] <= e["limit"],
              f"lm_serve[check]: {key} max abs err {e['max_abs_err']} > "
              f"{e['limit']} (prefill_forward vs prefill_cache, float32)")
    del c_k, lg_k

    # The control: the same float32 prefill with both kernels fed inputs
    # rounded through bf16, as a kernel that computed in bf16 would be.
    # It must exceed the limit, or the limit could not tell such a kernel.
    def rounded(fn):
        def wrap(*args, **kw):
            return fn(*(t.bfloat16().float() for t in args), **kw)
        return wrap

    saved = kernel_ops.flash_attention, kernel_ops.ssd_scan
    kernel_ops.flash_attention, kernel_ops.ssd_scan = map(rounded, saved)
    try:
        lg_r, c_r = transformer.prefill_forward(cfg32, params,
                                                {"tokens": toks32})
    finally:
        kernel_ops.flash_attention, kernel_ops.ssd_scan = saved
    control = against_steps(lg_r, c_r)
    check(any(e["max_abs_err"] > e["limit"] for e in control.values()),
          f"lm_serve[check]: the bf16-rounded control stays within the "
          f"limit {ck['rel']} of max, which therefore cannot tell it: "
          f"{control}")
    del c_d, lg_d, c_r, lg_r

    # (c) the engine: short requests, greedy and sampled
    reqs = lm_requests(cfg, rq["requests"])
    prompts_np, lens = engine.batch_requests(reqs)
    prompts = torch.from_numpy(prompts_np).to(DEVICE)
    scfg = engine.ServeConfig(max_seq=prompts.shape[1] + rq["tokens"])
    greedy, greedy_ms = synced_ms(
        lambda: engine.generate(cfg, params, prompts, scfg, rq["tokens"]))
    greedy2 = engine.generate(cfg, params, prompts, scfg, rq["tokens"])
    check(torch.equal(greedy, greedy2), "lm_serve: greedy generation is not "
          "deterministic")
    hot = engine.ServeConfig(max_seq=scfg.max_seq,
                             temperature=rq["temperature"])
    sampled = [engine.generate(cfg, params, prompts, hot, rq["tokens"],
                               generator=torch.Generator(DEVICE)
                               .manual_seed(7)) for _ in range(2)]
    check(torch.equal(sampled[0], sampled[1]),
          "lm_serve: sampling from one seed is not repeatable")
    for out in (greedy, sampled[0]):
        check(out.shape == (rq["requests"], rq["tokens"])
              and out.dtype == torch.int32 and int(out.min()) >= 0
              and int(out.max()) < cfg.vocab_size,
              "lm_serve: generated tokens")
    del params
    torch.cuda.empty_cache()
    emit("lm_serve", arch=LM_ARCH, layers=cfg.num_layers,
         d_model=cfg.d_model, main=main_fields,
         check=dict(batch=ck["batch"], prompt_tokens=ck["seq"],
                    dtype="float32", rel_limit=ck["rel"],
                    prefill_forward_ms=check_prefill_ms,
                    prefill_cache_ms=steps_ms, errors=errs,
                    bf16_rounded_control=control),
         generate=dict(requests=rq["requests"], prompt_lens=lens.tolist(),
                       tokens=rq["tokens"], greedy_ms=greedy_ms,
                       greedy_tokens_per_s=rq["requests"] * rq["tokens"]
                       / greedy_ms * 1e3,
                       sampled_differs_from_greedy=not torch.equal(
                           greedy, sampled[0])),
         clocks="host clock between device synchronizations; "
                "prefill_ms_first includes first-call cuBLAS set-up")


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
         allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 must be off for matrix products")
    check(torch.backends.cudnn.allow_tf32 is False,
          "TF32 must be off for cuDNN")

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
                  phase_solve_scaled, phase_stream_exact, phase_stream_serve,
                  phase_serve_scaled, phase_hierarchical, phase_stream_window,
                  phase_merge_driver_ab, phase_lm_serve):
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
            **{key: value for key, value in state["kernel_main"][name]
               .items() if key != "checked"}))
    emit("stage_summary", **state["stage_summary"])
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
