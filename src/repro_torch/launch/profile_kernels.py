"""Profile six kernels on one GPU: ``flash_attention``, ``topk_score``,
``ssd_scan``, ``blockgram``, ``sparse_gram`` and ``sketch_panel``, with
what ptxas says of every kernel's registers.

  python3 src/repro_torch/launch/profile_kernels.py [--src DIR] [--out FILE]
      [--only flash,topk,ssd,blockgram,sgram,sketch] [--no-ptxas]

``--src`` is the ``src`` directory whose ``repro_torch`` is measured (the
default is this checkout's), so one call can profile two trees of the port
side by side.  Prints one JSON object: the card (``nvidia-smi`` name and
power limit); for every kernel function of ``csrc/*.cu`` the registers,
shared memory, stack and spills that ``nvcc -Xptxas -v`` reports (unless
``--no-ptxas``); for
``flash_attention`` the device time (CUDA events, cold L2, median of 10),
the achieved TFLOP/s over the pairs the mask shows and SDPA's time on the
same inputs; for ``topk_score`` the device time of each of its kernels by
name (``torch.profiler``, a call's share of 10 warm calls) beside the whole
call's time and ``torch.mm`` + ``torch.topk``'s; for ``ssd_scan`` the
device time (CUDA events, cold L2, median of 10) at zamba2's prefill shape
x (8, 1024, 80, 64), G 1, N 64 in bf16 and float32 and at its long prompt
(2, 3000, 80, 64) in bf16, its bound and the achieved TFLOP/s over the
recurrence's operations (``ssd_scan.work`` of this checkout, whichever
tree is measured, so that two trees are held to one yardstick), and the
worst error of a smaller call against ``ssd_scan_ref`` over its limit
(<= 1 holds); for ``blockgram`` the same at the dense solve's shape (8,
539, 21363) for 0/1, gaussian float32 and bf16 input, beside ``torch.bmm``
and the bound of this checkout's ``blockgram.work`` at ``chip_smoke.py``'s
``products``, errors against ``chip_smoke.gram_f64`` (float64 sums); for
``sparse_gram`` (``sgram``) the device time at the paper's ELL (8, 5096,
5), M 539, and at ``chip_smoke.py``'s 2048 x 1,048,576 ELL (8, 84104, 8),
each 0/1 and weighted, beside ``chip_smoke.sparse_gram_bound`` and one
``torch.sparse.mm`` of the block-diagonal CSR of the stored columns by its
transpose (``chip_smoke.ell_blockdiag_csr``: cuSPARSE SpGEMM, the CSRs
built outside the timed window), with the device kernels of a call, the error against ``chip_smoke.sparse_gram_f64``
(a float64 sum) and whether 10 calls give the same bits; for
``sketch_panel`` (``sketch``) the same at the paper's ELL with Omega (24,
539) and at the 32,768 x 262,144 ELL (8, 32768, 36) with Omega (64,
32768), each Omega (L, M)-contiguous and as the transpose of an
(M, L)-contiguous tensor, beside ``chip_smoke.sketch_panel_bound`` and one
``torch.sparse.mm`` of the block-stacked (D*C, M) CSR by Omega^T
(cuSPARSE; the CSR built outside the timed window).  The inputs of the two
sparse kernels come from this checkout's generators and seeds
(``chip_smoke.py``'s).  ``--only`` times a subset of the kernels.  Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
PEAK = {torch.bfloat16: 989e12, torch.float32: 67e12}


def _time_ms(fn, iters=10, warmup=2):
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def ptxas_report(csrc):
    """{source: [{kernel, registers, smem_bytes, stack_bytes,
    spill_bytes}]} from ``nvcc -Xptxas -v`` (one throw-away object per
    source, all compiled at once)."""
    from repro_torch.kernels import build
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        srcs = sorted(s for s in os.listdir(csrc) if s.endswith(".cu"))
        procs = [subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             os.path.join(csrc, src), "-o", os.path.join(tmp, src + ".o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in srcs]
        for src, proc in zip(srcs, procs):
            text, _ = proc.communicate()
            rows, name, stack, spill = [], None, 0, 0
            for line in text.splitlines():
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    name, stack, spill = m.group(1), 0, 0
                    continue
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores", line)
                if m and name:
                    stack, spill = int(m.group(1)), int(m.group(2))
                m = re.search(r"Used (\d+) registers", line)
                if m and name:
                    sm = re.search(r"(\d+) bytes smem", line)
                    rows.append(dict(kernel=name[:90],
                                     registers=int(m.group(1)),
                                     smem_bytes=int(sm.group(1)) if sm else 0,
                                     stack_bytes=stack, spill_bytes=spill))
                    name = None
            out[src] = rows if proc.returncode == 0 else text[-2000:]
    return out


def flash_rows(fa):
    gen = torch.Generator("cuda").manual_seed(21)
    rows = []
    for (b, hq, hkv, sq, sk, d), kw in (
            ((8, 32, 32, 1024, 1024, 80), dict(causal=True)),
            ((2, 32, 32, 3000, 3000, 80), dict(causal=True)),
            ((1, 4, 2, 300, 300, 128), dict(causal=False))):
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((b, hq, sq, d), generator=gen,
                            device="cuda").to(dtype)
            k = torch.randn((b, hkv, sk, d), generator=gen,
                            device="cuda").to(dtype)
            v = torch.randn((b, hkv, sk, d), generator=gen,
                            device="cuda").to(dtype)
            pairs = sq * sk
            if kw["causal"]:
                pairs = sum(min(sk, i + 1 + sk - sq) for i in range(sq))
            flops = 4.0 * b * hq * d * pairs
            ms = _time_ms(lambda: fa.flash_attention(q, k, v, **kw))
            kk = k.repeat_interleave(hq // hkv, 1)
            vv = v.repeat_interleave(hq // hkv, 1)
            lib = _time_ms(lambda: torch.nn.functional
                           .scaled_dot_product_attention(
                               q, kk, vv, is_causal=kw["causal"]))
            nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
            rows.append(dict(
                shape=[b, hq, hkv, sq, sk, d], dtype=str(dtype)[6:], **kw,
                ms=ms, tflops=flops / ms / 1e9, sdpa_ms=lib,
                bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / PEAK[dtype])
                * 1e3))
    return rows


def topk_rows(tk):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator("cuda").manual_seed(12)
    rows = []
    for b, k, n, k_top in ((32, 16, 170_904, 10),
                           (256, 64, 1_048_576, 100)):
        qs = torch.randn((b, k), generator=gen, device="cuda")
        vf = torch.randn((n, k), generator=gen, device="cuda")
        amax = vf.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
        vq = torch.round(vf / amax * 127).to(torch.int8)
        sc = (amax[:, 0] / 127).contiguous()
        for tag, v, scale in (("f32", vf, None), ("int8", vq, sc)):
            call = lambda: tk.topk_score(qs, v, k_top, scale=scale)  # noqa
            ms = _time_ms(call)
            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call()
                torch.cuda.synchronize()
            passes = {}
            for ev in prof.key_averages():
                if ev.device_type == DeviceType.CUDA and "topk" in ev.key:
                    t = getattr(ev, "self_device_time_total",
                                getattr(ev, "self_cuda_time_total", 0.0))
                    passes[ev.key[:60]] = t / 1e3 / 10
            lib = _time_ms(lambda: torch.topk(
                torch.mm(qs, v.float().T) * (scale[None, :] if scale
                                             is not None else 1.0), k_top))
            flops = 2.0 * b * n * k
            rows.append(dict(b=b, k=k, n=n, k_top=k_top, v=tag, ms=ms,
                             pass_ms=passes, library_ms=lib,
                             tflops=flops / ms / 1e9,
                             bound_ms=max(v.numel() * v.element_size()
                                          / HBM_BYTES_PER_S,
                                          flops / 67e12) * 1e3))
    return rows


def _ssd_inputs(b, seq, h, g, p, n, dtype, gen):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = randn(b, seq, h, p).to(dtype)
    dt = (torch.nn.functional.softplus(randn(b, seq, h)) * 0.1).to(dtype)
    a = -torch.exp(randn(h))
    bm = (randn(b, seq, g, n) / n ** 0.5).to(dtype)
    cm = (randn(b, seq, g, n) / n ** 0.5).to(dtype)
    return x, dt, a, bm, cm


def _ssd_worst(ss, gen, dtype):
    """Worst |kernel - plain| over chip_smoke's limit at (2, 1000, 80, 64),
    G 1, N 64 (ragged last chunk): y at 1 bf16 ulp of |plain| + 1e-4 max
    (bf16) or 1e-4 max (float32), the state at 1e-4 max."""
    args = _ssd_inputs(2, 1000, 80, 1, 64, 64, dtype, gen)
    (y, hf), (yr, hr) = ss.ssd_scan(*args), ss.ssd_scan_ref(*args)
    torch.cuda.synchronize()
    tol = 1e-4 * float(yr.float().abs().max())
    if dtype == torch.bfloat16:
        _, e = torch.frexp(yr.float().abs())
        tol = torch.where(yr == 0, 0.0, torch.ldexp(
            torch.ones_like(yr, dtype=torch.float32), e - 8)) + tol
    wy = float(((y.float() - yr.float()).abs() / tol).max())
    wh = float((hf - hr).abs().max()) / (1e-4 * float(hr.abs().max()))
    return max(wy, wh)


def ssd_rows(ss, work):
    gen = torch.Generator("cuda").manual_seed(22)
    rows = []
    for dtype, shapes in ((torch.bfloat16, [(8, 1024, 80, 1, 64, 64),
                                            (2, 3000, 80, 1, 64, 64)]),
                          (torch.float32, [(8, 1024, 80, 1, 64, 64)])):
        worst = _ssd_worst(ss, gen, dtype)
        for shape in shapes:
            args = _ssd_inputs(*shape, dtype, gen)
            ms = _time_ms(lambda: ss.ssd_scan(*args))
            nbytes, flops = work(*shape, args[0].element_size())
            rows.append(dict(
                shape=list(shape), dtype=str(dtype)[6:], ms=ms,
                tflops=flops / ms / 1e9,
                bound_ms=max(nbytes / HBM_BYTES_PER_S,
                             flops / PEAK[dtype]) * 1e3,
                worst_err_over_limit=worst))
            del args
    return rows


def blockgram_rows(bg, work, products, gram_f64):
    """``blockgram`` at the dense solve's shape (8, 539, 21363): 0/1 values
    at the paper matrix's density (5e-4), gaussian float32 and the same
    rounded to bf16.  Each: device time (CUDA events, cold L2, median of
    10), ``torch.bmm``'s time on the same float32 values, the bound from
    this checkout's ``work`` at the tensor-core rate over ``products``
    bf16 products (or the float32 rate if higher), the errors of the
    kernel and of ``torch.bmm`` against ``gram_f64`` (float64 sums)
    beside chip_smoke's limit (0 for 0/1, else 1e-5 of max|G|), and
    whether two calls give the same bits."""
    gen = torch.Generator("cuda").manual_seed(31)
    shape = (8, 539, 21363)
    gauss = torch.randn(shape, generator=gen, device="cuda")
    cases = (("0/1 at density 5e-4",
              (torch.rand(shape, generator=gen, device="cuda") < 5e-4)
              .float()),
             ("gaussian f32", gauss),
             ("gaussian bf16", gauss.to(torch.bfloat16)))
    rows = []
    for tag, a in cases:
        got = bg.blockgram(a)
        want = gram_f64(a)
        a32 = a.float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        bmm_err = float((torch.bmm(a32, a32.mT) - want).abs().max())
        limit = 0.0 if tag.startswith("0/1") else \
            1e-5 * float(want.abs().max())
        t = products(a)
        nbytes, flops = work(*shape, a.element_size())
        ms = _time_ms(lambda: bg.blockgram(a))
        rows.append(dict(
            case=tag, shape=list(shape), dtype=str(a.dtype)[6:], ms=ms,
            tflops=flops / ms / 1e9, products=t,
            bound_ms=max(nbytes / HBM_BYTES_PER_S,
                         flops / max(PEAK[torch.float32],
                                     PEAK[torch.bfloat16] / t)) * 1e3,
            bmm_ms=_time_ms(lambda: torch.bmm(a32, a32.mT)),
            max_abs_err=err, bmm_max_abs_err=bmm_err, limit=limit,
            bit_stable=bool(torch.equal(got, bg.blockgram(a))),
            symmetric=bool(torch.equal(got, got.mT))))
        del got, want, a32
    return rows


def _sparse_inputs(cs, which):
    """``chip_smoke.py``'s ELL inputs: "paper" (the paper matrix, 0/1,
    and its weighted twin), "a" (2048 x 1,048,576, 0/1) or "b" (32,768 x
    262,144), each as (rows, vals, m)."""
    if which == "paper":
        cfg = cs.RankyPaperConfig()
        coo = cs.bipartite.paper_coo(cfg)
        wcoo = cs.sparse.random_bipartite(cfg.rows, cfg.cols, cfg.density,
                                          seed=cfg.seed, weighted=True)
        return [cs.sparse.block_ell_from_coo(x, cs.NUM_BLOCKS, device="cuda")
                for x in (coo, wcoo)]
    m, n = cs.SCALED_EXACT if which == "a" else cs.SCALED_TALL
    coo = cs.scaled_coo(m, n, 5e-4, seed=11 if which == "a" else 12)
    return [cs.sparse.block_ell_from_coo(coo, cs.NUM_BLOCKS, device="cuda")]


def sgram_rows(sg, cs):
    """``sparse_gram`` at the paper's shape (0/1, weighted) and at (a)
    (0/1, seeded weights in (0.5, 2) on the non-zero slots): device time,
    bound, device kernels a call, error against a float64 sum over
    chip_smoke's limit (0 for 0/1 data, else 1e-5 of max|G|), the same bits
    over 10 calls, exact symmetry."""
    paper, wpaper = _sparse_inputs(cs, "paper")
    (big,) = _sparse_inputs(cs, "a")
    cases = [("paper 0/1", paper.col_rows, paper.col_vals, paper.m),
             ("paper weighted", wpaper.col_rows, wpaper.col_vals, paper.m),
             ("(a) 0/1", big.col_rows, big.col_vals, big.m),
             ("(a) weights in (0.5, 2)", big.col_rows,
              cs.reweighted(big.col_vals, 13), big.m)]
    rows = []
    for tag, r, v, m in cases:
        got = sg.sparse_gram(r, v, m)
        want = cs.sparse_gram_f64(r, v, m)
        torch.cuda.synchronize()
        exact = bool(((v == 0) | (v == 1)).all())
        limit = 0.0 if exact else 1e-5 * float(want.abs().max())
        err = float((got - want).abs().max())
        stable = all(torch.equal(got, sg.sparse_gram(r, v, m))
                     for _ in range(10))
        b_ms, b_by = cs.sparse_gram_bound(r, v, m)
        e, et = cs.ell_blockdiag_csr(r, v, m)
        lib_ms = _time_ms(lambda: torch.sparse.mm(e, et))
        del e, et
        rows.append(dict(
            case=tag, shape=list(r.shape), m=m,
            ms=_time_ms(lambda: sg.sparse_gram(r, v, m)),
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            device_kernels=cs.device_kernels_per_call(
                lambda: sg.sparse_gram(r, v, m)),
            kernel_ms=cs.device_ms_by_kernel(lambda: sg.sparse_gram(r, v, m)),
            max_abs_err=err, limit=limit, bit_stable_10=stable,
            symmetric=bool(torch.equal(got, got.mT))))
        del got, want
    return rows


def sketch_rows(sp, cs):
    """``sketch_panel`` at the paper's shape (Omega (24, 539)) and at (b)
    (Omega (64, 32768), K = 36), Omega (L, M)-contiguous and as the
    transpose of an (M, L)-contiguous tensor: device time, bound, the
    cuSPARSE yardstick, device kernels a call, error against the plain
    version over 1e-5 of its max, the same bits over 10 calls."""
    paper, _ = _sparse_inputs(cs, "paper")
    (tall,) = _sparse_inputs(cs, "b")
    gen = torch.Generator("cuda").manual_seed(3)
    rows = []
    for tag, ell, l in (("paper", paper, 24), ("(b)", tall, 64)):
        omega = torch.randn((l, ell.m), generator=gen, device="cuda")
        csr = cs.ell_csr(ell.col_rows, ell.col_vals, ell.m)
        for layout, om in (("(L, M)", omega),
                           ("(M, L) transposed", omega.T.contiguous().T)):
            r, v = ell.col_rows, ell.col_vals
            got = sp.sketch_panel(om, r, v)
            want = sp.sketch_panel_ref(om, r, v)
            torch.cuda.synchronize()
            b_ms, b_by = cs.sketch_panel_bound(om, r, v)
            rows.append(dict(
                case=f"{tag} omega {tuple(om.shape)} {layout}",
                shape=list(r.shape),
                ms=_time_ms(lambda: sp.sketch_panel(om, r, v)),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=_time_ms(lambda: torch.sparse.mm(csr, om.T)),
                device_kernels=cs.device_kernels_per_call(
                    lambda: sp.sketch_panel(om, r, v)),
                kernel_ms=cs.device_ms_by_kernel(
                    lambda: sp.sketch_panel(om, r, v)),
                max_abs_err=float((got - want).abs().max()),
                limit=1e-5 * float(want.abs().max()),
                equal_to_plain=bool(torch.equal(got, want)),
                bit_stable_10=all(torch.equal(got, sp.sketch_panel(om, r, v))
                                  for _ in range(10))))
            del got, want
    return rows


def _import_tree(src):
    """Let ``import repro_torch`` load the copy under ``src``, in place of
    any copy imported so far."""
    for name in [m for m in sys.modules
                 if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, src)


def main(argv=None) -> int:
    own_src = os.path.abspath(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=own_src)
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", default="flash,topk,ssd,blockgram,sgram,"
                    "sketch", help="the kernels to time (ptxas covers all)")
    ap.add_argument("--no-ptxas", action="store_true",
                    help="skip the ptxas report")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        print("profile_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    # the yardsticks come from this checkout, the kernels from --src
    _import_tree(own_src)
    sys.path.insert(0, os.path.dirname(own_src))
    import chip_smoke
    from repro_torch.kernels.blockgram import work as bg_work
    from repro_torch.kernels.ssd_scan import work as ssd_work
    _import_tree(os.path.abspath(args.src))
    from repro_torch.kernels import blockgram as bg
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sketch_panel as sp
    from repro_torch.kernels import sparse_gram as sg
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import topk_score as tk
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    build.load()
    res = dict(card=smi, src=os.path.abspath(args.src),
               ptxas=(None if args.no_ptxas
                      else ptxas_report(str(build.CSRC))),
               flash_attention=flash_rows(fa) if "flash" in only else None,
               topk_score=topk_rows(tk) if "topk" in only else None,
               ssd_scan=ssd_rows(ss, ssd_work) if "ssd" in only else None,
               blockgram=(blockgram_rows(bg, bg_work, chip_smoke.products,
                                         chip_smoke.gram_f64)
                          if "blockgram" in only else None),
               sparse_gram=sgram_rows(sg, chip_smoke) if "sgram" in only
               else None,
               sketch_panel=sketch_rows(sp, chip_smoke) if "sketch" in only
               else None)
    text = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
