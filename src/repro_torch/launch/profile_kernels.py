"""Profile the two serving-path kernels on one GPU: ``flash_attention`` and
``topk_score``, with what ptxas says of every kernel's registers.

  python3 src/repro_torch/launch/profile_kernels.py [--src DIR] [--out FILE]

``--src`` is the ``src`` directory whose ``repro_torch`` is measured (the
default is this checkout's), so one call can profile two trees of the port
side by side.  Prints one JSON object: the card (``nvidia-smi`` name and
power limit); for every kernel function of ``csrc/*.cu`` the registers,
shared memory, stack and spills that ``nvcc -Xptxas -v`` reports; for
``flash_attention`` the device time (CUDA events, cold L2, median of 10),
the achieved TFLOP/s over the pairs the mask shows and SDPA's time on the
same inputs; for ``topk_score`` the device time of each of its kernels by
name (``torch.profiler``, a call's share of 10 warm calls) beside the whole
call's time and ``torch.mm`` + ``torch.topk``'s.  Needs a CUDA device.
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
    spill_bytes}]} from ``nvcc -Xptxas -v`` (compiled to a throw-away
    object)."""
    from repro_torch.kernels import build
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in sorted(os.listdir(csrc)):
            if not src.endswith(".cu"):
                continue
            proc = subprocess.run(
                [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 os.path.join(csrc, src), "-o",
                 os.path.join(tmp, src + ".o")],
                capture_output=True, text=True)
            rows, name, stack, spill = [], None, 0, 0
            for line in (proc.stdout + proc.stderr).splitlines():
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
            out[src] = rows if proc.returncode == 0 else proc.stderr[-2000:]
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import topk_score as tk
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    build.load()
    res = dict(card=smi, src=os.path.abspath(args.src),
               ptxas=ptxas_report(str(build.CSRC)),
               flash_attention=flash_rows(fa), topk_score=topk_rows(tk))
    text = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
