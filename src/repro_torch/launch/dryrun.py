"""Dry run: every (architecture x input shape) cell on the production
meshes, one rank's step run on the ``meta`` device under the cost
counter, and its roofline terms on the H100 model.

The counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell on 512 forced host devices.  The port runs one mesh slot a process,
so a cell here is one rank: its blocks of the parameters (``param_specs``),
of the train state (``state_shardings``, ``TrainConfig(remat="dots")``)
and of the inputs (``models/io.input_specs``; ``long_500k`` shards the
cache's sequence over ``data``), built on ``meta`` and run through the
rank's train step, prefill or decode step on a :class:`~repro_torch.
launch.mesh.CountingMesh`.  Nothing executes and no card is needed; a
block or a collective whose shapes do not fit raises, and the cell is a
failure, as a partitioner error is in the reference.  The counter
(``launch/hlocost.py``) gives the operations, bytes and collective bytes
of the rank, ``launch/roofline.py`` the three terms.  The memory dict has
the reference's keys: ``argument_size_in_bytes`` (the rank's inputs),
``output_size_in_bytes`` (what the step returns; the train step updates
its state in place and returns it) and ``temp_size_in_bytes`` (the most
bytes of tensors the step made that were alive at once).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--out out.json]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs.base import ARCH_IDS, SHAPES, cells, get_config
from repro_torch.launch import hlocost
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.io import input_specs
from repro_torch.models.layers import DEFAULT_RULES, ShardCtx
from repro_torch.models.schema import abstract_params, map_specs, \
    param_specs
from repro_torch.models.transformer import decode_step, init_cache, \
    prefill_forward
from repro_torch.train.step import TrainConfig, init_opt_state, \
    make_train_step


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _blocks(tree, specs, ctx: ShardCtx):
    """The rank's blocks of a tree of ``meta`` tensors, as fresh ``meta``
    tensors."""
    return map_specs(lambda sp, x: torch.empty(
        ctx.local_shape(x.shape, sp), dtype=x.dtype, device="meta"),
        specs, tree)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               rules: Optional[dict] = None,
               tcfg: Optional[TrainConfig] = None):
    """One cell's rank: ``(fn, args, ctx)``, ``fn(*args)`` its step on
    ``meta`` on a production-mesh slot."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if rules is None and shape.name == "long_500k":
        # batch=1: the data axis shards the KV / state SEQUENCE instead of
        # the batch (sequence parallelism for long-context decode).
        rules = {**DEFAULT_RULES, "batch": None}
    ctx = ShardCtx(mesh=make_production_mesh(multi_pod=multi_pod),
                   rules=rules)
    tcfg = tcfg or TrainConfig(remat="dots")
    params = _blocks(abstract_params(cfg), param_specs(cfg, ctx), ctx)
    args, specs = input_specs(cfg, shape, ctx)
    batch = _blocks(args["batch"], specs["batch"], ctx)

    if shape.kind == "train":
        state = {"params": params,
                 "opt": init_opt_state(tcfg, params, cfg, ctx), "seed": 1}
        return make_train_step(cfg, tcfg, ctx), (state, batch), ctx
    if shape.kind == "prefill":
        def serve_prefill(params, batch):
            return prefill_forward(cfg, params, batch, ctx=ctx)

        return serve_prefill, (params, batch), ctx
    seq_sharded = shape.name == "long_500k"
    cache = init_cache(cfg, shape.global_batch, shape.seq_len, ctx=ctx,
                       seq_sharded=seq_sharded, abstract=True)

    def serve_step(params, cache, batch):
        return decode_step(cfg, params, cache, batch, ctx=ctx,
                           seq_sharded=seq_sharded)

    return serve_step, (params, cache, batch), ctx


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             rules: Optional[dict] = None, verbose: bool = True) -> dict:
    t0 = time.time()
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    chips = 512 if multi_pod else 256
    try:
        fn, args, _ = lower_cell(arch, shape_name, multi_pod=multi_pod,
                                 rules=rules)
        arg_bytes = hlocost.tree_bytes(args)
        out, cost = hlocost.run(fn, *args)
    except Exception as e:  # a failure here is a fault of the port
        traceback.print_exc()
        return {"arch": arch, "shape": shape_name,
                "mesh": _mesh_name(multi_pod), "ok": False,
                "error": f"{type(e).__name__}: {e}"}
    roof = rl.build(arch, shape, _mesh_name(multi_pod), chips, cost, cfg)
    result = {
        "ok": True,
        **roof.row(),
        "compile_s": round(time.time() - t0, 1),
        "memory": _mem_dict(arg_bytes, hlocost.tree_bytes(out), cost),
    }
    if verbose:
        ma = result["memory"]
        print(f"[{arch} x {shape_name} x {result['mesh']}] ok "
              f"compile={result['compile_s']}s "
              f"bytes/dev={ma['argument_size_in_bytes'] / 1e9:.2f}+"
              f"{ma['temp_size_in_bytes'] / 1e9:.2f}GB "
              f"t_comp={roof.t_compute * 1e3:.1f}ms "
              f"t_mem={roof.t_memory * 1e3:.1f}ms "
              f"t_coll={roof.t_collective * 1e3:.1f}ms -> {roof.bottleneck} "
              f"useful={roof.useful_flop_ratio:.2f} "
              f"roofline={roof.roofline_fraction:.2f}", flush=True)
    return result


def _mem_dict(arg_bytes: int, out_bytes: int, cost) -> dict:
    return {"argument_size_in_bytes": int(arg_bytes),
            "output_size_in_bytes": int(out_bytes),
            "temp_size_in_bytes": int(cost.peak_bytes)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="every assigned (arch x shape) cell")
    ap.add_argument("--multi-pod", action="store_true",
                    help="2x16x16 two-pod mesh (default: 16x16 single pod)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None,
                    help="append results to a JSON file")
    args = ap.parse_args(argv)

    todo = []
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    if args.all:
        for arch in ARCH_IDS:
            for shape in cells(arch):
                for mp in meshes:
                    todo.append((arch, shape, mp))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        for mp in meshes:
            todo.append((args.arch, args.shape, mp))

    results = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results if r.get("ok")}

    t_all = time.time()
    for arch, shape, mp in todo:
        if (arch, shape, _mesh_name(mp)) in done:
            print(f"[{arch} x {shape} x {_mesh_name(mp)}] cached, skip",
                  flush=True)
            continue
        res = run_cell(arch, shape, multi_pod=mp)
        results = [r for r in results
                   if not (r["arch"] == arch and r["shape"] == shape
                           and r["mesh"] == res["mesh"])]
        results.append(res)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1, default=str)

    failures = [r for r in results if not r.get("ok")]
    print(f"\n{len(results) - len(failures)}/{len(results)} cells ok "
          f"({time.time() - t_all:.1f} s)")
    for r in failures:
        print(f"FAILED: {r['arch']} x {r['shape']} x {r['mesh']}: "
              f"{r['error']}")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
