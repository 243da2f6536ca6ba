"""Ranky-GaLore over the port's LM model mesh, on four gloo ranks on the
CPU (``data`` 2 x ``model`` 2), against the port's single-device GaLore
and the reference's ``galore.apply_updates`` on the whole gradient.

The smoke configs of phi3.5-moe and zamba2 in float32, GaLore at rank 4
over every matrix of 16 and more (``min_dim`` 16), so that every kind of
leaf occurs: column-split (``lm_head``, ``wx``, ``w_up``), row-split (the
vocab-parallel ``embed``, ``out_proj``, ``wq``), split on a leading
dimension (the experts, ``wo``) and replicated (``wbc``).  The ranks take
one device's gradients, cut to their blocks (the model mesh's own
gradients are held by ``test_torch_mesh*.py``; the moe's per-shard
load-balance loss and capacity make a mesh's gradients another function
than one device's), and the reference's bases and repair columns
(``jax.random.split(key, leaves)``), so that an update compares bit for
bit in what it computes: an eigh basis is free in its signs and inside a
near-degenerate eigenspace.  Limits: the gram 1e-5 of its max; masks and
repaired entries exact; P the same bits on every rank; the parameters
rtol 2e-4 / atol 1e-5 (``tests/test_distributed.py``'s); a subspace 1e-4
where the top eigenvalues are apart.
"""
import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.compression import galore as jgalore
from repro.optim import adamw as jadamw

from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.compression import galore as tgalore
from repro_torch.configs import base as tbase
from repro_torch.data import tokens as ttokens
from repro_torch.models.layers import ShardCtx
from repro_torch.optim import tree
from repro_torch.train import step as tstep

from conftest import REPO
from test_torch_helpers import one_torch_thread, projector_gap, \
    spawn_gloo  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = ("phi3.5-moe-42b-a6.6b", "zamba2-2.7b")
GCFG = dict(rank=4, min_dim=16, update_every=2)
# Rows past which the ranks' second pass takes the n-side gram (the route
# of an LM's embedding on the card): the smoke embedding has 512.
NSIDE_ROWS = 256
KEY = 7
GAP = 1e-3          # a subspace is compared where the top gaps exceed it


def _setup(arch):
    cfg = dataclasses.replace(tbase.get_smoke_config(arch), dtype="float32")
    tcfg = tstep.TrainConfig(optimizer="galore", remat="none",
                             warmup_steps=0,
                             galore=tgalore.GaloreConfig(**GCFG))
    return cfg, tcfg, ttokens.DataConfig(cfg.vocab_size, 32, 4)


def _np_tree(t):
    return {p: x.detach().numpy().copy() for p, x in tree.flatten(t)}


def _one_device(arch, tmp):
    """Everything one device computes, saved for the ranks: the drawn
    state's two steps with the reference's bases and columns (its
    gradients, grams, masks and repaired blocks), the reference's own
    step, and each eligible slice's top eigen-gap."""
    cfg, tcfg, dcfg = _setup(arch)
    gcfg = tcfg.galore
    state = tstep.init_train_state(cfg, tcfg,
                                   torch.Generator().manual_seed(0), "cpu")
    params0 = _np_tree(state["params"])
    flat = tree.flatten(state["params"])
    grads = []
    for s in range(2):
        batch = ttokens.shard_batch(ttokens.batch_at(dcfg, s), "cpu")
        grads.append(tstep._grads(cfg, tcfg, state["params"], batch)[2])
        if s == 0:
            # the reference's step on the whole gradient: its bases
            jgcfg = jgalore.GaloreConfig(**GCFG)
            key = jax.random.PRNGKey(KEY)
            jp = {p: jnp.asarray(x) for p, x in params0.items()}
            jp = _nest(jp)
            jgr = _nest({p: jnp.asarray(g.numpy())
                         for p, g in tree.flatten(grads[0])})
            jst = jgalore.init_state(jp, jgcfg)
            jnew, jst, _ = jax.jit(lambda p_, g_, s_: jgalore.apply_updates(
                jadamw.AdamWConfig(), jgcfg, p_, g_, s_, lr_scale=1.0,
                key=key))(jp, jgr, jst)
            keys = jax.random.split(key, len(flat))
            cols, bases = {}, {}
            for (path, p), k in zip(flat, keys):
                if tgalore.eligible(gcfg, p):
                    m, n = p.shape[-2:]
                    cols[path] = torch.from_numpy(np.array(
                        jax.random.randint(k, (m,), 0, n))).long()
                    node = jst["leaves"]
                    for part in path.split("/"):
                        node = node[part]
                    bases[path] = torch.from_numpy(np.array(node["p"]))
            ref_params1 = {p: np.asarray(x) for p, x in
                           tree.flatten(jnew)}
            one = {}
            for path, g in tree.flatten(grads[0]):
                if path in cols:
                    gram, lonely, blk = tgalore.mesh_gram(
                        gcfg, g, (), ShardCtx(), cols[path])
                    ev = torch.linalg.eigvalsh(gram).flip(-1)[
                        ..., : gcfg.rank + 1]
                    gaps = ((ev[..., :-1] - ev[..., 1:])
                            / ev[..., :1].clamp_min(1e-30)).min(-1).values
                    one[path] = dict(gram=gram.numpy(), lonely=lonely.numpy(),
                                     repaired=blk.numpy(), gap=gaps.numpy())
        tgalore.apply_updates(tcfg.adamw, gcfg, state["params"], grads[s],
                              state["opt"], lr_scale=1.0, seed=0,
                              cols=cols, bases=bases)
        if s == 0:
            params1 = _np_tree(state["params"])
    torch.save(dict(grads=[{p: g for p, g in tree.flatten(gr)}
                           for gr in grads], cols=cols, bases=bases),
               os.path.join(tmp, f"in_{arch}.pt"))
    return dict(params0=params0, params1=params1,
                params2=_np_tree(state["params"]), ref_params1=ref_params1,
                one=one, state=state, cols=cols, bases=bases, grads=grads)


def _nest(flat):
    out = {}
    for path, x in flat.items():
        node = out
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = x
    return out


_BODY = """
import dataclasses
import numpy as np
import torch
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.compression import galore as tgalore
from repro_torch.configs import base as tbase
from repro_torch.core import collectives as tcol
from repro_torch.data import tokens as ttokens
from repro_torch.ft import elastic
from repro_torch.models import layers as tlayers
from repro_torch.models import schema as tschema
from repro_torch.optim import tree
from repro_torch.train import step as tstep

ARCHS, GCFG, NSIDE_ROWS = %r, %r, %d
""" % (ARCHS, GCFG, NSIDE_ROWS) + __import__("inspect").getsource(
    _setup) + """

def gathered(tree_, specs, ctx):
    full = tschema.map_specs(lambda sp, x: ctx.gather(x, sp), specs, tree_)
    return {p: x.numpy().copy() for p, x in tree.flatten(full)}


def grams(gcfg, grads, cols, specs, ctx, only=None):
    out = {}
    for (path, g), sp in zip(tree.flatten(grads),
                             tree.leaves(specs, dicts_only=True)):
        if path not in cols or (only and path not in only):
            continue
        gram, lonely, blk = tgalore.mesh_gram(gcfg, g, sp, ctx, cols[path])
        full = tgalore._full(sp, g.dim())
        p = ctx.gather(tgalore.mesh_basis(gcfg, g, sp, ctx, cols[path]),
                       full[:-2] + (None, None))
        out[path] = dict(gram=gram.numpy(), lonely=lonely.numpy(),
                         repaired=blk.numpy(), p=p.numpy(), spec=full,
                         index={ax: ctx.index((ax,))
                                for ax in ("data", "model")})
    return out


def run(arch, mesh, ctx):
    cfg, tcfg, dcfg = _setup(arch)
    gcfg = tcfg.galore
    inp = torch.load(out_dir + f"/in_{arch}.pt")
    state = tstep.init_train_state(cfg, tcfg,
                                   torch.Generator().manual_seed(0), "cpu",
                                   ctx=ctx)
    sh = tstep.state_shardings(cfg, tcfg, ctx)
    specs = sh["params"]
    blocks = [tree.unflatten(state["params"], [
        ctx.local(g[p], sp).clone() for p, sp in zip(
            g, tree.leaves(specs, dicts_only=True))]) for g in inp["grads"]]
    out = dict(grams=grams(gcfg, blocks[0], inp["cols"], specs, ctx))
    saved = tgalore.EIGH_MAX_ROWS
    tgalore.EIGH_MAX_ROWS = NSIDE_ROWS
    try:
        out["nside"] = grams(gcfg, blocks[0], inp["cols"], specs, ctx,
                             only=("embed",))
    finally:
        tgalore.EIGH_MAX_ROWS = saved
    for s in range(2):
        tgalore.apply_updates(tcfg.adamw, gcfg, state["params"], blocks[s],
                              state["opt"], lr_scale=1.0, seed=0,
                              cols=inp["cols"], bases=inp["bases"], ctx=ctx,
                              specs=specs)
        out[f"params{s + 1}"] = gathered(state["params"], specs, ctx)
    out["p_slice_embed"] = tuple(
        state["opt"]["leaves"]["embed"]["p"].shape)
    # the checkpoint: saved gathered, restored onto the blocks
    ck = Checkpointer(out_dir + f"/ck_{arch}")
    ck.save(2, tstep.checkpoint_tree(state), shardings=sh, ctx=ctx,
            blocking=True)
    dist.barrier()                 # rank 0 wrote the file
    back, meta = ck.restore(device="cpu", shardings=sh, ctx=ctx)
    out["restored_bit_for_bit"] = all(
        np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
            tree.leaves(tstep.checkpoint_tree(state)), tree.leaves(back)))
    out["opt"] = gathered(state["opt"], sh["opt"], ctx)
    # recover (no shardings_fn) plans (2, 2) on the 4 ranks again and
    # restores the same blocks through state_shardings
    pool = tcol.ProcessGroupMesh({"blocks": 4}, device="cpu")
    mesh2, _, again, meta2 = elastic.recover(ck, cfg, tcfg, survivors=pool,
                                             model_parallel=2)
    out["recovered"] = dict(mesh=dict(mesh2.shape), step=meta2["step"],
                            bit_for_bit=all(
        np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(tree.leaves(back), tree.leaves(again))))
    if arch == "zamba2-2.7b":
        # the train step on the mesh: its own gradients and bases
        fresh = tstep.init_train_state(cfg, tcfg,
                                       torch.Generator().manual_seed(0),
                                       "cpu", ctx=ctx)
        step = tstep.make_train_step(cfg, tcfg, ctx)
        batch = ttokens.shard_batch(ttokens.batch_at(dcfg, 0), "cpu", mesh)
        _, m = step(fresh, batch)
        out["step"] = dict(loss=float(m["loss"]),
                           gnorm=float(m["grad_norm"]),
                           params=gathered(fresh["params"], specs, ctx))
    return out


def main(rank, world):
    mesh = tcol.ProcessGroupMesh({"data": 2, "model": 2}, device="cpu")
    ctx = tlayers.ShardCtx(mesh=mesh)
    return {arch: run(arch, mesh, ctx) for arch in ARCHS}
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("galore_mesh")
    one = {arch: _one_device(arch, str(tmp)) for arch in ARCHS}
    return tmp, one, spawn_gloo(_BODY, 4, tmp, timeout=180)


def _close(got, want):
    assert set(got) == set(want)
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=2e-4, atol=1e-5,
                                   err_msg=p)


def _own(x, spec, index, lead_only=False):
    """Rank ``index``'s block of a whole array under ``spec``, the last
    two dims kept whole (the gram's) where ``lead_only``."""
    sl = []
    for dim, ax in enumerate(spec[:-2] if lead_only else spec):
        if ax:
            n = int(np.prod([2 for _ in ax]))
            step = x.shape[dim] // n
            i = index[ax[0]] if len(ax) == 1 else None
            sl.append(slice(i * step, (i + 1) * step))
        else:
            sl.append(slice(None))
    return x[tuple(sl)]


@pytest.mark.parametrize("arch", ARCHS)
def test_gram_masks_and_repair_are_one_devices(runs, arch):
    """Every eligible leaf's gram (the rank's matrices) within 1e-5 of
    the max of one device's; the lonely-row masks equal and the repaired
    entries exactly one device's; the leaf kinds all occur."""
    _, one, got = runs
    kinds = set()
    for r in got:
        for path, g in r[arch]["grams"].items():
            want = one[arch]["one"][path]
            spec, idx = g["spec"], g["index"]
            kinds.add("lead" if any(spec[:-2]) else
                      "rows" if spec[-2] else "cols" if spec[-1] else "none")
            w_gram = _own(want["gram"], spec, idx, lead_only=True)
            assert np.abs(g["gram"] - w_gram).max() <= \
                1e-5 * np.abs(w_gram).max(), path
            lonely = _own(want["lonely"], tuple(spec[:-2]) + (None,), idx)
            np.testing.assert_array_equal(g["lonely"], lonely, err_msg=path)
            # the repaired block: every row, the rank's columns
            rep = _own(want["repaired"], tuple(spec[:-2]) + (None, spec[-1]),
                       idx)
            np.testing.assert_array_equal(g["repaired"], rep, err_msg=path)
            assert np.count_nonzero(rep[lonely]) == lonely.sum()
    assert kinds >= {"lead", "rows", "cols"}
    if arch == "zamba2-2.7b":
        assert "none" in kinds            # wbc


@pytest.mark.parametrize("arch", ARCHS)
def test_bases_are_the_same_bits_on_every_rank(runs, arch):
    """P (gathered over a leading split) is bit-identical on all four
    ranks, on the m side and on the n side; its subspace matches one
    device's (the reference's) where the top eigen-gaps allow."""
    _, one, got = runs
    compared = 0
    for part in ("grams", "nside"):
        for path in got[0][arch][part]:
            ps = [r[arch][part][path]["p"] for r in got]
            for p in ps[1:]:
                assert np.array_equal(p, ps[0]), (part, path)
            ref = one[arch]["bases"][path].numpy()
            gaps = one[arch]["one"][path]["gap"].reshape(-1)
            for j, gap in zip(np.ndindex(ref.shape[:-2]), gaps):
                if gap > GAP:
                    assert projector_gap(ps[0][j], ref[j]) < 1e-4, \
                        (part, path, j)
                    compared += 1
    assert compared >= 4
    # the n-side pass took the embedding's n-side gram (64 x 64)
    assert got[0][arch]["nside"]["embed"]["gram"].shape == (64, 64)


@pytest.mark.parametrize("arch", ARCHS)
def test_injected_step_matches_one_device_and_the_reference(runs, arch):
    """Two steps with the reference's bases injected at the refresh and
    one device's gradients: every parameter within rtol 2e-4 / atol 1e-5
    of the port's single-device GaLore after each step, and after the
    first of the reference's ``galore.apply_updates`` on the whole
    gradient with the same columns; each step moved every matrix."""
    _, one, got = runs
    for r in got:
        _close(r[arch]["params1"], one[arch]["params1"])
        _close(r[arch]["params2"], one[arch]["params2"])
    _close(got[0][arch]["params1"], one[arch]["ref_params1"])
    for p, x in one[arch]["params1"].items():
        if x.ndim >= 2:
            assert np.abs(x - one[arch]["params0"][p]).max() > 10 * 1e-5, p


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_restores_bit_for_bit_and_crosses_to_one_device(runs,
                                                                   arch):
    """The GaLore state saved from the mesh (gathered) restores onto each
    rank's blocks bit for bit (also through ``ft.elastic.recover``
    without ``shardings_fn``), and on one device as the ranks' gathered
    state, within rtol 2e-4 / atol 1e-5 of one device's own after the
    same two steps (moments of the same signs: the same bases)."""
    tmp, one, got = runs
    assert all(r[arch]["restored_bit_for_bit"] for r in got)
    for r in got:
        assert r[arch]["recovered"] == dict(mesh={"data": 2, "model": 2},
                                            step=2, bit_for_bit=True)
    back, meta = tckpt.Checkpointer(str(tmp / f"ck_{arch}")).restore(
        device="cpu")
    assert meta["step"] == 2
    saved = tstep.state_from_checkpoint(back)
    for path, x in tree.flatten(saved["opt"]):
        np.testing.assert_array_equal(x.numpy(), got[0][arch]["opt"][path],
                                      err_msg=path)
    want = tree.flatten(one[arch]["state"]["opt"])
    for (path, x), (_, w) in zip(tree.flatten(saved["opt"]), want):
        assert x.shape == w.shape, path
        np.testing.assert_allclose(x.numpy(), w.numpy(), rtol=2e-4,
                                   atol=1e-5 * max(1.0, float(w.abs().max())),
                                   err_msg=path)
    # the embedding's P is split over data on its rows (ZeRO-1)
    vp = one[arch]["params0"]["embed"].shape[0]
    assert got[0][arch]["p_slice_embed"] == (vp // 2, GCFG["rank"])


def test_train_step_on_the_mesh_matches_one_device(runs):
    """``make_train_step`` on the mesh (its own gradients, bases from the
    whole gradient with ``draw_cols``) against one device's step: loss
    1e-4, grad_norm rel 1e-5, every parameter of a leaf whose top
    eigen-gaps allow (and every leaf GaLore does not take) within rtol
    2e-4 / atol 1e-5."""
    _, one, got = runs
    arch = "zamba2-2.7b"
    cfg, tcfg, dcfg = _setup(arch)
    state = tstep.init_train_state(cfg, tcfg,
                                   torch.Generator().manual_seed(0), "cpu")
    _, m = tstep.make_train_step(cfg, tcfg)(
        state, ttokens.shard_batch(ttokens.batch_at(dcfg, 0), "cpu"))
    want = _np_tree(state["params"])
    gaps = {p: float(v["gap"].min()) for p, v in one[arch]["one"].items()}
    checked = 0
    for r in got:
        s = r[arch]["step"]
        assert abs(s["loss"] - float(m["loss"])) < 1e-4
        assert s["gnorm"] == pytest.approx(float(m["grad_norm"]), rel=1e-5)
        for p, w in want.items():
            if gaps.get(p, 1.0) > GAP:
                np.testing.assert_allclose(s["params"][p], w, rtol=2e-4,
                                           atol=1e-5, err_msg=p)
                checked += 1
    assert checked >= 4 * len(want) // 2


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_launcher_trains_galore_on_two_ranks():
    """``launch/train.py --optimizer galore --model-parallel 2
    --coordinator`` as two gloo processes: a (1, 2) mesh, the same losses
    logged on both ranks (steps 0 and 2), falling."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    args = ["--arch", "zamba2-2.7b", "--smoke", "--steps", "3", "--seq",
            "16", "--global-batch", "2", "--model-parallel", "2",
            "--optimizer", "galore", "--device", "cpu", "--coordinator",
            f"localhost:{port}", "--num-hosts", "2"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *args,
         "--host-id", str(i)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=60))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    lines = [o.strip().splitlines() for o, _ in outs]
    for ls in lines:
        assert ls[0] == "mesh: (1, 2) ('data', 'model') (0 devices idle)"
        assert len(ls) == 3            # steps 0 and 2 logged
    losses = [[ln.split()[2] for ln in ls[1:]] for ls in lines]
    assert losses[0] == losses[1]
    assert float(losses[0][1][5:]) < float(losses[0][0][5:])
