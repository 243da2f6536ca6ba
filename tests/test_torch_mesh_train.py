"""Training on the port's LM model mesh, on four gloo ranks on the CPU
(``data`` 2 x ``model`` 2): the ZeRO-1 AdamW step and the loop against the
port's single-device path at the reference test's tolerances
(``tests/test_distributed.py::test_sharded_train_step_runs_and_matches_
single``: loss 1e-4, params rtol 2e-4 / atol 1e-5), a checkpoint saved
from the 4 ranks restored on one device and in the reference's
``Checkpointer``, ``ft.elastic.recover`` without ``shardings_fn`` putting 2
surviving ranks back on the same trajectory, and ``launch/train.py
--coordinator`` and ``launch/serve.py --coordinator`` starting two
ranks, and the ranks' backend and card by their layout (``launch/ranks.py``).
"""
import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt

from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import base as tbase
from repro_torch.data import tokens as ttokens
from repro_torch.optim import tree
from repro_torch.train import loop as tloop
from repro_torch.train import step as tstep

from conftest import REPO
from test_torch_helpers import one_torch_thread, spawn_gloo  # noqa: F401

# loops of small torch ops in the parent: one torch thread (the helper)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = {"phi4": ("phi4-mini-3.8b", "none", 8),
         "zamba2": ("zamba2-2.7b", "dots", 4)}
LOOP_STEPS, MORE_STEPS = 4, 2


def _setup(name):
    arch, remat, batch = ARCHS[name]
    cfg = dataclasses.replace(tbase.get_smoke_config(arch), dtype="float32")
    # no warmup: every step moves the weights by about lr (3e-4), far
    # past the params' atol (1e-5), so a missed update shows
    return (cfg, tstep.TrainConfig(remat=remat, warmup_steps=0),
            ttokens.DataConfig(cfg.vocab_size, 32, batch))


_BODY = """
import dataclasses
import numpy as np
import torch
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import base as tbase
from repro_torch.core import collectives as tcol
from repro_torch.data import tokens as ttokens
from repro_torch.ft import elastic
from repro_torch.models import layers as tlayers
from repro_torch.models import schema as tschema
from repro_torch.optim import tree
from repro_torch.train import loop as tloop
from repro_torch.train import step as tstep

ARCHS = %r
LOOP_STEPS, MORE_STEPS = %d, %d
""" % (ARCHS, LOOP_STEPS, MORE_STEPS) + __import__("inspect").getsource(
    _setup) + """

def gathered(cfg, params, ctx):
    full = tschema.gather_params(params, cfg, ctx)
    return {p: x.numpy() for p, x in tree.flatten(full)}


def one_step(name, mesh):
    cfg, tcfg, dcfg = _setup(name)
    ctx = tlayers.ShardCtx(mesh=mesh)
    state = tstep.init_train_state(cfg, tcfg,
                                   torch.Generator().manual_seed(0), "cpu",
                                   ctx=ctx)
    step = tstep.make_train_step(cfg, tcfg, ctx)
    losses = []
    for s in range(2):
        batch = ttokens.shard_batch(ttokens.batch_at(dcfg, s), "cpu", mesh)
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return dict(losses=losses, gnorm=float(m["grad_norm"]),
                params=gathered(cfg, state["params"], ctx),
                m_embed=tuple(state["opt"]["m"]["embed"].shape),
                p_embed=tuple(state["params"]["embed"].shape))


def main(rank, world):
    mesh = tcol.ProcessGroupMesh({"data": 2, "model": 2}, device="cpu")
    out = {name: one_step(name, mesh) for name in ARCHS}
    if rank:
        for name in ARCHS:
            out[name].pop("params")

    # the loop on the mesh, checkpoints every 2 steps (saved gathered)
    cfg, tcfg, dcfg = _setup("phi4")
    ck_dir = out_dir + "/ck"
    lcfg = tloop.LoopConfig(steps=LOOP_STEPS, ckpt_every=2, ckpt_dir=ck_dir,
                            log_every=1)
    logs = []
    state = tloop.train(cfg, tcfg, lcfg, dcfg, device="cpu",
                        log=logs.append, mesh=mesh)
    out["loop_logs"] = logs
    if rank == 0:
        out["loop_params"] = gathered(cfg, state["params"],
                                      tlayers.ShardCtx(mesh=mesh))
    else:
        tschema.gather_params(state["params"], cfg,
                              tlayers.ShardCtx(mesh=mesh))
    dist.barrier()

    # ranks 2 and 3 are lost: the survivors recover onto their own mesh
    pool = tcol.ProcessGroupMesh({"blocks": 4}, device="cpu")
    surv = elastic.build_mesh(elastic.ElasticPlan((2,), ("blocks",), 2),
                              pool, slots=[0, 1])
    if surv is None:
        # new_group is collective over every rank: take part in the
        # survivors' mesh too
        elastic.build_mesh(elastic.plan_mesh(2, model_parallel=2), pool,
                           slots=[0, 1])
        return out
    mesh2, ctx2, saved, meta = elastic.recover(
        Checkpointer(ck_dir), cfg, tcfg, survivors=surv, model_parallel=2)
    state = tstep.state_from_checkpoint(saved)
    step = tstep.make_train_step(cfg, tcfg, ctx2)
    for s in range(meta["step"], meta["step"] + MORE_STEPS):
        batch = ttokens.shard_batch(ttokens.batch_at(dcfg, s), "cpu", mesh2)
        state, _ = step(state, batch)
    out["recovered"] = dict(
        mesh=dict(mesh2.shape), step=meta["step"],
        opt_step=int(state["opt"]["step"]),
        params=gathered(cfg, state["params"], ctx2))
    return out
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    return tmp, spawn_gloo(_BODY, 4, tmp, timeout=180)


def _init(name):
    cfg, tcfg, _ = _setup(name)
    return tstep.init_train_state(cfg, tcfg,
                                  torch.Generator().manual_seed(0), "cpu")


def _single(name, steps):
    cfg, tcfg, dcfg = _setup(name)
    state = _init(name)
    step = tstep.make_train_step(cfg, tcfg)
    losses = []
    for s in range(steps):
        state, m = step(state, ttokens.shard_batch(ttokens.batch_at(dcfg, s),
                                                   "cpu"))
        losses.append(float(m["loss"]))
    return losses, float(m["grad_norm"]), {
        p: x.numpy() for p, x in tree.flatten(state["params"])}


def _close(got, want):
    assert set(got) == set(want)
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=2e-4, atol=1e-5,
                                   err_msg=p)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_zero1_adamw_steps_match_one_device(ranks, name):
    """Two AdamW steps with ZeRO-1 moments on (data 2, model 2) against one
    device, at the full lr from the first step: each loss within 1e-4, the
    gathered params within rtol 2e-4 / atol 1e-5, every leaf moved by more
    than 10 x atol; a moment is the rank's block of the parameter's
    block."""
    losses, gnorm, params = _single(name, 2)
    _, got = ranks
    for r in got:
        for a, b in zip(r[name]["losses"], losses):
            assert abs(a - b) < 1e-4
        assert r[name]["gnorm"] == pytest.approx(gnorm, rel=1e-5)
    _close(got[0][name]["params"], params)
    # the steps moved every leaf by far more than the params' atol: a
    # missed update, or a ZeRO slice not gathered back, would show
    start = {p: x.numpy() for p, x in tree.flatten(_init(name)["params"])}
    for p in params:
        assert np.abs(params[p] - start[p]).max() > 10 * 1e-5, p
    p0, d0 = got[0][name]["p_embed"]
    # embed (Vp, D): the vocab over model 2, ZeRO over data 2 on D
    assert got[0][name]["m_embed"] == (p0, d0 // 2)


def test_loop_on_the_mesh_matches_one_device_and_its_files_cross(ranks):
    """``train(mesh=)`` for 4 steps against ``train()`` on one device; the
    file the 4 ranks saved (gathered, rank 0 writing) restores on one
    device and in the reference's Checkpointer, as the rank's gathered
    params."""
    tmp, got = ranks
    cfg, tcfg, dcfg = _setup("phi4")
    lcfg = tloop.LoopConfig(steps=LOOP_STEPS, ckpt_every=2, ckpt_dir=None,
                            log_every=1)
    logs = []
    state = tloop.train(cfg, tcfg, lcfg, dcfg, device="cpu", log=logs.append)
    want = {p: x.numpy() for p, x in tree.flatten(state["params"])}
    _close(got[0]["loop_params"], want)
    for r in got:
        assert len(r["loop_logs"]) == LOOP_STEPS
        assert r["loop_logs"][0].split()[:3] == logs[0].split()[:3]
    ck = str(tmp / "ck")
    back, meta = tckpt.Checkpointer(ck).restore(
        device="cpu",
        expect_signature=tckpt.tree_signature(tstep.checkpoint_tree(state)))
    assert meta["step"] == LOOP_STEPS and meta["process_index"] == 0
    for p, x in tree.flatten(back["params"]):
        np.testing.assert_array_equal(x.numpy(), got[0]["loop_params"][p])
    assert back["opt"]["m"]["embed"].shape == state["opt"]["m"]["embed"].shape
    jtree, jmeta = jckpt.Checkpointer(ck).restore()
    assert jmeta["signature"] == jckpt.tree_signature(jtree)
    np.testing.assert_array_equal(np.asarray(jtree["params"]["embed"]),
                                  got[0]["loop_params"]["embed"])
    assert int(np.asarray(jtree["opt"]["step"])) == LOOP_STEPS


def test_recover_puts_the_survivors_on_the_same_trajectory(ranks):
    """Ranks 2 and 3 lost after the loop's last checkpoint: ``recover``
    without ``shardings_fn`` plans (data 1, model 2) on the survivors,
    restores the state by ``state_shardings`` onto it, and 2 more steps land
    on one device's 6-step trajectory (rtol 2e-4, atol 1e-5)."""
    _, got = ranks
    _, _, want = _single("phi4", LOOP_STEPS + MORE_STEPS)
    assert "recovered" not in got[2] and "recovered" not in got[3]
    for r in got[:2]:
        rec = r["recovered"]
        assert rec["mesh"] == {"data": 1, "model": 2}
        assert rec["step"] == LOOP_STEPS
        assert rec["opt_step"] == LOOP_STEPS + MORE_STEPS
        _close(rec["params"], want)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _launch_ranks(module, args, world):
    """``python -m module`` as ``world`` gloo ranks on the CPU: each rank's
    stdout lines (every process is ended before this returns)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *args, "--device", "cpu",
         "--coordinator", f"localhost:{port}", "--num-hosts", str(world),
         "--host-id", str(i)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(world)]
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
    return [o.strip().splitlines() for o, _ in outs]


def test_launcher_starts_ranks_with_a_coordinator():
    """``launch/train.py --coordinator`` as two processes: a (1, 2) mesh
    over gloo, the same losses logged on both ranks."""
    lines = _launch_ranks("repro_torch.launch.train", [
        "--arch", "zamba2-2.7b", "--smoke", "--steps", "2", "--seq", "16",
        "--global-batch", "2", "--model-parallel", "2"], 2)
    for ls in lines:
        assert ls[0] == "mesh: (1, 2) ('data', 'model') (0 devices idle)"
        assert len(ls) == 3
    losses = [[ln.split()[2] for ln in ls[1:]] for ls in lines]
    assert losses[0] == losses[1]


@pytest.mark.parametrize("model_parallel", [2, 1])
def test_serve_launcher_starts_ranks_with_a_coordinator(model_parallel,
                                                        capsys):
    """``launch/serve.py --coordinator`` as two processes: on (1, 2) both
    ranks serve every request, on (2, 1) each its row; the tokens are one
    process's (the same seeds, the same requests)."""
    from repro_torch.launch import serve as tserve

    args = ["--arch", "zamba2-2.7b", "--smoke", "--requests", "2",
            "--tokens", "3", "--model-parallel", str(model_parallel)]
    lines = _launch_ranks("repro_torch.launch.serve", args, 2)
    want = tserve.main(args + ["--device", "cpu"]).tolist()
    capsys.readouterr()
    shape = (1, 2) if model_parallel == 2 else (2, 1)
    for i, ls in enumerate(lines):
        assert ls[0] == (f"mesh: {shape} ('data', 'model') (0 devices "
                         f"idle)")
        assert ls[1].endswith(f"mesh {shape}")
        rows = want if model_parallel == 2 else want[i:i + 1]
        assert ls[2] == f"tokens: {rows}"


@pytest.mark.parametrize("per_host, cards, want", [
    # one host, four ranks sharing one card: gloo, all on card 0
    (4, 1, [("gloo", 0)] * 4),
    # one host, a card a rank: NCCL, card = rank
    (4, 4, [("nccl", r) for r in range(4)]),
    # two hosts of 2 cards, 2 ranks each: NCCL on each host's cards
    (2, 2, [("nccl", 0), ("nccl", 1), ("nccl", 0), ("nccl", 1)]),
    # no card: gloo on the CPU
    (4, 0, [("gloo", None)] * 4),
    # two hosts of 1 card, 2 ranks each: shared, gloo
    (2, 1, [("gloo", 0)] * 4),
])
def test_rank_layout_picks_nccl_only_where_every_rank_owns_a_card(
        per_host, cards, want):
    from repro_torch.launch.ranks import rank_layout

    assert [rank_layout(r, per_host, cards) for r in range(4)] == want


def test_sixteen_ranks_on_two_hosts_of_eight_cards_take_nccl():
    """The world size alone does not decide: 2 x 8 ranks on hosts of 8
    cards each own a card (the layout a 16-rank job across two nodes
    has); ``start_ranks`` refuses a per-host count that does not divide
    the world before joining any group."""
    from repro_torch.launch.ranks import rank_layout, start_ranks

    assert {rank_layout(r, 8, 8)[0] for r in range(16)} == {"nccl"}
    assert [rank_layout(r, 8, 8)[1] for r in range(16)] == list(range(8)) * 2
    with pytest.raises(ValueError, match="does not divide"):
        start_ranks("localhost:1", 16, 0, "cpu", ranks_per_host=6)
    with pytest.raises(ValueError, match="host-id"):
        start_ranks("localhost:1", 2, 2, "cpu")
