"""The port's LM trainer against the JAX package, on the CPU: the loss and
gradients of every family, remat, one AdamW step, micro-batching, the
data stream, the schedule, clipping, the loss function, the loop (resume,
a falling loss), train-state checkpoints across the packages, the
launcher and its guards.

Inputs are made from a seed (numpy, or the port's seeded parameter draw),
the same parameters reach both sides as arrays (the port's through
``models.convert.params_from_numpy``), and the reference's kernels run as
its own tests run them (``REPRO_KERNELS=ref``, the jnp oracles).  Float32
configs.  Tolerances: the loss rtol 1e-5; a gradient leaf max|Δ| <= 1e-4 *
max|g| (float32 sums in another order: matrix product blocking, the
online softmax against the direct one, the scan's order).
"""
import dataclasses
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.compression import galore as jgalore
from repro.configs import base as jbase
from repro.data import tokens as jtokens
from repro.models import io as jio
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.models.layers import ShardCtx
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.train import step as jstep

from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import base as tbase
from repro_torch.core import collectives as tcol
from repro_torch.data import tokens as ttokens
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert
from repro_torch.models import io as tio
from repro_torch.models import layers as tlayers
from repro_torch.models import schema as tschema
from repro_torch.models import transformer as ttr
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedule as tschedule
from repro_torch.optim import tree
from repro_torch.train import loop as tloop
from repro_torch.train import step as tstep

from conftest import REPO
from test_torch_helpers import lm_np, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CTX = ShardCtx()
GRAD_REL = 1e-4


def smoke_models(arch: str):
    """(reference config, port config, reference params, port params) of
    ``arch``'s smoke config in float32: parameters drawn by the port's
    ``init_params`` from a seeded generator, carried to the reference as
    arrays and back into the port through ``convert.params_from_numpy``
    (the reference's own ``init_params`` takes seconds a config here)."""
    jcfg = dataclasses.replace(jbase.get_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(tbase.get_smoke_config(arch), dtype="float32")
    drawn = tschema.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    host = tree.tree_map(lambda p: p.numpy(), drawn)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, host),
            convert.params_from_numpy(tcfg, host, device="cpu"))


def lm_batch(cfg, b, s, seed=0):
    """(reference batch, port batch): tokens, next-token labels with the
    last -1, M-RoPE positions, float32 encoder frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], -np.ones((b, 1), np.int32)], 1)
    out = {"tokens": toks, "labels": labels}
    if cfg.use_mrope:
        steps = np.arange(s, dtype=np.int32)[None, :, None]
        out["pos"] = (steps + rng.integers(0, 3, (b, 1, 3))).astype(np.int32)
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in out.items()})


def port_grads(cfg, params, batch, remat="none"):
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    live = tree.unflatten(params, leaves)
    total, metrics = ttr.train_loss(cfg, live, batch, remat=remat)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    return total.detach(), {k: v.detach() for k, v in metrics.items()}, \
        grads


def assert_grads_close(params, got, want_tree, rel=GRAD_REL):
    """Leaf by leaf (the reference's leaf order is the port's sorted
    paths): max|got - want| <= rel * max|want|."""
    want = jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for (path, _), g, w in zip(tree.flatten(params), got, want):
        w = np.asarray(w, np.float64)
        assert g is not None, path
        err = float(np.abs(lm_np(g).astype(np.float64) - w).max())
        assert err <= rel * max(float(np.abs(w).max()), 1e-30), (path, err)


# ---------------------------------------------------------------------------
# The loss and gradients of every family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_train_loss_and_grads_match_reference(arch):
    jcfg, tcfg, jp, tp = smoke_models(arch)
    jb, tb = lm_batch(tcfg, 2, 16)

    def jloss(p):
        return jtr.train_loss(jcfg, p, jb, CTX, remat="none")

    (jtotal, jm), jgrads = jax.jit(jax.value_and_grad(jloss,
                                                      has_aux=True))(jp)
    total, metrics, grads = port_grads(tcfg, tp, tb)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux_loss"]),
                               float(jm["aux_loss"]), rtol=1e-5, atol=1e-8)
    if tcfg.family == "moe":
        assert float(metrics["aux_loss"]) > 0
    assert_grads_close(tp, grads, jgrads)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "gemma2-9b", "whisper-small",
                                  "phi3.5-moe-42b-a6.6b"])
def test_remat_modes_give_the_same_gradients(arch):
    """``none``, ``dots`` and ``full`` (hybrid groups, gemma2's layer
    pairs, whisper's encoder and decoder layers, moe's aux loss)."""
    _, tcfg, _, tp = smoke_models(arch)
    _, tb = lm_batch(tcfg, 2, 16, seed=1)
    _, _, base = port_grads(tcfg, tp, tb, "none")
    for remat in ("dots", "full"):
        _, _, grads = port_grads(tcfg, tp, tb, remat)
        for g, w in zip(grads, base):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="remat"):
        ttr.train_loss(tcfg, tp, tb, remat="attention")


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def _state_pair(arch, tcfg_kw, *, seq=16, batch=8):
    """Reference and port train states from the same parameters, and the
    step-0 batch of the data stream on both sides."""
    jcfg, tcfg, jp, tp = smoke_models(arch)
    jt = jstep.TrainConfig(**tcfg_kw)
    tt = tstep.TrainConfig(**{k: (tadamw.AdamWConfig(**dataclasses.asdict(v))
                                  if k == "adamw" else v)
                              for k, v in tcfg_kw.items()})
    jstate = {"params": jp, "opt": jadamw.init_state(jp),
              "rng": jax.random.PRNGKey(1)}
    tstate = {"params": tp, "opt": tadamw.init_state(tp), "seed": 1}
    dcfg = jtokens.DataConfig(tcfg.vocab_size, seq, batch)
    host = jtokens.batch_at(dcfg, 0)
    return (jcfg, jt, jstate, {k: jnp.asarray(v) for k, v in host.items()},
            tcfg, tt, tstate, ttokens.shard_batch(host, "cpu"))


def test_adamw_train_step_matches_reference():
    (jcfg, jt, jstate, jb, tcfg, tt, tstate, tb) = _state_pair(
        "starcoder2-15b", dict(remat="none", warmup_steps=2,
                               adamw=jadamw.AdamWConfig(lr=1e-3)))
    jfn = jax.jit(jstep.make_train_step(jcfg, jt, CTX))
    tfn = tstep.make_train_step(tcfg, tt)
    for i in range(2):
        jstate, jm = jfn(jstate, jb)
        tstate, tm = tfn(tstate, tb)
        for key in ("loss", "aux_loss", "grad_norm", "lr_scale"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, atol=1e-8, err_msg=key)
    assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"]) == 2
    # parameters at tests/test_substrate.py's limits for two computations
    # of one step (Adam turns the float32 noise of a near-zero gradient
    # into up to lr per element), moments leaf by leaf as the gradients
    for (path, g), w in zip(tree.flatten(tstate["params"]),
                            jax.tree.leaves(jstate["params"])):
        np.testing.assert_allclose(lm_np(g), np.asarray(w), rtol=2e-4,
                                   atol=2e-5, err_msg=path)
    for key in ("m", "v"):
        assert_grads_close(tstate["params"], tree.leaves(
            tstate["opt"][key]), jstate["opt"][key])


def test_microbatch_equivalence():
    """The twin of tests/test_substrate.py's: 4 micro-batches give the
    one-batch step."""
    _, tcfg, _, tp = smoke_models("starcoder2-15b")
    t1 = tstep.TrainConfig(remat="none", microbatches=1,
                           adamw=tadamw.AdamWConfig(lr=1e-3))
    t4 = dataclasses.replace(t1, microbatches=4)
    dcfg = ttokens.DataConfig(tcfg.vocab_size, 16, 8)
    batch = ttokens.shard_batch(ttokens.batch_at(dcfg, 0), "cpu")
    copy = tree.tree_map(lambda p: p.clone(), tp)
    s1 = {"params": tp, "opt": tadamw.init_state(tp), "seed": 1}
    s4 = {"params": copy, "opt": tadamw.init_state(copy), "seed": 1}
    s1, m1 = tstep.make_train_step(tcfg, t1)(s1, batch)
    s4, m4 = tstep.make_train_step(tcfg, t4)(s4, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    assert float(m4["aux_loss"]) == 0.0
    for a, b in zip(tree.leaves(s1["params"]), tree.leaves(s4["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)


# ---------------------------------------------------------------------------
# Data, schedule, clipping, the loss function, inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(vocab_size=1000, seq_len=32,
                                     global_batch=4, seed=3),
                                dict(vocab_size=32000, seq_len=64,
                                     global_batch=3, alphabet=16, noise=0.3)])
def test_batch_at_is_the_references_bit_for_bit(kw):
    jcfg, tcfg = jtokens.DataConfig(**kw), ttokens.DataConfig(**kw)
    for step in (0, 1, 17):
        want, got = jtokens.batch_at(jcfg, step), ttokens.batch_at(tcfg, step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    it = ttokens.iterate(tcfg, 5)
    np.testing.assert_array_equal(next(it)["tokens"],
                                  jtokens.batch_at(jcfg, 5)["tokens"])
    on = ttokens.shard_batch(ttokens.batch_at(tcfg, 0), "cpu")
    assert on["labels"].dtype == torch.int32 and on["tokens"].device.type \
        == "cpu"
    # on a mesh of one slot the rank's rows are the whole batch; a layout
    # mesh's rank of (data 2, model 2) would take its half
    mesh = tcol.LocalMesh({"data": 1, "model": 1}, "cpu")
    one = ttokens.shard_batch(ttokens.batch_at(tcfg, 0), "cpu", mesh=mesh)
    for k in on:
        assert torch.equal(one[k], on[k])
    with pytest.raises(ValueError, match="one slot a process"):
        ttokens.shard_batch(ttokens.batch_at(tcfg, 0), "cpu",
                            mesh=tcol.LocalMesh(2, "cpu"))


def test_schedule_and_clipping_match_reference():
    steps = [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]
    for kw in (dict(warmup=10, total=100), dict(warmup=0, total=7),
               dict(warmup=3, total=3, min_ratio=0.2)):
        for s in steps:
            want = float(jschedule.warmup_cosine(jnp.asarray(s), **kw))
            assert float(tschedule.warmup_cosine(s, **kw)) == pytest.approx(
                want, rel=1e-6, abs=1e-7)
            assert float(tschedule.warmup_cosine(
                torch.tensor(s, dtype=torch.int32), **kw)) == pytest.approx(
                want, rel=1e-6, abs=1e-7)
    assert float(tschedule.constant(torch.tensor(7))) == 1.0
    rng = np.random.default_rng(0)
    g = {"a": rng.standard_normal((4, 5)).astype(np.float32) * 3,
         "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    for max_norm in (1.0, 100.0):
        jc, jn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                            max_norm)
        tc, tn = tadamw.clip_by_global_norm(
            tree.tree_map(torch.from_numpy, g), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for a, b in zip(tree.leaves(tc), jax.tree.leaves(jc)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_adamw_reduces_quadratic():
    """The twin of tests/test_substrate.py's."""
    params = {"w": torch.tensor([2.0, -3.0])}
    state = tadamw.init_state(params)
    cfg = tadamw.AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = tadamw.apply_updates(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 1e-2


def test_xent_loss_matches_reference():
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((3, 5, 40)) * 4).astype(np.float32)
    labels = rng.integers(0, 33, (3, 5)).astype(np.int32)
    labels[0, :2] = -1
    labels[2, 4] = -7
    for real in (40, 33):
        want = float(jlayers.xent_loss(jnp.asarray(logits),
                                       jnp.asarray(labels), real_vocab=real))
        got = tlayers.xent_loss(torch.from_numpy(logits),
                                torch.from_numpy(labels), real_vocab=real)
        assert float(got) == pytest.approx(want, rel=1e-6)
    none = tlayers.xent_loss(torch.from_numpy(logits),
                             torch.full((3, 5), -1), real_vocab=40)
    assert float(none) == 0.0


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "whisper-small"])
def test_io_batches_match_reference(arch):
    jcfg, tcfg = jbase.get_smoke_config(arch), tbase.get_smoke_config(arch)
    for kind in ("train", "decode"):
        if kind == "train":
            want = jio.train_batch(jcfg, 2, 8)
            got = tio.train_batch(tcfg, 2, 8, device="cpu")
            meta = tio.train_batch(tcfg, 2, 8, abstract=True)
        else:
            want = jio.decode_batch(jcfg, 2)
            got = tio.decode_batch(tcfg, 2, device="cpu")
            meta = tio.decode_batch(tcfg, 2, abstract=True)
        assert set(got) == set(want) == set(meta)
        for k, w in want.items():
            assert tuple(got[k].shape) == tuple(w.shape) \
                == tuple(meta[k].shape)
            assert str(got[k].dtype).replace("torch.", "") == str(w.dtype)
            assert meta[k].device.type == "meta"
            assert not bool(got[k].any())


# ---------------------------------------------------------------------------
# The loop, checkpoints, the launcher
# ---------------------------------------------------------------------------

def _smoke_train(tmp_path, name, steps, log=None, lr=1e-3, mesh=None):
    cfg = tbase.get_smoke_config("phi4-mini-3.8b")
    tcfg = tstep.TrainConfig(remat="none", adamw=tadamw.AdamWConfig(lr=lr))
    dcfg = ttokens.DataConfig(cfg.vocab_size, 32, 4)
    lcfg = tloop.LoopConfig(steps=steps, ckpt_every=5,
                            ckpt_dir=str(tmp_path / name), log_every=100)
    return tloop.train(cfg, tcfg, lcfg, dcfg, device="cpu",
                       log=log or (lambda s: None), mesh=mesh)


def test_loop_resume_matches_straight_run(tmp_path):
    """The twin of tests/test_substrate.py's: 2 x 5 steps with a restart
    against 10 straight (rtol 1e-4, atol 1e-5)."""
    straight = _smoke_train(tmp_path, "a", 10)
    _smoke_train(tmp_path, "b", 5)
    logs = []
    resumed = _smoke_train(tmp_path, "b", 10, log=logs.append)
    assert logs[0] == "resumed from step 5"
    for a, b in zip(tree.leaves(straight["params"]),
                    tree.leaves(resumed["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)
    assert int(resumed["opt"]["step"]) == 10
    # the loop over a (1, 1) mesh runs the mesh path and lands on the
    # straight run's bits
    on_mesh = _smoke_train(tmp_path, "c", 10, mesh=tcol.LocalMesh(
        {"data": 1, "model": 1}, "cpu"))
    for a, b in zip(tree.leaves(straight["params"]),
                    tree.leaves(on_mesh["params"])):
        assert torch.equal(a, b)


def test_loss_falls_over_40_steps(tmp_path):
    """tests/test_system.py's criterion: the last logged loss below 0.85x
    the first over 40 steps (the same config, data and schedule)."""
    cfg = tbase.get_smoke_config("phi4-mini-3.8b")
    tcfg = tstep.TrainConfig(remat="none", adamw=tadamw.AdamWConfig(lr=3e-3),
                             warmup_steps=5, total_steps=40)
    dcfg = ttokens.DataConfig(cfg.vocab_size, 64, 8, alphabet=16)
    lcfg = tloop.LoopConfig(steps=40, ckpt_every=20, ckpt_dir=str(tmp_path),
                            log_every=10)
    lines = []
    tloop.train(cfg, tcfg, lcfg, dcfg, device="cpu", log=lines.append)
    losses = [float(re.search(r"loss=(\S+)", s).group(1)) for s in lines]
    assert len(losses) == 5 and losses[-1] < 0.85 * losses[0], losses
    assert re.fullmatch(r"step +39 loss=\S+ gnorm=\S+ \d+ms", lines[-1])


def test_train_state_checkpoints_cross_the_packages(tmp_path):
    """A port train state restores in the reference's Checkpointer under
    the reference's tree signature, and a reference one in the port's."""
    jcfg, tcfg, jp, tp = smoke_models("phi4-mini-3.8b")
    for opt in ("adamw", "galore"):
        jt, tt = jstep.TrainConfig(optimizer=opt), \
            tstep.TrainConfig(optimizer=opt)
        jopt = (jgalore.init_state(jp, jt.galore) if opt == "galore"
                else jadamw.init_state(jp))
        jstate = {"params": jp, "opt": jopt, "rng": jax.random.PRNGKey(1)}
        tstate = {"params": tp, "opt": tstep.init_opt_state(tt, tp),
                  "seed": 1}
        sig = jckpt.tree_signature(jstate)
        assert tckpt.tree_signature(tstep.checkpoint_tree(tstate)) == sig
        tckpt.Checkpointer(str(tmp_path / f"p{opt}")).save(
            3, tstep.checkpoint_tree(tstate), blocking=True)
        got, meta = jckpt.Checkpointer(str(tmp_path / f"p{opt}")).restore(
            expect_signature=sig)
        assert meta["step"] == 3
        np.testing.assert_array_equal(np.asarray(got["rng"]),
                                      np.asarray(jax.random.PRNGKey(1)))
        np.testing.assert_array_equal(np.asarray(got["params"]["embed"]),
                                      tp["embed"].numpy())
        jckpt.Checkpointer(str(tmp_path / f"j{opt}")).save(4, jstate,
                                                          blocking=True)
        saved, meta = tckpt.Checkpointer(str(tmp_path / f"j{opt}")).restore(
            device="cpu", expect_signature=sig)
        back = tstep.state_from_checkpoint(saved)
        assert meta["step"] == 4 and back["seed"] == 1
        assert back["opt"]["step"].dtype == torch.int32
        np.testing.assert_array_equal(back["params"]["embed"].numpy(),
                                      np.asarray(jstate["params"]["embed"]))


def test_launcher_trains_on_the_cpu_and_guards_the_mesh(tmp_path):
    lines = []
    state = tlaunch.main(["--arch", "zamba2-2.7b", "--smoke", "--steps", "2",
                          "--seq", "16", "--global-batch", "2",
                          "--device", "cpu"], log=lines.append)
    assert int(state["opt"]["step"]) == 2 and len(lines) == 2
    # --model-parallel 2 alone plans (1, 1); --coordinator joins a process
    # group (here of one gloo rank) and trains on its mesh
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for extra in (["--model-parallel", "2"],
                  ["--model-parallel", "2", "--coordinator",
                   f"localhost:{port}", "--num-hosts", "1", "--host-id",
                   "0"]):
        got = []
        state = tlaunch.main(["--arch", "zamba2-2.7b", "--smoke", "--steps",
                              "2", "--seq", "16", "--global-batch", "2",
                              "--device", "cpu", *extra], log=got.append)
        assert got[0] == "mesh: (1, 1) ('data', 'model') (0 devices idle)"
        assert int(state["opt"]["step"]) == 2 and len(got) == 3
    assert not torch.distributed.is_initialized()
    # --optimizer galore trains on the mesh too: the same losses as
    # without a coordinator (a group of one copies its collectives' input)
    logs = {}
    for name, extra in (("alone", []),
                        ("mesh", ["--coordinator", f"localhost:{port}",
                                  "--num-hosts", "1", "--host-id", "0"])):
        got = []
        state = tlaunch.main(["--arch", "zamba2-2.7b", "--smoke", "--steps",
                              "2", "--seq", "16", "--global-batch", "2",
                              "--device", "cpu", "--optimizer", "galore",
                              "--model-parallel", "2", *extra],
                             log=got.append)
        assert int(state["opt"]["step"]) == 2 and len(got) == 3
        assert "p" in state["opt"]["leaves"]["embed"]
        logs[name] = [ln.split()[:3] for ln in got[1:]]
    assert logs["mesh"] == logs["alone"]
    assert not torch.distributed.is_initialized()
    # what the mesh path still refuses: a LocalMesh of several slots for
    # the LM
    with pytest.raises(ValueError, match="one mesh slot a process"):
        tlayers.ShardCtx(tcol.LocalMesh({"data": 2, "model": 1}, "cpu"))


NEW_MODULES = ("optim/tree.py", "optim/schedule.py", "optim/adamw.py",
               "optim/__init__.py", "data/tokens.py", "models/io.py",
               "compression/galore.py", "compression/__init__.py",
               "core/spectral.py", "train/step.py", "train/loop.py",
               "train/__init__.py", "launch/train.py")


def test_new_modules_import_nothing_of_jax_or_the_reference():
    bad = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    for rel in NEW_MODULES + ("../../examples/train_lm_torch.py",
                              "../../examples/gradient_compression_torch.py"):
        path = os.path.join(REPO, "src", "repro_torch", rel)
        with open(path) as f:
            assert not bad.search(f.read()), rel
