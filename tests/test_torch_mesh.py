"""The LM model mesh of the port (``models/layers.ShardCtx``): its closed
forms against the reference's on abstract production meshes, and its
sharded serving and training paths on four gloo ranks on the CPU
(``data`` 2 x ``model`` 2) against the reference's single-device
computation and the port's own.

The reference's own mesh computations do not run on the installed jax
(``tests/test_distributed.py``'s sharded tests fail at the vocab-sharded
embedding gather), so each sharded result is held against the reference's
single-device ``forward_logits``, ``prefill_forward`` / ``decode_step`` and
``jax.value_and_grad`` of the same loss on the same numpy parameters and
batch (its kernels as its own tests run them, ``REPRO_KERNELS=ref``), and
against the port's single-device path, at the reference tests'
tolerances.  The closed
forms (``param_specs``, ``state_shardings``, ``cache_specs``,
``batch_specs``, ``input_specs``) are held against the reference's exactly,
over ``jax.sharding.AbstractMesh``.  Training, checkpoints and recovery on
the mesh: ``tests/test_torch_mesh_train.py``.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import base as jbase
from repro.models import io as jio
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import schema as jschema
from repro.models import transformer as jtr
from repro.models.layers import ShardCtx as JCtx
from repro.train import step as jstep

from repro_torch.configs import base as tbase
from repro_torch.core import collectives as tcol
from repro_torch.models import io as tio
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import schema as tschema
from repro_torch.models import transformer as ttr
from repro_torch.train import step as tstep

from test_torch_helpers import one_torch_thread, spawn_gloo  # noqa: F401

# loops of small torch ops in the parent: one torch thread (the helper)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

MESHES = {"dp4_tp2": {"data": 4, "model": 2},
          "pod": {"data": 16, "model": 16},
          "multipod": {"pod": 2, "data": 16, "model": 16}}


def _jmesh(shape):
    return AbstractMesh(tuple(shape.values()), tuple(shape),
                        axis_types=(AxisType.Auto,) * len(shape))


def _norm(spec):
    """A reference PartitionSpec or a port spec as a tuple of (None | tuple
    of axis names), one entry a dimension."""
    if isinstance(spec, NamedSharding):
        spec = spec.spec
    out = []
    for e in tuple(spec):
        if e is None or (isinstance(e, tuple) and not e):
            out.append(None)
        elif isinstance(e, str):
            out.append((e,))
        else:
            out.append(tuple(e))
    return tuple(out)


def _same_specs(port, ref, where=""):
    if isinstance(ref, dict):
        assert isinstance(port, dict) and set(port) == set(ref), \
            (where, sorted(set(port) ^ set(ref)))
        for k in ref:
            _same_specs(port[k], ref[k], f"{where}/{k}")
        return
    assert isinstance(ref, (P, NamedSharding)), (where, ref)
    assert _norm(port) == _norm(ref), (where, port, ref)


def _same_shapes(port, ref, where=""):
    if isinstance(ref, dict):
        assert set(port) == set(ref), where
        for k in ref:
            _same_shapes(port[k], ref[k], f"{where}/{k}")
        return
    if isinstance(port, torch.Tensor):
        assert port.device.type == "meta", where
        assert tuple(port.shape) == tuple(ref.shape), (where, port.shape,
                                                       ref.shape)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_closed_forms_equal_the_references(arch, mesh):
    """param_specs, state_shardings (AdamW and GaLore), cache_specs (with
    and without the sequence sharded), batch_specs and input_specs' specs
    of the published config on an abstract production mesh: the
    reference's, exactly."""
    jctx = JCtx(mesh=_jmesh(MESHES[mesh]))
    tctx = tlayers.ShardCtx(mesh=tlayers.layout_mesh(MESHES[mesh]))
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    _same_specs(tschema.param_specs(tcfg, tctx),
                jschema.param_specs(jcfg, jctx))
    for opt in ("adamw", "galore"):
        _same_specs(tstep.state_shardings(tcfg, tstep.TrainConfig(
            optimizer=opt), tctx), jstep.state_shardings(
            jcfg, jstep.TrainConfig(optimizer=opt), jctx))
    for seq in (False, True):
        _same_specs(ttr.cache_specs(tcfg, tctx, seq_sharded=seq),
                    jtr.cache_specs(jcfg, jctx, seq_sharded=seq))
    for kind in ("train", "prefill", "decode"):
        _same_specs(tio.batch_specs(tcfg, tctx, kind=kind),
                    jio.batch_specs(jcfg, jctx, kind=kind))
    for shape in jbase.SHAPES.values():
        targs, tspecs = tio.input_specs(tcfg, tbase.SHAPES[shape.name], tctx)
        jargs, jspecs = jio.input_specs(jcfg, shape, jctx)
        _same_specs(tspecs, jspecs)
        _same_shapes(targs, jargs)


def test_closed_forms_without_a_mesh():
    """No mesh: no state shardings, every param spec replicated, the
    abstract params' shapes the reference's."""
    cfg = tbase.get_config("zamba2-2.7b")
    ctx = tlayers.ShardCtx()
    assert tstep.state_shardings(cfg, tstep.TrainConfig(), ctx) is None
    assert tschema.param_shardings(cfg, ctx) is None
    specs = tschema.param_specs(cfg, ctx)
    assert all(e is None for e in specs["layers"]["wz"])
    _same_shapes(tschema.abstract_params(cfg),
                 jschema.abstract_params(jbase.get_config("zamba2-2.7b")))


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "qwen3-moe-235b-a22b"])
def test_moe_capacity_is_the_references_per_shard_arithmetic(arch):
    """Capacity over a data shard's tokens: the reference's ``_capacity``
    at every token count and factor."""
    for cf in (0.5, 1.0, 1.25, 8.0):
        jcfg = dataclasses.replace(jbase.get_config(arch), capacity_factor=cf)
        tcfg = dataclasses.replace(tbase.get_config(arch), capacity_factor=cf)
        for t in (1, 2, 3, 7, 64, 1000, 4096):
            assert tmoe._capacity(tcfg, t) == jmoe._capacity(jcfg, t)


def test_shard_ctx_without_a_mesh_is_the_single_device_path():
    """``ShardCtx(mesh=None)`` passed everywhere gives the same bits as
    the calls without a context (bf16 configs, the kernels' plain versions
    on the CPU)."""
    ctx = tlayers.ShardCtx()
    for arch in ("zamba2-2.7b", "phi3.5-moe-42b-a6.6b", "whisper-small"):
        cfg = tbase.get_smoke_config(arch)
        params = tschema.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
        assert all(torch.equal(a, b) for a, b in zip(
            tstep.tree.leaves(params), tstep.tree.leaves(
                tschema.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu", ctx=ctx))))
        batch = _batch(cfg, 2, 6)
        a, aux_a = ttr.forward_logits(cfg, params, batch)
        b, aux_b = ttr.forward_logits(cfg, params, batch, ctx=ctx)
        assert torch.equal(a, b) and float(aux_a) == float(aux_b)
        pre = {k: v[:, :4] if k != "frames" else v for k, v in batch.items()
               if k != "labels"}
        la, ca = ttr.prefill_forward(cfg, params, pre, max_seq=6)
        lb, cb = ttr.prefill_forward(cfg, params, pre, max_seq=6, ctx=ctx)
        assert torch.equal(la, lb)
        for t in (4, 5):
            step = {"tokens": batch["tokens"][:, t:t + 1]}
            if cfg.use_mrope:
                step["pos"] = batch["pos"][:, t:t + 1]
            la, ca = ttr.decode_step(cfg, params, ca, step)
            lb, cb = ttr.decode_step(cfg, params, cb, step, ctx=ctx)
            assert torch.equal(la, lb)
        tc = tstep.TrainConfig(remat="dots")
        _, ma, ga = tstep._grads(cfg, tc, params, batch)
        _, mb, gb = tstep._grads(cfg, tc, params, batch, ctx)
        assert torch.equal(ma["loss"], mb["loss"])
        assert all(torch.equal(x, y) for x, y in zip(
            tstep.tree.leaves(ga), tstep.tree.leaves(gb)))


def test_local_mesh_of_several_slots_is_refused_on_the_lm_path():
    with pytest.raises(ValueError, match="one mesh slot a process"):
        tlayers.ShardCtx(mesh=tcol.LocalMesh({"data": 2, "model": 2},
                                              "cpu"))
    one = tlayers.ShardCtx(mesh=tcol.LocalMesh({"data": 1, "model": 1},
                                               "cpu"))
    assert one.index(("model",)) == 0 and one.size(("data", "model")) == 1
    with pytest.raises(ValueError, match="holds 0 slots"):
        tlayers.ShardCtx(mesh=tlayers.layout_mesh({"model": 2})).index(
            ("model",))


# ---------------------------------------------------------------------------
# Sharded against single-device, on 4 gloo ranks (data 2 x model 2)
# ---------------------------------------------------------------------------

B, S = 4, 8
FAMILIES = {
    "dense": ("gemma2-9b", {}),
    "moe": ("phi3.5-moe-42b-a6.6b", {"capacity_factor": 8.0}),
    "ssm": ("mamba2-1.3b", {}),
    "hybrid": ("zamba2-2.7b", {}),
    "vlm": ("qwen2-vl-2b", {}),
    "encdec": ("whisper-small", {}),
    # 48 query heads over 3 KV heads: KV replicated over model 2, each
    # rank's 24 query heads straddle a group of 16
    "kv3": ("phi3-medium-14b", {"num_heads": 48, "num_kv_heads": 3}),
}


def _cfg(name):
    arch, over = FAMILIES[name]
    return dataclasses.replace(tbase.get_smoke_config(arch), dtype="float32",
                               **over)


def _batch(cfg, b, s, seed=0):
    """Tokens, next-token labels (the last and a few more -1), M-RoPE
    positions (three streams apart), encoder frames; seeded numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], -np.ones((b, 1), np.int32)], 1)
    labels[rng.random((b, s)) < 0.15] = -1
    out = {"tokens": torch.from_numpy(toks),
           "labels": torch.from_numpy(labels.astype(np.int32))}
    if cfg.use_mrope:
        base = np.arange(s)[None, :, None] + np.arange(b)[:, None, None]
        out["pos"] = torch.from_numpy(
            (base + np.array([0, 1, 2])).astype(np.int32))
    if cfg.is_encdec:
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return out


_BODY = ("""
import dataclasses
import numpy as np
import torch
from repro_torch.configs import base as tbase
from repro_torch.core import collectives as tcol
from repro_torch.models import convert
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import schema as tschema
from repro_torch.models import transformer as ttr
from repro_torch.train import step as tstep

B, S = 4, 8
FAMILIES = %r
""" % (FAMILIES,)) + "\n".join(
    __import__("inspect").getsource(f) for f in (_cfg, _batch)) + """

def rows(batch, ctx):
    ax = ctx.axes("batch")
    n, i = ctx.size(ax), ctx.index(ax)
    return {k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
            for k, v in batch.items()}


def family(name, ctx):
    cfg = _cfg(name)
    v_ax = ttr.vocab_axes(cfg, ctx)
    full = tschema.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    # numpy leaves (as the reference's are carried over) to this rank's
    # blocks
    local = convert.params_from_numpy(
        cfg, tstep.tree.tree_map(lambda x: x.numpy(), full), "cpu", ctx=ctx)
    batch = rows(_batch(cfg, B, S), ctx)
    out = {}
    with torch.no_grad():
        lg, aux = ttr.forward_logits(cfg, local, batch, ctx=ctx)
        out["logits"] = ctx.all_gather(lg, v_ax, dim=-1).numpy()
        pre = {k: (v[:, :S - 2] if k != "frames" else v)
               for k, v in batch.items() if k != "labels"}
        lg, cache = ttr.prefill_forward(cfg, local, pre, max_seq=S, ctx=ctx)
        steps = [ctx.all_gather(lg, v_ax, dim=-1).numpy()]
        for t in (S - 2, S - 1):
            st = {"tokens": batch["tokens"][:, t:t + 1]}
            if cfg.use_mrope:
                st["pos"] = batch["pos"][:, t:t + 1]
            lg, cache = ttr.decode_step(cfg, local, cache, st, ctx=ctx)
            steps.append(ctx.all_gather(lg, v_ax, dim=-1).numpy())
        out["decode"] = steps
    tc = tstep.TrainConfig(remat="dots")
    loss, metrics, grads = tstep._grads(cfg, tc, local, batch, ctx)
    grads = tstep._psum_tree(grads, ctx, ctx.axes("batch"))
    grads = tschema.gather_params(grads, cfg, ctx)
    out["loss"] = float(metrics["loss"])
    out["aux"] = float(metrics["aux_loss"])
    if ctx.index(("data", "model")) == 0:
        out["grads"] = {p: g.numpy() for p, g in tstep.tree.flatten(grads)}
    return out


def xent_case(ctx):
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((B, S, 40)).astype(
        np.float32) * 3)
    labels = rng.integers(0, 37, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.3] = -1
    labels = torch.from_numpy(labels)
    spec = (("data",), None, ("model",))
    loc = ctx.local(logits, spec).clone().requires_grad_(True)
    lab = ctx.local(labels, (("data",), None))
    loss = tlayers.xent_loss(loc, lab, real_vocab=37, ctx=ctx,
                             v_axes=("model",), b_axes=("data",))
    loss.backward()
    return float(loss), ctx.gather(loc.grad, spec).numpy()


def seq_sharded_case(ctx):
    # one request, its cache's 16 positions over data 2, heads over
    # model 2; the prompt filled on one device, then cut
    cfg = _cfg("hybrid")
    full = tschema.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    local = tschema.shard_params(full, cfg, ctx)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 10)).astype(np.int32))
    with torch.no_grad():
        _, cache = ttr.prefill_forward(cfg, full, {"tokens": toks[:, :6]},
                                       max_seq=16)
        mine = ttr.local_cache(cfg, cache, ctx, seq_sharded=True)
        v_ax = ttr.vocab_axes(cfg, ctx)
        got, changed = [], []
        for t in range(6, 10):
            before = mine["k"].clone()
            lg, mine = ttr.decode_step(cfg, local, mine,
                                       {"tokens": toks[:, t:t + 1]},
                                       ctx=ctx, seq_sharded=True)
            got.append(ctx.all_gather(lg, v_ax, dim=-1).numpy())
            diff = (mine["k"] != before).any(dim=(0, 1, 2, 4))
            changed.append(diff.nonzero()[:, 0].tolist())
    return dict(logits=got, changed=changed, slab=int(mine["k"].shape[3]),
                data=ctx.index(("data",)))


def moe_drop_case(ctx):
    cfg = dataclasses.replace(_cfg("moe"), capacity_factor=1.0)
    full = tschema.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    local = tschema.shard_params(full, cfg, ctx)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    pl = ttr.layer_params(local, 0)
    with torch.no_grad():
        y, aux = tmoe.moe_block(cfg, pl, rows({"x": x}, ctx)["x"], ctx=ctx)
    return y.numpy(), float(aux)


def main(rank, world):
    mesh = tcol.ProcessGroupMesh({"data": 2, "model": 2}, device="cpu")
    ctx = tlayers.ShardCtx(mesh=mesh)
    out = {"data": ctx.index(("data",)), "model": ctx.index(("model",))}
    out["families"] = {name: family(name, ctx) for name in FAMILIES}
    out["xent"] = xent_case(ctx)
    out["seq"] = seq_sharded_case(ctx)
    out["moe_drop"] = moe_drop_case(ctx)
    out["counts"] = dict(mesh.counts)
    return out
"""


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The 4 gloo ranks' results, and the single-device ones computed here
    while the ranks run."""
    return spawn_gloo(_BODY, 4, tmp_path_factory.mktemp("mesh"),
                      timeout=180, while_waiting=_singles)


@pytest.fixture(scope="module")
def ranks(mesh_runs):
    return mesh_runs[0]


def _jcfg(name):
    arch, over = FAMILIES[name]
    return dataclasses.replace(jbase.get_smoke_config(arch), dtype="float32",
                               **over)


def _reference(name, params, batch):
    """The reference's single-device results of ``name`` on the port's
    parameters and batch (as numpy): the logits, the prefill's and two
    decode steps' logits, and ``jax.value_and_grad`` of the loss the mesh
    computes (see :func:`_single_grads`); gradients by the port's paths
    (the reference's leaves are in their sorted order)."""
    jcfg, jctx = _jcfg(name), JCtx()
    jp = jax.tree.map(jnp.asarray,
                      tstep.tree.tree_map(lambda x: x.numpy(), params))
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    r = {"logits": np.asarray(jtr.forward_logits(jcfg, jp, jb, jctx)[0])}
    pre = {k: (v[:, :S - 2] if k != "frames" else v) for k, v in jb.items()
           if k != "labels"}
    lg, cache = jtr.prefill_forward(jcfg, jp, pre, jctx, max_seq=S)
    steps = [np.asarray(lg)]
    decode = jax.jit(lambda p, c, b: jtr.decode_step(jcfg, p, c, b, jctx))
    for t in (S - 2, S - 1):
        st = {"tokens": jb["tokens"][:, t:t + 1]}
        if jcfg.use_mrope:
            st["pos"] = jb["pos"][:, t:t + 1]
        lg, cache = decode(jp, cache, st)
        steps.append(np.asarray(lg))
    r["decode"] = steps

    def loss(p):
        logits, _ = jtr.forward_logits(jcfg, p, jb, jctx)
        xent = jlayers.xent_loss(logits, jb["labels"],
                                 real_vocab=jcfg.vocab_size)
        aux = jnp.zeros((), jnp.float32)
        if jcfg.family == "moe":
            for d in range(2):
                shard = {k: v[d * B // 2:(d + 1) * B // 2]
                         for k, v in jb.items()}
                aux = aux + jtr.forward_logits(jcfg, p, shard, jctx)[1] / 2
        return xent + aux, (xent, aux)

    (_, (xent, aux)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(jp)
    r["loss"], r["aux"] = float(xent), float(aux)
    r["grads"] = {p: np.asarray(g) for (p, _), g in zip(
        tstep.tree.flatten(params), jax.tree.leaves(grads))}
    return r


@pytest.fixture(scope="module")
def singles(mesh_runs):
    return mesh_runs[1]


def _singles():
    """The single-device results of every family: the port's without a
    mesh, and the reference's (``"reference"``) on the same inputs."""
    out = {}
    for name in FAMILIES:
        cfg = _cfg(name)
        params = tschema.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
        batch = _batch(cfg, B, S)
        r = {"reference": _reference(name, params, batch)}
        with torch.no_grad():
            r["logits"] = ttr.forward_logits(cfg, params, batch)[0].numpy()
            pre = {k: (v[:, :S - 2] if k != "frames" else v)
                   for k, v in batch.items() if k != "labels"}
            lg, cache = ttr.prefill_forward(cfg, params, pre, max_seq=S)
            steps = [lg.numpy()]
            for t in (S - 2, S - 1):
                st = {"tokens": batch["tokens"][:, t:t + 1]}
                if cfg.use_mrope:
                    st["pos"] = batch["pos"][:, t:t + 1]
                lg, cache = ttr.decode_step(cfg, params, cache, st)
                steps.append(lg.numpy())
            r["decode"] = steps
        r["loss"], r["aux"], r["grads"] = _single_grads(cfg, params, batch)
        out[name] = r
    return out


def _single_grads(cfg, params, batch):
    """The loss the mesh computes, on one device: the cross-entropy's mean
    over the whole batch plus the moe load-balance loss averaged over the
    data shards' (the reference's ``pmean`` of per-shard losses: the
    loss is a product of two means over the tokens, so it is not the
    whole batch's); gradients of every leaf."""
    live = tstep._live_params(params)
    leaves = tstep.tree.leaves(live)
    logits, _ = ttr.forward_logits(cfg, live, batch, remat="dots")
    loss = tlayers.xent_loss(logits, batch["labels"],
                             real_vocab=cfg.vocab_size)
    aux = torch.zeros(())
    if cfg.family == "moe":
        for d in range(2):
            shard = {k: v[d * B // 2:(d + 1) * B // 2]
                     for k, v in batch.items()}
            aux = aux + ttr.forward_logits(cfg, live, shard)[1] / 2
    gs = torch.autograd.grad(loss + aux, leaves, allow_unused=True)
    grads = tstep._restack(live, gs)
    return float(loss.detach()), float(aux.detach()), {
        p: g.numpy() for p, g in tstep.tree.flatten(grads)}


def _rows(x, data):
    h = x.shape[0] // 2
    return x[data * h:(data + 1) * h]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_sharded_logits_and_decode_match_one_device(ranks, singles, name):
    """forward_logits, prefill_forward and two decode_steps on (data 2,
    model 2), each rank's rows gathered over the vocab, against the
    reference's single-device results and the port's: the reference
    test's rtol 1e-3 / atol 1e-3 (tests/test_distributed.py); against the
    port's also within 1e-4."""
    for want in (singles[name]["reference"], singles[name]):
        for got in ranks:
            fam = got["families"][name]
            np.testing.assert_allclose(fam["logits"],
                                       _rows(want["logits"], got["data"]),
                                       rtol=1e-3, atol=1e-3)
            for a, b in zip(fam["decode"], want["decode"]):
                np.testing.assert_allclose(a, _rows(b, got["data"]),
                                           rtol=1e-3, atol=1e-3)
    for got in ranks:
        fam, want = got["families"][name], singles[name]
        assert np.abs(fam["logits"] - _rows(want["logits"], got["data"])
                      ).max() < 1e-4


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_sharded_train_loss_gradients_match_one_device(ranks, singles, name):
    """The gradients of ``train_loss`` (remat ``dots``) on the mesh, psummed
    over data and gathered, against the reference's ``jax.value_and_grad``
    on one device and the port's: per leaf max|diff| <= 1e-4 max|g|; the
    loss (a global mean on every rank) within 1e-5, the moe load-balance
    loss (the data shards' mean) within 1e-6."""
    for want in (singles[name]["reference"], singles[name]):
        for got in ranks:
            fam = got["families"][name]
            assert fam["loss"] == pytest.approx(want["loss"], abs=1e-5)
            assert fam["aux"] == pytest.approx(want["aux"], abs=1e-6)
        grads = ranks[0]["families"][name]["grads"]
        assert set(grads) == set(want["grads"])
        for path, g in want["grads"].items():
            scale = float(np.abs(g).max())
            assert scale > 0, path
            assert float(np.abs(grads[path] - g).max()) <= 1e-4 * scale, \
                path
    if FAMILIES[name][0].startswith("phi3.5-moe"):
        assert singles[name]["reference"]["aux"] > 0


def test_vocab_parallel_xent_matches_the_plain_loss(ranks):
    """Padded vocab (37 of 40: rank model 1 holds the padding), ignored
    labels, rows over data: the loss and its gradient against the plain
    ``xent_loss`` of the whole tensor."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((B, S, 40)).astype(
        np.float32) * 3).requires_grad_(True)
    labels = rng.integers(0, 37, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.3] = -1
    loss = tlayers.xent_loss(logits, torch.from_numpy(labels), real_vocab=37)
    loss.backward()
    for got in ranks:
        lval, grad = got["xent"]
        assert lval == pytest.approx(float(loss.detach()), rel=1e-6)
        np.testing.assert_allclose(grad, logits.grad.numpy(), rtol=0,
                                   atol=1e-7)


def test_sequence_sharded_decode_matches_the_unsharded_one(ranks):
    """zamba2 (smoke): a cache of 16 positions over data 2, heads over
    model 2; 4 decode steps against the unsharded decode (rtol / atol
    1e-3); at each step only the owning shard's slab changed, at the
    written position."""
    cfg = _cfg("hybrid")
    full = tschema.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 10)).astype(np.int32))
    with torch.no_grad():
        _, cache = ttr.prefill_forward(cfg, full, {"tokens": toks[:, :6]},
                                       max_seq=16)
        want = []
        for t in range(6, 10):
            lg, cache = ttr.decode_step(cfg, full, cache,
                                        {"tokens": toks[:, t:t + 1]})
            want.append(lg.numpy())
    for got in ranks:
        seq = got["seq"]
        assert seq["slab"] == 8
        for a, b in zip(seq["logits"], want):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)
            assert np.abs(a - b).max() < 1e-4
        lo = seq["data"] * 8
        for t, changed in zip(range(6, 10), seq["changed"]):
            assert changed == ([t - lo] if lo <= t < lo + 8 else []), t


def test_moe_drops_per_data_shard(ranks):
    """At capacity factor 1 tokens drop: each data shard's output is one
    device's moe_block over that shard's tokens alone (capacity reckoned
    over the shard), and the load-balance loss the shards' mean."""
    cfg = dataclasses.replace(_cfg("moe"), capacity_factor=1.0)
    full = tschema.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    pl = ttr.layer_params(full, 0)
    whole, _ = tmoe.moe_block(cfg, pl, x)
    shards = [tmoe.moe_block(cfg, pl, _rows(x, d)) for d in range(2)]
    aux = (float(shards[0][1]) + float(shards[1][1])) / 2
    for got in ranks:
        y, a = got["moe_drop"]
        np.testing.assert_allclose(y, shards[got["data"]][0].numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert a == pytest.approx(aux, rel=1e-6)
    # ... which is not the whole batch's: something dropped differently
    assert not np.allclose(np.concatenate([s[0].numpy() for s in shards]),
                           whole.numpy(), atol=1e-6)


def test_every_rank_ran_the_collectives(ranks):
    for got in ranks:
        assert got["counts"]["psum"] > 100 and got["counts"]["all_gather"] > 10
