"""The port's sharded engine (``backend="shard_map"``) against its own
single-host engine and against the reference's ``shard_map`` engine.

* ``core/collectives.py`` semantics on a ``LocalMesh`` (one process holding
  every slot) and on a 4-rank gloo group spawned on the CPU: psum over the
  whole mesh and over a sub-axis, the all-gather order, the flat index.
* The one-shot engine (``core/distributed.py``) on both backends against
  the port's ``single`` with the same seed (the repair bit for bit, the
  factors at 1e-5 of S[0]).
* Every sharded path against the reference's, given the reference's draws:
  the one-shot engine (sparse and dense, every method, gram / proxy /
  two-level, ``rank=k``, ``want_right``), the R5d ingest, the sharded
  window and the sharded ranker.  The reference runs once for the module,
  in one subprocess with 8 forced host devices that writes an ``.npz``.
* The shim's ``DeprecationWarning`` and the reference's error messages.
"""
import dataclasses
import os

import numpy as np
import jax
import pytest
import torch

from repro.core import sparse as jsparse

from repro_torch.core import api as tapi
from repro_torch.core import collectives as tcol
from repro_torch.core import convert
from repro_torch.core import distributed as tdist
from repro_torch.core import ranky as tranky
from repro_torch.core import sparse as tsparse
from repro_torch.serve import ServingSnapshot, ranker
from repro_torch.stream import state as tstate
from repro_torch.stream import window as tw

from conftest import run_forced_devices
from test_torch_helpers import (assert_same_factors, projector_gap,
                                reference_draws, reference_omega,
                                shard_map_draws, spawn_gloo)

CPU = "cpu"
KEY = jax.random.PRNGKey(11)
M, N, D = 24, 2048, 8
W = N // D
RANK, OVER = 6, 8

# (name, input, method, merge_mode, two_level, rank, want_right)
ONE_SHOT = [
    ("gram-none-dense", "dense", "none", "gram", False, None, False),
    ("gram-random-dense", "dense", "random", "gram", False, None, False),
    ("gram-neighbor-ell", "ell", "neighbor", "gram", False, None, False),
    ("gram-nr-ell", "ell", "neighbor_random", "gram", False, None, False),
    ("gram-nr-dense", "dense", "neighbor_random", "gram", False, None,
     False),
    ("proxy-nr-dense", "dense", "neighbor_random", "proxy", False, None,
     False),
    ("proxy-random-ell", "ell", "random", "proxy", False, None, False),
    ("twolevel-nr-dense", "dense", "neighbor_random", "proxy", True, None,
     False),
    ("twolevel-nr-ell", "ell", "neighbor_random", "proxy", True, None,
     False),
    ("rank-nr-dense", "dense", "neighbor_random", "gram", False, RANK,
     False),
    ("rank-random-ell", "ell", "random", "gram", False, RANK, True),
    ("right-nr-ell", "ell", "neighbor_random", "gram", False, None, True),
    ("right-neighbor-dense", "dense", "neighbor", "proxy", False, None,
     True),
]

# Column blocks over part of a (data 2, model 4) mesh, block_axes=("model",):
# (name, input, method, merge_mode, want_right)
PART_MESH = [
    ("gram-nr-ell", "ell", "neighbor_random", "gram", True),
    ("proxy-random-dense", "dense", "random", "proxy", False),
]
PART_D = 4

# The streams: (name, input kind, forced batch rank)
STREAMS = [("dense", "dense", None), ("coo", "coo", None),
           ("sketch", "coo", 4)]
SN, SMB, SK = 800, 10, 8

_REFERENCE = """
import json
import numpy as np, jax, jax.numpy as jnp
from repro.core import sparse, planner
from repro.core.api import (SolveConfig, svd, svd_init, svd_update,
                            ServeTopKConfig)
from repro.core.distributed import solve_shard_map
from repro.serve import ServingSnapshot, ranker
from repro.stream import StreamingSVDState, shard_state
from repro.stream import window as sw
assert jax.device_count() == 8
out = {}
M, N, D = %(M)d, %(N)d, %(D)d
key = jax.random.PRNGKey(11)
coo = sparse.ensure_full_row_rank(
    sparse.random_bipartite(M, N, 4e-3, seed=3, weighted=True), seed=3)
dense = jnp.asarray(sparse.pad_to_block_multiple(coo.todense(), D))
ell = sparse.block_ell_from_coo(coo, D)
mesh1 = jax.make_mesh((8,), ("model",))
mesh2 = jax.make_mesh((2, 4), ("pod", "model"))
for name, kind, method, merge, two, rank, right in %(cases)s:
    cfg = SolveConfig(backend="shard_map", method=method, merge_mode=merge,
                      two_level=two, rank=rank, want_right=right, key=key,
                      oversample=%(OVER)d)
    mesh, axes = (mesh2, ("pod", "model")) if two else (mesh1, ("model",))
    res = solve_shard_map(dense if kind == "dense" else ell, mesh,
                          block_axes=axes, config=cfg)
    for i, x in enumerate(res):
        out[f"{name}/{i}"] = np.asarray(x)

mesh3 = jax.make_mesh((2, %(PART_D)d), ("data", "model"))
ell4 = sparse.block_ell_from_coo(coo, %(PART_D)d)
for name, kind, method, merge, right in %(part)s:
    cfg = SolveConfig(backend="shard_map", method=method, merge_mode=merge,
                      want_right=right, key=key)
    res = solve_shard_map(dense if kind == "dense" else ell4, mesh3,
                          block_axes=("model",), config=cfg)
    for i, x in enumerate(res):
        out[f"part-{name}/{i}"] = np.asarray(x)

errors = []
for call in (
        lambda: solve_shard_map(sparse.block_ell_from_coo(coo, 4), mesh1,
                                block_axes=("model",),
                                config=SolveConfig(backend="shard_map")),
        lambda: solve_shard_map(ell, mesh1, block_axes=("model",),
                                config=SolveConfig(backend="shard_map",
                                                   local_mode="svd",
                                                   merge_mode="proxy")),
        lambda: solve_shard_map(dense[:, :-3], mesh1, block_axes=("model",),
                                config=SolveConfig(backend="shard_map"))):
    try:
        call()
        errors.append("")
    except ValueError as e:
        errors.append(str(e))
out["errors"] = np.asarray(errors)

scoo = sparse.ensure_full_row_rank(
    sparse.random_bipartite(40, %(SN)d, 0.03, seed=1, weighted=True), seed=1)
def rows(lo, hi):
    m = (scoo.rows >= lo) & (scoo.rows < hi)
    return sparse.COOMatrix(rows=(scoo.rows[m] - lo).astype(np.int32),
                            cols=scoo.cols[m], vals=scoo.vals[m],
                            shape=(hi - lo, scoo.shape[1]))
for name, kind, rank in %(streams)s:
    cfg = SolveConfig(method="neighbor_random", truncate_rank=%(SK)d,
                      num_blocks=D, oversample=4, rank=rank, key=key,
                      stream_backend="shard_map")
    st = svd_init(%(SN)d, cfg)
    for b in range(4):
        x = rows(%(SMB)d * b, %(SMB)d * (b + 1))
        r = svd_update(st, x.todense() if kind == "dense" else x, cfg)
        assert r.plan.backend == "shard_map", r.plan.backend
        st = r.state
    for f in ("u", "s", "v"):
        out[f"stream-{name}/{f}"] = np.asarray(getattr(st, f))
    out[f"stream-{name}/counts"] = np.asarray(
        [st.rows_seen, st.lonely_rows_seen, st.repaired_rows_seen])

wn, wk = 64, 8
wcfg = SolveConfig(truncate_rank=wk, num_blocks=D, stream_backend="shard_map",
                   key=key)
rng = np.random.default_rng(0)
wb = [rng.standard_normal((8, wn)).astype(np.float32)
      * (rng.random((8, wn)) < 0.3) for _ in range(6)]
wb[3][2, :] = 0.0
st = svd_update(svd_init(wn, wcfg), wb[0], wcfg).state
spec = planner.ASpec(m=8, n=wn, nnz=8 * wn, num_blocks=D, kind="stream")
plan = planner.make_window_plan(spec, wcfg, device_count=8)
assert plan.backend == "shard_map"
st, info = sw.ingest_window(st, wb[1:], wcfg, plan)
for f in ("u", "s", "v"):
    out[f"window/{f}"] = np.asarray(getattr(st, f))
out["window/counts"] = np.asarray([info.lonely_rows, info.repaired_rows])

rng = np.random.default_rng(7)
rk, rn = 6, 197
ru = rng.integers(-2, 3, size=(5, rk)).astype(np.float32)
rs = rng.integers(1, 4, size=rk).astype(np.float32)
rv = rng.integers(-2, 3, size=(D * 25, rk)).astype(np.float32)
rq = rng.integers(-3, 4, size=(6, rk)).astype(np.float32)
jst = StreamingSVDState(u=jnp.asarray(ru), s=jnp.asarray(rs),
                        v=jnp.asarray(rv), key=key, n=rn, num_blocks=D,
                        rows_seen=5, batches_seen=1, lonely_rows_seen=0,
                        repaired_rows_seen=0)
for quant in (False, True):
    res = ranker.score_topk(
        ServingSnapshot.from_state(shard_state(jst), quantize=quant),
        jnp.asarray(rq), 9, sharded=True)
    out[f"ranker-{int(quant)}/scores"] = np.asarray(res.scores)
    out[f"ranker-{int(quant)}/indices"] = np.asarray(res.indices)
np.savez(%(path)r, **out)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "shard_map.npz")
    out = run_forced_devices(_REFERENCE % dict(
        M=M, N=N, D=D, OVER=OVER, SN=SN, SMB=SMB, SK=SK, path=path,
        cases=repr([c for c in ONE_SHOT]), streams=repr(STREAMS),
        part=repr(PART_MESH), PART_D=PART_D))
    assert "REFERENCE_OK" in out
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _coo():
    jcoo = jsparse.ensure_full_row_rank(
        jsparse.random_bipartite(M, N, 4e-3, seed=3, weighted=True), seed=3)
    return jcoo, convert.coo_from_numpy(jcoo.rows, jcoo.cols, jcoo.vals,
                                        jcoo.shape)


def _port_input(kind, tcoo):
    if kind == "dense":
        return torch.from_numpy(tsparse.pad_to_block_multiple(
            tcoo.todense(), D))
    return tsparse.block_ell_from_coo(tcoo, D, device=CPU)


def _oracle_slots(shape):
    """Per-slot coordinates of a row-major mesh, as numpy."""
    return np.stack(np.unravel_index(np.arange(int(np.prod(shape))), shape),
                    axis=1)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [{"blocks": 8}, {"pod": 2, "model": 4}])
def test_local_mesh_collectives_against_a_numpy_oracle(shape):
    mesh = tcol.LocalMesh(shape, CPU)
    sizes = tuple(shape.values())
    rng = np.random.default_rng(0)
    x = rng.standard_normal((mesh.size, 3, 2)).astype(np.float32)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(mesh.psum(xt).numpy(), x.sum(0)[None],
                               rtol=1e-6)
    g = mesh.all_gather(xt)
    assert g.shape == (1, mesh.size, 3, 2)
    np.testing.assert_array_equal(g[0].numpy(), x)
    assert mesh.axis_index().tolist() == list(range(mesh.size))
    assert mesh.axis_size() == mesh.size
    if len(sizes) == 2:
        grid = x.reshape(sizes + (3, 2))
        # Sub-axis psum: one sum per pod (over its models), and per model.
        np.testing.assert_allclose(mesh.psum(xt, "model").numpy(),
                                   grid.sum(1), rtol=1e-6)
        np.testing.assert_allclose(mesh.psum(xt, "pod").numpy(),
                                   grid.sum(0), rtol=1e-6)
        np.testing.assert_array_equal(mesh.all_gather(xt, "model").numpy(),
                                      grid)
        np.testing.assert_array_equal(mesh.all_gather(xt, "pod").numpy(),
                                      grid.transpose(1, 0, 2, 3))
        coords = _oracle_slots(sizes)
        assert mesh.axis_index("model").tolist() == coords[:, 1].tolist()
        assert mesh.axis_index(("model", "pod")).tolist() == \
            (coords[:, 1] * 2 + coords[:, 0]).tolist()
        # A value that varies over the pods only: gather it over them.
        per_pod = torch.from_numpy(grid.sum(1))
        np.testing.assert_array_equal(
            mesh.all_gather(per_pod, "pod", over="pod")[0].numpy(),
            grid.sum(1))
    # Ascending slot order, the same bits every call.
    assert torch.equal(mesh.psum(xt), mesh.psum(xt))


def test_local_mesh_validates_axes_and_shapes():
    mesh = tcol.LocalMesh({"pod": 2, "model": 4}, CPU)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh.psum(torch.zeros(8, 1), "rows")
    with pytest.raises(ValueError, match="leading dimension"):
        mesh.psum(torch.zeros(4, 1))
    with pytest.raises(ValueError, match="varies only over"):
        mesh.psum(torch.zeros(2, 1), "model", over="pod")
    with pytest.raises(ValueError, match="size"):
        tcol.LocalMesh({"blocks": 0}, CPU)
    with pytest.raises(RuntimeError, match="process group"):
        tcol.ProcessGroupMesh(4)


_GLOO_BODY = """
import numpy as np
from repro_torch.core import api, collectives, sparse
from repro_torch.stream import state as sst, window as sw
from repro_torch.serve import ServingSnapshot, ranker
from repro_torch.checkpoint import Checkpointer

def main(rank, world):
    out = {}
    m2 = collectives.ProcessGroupMesh({"pod": 2, "model": 2}, device="cpu")
    x = torch.arange(6, dtype=torch.float32).reshape(1, 3, 2) + 10 * rank
    out["psum"] = m2.psum(x).numpy()
    out["psum_model"] = m2.psum(x, "model").numpy()
    out["gather"] = m2.all_gather(x).numpy()
    out["gather_pod"] = m2.all_gather(x, "pod").numpy()
    out["gather_rev"] = m2.all_gather(x, ("model", "pod")).numpy()
    out["index"] = m2.axis_index(("model", "pod")).tolist()
    mesh = collectives.ProcessGroupMesh(world, device="cpu")
    coo = sparse.ensure_full_row_rank(
        sparse.random_bipartite(24, 2048, 4e-3, seed=3, weighted=True),
        seed=3)
    for name, kw in (("gram", {}), ("proxy", dict(merge_mode="proxy")),
                     ("rank", dict(rank=6)), ("right", dict(want_right=True))):
        res = api.svd(coo, backend="shard_map", mesh=mesh, key=5, **kw)
        out[name] = [t.numpy() for t in (res.u, res.s)] + (
            [res.v.numpy()] if res.v is not None else [])
    two = api.svd(coo, backend="shard_map", mesh=m2, merge_mode="proxy",
                  two_level=True, key=5)
    out["two"] = two.s.numpy()
    part = api.svd(coo, backend="shard_map", mesh=m2, block_axes=("model",),
                   want_right=True, key=5)
    out["part"] = [part.u.numpy(), part.s.numpy(), part.v.numpy()]
    from repro_torch import ft
    # Survivors' meshes: every rank takes part in making the groups; a
    # rank outside the plan holds no slot.
    subs = []
    for plan, slots in ((ft.plan_stream_mesh(3, 2), [0, 2, 3]),
                        (ft.plan_mesh(2, model_parallel=2), [1, 3])):
        sub = ft.build_mesh(plan, mesh, slots=slots)
        x = torch.full((1, 2), float(rank + 1))
        subs.append(None if sub is None else (
            dict(sub.shape), sub.rank, sub.psum(x).tolist(),
            sub.psum(x, sub.axis_names[-1]).tolist()))
    out["subs"] = subs
    sst.set_stream_devices(mesh)
    cfg = api.SolveConfig(truncate_rank=8, num_blocks=world, key=5)
    rng = np.random.default_rng(0)
    xs = [(rng.random((16, 600)) < 0.02).astype(np.float32) * (1 + b)
          for b in range(5)]
    st = api.svd_init(600, cfg, device="cpu")
    for x in xs[:3]:
        r = api.svd_update(st, x, cfg)
        st = r.state
    out["ingest_backend"] = r.plan.backend
    res = api.svd_stream(xs[3:], cfg, state=st)
    res1 = api.svd_stream(xs[3:], dataclasses_replace(cfg, window=1),
                          state=st)
    gathered = sst.gather_state(res.state)
    out["stream"] = [gathered.u.numpy(), gathered.s.numpy(),
                     gathered.v.numpy()]
    out["window_vs_loop"] = bool(torch.equal(res.state.v, res1.state.v)
                                 and torch.equal(res.state.u, res1.state.u))
    out["counts"] = [gathered.lonely_rows_seen, gathered.repaired_rows_seen]
    h = api.serve_init(res.state, k_top=7)
    out["serve_backend"] = h.plan.backend
    q = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (5, 8)).astype(np.float32))
    w = api.serve_topk(h, q)
    out["wave"] = [w.scores.numpy(), w.indices.numpy()]
    ck = Checkpointer(out_dir + "/ck")
    ck.save(0, res.state, blocking=True)
    dist.barrier()
    back, _ = ck.restore(0, shardings=mesh)
    out["restore"] = bool(torch.equal(back.v, res.state.v)
                          and torch.equal(back.u, res.state.u))
    sst.set_stream_devices(None)
    out["collective_counts"] = dict(mesh.counts)
    return out

def dataclasses_replace(cfg, **kw):
    import dataclasses
    return dataclasses.replace(cfg, **kw)
"""


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    return spawn_gloo(_GLOO_BODY, 4, tmp_path_factory.mktemp("gloo"),
                      timeout=60)


def test_process_group_collectives_match_the_local_mesh(gloo):
    """The same collectives on a 4-rank gloo group (pod 2 x model 2) as a
    local mesh computes them: each rank holds its slot's entry."""
    x = (torch.arange(6, dtype=torch.float32).reshape(1, 3, 2)
         + 10 * torch.arange(4, dtype=torch.float32)[:, None, None])
    local = tcol.LocalMesh({"pod": 2, "model": 2}, CPU)
    for rank, got in enumerate(gloo):
        pod = rank // 2
        np.testing.assert_array_equal(got["psum"], local.psum(x).numpy())
        np.testing.assert_array_equal(got["psum_model"][0],
                                      local.psum(x, "model")[pod].numpy())
        np.testing.assert_array_equal(got["gather"], local.all_gather(x))
        np.testing.assert_array_equal(
            got["gather_pod"][0], local.all_gather(x, "pod")[rank % 2])
        np.testing.assert_array_equal(
            got["gather_rev"][0], local.all_gather(x, ("model", "pod"))[0])
        assert got["index"] == [local.flat_index(rank, ("model", "pod"))]


def test_process_group_solves_match_the_local_mesh(gloo):
    """One block a rank (4 ranks) against one process holding the 4 slots:
    the same seed, the same factors to float32 rounding; each rank's V is
    its own block's rows."""
    jcoo, tcoo = _coo()
    local = tcol.LocalMesh(4, CPU)
    for name, kw in (("gram", {}), ("proxy", dict(merge_mode="proxy")),
                     ("rank", dict(rank=6)), ("right", dict(want_right=True))):
        want = tapi.svd(tcoo, backend="shard_map", mesh=local, key=5, **kw)
        for rank, got in enumerate(gloo):
            u, s = got[name][:2]
            assert_same_factors(u, s, want.u.numpy(), want.s.numpy(),
                                rtol=1e-5, top=4)
            if kw.get("want_right"):
                # This rank's rows of V, its columns' signs taken from U.
                rows = want.v.numpy()[rank * 512:(rank + 1) * 512, :4]
                sign = np.sign((u[:, :4] * want.u.numpy()[:, :4]).sum(0))
                np.testing.assert_allclose(got[name][2][:, :4] * sign, rows,
                                           rtol=0,
                                           atol=1e-4 * np.abs(rows).max())
    two = tapi.svd(tcoo, backend="shard_map",
                   mesh=tcol.LocalMesh({"pod": 2, "model": 2}, CPU),
                   merge_mode="proxy", two_level=True, key=5)
    for got in gloo:
        np.testing.assert_allclose(got["two"], two.s.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(two.s[0]))


def test_process_group_solves_over_part_of_a_mesh(gloo):
    """block_axes=("model",) on the (pod 2, model 2) gloo group: each rank
    solves its model coordinate's block within the sub-group of its pod,
    as a local mesh of the same shape does; V is the rank's block."""
    _, tcoo = _coo()
    want = tapi.svd(tcoo, backend="shard_map",
                    mesh=tcol.LocalMesh({"pod": 2, "model": 2}, CPU),
                    block_axes=("model",), want_right=True, key=5)
    w = N // 2
    for rank, got in enumerate(gloo):
        u, s, v = got["part"]
        assert_same_factors(u, s, want.u.numpy(), want.s.numpy(), rtol=1e-5,
                            top=4)
        rows = want.v.numpy()[(rank % 2) * w:(rank % 2 + 1) * w, :4]
        sign = np.sign((u[:, :4] * want.u.numpy()[:, :4]).sum(0))
        np.testing.assert_allclose(v[:, :4] * sign, rows, rtol=0,
                                   atol=1e-4 * np.abs(rows).max())


def test_process_group_build_mesh_makes_a_sub_group_of_survivors(gloo):
    """ft.build_mesh on a 4-rank pool: a 1-D stream plan on slots 0, 2, 3
    takes ranks 0 and 2; a (data 1, model 2) plan on slots 1 and 3 makes
    its sub-groups on every rank, members or not."""
    x = [float(r + 1) for r in range(4)]
    for rank, got in enumerate(gloo):
        stream, grid = got["subs"]
        if rank in (0, 2):
            assert stream == ({"blocks": 2}, rank // 2,
                              [[x[0] + x[2]] * 2], [[x[0] + x[2]] * 2])
        else:
            assert stream is None
        if rank in (1, 3):
            assert grid == ({"data": 1, "model": 2}, rank // 2,
                            [[x[1] + x[3]] * 2], [[x[1] + x[3]] * 2])
        else:
            assert grid is None


def test_process_group_stream_window_ranker_and_checkpoint(gloo):
    """The sharded ingest, window, ranker and restore on 4 gloo ranks:
    the same stream as a local mesh of 4 slots, windows equal to
    ``window=1`` bit for bit, the wave equal on every rank, a file saved
    gathered restored sharded."""
    tstate.set_stream_devices(tcol.LocalMesh(4, CPU))
    try:
        cfg = tapi.SolveConfig(truncate_rank=8, num_blocks=4, key=5)
        rng = np.random.default_rng(0)
        xs = [(rng.random((16, 600)) < 0.02).astype(np.float32) * (1 + b)
              for b in range(5)]
        st = tapi.svd_init(600, cfg, device=CPU)
        for x in xs[:3]:
            st = tapi.svd_update(st, x, cfg).state
        res = tapi.svd_stream(xs[3:], cfg, state=st)
        h = tapi.serve_init(res.state, k_top=7)
        q = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (5, 8)).astype(np.float32))
        wave = tapi.serve_topk(h, q)
    finally:
        tstate.set_stream_devices(None)
    for got in gloo:
        assert got["ingest_backend"] == "shard_map"
        assert got["serve_backend"] == "shard_map"
        assert got["window_vs_loop"] and got["restore"]
        u, s, v = got["stream"]
        assert_same_factors(u, s, res.state.u.numpy(), res.state.s.numpy(),
                            rtol=1e-4, top=4)
        assert projector_gap(v[:, :4], res.state.v.numpy()[:, :4]) < 1e-3
        assert got["counts"] == [res.state.lonely_rows_seen,
                                 res.state.repaired_rows_seen]
        np.testing.assert_array_equal(got["wave"][1], gloo[0]["wave"][1])
        np.testing.assert_array_equal(got["wave"][0], gloo[0]["wave"][0])
        assert got["collective_counts"]["psum"] > 0
    # The sharded wave equals the dense path on the ranks' own factors
    # (the signs of a factor column are free, so not on the local mesh's).
    own = convert.state_from_numpy(
        u, s, v, n=600, num_blocks=4, rows_seen=res.state.rows_seen,
        batches_seen=res.state.batches_seen, lonely_rows_seen=0,
        repaired_rows_seen=0, device=CPU)
    dense = ranker.score_topk(ServingSnapshot.from_state(own), q, 7)
    np.testing.assert_array_equal(gloo[0]["wave"][0], dense.scores.numpy())
    np.testing.assert_array_equal(gloo[0]["wave"][1], dense.indices.numpy())
    assert wave.scores.shape == dense.scores.shape


# ---------------------------------------------------------------------------
# The port's shard_map against its own single with the same seed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "ell"])
@pytest.mark.parametrize("method", ["random", "neighbor", "neighbor_random"])
def test_shard_repair_equals_split_and_repair_bit_for_bit(kind, method):
    _, tcoo = _coo()
    a = _port_input(kind, tcoo)
    mesh = tcol.LocalMesh(D, CPU)
    single = tranky.split_and_repair(a, D, method, 9)
    local = tdist.local_blocks(a, mesh, D)
    if kind == "dense":
        got = tdist._local_repair(local, mesh, mesh.axis_names, method, 9)
        assert torch.equal(got, single)
    else:
        got = tdist._sparse_local_repair(local, mesh, mesh.axis_names,
                                         method, 9)
        assert torch.equal(got.repair_cols[got.repair_mask],
                           single.repair_cols[single.repair_mask])
        assert torch.equal(got.repair_mask, single.repair_mask)


@pytest.mark.parametrize("kind", ["dense", "ell"])
@pytest.mark.parametrize("kw", [
    dict(), dict(merge_mode="proxy"), dict(rank=RANK),
    dict(want_right=True), dict(rank=RANK, want_right=True),
    dict(merge_mode="proxy", two_level=True),
], ids=["gram", "proxy", "rank", "right", "rank-right", "two-level"])
def test_shard_map_equals_single_for_the_same_seed(kind, kw):
    _, tcoo = _coo()
    a = _port_input(kind, tcoo)
    mesh = (tcol.LocalMesh({"pod": 2, "model": 4}, CPU)
            if kw.get("two_level") else tcol.LocalMesh(D, CPU))
    single_kw = {k: v for k, v in kw.items() if k != "two_level"}
    r1 = tapi.svd(a, backend="single", num_blocks=D, key=9, device=CPU,
                  **single_kw)
    r2 = tapi.svd(a, backend="shard_map", mesh=mesh, key=9, **kw)
    assert r2.plan.backend == "shard_map"
    s1 = r1.s.numpy()
    np.testing.assert_allclose(r2.s.numpy(), s1, rtol=0, atol=1e-5 * s1[0])
    assert projector_gap(r2.u.numpy()[:, :4], r1.u.numpy()[:, :4]) < 1e-4
    if kw.get("want_right"):
        assert r2.v.shape == r1.v.shape == (N, r1.s.shape[0])
        assert projector_gap(r2.v.numpy()[:, :4], r1.v.numpy()[:, :4]) < 1e-4
    assert r2.diagnostics.repaired_rows == r1.diagnostics.repaired_rows


def test_a_local_mesh_repeats_its_bits():
    _, tcoo = _coo()
    mesh = tcol.LocalMesh(D, CPU)
    a = tapi.svd(tcoo, backend="shard_map", mesh=mesh, rank=RANK, key=3)
    b = tapi.svd(tcoo, backend="shard_map", mesh=mesh, rank=RANK, key=3)
    assert torch.equal(a.u, b.u) and torch.equal(a.s, b.s)


# ---------------------------------------------------------------------------
# Against the reference's shard_map engine, its draws injected
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ONE_SHOT, ids=[c[0] for c in ONE_SHOT])
def test_one_shot_matches_the_reference_shard_map(ref, case):
    name, kind, method, merge, two, rank, right = case
    jcoo, tcoo = _coo()
    a = _port_input(kind, tcoo)
    score_cols = W if kind == "dense" else a.capacity[0]
    draws = shard_map_draws(KEY, method, D, M, W, score_cols)
    omega = (reference_omega(KEY, min(rank + OVER, M), M) if rank else None)
    mesh = (tcol.LocalMesh({"pod": 2, "model": 4}, CPU) if two
            else tcol.LocalMesh({"model": D}, CPU))
    cfg = tapi.SolveConfig(backend="shard_map", method=method,
                           merge_mode=merge, two_level=two, rank=rank,
                           want_right=right, oversample=OVER)
    out = tdist.solve_shard_map(a, mesh, block_axes=mesh.axis_names,
                                config=cfg, draws=draws, omega=omega)
    ju, js = ref[f"{name}/0"], ref[f"{name}/1"]
    top = 6
    assert_same_factors(out[0].numpy(), out[1].numpy(), ju, js, top=top)
    if right:
        jv = ref[f"{name}/2"]
        assert out[2].shape == jv.shape
        assert projector_gap(out[2].numpy()[:, :top], jv[:, :top]) < 1e-3


@pytest.mark.parametrize("case", PART_MESH, ids=[c[0] for c in PART_MESH])
def test_part_of_a_mesh_matches_the_reference_shard_map(ref, case):
    """block_axes=("model",) on a (data 2, model 4) local mesh: four column
    blocks, each held by the two slots along "data", against the
    reference's shard_map on the same mesh of forced devices (block d
    repairs with fold_in(key, d), d the flat index over the block axes).
    S within 1e-5 of S[0], U and V by subspace."""
    name, kind, method, merge, right = case
    _, tcoo = _coo()
    w = N // PART_D
    if kind == "dense":
        a = torch.from_numpy(tsparse.pad_to_block_multiple(tcoo.todense(),
                                                           PART_D))
        score_cols = w
    else:
        a = tsparse.block_ell_from_coo(tcoo, PART_D, device=CPU)
        score_cols = a.capacity[0]
    draws = shard_map_draws(KEY, method, PART_D, M, w, score_cols)
    mesh = tcol.LocalMesh({"data": 2, "model": PART_D}, CPU)
    cfg = tapi.SolveConfig(backend="shard_map", method=method,
                           merge_mode=merge, want_right=right)
    res = tapi.svd(a, cfg, mesh=mesh, block_axes=("model",), draws=draws)
    assert res.plan.backend == "shard_map"
    ju, js = ref[f"part-{name}/0"], ref[f"part-{name}/1"]
    np.testing.assert_allclose(res.s.numpy(), js, rtol=0, atol=1e-5 * js[0])
    assert projector_gap(res.u.numpy()[:, :6], ju[:, :6]) < 1e-3
    if right:
        jv = ref[f"part-{name}/2"]
        assert res.v.shape == jv.shape
        assert projector_gap(res.v.numpy()[:, :6], jv[:, :6]) < 1e-3
    # The replicated slots add nothing: the same bits as a mesh of the
    # four blocks alone, and the collectives tallied on the mesh passed.
    alone = tapi.svd(a, cfg, mesh=tcol.LocalMesh({"model": PART_D}, CPU),
                     draws=draws)
    assert torch.equal(res.u, alone.u) and torch.equal(res.s, alone.s)
    assert sum(mesh.counts.values()) > 0


def test_shim_warns_and_runs_the_same_engine():
    _, tcoo = _coo()
    ell = tsparse.block_ell_from_coo(tcoo, D, device=CPU)
    mesh = tcol.LocalMesh({"model": D}, CPU)
    with pytest.warns(DeprecationWarning, match="distributed_ranky_svd"):
        u, s = tdist.distributed_ranky_svd(ell, mesh, key=4)
    res = tapi.svd(ell, tapi.SolveConfig(backend="shard_map", key=4),
                   mesh=mesh, block_axes=("model",))
    assert torch.equal(res.u, u) and torch.equal(res.s, s)


def test_errors_carry_the_references_messages(ref):
    _, tcoo = _coo()
    mesh = tcol.LocalMesh({"model": D}, CPU)
    dense = _port_input("dense", tcoo)
    calls = [
        lambda: tdist.solve_shard_map(
            tsparse.block_ell_from_coo(tcoo, 4, device=CPU), mesh,
            block_axes=("model",), config=tapi.SolveConfig(
                backend="shard_map")),
        lambda: tdist.solve_shard_map(
            tsparse.block_ell_from_coo(tcoo, D, device=CPU), mesh,
            block_axes=("model",), config=tapi.SolveConfig(
                backend="shard_map", local_mode="svd", merge_mode="proxy")),
        lambda: tdist.solve_shard_map(
            dense[:, :-3], mesh, block_axes=("model",),
            config=tapi.SolveConfig(backend="shard_map")),
    ]
    for call, want in zip(calls, ref["errors"]):
        with pytest.raises(ValueError) as err:
            call()
        assert str(err.value) == str(want)
    with pytest.raises(ValueError, match="mesh only applies"):
        tapi.svd(tcoo, backend="single", mesh=mesh)
    # block_axes may name part of the mesh (the other axes replicate), but
    # only axes of the mesh, in its order.
    with pytest.raises(ValueError, match="unknown mesh axis"):
        tapi.svd(tcoo, backend="shard_map",
                 mesh=tcol.LocalMesh({"pod": 2, "model": 4}, CPU),
                 block_axes=("rows",))
    with pytest.raises(ValueError, match="in the mesh's order"):
        tapi.svd(tcoo, backend="shard_map",
                 mesh=tcol.LocalMesh({"pod": 2, "model": 4}, CPU),
                 block_axes=("model", "pod"))
    with pytest.raises(ValueError, match="one device per block"):
        tapi.svd(tcoo, backend="shard_map", num_blocks=D, device=CPU)


def _stream_rows(lo, hi):
    jcoo = jsparse.ensure_full_row_rank(
        jsparse.random_bipartite(40, SN, 0.03, seed=1, weighted=True), seed=1)
    m = (jcoo.rows >= lo) & (jcoo.rows < hi)
    return jsparse.COOMatrix(rows=(jcoo.rows[m] - lo).astype(np.int32),
                             cols=jcoo.cols[m], vals=jcoo.vals[m],
                             shape=(hi - lo, SN))


@pytest.mark.parametrize("stream", STREAMS, ids=[s[0] for s in STREAMS])
def test_sharded_ingest_matches_the_reference(ref, stream):
    """The R5d ingest on a local mesh of 8 slots against the reference's
    on 8 forced devices, the reference's per-batch draws injected."""
    name, kind, rank = stream
    tcfg = tapi.SolveConfig(method="neighbor_random", truncate_rank=SK,
                            num_blocks=D, oversample=4, rank=rank,
                            stream_backend="shard_map")
    tstate.set_stream_devices(tcol.LocalMesh(D, CPU))
    try:
        st = tapi.svd_init(SN, tcfg, device=CPU)
        for b in range(4):
            jx = _stream_rows(SMB * b, SMB * (b + 1))
            kb = jax.random.fold_in(KEY, b)
            if kind == "dense":
                x = jx.todense()
                w = jsparse.block_width(SN, D)
                draws = reference_draws(kb, "neighbor_random", D, SMB, w, w)
            else:
                x = convert.coo_from_numpy(jx.rows, jx.cols, jx.vals,
                                           jx.shape)
                jell = jsparse.block_ell_from_coo(jx, D)
                draws = reference_draws(kb, "neighbor_random", D, SMB,
                                        jell.width, jell.col_rows.shape[1])
            omega = (reference_omega(kb, min(rank + 4, SMB), SMB)
                     if rank else None)
            r = tapi.svd_update(st, x, tcfg, draws=draws, omega=omega)
            assert r.plan.backend == "shard_map"
            st = r.state
    finally:
        tstate.set_stream_devices(None)
    js = ref[f"stream-{name}/s"]
    np.testing.assert_allclose(st.s.numpy(), js, rtol=1e-4,
                               atol=1e-5 * js[0])
    assert [st.rows_seen, st.lonely_rows_seen, st.repaired_rows_seen] == \
        ref[f"stream-{name}/counts"].tolist()
    gaps = js[:-1] / js[1:]
    j = int(np.argmax(gaps > 1.05)) + 1 if (gaps > 1.05).any() else 1
    assert projector_gap(st.u.numpy()[:, :j], ref[f"stream-{name}/u"][:, :j]) \
        < 1e-3
    assert projector_gap(st.v.numpy()[:, :j], ref[f"stream-{name}/v"][:, :j]) \
        < 1e-3


def test_sharded_window_matches_the_reference(ref):
    """The sharded window (5 batches, one with a row that needs repair) on
    a local mesh against the reference's scan on 8 forced devices, the
    reference's draws injected at the bucket's padded shape."""
    wn, wk = 64, 8
    cfg = tapi.SolveConfig(truncate_rank=wk, num_blocks=D,
                           stream_backend="shard_map")
    rng = np.random.default_rng(0)
    wb = [rng.standard_normal((8, wn)).astype(np.float32)
          * (rng.random((8, wn)) < 0.3) for _ in range(6)]
    wb[3][2, :] = 0.0
    w = wn // D

    def draws(b):
        return reference_draws(jax.random.fold_in(KEY, b), "neighbor_random",
                               D, 8, w, w)

    tstate.set_stream_devices(tcol.LocalMesh(D, CPU))
    try:
        st = tapi.svd_update(tapi.svd_init(wn, cfg, device=CPU), wb[0], cfg,
                             draws=draws(0)).state
        spec = tapi.ASpec(m=8, n=wn, nnz=8 * wn, num_blocks=D,
                          kind="stream")
        plan = tapi.planner.make_window_plan(spec, cfg, device_count=D)
        assert plan.backend == "shard_map"
        st, info = tw.ingest_window(st, wb[1:], cfg, plan, draws=draws)
    finally:
        tstate.set_stream_devices(None)
    js = ref["window/s"]
    np.testing.assert_allclose(st.s.numpy(), js, rtol=1e-4,
                               atol=1e-5 * js[0])
    assert [info.lonely_rows, info.repaired_rows] == \
        ref["window/counts"].tolist()
    assert info.repaired_rows >= 1
    assert projector_gap(st.v.numpy()[:, :4], ref["window/v"][:, :4]) < 1e-3


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_sharded_ranker_matches_the_reference(ref, quant):
    """Integer-valued factors: the sharded ranker on a local mesh of 8
    slots against the reference's on 8 devices, bit for bit in f32 (int8:
    the indices, and the scores to the kvquant rounding)."""
    rng = np.random.default_rng(7)
    rk, rn = 6, 197
    ru = rng.integers(-2, 3, size=(5, rk)).astype(np.float32)
    rs = rng.integers(1, 4, size=rk).astype(np.float32)
    rv = rng.integers(-2, 3, size=(D * 25, rk)).astype(np.float32)
    rq = rng.integers(-3, 4, size=(6, rk)).astype(np.float32)
    st = convert.state_from_numpy(ru, rs, rv, n=rn, num_blocks=D,
                                  rows_seen=5, batches_seen=1,
                                  lonely_rows_seen=0, repaired_rows_seen=0,
                                  device=CPU)
    sharded = tstate.shard_state(st, tcol.LocalMesh(D, CPU))
    got = ranker.score_topk(ServingSnapshot.from_state(sharded,
                                                       quantize=quant),
                            torch.from_numpy(rq), 9, sharded=True)
    dense = ranker.score_topk(ServingSnapshot.from_state(st, quantize=quant),
                              torch.from_numpy(rq), 9)
    assert torch.equal(got.scores, dense.scores)
    assert torch.equal(got.indices, dense.indices)
    key = f"ranker-{int(quant)}"
    np.testing.assert_array_equal(got.indices.numpy(), ref[f"{key}/indices"])
    if quant:
        np.testing.assert_allclose(got.scores.numpy(), ref[f"{key}/scores"],
                                   rtol=1e-6)
    else:
        np.testing.assert_array_equal(got.scores.numpy(),
                                      ref[f"{key}/scores"])
