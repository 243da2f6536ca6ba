"""``repro_torch.checkpoint`` against ``repro.checkpoint`` on the CPU.

* Twins of the reference's checkpoint tests: the round trip, async saves
  with garbage collection, the signature check (``tests/test_substrate.py``),
  a stream resumed bit-identically, a ``BlockEll`` inside a plain tree,
  sequence children refused (``tests/test_streaming.py``) and a window
  resumed mid-stream (``tests/test_streaming_scan.py``).  Within the port
  a resumed stream equals the uninterrupted one bit for bit
  (``torch.equal``).
* Files cross both ways: the reference saves a ``StreamingSVDState`` (JAX
  on the CPU) and the port restores it, arrays bit-equal, counters equal
  and ``seed`` the key's seed; the port saves and the reference's
  unchanged ``Checkpointer`` restores a ``repro.stream.state.
  StreamingSVDState`` with ``key == PRNGKey(seed)`` that its
  ``svd_update`` takes.  The same for ``BlockEll``; ``tree_signature`` is
  equal across the packages.  Restoring a reference file imports nothing
  of the reference (checked in a fresh interpreter).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.core import api as japi
from repro.core import sparse as jsparse
from repro.stream import state as jstate

from repro_torch.checkpoint import Checkpointer, tree_signature
from repro_torch.core import api as tapi
from repro_torch.core import sparse as tsparse
from repro_torch.stream import StreamingSVDState
from repro_torch.stream import window as sw

from conftest import REPO

CPU = "cpu"
N, D, K = 256, 4, 12


def _coo(m=24, n=N, density=0.02, seed=3):
    return tsparse.random_bipartite(m, n, density, seed=seed, weighted=True)


def _rows(coo, lo, hi):
    keep = (coo.rows >= lo) & (coo.rows < hi)
    return tsparse.COOMatrix(coo.rows[keep] - lo, coo.cols[keep],
                             coo.vals[keep], (hi - lo, coo.shape[1]))


def _jcoo(c):
    return jsparse.COOMatrix(rows=c.rows, cols=c.cols, vals=c.vals,
                             shape=c.shape)


def _port_stream(cfg, batches, state=None):
    state = state or tapi.svd_init(N, cfg, device=CPU)
    for delta in batches:
        state = tapi.svd_update(state, delta, cfg).state
    return state


def _assert_states_equal(a, b, fields=("u", "s", "v")):
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _counters(st):
    return (st.n, st.num_blocks, st.rows_seen, st.batches_seen,
            st.lonely_rows_seen, st.repaired_rows_seen)


# ---------------------------------------------------------------------------
# Twins of the reference's checkpoint tests
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": {"c": torch.tensor(2.5)}}
    ck.save(10, tree, blocking=True)
    restored, meta = ck.restore(device=CPU)
    assert meta["step"] == 10 and meta["process_index"] == 0
    assert torch.equal(restored["a"], tree["a"])
    assert float(restored["b"]["c"]) == 2.5
    assert tree_signature(restored) == tree_signature(tree) \
        == meta["signature"]


def test_checkpoint_async_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"x": torch.full((8,), float(s))})
    ck.wait()
    assert ck.list_steps() == [3, 4] and ck.latest_step() == 4
    restored, meta = ck.restore(device=CPU)
    assert meta["step"] == 4
    assert torch.equal(restored["x"], torch.full((8,), 4.0))
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_checkpoint_signature_mismatch(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"x": torch.zeros((4,))}, blocking=True)
    with pytest.raises(ValueError, match="signature"):
        ck.restore(device=CPU, expect_signature="deadbeef00000000")
    ck.restore(device=CPU,
               expect_signature=tree_signature({"x": torch.zeros((4,))}))


def test_checkpoint_roundtrip_resumes_bit_identically(tmp_path):
    coo = _coo()
    cfg = tapi.SolveConfig(method="random", truncate_rank=K, num_blocks=D)
    batches = [_rows(coo, 6 * i, 6 * i + 6) for i in range(4)]
    state = _port_stream(cfg, batches[:2])

    ck = Checkpointer(str(tmp_path))
    ck.save(2, state, blocking=True)
    restored, meta = ck.restore(2, device=CPU)
    assert isinstance(restored, StreamingSVDState)
    assert meta["signature"] == tree_signature(state)
    assert _counters(restored) == _counters(state)
    assert (restored.rows_seen, restored.batches_seen) == (12, 2)
    assert restored.seed == state.seed
    _assert_states_equal(restored, state)

    # Continue BOTH streams over the remaining batches: bit-identical.
    state = _port_stream(cfg, batches[2:], state)
    restored = _port_stream(cfg, batches[2:], restored)
    _assert_states_equal(state, restored)
    assert _counters(state) == _counters(restored)


def test_checkpoint_roundtrip_block_ell_inside_plain_tree(tmp_path):
    ell = tsparse.block_ell_from_coo(_coo(), D, device=CPU)
    tree = {"data": ell, "step_arrays": [np.arange(3.0), np.ones((2, 2))]}
    ck = Checkpointer(str(tmp_path))
    ck.save(0, tree, blocking=True)
    back, _ = ck.restore(0, device=CPU)
    assert isinstance(back["data"], tsparse.BlockEll)
    assert (back["data"].m, back["data"].width, back["data"].n,
            back["data"].nnz) == (ell.m, ell.width, ell.n, ell.nnz)
    for f in ("col_ids", "col_rows", "col_vals"):
        assert torch.equal(getattr(back["data"], f), getattr(ell, f)), f
    np.testing.assert_array_equal(back["step_arrays"]["0"].numpy(),
                                  np.arange(3.0))


def test_checkpoint_rejects_sequence_children_loudly(tmp_path):
    @dataclasses.dataclass(frozen=True)
    class BadChain:
        keys: object

        def tree_flatten(self):
            return ((self.keys,), ())

        @classmethod
        def tree_unflatten(cls, aux, children):
            return cls(*children)

    ck = Checkpointer(str(tmp_path))
    with pytest.raises(TypeError, match="tuple"):
        ck.save(0, {"bad": BadChain(keys=(np.ones(2), np.ones(2)))},
                blocking=True)
    with pytest.raises(TypeError, match="empty dict"):
        ck.save(0, {"bad": BadChain(keys={})}, blocking=True)
    with pytest.raises(ValueError, match="reserved key"):
        ck.save(0, {"x": {"__type__": 1}}, blocking=True)
    assert ck.list_steps() == []


def test_checkpoint_resume_mid_window_bit_identical(tmp_path):
    rng = np.random.default_rng(5)
    batches = [rng.standard_normal((8, N)).astype(np.float32)
               * (rng.random((8, N)) < 0.25) for _ in range(6)]
    batches[4][2, :] = 0.0
    cfg = tapi.SolveConfig(truncate_rank=K, num_blocks=D)
    spec = tapi.ASpec(m=8, n=N, nnz=8 * N, num_blocks=D, kind="stream")
    p = tapi.planner.make_window_plan(spec, cfg, device_count=1)
    grown = _port_stream(cfg, [rng.standard_normal((8, N))
                               .astype(np.float32) for _ in range(2)])
    assert grown.rank == K
    whole, _ = sw.ingest_window(grown, batches, cfg, p)

    half, _ = sw.ingest_window(grown, batches[:3], cfg, p)
    ck = Checkpointer(str(tmp_path))
    ck.save(3, half, blocking=True)
    restored, _ = ck.restore(3, device=CPU)
    assert restored.batches_seen == half.batches_seen
    resumed, _ = sw.ingest_window(restored, batches[3:], cfg, p)
    # The window boundary moved AND the stream crossed a save/restore:
    # batch b still draws derive_seed(seed, b), so nothing changes.
    _assert_states_equal(whole, resumed)
    assert _counters(whole) == _counters(resumed)


def test_restored_repaired_blocks_and_none_leaves(tmp_path):
    from repro_torch.core import ranky as tranky
    rep = tranky.split_and_repair(
        tsparse.block_ell_from_coo(_coo(), D, device=CPU), D,
        "neighbor_random", 7)
    ck = Checkpointer(str(tmp_path))
    ck.save(0, {"rep": rep, "nothing": None}, blocking=True)
    back, _ = ck.restore(0, device=CPU)
    assert back["nothing"] is None
    assert isinstance(back["rep"], tsparse.RepairedSparseBlocks)
    assert torch.equal(back["rep"].repair_mask, rep.repair_mask)
    assert torch.equal(back["rep"].todense_blocks(), rep.todense_blocks())


def test_checkpoint_refuses_what_it_cannot_hold(tmp_path):
    ck = Checkpointer(str(tmp_path))
    with pytest.raises(TypeError, match="w/bf"):
        ck.save(0, {"w": {"bf": torch.ones(2, dtype=torch.bfloat16)}},
                blocking=True)
    ck.save(0, {"x": torch.zeros(2)}, blocking=True)
    # shardings takes block meshes (in dicts keyed like the tree); None
    # leaves a subtree as restored.
    back, _ = ck.restore(0, device=CPU, shardings={"x": None})
    assert torch.equal(back["x"], torch.zeros(2))
    with pytest.raises(TypeError, match="BlockMesh"):
        ck.restore(0, device=CPU, shardings={"x": "cpu"})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ck.restore(0)
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(device=CPU)


def test_seed_is_written_as_the_reference_key():
    from repro_torch.checkpoint.ckpt import _key_to_seed, _seed_to_key
    for seed in (0, 5, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            _seed_to_key(seed), np.asarray(jax.random.PRNGKey(seed)))
    for seed in (0, 5, 2 ** 32 + 7, 2 ** 64 - 1):
        assert _key_to_seed(_seed_to_key(seed)) == seed
    with pytest.raises(ValueError, match="seed"):
        _seed_to_key(-1)


# ---------------------------------------------------------------------------
# Files cross between the packages
# ---------------------------------------------------------------------------

JCFG = japi.SolveConfig(method="random", truncate_rank=K, num_blocks=D)
TCFG = tapi.SolveConfig(method="random", truncate_rank=K, num_blocks=D)


def _reference_state(seed=5):
    coo = _coo()
    st = japi.svd_init(N, dataclasses.replace(
        JCFG, key=jax.random.PRNGKey(seed)))
    for i in range(2):
        st = japi.svd_update(st, _jcoo(_rows(coo, 6 * i, 6 * i + 6)),
                             JCFG).state
    return st


def test_reference_saved_state_restores_in_the_port(tmp_path):
    jst = _reference_state(seed=5)
    jckpt.Checkpointer(str(tmp_path)).save(2, jst, blocking=True)
    tst, meta = Checkpointer(str(tmp_path)).restore(
        device=CPU, expect_signature=jckpt.tree_signature(jst))
    assert isinstance(tst, StreamingSVDState)
    for f in ("u", "s", "v"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    assert _counters(tst) == (jst.n, jst.num_blocks, jst.rows_seen,
                              jst.batches_seen, jst.lonely_rows_seen,
                              jst.repaired_rows_seen)
    assert tst.seed == 5
    assert tree_signature(tst) == meta["signature"]
    # and the port goes on streaming from it
    nxt = tapi.svd_update(tst, _rows(_coo(), 12, 18), TCFG).state
    assert nxt.batches_seen == 3 and nxt.rank == K


def test_port_saved_state_restores_in_the_reference(tmp_path):
    tst = _port_stream(dataclasses.replace(TCFG, key=5),
                       [_rows(_coo(), 6 * i, 6 * i + 6) for i in range(2)])
    Checkpointer(str(tmp_path)).save(2, tst, blocking=True)
    jst, meta = jckpt.Checkpointer(str(tmp_path)).restore(
        expect_signature=tree_signature(tst))
    assert isinstance(jst, jstate.StreamingSVDState)
    np.testing.assert_array_equal(np.asarray(jst.key),
                                  np.asarray(jax.random.PRNGKey(5)))
    for f in ("u", "s", "v"):
        np.testing.assert_array_equal(np.asarray(getattr(jst, f)),
                                      getattr(tst, f).numpy(), err_msg=f)
    assert (jst.rows_seen, jst.batches_seen) == (12, 2)
    assert jckpt.tree_signature(jst) == meta["signature"]
    nxt = japi.svd_update(jst, _jcoo(_rows(_coo(), 12, 18)), JCFG).state
    assert nxt.batches_seen == 3 and nxt.rank == K


def test_block_ell_crosses_both_ways(tmp_path):
    coo = _coo()
    jell = jsparse.block_ell_from_coo(_jcoo(coo), D)
    tell = tsparse.block_ell_from_coo(coo, D, device=CPU)
    assert tree_signature(tell) == jckpt.tree_signature(jell)

    jckpt.Checkpointer(str(tmp_path / "ref")).save(0, {"e": jell},
                                                   blocking=True)
    back, _ = Checkpointer(str(tmp_path / "ref")).restore(device=CPU)
    Checkpointer(str(tmp_path / "port")).save(0, {"e": tell}, blocking=True)
    jback, _ = jckpt.Checkpointer(str(tmp_path / "port")).restore()
    assert isinstance(back["e"], tsparse.BlockEll)
    assert isinstance(jback["e"], jsparse.BlockEll)
    for f in ("col_ids", "col_rows", "col_vals"):
        np.testing.assert_array_equal(getattr(back["e"], f).numpy(),
                                      np.asarray(getattr(jell, f)))
        np.testing.assert_array_equal(np.asarray(getattr(jback["e"], f)),
                                      getattr(tell, f).numpy())
    for e in (back["e"], jback["e"]):
        assert (e.m, e.width, e.n, e.nnz) == (tell.m, tell.width, tell.n,
                                              tell.nnz)


def test_tree_signature_is_equal_across_packages():
    jst = _reference_state(seed=0)
    tst = StreamingSVDState(
        u=torch.zeros(tuple(jst.u.shape)), s=torch.zeros(tuple(jst.s.shape)),
        v=torch.zeros(tuple(jst.v.shape)), seed=0, n=jst.n,
        num_blocks=jst.num_blocks, rows_seen=jst.rows_seen,
        batches_seen=jst.batches_seen, lonely_rows_seen=jst.lonely_rows_seen,
        repaired_rows_seen=jst.repaired_rows_seen)
    assert tree_signature(tst) == jckpt.tree_signature(jst)
    plain_t = {"a": torch.zeros((2, 3), dtype=torch.int32),
               "b": [torch.ones(4, dtype=torch.bool), None]}
    plain_j = {"a": jnp.zeros((2, 3), jnp.int32),
               "b": [jnp.ones(4, bool), None]}
    assert tree_signature(plain_t) == jckpt.tree_signature(plain_j)
    # a counter is structure: it changes the signature
    bumped = dataclasses.replace(tst, rows_seen=tst.rows_seen + 1)
    assert tree_signature(bumped) != tree_signature(tst)


def test_restore_imports_nothing_of_the_reference(tmp_path):
    """A reference-saved state restores in an interpreter that has only
    the port: neither ``repro`` nor ``jax`` gets imported; an unknown
    ``repro.*`` type raises a TypeError naming it."""
    jckpt.Checkpointer(str(tmp_path)).save(1, _reference_state(),
                                           blocking=True)
    body = f"""
import json, os, sys
import numpy as np
from repro_torch.checkpoint import Checkpointer
st, meta = Checkpointer({str(tmp_path)!r}).restore(device="cpu")
assert type(st).__module__ == "repro_torch.stream.state", type(st)
bad = [m for m in sys.modules if m == "jax" or m == "repro"
       or m.startswith(("jax.", "repro."))]
assert not bad, bad
path = os.path.join({str(tmp_path)!r}, "step_00000001", "arrays.npz")
arrs = dict(np.load(path))
arrs["__type__"] = np.asarray("repro.core.sparse:COOMatrix")
arrs["__aux__"] = np.asarray("[]")
np.savez(path, **arrs)
try:
    Checkpointer({str(tmp_path)!r}).restore(device="cpu")
except TypeError as e:
    assert "repro.core.sparse:COOMatrix" in str(e), e
    print("OK")
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", body], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "OK"


# ---------------------------------------------------------------------------
# Sharded states: saves are gathered, restores re-shard onto the CURRENT
# slots (twins of the reference's 8-device checkpoint tests)
# ---------------------------------------------------------------------------

def _sharded_pair():
    from repro_torch.core.collectives import LocalMesh

    rng = np.random.default_rng(3)
    a = rng.standard_normal((48, 128)).astype(np.float32)
    kw = dict(method="random", truncate_rank=12, num_blocks=8)
    return (a, LocalMesh(8, CPU),
            tapi.SolveConfig(stream_backend="shard_map", **kw),
            tapi.SolveConfig(stream_backend="single", **kw))


def test_checkpoint_portability_sharded_roundtrip(tmp_path):
    """Save a SHARDED state, restore it sharded (the pool has one slot a
    block), continue sharded and gathered single-host: bit-identical to
    continuing the never-checkpointed state the same way.  And a
    single-host stream's checkpoint feeds the sharded engine."""
    from repro_torch.stream import state as tstate

    a, mesh, cfg_sh, cfg_si = _sharded_pair()
    tstate.set_stream_devices(mesh)
    try:
        state = tapi.svd_init(128, cfg_sh, device=CPU)
        for i in range(3):
            state = tapi.svd_update(state, a[i * 12:(i + 1) * 12],
                                    cfg_sh).state
        assert state.mesh is mesh
        ck = Checkpointer(str(tmp_path))
        ck.save(3, state, blocking=True)
        restored, _ = ck.restore(3, device=CPU)
        assert isinstance(restored, StreamingSVDState)
        assert restored.mesh is not None and restored.mesh.size == 8
        for f in ("u", "s", "v", "seed", "rows_seen", "batches_seen"):
            got, want = getattr(restored, f), getattr(state, f)
            assert (torch.equal(got, want) if isinstance(got, torch.Tensor)
                    else got == want), f
        n1 = tapi.svd_update(state, a[36:48], cfg_sh).state
        n2 = tapi.svd_update(restored, a[36:48], cfg_sh).state
        g1 = tapi.svd_update(tstate.gather_state(state), a[36:48],
                             cfg_si).state
        g2 = tapi.svd_update(tstate.gather_state(restored), a[36:48],
                             cfg_si).state
        st1 = tapi.svd_init(128, cfg_si, device=CPU)
        for i in range(2):
            st1 = tapi.svd_update(st1, a[i * 12:(i + 1) * 12], cfg_si).state
        ck.save(10, st1, blocking=True)
        rest1, _ = ck.restore(10, device=CPU, reshard=False)
        m1 = tapi.svd_update(st1, a[24:36], cfg_sh).state
        m2 = tapi.svd_update(rest1, a[24:36], cfg_sh).state
    finally:
        tstate.set_stream_devices(None)
    for x, y in ((n1, n2), (g1, g2), (m1, m2)):
        for f in ("u", "s", "v"):
            assert torch.equal(getattr(x, f), getattr(y, f)), f


def test_checkpoint_saved_on_8_slots_restores_on_1(tmp_path):
    """A file of a state sharded over 8 slots restores onto one (no pool:
    gathered; ``shardings`` a one-slot mesh: gathered too) and continues
    single-host bit for bit; a single-host file restores onto 8 slots
    through ``shardings=`` and continues sharded bit for bit."""
    from repro_torch.core.collectives import LocalMesh
    from repro_torch.stream import state as tstate

    a, mesh, cfg_sh, cfg_si = _sharded_pair()
    state = tapi.svd_init(128, cfg_sh, device=CPU)
    tstate.set_stream_devices(mesh)
    try:
        for i in range(3):
            state = tapi.svd_update(state, a[i * 12:(i + 1) * 12],
                                    cfg_sh).state
    finally:
        tstate.set_stream_devices(None)
    ck = Checkpointer(str(tmp_path))
    ck.save(3, {"state": state}, blocking=True)
    on1, _ = ck.restore(3, device=CPU)
    one_slot, _ = ck.restore(3, shardings=LocalMesh(1, CPU))
    assert on1["state"].mesh is None and one_slot["state"].mesh is None
    want = tapi.svd_update(tstate.gather_state(state), a[36:48],
                           cfg_si).state
    for back in (on1, one_slot):
        got = tapi.svd_update(back["state"], a[36:48], cfg_si).state
        for f in ("u", "s", "v"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    ck.save(4, {"state": want}, blocking=True)
    on8, _ = ck.restore(4, device=CPU, shardings={"state": mesh})
    assert on8["state"].mesh is mesh
    tstate.set_stream_devices(mesh)
    try:
        x = tapi.svd_update(on8["state"], a[:12], cfg_sh)
        y = tapi.svd_update(tstate.shard_state(want, mesh), a[:12], cfg_sh)
    finally:
        tstate.set_stream_devices(None)
    assert x.plan.backend == "shard_map"
    for f in ("u", "s", "v"):
        assert torch.equal(getattr(x.state, f), getattr(y.state, f)), f
