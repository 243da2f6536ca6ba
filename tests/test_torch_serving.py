"""The serving slice: ``repro_torch.serve`` + ``api.ServeTopKConfig`` /
``serve_init`` / ``serve_topk`` (rule R7) and ``stream.decay`` against the
reference, on the CPU.

The reference's states (``tests/test_serving.py``'s chain of ingests) are
carried into the port through ``convert.state_from_numpy``, so both
packages serve the very same factors.  Where the port is compared with
itself (kernel path vs plain version, a wave vs its precomputed answer)
the comparison is bitwise; against the reference, whose matmul sums in
another order, values are held at rtol 1e-6 and indices wherever the
neighbouring scores lie further apart; on integer-valued factors and
queries every sum is exact and the two packages agree bit for bit.
"""
import dataclasses
import sys
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import api as japi
from repro.core import planner as jplanner
from repro.serve import kvquant as jkvquant
from repro.serve import ranker as jranker
from repro.serve import ServingSnapshot as JSnapshot
from repro.stream import StreamingSVDState as JState
from repro.stream import decay_from_timestamps as jdecay

from repro_torch.core import api as tapi
from repro_torch.core import convert
from repro_torch.core import planner as tplanner
from repro_torch.kernels import topk_score as ttk
from repro_torch.serve import ServingSnapshot, SnapshotBuffer, kvquant, ranker
from repro_torch.stream import decay_from_timestamps, init_state
from repro_torch.core.collectives import LocalMesh
from repro_torch.stream.state import set_stream_devices, shard_state

KEY = jax.random.PRNGKey(11)
N, D, K = 96, 4, 8
CPU = "cpu"
JCFG = japi.SolveConfig(method="random", truncate_rank=K, num_blocks=D,
                        stream_backend="single")


def _carry(js, seed=0):
    """A reference StreamingSVDState -> the port's, same numbers."""
    return convert.state_from_numpy(
        np.asarray(js.u), np.asarray(js.s), np.asarray(js.v), n=js.n,
        num_blocks=js.num_blocks, rows_seen=js.rows_seen,
        batches_seen=js.batches_seen, lonely_rows_seen=js.lonely_rows_seen,
        repaired_rows_seen=js.repaired_rows_seen, seed=seed, device=CPU)


def _ingested_states(count=3, rows=16, seed=0):
    """(reference states, port states): a chain of ingests over one
    universe made by the reference, each carried into the port."""
    a = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                     (rows * count, N)))
    state, jstates = japi.svd_init(N, JCFG), []
    for i in range(count):
        state = japi.svd_update(state, a[i * rows:(i + 1) * rows], JCFG).state
        jstates.append(state)
    return jstates, [_carry(s) for s in jstates]


JSTATES, STATES = _ingested_states()


def _queries(b, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, K)).astype(np.float32))


def _assert_close_to_reference(res, jres, rtol=1e-6):
    vals, idx = res.scores.numpy(), res.indices.numpy()
    jvals, jidx = np.asarray(jres.scores), np.asarray(jres.indices)
    np.testing.assert_allclose(vals, jvals, rtol=rtol, atol=rtol)
    tight = np.abs(np.diff(jvals, axis=1)) <= rtol * np.abs(jvals[:, 1:])
    sep = np.ones_like(jvals, dtype=bool)
    sep[:, 1:] &= ~tight
    sep[:, :-1] &= ~tight
    np.testing.assert_array_equal(idx[sep], jidx[sep])


# ---------------------------------------------------------------------------
# kvquant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [-1, 0])
def test_quantize_equals_the_reference(axis):
    x = (np.random.default_rng(3).standard_normal((50, 12)) * 3
         ).astype(np.float32)
    q, scale = kvquant.quantize(torch.from_numpy(x), axis=axis)
    jq, jscale = jkvquant.quantize(jnp.asarray(x), axis=axis)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(kvquant.dequantize(q, scale).numpy(),
                                  np.asarray(jkvquant.dequantize(jq, jscale)))


def test_round_half_to_even_in_both():
    """x / scale lands exactly on .5 here: both round half to even."""
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]], np.float32)
    q, _ = kvquant.quantize(torch.from_numpy(x))
    jq, _ = jkvquant.quantize(jnp.asarray(x))
    assert q.tolist() == [[127, 0, 2, 2, 0, -2]]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


# ---------------------------------------------------------------------------
# ServingSnapshot / SnapshotBuffer
# ---------------------------------------------------------------------------

def test_snapshot_captures_consistent_triple():
    snap = ServingSnapshot.from_state(STATES[0], keep_u=True)
    assert snap.rank == K and snap.n == N and snap.num_blocks == D
    assert snap.version == 0 and not snap.quantized
    assert snap.s is STATES[0].s and snap.v is STATES[0].v
    assert snap.u_rows is STATES[0].u


def test_snapshot_rejects_rank0_state():
    with pytest.raises(ValueError, match="rank-0"):
        ServingSnapshot.from_state(init_state(N, num_blocks=D, device=CPU))


def test_snapshot_quantized_drops_f32_factors():
    snap = ServingSnapshot.from_state(STATES[0], quantize=True)
    jsnap = JSnapshot.from_state(JSTATES[0], quantize=True)
    assert snap.quantized and snap.v is None
    assert snap.v_q.dtype == torch.int8
    assert snap.v_q.shape == STATES[0].v.shape
    assert snap.v_scale.shape == (STATES[0].v.shape[0], 1)
    np.testing.assert_array_equal(snap.v_q.numpy(), np.asarray(jsnap.v_q))
    np.testing.assert_array_equal(snap.v_scale.numpy(),
                                  np.asarray(jsnap.v_scale))


def test_snapshot_is_a_frozen_dataclass():
    """The port's snapshot is no pytree: a frozen dataclass with the
    reference's fields."""
    snap = ServingSnapshot.from_state(STATES[0])
    with pytest.raises(dataclasses.FrozenInstanceError):
        snap.version = 3
    # ... plus the mesh of a sharded state's snapshot (a tensor carries no
    # sharding of its own).
    assert [f.name for f in dataclasses.fields(ServingSnapshot)] == \
        [f.name for f in dataclasses.fields(JSnapshot)] + ["mesh"]


def test_buffer_stage_is_invisible_until_publish():
    buf = SnapshotBuffer(ServingSnapshot.from_state(STATES[0]))
    assert buf.version == 0
    buf.stage(STATES[1])
    assert buf.version == 0 and buf.read().version == 0
    flipped = buf.publish()
    assert flipped.version == 1 and buf.version == 1
    assert buf.publish().version == 1
    assert 0.0 <= buf.age_seconds() < 60.0


def test_buffer_commit_bumps_version_and_inherits_options():
    buf = SnapshotBuffer(
        ServingSnapshot.from_state(STATES[0], quantize=True, keep_u=True))
    snap = buf.commit(STATES[1])
    assert snap.version == 1
    assert snap.quantized and snap.u_rows is not None


def test_buffer_torn_read_hammer():
    """Concurrent ingests + reads: every answer must be bitwise the one
    precomputed from the snapshot of its stamped version alone.  A torn (s
    from one ingest, v from another) mix cannot match any precomputed
    pair.  More threads than this check needs, and a short switch
    interval, to make interleavings likely."""
    jstates, states = _ingested_states(count=5, seed=3)
    snaps = [ServingSnapshot.from_state(s, version=i)
             for i, s in enumerate(states)]
    queries = _queries(4)
    expected = {}
    for snap in snaps:
        res = ranker.score_topk(snap, queries, 5)
        expected[snap.version] = (res.scores, res.indices)

    buf = SnapshotBuffer(snaps[0])
    stop = threading.Event()
    failures = []

    def writer():
        i = 0
        while not stop.is_set():
            i += 1
            buf.stage(states[i % len(states)])
            buf.publish()

    def reader():
        while not stop.is_set():
            res = ranker.score_topk(buf.read(), queries, 5)
            want = expected[res.version % len(states)]
            if not (torch.equal(res.scores, want[0])
                    and torch.equal(res.indices, want[1])):
                failures.append(f"torn read at version {res.version}")
                return

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=writer)] + \
        [threading.Thread(target=reader) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        time.sleep(1.0)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not failures, failures
    assert buf.version > 0


# ---------------------------------------------------------------------------
# ranker
# ---------------------------------------------------------------------------

def test_score_topk_matches_oracle_bitwise_and_the_reference():
    snap = ServingSnapshot.from_state(STATES[0])
    queries = _queries(6)
    res = ranker.score_topk(snap, queries, 7)
    qs = queries * snap.s[None, :]
    want = ttk.topk_score_ref(qs, snap.v, 7, valid_n=N)
    assert torch.equal(res.scores, want[0])
    assert torch.equal(res.indices, want[1])
    assert res.version == 0
    assert (np.diff(res.scores.numpy(), axis=1) <= 0).all()
    assert int(res.indices.max()) < N
    jres = jranker.score_topk(JSnapshot.from_state(JSTATES[0]),
                              jnp.asarray(queries.numpy()), 7)
    _assert_close_to_reference(res, jres)


def test_score_topk_fallback_matches_kernel_path():
    snap = ServingSnapshot.from_state(STATES[0])
    queries = _queries(3)
    a = ranker.score_topk(snap, queries, 5, use_kernel=True)
    b = ranker.score_topk(snap, queries, 5, use_kernel=False)
    assert torch.equal(a.scores, b.scores)
    assert torch.equal(a.indices, b.indices)


def test_score_topk_int8_agreement():
    snap = ServingSnapshot.from_state(STATES[0])
    snap8 = ServingSnapshot.from_state(STATES[0], quantize=True)
    queries = _queries(8)
    full = ranker.score_topk(snap, queries, 10)
    q8 = ranker.score_topk(snap8, queries, 10)
    overlap = np.mean([
        len(set(full.indices[i].tolist()) & set(q8.indices[i].tolist())) / 10
        for i in range(8)])
    assert overlap >= 0.8, overlap
    np.testing.assert_allclose(q8.scores.numpy(), full.scores.numpy(),
                               rtol=0.05, atol=0.05)
    jq8 = jranker.score_topk(JSnapshot.from_state(JSTATES[0], quantize=True),
                             jnp.asarray(queries.numpy()), 10)
    _assert_close_to_reference(q8, jq8)


def test_project_rows_inverts_row_factor_identity():
    """U = A V diag(1/s): projecting training rows recovers factor rows
    close to the stored u rows; the projection equals the reference's."""
    rows = np.array(jax.random.normal(jax.random.PRNGKey(0), (16 * 3, N)))
    snap = ServingSnapshot.from_state(STATES[0], keep_u=True)
    proj = ranker.project_rows(snap, torch.from_numpy(rows[:4]))
    assert proj.shape == (4, K)
    direct = ranker.user_queries(snap, [0, 1, 2, 3])
    np.testing.assert_allclose(proj.numpy(), direct.numpy(), rtol=0.2,
                               atol=0.2)
    jproj = jranker.project_rows(JSnapshot.from_state(JSTATES[0]),
                                 jnp.asarray(rows[:4]))
    np.testing.assert_allclose(proj.numpy(), np.asarray(jproj), rtol=1e-5,
                               atol=1e-5)


def test_project_rows_int8_close_to_f32():
    snap = ServingSnapshot.from_state(STATES[0])
    snap8 = ServingSnapshot.from_state(STATES[0], quantize=True)
    rows = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (5, N)).astype(np.float32))
    p32 = ranker.project_rows(snap, rows).numpy()
    p8 = ranker.project_rows(snap8, rows).numpy()
    np.testing.assert_allclose(p8, p32, rtol=0.1,
                               atol=0.05 * np.abs(p32).max())
    jp8 = jranker.project_rows(JSnapshot.from_state(JSTATES[0], quantize=True),
                               jnp.asarray(rows.numpy()))
    np.testing.assert_allclose(p8, np.asarray(jp8), rtol=1e-5, atol=1e-5)


def test_user_queries_requires_keep_u():
    with pytest.raises(ValueError, match="keep_u"):
        ranker.user_queries(ServingSnapshot.from_state(STATES[0]), [0])


@pytest.mark.parametrize("call,match", [
    (lambda s: ranker.score_topk(s, torch.zeros((2, K + 1)), 5),
     "factor-space"),
    (lambda s: ranker.score_topk(s, torch.zeros((2, K)), 0), "k_top"),
    (lambda s: ranker.score_topk(s, torch.zeros((2, K)), N + 1), "k_top"),
    (lambda s: ranker.project_rows(s, torch.zeros((2, N + 3))), "columns"),
])
def test_score_topk_validates_inputs(call, match):
    with pytest.raises(ValueError, match=match):
        call(ServingSnapshot.from_state(STATES[0]))


def test_sharded_ranker_needs_a_sharded_snapshot():
    """``sharded=True`` on a snapshot of a single-device state is refused
    (there is no mesh to score over); on a sharded one it answers."""
    with pytest.raises(ValueError, match="sharded state"):
        ranker.score_topk(ServingSnapshot.from_state(STATES[0]),
                          _queries(2), 3, sharded=True)
    sharded = shard_state(STATES[0], LocalMesh(D, CPU))
    res = ranker.score_topk(ServingSnapshot.from_state(sharded),
                            _queries(2), 3, sharded=True)
    dense = ranker.score_topk(ServingSnapshot.from_state(STATES[0]),
                              _queries(2), 3)
    assert torch.equal(res.scores, dense.scores)
    assert torch.equal(res.indices, dense.indices)


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_sharded_ranker_bitwise(quantize):
    """Twin of the reference's 8-device ranker test, on a local mesh of 8
    slots: per-slot fused top-k with its offset, a slot-major gather and a
    stable merge give the dense path's answer bit for bit, f32 and int8
    alike, and ``serve_backend='auto'`` picks it through the front door
    when the stream pool has one slot per block."""
    n, d, k = 1000, 8, 12
    cfg = tapi.SolveConfig(method="random", truncate_rank=k, num_blocks=d,
                           stream_backend="single")
    a = np.random.default_rng(0).standard_normal((64, n)).astype(np.float32)
    state = tapi.svd_update(tapi.svd_init(n, cfg, device=CPU), a, cfg).state
    q = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (7, k)).astype(np.float32))
    dense = ranker.score_topk(
        ServingSnapshot.from_state(state, quantize=quantize), q, 9)
    sharded = ranker.score_topk(
        ServingSnapshot.from_state(shard_state(state, LocalMesh(d, CPU)),
                                   quantize=quantize), q, 9, sharded=True)
    assert torch.equal(dense.scores, sharded.scores)
    assert torch.equal(dense.indices, sharded.indices)
    set_stream_devices(LocalMesh(d, CPU))
    try:
        handle = tapi.serve_init(state, tapi.ServeTopKConfig(
            k_top=9, quantize=quantize))
        assert handle.plan.backend == "shard_map"
        res = tapi.serve_topk(handle, q)
    finally:
        set_stream_devices(None)
    assert torch.equal(res.scores, dense.scores)
    assert torch.equal(res.indices, dense.indices)


def test_integer_factors_served_bitwise_by_both_packages():
    """Integer-valued factors, singular values and queries: every score is
    an exact integer in both packages, so values AND indices (ties to the
    lowest id) agree bit for bit through the front doors."""
    rng = np.random.default_rng(7)
    n_pad = 100                                       # n = 97, D = 4, W = 25
    u = rng.integers(-2, 3, size=(5, K)).astype(np.float32)
    s = rng.integers(1, 4, size=K).astype(np.float32)
    v = rng.integers(-2, 3, size=(n_pad, K)).astype(np.float32)
    meta = dict(n=97, num_blocks=D, rows_seen=5, batches_seen=1,
                lonely_rows_seen=0, repaired_rows_seen=0)
    tst = convert.state_from_numpy(u, s, v, device=CPU, **meta)
    jst = JState(u=jnp.asarray(u), s=jnp.asarray(s), v=jnp.asarray(v),
                 key=KEY, **meta)
    q = rng.integers(-3, 4, size=(6, K)).astype(np.float32)
    for quant in (False, True):
        cfg = dict(batch_size=8, k_top=9, quantize=quant)
        res = tapi.serve_topk(tapi.serve_init(tst, **cfg), q)
        jres = japi.serve_topk(japi.serve_init(jst, **cfg), jnp.asarray(q))
        if not quant:
            np.testing.assert_array_equal(res.scores.numpy(),
                                          np.asarray(jres.scores))
            np.testing.assert_array_equal(res.indices.numpy(),
                                          np.asarray(jres.indices))
        else:
            _assert_close_to_reference(res, jres)


# ---------------------------------------------------------------------------
# front door: ServeTopKConfig + serve_init / serve_topk
# ---------------------------------------------------------------------------

def test_serve_config_has_every_field_with_the_same_default():
    jf = {f.name: f.default for f in dataclasses.fields(japi.ServeTopKConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tapi.ServeTopKConfig)}
    assert tf == jf
    assert tapi.SERVE_BACKENDS == japi.SERVE_BACKENDS


@pytest.mark.parametrize("kwargs, field", [
    (dict(batch_size=0), "batch_size"),
    (dict(k_top=0), "k_top"),
    (dict(block_n=100), "block_n"),
    (dict(block_n=0), "block_n"),
    (dict(serve_backend="tpu_pod"), "serve_backend"),
    (dict(num_blocks=0), "num_blocks"),
    (dict(memory_budget_bytes=0), "memory_budget_bytes"),
    (dict(k_top=600, block_n=512), "block_n"),
])
def test_invalid_serve_config_same_message(kwargs, field):
    with pytest.raises(ValueError) as te:
        tapi.ServeTopKConfig(**kwargs)
    with pytest.raises(ValueError) as je:
        japi.ServeTopKConfig(**kwargs)
    assert str(te.value) == str(je.value) and field in str(te.value)


def test_cross_field_escape_hatches_are_valid():
    tapi.ServeTopKConfig(k_top=600, block_n=640)
    tapi.ServeTopKConfig(k_top=600, block_n=512, use_kernel=False)


def test_serve_init_rejects_num_blocks_mismatch():
    with pytest.raises(ValueError) as te:
        tapi.serve_init(STATES[0], tapi.ServeTopKConfig(num_blocks=D + 1))
    with pytest.raises(ValueError) as je:
        japi.serve_init(JSTATES[0], japi.ServeTopKConfig(num_blocks=D + 1))
    assert str(te.value) == str(je.value) and "num_blocks" in str(te.value)


def test_serve_handle_end_to_end_single_device():
    handle = tapi.serve_init(STATES[0],
                             tapi.ServeTopKConfig(batch_size=8, k_top=6))
    assert handle.plan.backend == "single"
    assert handle.plan.strategy == "serve_fused"
    assert handle.config.num_blocks == D
    assert handle.version == 0
    queries = _queries(4)
    res = tapi.serve_topk(handle, queries)
    want = ranker.score_topk(handle.read(), queries, 6)
    assert torch.equal(res.scores, want.scores)
    handle.commit(STATES[1])
    assert handle.version == 1
    res2 = tapi.serve_topk(handle, queries, k_top=3)
    assert res2.version == 1 and res2.scores.shape == (4, 3)
    assert handle.plan.peak_bytes == tplanner.serving_bytes(
        N, K, 8, 6, num_blocks=D)
    m = handle.metrics()
    assert m["snapshot_version"] == 1 and m["snapshot_age_s"] >= 0.0
    assert m["planned_peak_bytes"] == handle.plan.peak_bytes


def test_serve_topk_validates_waves():
    handle = tapi.serve_init(STATES[0], tapi.ServeTopKConfig(batch_size=4))
    with pytest.raises(ValueError, match="batch_size=4"):
        tapi.serve_topk(handle, torch.zeros((5, K)))
    with pytest.raises(ValueError, match="factor-space"):
        tapi.serve_topk(handle, torch.zeros((K,)))


def test_serve_commit_rejects_universe_change():
    handle = tapi.serve_init(STATES[0])
    cfg = tapi.SolveConfig(method="random", truncate_rank=K, num_blocks=D)
    other = tapi.svd_update(tapi.svd_init(N * 2, cfg, device=CPU),
                            np.ones((8, N * 2), np.float32), cfg).state
    with pytest.raises(ValueError, match="universe"):
        handle.commit(other)


def test_serve_overrides_build_config():
    handle = tapi.serve_init(STATES[0], k_top=3, quantize=True)
    assert handle.config.k_top == 3
    assert handle.read().quantized
    assert handle.plan.estimates["serve_factors"] == \
        tplanner.serve_factor_bytes(STATES[0].v.shape[0], K, quantized=True)


@pytest.mark.parametrize("cfg,dc", [
    (dict(), 1),
    (dict(quantize=True, k_top=3), 1),
    (dict(use_kernel=False, batch_size=8), 1),
    (dict(memory_budget_bytes=1000), 1),
    (dict(serve_backend="shard_map"), 1),
    (dict(serve_backend="shard_map", quantize=True), D),
    (dict(), D),
    (dict(serve_backend="single"), D),
])
def test_serve_plan_equals_the_reference(cfg, dc):
    """Rule R7, every field and reason, single and per-device."""
    tp = tplanner.make_serve_plan(N, K, tapi.ServeTopKConfig(num_blocks=D,
                                                             **cfg),
                                  device_count=dc)
    jp = jplanner.make_serve_plan(N, K, japi.ServeTopKConfig(num_blocks=D,
                                                             **cfg),
                                  device_count=dc)
    assert (tp.backend, tp.strategy, tp.peak_bytes, tp.budget, tp.rank,
            tp.truncate_to) == (jp.backend, jp.strategy, jp.peak_bytes,
                                jp.budget, jp.rank, jp.truncate_to)
    assert tp.estimates == jp.estimates and tp.reasons == jp.reasons


def test_a_sharded_serve_plan_runs_the_sharded_ranker():
    """One slot per column block in the stream pool: R7 picks shard_map,
    ``serve_init`` shards the snapshot over the pool's mesh and the waves
    run the sharded ranker (the same answer as a single-device handle)."""
    set_stream_devices(LocalMesh(D, CPU))
    try:
        handle = tapi.serve_init(STATES[0])
        assert handle.plan.backend == "shard_map"
        assert handle.read().mesh is not None
        res = tapi.serve_topk(handle, _queries(3))
    finally:
        set_stream_devices(None)
    single = tapi.serve_topk(tapi.serve_init(STATES[0]), _queries(3))
    assert torch.equal(res.scores, single.scores)
    assert torch.equal(res.indices, single.indices)


def test_carried_state_served_and_updated_by_both():
    """A reference state in the port: both serve it, both ingest the next
    batch (the reference's draws injected), both commit and serve again."""
    jhandle = japi.serve_init(JSTATES[1], k_top=5)
    handle = tapi.serve_init(STATES[1], k_top=5)
    q = _queries(4, seed=2)
    _assert_close_to_reference(tapi.serve_topk(handle, q),
                               japi.serve_topk(jhandle, jnp.asarray(q.numpy())))
    delta = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (16, N)))
    jnext = japi.svd_update(JSTATES[1], delta, JCFG).state
    from test_torch_helpers import reference_draws
    kb = jax.random.fold_in(JCFG.resolved_key(), JSTATES[1].batches_seen)
    w = STATES[1].width
    tnext = tapi.svd_update(
        STATES[1], delta,
        tapi.SolveConfig(method="random", truncate_rank=K, num_blocks=D,
                         stream_backend="single"),
        draws=reference_draws(kb, "random", D, 16, w, w)).state
    np.testing.assert_allclose(tnext.s.numpy(), np.asarray(jnext.s),
                               rtol=1e-4, atol=1e-5 * float(jnext.s[0]))
    jhandle.commit(jnext)
    handle.commit(tnext)
    res, jres = (tapi.serve_topk(handle, q),
                 japi.serve_topk(jhandle, jnp.asarray(q.numpy())))
    assert res.version == jres.version == 1
    assert set(res.indices[:, 0].tolist()) == \
        set(np.asarray(jres.indices)[:, 0].tolist())


# ---------------------------------------------------------------------------
# stream/decay.py
# ---------------------------------------------------------------------------

def test_decay_half_life_is_exact():
    assert decay_from_timestamps(1000.0, 1000.0 - 60.0, 60.0) == 0.5
    assert decay_from_timestamps(1000.0, 1000.0 - 120.0, 60.0) == 0.25
    assert decay_from_timestamps(500.0, 500.0, 60.0) == 1.0


def test_decay_composes_over_gaps():
    h = 37.0
    one = decay_from_timestamps(80.0, 0.0, h)
    two = (decay_from_timestamps(30.0, 0.0, h)
           * decay_from_timestamps(80.0, 30.0, h))
    assert one == pytest.approx(two, rel=1e-12)


def test_decay_clock_skew_never_amplifies():
    assert decay_from_timestamps(100.0, 250.0, 60.0) == 1.0


def test_decay_extreme_gap_stays_valid_for_solve_config():
    d = decay_from_timestamps(0.0, -1e12, 1.0)
    assert 0.0 < d <= 1.0
    tapi.SolveConfig(truncate_rank=4, history_decay=d)
    tapi.SolveConfig(truncate_rank=4,
                     history_decay=decay_from_timestamps(10.0, 0.0, 5.0))


@pytest.mark.parametrize("kwargs", [
    dict(now=float("nan"), t_batch=0.0, half_life=1.0),
    dict(now=0.0, t_batch=float("inf"), half_life=1.0),
    dict(now=0.0, t_batch=0.0, half_life=0.0),
    dict(now=0.0, t_batch=0.0, half_life=-3.0),
])
def test_decay_rejects_bad_inputs(kwargs):
    with pytest.raises(ValueError) as te:
        decay_from_timestamps(**kwargs)
    with pytest.raises(ValueError) as je:
        jdecay(**kwargs)
    assert str(te.value) == str(je.value)


def test_decay_equals_the_reference_on_a_grid():
    for now in (0.0, 1.5, 60.0, 1e9):
        for t in (-1e12, 0.0, 1.0, 59.9):
            for h in (0.1, 1.0, 3600.0):
                assert decay_from_timestamps(now, t, h) == jdecay(now, t, h)
