"""The streaming slice: ``repro_torch.stream`` + ``api.svd_init`` /
``plan_update`` / ``svd_update`` against ``repro.stream`` and
``repro.core.api`` on the CPU.

* Config validation and the R5/R5d planner: the same errors (same
  messages), the same hand-computed bytes, plans equal to the reference's
  field by field, reasons as strings.
* Stream == one-shot: the single-host twins of ``tests/test_streaming.py``
  with ``svd_update`` loops in place of ``svd_stream`` (whose own twins are
  in ``tests/test_torch_window.py``).
* Direct parity: the same batches through both packages, the reference's
  per-batch draws (``fold_in(key, b)``) injected into the port; S at rtol
  1e-4 (f32 gram + eigh + panel SVD on two LAPACK builds), U and V by
  subspace projector where the spectrum has gaps, diagnostics equal.
* A reference state carried in through ``convert.state_from_numpy`` and
  updated by both packages.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import stream as jstream
from repro.core import api as japi
from repro.core import hierarchy as jhier
from repro.core import planner as jplanner
from repro.core import sparse as jsparse

from repro_torch import stream as tstream
from repro_torch.core import api as tapi
from repro_torch.core import convert
from repro_torch.core import hierarchy as thier
from repro_torch.core import planner as tplanner
from repro_torch.core import ranky as tranky
from repro_torch.core import sparse as tsparse

from test_torch_helpers import projector_gap, reference_draws, reference_omega

KEY = jax.random.PRNGKey(13)
RANK = 24
CPU = "cpu"


def _spectrum_matrix(m=32, n=96, seed=0):
    """Dense (m, n) float32 matrix with a known, well-separated spectrum."""
    rng = np.random.default_rng(seed)
    u0, _ = np.linalg.qr(rng.standard_normal((m, m)))
    v0, _ = np.linalg.qr(rng.standard_normal((n, m)))
    svals = np.geomspace(20.0, 0.5, m)
    return ((u0 * svals) @ v0.T).astype(np.float32)


def _sparse_coo(m=24, n=256, density=0.02, seed=3):
    return jsparse.ensure_full_row_rank(
        jsparse.random_bipartite(m, n, density, seed=seed, weighted=True),
        seed=seed)


def _dense_to_coo(a):
    r, c = np.nonzero(a)
    return jsparse.COOMatrix(rows=r.astype(np.int32), cols=c.astype(np.int32),
                             vals=a[r, c].astype(np.float32), shape=a.shape)


def _coo_rows(coo, lo, hi):
    sel = (coo.rows >= lo) & (coo.rows < hi)
    return jsparse.COOMatrix(rows=(coo.rows[sel] - lo).astype(np.int32),
                             cols=coo.cols[sel], vals=coo.vals[sel],
                             shape=(hi - lo, coo.shape[1]))


def _as_kind(coo, kind, d):
    """(reference delta, port delta) of a host COO in one representation."""
    tcoo = convert.coo_from_numpy(coo.rows, coo.cols, coo.vals, coo.shape)
    if kind == "dense":
        dense = coo.todense()
        return dense, dense.copy()
    if kind == "coo":
        return coo, tcoo
    return (jsparse.block_ell_from_coo(coo, d),
            tsparse.block_ell_from_coo(tcoo, d, device=CPU))


def _row_batches(a, num_batches, kind, d):
    mb = a.shape[0] // num_batches
    return [_as_kind(_dense_to_coo(a[i * mb:(i + 1) * mb]), kind, d)[1]
            for i in range(num_batches)]


def _port_stream(batches, cfg, n):
    st = tapi.svd_init(n, cfg, device=CPU)
    for delta in batches:
        st = tapi.svd_update(st, delta, cfg).state
    return st


def _both_raise(exc, jcall, tcall):
    with pytest.raises(exc) as je:
        jcall()
    with pytest.raises(exc) as te:
        tcall()
    return str(je.value), str(te.value)


# ---------------------------------------------------------------------------
# SolveConfig: the streaming knobs validate like every other knob
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs,field", [
    (dict(truncate_rank=0), "truncate_rank"),
    (dict(truncate_rank=-3), "truncate_rank"),
    (dict(history_decay=0.0), "history_decay"),
    (dict(history_decay=1.5), "history_decay"),
    (dict(history_decay=-0.1), "history_decay"),
])
def test_invalid_streaming_single_field_config(kwargs, field):
    jm, tm = _both_raise(ValueError, lambda: japi.SolveConfig(**kwargs),
                         lambda: tapi.SolveConfig(**kwargs))
    assert tm == jm and field in tm


@pytest.mark.parametrize("kwargs,fields", [
    (dict(truncate_rank=8, undetermined_tail=True, merge_mode="proxy"),
     ("truncate_rank", "undetermined_tail")),
    (dict(history_decay=0.9), ("history_decay", "truncate_rank")),
])
def test_invalid_streaming_cross_field_config(kwargs, fields):
    jm, tm = _both_raise(ValueError, lambda: japi.SolveConfig(**kwargs),
                         lambda: tapi.SolveConfig(**kwargs))
    assert tm == jm
    for f in fields:
        assert f in tm


def test_stream_backend_config_validation():
    with pytest.raises(ValueError, match="stream_backend"):
        tapi.SolveConfig(truncate_rank=8, stream_backend="proxy")
    jm, tm = _both_raise(
        ValueError, lambda: japi.SolveConfig(stream_backend="shard_map"),
        lambda: tapi.SolveConfig(stream_backend="shard_map"))
    assert tm == jm and "stream_backend" in tm and "truncate_rank" in tm


@pytest.mark.parametrize("kw,exc", [
    (dict(), ValueError),                                  # no truncate_rank
    (dict(truncate_rank=4, backend="shard_map"), ValueError),
    (dict(truncate_rank=4, local_mode="svd"), ValueError),
    (dict(truncate_rank=4, merge_mode="proxy"), ValueError),
    (dict(truncate_rank=4, sketch=True, backend="hierarchical"), ValueError),
])
def test_svd_update_requires_a_streaming_config(kw, exc):
    """The same refusals with the same messages as the reference."""
    delta = np.ones((2, 64), np.float32)
    jm, tm = _both_raise(
        exc,
        lambda: japi.svd_update(jstream.init_state(64, num_blocks=4), delta,
                                japi.SolveConfig(**kw)),
        lambda: tapi.svd_update(tstream.init_state(64, num_blocks=4,
                                                   device=CPU), delta,
                                tapi.SolveConfig(**kw)))
    assert tm == jm


def test_svd_update_rejects_what_is_not_a_state():
    with pytest.raises(TypeError, match="StreamingSVDState"):
        tapi.svd_update(np.ones((2, 2)), np.ones((2, 64), np.float32),
                        tapi.SolveConfig(truncate_rank=4))


@pytest.mark.parametrize("case", ["columns", "ell_blocks", "config_blocks"])
def test_delta_universe_mismatches_rejected(case):
    cfg = dict(truncate_rank=4, num_blocks=4)
    st = tapi.svd_init(64, tapi.SolveConfig(**cfg), device=CPU)
    jst = japi.svd_init(64, japi.SolveConfig(**cfg))
    ones = np.ones((2, 64), np.float32)
    if case == "columns":
        args = (np.ones((2, 32), np.float32), cfg)
        jargs = args
    elif case == "ell_blocks":
        coo = _dense_to_coo(ones)
        jargs = (jsparse.block_ell_from_coo(coo, 8), cfg)
        args = (_as_kind(coo, "ell", 8)[1], cfg)
    else:
        args = jargs = (ones, dict(truncate_rank=4, num_blocks=8))
    jm, tm = _both_raise(
        ValueError,
        lambda: japi.svd_update(jst, jargs[0], japi.SolveConfig(**jargs[1])),
        lambda: tapi.svd_update(st, args[0], tapi.SolveConfig(**args[1])))
    assert tm == jm


def test_oneshot_svd_rejects_streaming_knobs():
    a = _spectrum_matrix(m=16, n=96)
    with pytest.raises(ValueError, match="truncate_rank"):
        tapi.svd(a, tapi.SolveConfig(truncate_rank=8, num_blocks=4),
                 device=CPU)
    with pytest.raises(ValueError, match="truncate_rank"):
        tapi.plan(tplanner.ASpec(m=16, n=96, nnz=100, num_blocks=4),
                  tapi.SolveConfig(truncate_rank=8), device=CPU)


# ---------------------------------------------------------------------------
# Planner rules R5 / R5d: hand-computed bytes and plans equal to the
# reference's
# ---------------------------------------------------------------------------

BATCH_SPEC = tplanner.ASpec(m=64, n=4096, nnz=5_000, num_blocks=8)  # W = 512
J_BATCH_SPEC = jplanner.ASpec(m=64, n=4096, nnz=5_000, num_blocks=8)


def test_r5_byte_estimates_hand_computed():
    assert tplanner.stream_panel_width(16, 8, 64) == 24
    assert tplanner.stream_panel_width(16, 8, 10) == 10
    assert tplanner.stream_merge_bytes(BATCH_SPEC, 16, 8) == 1_310_720
    assert tplanner.stream_repair_bytes(BATCH_SPEC) == 2_097_152
    assert tplanner.streaming_bytes(BATCH_SPEC, 16, 8, exact=True) == \
        131_072 + 2_097_152 + 1_310_720
    assert tplanner.streaming_bytes(BATCH_SPEC, 16, 8, exact=False) == \
        540_672 + 2_097_152 + 1_310_720
    assert tplanner.streaming_bytes(BATCH_SPEC, 16, 8, exact=False,
                                    batch_rank=12) == \
        4 * (8 * 20 * 512 + 2 * 64 * 20) + 2_097_152 + 4 * 2 * 4096 * 28


def test_r5d_byte_estimates_hand_computed():
    assert tplanner.stream_merge_bytes_per_device(BATCH_SPEC, 16, 8) == \
        163_840
    assert tplanner.stream_repair_bytes_per_device(BATCH_SPEC) == 294_912
    assert tplanner.streaming_bytes_per_device(BATCH_SPEC, 16, 8,
                                               exact=True) == \
        16_384 + 294_912 + 163_840
    assert tplanner.streaming_bytes_per_device(BATCH_SPEC, 16, 8,
                                               exact=False) == \
        81_920 + 294_912 + 163_840
    assert tplanner.streaming_bytes_per_device(
        BATCH_SPEC, 16, 8, exact=False, batch_rank=12) == \
        51_200 + 294_912 + 114_688


TALL = dict(m=1_000_000, n=4096, nnz=10_000_000, num_blocks=8)


@pytest.mark.parametrize("spec,cfg,dc", [
    ("batch", dict(truncate_rank=16), 1),
    ("batch", dict(truncate_rank=16, rank=12), 1),
    ("batch", dict(truncate_rank=16, memory_budget_bytes=1), 1),
    ("batch", dict(truncate_rank=16, memory_budget_bytes=200_000,
                   oversample=40), 1),
    ("batch", dict(truncate_rank=16, stream_backend="shard_map"), 8),
    ("batch", dict(truncate_rank=16, stream_backend="shard_map"), 4),
    ("batch", dict(truncate_rank=16, stream_backend="shard_map"), 1),
    ("batch", dict(truncate_rank=16, stream_backend="single"), 8),
    ("batch", dict(truncate_rank=16, rank=12, stream_backend="shard_map"), 8),
    ("tall", dict(truncate_rank=16), 1),
])
def test_stream_plan_equals_the_reference(spec, cfg, dc):
    """Every field of the R5/R5d plan, reasons as strings, to the byte."""
    if spec == "batch":
        js, ts = J_BATCH_SPEC, BATCH_SPEC
    else:
        js, ts = jplanner.ASpec(**TALL), tplanner.ASpec(**TALL)
    jp = jplanner.make_stream_plan(js, japi.SolveConfig(**cfg),
                                   device_count=dc)
    tp = tplanner.make_stream_plan(ts, tapi.SolveConfig(**cfg),
                                   device_count=dc)
    assert (tp.backend, tp.strategy, tp.rank, tp.peak_bytes, tp.budget) == \
        (jp.backend, jp.strategy, jp.rank, jp.peak_bytes, jp.budget)
    assert tp.estimates == jp.estimates
    assert tp.reasons == jp.reasons


def test_r5_decisions_as_documented():
    p = tplanner.make_stream_plan(BATCH_SPEC, tapi.SolveConfig(truncate_rank=16))
    assert (p.strategy, p.backend, p.rank) == ("streaming", "single", None)
    assert p.peak_bytes == 131_072 + 2_097_152 + 1_310_720
    assert "independent of rows already ingested" in " ".join(p.reasons)
    tall = tplanner.make_stream_plan(tplanner.ASpec(**TALL),
                                     tapi.SolveConfig(truncate_rank=16))
    assert tall.rank == tplanner.stream_panel_width(16, 8, 1_000_000)
    assert tall.estimates["stream_sketch"] == tall.peak_bytes
    forced = tplanner.make_stream_plan(
        BATCH_SPEC, tapi.SolveConfig(truncate_rank=16, rank=12))
    assert forced.rank == 12 and any("explicitly" in r for r in forced.reasons)
    broke = tplanner.make_stream_plan(
        BATCH_SPEC, tapi.SolveConfig(truncate_rank=16, memory_budget_bytes=1))
    assert broke.rank is None
    assert any("NO batch factorization fits" in r for r in broke.reasons)


def test_plan_update_from_spec_and_from_delta():
    cfg = dict(truncate_rank=4)
    p = tapi.plan_update(BATCH_SPEC, tapi.SolveConfig(truncate_rank=16),
                         device=CPU)
    assert p.strategy == "streaming"
    st = tapi.svd_init(64, tapi.SolveConfig(truncate_rank=4, num_blocks=4),
                       device=CPU)
    jst = japi.svd_init(64, japi.SolveConfig(truncate_rank=4, num_blocks=4))
    delta = np.ones((8, 64), np.float32)
    p2 = tapi.plan_update(delta, tapi.SolveConfig(**cfg), state=st)
    jp2 = japi.plan_update(delta, japi.SolveConfig(**cfg), state=jst)
    assert p2.spec.m == 8 and p2.spec.num_blocks == 4
    assert p2.reasons == jp2.reasons and p2.estimates == jp2.estimates
    with pytest.raises(ValueError, match="state"):
        tapi.plan_update(delta, tapi.SolveConfig(**cfg), device=CPU)


def test_a_sharded_stream_plan_is_refused_not_run_single(monkeypatch):
    """One device per column block makes R5d pick shard_map; that engine is
    not ported, so svd_update raises instead of running something else."""
    monkeypatch.setattr(tapi, "_device_count", lambda device: 4)
    cfg = tapi.SolveConfig(truncate_rank=4, num_blocks=4)
    st = tapi.svd_init(64, cfg, device=CPU)
    with pytest.raises(NotImplementedError, match="item 8"):
        tapi.svd_update(st, np.ones((2, 64), np.float32), cfg)
    with pytest.raises(NotImplementedError, match="item 8"):
        tstream.ingest_shard_map(st, None, cfg, None)


# ---------------------------------------------------------------------------
# State, delta normalization, merge primitive
# ---------------------------------------------------------------------------

def test_streaming_state_is_a_frozen_dataclass():
    cfg = tapi.SolveConfig(method="none", truncate_rank=8, num_blocks=4)
    st = tapi.svd_update(tapi.svd_init(96, cfg, device=CPU),
                         _spectrum_matrix()[:8], cfg).state
    with pytest.raises(dataclasses.FrozenInstanceError):
        st.rows_seen = 3
    fields = [f.name for f in dataclasses.fields(tstream.StreamingSVDState)]
    jfields = [f.name for f in dataclasses.fields(jstream.StreamingSVDState)]
    assert fields == [("seed" if f == "key" else f) for f in jfields]
    assert (st.rows_seen, st.batches_seen, st.n, st.rank) == (8, 1, 96, 8)
    assert st.device == torch.device(CPU)


def test_rank0_state_has_the_reference_shapes():
    st = tapi.svd_init(90, tapi.SolveConfig(truncate_rank=8, num_blocks=4),
                       device=CPU)
    jst = japi.svd_init(90, japi.SolveConfig(truncate_rank=8, num_blocks=4))
    for f in ("u", "s", "v"):
        assert tuple(getattr(st, f).shape) == tuple(getattr(jst, f).shape)
    assert (st.width, st.n_pad, st.rank) == (jst.width, jst.n_pad, 0)
    assert st.seed == tranky.DEFAULT_SEED
    with pytest.raises(ValueError):
        tstream.init_state(0, num_blocks=2, device=CPU)


def test_as_delta_normalizes_every_representation():
    st = tstream.init_state(90, num_blocks=4, device=CPU)     # n_pad 92
    a = _spectrum_matrix(m=6, n=90)
    dense = tstream.as_delta(a, st)
    assert dense.shape == (6, 92) and dense.dtype == torch.float32
    assert torch.equal(tstream.as_delta(torch.from_numpy(a), st), dense)
    assert tstream.as_delta(dense, st) is not None
    assert torch.equal(tstream.as_delta(dense, st), dense)   # idempotent
    coo = _dense_to_coo(a)
    ell = tstream.as_delta(_as_kind(coo, "coo", 4)[1], st)
    assert isinstance(ell, tsparse.BlockEll) and ell.num_blocks == 4
    assert torch.equal(ell.todense(), dense)
    assert tstream.as_delta(ell, st) is not None
    with pytest.raises(ValueError, match="rows"):
        tstream.as_delta(np.zeros((0, 90), np.float32), st)
    with pytest.raises(ValueError, match="universe"):
        tstream.as_delta(np.zeros((2, 91), np.float32), st)


@pytest.mark.parametrize("m,r,rank", [(50, 7, 5), (6, 10, 8), (12, 4, 6)])
def test_merge_svd_matches_the_reference(m, r, rank):
    """Zero-padded when rank > min(M, R); P = U diag(S) W^T up to the
    truncated tail."""
    p = np.random.default_rng(m + r).standard_normal((m, r)).astype(np.float32)
    u, s, w = thier.merge_svd(torch.from_numpy(p), rank)
    ju, js, jw = jhier.merge_svd(jnp.asarray(p), rank)
    assert u.shape == ju.shape and s.shape == js.shape and w.shape == jw.shape
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    k = min(m, r, rank)
    recon = (u[:, :k] * s[:k]) @ w[:, :k].T
    jrecon = (np.asarray(ju)[:, :k] * np.asarray(js)[:k]) @ np.asarray(jw)[:, :k].T
    np.testing.assert_allclose(recon.numpy(), jrecon, atol=1e-4)
    assert not s[k:].any()


def test_fault_seam_fires_at_both_points():
    cfg = tapi.SolveConfig(method="none", truncate_rank=4, num_blocks=4)
    st = tapi.svd_init(96, cfg, device=CPU)
    seen = []

    def seam(phase):
        seen.append(phase)
        if phase == "ingest.merge":
            raise RuntimeError("injected")

    tstream.install_fault_seam(seam)
    try:
        with pytest.raises(RuntimeError, match="injected"):
            tapi.svd_update(st, _spectrum_matrix()[:4], cfg)
    finally:
        tstream.install_fault_seam(None)
    assert seen == ["ingest.batch", "ingest.merge"]
    assert tapi.svd_update(st, _spectrum_matrix()[:4], cfg).state.rank == 4


# ---------------------------------------------------------------------------
# Stream == one-shot (the single-host twins of tests/test_streaming.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "coo", "ell"])
def test_stream_matches_oneshot_spectrum_matrix(kind):
    d, b = 4, 4
    a = _spectrum_matrix(m=32, n=96)
    cfg = tapi.SolveConfig(method="none", truncate_rank=RANK, oversample=8,
                           num_blocks=d)
    st = _port_stream(_row_batches(a, b, kind, d), cfg, 96)
    assert st.rows_seen == 32 and st.batches_seen == b and st.rank == RANK
    oracle = tapi.svd(a, tapi.SolveConfig(method="none", num_blocks=d,
                                          backend="single",
                                          merge_mode="gram"), device=CPU)
    s_true = oracle.s.numpy()[:RANK]
    assert np.abs(st.s.numpy() - s_true).max() <= 1e-3 * s_true[0]
    c = np.linalg.svd(st.u.numpy()[:, :8].T @ oracle.u.numpy()[:, :8],
                      compute_uv=False)
    assert c.min() > 1.0 - 1e-4, f"subspace angle too wide: cos={c.min()}"


@pytest.mark.parametrize("kind", ["dense", "coo", "ell"])
def test_stream_matches_oneshot_sparse_bipartite(kind):
    d, n = 4, 256
    coo = _sparse_coo(m=24, n=n)
    dense = coo.todense()
    batches = [_as_kind(_coo_rows(coo, 6 * i, 6 * i + 6), kind, d)[1]
               for i in range(4)]
    st = _port_stream(batches, tapi.SolveConfig(method="none",
                                                truncate_rank=24,
                                                num_blocks=d), n)
    s_true = np.linalg.svd(dense, compute_uv=False)
    assert np.abs(st.s.numpy() - s_true[:24]).max() <= 1e-3 * s_true[0]
    recon = (st.u * st.s) @ st.trimmed_v().T
    assert np.abs(recon.numpy() - dense).max() <= 1e-3 * s_true[0]


def test_history_decay_matches_decayed_oneshot():
    d, b, decay = 4, 4, 0.5
    a = _spectrum_matrix(m=32, n=96, seed=7)
    cfg = tapi.SolveConfig(method="none", truncate_rank=32, oversample=8,
                           num_blocks=d, history_decay=decay)
    st = _port_stream(_row_batches(a, b, "dense", d), cfg, 96)
    mb = 32 // b
    scaled = np.concatenate(
        [a[i * mb:(i + 1) * mb] * decay ** (b - 1 - i) for i in range(b)])
    s_true = np.linalg.svd(scaled, compute_uv=False)
    assert np.abs(st.s.numpy() - s_true).max() <= 1e-3 * s_true[0]


def test_rank_deficient_batch_requires_repair():
    """The rank problem, streaming edition: without repair the truncated
    batch sketch loses the tail for good; with it the stream recovers the
    spectrum of the matrix the stream actually factored (batch 0 repaired
    with the port's own chain, ``derive_seed(DEFAULT_SEED, 0)``)."""
    coo = jsparse.ensure_full_row_rank(
        jsparse.random_bipartite(16, 1024, 0.006, seed=11, weighted=True),
        seed=11)
    dead = np.isin(coo.rows, (2, 9, 13))
    coo = jsparse.COOMatrix(rows=coo.rows[~dead], cols=coo.cols[~dead],
                            vals=coo.vals[~dead], shape=coo.shape)
    tcoo = _as_kind(coo, "coo", 8)[1]
    k = 15
    base = dict(truncate_rank=k, rank=k, oversample=32, power_iters=4,
                num_blocks=8)
    none_cfg = tapi.SolveConfig(method="none", **base)
    fix_cfg = tapi.SolveConfig(method="neighbor_random", **base)
    res_none = tapi.svd_update(tapi.svd_init(1024, none_cfg, device=CPU),
                               tcoo, none_cfg)
    res_fix = tapi.svd_update(tapi.svd_init(1024, fix_cfg, device=CPU),
                              tcoo, fix_cfg)
    assert res_fix.plan.rank == k
    ell = tsparse.block_ell_from_coo(tcoo, 8, device=CPU)
    repaired = tranky.split_and_repair(
        ell, 8, "neighbor_random",
        tranky.derive_seed(tranky.DEFAULT_SEED, 0)).todense().numpy()
    s_true = np.linalg.svd(repaired, compute_uv=False)
    assert float(res_none.s[-1]) < 1e-4 * s_true[0]
    assert s_true[k - 1] > 0.05 * s_true[0]
    np.testing.assert_allclose(res_fix.s.numpy(), s_true[:k], rtol=1e-3,
                               atol=1e-3 * s_true[0])
    assert res_fix.diagnostics.repaired_rows > 0
    assert res_none.diagnostics.repaired_rows == 0
    after = tapi.svd_update(res_fix.state, tcoo, fix_cfg)
    assert after.state.lonely_rows_seen == 2 * res_fix.state.lonely_rows_seen
    assert after.state.repaired_rows_seen == \
        res_fix.state.repaired_rows_seen + after.diagnostics.repaired_rows
    assert after.diagnostics.repaired_rows > 0


def test_want_right_trims_to_original_columns():
    a = _spectrum_matrix(m=16, n=90)                 # 90 pads to 92
    cfg = tapi.SolveConfig(method="none", truncate_rank=8, num_blocks=4,
                           want_right=True)
    st = tapi.svd_init(90, cfg, device=CPU)
    res = None
    for delta in _row_batches(a, 2, "dense", 4):
        res = tapi.svd_update(st, delta, cfg)
        st = res.state
    assert res.v is not None and res.v.shape == (90, 8)
    assert res.state.v.shape == (92, 8)
    no_v = tapi.svd_update(st, a[:2], tapi.SolveConfig(
        method="none", truncate_rank=8, num_blocks=4))
    assert no_v.v is None


def test_unkeyed_streams_are_deterministic():
    coo = _sparse_coo()
    cfg = tapi.SolveConfig(method="random", truncate_rank=12, num_blocks=4)
    batches = [_as_kind(_coo_rows(coo, 6 * i, 6 * i + 6), "coo", 4)[1]
               for i in range(4)]
    s1, s2 = (_port_stream(batches, cfg, 256) for _ in range(2))
    for f in ("u", "s", "v"):
        assert torch.equal(getattr(s1, f), getattr(s2, f))
    keyed = _port_stream(batches, tapi.SolveConfig(
        method="random", truncate_rank=12, num_blocks=4, key=5), 256)
    assert not torch.equal(keyed.u, s1.u)


def test_update_diagnostics_and_plan():
    cfg = tapi.SolveConfig(method="neighbor_random", truncate_rank=6,
                           num_blocks=4)
    coo = _sparse_coo()
    res = tapi.svd_update(tapi.svd_init(256, cfg, device=CPU),
                          _as_kind(_coo_rows(coo, 0, 12), "coo", 4)[1], cfg)
    dg = res.diagnostics
    assert dg.strategy == "streaming" and res.plan.strategy == "streaming"
    assert dg.estimated_peak_bytes == res.plan.peak_bytes
    assert dg.wall_time_s > 0 and dg.compile_time_s == 0.0
    assert dg.lonely_rows == sum(dg.lonely_rows_per_block)
    assert dg.repaired_rows == dg.lonely_rows    # neighbor_random fixes all
    assert res.u is res.state.u and res.s is res.state.s


# ---------------------------------------------------------------------------
# Direct parity: the reference's per-batch draws injected into the port
# ---------------------------------------------------------------------------

def _draws_for(key_b, method, delta_j, d, m_b):
    """The reference's draws for one batch, in the port's layout."""
    if isinstance(delta_j, np.ndarray):
        w = jsparse.block_width(delta_j.shape[1], d)
        return reference_draws(key_b, method, d, m_b, w, w)
    ell = (delta_j if isinstance(delta_j, jsparse.BlockEll)
           else jsparse.block_ell_from_coo(delta_j, d))
    return reference_draws(key_b, method, d, m_b, ell.width,
                           ell.col_rows.shape[1])


@pytest.mark.parametrize("method,kind,rank", [
    ("none", "dense", None),
    ("neighbor", "ell", None),
    ("neighbor_random", "coo", None),
    ("neighbor_random", "dense", None),
    ("random", "coo", 6),
    ("neighbor_random", "ell", 6),
])
def test_stream_parity_with_injected_draws(method, kind, rank):
    d, n, mb = 4, 600, 10
    coo = jsparse.ensure_full_row_rank(
        jsparse.random_bipartite(40, n, 0.03, seed=1, weighted=True), seed=1)
    kw = dict(method=method, truncate_rank=8, num_blocks=d, oversample=4,
              want_right=True)
    if rank:
        kw["rank"] = rank
    jcfg, tcfg = japi.SolveConfig(key=KEY, **kw), tapi.SolveConfig(**kw)
    jst, tst = japi.svd_init(n, jcfg), tapi.svd_init(n, tcfg, device=CPU)
    for b in range(4):
        jd, td = _as_kind(_coo_rows(coo, mb * b, mb * (b + 1)), kind, d)
        kb = jax.random.fold_in(KEY, b)
        omega = reference_omega(kb, min(rank + 4, mb), mb) if rank else None
        jr = japi.svd_update(jst, jd, jcfg)
        tr = tapi.svd_update(tst, td, tcfg, draws=_draws_for(kb, method, jd, d, mb),
                             omega=omega)
        jst, tst = jr.state, tr.state
        assert tr.plan.rank == jr.plan.rank
        assert tr.plan.reasons == jr.plan.reasons
        assert (tr.diagnostics.lonely_rows_per_block,
                tr.diagnostics.repaired_rows) == \
            (jr.diagnostics.lonely_rows_per_block,
             jr.diagnostics.repaired_rows)
    js, ts = np.asarray(jst.s), tst.s.numpy()
    np.testing.assert_allclose(ts, js, rtol=1e-4, atol=1e-5 * js[0])
    assert (tst.rows_seen, tst.lonely_rows_seen, tst.repaired_rows_seen) == \
        (jst.rows_seen, jst.lonely_rows_seen, jst.repaired_rows_seen)
    gaps = js[:-1] / js[1:]
    j = int(np.argmax(gaps > 1.05)) + 1 if (gaps > 1.05).any() else 1
    assert projector_gap(tst.u.numpy()[:, :j], np.asarray(jst.u)[:, :j]) < 1e-3
    assert projector_gap(tr.v.numpy()[:, :j], np.asarray(jr.v)[:, :j]) < 1e-3


def test_reference_state_carried_in_and_updated_by_both():
    """A reference state after two batches -> ``convert.state_from_numpy``
    -> the third batch through both packages (reference draws injected).
    Same shapes as the parity test above, so the reference compiles
    nothing new."""
    d, n, mb = 4, 600, 10
    coo = jsparse.ensure_full_row_rank(
        jsparse.random_bipartite(40, n, 0.03, seed=1, weighted=True), seed=1)
    kw = dict(method="neighbor_random", truncate_rank=8, num_blocks=d,
              oversample=4)
    jcfg, tcfg = japi.SolveConfig(key=KEY, **kw), tapi.SolveConfig(**kw)
    jst = japi.svd_init(n, jcfg)
    for b in range(2):
        jst = japi.svd_update(jst, _coo_rows(coo, mb * b, mb * (b + 1)),
                              jcfg).state
    tst = convert.state_from_numpy(
        np.asarray(jst.u), np.asarray(jst.s), np.asarray(jst.v), n=jst.n,
        num_blocks=jst.num_blocks, rows_seen=jst.rows_seen,
        batches_seen=jst.batches_seen, lonely_rows_seen=jst.lonely_rows_seen,
        repaired_rows_seen=jst.repaired_rows_seen, seed=7, device=CPU)
    assert (tst.rank, tst.n_pad, tst.batches_seen) == (jst.rank, jst.n_pad, 2)
    assert np.array_equal(tst.v.numpy(), np.asarray(jst.v))
    jd, td = _as_kind(_coo_rows(coo, 2 * mb, 3 * mb), "coo", d)
    kb = jax.random.fold_in(KEY, 2)
    jnext = japi.svd_update(jst, jd, jcfg).state
    tnext = tapi.svd_update(tst, td, tcfg,
                            draws=_draws_for(kb, kw["method"], jd, d, mb)).state
    js = np.asarray(jnext.s)
    np.testing.assert_allclose(tnext.s.numpy(), js, rtol=1e-4,
                               atol=1e-5 * js[0])
    assert projector_gap(tnext.v.numpy()[:, :4], np.asarray(jnext.v)[:, :4]) \
        < 1e-3
    assert (tnext.rows_seen, tnext.repaired_rows_seen) == \
        (jnext.rows_seen, jnext.repaired_rows_seen)


def test_state_from_numpy_validates_shapes():
    u, s, v = np.zeros((3, 2)), np.ones(2), np.zeros((92, 2))
    kw = dict(n=90, num_blocks=4, rows_seen=3, batches_seen=1,
              lonely_rows_seen=0, repaired_rows_seen=0, device=CPU)
    assert convert.state_from_numpy(u, s, v, **kw).rank == 2
    with pytest.raises(ValueError, match="rank"):
        convert.state_from_numpy(u, np.ones(3), v, **kw)
    with pytest.raises(ValueError, match="rows_seen"):
        convert.state_from_numpy(u, s, v, **dict(kw, rows_seen=4))
    with pytest.raises(ValueError, match="pads"):
        convert.state_from_numpy(u, s, v[:90], **kw)


@pytest.mark.parametrize("kind", ["dense", "coo", "ell"])
def test_batch_universe_and_nnz_estimate_match_the_reference(kind):
    """The two shape helpers of the streaming front door: the universe a
    fresh stream adopts from its first delta, and the O(1) nnz of a delta."""
    coo = _sparse_coo()
    jd, td = _as_kind(coo, kind, 4)
    assert tapi._batch_universe(td) == japi._batch_universe(jd)
    assert tapi._delta_nnz_estimate(td) == japi._delta_nnz_estimate(jd)
