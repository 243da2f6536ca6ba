"""The scan-window stream driver: ``repro_torch.stream.window``, planner
rule R6 and ``api.svd_stream`` against ``repro.stream.window``,
``repro.core.planner`` and ``repro.core.api`` on the CPU.

* Twins of the single-host tests of ``tests/test_streaming_scan.py``,
  the masked-padding oracle first: bucket signatures, padded rows exactly
  inert, scan vs loop (``window=T`` vs length-1 windows) equal bit for bit
  (``torch.equal``) for dense, COO and BlockEll deltas, ragged batches,
  the step shape / window length counts, R6's closed forms, the
  tail-adaptive width, ``svd_stream`` over generators, mixed buckets and a
  resumed state.
* Exact against the reference: plans and every reason string, R6 bytes,
  bucket signatures and slot counts, the dispatch / bucket / trace counts
  of the same stream, lonely and repaired counts, ``adaptive_oversample``.
* Direct parity: ``svd_stream`` through both packages with the reference's
  per-batch draws (``fold_in(key, b)``, at the bucket's padded shape inside
  a window) injected into the port; S at rtol 1e-4, atol 1e-5 * S[0], U and
  V by subspace projector on the separated leading columns.
"""
import dataclasses

import numpy as np
import jax
import pytest
import torch

from repro import stream as jstream
from repro.core import api as japi
from repro.core import planner as jplanner
from repro.core import sparse as jsparse
from repro.stream import window as jsw

from repro_torch.core import api as tapi
from repro_torch.core import convert
from repro_torch.core import hierarchy as thier
from repro_torch.core import planner as tplanner
from repro_torch.core import ranky as tranky
from repro_torch.core import sparse as tsparse
from repro_torch.core import svd as tsvd
from repro_torch.stream import as_delta, init_state
from repro_torch.stream import window as sw

from test_torch_helpers import projector_gap, reference_draws, reference_omega

N, D, K = 96, 4, 12
CFG = tapi.SolveConfig(truncate_rank=K, num_blocks=D)
CPU = "cpu"


def _batches(num, m=8, seed=0, density=0.25):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((m, N)).astype(np.float32)
            * (rng.random((m, N)) < density) for _ in range(num)]


def _steady_state(cfg=CFG, seed=99):
    """A state grown to truncate_rank via the per-batch path."""
    state = tapi.svd_init(N, cfg, device=CPU)
    for b in _batches(2, seed=seed):
        state = tapi.svd_update(state, b, cfg).state
    assert state.rank == cfg.truncate_rank
    return state


def _assert_states_equal(a, b, fields=("u", "s", "v")):
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _plan(cfg=CFG, m_pad=8, nnz_slots=None):
    spec = tplanner.ASpec(m=m_pad, n=N, nnz=m_pad * N, num_blocks=D,
                          kind="stream")
    return tplanner.make_window_plan(spec, cfg, device_count=1,
                                     nnz_slots=nnz_slots)


def _coo_of(b):
    r, c = np.nonzero(b)
    return jsparse.COOMatrix(rows=r.astype(np.int32), cols=c.astype(np.int32),
                             vals=b[r, c].astype(np.float32), shape=b.shape)


def _port_coo(jcoo):
    return convert.coo_from_numpy(jcoo.rows, jcoo.cols, jcoo.vals,
                                  jcoo.shape)


def _plan_dict(p):
    d = dataclasses.asdict(p)
    d["estimated_peak_bytes"] = p.estimated_peak_bytes
    d["explain"] = p.explain()
    return d


# ---------------------------------------------------------------------------
# The masked-padding oracle
# ---------------------------------------------------------------------------

def test_padded_rows_provably_inert():
    """The masked-oracle equality: window-ingesting an m_b < m_pad batch
    equals the eager repair-then-MASK computation (padded rows exactly
    zeroed after repair, u_b sliced to the true rows), bit for bit."""
    rng = np.random.default_rng(11)
    m_b, m_pad = 6, 8
    batch = (rng.standard_normal((m_b, N)).astype(np.float32)
             * (rng.random((m_b, N)) < 0.3))
    batch[4, :] = 0.0                       # a real lonely row, repaired
    state = _steady_state()
    got, info = sw.ingest_window(state, [batch], CFG, _plan())

    # Oracle: pad, repair with the window's seed chain, mask, factor,
    # merge, fold, one op after the other.
    a_norm = as_delta(batch, state)
    a_pad = torch.zeros((m_pad, a_norm.shape[1]))
    a_pad[:m_b] = a_norm
    seed_b = tranky.derive_seed(state.seed, state.batches_seen)
    valid = torch.arange(m_pad) < m_b
    blocks = tranky.split_and_repair(a_pad, D, CFG.method, seed_b)
    blocks = torch.where(valid[None, :, None], blocks, 0.0)
    r_b = min(m_pad, K + CFG.oversample)
    u_b, _ = tsvd.merge_grams_eigh(tsvd.gram_stack(blocks))
    u_b = u_b[:, :r_b]
    panel = tranky.right_vectors_stack(blocks, u_b, torch.ones(r_b))
    p = torch.cat([state.v * (state.s * torch.tensor(1.0))[None, :], panel],
                  dim=1)
    v_new, s_new, uk = thier.merge_svd(p, K)
    u_new = torch.cat([state.u @ uk[:K], u_b[:m_b] @ uk[K:]], dim=0)

    assert torch.equal(got.s, s_new)
    assert torch.equal(got.v, v_new)
    assert torch.equal(got.u, u_new)
    assert got.u.shape[0] == state.u.shape[0] + m_b
    # the zeroed row is lonely in EVERY column block; the padded rows
    # (also all-zero) are never counted
    assert info.lonely_rows >= D
    assert info.repaired_rows == info.lonely_rows


def test_padded_ell_rows_and_slots_are_inert():
    """An ELL bucket pads rows, stored columns and slots: the window equals
    the per-batch engine on the same batch within float rounding of the
    gram's order (repair-free, so no draw depends on the padded shape), and
    the padded rows are neither lonely nor repaired."""
    cfg = tapi.SolveConfig(truncate_rank=4, num_blocks=D, oversample=2,
                           method="none")
    rng = np.random.default_rng(3)
    grow = [rng.standard_normal((6, N)).astype(np.float32) for _ in range(2)]
    state = tapi.svd_init(N, cfg, device=CPU)
    for b in grow:
        state = tapi.svd_update(state, b, cfg).state
    coo = _port_coo(jsparse.random_bipartite(6, N, 0.3, seed=8,
                                             weighted=True))
    ell = as_delta(coo, state)
    sig = sw.bucket_signature(ell)
    assert sig[2] > ell.capacity[0] or sig[3] > ell.capacity[1] \
        or sig[1] > ell.m
    padded, info = sw.ingest_window(state, [coo], cfg, _plan(cfg, m_pad=8))
    legacy = tapi.svd_update(state, coo, cfg).state
    np.testing.assert_allclose(padded.s.numpy(), legacy.s.numpy(),
                               rtol=1e-5, atol=1e-6)
    assert padded.u.shape == legacy.u.shape
    assert info.lonely_rows == sum(tranky.lonely_rows_per_block(ell, D))


# ---------------------------------------------------------------------------
# Bucketing prologue
# ---------------------------------------------------------------------------

def test_bucket_signature_dense_pow2_rows():
    st = init_state(N, num_blocks=D, device=CPU)
    jst = jstream.init_state(N, num_blocks=D)
    for m_b, m_pad in ((1, 8), (5, 8), (8, 8), (9, 16), (16, 16), (33, 64)):
        x = np.ones((m_b, N), np.float32)
        sig = sw.bucket_signature(as_delta(x, st))
        assert sig == ("dense", m_pad), (m_b, sig)
        assert sig == jsw.bucket_signature(jstream.as_delta(x, jst))
        assert sw.bucket_rows(m_b) == jsw.bucket_rows(m_b)


@pytest.mark.parametrize("m,density,seed", [(8, 0.1, 3), (13, 0.05, 4),
                                            (40, 0.3, 5)])
def test_bucket_signature_ell_pads_capacity(m, density, seed):
    st = init_state(N, num_blocks=D, device=CPU)
    jst = jstream.init_state(N, num_blocks=D)
    jcoo = jsparse.random_bipartite(m, N, density, seed=seed)
    ell = as_delta(_port_coo(jcoo), st)
    sig = sw.bucket_signature(ell)
    c, k = ell.capacity
    assert sig[0] == "ell" and sig[1] == sw.bucket_rows(m)
    assert sig[2] >= max(8, c) and sig[2] & (sig[2] - 1) == 0
    assert sig[3] >= k and sig[3] & (sig[3] - 1) == 0
    assert sig == jsw.bucket_signature(jstream.as_delta(jcoo, jst))
    assert sw.bucket_nnz_slots(sig, D) == D * sig[2] * sig[3] == \
        jsw.bucket_nnz_slots(sig, D)
    assert sw.bucket_nnz_slots(("dense", 8), D) is None


def test_build_window_stacks_on_the_host_and_pads_with_zeros():
    st = init_state(N, num_blocks=D, device=CPU)
    coos = [_port_coo(jsparse.random_bipartite(8, N, 0.1, seed=s))
            for s in (1, 2)]
    norm = [as_delta(x, st, device="cpu") for x in coos]
    sig = ("ell", 8, 64, 8)
    ids, rows, vals = sw.build_window(norm, sig, device="cpu")
    assert ids.shape == (2, D, 64) and rows.shape == vals.shape == \
        (2, D, 64, 8)
    for t, e in enumerate(norm):
        c, k = e.capacity
        assert torch.equal(vals[t, :, :c, :k], e.col_vals)
        assert float(vals[t, :, c:].abs().sum() + vals[t, :, :, k:]
                     .abs().sum()) == 0.0
    (a,) = sw.build_window([torch.ones((5, N))], ("dense", 8), device="cpu")
    assert a.shape == (1, 8, N) and float(a[0, 5:].abs().sum()) == 0.0


def test_ingest_window_rejects_mixed_buckets_and_growing_rank():
    state = _steady_state()
    p = _plan()
    mixed = [np.ones((8, N), np.float32), np.ones((20, N), np.float32)]
    with pytest.raises(ValueError, match="mixed buckets") as t_err:
        sw.ingest_window(state, mixed, CFG, p)
    jcfg = japi.SolveConfig(truncate_rank=K, num_blocks=D)
    jstate = japi.svd_init(N, jcfg)
    for b in _batches(2, seed=99):
        jstate = japi.svd_update(jstate, b, jcfg).state
    jp = jplanner.make_window_plan(
        jplanner.ASpec(m=8, n=N, nnz=8 * N, num_blocks=D, kind="stream"),
        jcfg, device_count=1)
    with pytest.raises(ValueError) as j_err:
        jsw.ingest_window(jstate, mixed, jcfg, jp)
    assert str(t_err.value) == str(j_err.value)
    fresh = tapi.svd_init(N, CFG, device=CPU)
    with pytest.raises(ValueError, match="steady-state") as t_err:
        sw.ingest_window(fresh, [np.ones((8, N), np.float32)], CFG, p)
    with pytest.raises(ValueError) as j_err:
        jsw.ingest_window(japi.svd_init(N, jcfg),
                          [np.ones((8, N), np.float32)], jcfg, jp)
    assert str(t_err.value) == str(j_err.value)
    # A shard_map plan needs one slot per column block in the stream pool
    # (one here): refused with the reference's message, not run single.
    with pytest.raises(ValueError, match="one device per column block"):
        sw.ingest_window(state, mixed[:1], CFG,
                         dataclasses.replace(p, backend="shard_map"))


# ---------------------------------------------------------------------------
# Scan vs loop: bit-identical (loop = length-1 windows through the SAME
# step).  Rank-deficient batches force repair inside the window; ragged
# row counts force padding + masking.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "coo", "ell"])
def test_scan_vs_loop_bit_identical(kind):
    dense = _batches(6, seed=1)
    dense[2][3, :] = 0.0          # lonely rows -> repaired inside the window
    dense[2][5, :] = 0.0
    state0 = _steady_state()
    if kind == "dense":
        deltas = dense
    else:
        deltas = []
        for b in dense:
            coo = _port_coo(_coo_of(b))
            deltas.append(coo if kind == "coo"
                          else tsparse.block_ell_from_coo(coo, D,
                                                          device="cpu"))
        # one bucket only: keep the group that shares a signature
        sigs = [sw.bucket_signature(as_delta(x, state0)) for x in deltas]
        keep = max(set(sigs), key=sigs.count)
        deltas = [x for x, s in zip(deltas, sigs) if s == keep]
        assert len(deltas) >= 3
    p = _plan()

    scan_state, scan_info = sw.ingest_window(state0, deltas, CFG, p)
    loop_state = state0
    lonely = repaired = 0
    for x in deltas:
        loop_state, info = sw.ingest_window(loop_state, [x], CFG, p)
        lonely += info.lonely_rows
        repaired += info.repaired_rows
    _assert_states_equal(scan_state, loop_state)
    assert scan_state.batches_seen == loop_state.batches_seen
    assert scan_info.lonely_rows == lonely
    assert scan_info.repaired_rows == repaired
    if kind == "dense":
        assert scan_info.lonely_rows >= 2     # the zeroed rows were seen
        assert scan_info.repaired_rows >= 2   # ... and repaired


def test_randomized_window_scan_vs_loop_bit_identical():
    """rank= forces the randomized batch factorization (sketch, segmented
    pullback) inside the window: scan == loop bitwise, on an ELL bucket."""
    cfg = tapi.SolveConfig(truncate_rank=6, num_blocks=D, rank=4,
                           oversample=3, method="neighbor_random")
    state0 = tapi.svd_init(N, cfg, device=CPU)
    for b in _batches(2, m=16, seed=4):
        state0 = tapi.svd_update(state0, b, cfg).state
    coos = [_port_coo(jsparse.random_bipartite(16, N, 0.2, seed=60 + i,
                                               weighted=True))
            for i in range(8)]
    sigs = [sw.bucket_signature(as_delta(x, state0)) for x in coos]
    keep = max(set(sigs), key=sigs.count)
    deltas = [x for x, s in zip(coos, sigs) if s == keep]
    assert len(deltas) >= 3
    p = _plan(cfg, m_pad=keep[1], nnz_slots=sw.bucket_nnz_slots(keep, D))
    assert p.rank == 4
    a, _ = sw.ingest_window(state0, deltas, cfg, p)
    b = state0
    for x in deltas:
        b, _ = sw.ingest_window(b, [x], cfg, p)
    _assert_states_equal(a, b)


def test_scan_matches_per_batch_engine_when_shapes_align():
    """With m_b == m_pad the window replays the per-batch engine's seed
    chain and shapes, so the whole stream is bit-identical to the
    per-batch svd_update loop."""
    batches = _batches(5, seed=2)
    batches[1][0, :] = 0.0
    scan_state = _steady_state()
    scan_state, _ = sw.ingest_window(scan_state, batches, CFG, _plan())
    legacy = _steady_state()
    for b in batches:
        legacy = tapi.svd_update(legacy, b, CFG).state
    _assert_states_equal(scan_state, legacy)
    assert scan_state.lonely_rows_seen == legacy.lonely_rows_seen
    assert scan_state.repaired_rows_seen == legacy.repaired_rows_seen


def test_ragged_batches_pad_and_mask():
    """5-row batches pad to the 8-row bucket: scan == loop bitwise, u
    grows by exactly the TRUE row counts, counters ignore padding."""
    rng = np.random.default_rng(7)
    deltas = [rng.standard_normal((5, N)).astype(np.float32)
              * (rng.random((5, N)) < 0.3) for _ in range(4)]
    state0 = _steady_state()
    rows0 = state0.u.shape[0]
    a_state, a_info = sw.ingest_window(state0, deltas, CFG, _plan())
    b_state = state0
    for x in deltas:
        b_state, _ = sw.ingest_window(b_state, [x], CFG, _plan())
    _assert_states_equal(a_state, b_state)
    assert a_state.u.shape[0] == rows0 + 4 * 5
    assert a_info.batch_rows == 20
    # full-rank 5-row batches: no padding row ever counted or repaired
    assert a_info.lonely_rows == 0 and a_info.repaired_rows == 0


def test_padding_changes_nothing_for_repair_free_batches():
    """method='none' (no draw, no repair): the padded bucket's spectrum
    matches the unpadded per-batch engine's whenever the merge width
    agrees: the padded rows carry exactly zero weight."""
    cfg = tapi.SolveConfig(truncate_rank=4, num_blocks=D, oversample=2,
                           method="none")
    rng = np.random.default_rng(13)
    grow = [rng.standard_normal((6, N)).astype(np.float32)
            for _ in range(2)]
    batch = rng.standard_normal((6, N)).astype(np.float32)  # m_pad=8

    state = tapi.svd_init(N, cfg, device=CPU)
    for b in grow:
        state = tapi.svd_update(state, b, cfg).state
    assert state.rank == 4
    padded, _ = sw.ingest_window(state, [batch], cfg, _plan(cfg, m_pad=8))
    legacy = tapi.svd_update(state, batch, cfg).state
    np.testing.assert_allclose(padded.s.numpy(), legacy.s.numpy(),
                               rtol=1e-5, atol=1e-6)
    assert padded.u.shape == legacy.u.shape


# ---------------------------------------------------------------------------
# Step shapes and window lengths: one per bucket shape, not per batch
# ---------------------------------------------------------------------------

def test_one_trace_per_bucket_shape_not_per_batch():
    sw.clear_caches()
    jsw.clear_caches()
    cfg = tapi.SolveConfig(truncate_rank=K, num_blocks=D, window=4)
    jcfg = japi.SolveConfig(truncate_rank=K, num_blocks=D, window=4)
    batches = _batches(11, seed=17)     # 2 grow the rank, 9 stream
    res = tapi.svd_stream(iter(batches), cfg, device=CPU)
    japi.svd_stream(iter(batches), jcfg)
    assert res.state.batches_seen == 11
    assert sw.bucket_count() == 1 == jsw.bucket_count()
    counts = sw.dispatch_counts()
    assert counts == {"windows": 3, "batches": 9} == jsw.dispatch_counts()
    # two window lengths (4 and 1) of the ONE step shape, nowhere near
    # one per batch
    assert sw.trace_count() == 2 == jsw.trace_count()
    # replaying the same stream shape adds NO new step shapes or lengths
    tapi.svd_stream(iter(_batches(11, seed=18)), cfg, device=CPU)
    assert sw.bucket_count() == 1 and sw.trace_count() == 2
    sw.clear_caches()
    jsw.clear_caches()
    assert sw.dispatch_counts() == {"windows": 0, "batches": 0}


# ---------------------------------------------------------------------------
# Planner rule R6: closed forms pinned by hand, window choice, degrade
# ---------------------------------------------------------------------------

# Bucketed batch: m_pad=64 rows, n=4096 over D=8 -> W=512; k=16, p=8.
SPEC = dict(m=64, n=4096, nnz=5000, num_blocks=8, kind="stream")
R6_CFG = dict(truncate_rank=16, num_blocks=8)


def test_r6_byte_estimates_hand_computed():
    spec = tplanner.ASpec(**SPEC)
    jspec = jplanner.ASpec(**SPEC)
    assert tplanner.DEFAULT_WINDOW == jplanner.DEFAULT_WINDOW == 16
    # carry: 4 * (k * (N_pad + 1) + D + 3)
    assert tplanner.window_carry_bytes(spec, 16) == 4 * (16 * 4097 + 11)
    assert tplanner.window_carry_bytes(spec, 16, per_device=True) == \
        4 * (16 * 513 + 11)
    # dense inputs: T * m * N_pad floats (per device: m * W)
    assert tplanner.window_input_bytes(spec, 4) == 4 * 4 * 64 * 4096
    assert tplanner.window_input_bytes(spec, 4, per_device=True) == \
        4 * 4 * 64 * 512
    # bucketed ELL inputs: 3 arrays of nnz_slots entries per batch
    assert tplanner.window_input_bytes(spec, 4, nnz_slots=8 * 128 * 8) == \
        4 * 4 * 3 * 8 * 128 * 8
    # outputs: T * ((k + l_b) * k + m * l_b + D), l_b = min(16+8, 64) = 24
    assert tplanner.window_output_bytes(spec, 16, 8, 4) == \
        4 * 4 * ((16 + 24) * 16 + 64 * 24 + 8)
    # total = carry + inputs + outputs + ONE step's R5 working set
    assert tplanner.window_bytes(spec, 16, 8, exact=True, window=4) == (
        tplanner.window_carry_bytes(spec, 16)
        + tplanner.window_input_bytes(spec, 4)
        + tplanner.window_output_bytes(spec, 16, 8, 4)
        + tplanner.streaming_bytes(spec, 16, 8, exact=True))
    for kw in (dict(exact=True, window=4), dict(exact=False, window=8,
                                                batch_rank=6),
               dict(exact=True, window=2, nnz_slots=4096, per_device=True),
               dict(exact=False, window=16, nnz_slots=999)):
        assert tplanner.window_bytes(spec, 16, 8, **kw) == \
            jplanner.window_bytes(jspec, 16, 8, **kw)


WINDOW_CASES = [
    ("auto", dict(), 1, None),
    ("forced4", dict(window=4), 1, None),
    ("loop", dict(window=1), 1, None),
    ("halved", dict(memory_budget_bytes=1_500_000), 1, None),
    ("degrade", dict(memory_budget_bytes=1024), 1, None),
    ("ell", dict(), 1, 8 * 128 * 8),
    ("randomized", dict(rank=6), 1, None),
    ("sharded", dict(stream_backend="shard_map"), 8, None),
    ("sharded_auto_ell", dict(), 8, 8 * 64 * 4),
]


@pytest.mark.parametrize("label,extra,devices,slots", WINDOW_CASES,
                         ids=[c[0] for c in WINDOW_CASES])
def test_window_plan_equals_the_reference_to_the_byte(label, extra, devices,
                                                      slots):
    jp = jplanner.make_window_plan(
        jplanner.ASpec(**SPEC), japi.SolveConfig(**R6_CFG, **extra),
        device_count=devices, nnz_slots=slots)
    tp = tplanner.make_window_plan(
        tplanner.ASpec(**SPEC), tapi.SolveConfig(**R6_CFG, **extra),
        device_count=devices, nnz_slots=slots)
    assert _plan_dict(tp) == _plan_dict(jp)
    assert tp.reasons == jp.reasons


def test_r6_window_choice_and_explain():
    spec = tplanner.ASpec(**SPEC)
    p = tplanner.make_window_plan(spec, tapi.SolveConfig(**R6_CFG),
                                  device_count=1)
    assert p.window == tplanner.DEFAULT_WINDOW
    assert p.peak_bytes == tplanner.window_bytes(
        spec, 16, 8, exact=p.rank is None, window=p.window)
    assert "stream_window" in p.estimates
    assert any("R6" in r for r in p.reasons)
    forced = tplanner.make_window_plan(
        spec, tapi.SolveConfig(**R6_CFG, window=4), device_count=1)
    assert forced.window == 4
    loop = tplanner.make_window_plan(
        spec, tapi.SolveConfig(**R6_CFG, window=1), device_count=1)
    assert loop.window == 1
    assert any("per-batch loop" in r for r in loop.reasons)


def test_r6_halves_to_fit_and_degrades_honestly():
    spec = tplanner.ASpec(**SPEC)
    base = tplanner.make_stream_plan(spec, tapi.SolveConfig(**R6_CFG),
                                     device_count=1)
    # Budget admits a 4-window but not the 16 target: halved to fit.
    mid = tplanner.window_bytes(spec, 16, 8, exact=base.rank is None,
                                window=4)
    p = tplanner.make_window_plan(
        spec, tapi.SolveConfig(**R6_CFG, memory_budget_bytes=mid),
        device_count=1)
    assert 1 < p.window <= 4
    assert p.peak_bytes <= mid
    assert any("halved" in r for r in p.reasons)
    # Budget below even a 2-window: honest degrade to the loop.
    q = tplanner.make_window_plan(
        spec, tapi.SolveConfig(**R6_CFG, memory_budget_bytes=1024),
        device_count=1)
    assert q.window == 1
    assert any("degrading honestly to the per-batch loop" in r
               for r in q.reasons)


# ---------------------------------------------------------------------------
# Tail-adaptive merge width
# ---------------------------------------------------------------------------

def test_adaptive_oversample_tracks_the_tail():
    base = 8
    flat = np.ones(16, np.float32)             # tail = 1 -> widest
    assert sw.adaptive_oversample(flat, 16, base) == 2 * base
    decayed = np.geomspace(1.0, 1e-6, 16)      # tail ~ 0 -> narrowest
    assert sw.adaptive_oversample(decayed, 16, base) == max(4, base // 2)
    mid = np.geomspace(1.0, 0.5, 16)
    got = sw.adaptive_oversample(mid, 16, base)
    assert max(4, base // 2) <= got <= 2 * base and got % 4 == 0
    # no full-rank spectrum yet -> fall back to the static width
    assert sw.adaptive_oversample(np.ones(4), 16, base) == base
    assert sw.adaptive_oversample(np.zeros(16), 16, base) == base
    # the same value as the reference, for tensors and arrays alike
    rng = np.random.default_rng(0)
    for _ in range(20):
        s = np.sort(rng.random(16))[::-1].astype(np.float32)
        b = int(rng.integers(1, 20))
        want = jsw.adaptive_oversample(s, 16, b)
        assert sw.adaptive_oversample(s, 16, b) == want
        assert sw.adaptive_oversample(torch.from_numpy(s.copy()), 16,
                                      b) == want


def test_adaptive_width_stream_runs_and_rebuckets():
    sw.clear_caches()
    cfg = tapi.SolveConfig(truncate_rank=K, num_blocks=D,
                           adaptive_width=True, window=4)
    res = tapi.svd_stream(iter(_batches(10, seed=23)), cfg, device=CPU)
    assert res.state.batches_seen == 10
    assert res.s.shape == (K,)
    assert sw.dispatch_counts()["windows"] >= 1
    sw.clear_caches()


def test_adaptive_width_validation():
    for kw in (dict(adaptive_width=True),
               dict(truncate_rank=8, adaptive_width=True, rank=4),
               dict(truncate_rank=8, window=0)):
        with pytest.raises(ValueError) as t_err:
            tapi.SolveConfig(**kw)
        with pytest.raises(ValueError) as j_err:
            japi.SolveConfig(**kw)
        assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="window"):
        tapi.SolveConfig(window=4)                          # no stream


# ---------------------------------------------------------------------------
# svd_stream: generator-friendly, window by window
# ---------------------------------------------------------------------------

def test_svd_stream_consumes_a_generator_lazily():
    seen = []

    def gen():
        for i, b in enumerate(_batches(9, seed=31)):
            seen.append(i)
            yield b

    res = tapi.svd_stream(gen(), CFG, device=CPU)
    assert seen == list(range(9))
    assert res.state.batches_seen == 9
    assert res.plan.window is not None
    assert any("R6" in r for r in res.plan.reasons)
    with pytest.raises(ValueError, match="at least one batch"):
        tapi.svd_stream(iter([]), CFG, device=CPU)


def test_svd_stream_scan_equals_forced_loop_mixed_buckets():
    rng = np.random.default_rng(37)
    mixed = []
    for i in range(8):
        m = 8 if i % 2 == 0 else 20            # two buckets, interleaved
        mixed.append(rng.standard_normal((m, N)).astype(np.float32)
                     * (rng.random((m, N)) < 0.25))
    a = tapi.svd_stream(iter(mixed), CFG, device=CPU)
    b = tapi.svd_stream(iter(mixed), CFG, device=CPU, window=1)
    assert torch.equal(a.u, b.u) and torch.equal(a.s, b.s)
    assert a.state.rows_seen == b.state.rows_seen == 4 * 8 + 4 * 20
    assert a.plan.window > 1 and b.plan.window == 1


def test_svd_stream_resumes_an_existing_state():
    batches = _batches(8, seed=41)
    whole = tapi.svd_stream(iter(batches), CFG, device=CPU)
    head = tapi.svd_stream(iter(batches[:4]), CFG, device=CPU)
    tail = tapi.svd_stream(iter(batches[4:]), CFG, state=head.state)
    _assert_states_equal(whole.state, tail.state)
    # cumulative diagnostics count THIS call's batches only
    assert (head.diagnostics.lonely_rows + tail.diagnostics.lonely_rows
            == whole.diagnostics.lonely_rows)


def test_block_ell_records_exact_nnz():
    jcoo = jsparse.random_bipartite(16, N, 0.1, seed=43)
    ell = tsparse.block_ell_from_coo(_port_coo(jcoo), D, device=CPU)
    assert ell.nnz == jcoo.nnz
    slot_capacity = int(np.prod(ell.col_vals.shape))
    assert ell.nnz <= slot_capacity
    assert tapi._delta_nnz_estimate(ell) == jcoo.nnz
    assert tapi.describe(ell, D).nnz == jcoo.nnz
    dup = tsparse.COOMatrix(
        rows=np.array([0, 0, 1], np.int32),
        cols=np.array([2, 2, 3], np.int32),
        vals=np.array([1.0, 2.0, 3.0], np.float32), shape=(4, N))
    assert tsparse.block_ell_from_coo(dup, D, device=CPU).nnz == 2
    bare = tsparse.BlockEll(ell.col_ids, ell.col_rows, ell.col_vals,
                            m=ell.m, width=ell.width, n=ell.n)
    assert bare.nnz is None
    assert tapi._delta_nnz_estimate(bare) == slot_capacity


# ---------------------------------------------------------------------------
# Direct parity: svd_stream through both packages, the reference's
# per-batch draws injected
# ---------------------------------------------------------------------------

PKEY = jax.random.PRNGKey(29)


def _stream_draws(jdeltas, method, d, n, truncate_rank, rank, oversample):
    """The reference's draws of every batch of its ``svd_stream``, in the
    port's layout, as callables of the global batch index: a batch that
    grows the rank has its own shape, every later one rides in a window
    (its bucket's padded shape: m_pad rows, C_pad candidate columns)."""
    jst = jstream.init_state(n, num_blocks=d)
    w = jsparse.block_width(n, d)
    shapes = []
    state_rank = 0
    for x in jdeltas:
        norm = jstream.as_delta(x, jst)
        m_b = jstream.delta_shape(norm)[0]
        if state_rank != truncate_rank:
            cols = norm.capacity[0] if isinstance(norm, jsparse.BlockEll) \
                else w
            shapes.append((m_b, cols))
            r_b = rank if rank else min(m_b, truncate_rank + oversample)
            state_rank = min(truncate_rank, state_rank + r_b)
        else:
            sig = jsw.bucket_signature(norm)
            shapes.append((sig[1], sig[2] if sig[0] == "ell" else w))

    def draws(b):
        m, cols = shapes[b]
        return reference_draws(jax.random.fold_in(PKEY, b), method, d, m, w,
                               cols)

    def omegas(b):
        m = shapes[b][0]
        return reference_omega(jax.random.fold_in(PKEY, b),
                               min(rank + oversample, m), m)

    return draws, (omegas if rank else None)


@pytest.mark.parametrize("kind,method,rank", [
    ("dense", "neighbor_random", None),
    ("coo", "neighbor_random", None),
    ("ell", "random", None),
    ("coo", "random", 5),
])
def test_svd_stream_parity_with_injected_draws(kind, method, rank):
    """Ragged batches (10-16 rows: one 16-row bucket) of a weighted sparse
    matrix, some rows lonely in a block, through both ``svd_stream``s in
    windows of 4; the same plan, counts and factors."""
    n, d, k = 600, 4, 8
    rng = np.random.default_rng(5)
    sizes = [16] + [int(x) for x in rng.integers(10, 17, 7)]
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    coo = jsparse.ensure_full_row_rank(
        jsparse.random_bipartite(int(bounds[-1]), n, 0.03, seed=1,
                                 weighted=True), seed=1)
    jdeltas, tdeltas = [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        sel = (coo.rows >= lo) & (coo.rows < hi)
        part = jsparse.COOMatrix(rows=(coo.rows[sel] - lo).astype(np.int32),
                                 cols=coo.cols[sel], vals=coo.vals[sel],
                                 shape=(int(hi - lo), n))
        if kind == "dense":
            x = part.todense()
            jdeltas.append(x)
            tdeltas.append(x.copy())
        elif kind == "coo":
            jdeltas.append(part)
            tdeltas.append(_port_coo(part))
        else:
            jell = jsparse.block_ell_from_coo(part, d)
            jdeltas.append(jell)
            tdeltas.append(tsparse.block_ell_from_coo(_port_coo(part), d,
                                                      device=CPU))
    kw = dict(method=method, truncate_rank=k, num_blocks=d, oversample=4,
              want_right=True, window=4)
    if rank:
        kw["rank"] = rank
    draws, omegas = _stream_draws(jdeltas, method, d, n, k, rank, 4)
    sw.clear_caches()
    jsw.clear_caches()
    jres = japi.svd_stream(iter(jdeltas), japi.SolveConfig(key=PKEY, **kw))
    tres = tapi.svd_stream(iter(tdeltas), tapi.SolveConfig(**kw), device=CPU,
                           draws=draws, omegas=omegas)
    counts = sw.dispatch_counts()
    assert counts == jsw.dispatch_counts()
    assert counts["windows"] < counts["batches"] == 8 - (2 if rank else 1)
    if kind == "dense":                        # one bucket: 4 + 3
        assert counts["windows"] == 2
    assert (sw.bucket_count(), sw.trace_count()) == \
        (jsw.bucket_count(), jsw.trace_count())
    sw.clear_caches()
    jsw.clear_caches()
    assert _plan_dict(tres.plan) == _plan_dict(jres.plan)
    td, jd = tres.diagnostics, jres.diagnostics
    assert (td.lonely_rows_per_block, td.lonely_rows, td.repaired_rows) == \
        (jd.lonely_rows_per_block, jd.lonely_rows, jd.repaired_rows)
    assert td.lonely_rows > 0
    js = np.asarray(jres.s, np.float64)
    np.testing.assert_allclose(tres.s.numpy(), js, rtol=1e-4,
                               atol=1e-5 * js[0])
    assert (tres.state.rows_seen, tres.state.batches_seen) == \
        (jres.state.rows_seen, jres.state.batches_seen)
    gaps = js[:-1] / js[1:]
    j = int(np.argmax(gaps > 1.05)) + 1 if (gaps > 1.05).any() else 1
    assert projector_gap(tres.u.numpy()[:, :j], np.asarray(jres.u)[:, :j]) \
        < 1e-3
    assert projector_gap(tres.v.numpy()[:, :j], np.asarray(jres.v)[:, :j]) \
        < 1e-3
    # the forced per-batch loop of the port: the same bits as its windows
    loop = tapi.svd_stream(iter(tdeltas), tapi.SolveConfig(**{**kw,
                                                             "window": 1}),
                           device=CPU, draws=draws, omegas=omegas)
    assert torch.equal(loop.u, tres.u) and torch.equal(loop.s, tres.s)
    assert torch.equal(loop.v, tres.v)


# ---------------------------------------------------------------------------
# The sharded window (twin of the reference's 8-device scan test)
# ---------------------------------------------------------------------------

def test_shard_map_window_vs_loop_bit_identical():
    """On a local mesh of 8 slots: a sharded window equals the same
    batches as length-1 windows bit for bit (one batch repaired inside
    the window), equals the per-batch sharded ``svd_update``, sparse deltas
    through the sharded ELL window too, and ``svd_stream`` end to end."""
    from repro_torch.core.collectives import LocalMesh
    from repro_torch.stream import state as tstate

    n, d, k = 64, 8, 8
    cfg = tapi.SolveConfig(truncate_rank=k, num_blocks=d,
                           stream_backend="shard_map")
    rng = np.random.default_rng(0)
    batches = [rng.standard_normal((8, n)).astype(np.float32)
               * (rng.random((8, n)) < 0.3) for _ in range(6)]
    batches[3][2, :] = 0.0          # repair inside the sharded window
    tstate.set_stream_devices(LocalMesh(d, CPU))
    try:
        def mk():
            st = tapi.svd_init(n, cfg, device=CPU)
            st = tapi.svd_update(st, batches[0], cfg).state
            assert st.rank == k and st.mesh is not None
            return st

        spec = tplanner.ASpec(m=8, n=n, nnz=8 * n, num_blocks=d,
                              kind="stream")
        plan = tplanner.make_window_plan(spec, cfg, device_count=8)
        assert plan.backend == "shard_map"
        stream = batches[1:]
        a, ai = sw.ingest_window(mk(), stream, cfg, plan)
        b = mk()
        lon = rep = 0
        for x in stream:
            b, i = sw.ingest_window(b, [x], cfg, plan)
            lon += i.lonely_rows
            rep += i.repaired_rows
        _assert_states_equal(a, b)
        assert ai.lonely_rows == lon and ai.repaired_rows == rep
        assert ai.repaired_rows >= 1
        c = mk()
        for x in stream:
            c = tapi.svd_update(c, x, cfg).state
        _assert_states_equal(a, c)

        coos = [jsparse.random_bipartite(8, n, 0.15, seed=100 + i)
                for i in range(6)]
        st0 = mk()
        groups = {}
        for x in coos:
            groups.setdefault(sw.bucket_signature(as_delta(_port_coo(x), st0)),
                              []).append(_port_coo(x))
        _, grp = max(groups.items(), key=lambda kv: len(kv[1]))
        assert len(grp) >= 3
        e1, _ = sw.ingest_window(mk(), grp, cfg, plan)
        e2 = mk()
        for x in grp:
            e2, _ = sw.ingest_window(e2, [x], cfg, plan)
        _assert_states_equal(e1, e2)

        res = tapi.svd_stream(iter(batches), cfg, device=CPU)
        res1 = tapi.svd_stream(iter(batches), cfg, window=1, device=CPU)
        assert torch.equal(res.u, res1.u)
        assert res.plan.backend == "shard_map"
    finally:
        tstate.set_stream_devices(None)
