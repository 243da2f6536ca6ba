"""The slice as a whole: ``repro_torch.core.api`` against ``repro.core.api``.

The same COO / dense / BlockEll inputs go through both front doors (the
port with ``device="cpu"`` and the reference's own random draws injected):
S at rtol 1e-4, atol 1e-5 * S[0] (f32 gram + eigh on two LAPACK builds);
V in original column order, trimmed to N, by subspace; diagnostics equal.
Plans are pure arithmetic and equal the reference's to the byte, reasons as
strings, for R1, R2, every branch of R3, R4 and the PlanError text; every
``SolveConfig.__post_init__`` error carries the reference's message."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core as jcore
from repro.core import api as japi
from repro.core import planner as jplanner
from repro.core import sparse as jsparse

import repro_torch.core as tcore
from repro_torch.core import api as tapi
from repro_torch.core import collectives as tcollectives
from repro_torch.core import planner as tplanner
from repro_torch.core import sparse as tsparse

from test_torch_helpers import (paper_like_coo, port_ell, projector_gap,
                                reference_draws, reference_omega)

KEY = jax.random.PRNGKey(21)


# ---------------------------------------------------------------------------
# SolveConfig: same fields, same defaults, same errors
# ---------------------------------------------------------------------------

def test_solve_config_has_every_field_with_the_same_default():
    jf = {f.name: f.default for f in dataclasses.fields(japi.SolveConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tapi.SolveConfig)}
    # One default differs on purpose: the port's use_kernel=None is the
    # hand kernel on a CUDA tensor and the reference's False on the CPU.
    assert jf.pop("use_kernel") is False and tf.pop("use_kernel") is None
    assert tf == jf
    assert tapi.lsvd.resolve_use_kernel(None, "cpu") is False
    assert tapi.BACKENDS == japi.BACKENDS and tapi.MERGE_MODES == japi.MERGE_MODES
    assert tapi.LOCAL_MODES == japi.LOCAL_MODES
    assert tapi.STREAM_BACKENDS == japi.STREAM_BACKENDS
    jd = {f.name for f in dataclasses.fields(japi.Diagnostics)}
    assert {f.name for f in dataclasses.fields(tapi.Diagnostics)} == jd
    assert [f.name for f in dataclasses.fields(tapi.SVDResult)] == \
        [f.name for f in dataclasses.fields(japi.SVDResult)]


INVALID_CONFIGS = [
    # single-field domains (tests/test_api.py) ...
    dict(method="bogus"), dict(backend="bogus"), dict(local_mode="bogus"),
    dict(merge_mode="bogus"), dict(rank=0), dict(oversample=-1),
    dict(power_iters=-1), dict(num_blocks=0), dict(fanout=1),
    dict(memory_budget_bytes=0),
    # ... and the streaming knobs' domains
    dict(truncate_rank=0), dict(history_decay=0.0), dict(history_decay=1.5),
    dict(stream_backend="bogus"), dict(truncate_rank=4, window=0),
    dict(truncate_rank=4, checkpoint_every=0), dict(max_retries=-1),
    dict(retry_backoff_s=-0.5),
    # cross-field constraints (tests/test_api.py) ...
    dict(undetermined_tail=True),
    dict(undetermined_tail=True, merge_mode="gram"),
    dict(undetermined_tail=True, merge_mode="proxy", rank=4),
    dict(undetermined_tail=True, merge_mode="proxy", backend="shard_map"),
    dict(undetermined_tail=True, merge_mode="proxy", backend="hierarchical"),
    dict(sketch=True, backend="single"), dict(sketch=True, backend="shard_map"),
    dict(two_level=True), dict(two_level=True, backend="single"),
    dict(two_level=True, backend="hierarchical"),
    dict(local_mode="svd", backend="hierarchical"),
    dict(local_mode="svd", rank=3), dict(local_mode="svd", use_kernel=True),
    # ... and the streaming ones
    dict(truncate_rank=4, undetermined_tail=True, merge_mode="proxy"),
    dict(history_decay=0.5), dict(stream_backend="single"),
    dict(adaptive_width=True), dict(checkpoint_every=2),
    dict(adaptive_width=True, truncate_rank=4, rank=3),
]


@pytest.mark.parametrize("kwargs", INVALID_CONFIGS,
                         ids=[",".join(f"{k}={v}" for k, v in kw.items())
                              for kw in INVALID_CONFIGS])
def test_invalid_config_raises_the_references_message(kwargs):
    with pytest.raises(ValueError) as j_err:
        japi.SolveConfig(**kwargs)
    with pytest.raises(ValueError) as t_err:
        tapi.SolveConfig(**kwargs)
    assert str(t_err.value) == str(j_err.value)


def test_window_without_truncate_rank_names_both_fields():
    """The one message the port words differently (same fields, same rule)."""
    for mod in (japi, tapi):
        with pytest.raises(ValueError) as err:
            mod.SolveConfig(window=4)
        assert "window=4" in str(err.value)
        assert "truncate_rank=None" in str(err.value)


def test_valid_configs_construct_and_resolve_their_key():
    tapi.SolveConfig(backend="single", merge_mode="proxy", num_blocks=8)
    tapi.SolveConfig(backend="hierarchical", num_blocks=8)
    tapi.SolveConfig(backend="shard_map")
    tapi.SolveConfig(truncate_rank=8, history_decay=0.9, window=4,
                     stream_backend="single", checkpoint_every=2)
    assert tapi.SolveConfig().resolved_key() == tcore.DEFAULT_SEED == 0
    assert tapi.SolveConfig(key=9).resolved_key() == 9
    gen = torch.Generator().manual_seed(9)
    assert tapi.SolveConfig(key=gen).resolved_key() == 9


# ---------------------------------------------------------------------------
# Planner: equal to the byte
# ---------------------------------------------------------------------------

SPEC = dict(m=512, n=4096, nnz=10_000, num_blocks=8)
MID = dict(m=4096, n=4096, nnz=50_000, num_blocks=8)          # M > ceiling
WIDE = dict(m=4096, n=2_000_000, nnz=500_000, num_blocks=8)   # sketch > gram

PLAN_CASES = [
    # (label, spec, config kwargs, device_count)
    ("R1", SPEC, dict(undetermined_tail=True, merge_mode="proxy"), 8),
    ("R2", SPEC, dict(sketch=True, rank=6), 1),
    ("R3 small exact, truncated", SPEC, dict(rank=6), 1),
    ("R3 sketch: gram exceeds budget", SPEC,
     dict(rank=6, memory_budget_bytes=1 << 20), 1),
    ("R3 sketch: M above the ceiling", MID, dict(rank=16), 1),
    ("R3 sketch: tall rows", dict(m=32_768, n=4096, nnz=100_000, num_blocks=8),
     dict(rank=16), 1),
    ("R3 exact: sketch does not fit", WIDE,
     dict(rank=64, memory_budget_bytes=550_000_000), 1),
    ("R3 nothing fits, sketch cheaper", SPEC,
     dict(rank=6, memory_budget_bytes=1000), 1),
    ("R3 nothing fits, exact cheaper", WIDE,
     dict(rank=64, memory_budget_bytes=1000), 1),
    ("R3 on a matching mesh", SPEC, dict(rank=6, memory_budget_bytes=1 << 20), 8),
    ("R4 single", SPEC, dict(), 1),
    ("R4 proxy", SPEC, dict(merge_mode="proxy"), 1),
    ("R4 shard_map", SPEC, dict(), 8),
    ("R4 shard_map proxy", SPEC, dict(merge_mode="proxy"), 8),
    ("explicit single rank", SPEC, dict(backend="single", rank=6), 1),
    ("explicit hierarchical", SPEC, dict(backend="hierarchical", rank=6), 1),
    ("explicit shard_map rank", SPEC, dict(backend="shard_map", rank=6), 8),
]


def _plan_dict(p):
    d = dataclasses.asdict(p)
    d["estimated_peak_bytes"] = p.estimated_peak_bytes
    d["explain"] = p.explain()
    return d


@pytest.mark.parametrize("label,spec,cfg,devices", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_make_plan_equals_reference_to_the_byte(label, spec, cfg, devices):
    jp = jplanner.make_plan(jplanner.ASpec(**spec), japi.SolveConfig(**cfg),
                            device_count=devices)
    tp = tplanner.make_plan(tplanner.ASpec(**spec), tapi.SolveConfig(**cfg),
                            device_count=devices)
    assert _plan_dict(tp) == _plan_dict(jp)
    assert tp.reasons == jp.reasons and tp.peak_bytes == jp.peak_bytes
    assert tp.estimates == jp.estimates


def test_r3_cases_hit_the_branches_they_name():
    hits = {c[0]: tplanner.make_plan(tplanner.ASpec(**c[1]),
                                     tapi.SolveConfig(**c[2]),
                                     device_count=c[3]) for c in PLAN_CASES}
    assert hits["R3 small exact, truncated"].truncate_to == 6
    assert "exceeds the budget" in hits["R3 sketch: gram exceeds budget"].reasons[0]
    assert "exact-truncate ceiling" in hits["R3 sketch: M above the ceiling"].reasons[0]
    p = hits["R3 exact: sketch does not fit"]
    assert p.strategy == "exact_gram" and "sketch estimate" in p.reasons[0]
    assert "cheaper sketch" in hits["R3 nothing fits, sketch cheaper"].reasons[0]
    assert "cheaper exact" in hits["R3 nothing fits, exact cheaper"].reasons[0]
    assert hits["R3 on a matching mesh"].backend == "shard_map"
    assert hits["R1"].strategy == "exact_proxy" and hits["R2"].sketch_leaves


def test_plan_error_text_and_byte_helpers_equal():
    cfg = dict(memory_budget_bytes=1 << 20)
    with pytest.raises(jplanner.PlanError) as j_err:
        jplanner.make_plan(jplanner.ASpec(**SPEC), japi.SolveConfig(**cfg))
    with pytest.raises(tplanner.PlanError) as t_err:
        tplanner.make_plan(tplanner.ASpec(**SPEC), tapi.SolveConfig(**cfg))
    assert str(t_err.value) == str(j_err.value)
    assert issubclass(tplanner.PlanError, ValueError)
    js, ts = jplanner.ASpec(**WIDE), tplanner.ASpec(**WIDE)
    assert ts.width == js.width
    for name in ("exact_bytes", "solve_repair_bytes"):
        assert getattr(tplanner, name)(ts) == getattr(jplanner, name)(js)
    for mode in ("gram", "proxy"):
        assert tplanner.shard_map_bytes(ts, mode) == jplanner.shard_map_bytes(js, mode)
    assert tplanner.sketch_bytes(ts, 16, 8) == jplanner.sketch_bytes(js, 16, 8)
    for r in (None, 6, 10_000):
        assert tplanner.hierarchical_bytes(ts, r) == jplanner.hierarchical_bytes(js, r)
    for name in ("BYTES_F32", "DEFAULT_MEMORY_BUDGET", "DEFAULT_NUM_BLOCKS",
                 "EXACT_TRUNC_MAX_M"):
        assert getattr(tplanner, name) == getattr(jplanner, name)
    with pytest.raises(ValueError) as t_err:
        tplanner.ASpec(m=0, n=4, nnz=0, num_blocks=1)
    with pytest.raises(ValueError) as j_err:
        jplanner.ASpec(m=0, n=4, nnz=0, num_blocks=1)
    assert str(t_err.value) == str(j_err.value)


# ---------------------------------------------------------------------------
# Input adapter and plan()
# ---------------------------------------------------------------------------

def _three_inputs(m=24, n=1000, density=0.01, d=8, seed=0, weighted=True):
    """(reference, port) inputs in the three accepted representations; N is
    not a multiple of D, so the adapter pads."""
    jcoo, tcoo = paper_like_coo(m, n, density, seed=seed, weighted=weighted)
    jell = jsparse.block_ell_from_coo(jcoo, d)
    dense = jcoo.todense()
    return {"coo": (jcoo, tcoo), "dense": (dense, dense.copy()),
            "ell": (jell, port_ell(jell))}


def test_describe_and_plan_on_every_representation():
    for kind, (ja, ta) in _three_inputs().items():
        js, ts = japi.describe(ja, 8), tapi.describe(ta, 8)
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
        assert ts.kind == kind
        for cfg in (dict(rank=6, num_blocks=8), dict(num_blocks=8),
                    dict(rank=6, num_blocks=8, memory_budget_bytes=10_000)):
            jp = japi.plan(ja, japi.SolveConfig(**cfg))
            tp = tapi.plan(ta, tapi.SolveConfig(**cfg), device="cpu")
            assert _plan_dict(tp) == _plan_dict(jp)
    jcoo, tcoo = _three_inputs()["coo"]
    # num_blocks defaulted: the note is part of the reasons on both sides
    assert _plan_dict(tapi.plan(tcoo, device="cpu")) == _plan_dict(japi.plan(jcoo))
    spec = tplanner.ASpec(**SPEC)
    tp = tapi.plan(spec, rank=6, num_blocks=4, device="cpu")
    jp = japi.plan(jplanner.ASpec(**SPEC), rank=6, num_blocks=4)
    assert tp.num_blocks == 4 and _plan_dict(tp) == _plan_dict(jp)
    assert tapi.describe(torch.ones(3, 5), 2).nnz == 15
    with pytest.raises(ValueError, match="2-D"):
        tapi.describe(np.ones(4), 2)


def test_as_block_input_normalizes_each_kind():
    (jcoo, tcoo), (_, dense), (_, tell) = _three_inputs().values()
    out = tapi.as_block_input(tcoo, 8, device="cpu")
    assert isinstance(out, tsparse.BlockEll) and out.num_blocks == 8
    out_d = tapi.as_block_input(tcoo, 8, needs_dense=True, device="cpu")
    assert isinstance(out_d, torch.Tensor) and out_d.shape == (24, 1000)
    padded = tapi.as_block_input(np.ones((4, 10), np.float32), 8, device="cpu")
    assert padded.shape == (4, 16) and float(padded[:, 10:].abs().sum()) == 0
    assert padded.dtype == torch.float32
    np.testing.assert_array_equal(
        padded.numpy(), np.asarray(japi.as_block_input(np.ones((4, 10), np.float32), 8)))
    same = tapi.as_block_input(tell, 8, device="cpu")
    assert torch.equal(same.col_vals, tell.col_vals)
    with pytest.raises(ValueError, match="num_blocks"):
        tapi.as_block_input(tell, 4, device="cpu")
    with pytest.raises(ValueError, match="gram-native"):
        tapi.as_block_input(tell, 8, needs_dense=True, device="cpu")


# ---------------------------------------------------------------------------
# svd(): the slice end to end
# ---------------------------------------------------------------------------

def _check_result(tres, jres, n, *, top=5, exact=True):
    s_ref = np.asarray(jres.s, np.float64)
    np.testing.assert_allclose(tres.s.numpy(), s_ref, rtol=1e-4,
                               atol=1e-5 * s_ref[0])
    assert tres.u.shape == tuple(jres.u.shape)
    assert projector_gap(tres.u[:, :top], np.asarray(jres.u)[:, :top]) < 2e-3
    if jres.v is None:
        assert tres.v is None
    else:
        # rows in ORIGINAL column order, trimmed back to N
        assert tres.v.shape == tuple(jres.v.shape) and tres.v.shape[0] == n
        assert projector_gap(tres.v[:, :top], np.asarray(jres.v)[:, :top]) < 2e-3
    td, jd = tres.diagnostics, jres.diagnostics
    assert td.lonely_rows_per_block == jd.lonely_rows_per_block
    assert td.lonely_rows == jd.lonely_rows
    assert td.repaired_rows == jd.repaired_rows
    assert td.strategy == jd.strategy
    assert td.estimated_peak_bytes == jd.estimated_peak_bytes
    assert td.drift_ratios is None and td.span_summary is None
    assert td.wall_time_s > 0 and td.compile_time_s == 0.0
    assert abs(td.wall_time_s - td.compile_time_s - td.run_time_s) < 1e-9
    assert _plan_dict(tres.plan) == _plan_dict(jres.plan)
    assert len(tuple(tres)) == len(tuple(jres))


@pytest.mark.parametrize("kind", ["coo", "dense", "ell"])
@pytest.mark.parametrize("merge_mode", ["gram", "proxy"])
def test_svd_method_none_matches_reference(kind, merge_mode):
    ja, ta = _three_inputs()[kind]
    cfg = dict(method="none", merge_mode=merge_mode, num_blocks=8,
               want_right=True)
    jres = japi.svd(ja, japi.SolveConfig(**cfg))
    tres = tapi.svd(ta, tapi.SolveConfig(**cfg), device="cpu")
    _check_result(tres, jres, 1000)


@pytest.mark.parametrize("kind", ["coo", "dense", "ell"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_svd_random_repair_with_injected_draws(kind, use_kernel):
    ja, ta = _three_inputs()[kind]
    cfg = dict(method="random", num_blocks=8, want_right=True,
               use_kernel=use_kernel)
    draws = reference_draws(KEY, "random", 8, 24, 125, 125)
    jres = japi.svd(ja, japi.SolveConfig(key=KEY, **cfg))
    tres = tapi.svd(ta, tapi.SolveConfig(**cfg), device="cpu", draws=draws)
    _check_result(tres, jres, 1000)
    assert tres.diagnostics.repaired_rows == tres.diagnostics.lonely_rows > 0


def test_svd_neighbor_counts_partial_repairs_like_the_reference():
    jcoo, tcoo = paper_like_coo(24, 1000, 0.004, seed=3)
    jell = jsparse.block_ell_from_coo(jcoo, 8)
    cfg = dict(method="neighbor", num_blocks=8)
    draws = reference_draws(KEY, "neighbor", 8, 24, jell.width,
                            jell.capacity[0])
    jres = japi.svd(jcoo, japi.SolveConfig(key=KEY, **cfg))
    tres = tapi.svd(tcoo, tapi.SolveConfig(**cfg), device="cpu", draws=draws)
    _check_result(tres, jres, 1000)
    assert 0 < tres.diagnostics.repaired_rows <= tres.diagnostics.lonely_rows


@pytest.mark.parametrize("kind", ["coo", "dense"])
def test_svd_randomized_with_injected_omega(kind):
    ja, ta = _three_inputs()[kind]
    cfg = dict(backend="single", method="random", rank=6, oversample=18,
               power_iters=4, num_blocks=8, want_right=True)
    draws = reference_draws(KEY, "random", 8, 24, 125, 125)
    jres = japi.svd(ja, japi.SolveConfig(key=KEY, **cfg))
    tres = tapi.svd(ta, tapi.SolveConfig(**cfg), device="cpu", draws=draws,
                    omega=reference_omega(KEY, 24, 24))
    assert tres.plan.strategy == "randomized" and tres.u.shape == (24, 6)
    _check_result(tres, jres, 1000, top=6)


def test_svd_auto_rank_truncates_an_exact_solve_and_overrides_apply():
    jcoo, tcoo = _three_inputs()["coo"]
    jres = japi.svd(jcoo, method="none", rank=5, num_blocks=8, want_right=True)
    tres = tapi.svd(tcoo, method="none", rank=5, num_blocks=8, want_right=True,
                    device="cpu")
    assert tres.plan.truncate_to == 5 and tres.plan.rank is None
    assert tres.u.shape == (24, 5) and tres.v.shape == (1000, 5)
    _check_result(tres, jres, 1000)
    u, s, v = tres
    assert u is tres.u and s is tres.s and v is tres.v
    # local_mode='svd' on COO takes the dense path under the proxy merge
    tres2 = tapi.svd(tcoo, method="none", local_mode="svd", merge_mode="proxy",
                     num_blocks=8, device="cpu")
    jres2 = japi.svd(jcoo, method="none", local_mode="svd", merge_mode="proxy",
                     num_blocks=8)
    _check_result(tres2, jres2, 1000)


def test_svd_own_draws_are_reproducible_and_keyed():
    _, tcoo = _three_inputs()["coo"]
    cfg = tapi.SolveConfig(method="neighbor_random", num_blocks=8, key=4)
    a = tapi.svd(tcoo, cfg, device="cpu")
    b = tapi.svd(tcoo, cfg, device="cpu")
    c = tapi.svd(tcoo, dataclasses.replace(cfg, key=5), device="cpu")
    assert torch.equal(a.s, b.s) and not torch.equal(a.s, c.s)
    assert torch.equal(tapi.svd(tcoo, method="random", num_blocks=8,
                                device="cpu").s,
                       tapi.svd(tcoo, method="random", num_blocks=8, key=0,
                                device="cpu").s)


@pytest.mark.parametrize("backend", ["shard_map"])
def test_shard_map_backend_runs_on_a_local_mesh(backend):
    """The shard_map plan runs (one card or the CPU standing for the 8
    slots) and agrees with the single-host engine for the same key; the
    plan is explainable and names the mesh's block axes."""
    _, tcoo = _three_inputs()["coo"]
    mesh = tcollectives.LocalMesh({"model": 8}, "cpu")
    res = tapi.svd(tcoo, backend=backend, mesh=mesh)
    single = tapi.svd(tcoo, backend="single", num_blocks=8, device="cpu")
    assert res.plan.backend == backend
    assert any("mesh block axes" in r for r in res.plan.reasons)
    np.testing.assert_allclose(res.s.numpy(), single.s.numpy(), rtol=0,
                               atol=1e-5 * float(single.s[0]))
    assert tapi.plan(tcoo, backend=backend, mesh=mesh).backend == backend
    # Without a mesh the stream pool's is used: one slot here, so a plan
    # for 8 blocks on it is refused, not run single-host.
    with pytest.raises(ValueError, match="one device per block"):
        tapi.svd(tcoo, backend=backend, num_blocks=8, device="cpu")


def test_parity_shard_map_backend_8_slots():
    """Twin of the reference's 8-device parity: api.svd on the mesh is
    bit-identical to the legacy shim (dense, ELL, and COO into the ELL
    path), trims V back to N, and auto with a small rank on a mesh runs
    the EXACT shard_map engine and slices the top k."""
    from repro_torch.core import distributed as tdist

    jcoo, tcoo = paper_like_coo(m=16, n=2048, density=0.004, seed=3)
    a = tsparse.pad_to_block_multiple(tcoo.todense(), 8)
    ell = tsparse.block_ell_from_coo(tcoo, 8, device="cpu")
    mesh = tcollectives.LocalMesh({"model": 8}, "cpu")
    kw = dict(method="neighbor_random", merge_mode="gram", want_right=True,
              key=11)
    cfg = tapi.SolveConfig(backend="shard_map", **kw)
    for legacy_in, api_in in ((torch.from_numpy(a), a), (ell, ell),
                              (ell, tcoo)):
        with pytest.warns(DeprecationWarning):
            u0, s0, v0 = tdist.distributed_ranky_svd(
                legacy_in, mesh, block_axes=("model",), **kw)
        res = tapi.svd(api_in, cfg, mesh=mesh, block_axes=("model",))
        assert torch.equal(res.u, u0) and torch.equal(res.s, s0)
        assert torch.equal(res.v, v0[:tcoo.shape[1]])
        assert res.plan.backend == "shard_map"
    res = tapi.svd(ell, tapi.SolveConfig(method="none", merge_mode="gram",
                                         rank=6, key=11), mesh=mesh)
    assert res.plan.backend == "shard_map"
    assert res.plan.truncate_to == 6 and res.plan.rank is None
    with pytest.warns(DeprecationWarning):
        u0, s0 = tdist.distributed_ranky_svd(ell, mesh, method="none",
                                             merge_mode="gram", key=11)
    assert torch.equal(res.s, s0[:6])


def test_parity_shard_map_backend_on_part_of_a_mesh():
    """The same twin on a (data 2, model 4) local mesh with
    block_axes=("model",): four column blocks, each held by two slots.
    api.svd is bit-identical to the legacy shim and to a mesh of the four
    blocks alone, and V is trimmed back to N."""
    from repro_torch.core import distributed as tdist

    _, tcoo = paper_like_coo(m=16, n=2048, density=0.004, seed=3)
    a = tsparse.pad_to_block_multiple(tcoo.todense(), 4)
    ell = tsparse.block_ell_from_coo(tcoo, 4, device="cpu")
    mesh = tcollectives.LocalMesh({"data": 2, "model": 4}, "cpu")
    alone = tcollectives.LocalMesh({"model": 4}, "cpu")
    kw = dict(method="neighbor_random", merge_mode="gram", want_right=True,
              key=11)
    cfg = tapi.SolveConfig(backend="shard_map", **kw)
    for legacy_in, api_in in ((torch.from_numpy(a), a), (ell, ell),
                              (ell, tcoo)):
        with pytest.warns(DeprecationWarning):
            u0, s0, v0 = tdist.distributed_ranky_svd(
                legacy_in, mesh, block_axes=("model",), **kw)
        res = tapi.svd(api_in, cfg, mesh=mesh, block_axes=("model",))
        assert torch.equal(res.u, u0) and torch.equal(res.s, s0)
        assert torch.equal(res.v, v0[:tcoo.shape[1]])
        assert res.plan.backend == "shard_map"
        four = tapi.svd(api_in, cfg, mesh=alone)
        assert torch.equal(res.s, four.s) and torch.equal(res.v, four.v)
    # The shim's default block axes, ("model",), on a (pod, model) mesh.
    with pytest.warns(DeprecationWarning):
        u1, s1 = tdist.distributed_ranky_svd(
            ell, tcollectives.LocalMesh({"pod": 2, "model": 4}, "cpu"),
            key=11)
    assert torch.equal(s1, tapi.svd(ell, backend="shard_map", mesh=alone,
                                    key=11).s)


# ---------------------------------------------------------------------------
# use_kernel=None: the hand kernel on a CUDA operand, today's plain path on
# the CPU
# ---------------------------------------------------------------------------

class _OnCuda:
    """An operand's stand-in that only claims to lie on a CUDA device."""
    device = torch.device("cuda")


def test_use_kernel_none_resolves_by_device_and_local_mode():
    resolve = tapi.lsvd.resolve_use_kernel
    assert resolve(None, "cpu") is False
    assert resolve(None, torch.device("cuda", 0)) is True
    # local_mode="svd" forms no gram: None is False on any device, and an
    # explicit value is kept as given on any device.
    assert resolve(None, "cuda", local_mode="svd") is False
    assert resolve(False, "cuda") is False and resolve(True, "cpu") is True
    cfg = tapi.SolveConfig()
    assert tapi._use_kernel(cfg, _OnCuda()) is True
    assert tapi._use_kernel(tapi.SolveConfig(use_kernel=False),
                            _OnCuda()) is False
    assert tapi._use_kernel(tapi.SolveConfig(local_mode="svd",
                                             merge_mode="proxy"),
                            _OnCuda()) is False


@pytest.mark.parametrize("kind", ["coo", "dense"])
def test_use_kernel_none_equals_false_on_the_cpu(kind):
    """The default config runs the reference's plain products on the CPU,
    bit for bit: one-shot (single, hierarchical, shard_map) and streaming
    (per batch and in windows)."""
    _, ta = _three_inputs()[kind]
    mesh = tcollectives.LocalMesh({"model": 8}, "cpu")
    for kw in (dict(backend="single", num_blocks=8),
               dict(backend="hierarchical", num_blocks=8, want_right=True),
               dict(backend="shard_map", mesh=mesh, merge_mode="proxy")):
        mesh_kw = {"mesh": kw.pop("mesh")} if "mesh" in kw else \
            {"device": "cpu"}
        a = tapi.svd(ta, tapi.SolveConfig(key=3, **kw), **mesh_kw)
        b = tapi.svd(ta, tapi.SolveConfig(key=3, use_kernel=False, **kw),
                     **mesh_kw)
        assert torch.equal(a.u, b.u) and torch.equal(a.s, b.s)
        if a.v is not None:
            assert torch.equal(a.v, b.v)
    rng = np.random.default_rng(4)
    batches = [(rng.random((12, 300)) < 0.05).astype(np.float32)
               for _ in range(5)]
    cfg = tapi.SolveConfig(truncate_rank=6, num_blocks=4, key=2)
    a = tapi.svd_stream(batches, cfg, device="cpu").state
    b = tapi.svd_stream(batches, dataclasses.replace(cfg, use_kernel=False),
                        device="cpu").state
    assert torch.equal(a.u, b.u) and torch.equal(a.s, b.s)
    assert torch.equal(a.v, b.v)


def test_use_kernel_none_changes_no_plan():
    """The planner reads use_kernel only in R7 (ServeTopKConfig), so the
    R1-R6 plans of None, False and True are equal to the byte, and equal
    to the reference's with its default."""
    spec = tplanner.ASpec(**SPEC)
    batch = tplanner.ASpec(m=64, n=4096, nnz=2000, num_blocks=8,
                           kind="stream")
    for kw, devices in ((dict(), 1), (dict(rank=6), 1), (dict(), 8),
                        (dict(merge_mode="proxy"), 8)):
        plans = [_plan_dict(tplanner.make_plan(
            spec, tapi.SolveConfig(use_kernel=uk, **kw),
            device_count=devices)) for uk in (None, False, True)]
        assert plans[0] == plans[1] == plans[2]
        jp = jplanner.make_plan(jplanner.ASpec(**SPEC),
                                japi.SolveConfig(**kw), device_count=devices)
        assert plans[0]["reasons"] == jp.reasons
    for devices in (1, 8):
        cfgs = [tapi.SolveConfig(truncate_rank=16, use_kernel=uk)
                for uk in (None, False, True)]
        stream = [_plan_dict(tplanner.make_stream_plan(
            batch, c, device_count=devices)) for c in cfgs]
        window = [_plan_dict(tplanner.make_window_plan(
            batch, c, device_count=devices)) for c in cfgs]
        assert stream[0] == stream[1] == stream[2]
        assert window[0] == window[1] == window[2]
    # R7 reads ServeTopKConfig.use_kernel, whose default stays True.
    assert tapi.ServeTopKConfig().use_kernel is True


def test_plan_peak_bytes_is_per_device_for_shard_map():
    """Rule R4 on 8 slots prices the per-device psum buffer, as the
    reference's planner does, byte for byte."""
    spec = tplanner.ASpec(m=16_384, n=65_536, nnz=100_000, num_blocks=8)
    jspec = jplanner.ASpec(m=16_384, n=65_536, nnz=100_000, num_blocks=8)
    p = tplanner.make_plan(spec, tapi.SolveConfig(), device_count=8)
    jp = jplanner.make_plan(jspec, japi.SolveConfig(), device_count=8)
    assert p.backend == jp.backend == "shard_map"
    assert p.estimated_peak_bytes == jp.estimated_peak_bytes \
        == 4 * 16_384 * 16_384
    assert p.estimated_peak_bytes <= p.budget
    assert p.reasons == jp.reasons


def test_front_door_errors_carry_the_references_messages():
    (jcoo, tcoo), _, (jell, tell) = _three_inputs().values()
    cases = [
        (dict(truncate_rank=4), jcoo, tcoo),                  # streaming knob
        (dict(rank=99, num_blocks=8), jcoo, tcoo),            # rank > M
        (dict(local_mode="svd", merge_mode="proxy"), jell, tell),
        (dict(num_blocks=4), jell, tell),                     # D mismatch
    ]
    for kw, ja, ta in cases:
        with pytest.raises(ValueError) as j_err:
            japi.svd(ja, **kw)
        with pytest.raises(ValueError) as t_err:
            tapi.svd(ta, device="cpu", **kw)
        assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError) as j_err:
        japi.plan(jcoo, truncate_rank=4)
    with pytest.raises(ValueError) as t_err:
        tapi.plan(tcoo, truncate_rank=4, device="cpu")
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(TypeError, match="SolveConfig"):
        tapi.svd(tcoo, {"rank": 3}, device="cpu")


def test_default_device_is_the_gpu_and_its_absence_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    _, tcoo = _three_inputs()["coo"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.svd(tcoo, num_blocks=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.svd(tcoo, num_blocks=8, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.plan(tcoo, num_blocks=8)


def test_core_all_exports_resolve():
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None, name
    # everything the port's core exports has a counterpart of the same name
    # in the reference, except the port-only names
    port_only = {"convert", "RepairDraws", "DEFAULT_SEED"}
    assert set(tcore.__all__) - port_only <= set(jcore.__all__)
