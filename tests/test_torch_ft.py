"""Fault tolerance (``repro_torch.ft``) against ``repro.ft``: the twins of
``tests/test_ft.py``.

* The straggler monitor, the fault injector, ``plan_stream_mesh``,
  ``plan_mesh`` and planner rule R8 are pure bookkeeping and arithmetic:
  the same inputs go through the reference's functions and the port's,
  and every verdict, raise, plan shape, byte count and reason string is
  equal.
* The supervisor is held to its contract (the reference's supervisor
  tests install an injector, which fails at baseline under the installed
  JAX): a transient drop gives one ``collective_retry`` and a result
  ``torch.equal`` to an uninterrupted chunked ``svd_stream`` of the port;
  retry exhaustion escalates; the events artifact has the reference's
  schema; the monitor resets after a recovery; a non-stream config is
  refused; ``close()`` resets the stream pool.  One case holds the
  supervised stream's S against the reference's plain chunked
  ``svd_stream`` on the same batches, the reference's per-batch draws
  injected.
"""
import json
import sys
import tempfile

import numpy as np
import jax
import pytest
import torch

from repro import ft as jft
from repro.core import api as japi
from repro.core import planner as jplanner
from repro.ft import straggler as jstraggler
from repro.stream import state as jstate
from repro.stream import window as jsw

from repro_torch import ft as tft
from repro_torch.core import api as tapi
from repro_torch.core import collectives as tcol
from repro_torch.core import planner as tplanner
from repro_torch.core.planner import PlanError
from repro_torch.ft import straggler as tstraggler
from repro_torch.stream import state as tstate

from test_torch_helpers import assert_same_factors, reference_draws

CPU = "cpu"


# ---------------------------------------------------------------------------
# StragglerMonitor: the reference's verdicts, step by step
# ---------------------------------------------------------------------------

def _both_monitors(hosts, **cfg):
    return (jstraggler.StragglerMonitor(jstraggler.StragglerConfig(**cfg),
                                        num_hosts=hosts),
            tstraggler.StragglerMonitor(tstraggler.StragglerConfig(**cfg),
                                        num_hosts=hosts))


SLOW4 = {0: 1.0, 1: 1.0, 2: 1.0, 3: 10.0}
MONITOR_CASES = {
    # one host: the median IS that host, never flagged however slow
    "single host never flagged": (1, dict(threshold=1.5),
                                  [{0: 1.0}, {0: 50.0}, {0: 1e6}]),
    "identical times flag nothing": (
        8, dict(threshold=1.5, patience=1, policy="evict"),
        [{h: 3.0 for h in range(8)}] * 20),
    "evict at exactly patience": (
        4, dict(alpha=1.0, threshold=1.5, patience=3, policy="evict"),
        [SLOW4] * 3),
    "flag streak resets when a host recovers": (
        4, dict(alpha=1.0, threshold=1.5, patience=3, policy="evict"),
        [SLOW4, SLOW4, {h: 1.0 for h in range(4)}, SLOW4, SLOW4, SLOW4]),
    "even host count: the true median": (
        2, dict(alpha=0.5, threshold=1.5, patience=2, policy="evict"),
        [{0: 1.0, 1: 4.0}] * 4),
    "ewma over ragged reports": (
        3, dict(alpha=0.1, threshold=1.2, patience=2, policy="flag"),
        [{0: 1.0}, {1: 2.0, 2: 1.0}, {0: 3.0, 1: 1.0, 2: 1.0},
         {2: 9.0}, {0: 1.0, 1: 1.0, 2: 8.0}]),
}


@pytest.mark.parametrize("case", list(MONITOR_CASES))
def test_monitor_matches_the_reference_step_by_step(case):
    hosts, cfg, steps = MONITOR_CASES[case]
    jm, tm = _both_monitors(hosts, **cfg)
    verdicts = []
    for step in steps:
        tv = tm.observe(step)
        assert tv == jm.observe(step)
        assert tm.ewma == jm.ewma and tm.flag_streak == jm.flag_streak
        verdicts.append(tv)
    if case == "single host never flagged":
        assert all(v == {"flagged": [], "evict": []} for v in verdicts)
    if case == "identical times flag nothing":
        assert tm.flag_streak == [0] * 8
    if case == "evict at exactly patience":
        assert [v["evict"] for v in verdicts] == [[], [], [3]]
    if case == "flag streak resets when a host recovers":
        assert [v["evict"] for v in verdicts] == [[], [], [], [], [], [3]]
    with pytest.raises(ValueError, match="outside"):
        tm.observe({hosts: 1.0})


def test_observe_window_adapter_matches_the_reference():
    jm, tm = _both_monitors(3, alpha=1.0, threshold=1.5)
    assert tm.observe_window(2.0, [1.0, 1.0, 4.0]) == \
        jm.observe_window(2.0, [1.0, 1.0, 4.0]) == {"flagged": [2],
                                                     "evict": []}
    assert tm.ewma == jm.ewma == [2.0, 2.0, 8.0]
    with pytest.raises(ValueError, match="3 hosts"):
        tm.observe_window(1.0, [1.0, 1.0])


@pytest.mark.parametrize("drift", [1.4, None, 0.5])
def test_observe_window_drift_scales_uniformly(drift):
    # Drift scales every slot the same way; < 1 never shrinks the times.
    jm, tm = _both_monitors(2, alpha=1.0)
    factors = [1.0, 4.0] if drift != 0.5 else [1.0, 1.0]
    tv = tm.observe_window(2.0, factors, drift=drift)
    assert tv == jm.observe_window(2.0, factors, drift=drift)
    assert tm.ewma == jm.ewma
    scale = max(1.0, drift) if drift is not None else 1.0
    assert tm.ewma == [2.0 * f * scale for f in factors]


# ---------------------------------------------------------------------------
# FaultInjector: the reference's raises and bookkeeping
# ---------------------------------------------------------------------------

def _faults(mod, spec):
    make = {"fail": mod.FailDeviceAt, "delay": mod.DelayDevice,
            "drop": mod.DropCollective}
    return [make[kind](*args, **kw) for kind, args, kw in spec]


def _replay(inj, script):
    """Run a (begin, fire) script; returns what each step did."""
    out = []
    for step in script:
        if step[0] == "begin":
            inj.begin_batches(*step[1:])
            continue
        try:
            inj.fire(step[1])
            out.append(None)
        except RuntimeError as e:
            out.append((type(e).__name__, str(e),
                        getattr(e, "device", None), getattr(e, "batch", None)))
    return out


INJECTOR_CASES = {
    "fires once in the covered range": (
        [("fail", (), dict(device=2, at_batch=5))],
        [("begin", 0, 4), ("fire", "ingest.batch"), ("begin", 4, 8),
         ("fire", "ingest.batch"), ("fire", "ingest.batch")]),
    "entry fault ignores the merge": (
        [("fail", (0, 1), dict(phase="entry"))],
        [("begin", 0, 4), ("fire", "ingest.merge"),
         ("fire", "ingest.window"), ("fire", "ingest.window")]),
    "merge fault ignores the entry": (
        [("fail", (0, 1), dict(phase="merge"))],
        [("begin", 0, 4), ("fire", "ingest.batch"),
         ("fire", "ingest.merge")]),
    "drop only at the merge, once": (
        [("drop", (), dict(at_batch=0))],
        [("begin", 0, 2), ("fire", "ingest.batch"), ("fire", "ingest.merge"),
         ("fire", "ingest.merge")]),
    "a script of every shape": (
        [("drop", (3,), {}), ("fail", (3, 5), dict(phase="merge")),
         ("delay", (1, 4.0), {}), ("fail", (1, 3), {})],
        [("begin", 2, 4), ("fire", "ingest.batch"), ("fire", "ingest.merge"),
         ("fire", "ingest.merge"), ("begin", 4, 6), ("fire", "ingest.batch"),
         ("fire", "ingest.merge"), ("fire", "ingest.merge")]),
}


@pytest.mark.parametrize("case", list(INJECTOR_CASES))
def test_injector_matches_the_reference(case):
    spec, script = INJECTOR_CASES[case]
    jinj = jft.FaultInjector(_faults(jft, spec))
    tinj = tft.FaultInjector(_faults(tft, spec))
    assert _replay(tinj, script) == _replay(jinj, script)
    assert [type(f).__name__ for f in tinj.fired] == \
        [type(f).__name__ for f in jinj.fired]
    assert [vars(f) for f in tinj.fired] == [vars(f) for f in jinj.fired]


def test_delay_factor_is_windowed_product():
    spec = [("delay", (), dict(device=1, factor=2.0, from_batch=2,
                               until_batch=6)),
            ("delay", (), dict(device=1, factor=3.0, from_batch=4))]
    jinj = jft.FaultInjector(_faults(jft, spec))
    tinj = tft.FaultInjector(_faults(tft, spec))
    for dev in (0, 1):
        for b in range(8):
            assert tinj.delay_factor(dev, b) == jinj.delay_factor(dev, b)
    assert [tinj.delay_factor(1, b) for b in (1, 2, 4, 6)] == \
        [1.0, 2.0, 6.0, 3.0]
    for bad, err, match in (([tft.DelayDevice(device=0, factor=1.0)],
                             ValueError, "factor"),
                            (["kill -9"], TypeError, "unknown fault"),
                            ([tft.FailDeviceAt(0, 1, phase="shuffle")],
                             ValueError, "phase")):
        with pytest.raises(err, match=match):
            tft.FaultInjector(bad)


def test_injector_installed_is_scoped():
    from repro_torch.ft.inject import stream_ingest
    assert stream_ingest.__name__ == "repro_torch.stream.ingest"
    inj = tft.FaultInjector([])
    assert stream_ingest._fault_seam is None
    with inj.installed():
        assert stream_ingest._fault_seam == inj.fire
    assert stream_ingest._fault_seam is None


# ---------------------------------------------------------------------------
# plan_stream_mesh / plan_mesh: the reference's shapes and axis names
# ---------------------------------------------------------------------------

def test_plan_stream_mesh_matches_the_reference():
    assert tstate.STREAM_AXIS == jstate.STREAM_AXIS == "blocks"
    for devices in range(1, 10):
        for blocks in range(1, 10):
            tp = tft.plan_stream_mesh(devices, blocks)
            jp = jft.plan_stream_mesh(devices, blocks)
            assert (tp.shape, tp.axis_names, tp.dropped_devices,
                    tp.num_devices) == (jp.shape, jp.axis_names,
                                        jp.dropped_devices, jp.num_devices)
    p = tft.plan_stream_mesh(8, 4)
    assert p.shape == (4,) and p.dropped_devices == 4
    assert tft.plan_stream_mesh(3, 4).shape == (1,)
    for bad in ((0, 4), (4, 0)):
        with pytest.raises(ValueError):
            tft.plan_stream_mesh(*bad)


@pytest.mark.parametrize("model_parallel,threshold", [(16, 512), (4, 10**9),
                                                      (4, 8), (1, 512)])
def test_plan_mesh_matches_the_reference(model_parallel, threshold):
    for devices in (1, 3, 7, 8, 12, 16, 24, 31, 64, 1024):
        tp = tft.plan_mesh(devices, model_parallel=model_parallel,
                           multi_pod_threshold=threshold)
        jp = jft.plan_mesh(devices, model_parallel=model_parallel,
                           multi_pod_threshold=threshold)
        assert (tp.shape, tp.axis_names, tp.dropped_devices) == \
            (jp.shape, jp.axis_names, jp.dropped_devices)


def test_build_mesh_on_a_local_pool():
    pool = tcol.LocalMesh(16, CPU)
    plan = tft.plan_mesh(12, model_parallel=4, multi_pod_threshold=10**9)
    mesh = tft.build_mesh(plan, pool, slots=range(12))
    assert isinstance(mesh, tcol.LocalMesh)
    assert mesh.shape == {"data": 3, "model": 4}
    assert mesh.device == pool.device
    assert tft.build_mesh(tft.plan_stream_mesh(7, 4), pool,
                          slots=[0, 1, 3, 4, 5, 6, 7]).shape == {"blocks": 4}
    with pytest.raises(ValueError, match="re-plan"):
        tft.build_mesh(plan, pool, slots=range(5))


# ---------------------------------------------------------------------------
# Planner rule R8: to the byte, reasons included
# ---------------------------------------------------------------------------

def _spec(mod, num_blocks=4, m=64, n=256):
    return mod.ASpec(m=m, n=n, nnz=m * n, num_blocks=num_blocks,
                     kind="stream")


def test_r8_restore_bytes_closed_form():
    k = 8
    spec = _spec(tplanner)
    n_pad = spec.num_blocks * ((spec.n + spec.num_blocks - 1)
                               // spec.num_blocks)
    assert tplanner.recovery_restore_bytes(spec, k) == 4 * 2 * n_pad * k \
        == jplanner.recovery_restore_bytes(_spec(jplanner), k)


R8_CASES = [
    # (num_blocks, survivors, config kwargs)
    (4, 7, dict(stream_backend="shard_map")),     # re-mesh, same peak
    (8, 7, dict()),                               # honest degrade
    (1, 3, dict()),                               # single by construction
    (4, 4, dict(stream_backend="single")),        # single by request
    (8, 2, dict(rank=4)),                         # degrade, sketch batch
    (4, 9, dict(memory_budget_bytes=1000)),       # nothing fits
]


@pytest.mark.parametrize("blocks,survivors,kw", R8_CASES,
                         ids=[f"D{c[0]}-S{c[1]}-{'-'.join(c[2]) or 'auto'}"
                              for c in R8_CASES])
def test_r8_plan_equals_the_reference_to_the_byte(blocks, survivors, kw):
    tp = tplanner.make_recovery_plan(
        _spec(tplanner, num_blocks=blocks),
        tapi.SolveConfig(truncate_rank=8, **kw), survivors=survivors)
    jp = jplanner.make_recovery_plan(
        _spec(jplanner, num_blocks=blocks),
        japi.SolveConfig(truncate_rank=8, **kw), survivors=survivors)
    assert (tp.backend, tp.strategy, tp.rank, tp.peak_bytes, tp.estimates,
            tp.reasons) == (jp.backend, jp.strategy, jp.rank, jp.peak_bytes,
                            jp.estimates, jp.reasons)
    assert tp.reasons[0].startswith("R8")
    assert f"{survivors} survivor(s)" in tp.reasons[0]


def test_r8_remesh_keeps_per_device_peak():
    cfg = tapi.SolveConfig(truncate_rank=8, stream_backend="shard_map")
    spec = _spec(tplanner, num_blocks=4)
    rp = tplanner.make_recovery_plan(spec, cfg, survivors=7)
    base = tplanner.make_stream_plan(spec, cfg, device_count=4)
    assert rp.backend == "shard_map" and rp.peak_bytes == base.peak_bytes
    assert rp.estimates["recovery_restore"] == \
        tplanner.recovery_restore_bytes(spec, 8)


def test_r8_degrade_is_honest():
    cfg = tapi.SolveConfig(truncate_rank=8)
    spec = _spec(tplanner, num_blocks=8)
    rp = tplanner.make_recovery_plan(spec, cfg, survivors=7)
    base = tplanner.make_stream_plan(spec, cfg, device_count=1)
    assert rp.backend == "single" and rp.peak_bytes == base.peak_bytes
    assert "degrading honestly" in rp.reasons[0]
    assert f"{base.peak_bytes:,}" in rp.reasons[0]
    for kw, err in ((dict(survivors=0), PlanError),):
        with pytest.raises(err) as t_err:
            tplanner.make_recovery_plan(spec, cfg, **kw)
        with pytest.raises(jplanner.PlanError) as j_err:
            jplanner.make_recovery_plan(_spec(jplanner, num_blocks=8),
                                        japi.SolveConfig(truncate_rank=8),
                                        **kw)
        assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError):
        tplanner.make_recovery_plan(spec, tapi.SolveConfig(), survivors=4)


def test_r8_bumps_its_plan_counter():
    from repro_torch import obs
    obs.reset()
    obs.enable()
    try:
        tplanner.make_recovery_plan(_spec(tplanner),
                                    tapi.SolveConfig(truncate_rank=8),
                                    survivors=4)
        assert 'planner_plans_total{rule="R8"} 1' in obs.export_text()
    finally:
        obs.disable()
        obs.reset()


# ---------------------------------------------------------------------------
# recover(): injected shardings, nothing of a training module
# ---------------------------------------------------------------------------

def test_recover_with_shardings_fn_skips_train(tmp_path):
    from repro_torch.checkpoint import Checkpointer
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"w": torch.arange(6, dtype=torch.float32)}
    ck.save(3, tree, blocking=True)
    before = {m for m in sys.modules if m.startswith("repro_torch")}
    seen = {}

    def shardings_fn(ctx):
        seen["ctx"] = ctx
        return {"w": None}

    survivors = tcol.LocalMesh(1, CPU)
    mesh, ctx, state, meta = tft.recover(ck, survivors=survivors,
                                         shardings_fn=shardings_fn,
                                         model_parallel=1)
    assert seen["ctx"] is ctx and ctx.mesh is mesh
    assert mesh.shape == {"data": 1, "model": 1} and mesh.device == \
        survivors.device
    assert torch.equal(state["w"], tree["w"]) and meta["step"] == 3
    new = {m for m in sys.modules if m.startswith("repro_torch")} - before
    assert not any("train" in m for m in new), new
    with pytest.raises(ValueError, match="survivor"):
        tft.recover(ck, survivors=[])
    # without shardings_fn: the train path, a train state restored by
    # state_shardings on the survivors' mesh
    from repro_torch.configs import base as tbase
    from repro_torch.train import step as tstep
    cfg = tbase.get_smoke_config("phi4-mini-3.8b")
    tcfg = tstep.TrainConfig()
    st = tstep.init_train_state(cfg, tcfg, torch.Generator().manual_seed(0),
                                CPU)
    ck.save(4, tstep.checkpoint_tree(st), blocking=True)
    mesh, ctx, saved, meta = tft.recover(ck, cfg, tcfg, survivors=survivors,
                                         model_parallel=1)
    back = tstep.state_from_checkpoint(saved)
    assert ctx.mesh is mesh and meta["step"] == 4 and back["seed"] == 1
    assert torch.equal(back["params"]["embed"], st["params"]["embed"])
    assert back["opt"]["m"]["embed"].shape == st["params"]["embed"].shape


def test_solveconfig_recovery_knobs_validate():
    cfg = tapi.SolveConfig(truncate_rank=4, checkpoint_every=2,
                           max_retries=1, retry_backoff_s=0.5)
    assert cfg.checkpoint_every == 2
    for kw, match in ((dict(truncate_rank=4, checkpoint_every=0),
                       "checkpoint_every"),
                      (dict(truncate_rank=4, max_retries=-1), "max_retries"),
                      (dict(truncate_rank=4, retry_backoff_s=-0.1),
                       "retry_backoff_s"),
                      (dict(checkpoint_every=2), "truncate_rank")):
        with pytest.raises(ValueError, match=match) as t_err:
            tapi.SolveConfig(**kw)
        with pytest.raises(ValueError) as j_err:
            japi.SolveConfig(**kw)
        assert str(t_err.value) == str(j_err.value)


# ---------------------------------------------------------------------------
# StreamSupervisor on one slot: the transient-fault contract
# ---------------------------------------------------------------------------

def _stream_cfg(**kw):
    kw.setdefault("checkpoint_every", 2)
    kw.setdefault("max_retries", 2)
    return tapi.SolveConfig(truncate_rank=4, num_blocks=1, **kw)


def _toy_batches(num=7, n=12, m=6, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
            for _ in range(num)]


def _plain_chunked(batches, cfg, every=2):
    state, i = tapi.svd_init(12, cfg, device=CPU), 0
    while i < len(batches):
        state = tapi.svd_stream(batches[i:i + every], cfg, state=state).state
        i += every
    return state


def _supervised(cfg, batches, faults=(), **kw):
    inj = tft.FaultInjector(list(faults))
    with tempfile.TemporaryDirectory() as d, inj.installed():
        with tft.StreamSupervisor(cfg, d, state=tapi.svd_init(12, cfg,
                                                              device=CPU),
                                  injector=inj) as sup:
            final = sup.run(batches, **kw)
    return final, sup


def test_supervisor_transient_drop_is_bit_identical():
    cfg = _stream_cfg()
    batches = _toy_batches()
    oracle = _plain_chunked(batches, cfg)
    final, sup = _supervised(cfg, batches, [tft.DropCollective(at_batch=3)])
    assert [e.kind for e in sup.events] == ["collective_retry"]
    assert sup.events[0].retries == 1
    assert sup.events[0].resumed_from_batch == 2
    assert torch.equal(final.u, oracle.u) and torch.equal(final.s, oracle.s)
    assert torch.equal(final.v, oracle.v)
    assert tstate._STREAM_POOL is None                # close() reset it


def test_supervisor_retry_exhaustion_escalates():
    # max_retries=0: the first drop takes the full drain/replan/restore
    # path at once; the fault fires once, so the replay succeeds.
    cfg = _stream_cfg(max_retries=0)
    batches = _toy_batches(num=5, seed=3)
    oracle = _plain_chunked(batches, cfg)
    final, sup = _supervised(cfg, batches, [tft.DropCollective(at_batch=2)])
    assert [e.kind for e in sup.events] == ["collective_escalate"]
    assert sup.events[0].resumed_from_batch == 2
    assert sup.events[0].retries == 1
    assert torch.equal(final.s, oracle.s) and torch.equal(final.u, oracle.u)


def test_supervisor_backs_off_between_retries(monkeypatch):
    """retry_backoff_s * 2**(attempt - 1) between tries, then escalation
    past max_retries (a collective that keeps dropping)."""
    from repro_torch.ft import supervise
    slept = []
    monkeypatch.setattr(supervise.time, "sleep", slept.append)
    cfg = _stream_cfg(max_retries=2, retry_backoff_s=0.25,
                      checkpoint_every=4)
    batches = _toy_batches(num=6, seed=4)
    oracle = _plain_chunked(batches, cfg, every=4)
    final, sup = _supervised(cfg, batches, [tft.DropCollective(at_batch=b)
                                            for b in (1, 2, 3)])
    assert [e.kind for e in sup.events] == \
        ["collective_retry", "collective_retry", "collective_escalate"]
    assert [e.retries for e in sup.events] == [1, 2, 3]
    assert sup.events[-1].resumed_from_batch == 0     # nothing committed
    assert slept == [0.25, 0.5]
    assert torch.equal(final.s, oracle.s)


def test_supervisor_writes_events_artifact(tmp_path):
    cfg = _stream_cfg()
    _, sup = _supervised(cfg, _toy_batches(num=3, seed=5),
                         [tft.DropCollective(at_batch=1)])
    out = tmp_path / "events.json"
    sup.write_events(str(out), scenario="unit")
    doc = json.loads(out.read_text())
    assert set(doc) == {"events", "healthy", "pool", "backend",
                        "backup_saved_s", "scenario"}
    assert doc["scenario"] == "unit" and doc["pool"] >= 1
    (ev,) = doc["events"]
    assert set(ev) == {f.name for f in
                       __import__("dataclasses").fields(jft.RecoveryEvent)}
    assert ev["kind"] == "collective_retry" and ev["batch"] == 1
    assert isinstance(ev["reasons"], list) and ev["reasons"]


def test_supervisor_monitor_resets_after_recovery():
    cfg = _stream_cfg()
    with tempfile.TemporaryDirectory() as d:
        with tft.StreamSupervisor(cfg, d, state=tapi.svd_init(12, cfg,
                                                              device=CPU)
                                  ) as sup:
            sup._monitor.flag_streak[0] = 7          # poisoned history
            sup._apply_placement(reset_monitor=True)
            assert sup._monitor.flag_streak == [0]
            assert sup._monitor.ewma == [None]
            assert isinstance(sup.pool, tcol.LocalMesh)
            assert tstate.stream_device_count() == 1
    assert tstate._STREAM_POOL is None


def test_supervisor_rejects_non_stream_config():
    with pytest.raises(ValueError, match="truncate_rank"):
        tft.StreamSupervisor(tapi.SolveConfig(), "/tmp/x",
                             state=tapi.svd_init(12, _stream_cfg(),
                                                 device=CPU))


def test_supervised_stream_matches_the_reference(tmp_path):
    """The supervised stream (a transient drop at batch 3 replayed) against
    the reference's plain chunked svd_stream on the same sparse batches,
    the reference's per-batch draws injected (fold_in(key, b), at the
    bucket's padded shape in a window): S at the stream tests' tolerance."""
    key = jax.random.PRNGKey(29)
    n, m, k = 48, 6, 4
    rng = np.random.default_rng(8)
    batches = [(rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.15))
               .astype(np.float32) for _ in range(7)]
    for x in batches[3:5]:
        x[1, :] = 0.0                      # lonely rows for the repair
    jcfg = japi.SolveConfig(truncate_rank=k, num_blocks=2, key=key)
    jst = japi.svd_init(n, jcfg)
    shapes = []
    for i in range(0, len(batches), 2):
        for x in batches[i:i + 2]:
            norm = jstate.as_delta(x, jst)
            shapes.append(m if jst.rank != k and not shapes
                          else jsw.bucket_signature(norm)[1])
        jst = japi.svd_stream(batches[i:i + 2], jcfg, state=jst).state
    w = n // 2

    def draws(b):
        return reference_draws(jax.random.fold_in(key, b), "neighbor_random",
                               2, shapes[b], w, w)

    cfg = tapi.SolveConfig(truncate_rank=k, num_blocks=2, checkpoint_every=2)
    inj = tft.FaultInjector([tft.DropCollective(at_batch=3)])
    with inj.installed():
        with tft.StreamSupervisor(cfg, str(tmp_path),
                                  state=tapi.svd_init(n, cfg, device=CPU),
                                  injector=inj) as sup:
            final = sup.run([torch.from_numpy(x) for x in batches],
                            draws=draws)
    assert [e.kind for e in sup.events] == ["collective_retry"]
    assert final.repaired_rows_seen == int(jst.repaired_rows_seen) > 0
    js = np.asarray(jst.s)
    np.testing.assert_allclose(final.s.numpy(), js, rtol=1e-4,
                               atol=1e-5 * js[0])
    assert_same_factors(final.u.numpy(), final.s.numpy(), np.asarray(jst.u),
                        js, top=2)
