"""``repro_torch.obs`` against ``repro.obs`` on the CPU.

* Twins of ``tests/test_obs.py``: span nesting and ordering, the ring's
  drop-oldest overflow, the Chrome trace schema, the Prometheus / JSON
  exporters (the reference's golden output, and the same ``export_json``
  as ``repro.obs.metrics`` for the same calls), the drift monitor's
  one-shot warning and gauges, the disabled-mode contract (the same window
  dispatches and step shapes, factors equal with ``torch.equal``, an
  empty ring and registry), Diagnostics' compile/run split and
  ``ServeHandle.metrics``.  The reference's
  ``test_span_records_nothing_while_jax_traces`` has as counterpart a span
  that is a no-op under CUDA graph capture (a stub of
  ``torch.cuda.is_current_stream_capturing``).
* The CPU has no allocator peak: the drift probe records nothing there
  (the R5 / R6 / R7 ratios are held on the card by ``chip_smoke.py``);
  the probe's memoization and one-shot warning are held through a stub
  measurement, and the lazy resolution of CUDA-event spans through stub
  events (no wait while a span's end event is pending, callbacks once
  resolved).
* The solver's spans (the stage names ``core/stages.py`` recorded before
  ``obs`` replaced it) for each solve path: names, repeats, the timed
  children of the call's root span ``svd.call`` within the wall time,
  results bit-equal with obs on and off.
* The call tree: every span of an ``api.svd`` call carries the call's
  id, its parent is the span around it, and ``svd.call`` is the root;
  under ``torch.profiler`` each span is one range nested in its parent's,
  and no range opens with obs or the profiler off.
"""
import warnings

import numpy as np
import pytest
import torch

from repro.obs import metrics as jmetrics

from repro_torch import obs
from repro_torch.core import api, sparse
from repro_torch.stream import window as sw

CPU = "cpu"
N, D, K = 96, 4, 12
CFG = api.SolveConfig(method="none", truncate_rank=K, num_blocks=D)


@pytest.fixture
def obs_on():
    """Enabled + clean obs state; always restores the module-global
    disabled default so the rest of the suite runs untouched."""
    obs.enable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


@pytest.fixture
def obs_off():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _batches(num, m=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((m, N)).astype(np.float32)
            for _ in range(num)]


# ---------------------------------------------------------------------------
# spans + ring buffer
# ---------------------------------------------------------------------------

def test_span_nesting_and_ordering(obs_on):
    with obs.span("a.outer", stage=1):
        with obs.span("a.inner"):
            pass
        obs.event("a.mark", hit=True)
    evs = obs.trace.events()
    # append order == exit order: inner closes first, outer last
    assert [e.name for e in evs] == ["a.inner", "a.mark", "a.outer"]
    inner, mark, outer = evs
    assert (outer.ph, inner.ph, mark.ph) == ("X", "X", "i")
    assert outer.depth == 0 and inner.depth == 1 and mark.depth == 1
    # the inner span is contained in the outer one on the obs timebase
    assert outer.ts_us <= inner.ts_us
    assert inner.ts_us + inner.dur_us <= outer.ts_us + outer.dur_us
    assert outer.args == (("stage", 1),)
    summary = obs.span_summary(evs)
    assert [row[0] for row in summary] == ["a.outer", "a.inner"]
    assert summary[0][1] == 1 and summary[0][2] >= summary[1][2]


def test_span_records_nothing_under_graph_capture(obs_on, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with obs.span("captured.body") as sp:
        sp.then(lambda us: pytest.fail("a captured span called back"))
    obs.event("captured.mark")
    monkeypatch.undo()
    assert obs.trace.events() == []


def test_span_callbacks_get_the_duration(obs_on):
    got = []
    with obs.span("with.callback", a=1) as sp:
        sp.then(got.append)
    (ev,) = obs.trace.events()
    assert ev.args == (("a", 1),)
    assert got == [ev.dur_us]


class _StubEvent:
    """A stand-in for ``torch.cuda.Event``: completes when told, counts
    the waits."""
    log = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.done = False
        self.t = None

    def record(self, stream=None):
        self.t = len(_StubEvent.log)
        _StubEvent.log.append(self)

    def query(self):
        return self.done

    def synchronize(self):
        _StubEvent.log.append("wait")
        self.done = True

    def elapsed_time(self, end):
        assert end.done                   # (so the start is done too)
        return float(end.t - self.t)      # "milliseconds"


def test_event_timed_spans_resolve_lazily_without_waiting(obs_on,
                                                          monkeypatch):
    """With CUDA initialized a span records two events and no wait: it is
    resolved when a later append finds its end event complete (query),
    and a read resolves the rest (waiting only there)."""
    _StubEvent.log = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "Event", _StubEvent)
    seen = []
    with obs.span("dev.a") as sp:
        sp.then(seen.append)
    buf = obs.trace.buffer()
    assert "wait" not in _StubEvent.log and seen == []
    assert len(buf._pending) == 1
    for ev in _StubEvent.log:
        ev.done = True                      # the device caught up
    with obs.span("dev.b"):
        pass
    assert seen == [1000.0]                 # (1 - 0) ms, resolved by query
    assert "wait" not in _StubEvent.log and len(buf._pending) == 1
    evs = obs.trace.events()                # a read may wait
    assert [e.name for e in evs] == ["dev.a", "dev.b"]
    assert [e.dur_us for e in evs] == [1000.0, 1000.0]
    assert _StubEvent.log.count("wait") == 1 and not buf._pending


def test_ring_overflow_drops_oldest(obs_on):
    try:
        obs.trace.set_capacity(4)
        for i in range(10):
            obs.event("ring.tick", i=i)
        evs = obs.trace.events()
        assert len(evs) == 4
        # drop-OLDEST: the survivors are the most recent four
        assert [dict(e.args)["i"] for e in evs] == [6, 7, 8, 9]
        assert obs.trace.dropped() == 6
        assert [dict(e.args)["i"] for e in obs.trace.events_since(8)] \
            == [8, 9]
        obs.trace.clear()
        assert obs.trace.events() == [] and obs.trace.dropped() == 0
    finally:
        obs.trace.set_capacity(obs.gate.ring_capacity())


def test_ring_capacity_validation():
    with pytest.raises(ValueError, match="capacity"):
        obs.trace.TraceBuffer(0)


def test_chrome_trace_schema_roundtrip(obs_on, tmp_path):
    with obs.span("ingest.window", bucket="('dense', 8)"):
        obs.event("snapshot.publish", version=1)
    doc = obs.chrome_trace()
    obs.validate_chrome_trace(doc)
    recs = doc["traceEvents"]
    assert recs[0]["ph"] == "M"      # process_name metadata
    cats = {r.get("cat") for r in recs[1:]}
    assert cats == {"ingest", "snapshot"}
    assert obs.write_chrome_trace(str(tmp_path / "t.json")) == 2
    with pytest.raises(AssertionError, match="dur"):
        obs.validate_chrome_trace({"traceEvents": [
            {"name": "x", "ph": "X", "pid": 1, "tid": 1, "ts": 0.0}]})


# ---------------------------------------------------------------------------
# metrics registry + exporters
# ---------------------------------------------------------------------------

GOLDEN = (
    "# TYPE ingest_rows_total counter\n"
    "ingest_rows_total 3\n"
    "# TYPE snapshot_version gauge\n"
    "snapshot_version 2\n"
    "# TYPE serve_latency_us summary\n"
    'serve_latency_us{quantile="0.5"} 200\n'
    'serve_latency_us{quantile="0.9"} 300\n'
    'serve_latency_us{quantile="0.99"} 300\n'
    "serve_latency_us_sum 600\n"
    "serve_latency_us_count 3\n")


def test_export_text_golden(obs_on):
    obs.counter_add("ingest_rows_total", 3)
    obs.gauge_set("snapshot_version", 2)
    for v in (100.0, 200.0, 300.0):
        obs.histogram_observe("serve_latency_us", v)
    assert obs.export_text() == GOLDEN


def test_export_json_and_labels(obs_on):
    obs.counter_add("planner_plans_total", labels={"rule": "R6"})
    obs.counter_add("planner_plans_total", labels={"rule": "R6"})
    obs.gauge_set("drift_ratio", 1.02, labels={"rule": "R7",
                                               "site": "dense"})
    doc = obs.export_json()
    assert doc["counters"] == {'planner_plans_total{rule="R6"}': 2}
    assert doc["gauges"] == {
        'drift_ratio{rule="R7",site="dense"}': 1.02}
    assert doc["histograms"] == {}
    reg = obs.registry()
    assert reg.counter_value("planner_plans_total",
                             {"rule": "R6"}) == 2
    assert reg.gauge_value("drift_ratio",
                           {"site": "dense", "rule": "R7"}) == 1.02


def test_registry_exports_equal_the_references():
    """The same calls on the port's registry and on
    ``repro.obs.metrics.MetricsRegistry`` export the same text and JSON."""
    rng = np.random.default_rng(4)
    ops = [("counter_add", "serve_requests_total", 1.0, None),
           ("counter_add", "planner_plans_total", 1.0, {"rule": "R5"}),
           ("gauge_set", "drift_ratio", 0.87, {"rule": "R6",
                                                "site": "single"}),
           ("gauge_set", "snapshot_version", 3, None)]
    ops += [("histogram_observe", "serve_latency_us", float(x), None)
            for x in rng.uniform(10, 500, size=50)]
    ours, theirs = obs.metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    for op, name, value, labels in ops:
        getattr(ours, op)(name, value, labels)
        getattr(theirs, op)(name, value, labels)
    assert ours.export_json() == theirs.export_json()
    assert ours.export_text() == theirs.export_text()
    golden = jmetrics.MetricsRegistry()
    golden.counter_add("ingest_rows_total", 3)
    golden.gauge_set("snapshot_version", 2)
    for v in (100.0, 200.0, 300.0):
        golden.histogram_observe("serve_latency_us", v)
    assert golden.export_text() == GOLDEN


def test_histogram_reservoir_is_sliding_window(obs_on):
    h = obs.metrics.Histogram(capacity=4)
    for v in (1.0, 2.0, 3.0, 4.0, 100.0, 100.0, 100.0, 100.0):
        h.observe(v)
    assert h.count == 8                      # lifetime count survives
    assert h.quantile(0.5) == 100.0          # quantiles track the window


def test_disabled_wrappers_do_not_touch_registry(obs_off):
    assert not obs.enabled()
    obs.counter_add("ghost_total")
    obs.gauge_set("ghost_gauge", 1.0)
    obs.histogram_observe("ghost_hist", 1.0)
    assert obs.record_drift("R6", 10, 1) is None
    calls = []
    assert obs.observe_call("R6", lambda: calls.append(1) or 7, 1,
                            device=CPU) == 7 and calls == [1]
    with obs.span("ghost.span") as sp:
        sp.then(calls.append)
    obs.event("ghost.event")
    doc = obs.export_json()
    assert (doc["counters"], doc["gauges"], doc["histograms"]) \
        == ({}, {}, {})
    assert obs.trace.events() == [] and obs.drift_ratios() == {}


# ---------------------------------------------------------------------------
# drift monitor
# ---------------------------------------------------------------------------

def test_drift_warns_once_on_underpriced_plan(obs_on, monkeypatch):
    """The probe measures the first call of a shape (a stub stands in for
    the card's allocator), warns once past the factor, and answers later
    calls of the shape from its memo without measuring again."""
    measured = []

    def fake_measure(call, device, *, resident=(), component="temp"):
        measured.append(component)
        return call(), 4096 + obs.drift.resident_bytes(resident)

    monkeypatch.setattr(obs.drift, "measured_peak_bytes", fake_measure)
    x = torch.zeros((64, 64))
    key = obs.drift.shape_key(x)
    with pytest.warns(obs.DriftWarning, match="under-pricing"):
        out = obs.observe_call("R6", lambda: "ran", 8, device=CPU,
                               component="total", label="test",
                               shape_key=key, resident=(x,))
    assert out == "ran" and measured == ["total"]
    ratio = obs.drift_ratios()["R6/test"]
    assert ratio == (4096 + 64 * 64 * 4) / 8 > obs.gate.drift_factor()
    reg = obs.registry()
    assert reg.gauge_value("drift_ratio",
                           {"rule": "R6", "site": "test"}) == ratio
    # shape-memoized AND one-shot: the same site/shape neither
    # re-measures nor re-warns
    with warnings.catch_warnings():
        warnings.simplefilter("error", obs.DriftWarning)
        again = obs.observe_call("R6", lambda: "again", 8, device=CPU,
                                 component="total", label="test",
                                 shape_key=key, resident=(x,))
    assert again == "again" and measured == ["total"]


def test_drift_record_sets_all_three_gauges(obs_on):
    ratio = obs.record_drift("R5", 120, 100, label="single")
    assert ratio == pytest.approx(1.2)
    reg = obs.registry()
    lab = {"rule": "R5", "site": "single"}
    assert reg.gauge_value("drift_measured_bytes", lab) == 120
    assert reg.gauge_value("drift_estimated_bytes", lab) == 100
    assert reg.gauge_value("drift_ratio", lab) == pytest.approx(1.2)
    # ratios() keeps the WORST ratio per key
    obs.record_drift("R5", 110, 100, label="single")
    assert obs.drift_ratios()["R5/single"] == pytest.approx(1.2)


def test_drift_probe_measures_nothing_on_the_cpu():
    calls = []
    out, peak = obs.drift.measured_peak_bytes(
        lambda: calls.append(1) or "x", CPU, component="total")
    assert (out, peak, calls) == ("x", None, [1])
    with pytest.raises(ValueError, match="component"):
        obs.drift.measured_peak_bytes(lambda: None, CPU, component="all")
    ell = sparse.block_ell_from_coo(
        sparse.random_bipartite(8, 64, 0.1, seed=0), 2, device=CPU)
    key = obs.drift.shape_key(ell, torch.zeros(3), (torch.ones(2, 2), None))
    assert key == ((tuple(ell.col_ids.shape), "torch.int32"),
                   (tuple(ell.col_rows.shape), "torch.int32"),
                   (tuple(ell.col_vals.shape), "torch.float32"),
                   ((3,), "torch.float32"), ((2, 2), "torch.float32"))


def test_drift_silent_on_pipeline_at_reference_shapes(obs_on):
    """svd_stream + serve_topk with observe on, on the CPU: nothing is
    measured and nothing warns (the card's R5 / R6 / R7 ratios are held
    by chip_smoke.py); record_drift drives the gauges; the digests ride
    on Diagnostics and ServeHandle.metrics() carries the serve view."""
    rng = np.random.default_rng(3)
    cfg = api.SolveConfig(method="none", truncate_rank=K, num_blocks=D,
                          observe=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error", obs.DriftWarning)
        res = api.svd_stream(iter(_batches(5)), cfg, device=CPU)
        handle = api.serve_init(res.state,
                                api.ServeTopKConfig(batch_size=8, k_top=5,
                                                    use_kernel=False))
        api.serve_topk(handle, torch.from_numpy(
            rng.standard_normal((8, K)).astype(np.float32)))
    assert obs.drift_ratios() == {}
    assert obs.registry().gauges_with_prefix("drift") == {}
    assert obs.record_drift("R7", 90, 100, label="dense") \
        == pytest.approx(0.9)
    assert obs.registry().gauges_with_prefix("drift_ratio") == {
        'drift_ratio{rule="R7",site="dense"}': pytest.approx(0.9)}
    assert res.diagnostics.drift_ratios == {}
    assert res.diagnostics.span_summary is not None
    assert {row[0] for row in res.diagnostics.span_summary} >= \
        {"ingest.window", "ingest.batch", "merge.svd"}
    reg = obs.registry()
    assert reg.counter_value("ingest_batches_total") == 5
    assert reg.counter_value("window_dispatch_total") >= 1
    assert reg.counter_value("planner_plans_total", {"rule": "R7"}) == 1
    m = handle.metrics()
    assert m["snapshot_version"] == 0     # no commit yet
    assert m["serve_requests_total"] == 1.0
    assert m["serve_queries_total"] == 8.0
    assert m["serve_latency_us_p99"] > 0
    assert m["drift_ratios"] == {"R7/dense": pytest.approx(0.9)}


# ---------------------------------------------------------------------------
# disabled mode: the zero-cost contract
# ---------------------------------------------------------------------------

def test_disabled_mode_zero_dispatch_and_bit_identical(obs_off):
    """observe=off vs on from identical fresh counts: the SAME window
    dispatches and step shapes, bit-identical factors — and the off run
    leaves the ring and registry empty."""
    batches = _batches(6, seed=42)

    sw.clear_caches()
    res_off = api.svd_stream(iter(batches), CFG, device=CPU)
    off_counts = dict(sw.dispatch_counts())
    off_traces = sw.trace_count()
    assert obs.trace.events() == []
    doc = obs.export_json()
    assert (doc["counters"], doc["gauges"], doc["histograms"]) \
        == ({}, {}, {})
    assert obs.drift_ratios() == {}
    assert res_off.diagnostics.span_summary is None

    obs.enable()
    sw.clear_caches()
    res_on = api.svd_stream(iter(batches), CFG, device=CPU)
    on_counts = dict(sw.dispatch_counts())
    on_traces = sw.trace_count()
    assert obs.trace.events(), "observe=on recorded nothing"

    assert off_counts == on_counts
    assert off_traces == on_traces
    for f in ("u", "s", "v"):
        assert torch.equal(getattr(res_off.state, f),
                           getattr(res_on.state, f)), f


def test_disabled_serve_topk_uses_untouched_path(obs_off):
    state = api.svd_stream(iter(_batches(3, seed=5)), CFG,
                           device=CPU).state
    handle = api.serve_init(state, api.ServeTopKConfig(batch_size=4,
                                                       k_top=3,
                                                       use_kernel=False))
    q = torch.from_numpy(np.random.default_rng(1)
                         .standard_normal((4, K)).astype(np.float32))
    off = api.serve_topk(handle, q)
    handle.commit(state)
    assert obs.trace.events() == []
    assert obs.drift_ratios() == {}
    # metrics() still answers (buffer-derived health needs no obs) and
    # lacks the obs fields; they appear once obs is on
    m = handle.metrics()
    assert m["snapshot_version"] == 1
    assert m["snapshot_age_s"] >= 0
    assert "serve_requests_total" not in m
    obs.enable()
    on = api.serve_topk(handle, q)
    assert torch.equal(off.scores, on.scores)
    assert torch.equal(off.indices, on.indices)
    m = handle.metrics()
    assert m["serve_requests_total"] == 1.0
    assert m["serve_latency_us_p50"] > 0


def test_snapshot_commit_records_stage_and_publish(obs_on):
    state = api.svd_stream(iter(_batches(3, seed=6)), CFG,
                           device=CPU).state
    handle = api.serve_init(state, api.ServeTopKConfig(batch_size=4,
                                                       k_top=3))
    obs.reset()
    handle.commit(state)
    evs = obs.trace.events()
    assert [(e.name, e.ph) for e in evs] == [("snapshot.stage", "X"),
                                             ("snapshot.publish", "i")]
    assert dict(evs[0].args) == {"version": 1, "quantize": False}
    assert obs.registry().gauge_value("snapshot_version") == 1


# ---------------------------------------------------------------------------
# Diagnostics: the wall-time split and the obs digests
# ---------------------------------------------------------------------------

def test_diagnostics_compile_run_split(obs_off):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((32, 48)).astype(np.float32)
    cfg = api.SolveConfig(num_blocks=2)
    d1 = api.svd(a, cfg, device=CPU).diagnostics
    assert d1.wall_time_s == pytest.approx(
        d1.compile_time_s + d1.run_time_s)
    assert d1.compile_time_s >= 0 and d1.run_time_s >= 0
    d2 = api.svd(a, cfg, device=CPU).diagnostics
    assert d2.compile_time_s <= d1.wall_time_s
    assert d2.run_time_s > 0
    # off by default: no obs payloads on Diagnostics
    assert d1.drift_ratios is None and d1.span_summary is None


def test_compile_seconds_come_from_the_kernel_build(obs_off, monkeypatch):
    """The kernels' build reports its seconds to the obs clock, and a call
    during which they appear reports them as compile time."""
    from repro_torch.obs import clock
    a = np.random.default_rng(1).standard_normal((16, 32)).astype(np.float32)
    real = api.ranky.solve_single

    def building_solve(*args, **kw):
        clock.record_compile(0.004)
        return real(*args, **kw)

    monkeypatch.setattr(api.ranky, "solve_single", building_solve)
    before = clock.compile_seconds()
    d = api.svd(a, num_blocks=2, backend="single", device=CPU).diagnostics
    assert clock.compile_seconds() == pytest.approx(before + 0.004)
    assert d.compile_time_s == pytest.approx(min(0.004, d.wall_time_s))
    assert d.run_time_s == pytest.approx(d.wall_time_s - d.compile_time_s)
    assert clock.install_compile_probe() is True


def test_solve_config_observe_turns_obs_on(obs_off):
    coo = sparse.random_bipartite(24, 512, 1e-2, seed=2)
    res = api.svd(coo, api.SolveConfig(num_blocks=4, observe=True),
                  device=CPU)
    assert obs.enabled()                   # sticky
    assert res.diagnostics.span_summary is not None
    assert res.diagnostics.drift_ratios == {}
    names = {row[0] for row in res.diagnostics.span_summary}
    assert {"describe_and_plan", "svd.solve", "gram_stack"} <= names
    assert obs.registry().counter_value("planner_plans_total",
                                        {"rule": "R1-R4"}) == 1


# ---------------------------------------------------------------------------
# The solver's spans, path by path (what core/stages.py recorded)
# ---------------------------------------------------------------------------

FRONT = ["describe_and_plan", "as_block_input", "svd.solve",
         "split_and_repair"]
PATHS = [
    (dict(merge_mode="gram", want_right=True, use_kernel=True),
     FRONT + ["gram_stack", "merge_grams_eigh", "right_vectors_stack"],
     {}),
    (dict(merge_mode="proxy"),
     FRONT + ["gram_stack", "eigh_to_svd", "merge_panels_svd"], {}),
    (dict(merge_mode="proxy", local_mode="svd"),
     FRONT + ["local_svd_exact", "merge_panels_svd"], {}),
    (dict(backend="single", method="random", rank=8, power_iters=2,
          want_right=True),
     FRONT + ["sketch_index", "sketch", "pullback", "qr", "sketch_gram",
              "truncate_sketch", "right_vectors"],
     {"sketch": 3, "pullback": 3, "qr": 2}),
]


@pytest.mark.parametrize("knobs,names,repeats", PATHS)
def test_each_path_records_its_spans_where_they_run(obs_off, knobs, names,
                                                    repeats):
    coo = sparse.random_bipartite(48, 4096, 2e-3, seed=1)
    cfg = api.SolveConfig(num_blocks=4, **knobs)
    plain = api.svd(coo, cfg, device=CPU)
    obs.enable()
    timed = api.svd(coo, cfg, device=CPU)
    evs = obs.trace.events()
    first_seen = list(dict.fromkeys(e.name for e in evs))
    # "diagnostics" runs after the call's clock stops, inside the call's
    # root span "svd.call", which closes last
    assert sorted(first_seen) == sorted(names + ["diagnostics", "svd.call"])
    assert evs[-1].name == "svd.call"
    summary = {name: (count, us) for name, count, us
               in timed.diagnostics.span_summary}
    assert set(summary) == set(names)
    for name in names:
        assert summary[name][0] == repeats.get(name, 1), name
        assert summary[name][1] >= 0.0
    timed_children = sum(e.dur_us for e in evs
                         if e.parent == evs[-1].span_id
                         and e.name != "diagnostics")
    assert timed_children <= timed.diagnostics.wall_time_s * 1e6
    assert torch.equal(plain.s, timed.s) and torch.equal(plain.u, timed.u)
    if plain.v is not None:
        assert torch.equal(plain.v, timed.v)


# ---------------------------------------------------------------------------
# The call tree, and the spans on the profiler's timeline
# ---------------------------------------------------------------------------

RANDOMIZED = dict(backend="single", method="random", rank=8,
                  want_right=True)


def _solve(**knobs):
    coo = sparse.random_bipartite(48, 4096, 2e-3, seed=1)
    return api.svd(coo, api.SolveConfig(num_blocks=4, **knobs), device=CPU)


@pytest.mark.parametrize("knobs", [dict(merge_mode="gram", want_right=True),
                                   RANDOMIZED])
def test_every_span_of_a_call_carries_its_id(obs_on, knobs):
    with obs.span("before"):
        pass
    _solve(**knobs)
    obs.event("after")
    evs = obs.trace.events()
    before, *inside, after = evs
    (root,) = [e for e in inside if e.name == "svd.call"]
    # svd.call is the only root but for what was recorded outside it
    assert [e for e in evs if e.parent is None] == [before, root, after]
    assert (before.call, after.call) == (before.span_id, after.span_id)
    assert len({e.span_id for e in evs}) == len(evs)
    by_id = {e.span_id: e for e in evs}
    for e in inside:
        assert e.call == root.span_id, e.name
        if e is root:
            continue
        p = by_id[e.parent]                 # the enclosing span
        assert p.depth == e.depth - 1, e.name
        assert p.ts_us <= e.ts_us, e.name
        assert e.ts_us + e.dur_us <= p.ts_us + p.dur_us, e.name
    assert {e.name for e in inside if e.parent == root.span_id} \
        == {"describe_and_plan", "as_block_input", "svd.solve",
            "diagnostics"}
    recs = obs.chrome_trace(evs)["traceEvents"][1:]
    assert [(r["args"]["span_id"], r["args"]["parent"], r["args"]["call"])
            for r in recs] == [(e.span_id, e.parent, e.call) for e in evs]


def _user_ranges(prof) -> dict:
    """{name: [(start_ns, end_ns), ...] by start} of a profile's
    ``record_function`` ranges."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            out.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return {name: sorted(r) for name, r in out.items()}


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return _user_ranges(prof)


def test_each_span_is_one_range_on_the_profilers_timeline(obs_on):
    ranges = _profiled(lambda: _solve(**RANDOMIZED))
    evs = obs.trace.events()
    where = {}
    for name in {e.name for e in evs}:
        spans = sorted((e for e in evs if e.name == name),
                       key=lambda e: e.ts_us)
        assert len(ranges.get(name, ())) == len(spans), name
        where.update((e.span_id, r) for e, r in zip(spans, ranges[name]))
    for e in evs:
        if e.parent is not None:
            (a, b), (pa, pb) = where[e.span_id], where[e.parent]
            assert pa <= a and b <= pb, e.name


def test_no_range_opens_with_obs_or_the_profiler_off(obs_off, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args, **kw):
        opened.append(name)
        return real(name, *args, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert "svd.call" not in _profiled(lambda: _solve(**RANDOMIZED))
    assert opened == []                     # obs off, the profiler on
    obs.enable()
    _solve(**RANDOMIZED)
    assert obs.trace.events() and opened == []   # the profiler off
    assert "svd.call" in _profiled(lambda: _solve(**RANDOMIZED))
    assert "svd.call" in opened


def test_nothing_is_recorded_while_off(obs_off):
    coo = sparse.random_bipartite(48, 4096, 2e-3, seed=1)
    res = api.svd(coo, api.SolveConfig(num_blocks=4), device=CPU)
    with obs.span("idle"):
        pass
    assert obs.trace.events() == [] and obs.trace.mark() == 0
    assert res.diagnostics.span_summary is None
    assert obs.export_json()["counters"] == {}


def test_snapshot_keeps_contiguous_factors_for_the_wave(obs_off):
    """R7's drift probe on the card read twice the planned bytes a wave:
    the state's v is a strided column slice of the merge's output, and
    the kernel's wrapper copied it at every wave.  The snapshot now holds
    the contiguous copy (same values), made once a commit."""
    import dataclasses

    from repro_torch.serve import ServingSnapshot
    state = api.svd_stream(iter(_batches(3, seed=7)), CFG, device=CPU).state
    # The tall merge now forms only the kept columns of U = Q U_R, so the
    # stream's v is contiguous; a strided v (the wide merge's, through the
    # transpose) is what the snapshot must copy.
    assert state.v.is_contiguous()
    wide = torch.cat([state.v, state.v], dim=1)
    state = dataclasses.replace(state, v=wide[:, :state.rank])
    assert not state.v.is_contiguous()
    snap = ServingSnapshot.from_state(state)
    assert snap.v.is_contiguous() and torch.equal(snap.v, state.v)
    assert ServingSnapshot.from_state(state, quantize=True).v_q \
        .is_contiguous()
