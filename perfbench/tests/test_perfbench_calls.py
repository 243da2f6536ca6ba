"""The readers of the solve's call tree and of the runtime calls under
it (``front_door_ms``, ``sketch_factor_ms``, ``launches``, ``syncs``) on
hand-built traces, and a small traced run of each cell on the CPU."""
from __future__ import annotations

import pytest
import torch

from perfbench import spec
from perfbench import trace as tr
from perfbench.tests import helpers
from repro_torch.obs.trace import TraceEvent

EXACT, RANK16 = "sparse-2048x1m.exact", "sparse-2048x1m.rank16"


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _read(metric, td):
    return spec.layer_reader(metric).read(td)


def _span(name, span_id, parent, dur_us):
    return TraceEvent(name=name, ph="X", ts_us=0.0, dur_us=dur_us, tid=1,
                      depth=0 if parent is None else 1, args=(),
                      span_id=span_id, parent=parent, call=1)


def _td(host=(), spans=(), solves=2, device=(), window=(0, 1000)):
    return tr.TraceData(
        window_ns=window, device=[tr.Interval(*iv) for iv in device],
        host=[tr.Interval(*iv) for iv in host], spans=list(spans),
        ops=[dict(op="solve")] * solves, workload={}, config={})


# Two solves: the first launches 2 kernels (one by `cuLaunchKernel`)
# and waits twice; the second launches once and never waits.  Calls
# outside the two ranges belong to the harness.
CALLS = [("perfbench.solve", 0, 400), ("svd.call", 10, 390),
         ("cudaLaunchKernel", 20, 25), ("cuLaunchKernel", 30, 32),
         ("cudaStreamSynchronize", 40, 60),
         ("cudaDeviceSynchronize", 370, 380),
         ("cudaLaunchKernel", 395, 398), ("cudaStreamSynchronize", 500, 510),
         ("svd.call", 600, 900), ("cudaLaunchKernel", 610, 615),
         ("cudaMemcpyAsync", 620, 630)]


def test_launches_and_syncs_count_the_runtime_calls_inside_svd_call():
    td = _td(CALLS)
    assert _read("launches.solve", td) == 1.5
    assert _read("syncs.solve", td) == 1.0
    # A traced run that launched but never waited inside a call reads 0.
    quiet = _td([iv for iv in CALLS if "Synchronize" not in iv[0]])
    assert _read("syncs.solve", quiet) == 0.0


@pytest.mark.parametrize("metric", ["launches.solve", "syncs.solve"])
def test_runtime_counts_read_nothing_where_nothing_is_traced(metric):
    # The CPU traces no runtime call; the parent program opens no
    # svd.call range.
    cpu = _td([("svd.call", 10, 390), ("aten::mm", 20, 30)])
    no_calls = _td([iv for iv in CALLS if iv[0] != "svd.call"])
    assert _read(metric, cpu) is None
    assert _read(metric, no_calls) is None
    assert _read(metric, _td()) is None


def test_front_door_is_svd_call_less_its_timed_children():
    spans = [
        _span("describe_and_plan", 2, 1, 100.0),
        _span("as_block_input", 3, 1, 50.0),
        _span("split_and_repair", 5, 4, 300.0),      # a grandchild
        _span("svd.solve", 4, 1, 700.0),
        _span("diagnostics", 6, 1, 100.0),           # front-door work
        _span("svd.call", 1, None, 1000.0),
        _span("svd.solve", 11, 10, 300.0),
        _span("svd.call", 10, None, 500.0),
        _span("svd.solve", 20, None, 50.0),          # outside any call
    ]
    # (1000 - 850) + (500 - 300) us over 2 solves
    assert _read("front_door_ms.solve", _td(spans=spans)) \
        == pytest.approx(0.175)
    assert _read("front_door_ms.solve", _td(spans=spans[:5])) is None
    assert _read("front_door_ms.solve", _td(spans=spans, solves=0)) is None


def test_sketch_factor_sums_its_four_spans_a_solve():
    spans = [_span("sketch_index", 2, 1, 100.0),
             _span("sketch_gram", 3, 1, 50.0),
             _span("truncate_sketch", 4, 1, 30.0),
             _span("right_vectors", 5, 1, 20.0),
             _span("sketch", 6, 1, 999.0),
             _span("right_vectors_stack", 7, 1, 999.0)]
    assert _read("sketch_factor_ms.solve", _td(spans=spans)) \
        == pytest.approx(0.1)
    assert _read("sketch_factor_ms.solve", _td(spans=spans[4:])) is None


def test_an_idle_gap_is_named_by_the_innermost_program_span():
    td = _td([("perfbench.solve", 0, 1000), ("svd.call", 10, 990),
              ("diagnostics", 120, 250)],
             device=[("k", 0, 100), ("k", 200, 1000)])
    assert tr.idle_gaps(td) == [["diagnostics", pytest.approx(1e-7)]]


@pytest.mark.parametrize("name", [EXACT, RANK16])
def test_a_traced_run_reads_the_call_tree(name, monkeypatch):
    seen = []
    real = tr.idle_gaps

    def keep(td):
        seen.append(td)
        return real(td)

    monkeypatch.setattr(tr, "idle_gaps", keep)
    out = helpers.run_tiny(name, trace=True)
    assert out["correct"], out["checks"]
    metrics = set(out["metrics"])
    assert "front_door_ms.solve" in metrics
    assert ("sketch_factor_ms.solve" in metrics) == (name == RANK16)
    assert out["metrics"]["front_door_ms.solve"]["value"] > 0.0
    # The CPU traces no runtime call: the counts are left out.
    assert not metrics & {"launches.solve", "syncs.solve"}

    # Every program span stands on the profiler's timeline as a host
    # range, so a gap under one is named by it: a gap just after a span
    # opened is put down to that span.
    (td,) = seen
    ranges = {iv.name for iv in td.host}
    assert {ev.name for ev in td.spans} <= ranges
    inner = "sketch_index" if name == RANK16 else "describe_and_plan"
    t = min(iv.start_ns for iv in td.host if iv.name == inner) + 1
    lo, hi = td.window_ns
    td.device = [tr.Interval("k", lo, t - 1), tr.Interval("k", t + 1, hi)]
    assert real(td) == [[inner, pytest.approx(2e-9)]]
