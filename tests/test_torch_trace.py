"""The trace CLI (scripts/ranky_trace_torch.py) against the reference's
scripts/ranky_trace.py at the same arguments, and the obs-off serving
branch against the direct ranker call.  Both run in process on the CPU;
the reference's run is the oracle for span and metric names."""
import contextlib
import importlib.util
import io
import json
import os
import re

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import api
from repro_torch.serve import ranker
from repro_torch.stream import window as swindow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--batches", "4", "--waves", "4", "--n", "256"]
# The reference CI's span categories (scripts/check_bench_json.py).
CATEGORIES = {"ingest", "merge", "serve", "snapshot"}
# Reference metric names the port does not write on the CPU, each with
# its reason.  (None is JAX-only: the port keeps ``jit_cache_size`` as
# its count of built (step shape, capacity, T) triples.)
CPU_ABSENT = {
    "drift_estimated_bytes": "drift is the allocator's peak on the card; "
                             "the CPU has none (chip_smoke.py phase "
                             "trace holds it on the GPU)",
    "drift_measured_bytes": "as drift_estimated_bytes",
    "drift_ratio": "as drift_estimated_bytes",
}
PROM_LINE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _prom_names(text):
    names = set()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = PROM_LINE.match(line)
        assert m is not None, f"not `name{{labels}} value`: {line!r}"
        float(m.group(3))
        names.add(m.group(1))
    return names


def _json_names(doc):
    return {key.split("{", 1)[0] for kind in doc.values() for key in kind}


def _events(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's run and the port's (Prometheus text, then JSON
    metrics), at the same arguments."""
    from repro import obs as ref_obs

    tmp = tmp_path_factory.mktemp("trace")
    out = {}
    try:
        assert _load("ranky_trace").main(
            [str(tmp / "ref.json"), "--metrics", str(tmp / "ref.prom"),
             *ARGS]) == 0
        out["ref_json_metrics"] = ref_obs.export_json()
    finally:
        ref_obs.disable()
        ref_obs.reset()
    port = _load("ranky_trace_torch")
    for fmt in ("prom", "json"):
        # each run as in a fresh process: no window shape built yet
        swindow.clear_caches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert port.main([str(tmp / f"port_{fmt}.trace.json"),
                              "--metrics", str(tmp / f"port.{fmt}"),
                              *ARGS, "--device", "cpu"]) == 0
        out[f"stdout_{fmt}"] = buf.getvalue()
    out["tmp"] = tmp
    return out


def test_trace_is_valid_and_covers_the_ci_categories(runs):
    doc = _events(runs["tmp"] / "port_prom.trace.json")
    obs.validate_chrome_trace(doc)
    evs = doc["traceEvents"]
    assert any(e["ph"] == "M" for e in evs)
    cats = {e["name"].split(".", 1)[0] for e in evs if e["ph"] == "X"}
    assert CATEGORIES <= cats, sorted(cats)


def test_trace_names_cover_the_reference(runs):
    def names(path):
        return {(e["ph"], e["name"]) for e in _events(path)["traceEvents"]
                if e["ph"] in ("X", "i")}

    ref = names(runs["tmp"] / "ref.json")
    port = names(runs["tmp"] / "port_prom.trace.json")
    assert {("i", "snapshot.publish"), ("X", "serve.topk"),
            ("X", "ingest.window")} <= ref
    assert ref <= port, sorted(ref - port)


def test_prometheus_names_cover_the_reference(runs):
    ref = _prom_names((runs["tmp"] / "ref.prom").read_text())
    port = _prom_names((runs["tmp"] / "port.prom").read_text())
    assert set(CPU_ABSENT) <= ref
    assert ref - set(CPU_ABSENT) <= port, sorted(ref - port)
    assert not set(CPU_ABSENT) & port


def test_json_metrics_load_and_cover_the_reference(runs):
    with open(runs["tmp"] / "port.json") as f:
        doc = json.load(f)
    assert set(doc) == {"counters", "gauges", "histograms"}
    ref = _json_names(runs["ref_json_metrics"])
    assert ref - set(CPU_ABSENT) <= _json_names(doc)
    assert doc["counters"]["serve_requests_total"] == 4
    assert doc["counters"]["ingest_batches_total"] == 4


def test_summary_line_parses(runs):
    for fmt in ("prom", "json"):
        last = runs[f"stdout_{fmt}"].strip().splitlines()[-1]
        assert last.startswith("summary ")
        summary = json.loads(last[len("summary "):])
        assert summary["waves"] == 4 and summary["device"] == "cpu"
        # the CPU takes the plain versions: no kernel launches
        assert not any(summary["launches"].values())
        assert CATEGORIES <= set(summary["span_categories"])
        evs = _events(runs["tmp"] / f"port_{fmt}.trace.json")["traceEvents"]
        assert summary["trace_events"] == sum(e["ph"] in ("X", "i")
                                              for e in evs)
        assert summary["drift"] == {}
    assert not obs.enabled()            # the script turns obs off after


def test_trace_cli_wants_a_gpu_without_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load("ranky_trace_torch").main([str(tmp_path / "t.json")])
    assert not obs.enabled()


def test_obs_off_serve_topk_is_the_direct_call():
    """With obs off, serve_topk answers what ranker.score_topk answers on
    the same snapshot, bit for bit, and records nothing."""
    assert not obs.enabled()
    obs.reset()
    rng = np.random.default_rng(3)
    cfg = api.SolveConfig(method="none", truncate_rank=8)
    batches = [torch.from_numpy(rng.normal(size=(32, 512))
                                .astype(np.float32)) for _ in range(3)]
    state = api.svd_stream(batches, cfg, device="cpu").state
    handle = api.serve_init(state, api.ServeTopKConfig(batch_size=8,
                                                       k_top=5))
    scfg = handle.config
    for w in range(3):
        q = torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32))
        got = api.serve_topk(handle, q)
        want = ranker.score_topk(handle.read(), q, scfg.k_top,
                                 block_n=scfg.block_n, sharded=False,
                                 use_kernel=scfg.use_kernel)
        assert torch.equal(got.scores, want.scores)
        assert torch.equal(got.indices, want.indices)
        assert got.version == want.version
    assert obs.trace.events() == []
    reg = obs.registry()
    assert reg.counter_value("serve_requests_total") == 0
    assert reg.export_json() == {"counters": {}, "gauges": {},
                                 "histograms": {}}
