"""The benchmark's harness on the CPU: names, lookup by name, what a new
cell file needs, the frozen counts, the imports, the command without a
card, and one run of every cell at a small size."""
from __future__ import annotations

import ast
import importlib
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import bipartite, spec
from perfbench.counts import sketch_panel, sparse_gram, topk_score
from perfbench.tests import helpers

ROOT = spec.ROOT
BENCH = spec.benchmark()
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def check_names(bench: dict):
    """What in ``bench`` breaks the naming rules of the benchmark's
    contract (names, units, ``better``, ``source``); empty when nothing."""
    bad = []
    names = {"configs": set(), "workloads": set(), "metrics": set(),
             "pairs": set()}

    def name(x, what):
        if not isinstance(x, str) or not NAME_RE.match(x):
            bad.append(f"{what}: bad name {x!r}")

    for c in bench["configs"]:
        name(c["name"], "config")
        for k in c["reduced"]:
            name(k, f"config {c['name']} reduced")
        names["configs"].add(c["name"])
    for w in bench["workloads"]:
        name(w["name"], "workload")
        name(w["config"], f"workload {w['name']} config")
        name(w["traffic"], f"workload {w['name']} traffic")
        if w["config"] not in names["configs"]:
            bad.append(f"workload {w['name']}: unknown config {w['config']}")
        if (w["config"], w["traffic"]) in names["pairs"]:
            bad.append(f"workload {w['name']}: config and traffic given "
                       f"twice")
        names["pairs"].add((w["config"], w["traffic"]))
        if w["chips"] not in (1, 4):
            bad.append(f"workload {w['name']}: chips {w['chips']}")
        names["workloads"].add(w["name"])
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            name(m["name"], group)
            if m["name"] in names["metrics"]:
                bad.append(f"{group}: {m['name']} twice")
            names["metrics"].add(m["name"])
            if not UNIT_RE.match(m["unit"]):
                bad.append(f"{m['name']}: bad unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                bad.append(f"{m['name']}: better {m['better']!r}")
            sources = {"host_clock", "device_trace"} | (
                {"program_span", "program_counter"}
                if group == "per_layer" else set())
            if m["source"] not in sources:
                bad.append(f"{m['name']}: source {m['source']!r}")
            for w in m.get("workloads", ()):
                if w not in names["workloads"]:
                    bad.append(f"{m['name']}: unknown cell {w}")
    return bad


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_names_and_units_follow_the_contract():
    assert check_names(BENCH) == []
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert len(m["unit"]) <= 16
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for w in BENCH["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_every_cell_finds_its_parts_by_name():
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"])
        assert cell["config"]["name"] == w["config"]
        kind = cell["workload"]["kind"]
        for fn in ("setup", "window", "check", "control", "free_program"):
            assert callable(getattr(spec.traffic(cell["workload"]), fn))
        assert importlib.import_module(f"perfbench.reference.{kind}").__doc__
        assert cell["per_layer"], w["name"]
        for m in cell["per_layer"]:
            assert callable(spec.layer_reader(m["name"]).read)
        reported = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2


def test_every_metric_moves_an_end_to_end_metric_of_its_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        for w in m["workloads"]:
            assert spec.reports(target, w), (m["name"], w)


def test_a_new_cell_is_files_and_an_entry(tmp_path):
    """A cell added in a copy of the checkout runs with no edit to any
    file already there: its file under workloads/, its entry in
    BENCHMARK.json, and a per-layer reader of its own."""
    (tmp_path / "perfbench" / "workloads").mkdir(parents=True)
    (tmp_path / "perfbench" / "layer_metrics").mkdir()
    shutil.copytree(ROOT / "perfbench" / "configs",
                    tmp_path / "perfbench" / "configs")
    bench = json.loads(json.dumps(BENCH))
    why = "a second exact cell, added as data only"
    bench["workloads"].append(dict(name="sparse-2048x1m.pool2",
                                   config="sparse-2048x1m", traffic="pool2",
                                   chips=1, why=why))
    bench["per_layer"].append(dict(
        name="solves_seen.pool2", unit="solves", better="higher",
        source="program_counter",
        layer="Front door and planner (core/api.py, core/planner.py)",
        moves="solve_ms", workloads=["sparse-2048x1m.pool2"]))
    bench["end_to_end"][0]["workloads"].append("sparse-2048x1m.pool2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    wl = json.loads((ROOT / "perfbench" / "workloads" /
                     "sparse-2048x1m.exact.json").read_text())
    wl.update(traffic="pool2", why=why, pool=2, checked=1)
    (tmp_path / "perfbench" / "workloads" /
     "sparse-2048x1m.pool2.json").write_text(json.dumps(wl))
    (tmp_path / "perfbench" / "layer_metrics" /
     "solves_seen.pool2.py").write_text(
        "def read(td):\n    return float(td.count('solve'))\n")
    assert check_names(bench) == []
    cell = spec.cell("sparse-2048x1m.pool2", root=tmp_path)
    assert cell["workload"]["pool"] == 2
    assert [m["name"] for m in cell["per_layer"]] == ["solves_seen.pool2"]
    reader = spec.layer_reader("solves_seen.pool2", root=tmp_path)
    cell["config"].update(helpers.cpu_size("sparse-2048x1m"))
    out = helpers.run_tiny("sparse-2048x1m.pool2", cell=cell)
    assert out["correct"] and set(out["metrics"]) == {"solve_ms",
                                                      "setup_s"}
    assert reader.read(type("T", (), {"count": lambda self, op: 3})()) == 3


def _add_configuration(root: pathlib.Path, name: str, cpu_size=None):
    """A copy of the checkout's benchmark files under ``root`` with one
    configuration more, ``name`` (sparse-2048x1m's model at 1,024 rows),
    and one exact cell of it, ``<name>.exact``; with ``cpu_size``, the
    configuration's CPU size too."""
    for sub in ("configs", "workloads"):
        shutil.copytree(ROOT / "perfbench" / sub, root / "perfbench" / sub)
    shutil.copytree(helpers.cpu_size_file("sparse-2048x1m").parent,
                    helpers.cpu_size_file(name, root).parent)
    conf = json.loads((ROOT / "perfbench" / "configs" /
                       "sparse-2048x1m.json").read_text())
    conf.update(name=name, rows=1024)
    (root / "perfbench" / "configs" / f"{name}.json").write_text(
        json.dumps(conf))
    if cpu_size is not None:
        helpers.cpu_size_file(name, root).write_text(json.dumps(cpu_size))
    cell = f"{name}.exact"
    why = "an exact cell of a configuration added as files only"
    wl = json.loads((ROOT / "perfbench" / "workloads" /
                     "sparse-2048x1m.exact.json").read_text())
    wl.update(config=name, why=why)
    (root / "perfbench" / "workloads" / f"{cell}.json").write_text(
        json.dumps(wl))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(
        name=name, source=BENCH["configs"][0]["source"],
        file=f"perfbench/configs/{name}.json", reduced=["rows", "cols"],
        why="sparse-2048x1m's model at half its rows"))
    bench["workloads"].append(dict(name=cell, config=name, traffic="exact",
                                   chips=1, why=why))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "sparse-2048x1m.exact" in m.get("workloads", ()):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench, cell


def test_every_configuration_has_a_cpu_size(tmp_path):
    """Each configuration names the keys of its file that a CPU run cuts;
    one without a CPU size is refused by name, never run at full size."""
    for c in BENCH["configs"]:
        size = helpers.cpu_size(c["name"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert size and set(size) <= set(conf), c["name"]
        assert set(c["reduced"]) <= set(size), c["name"]
    _, cell = _add_configuration(tmp_path, "sparse-1024x1m")
    with pytest.raises(FileNotFoundError, match="'sparse-1024x1m'"):
        helpers.tiny(cell, root=tmp_path)


def test_a_new_configuration_is_files_only(tmp_path):
    """A configuration added in a copy of the checkout, with its CPU size
    and a cell, runs at its CPU size with no edit to any file already
    there."""
    bench, cell = _add_configuration(
        tmp_path, "sparse-1024x1m",
        cpu_size=dict(rows=48, cols=2048, density=0.03))
    assert check_names(bench) == []
    tiny = helpers.tiny(cell, root=tmp_path)
    assert (tiny["config"]["rows"], tiny["config"]["cols"]) == (48, 2048)
    out = helpers.run_tiny(cell, cell=tiny)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"solve_ms", "setup_s"}


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_the_cpu_size_takes_the_cells_route(name):
    """At its CPU size a cell's plan is the strategy its file wants, and
    a cell whose why names the repair of lonely rows has some in every
    block of every matrix of its pool."""
    from perfbench import common
    from perfbench.traffic import solve
    from repro_torch.core import api, ranky

    cell = helpers.tiny(name)
    ctx = common.Context(name=name, seed=helpers.SEED, seconds=0.3,
                         trace=False, device=torch.device("cpu"),
                         config=cell["config"], workload=cell["workload"])
    data = solve.make_data(ctx)
    cfg = solve._solve_config(ctx)
    want = cell["workload"]["solve"]["strategy"]
    for ell in data["ells"]:
        assert api.plan(ell, cfg, device="cpu").strategy == want
        if "lonely rows" in cell["entry"]["why"]:
            assert min(ranky.lonely_rows_per_block(
                ell, cfg.num_blocks)) > 0, name


def test_frozen_counts_equal_hand_counts():
    # Columns 0, 1, 2 of a 4 x 6 matrix in 2 blocks hold 2, 1 and 3
    # entries: 6 non-zeros, 4 + 1 + 9 = 14 pairs, 3 stored columns.
    rows = torch.tensor([0, 2, 1, 0, 1, 3])
    cols = torch.tensor([0, 0, 1, 4, 4, 4])
    st = bipartite.stats(rows, cols, 4, 6, 2)
    assert (st.nnz, st.pairs, st.stored_cols) == (6, 14, 3)
    # sparse_gram: a multiply-add a pair; 8 bytes a non-zero, 2 * 4 * 4
    # floats out.
    assert sparse_gram.work(6, 14, 4, 2) == (28.0, 48.0 + 128.0)
    # sketch_panel, L = 3: Omega 3 x 4, the non-zeros, 3 x 3 panel floats.
    assert sketch_panel.work(6, 3, 3, 4) == (36.0, 48.0 + 48.0 + 36.0)
    # topk_score: 2 queries x 10 items x 3 factors; v, q, top-2 answers.
    assert topk_score.work(2, 10, 3, 2) == (120.0, 120.0 + 24.0 + 32.0)
    ms, by = sparse_gram.least_seconds(6, 14, 4, 2)
    assert by == "bytes" and ms == pytest.approx(176.0 / 3.35e12)
    ms, by = topk_score.least_seconds(256, 1 << 20, 64, 100)
    assert by == "operations" and ms == pytest.approx(
        2.0 * 256 * (1 << 20) * 64 / 67e12)


def _top_level_imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "perfbench").rglob("*.py"))
    assert len(files) > 20
    for path in files:
        found = set(_top_level_imports(path)) & (FORBIDDEN | {"benchmarks"})
        assert not found, (path, found)
    for path in (ROOT / "perfbench" / "reference").rglob("*.py"):
        assert "repro_torch" not in set(_top_level_imports(path)), path


def test_run_without_a_card_exits_nonzero_with_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
         "sparse-2048x1m.exact", "--seed", str(2 ** 31 + 7), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=120,
        env=env, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_a_small_run_of_each_cell_is_correct(name):
    out = helpers.run_tiny(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    cell = spec.cell(name)
    assert set(out["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(cell["workload"]["limits"])


def test_a_traced_run_reports_per_layer_metrics_only():
    out = helpers.run_tiny("sparse-2048x1m.exact", trace=True)
    cell = spec.cell("sparse-2048x1m.exact")
    names = {m["name"] for m in cell["per_layer"]}
    # On the CPU there is no device trace: spans and shares of the window
    # are read, rooflines find nothing and are left out.
    assert set(out["metrics"]) <= names
    assert "repair_ms.solve" in out["metrics"]
    assert "sparse_gram_roofline.solve" not in out["metrics"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_host_paced_cell_reports_its_own_group():
    """The paper's cell reports the traffic's solve time as
    ``solve_ms.host_paced`` and its layers as ``<quantity>.host_paced``,
    read as their ``.solve`` twins read them."""
    name = "ranky-paper.exact"
    cell = spec.cell(name)
    assert {m["name"] for m in cell["end_to_end"]} == {
        "solve_ms.host_paced", "setup_s"}
    out = helpers.run_tiny(name, trace=True)
    assert out["correct"], out["checks"]
    assert {"repair_ms.host_paced", "gram_ms.host_paced",
            "merge_ms.host_paced"} <= set(out["metrics"])
    assert all(k.endswith(".host_paced") for k in out["metrics"])


def test_same_seed_same_data():
    gen = lambda: bipartite.generator("cpu", 2 ** 33 + 1, 0)  # noqa: E731
    a = bipartite.random_bipartite(32, 512, 0.05, gen(), "cpu")
    b = bipartite.random_bipartite(32, 512, 0.05, gen(), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    rows, cols = a
    assert torch.all(cols[1:] >= cols[:-1])
    assert torch.bincount(rows, minlength=32).min() > 0
