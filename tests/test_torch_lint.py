"""Tests for the port's ranky-lint (src/repro_torch/analysis): per-rule
true positives/negatives from inline fixtures, the sync kinds of RL101
and RL107, the regions, the suppression round-trip, the window.py
host-sync mutation regression, the sweep-clean guarantee over
src/repro_torch, and the reports against the reference's."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.analysis import (Finding, all_rules, analyze_paths,
                                  analyze_sources)
from repro_torch.analysis.regions import build_module
from repro_torch.analysis.report import render_json, render_text
from repro_torch.analysis.suppress import collect_suppressions

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
RULE_IDS = ("RL101", "RL102", "RL103", "RL104", "RL105", "RL107", "RL108")


def _src(text: str) -> str:
    return textwrap.dedent(text).lstrip("\n")


# One true positive and one true negative per rule, each analyzed under a
# path in the rule's scope: RL107 / RL108 under a hot-path directory,
# RL102 under the port's package.
FIXTURES = {
    "RL101": ("src/repro_torch/fixtures/rl101.py", _src('''
        import torch

        @torch.compile
        def step(x, n):
            a = x.sum().item()                  # RL101
            b = x.tolist()                      # RL101
            c = x.cpu()                         # RL101
            d = x.numpy()                       # RL101
            torch.cuda.synchronize()            # RL101
            e = float(x.max())                  # RL101
            f = int(x[0])                       # RL101
            g = bool(x.any())                   # RL101
            return a, b, c, d, e, f, g
        '''), _src('''
        import torch

        @torch.compile
        def step(x):
            rows = int(x.shape[0])              # static: a shape
            return x * rows, float(x.numel())   # static: numel()

        def eager(x):
            return x.sum().item()               # eager host code
        ''')),
    "RL102": ("src/repro_torch/fixtures/rl102.py", _src('''
        import torch

        def omega(shape):
            return torch.randn(shape)                     # RL102: global

        def noise(x):
            return x.normal_()                            # RL102: global

        def per_batch(batches, seed):
            out = []
            for b in batches:
                g = torch.Generator().manual_seed(seed)   # RL102: same seed
                out.append(torch.rand(b.shape, generator=g))
            return out
        '''), _src('''
        import torch

        def omega(shape, gen):
            return torch.randn(shape, generator=gen)

        def noise(x, gen):
            return x.normal_(generator=gen)

        def per_batch(batches, seed):
            out = []
            for b, x in enumerate(batches):
                g = torch.Generator().manual_seed(seed + b)
                out.append(torch.rand(x.shape, generator=g))
            return out
        ''')),
    "RL103": ("src/repro_torch/fixtures/rl103.py", _src('''
        from repro_torch.core.collectives import LocalMesh

        STREAM_AXIS = "blocks"

        def reduce(x, mesh):
            return mesh.psum(x, "model")                  # RL103: undeclared
        '''), _src('''
        from repro_torch.core.collectives import LocalMesh

        STREAM_AXIS = "blocks"

        def reduce(x, axes):
            mesh = LocalMesh({"pod": 2, "model": 4}, "cpu")
            y = mesh.psum(x, ("pod", "model"))
            z = mesh.all_gather(y, STREAM_AXIS, over=("blocks",))
            return mesh.block_mesh(axes), z               # a variable: silent
        ''')),
    "RL104": ("src/repro_torch/fixtures/rl104.py", _src('''
        def gram(coo, t):
            dense = coo.todense()                         # RL104
            return dense @ dense.T, t.to_dense()          # RL104
        '''), _src('''
        def gram(mv, v):
            return mv(mv(v))
        ''')),
    "RL105": ("src/repro_torch/fixtures/rl105.py", _src('''
        import torch

        def body(x):
            if x.sum() > 0:                               # RL105
                return x
            return -x

        def capture(g, x):
            with torch.cuda.graph(g):
                y = body(x)
                while torch.any(y < 0):                   # RL105
                    y = y + 1
            return y
        '''), _src('''
        import torch

        @torch.compile
        def body(x, flag: bool):
            if flag and x.shape[0] > 2:
                return torch.where(x.sum() > 0, x, -x)
            return x

        def eager(x):
            if x.sum() > 0:                               # eager: fine
                return x
            return -x
        ''')),
    "RL107": ("src/repro_torch/serve/fixture.py", _src('''
        import torch

        def serve_loop(handle, waves):
            out = []
            for wave in waves:
                res = handle.topk(wave)
                torch.cuda.synchronize()                  # RL107
                out.append(res.indices.cpu())             # RL107
                out.append(res.scores.tolist())           # RL107
            return out

        def ingest_loop(state, batches, update):
            total = 0.0
            while batches:
                state, info = update(state, batches.pop())
                total += float(info.residual)             # RL107
                probe = state.s.numpy()                   # RL107
                first = state.s[0].item()                 # RL107
                lonely = info.mask.nonzero()              # RL107
                ids = torch.unique(info.ids)              # RL107
                picked = torch.masked_select(info.ids, info.mask)  # RL107
                stop = bool(info.done)                    # RL107
                if int(info.count) > 2:                   # RL107
                    break
            return state, total, probe, first, lonely, ids, picked, stop
        '''), _src('''
        import torch

        def serve_loop(handle, waves):
            out = []
            for wave in waves:
                out.append(handle.topk(wave))
            torch.cuda.synchronize()                      # after the loop
            return [r.scores.cpu() for r in out][-1].tolist()

        def ingest_loop(state, batches, update):
            counts = []
            for b in batches:
                state, info = update(state, b)
                counts.append(info.count)
                rows = int(b.shape[0])                    # static
            return state, torch.stack(counts).tolist(), rows
        ''')),
    "RL108": ("src/repro_torch/serve/clock_fixture.py", _src('''
        import time

        def wave(handle, q):
            t0 = time.perf_counter()                      # RL108
            res = handle.topk(q)
            print("wave", time.time() - t0)               # RL108 x2
            return res
        '''), _src('''
        from repro_torch.obs import clock

        def wave(handle, q):
            t0 = clock.now()
            res = handle.topk(q)
            return res, clock.now() - t0
        ''')),
}


def _analyze(rule_id, which, path=None):
    fpath, pos, neg = FIXTURES[rule_id]
    return analyze_sources([(path or fpath, pos if which == "pos" else neg)])


def _hits(result, rule_id):
    return [f for f in result.findings if f.rule == rule_id]


def _messages(result, rule_id):
    return " ".join(f.message for f in _hits(result, rule_id))


# ---------------------------------------------------------------------------
# per-rule fixtures
# ---------------------------------------------------------------------------

def test_registry_holds_the_port_rules_and_no_rl106():
    ids = [r.id for r in all_rules()]
    assert ids == list(RULE_IDS) == sorted(FIXTURES)
    assert "RL106" not in ids


@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_rule_true_positive(rule_id):
    assert _hits(_analyze(rule_id, "pos"), rule_id), \
        f"{rule_id} did not fire on its positive fixture"


@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_rule_true_negative(rule_id):
    result = _analyze(rule_id, "neg")
    assert not result.findings, \
        [f.render() for f in result.findings]


def test_rl101_positive_catches_every_sync_kind():
    result = _analyze("RL101", "pos")
    msgs = _messages(result, "RL101")
    for kind in (".item()", ".tolist()", ".cpu()", ".numpy()",
                 "torch.cuda.synchronize()", "float()", "int()", "bool()"):
        assert kind in msgs, f"RL101 missed {kind}"
    assert len(_hits(result, "RL101")) == 8
    assert all("'step'" in f.message for f in _hits(result, "RL101"))


@pytest.mark.parametrize("root", [
    "@torch.compile\ndef f(x):\n    return g(x)\n",
    "@torch.compile(mode='reduce-overhead')\ndef f(x):\n    return g(x)\n",
    "@functools.partial(torch.compile, fullgraph=True)\n"
    "def f(x):\n    return g(x)\n",
    "def f(x):\n    return g(x)\n\nfast = torch.compile(f)\n",
    "def f(x):\n    return g(x)\n\n"
    "fast = torch.cuda.make_graphed_callables(f, (x0,))\n",
    "def f(gr, x):\n    with torch.cuda.graph(gr):\n        return g(x)\n",
])
def test_regions_reach_the_helper_a_root_calls(root):
    """Every region root, and the module-local helper it calls, are in a
    region: the helper's sync is an RL101 finding (twin of the
    reference's scan-step region test)."""
    src = ("import functools\nimport torch\n\n"
           "def g(x):\n    return x.sum().item()\n\n" + root)
    m = build_module("src/repro_torch/fixtures/root.py", src)
    regions = {fi.qualname for fi in m.functions.values() if fi.in_region}
    assert "g" in regions
    hits = _hits(analyze_sources([("src/repro_torch/fixtures/root.py",
                                   src)]), "RL101")
    assert [f.line for f in hits] == [5] and "'g'" in hits[0].message


def test_eager_port_has_no_region():
    """The port runs eagerly today: no function of its tree is a region,
    so RL101 / RL105 have nothing to look at."""
    from repro_torch.analysis.runner import discover_files
    for path in discover_files([os.path.join(REPO, "src", "repro_torch")]):
        with open(path, encoding="utf-8") as fh:
            m = build_module(path, fh.read())
        assert not any(fi.in_region for fi in m.functions.values()), path
        assert not m.captures, path


def test_rl102_catches_global_draws_and_a_loop_invariant_seed():
    msgs = _messages(_analyze("RL102", "pos"), "RL102")
    assert "torch.randn draws from the global generator" in msgs
    assert "Tensor.normal_ draws from the global generator" in msgs
    assert "re-seeded from 'seed'" in msgs


@pytest.mark.parametrize("declare", [
    'MODEL_AXIS = "model"\n',
    'm = LocalMesh({"model": 4}, "cpu")\n',
    'm = ProcessGroupMesh([("pod", 2), ("model", 2)])\n',
    'p = ElasticPlan((2, 4), ("data", "model"), 0)\n',
])
def test_rl103_axis_declarations(declare):
    """Each way a mesh axis is declared makes the collective legal; the
    declaration may live in another analyzed file."""
    use = ("def reduce(x, mesh):\n"
           "    return mesh.psum(x, 'model')\n")
    bad = analyze_sources([("src/repro_torch/a.py", use),
                           ("src/repro_torch/b.py", 'X_AXIS = "blocks"\n')])
    assert [f.rule for f in bad.findings] == ["RL103"]
    assert "declares only ['blocks']" in bad.findings[0].message
    good = analyze_sources([("src/repro_torch/a.py", use),
                            ("src/repro_torch/b.py", declare)])
    assert not good.findings


def test_rl104_whitelists_test_paths():
    # The same densifying source is legal when it lives under tests/
    result = _analyze("RL104", "pos", path="tests/test_oracle.py")
    assert not _hits(result, "RL104")
    assert len(_hits(_analyze("RL104", "pos"), "RL104")) == 2


def test_rl107_positive_catches_every_sync_kind():
    result = _analyze("RL107", "pos")
    msgs = _messages(result, "RL107")
    for kind in ("torch.cuda.synchronize()", ".cpu()", ".tolist()",
                 "float()", ".numpy()", ".item()", ".nonzero()",
                 "torch.unique", "torch.masked_select", "bool()", "int()"):
        assert kind in msgs, f"RL107 missed {kind}"
    assert len(_hits(result, "RL107")) == 11


def test_rl107_is_scoped_to_hot_path_directories():
    # The same syncing loops are legal host code outside serve/stream
    # (core/, benchmarks, examples, checkpoint restore...).
    for path in ("src/repro_torch/core/driver.py",
                 "src/repro_torch/ft/loop.py", "scripts/loop.py"):
        assert not _hits(_analyze("RL107", "pos", path=path), "RL107")
    assert _hits(_analyze("RL107", "pos",
                          path="src/repro_torch/stream/loop.py"), "RL107")


def test_rl107_suppression():
    src = FIXTURES["RL107"][1]
    silenced = "\n".join(
        line + "  # ranky-lint: disable=RL107" if "# RL107" in line
        else line for line in src.splitlines())
    result = analyze_sources([("src/repro_torch/serve/loop.py", silenced)])
    assert not _hits(result, "RL107")


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

SUPPRESSED = _src('''
    import torch

    def oracle_gram(coo):
        dense = coo.todense()  # ranky-lint: disable=RL104
        return dense.T @ dense

    def init(shape):
        return torch.randn(shape)  # ranky-lint: disable=RL102

    @torch.compile
    def probe(x):
        return float(x.sum())  # ranky-lint: disable=RL101,RL105
    ''')


def test_suppression_round_trip():
    path = "src/repro_torch/fixtures/suppressed.py"
    clean = analyze_sources([(path, SUPPRESSED)])
    assert clean.findings == [], [f.render() for f in clean.findings]

    # strip the directives -> every silenced finding comes back
    stripped = "\n".join(line.split("# ranky-lint:")[0].rstrip()
                         for line in SUPPRESSED.splitlines())
    dirty = analyze_sources([(path, stripped)])
    assert {f.rule for f in dirty.findings} == {"RL104", "RL102", "RL101"}


def test_file_level_suppression():
    src = ("# ranky-lint: disable-file=RL104\n"
           "def gram(coo):\n"
           "    return coo.todense()\n")
    result = analyze_sources([("src/fixtures/file_sup.py", src)])
    assert result.findings == []


def test_directive_in_string_literal_is_inert():
    src = ('DOC = "# ranky-lint: disable-file=RL104"\n'
           "def gram(coo):\n"
           "    return coo.todense()\n")
    result = analyze_sources([("src/fixtures/str_sup.py", src)])
    assert [f.rule for f in result.findings] == ["RL104"]


def test_collect_suppressions_parses_lists():
    sup = collect_suppressions(
        "x = 1  # ranky-lint: disable=RL101, RL107 -- reason\n")
    assert sup.is_suppressed("RL101", 1)
    assert sup.is_suppressed("RL107", 1)
    assert not sup.is_suppressed("RL104", 1)
    assert not sup.is_suppressed("RL101", 2)


# ---------------------------------------------------------------------------
# the real tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rel", [
    "stream/window.py", "stream/ingest.py", "serve/ranker.py",
    "serve/snapshot.py", "ft/supervise.py",
])
def test_hot_paths_are_lint_clean_without_suppressions(rel):
    """The serving / ingest loops and the supervisor are clean with no
    suppression at all: their syncs sit after the loops or in core/."""
    path = os.path.join(REPO, "src", "repro_torch", rel)
    with open(path, encoding="utf-8") as fh:
        assert "ranky-lint:" not in fh.read()
    assert analyze_paths([path]).findings == []


def test_src_repro_torch_sweep_is_clean():
    result = analyze_paths([os.path.join(REPO, "src", "repro_torch")])
    assert result.errors == []
    assert result.files_analyzed > 70
    assert result.findings == [], "\n".join(
        f.render() for f in result.findings)


def _window_source():
    with open(os.path.join(REPO, "src", "repro_torch", "stream",
                           "window.py"), encoding="utf-8") as fh:
        return fh.read()


@pytest.mark.parametrize("inject, expect", [
    ("            _ = s[0].item()\n", ".item()"),
    ("            _ = lon.cpu()\n", ".cpu()"),
    ("            _ = float(s[0])\n", "float()"),
])
def test_rl107_mutation_regression_window(inject, expect):
    """A per-step sync put back into the window's step loop (the window
    reads the host once, after its loop) must trip RL107, naming the
    function."""
    src = _window_source()
    anchor = "            uks.append(uk)\n            ubs.append(u_b)\n"
    assert src.count(anchor) == 1           # the single-host step loop
    mutated = src.replace(anchor, inject + anchor, 1)
    result = analyze_sources([("src/repro_torch/stream/window.py", mutated)])
    hits = _hits(result, "RL107")
    assert len(hits) == 1 and expect in hits[0].message
    assert "'ingest_window.steps'" in hits[0].message
    assert not analyze_sources([("src/repro_torch/stream/window.py",
                                 src)]).findings


def test_analysis_and_scripts_import_no_jax_nor_the_reference():
    import ast
    paths = [os.path.join(REPO, "scripts", f)
             for f in ("ranky_lint_torch.py", "ranky_trace_torch.py")]
    adir = os.path.join(REPO, "src", "repro_torch", "analysis")
    paths += [os.path.join(adir, f) for f in os.listdir(adir)
              if f.endswith(".py")]
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)
                if path.startswith(adir):
                    assert top in ("__future__", "ast", "collections",
                                   "dataclasses", "io", "json", "os", "re",
                                   "tokenize", "typing",
                                   "repro_torch"), (path, name)


# ---------------------------------------------------------------------------
# reporters + CLI
# ---------------------------------------------------------------------------

def test_json_report_schema():
    result = _analyze("RL104", "pos")
    payload = json.loads(render_json(result.findings,
                                     result.files_analyzed))
    assert payload["tool"] == "ranky-lint"
    assert payload["schema_version"] == 1
    assert payload["counts"]["RL104"] == len(result.findings) == 2
    assert list(payload["rules"]) == list(RULE_IDS)
    assert all(set(f) == {"rule", "path", "line", "col", "message"}
               for f in payload["findings"])


def test_text_report_mentions_counts():
    result = _analyze("RL104", "pos")
    text = render_text(result.findings, result.files_analyzed)
    assert "RL104: 2" in text and "finding(s)" in text
    assert render_text([], 3).endswith("clean — 0 findings in 3 file(s)")


@pytest.mark.parametrize("fmt", ["json", "text"])
def test_reports_match_the_reference(fmt):
    """Given the same findings, the port's reporters write what the
    reference's write, field for field; the rule catalogue differs only
    by RL106, which the port does not register."""
    from repro.analysis import Finding as RefFinding
    from repro.analysis import report as ref_report

    rows = [("src/a.py", 3, 5, "RL104", "densify"),
            ("src/b.py", 1, 1, "RL107", "sync"),
            ("src/b.py", 9, 2, "RL107", "sync again")]
    ours = [Finding(*r) for r in rows]
    theirs = [RefFinding(*r) for r in rows]
    errors = ["src/c.py: invalid syntax (line 2)"]
    if fmt == "text":
        assert (render_text(ours, 4, errors)
                == ref_report.render_text(theirs, 4, errors))
        return
    a = json.loads(render_json(ours, 4, errors))
    b = json.loads(ref_report.render_json(theirs, 4, errors))
    assert list(a) == list(b)
    for key in a:
        if key != "rules":
            assert a[key] == b[key], key
    assert a["rules"] == {k: v for k, v in b["rules"].items()
                          if k != "RL106"}


def _cli():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "ranky_lint_torch", os.path.join(REPO, "scripts",
                                         "ranky_lint_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_list_rules(capsys):
    assert _cli().main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in RULE_IDS:
        assert rid in out
    assert "RL106" not in out


def test_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("def gram(coo):\n    return coo.todense()\n")
    good = tmp_path / "good.py"
    good.write_text("def gram(mv, v):\n    return mv(mv(v))\n")
    broken = tmp_path / "broken.py"
    broken.write_text("def gram(:\n")
    cli = _cli()

    assert cli.main([str(good)]) == 0
    assert cli.main([str(bad)]) == 1 and "RL104" in capsys.readouterr().out
    out = tmp_path / "report.json"
    assert cli.main(["--format", "json", "--out", str(out), str(bad)]) == 1
    assert json.loads(out.read_text())["counts"] == {"RL104": 1}
    assert cli.main(["--select", "RL107", str(bad)]) == 0
    assert cli.main(["--disable", "RL104", str(bad)]) == 0
    assert cli.main([str(broken)]) == 2

    # The script as a process: the port's tree is clean (exit 0).
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "ranky_lint_torch.py"),
         os.path.join(REPO, "src", "repro_torch")],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean — 0 findings" in proc.stdout
