"""Find everything of a cell by name: ``BENCHMARK.json``, the cell's file
under ``workloads/``, its configuration under ``configs/``, its traffic
module under ``traffic/`` (which imports ``reference/<kind>.py``) and the
readers of its per-layer metrics under ``layer_metrics/``.

A later cell, configuration, traffic kind or metric is a new file and an
entry in ``BENCHMARK.json``; nothing here names one of them.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import re
from types import ModuleType
from typing import List, Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def cell(name: str, bench: Optional[dict] = None,
         root: pathlib.Path = ROOT) -> dict:
    """Everything the run of cell ``name`` needs: its BENCHMARK.json entry
    (``entry``), its file (``workload``: traffic parameters and the limits
    of ``correct``), its configuration (``config``) and its metrics."""
    bench = benchmark(root) if bench is None else bench
    entry = _by_name(bench["workloads"], name, "workload")
    conf = _by_name(bench["configs"], entry["config"], "config")
    workload = _json(root / "perfbench" / "workloads" / f"{name}.json")
    for key in ("traffic", "config", "chips", "why"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: {key} {workload[key]!r} in its "
                             f"file, {entry[key]!r} in BENCHMARK.json")
    return dict(
        name=name, entry=entry, workload=workload,
        config=_json(root / conf["file"]),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)])


def reports(metric: dict, cell_name: str) -> bool:
    """Whether a cell reports a metric: every cell, or those it lists."""
    return "workloads" not in metric or cell_name in metric["workloads"]


def _load_file(path: pathlib.Path, tag: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    mod_name = "perfbench._loaded." + re.sub(r"\W", "_", f"{tag}_{path.stem}")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic(workload: dict) -> ModuleType:
    """The module of a cell's traffic kind (``workload["kind"]``), the
    one general driver that reads the cell's parameters."""
    return importlib.import_module(f"perfbench.traffic.{workload['kind']}")


def layer_reader(metric: str, root: pathlib.Path = ROOT) -> ModuleType:
    """The reader of a per-layer metric, ``layer_metrics/<metric>.py``
    (a metric's name may hold dots, so it is loaded by path)."""
    return _load_file(root / "perfbench" / "layer_metrics" / f"{metric}.py",
                      "layer")


def counts(kernel: str) -> ModuleType:
    return importlib.import_module(f"perfbench.counts.{kernel}")
