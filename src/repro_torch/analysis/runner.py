"""The ranky-lint driver: file discovery, the two-pass analysis, and
suppression filtering.

Pass 1 parses every file into a :class:`ModuleInfo` (imports, region
fixpoint, declared axes).  Pass 2 builds the :class:`ProjectContext`
from *all* modules — so a mesh axis declared in ``stream/state.py``
legalizes a collective in ``stream/window.py`` — and then runs every
rule over every module.  Findings on suppressed lines are dropped here,
never inside a rule.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis.core import Finding, all_rules
from repro_torch.analysis.regions import (ModuleInfo, ProjectContext,
                                         build_module)
from repro_torch.analysis.suppress import collect_suppressions

__all__ = ["AnalysisResult", "discover_files", "analyze_paths",
           "analyze_sources"]

_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules",
              ".pytest_cache", "build", "dist"}


@dataclasses.dataclass
class AnalysisResult:
    findings: List[Finding]
    files_analyzed: int
    errors: List[str]

    @property
    def exit_code(self) -> int:
        """0 clean, 1 findings, 2 analysis errors (unparseable files)."""
        if self.errors:
            return 2
        return 1 if self.findings else 0


def discover_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for path in paths:
        if os.path.isfile(path):
            out.append(path)
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs
                             if d not in _SKIP_DIRS
                             and not d.startswith("."))
            out.extend(os.path.join(root, f) for f in sorted(files)
                       if f.endswith(".py"))
    return sorted(set(out))


def _select_rules(select: Optional[Sequence[str]],
                  disable: Optional[Sequence[str]]):
    rules = all_rules()
    if select:
        wanted = {r.upper() for r in select}
        rules = [r for r in rules if r.id in wanted]
    if disable:
        dropped = {r.upper() for r in disable}
        rules = [r for r in rules if r.id not in dropped]
    return rules


def analyze_sources(sources: Sequence[Tuple[str, str]],
                    select: Optional[Sequence[str]] = None,
                    disable: Optional[Sequence[str]] = None
                    ) -> AnalysisResult:
    """Analyze in-memory ``(path, source)`` pairs as one project.  Used
    by the test suite's mutation checks; :func:`analyze_paths` is the
    filesystem front door."""
    modules: List[ModuleInfo] = []
    errors: List[str] = []
    for path, source in sources:
        try:
            modules.append(build_module(path, source))
        except SyntaxError as exc:                    # pragma: no cover
            errors.append(f"{path}: {exc.msg} (line {exc.lineno})")
    project = ProjectContext(modules)
    rules = _select_rules(select, disable)
    findings: List[Finding] = []
    for m in modules:
        sup = collect_suppressions(m.source)
        for rule in rules:
            for f in rule.check(m, project):
                if not sup.is_suppressed(f.rule, f.line):
                    findings.append(f)
    findings.sort()
    return AnalysisResult(findings, len(modules), errors)


def analyze_paths(paths: Iterable[str],
                  select: Optional[Sequence[str]] = None,
                  disable: Optional[Sequence[str]] = None
                  ) -> AnalysisResult:
    sources: List[Tuple[str, str]] = []
    errors: List[str] = []
    for path in discover_files(paths):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                sources.append((path, fh.read()))
        except OSError as exc:                        # pragma: no cover
            errors.append(f"{path}: {exc}")
    result = analyze_sources(sources, select=select, disable=disable)
    result.errors = errors + result.errors
    return result
