"""Findings, the rule base class and the rule registry of ranky-lint.

A *rule* is a stateless checker with a stable ``RLxxx`` id.  Rules run
against a fully-built :class:`~repro_torch.analysis.regions.ModuleInfo`
(one parsed file plus its compiled-region/call-graph analysis) and a
:class:`~repro_torch.analysis.regions.ProjectContext` (facts collected
across the whole analyzed fileset: the declared mesh axes).  They yield
:class:`Finding` records; suppression filtering and reporting happen in
``runner.py`` / ``report.py``, never inside a rule.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Type

__all__ = ["Finding", "Rule", "register_rule", "all_rules", "get_rule"]


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One diagnostic: a rule id anchored to a file:line:col."""

    path: str
    line: int
    col: int
    rule: str
    message: str

    def as_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message}

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


class Rule:
    """Base class for ranky-lint rules.

    Subclasses set ``id`` (stable ``RLxxx``), ``name`` (short slug used
    in reports) and ``description`` (one line, shown by
    ``--list-rules``), and implement :meth:`check`.
    """

    id: str = ""
    name: str = ""
    description: str = ""

    def check(self, module, project) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, module, node, message: str) -> Finding:
        return Finding(path=module.path, line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0) + 1,
                       rule=self.id, message=message)


_REGISTRY: Dict[str, Type[Rule]] = {}


def register_rule(cls: Type[Rule]) -> Type[Rule]:
    """Class decorator: add a rule to the registry (id must be unique)."""
    if not cls.id or not cls.id.startswith("RL"):
        raise ValueError(f"rule {cls.__name__} needs a stable RLxxx id")
    if cls.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {cls.id}")
    _REGISTRY[cls.id] = cls
    return cls


def all_rules() -> List[Rule]:
    """Fresh instances of every registered rule, in id order."""
    return [_REGISTRY[k]() for k in sorted(_REGISTRY)]


def get_rule(rule_id: str) -> Rule:
    return _REGISTRY[rule_id]()
