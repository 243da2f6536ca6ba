"""Text and JSON reporters for ranky-lint findings.

The JSON schema is stable — CI uploads it as an artifact and downstream
tooling keys on ``findings[*].rule`` / ``counts``:

    {"tool": "ranky-lint", "schema_version": 1,
     "files_analyzed": N, "findings": [...], "counts": {"RL101": 2},
     "errors": [...]}
"""
from __future__ import annotations

import json
from collections import Counter
from typing import List, Sequence

from repro_torch.analysis.core import Finding, all_rules

__all__ = ["render_text", "render_json"]

SCHEMA_VERSION = 1


def render_text(findings: Sequence[Finding], files_analyzed: int,
                errors: Sequence[str] = ()) -> str:
    lines: List[str] = [f.render() for f in findings]
    lines.extend(f"error: {e}" for e in errors)
    counts = Counter(f.rule for f in findings)
    if findings:
        per_rule = ", ".join(f"{r}: {n}" for r, n in sorted(counts.items()))
        lines.append(
            f"ranky-lint: {len(findings)} finding(s) "
            f"({per_rule}) in {files_analyzed} file(s)")
    else:
        lines.append(
            f"ranky-lint: clean — 0 findings in {files_analyzed} file(s)")
    return "\n".join(lines)


def render_json(findings: Sequence[Finding], files_analyzed: int,
                errors: Sequence[str] = ()) -> str:
    counts = Counter(f.rule for f in findings)
    payload = {
        "tool": "ranky-lint",
        "schema_version": SCHEMA_VERSION,
        "rules": {r.id: r.name for r in all_rules()},
        "files_analyzed": files_analyzed,
        "findings": [f.as_dict() for f in findings],
        "counts": dict(sorted(counts.items())),
        "errors": list(errors),
    }
    return json.dumps(payload, indent=2, sort_keys=False)
