"""ranky-lint for the PyTorch/CUDA port: an AST-based static analyzer
for the port's hot-path discipline (host syncs, explicit generators,
collective axes, densify bans, captured-code hazards, the obs clock).

Public API:

    from repro_torch.analysis import analyze_paths, analyze_sources, all_rules

See ``src/repro_torch/analysis/README.md`` for the rule catalog and
``scripts/ranky_lint_torch.py`` for the CLI.  Its modules use the
standard library only: they import neither torch nor the reference
package, and they never import the files they analyze.
"""
from repro_torch.analysis.core import Finding, Rule, all_rules, get_rule
from repro_torch.analysis.runner import (AnalysisResult, analyze_paths,
                                         analyze_sources, discover_files)
from repro_torch.analysis import rules as _rules  # noqa: F401  (registers RL1xx)

__all__ = [
    "Finding", "Rule", "all_rules", "get_rule",
    "AnalysisResult", "analyze_paths", "analyze_sources", "discover_files",
]
