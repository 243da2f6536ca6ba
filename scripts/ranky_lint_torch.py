#!/usr/bin/env python
"""ranky-lint CLI for the PyTorch/CUDA port — run the port's analyzer.

Usage:
    python scripts/ranky_lint_torch.py src/repro_torch
    python scripts/ranky_lint_torch.py --format json --out ranky-lint.json src/repro_torch
    python scripts/ranky_lint_torch.py --select RL101,RL107 src/repro_torch/stream
    python scripts/ranky_lint_torch.py --list-rules

Exit codes: 0 clean, 1 unsuppressed findings, 2 analysis errors.  The
analyzer's modules use the standard library only (the AST of the files,
nothing of them is imported), so it runs the same on the CPU and on a
GPU host.
"""
from __future__ import annotations

import argparse
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_HERE), "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

from repro_torch.analysis import all_rules, analyze_paths           # noqa: E402
from repro_torch.analysis.report import render_json, render_text    # noqa: E402


def _split_ids(value):
    return [v.strip() for v in value.split(",") if v.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ranky_lint_torch",
        description="AST-based analyzer of the port's torch discipline "
                    "(rules RL101-RL105, RL107, RL108)")
    ap.add_argument("paths", nargs="*", default=[],
                    help="files or directories to analyze")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="report format (default: text)")
    ap.add_argument("--out", metavar="FILE", default=None,
                    help="also write the report to FILE")
    ap.add_argument("--select", type=_split_ids, default=None,
                    metavar="RL101,RL102", help="run only these rules")
    ap.add_argument("--disable", type=_split_ids, default=None,
                    metavar="RL104", help="skip these rules globally")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.id}  {rule.name}\n    {rule.description}")
        return 0
    if not args.paths:
        ap.error("no paths given (try: python scripts/ranky_lint_torch.py "
                 "src/repro_torch)")

    result = analyze_paths(args.paths, select=args.select,
                           disable=args.disable)
    renderer = render_json if args.format == "json" else render_text
    report = renderer(result.findings, result.files_analyzed, result.errors)
    print(report)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(report + "\n")
    return result.exit_code


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:   # e.g. `ranky_lint_torch.py --list-rules | head`
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
