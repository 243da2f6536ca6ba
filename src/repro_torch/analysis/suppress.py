"""Suppression comments.

Syntax (on the offending line, or alone on a line for file scope):

    x = coo.todense()  # ranky-lint: disable=RL104
    y = f(a, b)        # ranky-lint: disable=RL101,RL105
    # ranky-lint: disable-file=RL104

``disable=`` silences the listed rules (or ``ALL``) on that physical
line; ``disable-file=`` silences them for the whole file.  Parsing goes
through :mod:`tokenize`, so the directive is only honored in real
comments — a string literal containing the text does nothing.
"""
from __future__ import annotations

import io
import re
import tokenize
from typing import Dict, Set, Tuple

__all__ = ["Suppressions", "collect_suppressions"]

_DIRECTIVE = re.compile(
    r"#\s*ranky-lint:\s*(disable(?:-file)?)\s*=\s*"
    r"([A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)")


class Suppressions:
    """Per-file suppression table: rule ids by line, plus file scope."""

    def __init__(self) -> None:
        self.file_level: Set[str] = set()
        self.line_level: Dict[int, Set[str]] = {}

    def is_suppressed(self, rule: str, line: int) -> bool:
        for scope in (self.file_level, self.line_level.get(line, ())):
            if rule in scope or "ALL" in scope:
                return True
        return False


def collect_suppressions(source: str) -> Suppressions:
    sup = Suppressions()
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        comments: Tuple = tuple(
            (tok.start[0], tok.string) for tok in tokens
            if tok.type == tokenize.COMMENT)
    except tokenize.TokenizeError:
        return sup
    for line, text in comments:
        match = _DIRECTIVE.search(text)
        if not match:
            continue
        rules = {r.strip().upper() for r in match.group(2).split(",")}
        if match.group(1) == "disable-file":
            sup.file_level |= rules
        else:
            sup.line_level.setdefault(line, set()).update(rules)
    return sup
