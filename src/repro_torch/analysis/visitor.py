"""AST plumbing shared by every ranky-lint rule: parent links, an
import-alias resolver that canonicalizes dotted names (``F.relu`` ->
``torch.nn.functional.relu``), and small expression classifiers.

Everything here is *syntactic* — no imports are executed, no module
objects are touched — so the analyzer runs on any source tree, broken
imports included.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, Optional

__all__ = [
    "attach_parents", "walk_skipping_functions", "ImportTable",
    "is_compile_name", "is_graph_name", "is_partial_name",
    "string_elements",
]

_PARENT_FIELD = "_rl_parent"


def attach_parents(tree: ast.AST) -> None:
    """Annotate every node with its parent (``node._rl_parent``)."""
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            setattr(child, _PARENT_FIELD, node)


def parent(node: ast.AST) -> Optional[ast.AST]:
    return getattr(node, _PARENT_FIELD, None)


def walk_skipping_functions(node: ast.AST) -> Iterator[ast.AST]:
    """Yield ``node``'s subtree but do NOT descend into nested function
    or lambda bodies — those are separate analysis units with their own
    region membership (reached through call edges, not lexically)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            # Decorators and default expressions still belong to the
            # enclosing scope; only the body is a new unit.
            if isinstance(n, ast.Lambda):
                continue
            stack.extend(n.decorator_list)
            stack.extend(n.args.defaults)
            stack.extend(n.args.kw_defaults or [])
            continue
        stack.extend(ast.iter_child_nodes(n))


class ImportTable:
    """Maps local names to canonical dotted paths.

    ``import torch.nn.functional as F``  ->  F: torch.nn.functional
    ``from torch import linalg``         ->  linalg: torch.linalg
    ``from functools import partial``    ->  partial: functools.partial
    ``from x import y as z``             ->  z: x.y
    """

    def __init__(self, tree: ast.Module):
        self.aliases: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.aliases[a.asname or a.name] = (
                        f"{node.module}.{a.name}")

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted path of a Name/Attribute chain, or None when
        the base name is not import-bound (a local variable, a param)."""
        if isinstance(node, ast.Name):
            return self.aliases.get(node.id)
        if isinstance(node, ast.Attribute):
            base = self.resolve(node.value)
            return f"{base}.{node.attr}" if base else None
        return None

    def resolve_or_name(self, node: ast.AST) -> Optional[str]:
        """Like :meth:`resolve` but a bare un-imported Name falls back
        to its own id — lets fixtures reference builtins (``float``)."""
        out = self.resolve(node)
        if out is None and isinstance(node, ast.Name):
            return node.id
        return out


def is_compile_name(dotted: Optional[str]) -> bool:
    """``torch.compile`` (the region root of eager torch)."""
    return dotted == "torch.compile"


def is_graph_name(dotted: Optional[str]) -> bool:
    """``torch.cuda.graph`` (a capture context manager)."""
    return dotted in ("torch.cuda.graph", "torch.cuda.graphs.graph")


def is_partial_name(dotted: Optional[str]) -> bool:
    return dotted in ("functools.partial", "partial")


def string_elements(node: ast.AST, constants: Dict[str, str]) -> list:
    """String constants inside a literal / tuple-of-literals, resolving
    Names through a module-level string-constant table.  Non-resolvable
    elements are skipped (a variable axis list can't be checked)."""
    out = []
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        out.append(node.value)
    elif isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        for el in node.elts:
            out.extend(string_elements(el, constants))
    elif isinstance(node, ast.Name) and node.id in constants:
        out.append(constants[node.id])
    return out
