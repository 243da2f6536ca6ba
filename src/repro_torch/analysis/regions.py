"""Compiled-region analysis: which code runs *captured* rather than
eagerly.

Eager torch runs every line on the host, so a host sync there costs one
round trip.  Inside code that ``torch.compile`` traces, a sync or a
Python branch on a tensor is a graph break (or a recompile per value),
and inside a CUDA-graph capture it is illegal.  The hot-path rules
(RL101/RL105) look only there.  This module computes, per parsed file, a
conservative region map:

* **Region roots** — functions decorated or wrapped with
  ``torch.compile`` (incl. ``functools.partial(torch.compile, ...)``),
  functions handed to ``torch.cuda.make_graphed_callables``, and the
  body of a ``with torch.cuda.graph(...):`` capture (a *capture block*:
  its statements are region code, and the module-local functions it
  calls are roots).
* **Propagation** — membership flows through the *module-local* call
  graph (calls to functions defined in the same file, resolved through
  local single-assignment chains and ``functools.partial`` wrappers) to
  a fixpoint.  Cross-module calls are not followed — a deliberate
  precision/recall trade documented in the package README.

Region membership is computed once per file and shared by every rule.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterator, List, Optional, Set

from repro_torch.analysis.visitor import (
    ImportTable, attach_parents, is_compile_name, is_graph_name,
    is_partial_name, parent, string_elements, walk_skipping_functions)

__all__ = ["FunctionInfo", "CaptureBlock", "RegionUnit", "ModuleInfo",
           "ProjectContext", "build_module", "region_units"]

# Mesh constructors whose shape names the axes: a dict literal
# ({"pod": 2, "model": 4}) or (name, size) pairs.
_MESH_CLASSES = ("LocalMesh", "ProcessGroupMesh", "BlockMesh")


@dataclasses.dataclass
class FunctionInfo:
    """One function/lambda: its AST, lexical scope chain and the local
    single-assignment table used to resolve callables."""

    node: ast.AST                       # FunctionDef | Lambda
    qualname: str
    scope_parent: Optional["FunctionInfo"]
    assignments: Dict[str, ast.AST] = dataclasses.field(default_factory=dict)
    local_defs: Dict[str, "FunctionInfo"] = dataclasses.field(
        default_factory=dict)
    in_region: bool = False             # filled by the fixpoint


@dataclasses.dataclass
class CaptureBlock:
    """The body of one ``with torch.cuda.graph(...):`` statement."""

    node: ast.AST                       # With
    scope: Optional[FunctionInfo]       # the function it lies in


@dataclasses.dataclass
class RegionUnit:
    """Region code as the rules walk it: a label for messages, the scope
    that resolves its names, and its nodes (nested defs excluded)."""

    label: str
    scope: Optional[FunctionInfo]
    nodes: List[ast.AST]


class ModuleInfo:
    """One parsed file plus every shared analysis the rules consume."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.tree = tree
        self.imports = ImportTable(tree)
        self.functions: Dict[ast.AST, FunctionInfo] = {}
        self.module_defs: Dict[str, FunctionInfo] = {}
        self.captures: List[CaptureBlock] = []
        self.str_constants: Dict[str, str] = {}
        self.declared_axes: Set[str] = set()

    # -- canonical-name helpers -------------------------------------------
    def resolve(self, node: ast.AST) -> Optional[str]:
        return self.imports.resolve(node)

    def resolve_or_name(self, node: ast.AST) -> Optional[str]:
        return self.imports.resolve_or_name(node)

    # -- callable resolution ----------------------------------------------
    def resolve_callable(self, node: ast.AST,
                         scope: Optional[FunctionInfo],
                         _depth: int = 0) -> Optional[FunctionInfo]:
        """Best-effort: the FunctionInfo a callable expression refers to
        — through local assignments, nested defs, module-level defs and
        ``functools.partial`` / ``torch.compile`` wrappers.  None when the
        target is a parameter, an attribute of another module, etc."""
        if _depth > 12 or node is None:
            return None
        if isinstance(node, ast.Lambda):
            return self.functions.get(node)
        if isinstance(node, ast.Name):
            s = scope
            while s is not None:
                if node.id in s.local_defs:
                    return s.local_defs[node.id]
                if node.id in s.assignments:
                    return self.resolve_callable(
                        s.assignments[node.id], s, _depth + 1)
                s = s.scope_parent
            return self.module_defs.get(node.id)
        if isinstance(node, ast.Call):
            fn_name = self.resolve_or_name(node.func)
            if ((is_partial_name(fn_name) or is_compile_name(fn_name))
                    and node.args):
                return self.resolve_callable(node.args[0], scope, _depth + 1)
        return None

    def enclosing_function(self, node: ast.AST) -> Optional[FunctionInfo]:
        n = parent(node)
        while n is not None:
            if n in self.functions:
                return self.functions[n]
            n = parent(n)
        return None


class ProjectContext:
    """Facts aggregated across every analyzed file (two-pass)."""

    def __init__(self, modules: List[ModuleInfo]):
        self.modules = modules
        self.declared_axes: Set[str] = set()
        for m in modules:
            self.declared_axes |= m.declared_axes


# ---------------------------------------------------------------------------
# Module construction
# ---------------------------------------------------------------------------

def build_module(path: str, source: str) -> ModuleInfo:
    tree = ast.parse(source, filename=path)
    attach_parents(tree)
    m = ModuleInfo(path, source, tree)
    _collect_constants(m)
    _collect_functions(m)
    _collect_captures(m)
    _collect_axes(m)
    _region_fixpoint(m)
    return m


def _collect_constants(m: ModuleInfo) -> None:
    for node in m.tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            m.str_constants[node.targets[0].id] = node.value.value


def _collect_functions(m: ModuleInfo) -> None:
    def visit(node: ast.AST, scope: Optional[FunctionInfo], prefix: str):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{prefix}{child.name}"
                fi = FunctionInfo(child, qn, scope)
                m.functions[child] = fi
                if scope is None:
                    m.module_defs[child.name] = fi
                else:
                    scope.local_defs[child.name] = fi
                _collect_assignments(child, fi)
                visit(child, fi, qn + ".")
            elif isinstance(child, ast.Lambda):
                fi = FunctionInfo(child, f"{prefix}<lambda>", scope)
                m.functions[child] = fi
                visit(child, fi, prefix)
            elif isinstance(child, ast.ClassDef):
                visit(child, scope, f"{prefix}{child.name}.")
            else:
                visit(child, scope, prefix)

    visit(m.tree, None, "")


def _collect_assignments(fn_node: ast.AST, fi: FunctionInfo) -> None:
    """Single-assignment table for this scope (simple Name targets at
    any nesting below the function, nested defs excluded)."""
    for node in walk_skipping_functions(fn_node):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    # last writer wins; good enough for the
                    # straight-line partial/step idiom we resolve
                    fi.assignments[t.id] = node.value


def _collect_captures(m: ModuleInfo) -> None:
    for node in ast.walk(m.tree):
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(item.context_expr, ast.Call)
                and is_graph_name(m.resolve(item.context_expr.func))
                for item in node.items):
            m.captures.append(CaptureBlock(node, m.enclosing_function(node)))


def _collect_axes(m: ModuleInfo) -> None:
    """Declared mesh-axis names: ``*_AXIS`` module string constants (the
    repo's STREAM_AXIS idiom), the axis names of a ``LocalMesh`` /
    ``ProcessGroupMesh`` shape literal, and the ``axis_names`` given to
    an ``ElasticPlan``."""
    for name, val in m.str_constants.items():
        if name.endswith("_AXIS") or name.endswith("AXIS_NAME"):
            m.declared_axes.add(val)
    for node in ast.walk(m.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = m.resolve_or_name(node.func)
        if fn is None and isinstance(node.func, ast.Attribute):
            fn = node.func.attr
        tail = (fn or "").rsplit(".", 1)[-1]
        if tail in _MESH_CLASSES and node.args:
            shape = node.args[0]
            if isinstance(shape, ast.Dict):
                keys = [k for k in shape.keys if k is not None]
            elif isinstance(shape, (ast.List, ast.Tuple)):
                keys = [el.elts[0] for el in shape.elts
                        if isinstance(el, ast.Tuple) and el.elts]
            else:
                keys = []
            for k in keys:
                m.declared_axes.update(string_elements(k, m.str_constants))
        elif tail == "ElasticPlan":
            cands = list(node.args[1:2]) + [
                kw.value for kw in node.keywords if kw.arg == "axis_names"]
            for c in cands:
                m.declared_axes.update(string_elements(c, m.str_constants))


# ---------------------------------------------------------------------------
# Region fixpoint
# ---------------------------------------------------------------------------

def _region_roots(m: ModuleInfo) -> List[FunctionInfo]:
    """Every function a torch.compile / graph binding site in the module
    makes a region root."""
    out = []
    # decorator seeds
    for fi in m.functions.values():
        node = fi.node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for dec in node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            name = m.resolve_or_name(target)
            if is_compile_name(name) or (
                    isinstance(dec, ast.Call) and is_partial_name(name)
                    and dec.args
                    and is_compile_name(m.resolve_or_name(dec.args[0]))):
                out.append(fi)
    # call-site bindings
    for node in ast.walk(m.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        name = m.resolve_or_name(node.func)
        if is_compile_name(name) or (
                name == "torch.cuda.make_graphed_callables"):
            tgt = m.resolve_callable(node.args[0],
                                     m.enclosing_function(node))
            if tgt is not None:
                out.append(tgt)
    # functions called from a capture block
    for blk in m.captures:
        for st in blk.node.body:
            for n in [st, *walk_skipping_functions(st)]:
                if isinstance(n, ast.Call):
                    tgt = m.resolve_callable(n.func, blk.scope)
                    if tgt is not None:
                        out.append(tgt)
    return out


def _call_edges(m: ModuleInfo):
    """Module-local call graph: (caller FunctionInfo, callee
    FunctionInfo).  A callee is any module-local function referenced
    by a call's target OR bound into a ``functools.partial`` — either
    way its body runs under the caller's tracing context.  Lexically
    nested defs that are never referenced stay out (dead code)."""
    edges = []
    for fi in m.functions.values():
        for n in walk_skipping_functions(fi.node):
            if not isinstance(n, ast.Call):
                continue
            tgt = m.resolve_callable(n.func, fi)
            if tgt is not None and tgt is not fi:
                edges.append((fi, tgt))
            name = m.resolve_or_name(n.func)
            if is_partial_name(name) and n.args:
                tgt = m.resolve_callable(n.args[0], fi)
                if tgt is not None and tgt is not fi:
                    edges.append((fi, tgt))
    return edges


def _region_fixpoint(m: ModuleInfo) -> None:
    for fi in _region_roots(m):
        fi.in_region = True
    edges = _call_edges(m)
    changed = True
    while changed:
        changed = False
        for caller, callee in edges:
            if caller.in_region and not callee.in_region:
                callee.in_region = True
                changed = True


def region_units(m: ModuleInfo) -> Iterator[RegionUnit]:
    """Every piece of region code once: each function in a region, and
    each capture block that does not already lie in one."""
    for fi in m.functions.values():
        if fi.in_region:
            yield RegionUnit(fi.qualname, fi,
                             list(walk_skipping_functions(fi.node)))
    for blk in m.captures:
        if blk.scope is not None and blk.scope.in_region:
            continue
        where = blk.scope.qualname if blk.scope is not None else "<module>"
        nodes = [n for st in blk.node.body
                 for n in (st, *walk_skipping_functions(st))]
        yield RegionUnit(f"<graph capture in {where}>", blk.scope, nodes)
