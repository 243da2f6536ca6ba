"""The ranky-lint rule set of the PyTorch/CUDA port: its hot-path
discipline, written down as RL101–RL105, RL107 and RL108.

The ids are the reference's where the hazard is the same: host syncs
inside captured code (RL101), randomness that a resume cannot replay
(RL102), collectives naming an axis no mesh declares (RL103), accidental
densification (RL104), Python branches on tensors inside captured code
(RL105), per-iteration host syncs in the serving/ingest hot loops
(RL107), and ad-hoc timing/printing that bypasses the observability
clock (RL108).  RL106 (pytree completeness) has no counterpart: eager
torch flattens nothing at a function boundary, and ``torch.compile``
takes dataclasses as they are.

Precision over recall: a rule stays silent when it cannot *prove* the
pattern from the AST (variable axis names, cross-module calls, values
of unknown provenance).  ``tests/test_torch_lint.py`` pins one true
positive and one true negative per rule.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.core import Finding, Rule, register_rule
from repro_torch.analysis.regions import (FunctionInfo, ModuleInfo,
                                          ProjectContext, region_units)
from repro_torch.analysis.visitor import string_elements, walk_skipping_functions

# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "itemsize",
                 "nbytes"}
_STATIC_METHODS = {"numel", "size", "dim", "element_size", "stride"}
_STATIC_FUNCS = {"len", "min", "max", "abs", "round", "sum", "divmod"}


def _dirs(m: ModuleInfo) -> List[str]:
    return m.path.replace("\\", "/").split("/")[:-1]


def _is_test_path(m: ModuleInfo) -> bool:
    """Test trees are oracle territory by construction: a 'tests'
    directory component, or a test_*/conftest.py file name."""
    name = m.path.replace("\\", "/").rsplit("/", 1)[-1]
    return ("tests" in _dirs(m) or name.startswith("test_")
            or name == "conftest.py")


def _is_static_expr(node: ast.AST, fi: Optional[FunctionInfo],
                    m: ModuleInfo, _depth: int = 0) -> bool:
    """True when an expression provably has a host value: constants,
    shape/dtype arithmetic, ``len()``, ``numel()``."""
    if _depth > 8:
        return False
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        if fi is not None and node.id in fi.assignments:
            return _is_static_expr(fi.assignments[node.id], fi, m,
                                   _depth + 1)
        return False
    if isinstance(node, ast.Attribute):
        return node.attr in _STATIC_ATTRS
    if isinstance(node, ast.Subscript):
        return _is_static_expr(node.value, fi, m, _depth + 1)
    if isinstance(node, (ast.BinOp, ast.UnaryOp, ast.BoolOp, ast.Compare,
                         ast.Tuple, ast.List, ast.IfExp)):
        return all(_is_static_expr(c, fi, m, _depth + 1)
                   for c in ast.iter_child_nodes(node)
                   if isinstance(c, ast.expr))
    if isinstance(node, ast.Call):
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _STATIC_METHODS
                and m.resolve(node.func) is None):
            return True
        name = m.resolve_or_name(node.func) or ""
        if name in _STATIC_FUNCS or name.startswith("math."):
            return all(_is_static_expr(a, fi, m, _depth + 1)
                       for a in node.args)
    return False


_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}


def _host_sync(node: ast.Call, fi: Optional[FunctionInfo],
               m: ModuleInfo) -> Optional[str]:
    """The sync kinds of RL101 (and RL107): a tensor read back to the
    host, a device-wide wait, or a Python number of a tensor."""
    if (isinstance(node.func, ast.Attribute)
            and node.func.attr in _SYNC_METHODS and not node.args
            and m.resolve(node.func) is None):
        return f".{node.func.attr}()"
    name = m.resolve_or_name(node.func)
    if name == "torch.cuda.synchronize":
        return "torch.cuda.synchronize()"
    if name in ("float", "int", "bool") and len(node.args) == 1:
        if not _is_static_expr(node.args[0], fi, m):
            return f"{name}() on a tensor value"
    return None


# ---------------------------------------------------------------------------
# RL101 — host sync inside a compiled region
# ---------------------------------------------------------------------------

@register_rule
class HostSyncInRegion(Rule):
    id = "RL101"
    name = "host-sync-in-region"
    description = (".item()/.tolist()/.cpu()/.numpy()/torch.cuda."
                   "synchronize()/float()/int()/bool() reachable from a "
                   "torch.compile function or a CUDA-graph capture — a "
                   "graph break there, illegal under capture")

    def check(self, m: ModuleInfo, project: ProjectContext
              ) -> Iterator[Finding]:
        if _is_test_path(m):
            return
        for unit in region_units(m):
            for node in unit.nodes:
                if not isinstance(node, ast.Call):
                    continue
                hit = _host_sync(node, unit.scope, m)
                if hit:
                    yield self.finding(
                        m, node,
                        f"{hit} inside compiled region '{unit.label}' "
                        f"forces a device->host sync (a graph break "
                        f"under torch.compile, an error under CUDA-graph "
                        f"capture); keep the value on the device and read "
                        f"it once after the region")


# ---------------------------------------------------------------------------
# RL102 — randomness a resume cannot replay
# ---------------------------------------------------------------------------

_SAMPLERS = {"randn", "rand", "randint", "randperm", "normal", "bernoulli",
             "multinomial"}
_INPLACE_SAMPLERS = {"normal_", "uniform_", "random_", "bernoulli_",
                     "exponential_"}


def _takes_generator(node: ast.Call) -> bool:
    """A ``generator=`` keyword, or a ``**kwargs`` that may carry one
    (silent: it cannot be proven missing)."""
    return any(kw.arg in ("generator", None) for kw in node.keywords)


def _bound_names(nodes) -> Set[str]:
    """Names (and the bases of attribute/subscript targets) that the
    given statements bind or mutate."""
    out: Set[str] = set()

    def target(t):
        if isinstance(t, ast.Name):
            out.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                target(el)
        elif isinstance(t, ast.Starred):
            target(t.value)
        elif isinstance(t, (ast.Attribute, ast.Subscript)):
            base = t.value
            while isinstance(base, (ast.Attribute, ast.Subscript)):
                base = base.value
            target(base)

    for n in nodes:
        if isinstance(n, ast.Assign):
            for t in n.targets:
                target(t)
        elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
            target(n.target)
        elif isinstance(n, (ast.For, ast.AsyncFor)):
            target(n.target)
        elif isinstance(n, (ast.With, ast.AsyncWith)):
            for item in n.items:
                if item.optional_vars is not None:
                    target(item.optional_vars)
        elif isinstance(n, ast.NamedExpr):
            target(n.target)
    return out


def _loop_invariant(expr: ast.AST, changed: Set[str]) -> bool:
    """No call, and no name the loop binds: the same value every pass."""
    for n in ast.walk(expr):
        if isinstance(n, (ast.Call, ast.Await, ast.Yield, ast.YieldFrom,
                          ast.NamedExpr)):
            return False
        if isinstance(n, ast.Name) and n.id in changed:
            return False
    return True


@register_rule
class KeyReuse(Rule):
    id = "RL102"
    name = "prng-key-reuse"
    description = ("a torch sampler drawing from the global generator "
                   "(no generator=), or a torch.Generator re-seeded in a "
                   "loop from a value the loop does not change — draws a "
                   "resume cannot replay, or the same draws every pass")

    def check(self, m: ModuleInfo, project: ProjectContext
              ) -> Iterator[Finding]:
        if "repro_torch" not in _dirs(m) or _is_test_path(m):
            return
        for node in ast.walk(m.tree):
            if isinstance(node, ast.Call) and not _takes_generator(node):
                what = self._global_draw(node, m)
                if what:
                    yield self.finding(
                        m, node,
                        f"{what} draws from the global generator: pass "
                        f"generator= (an explicit torch.Generator chained "
                        f"on the state's seed), or a resume is no longer "
                        f"bit-identical")
        seen: Set[int] = set()
        for loop in ast.walk(m.tree):
            if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                continue
            body = [n for st in loop.body
                    for n in (st, *walk_skipping_functions(st))]
            changed = _bound_names([loop, *body])
            for node in body:
                if (isinstance(node, ast.Call) and id(node) not in seen
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "manual_seed"
                        and m.resolve(node.func) is None
                        and len(node.args) == 1
                        and _loop_invariant(node.args[0], changed)):
                    seen.add(id(node))
                    yield self.finding(
                        m, node,
                        f"torch.Generator re-seeded from "
                        f"'{ast.unparse(node.args[0])}', which this loop "
                        f"never changes: every pass draws the same "
                        f"numbers; derive the seed from the loop's "
                        f"counter")

    @staticmethod
    def _global_draw(node: ast.Call, m: ModuleInfo) -> Optional[str]:
        name = m.resolve(node.func) or ""
        head, _, tail = name.rpartition(".")
        if head == "torch" and tail in _SAMPLERS:
            return f"torch.{tail}"
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _INPLACE_SAMPLERS
                and m.resolve(node.func) is None):
            return f"Tensor.{node.func.attr}"
        return None


# ---------------------------------------------------------------------------
# RL103 — collective-axis discipline
# ---------------------------------------------------------------------------

# method -> position of its axes argument
_COLLECTIVES = {"psum": 1, "all_gather": 1, "block_mesh": 0}


@register_rule
class CollectiveAxisDiscipline(Rule):
    id = "RL103"
    name = "collective-axis-discipline"
    description = ("a mesh collective (.psum/.all_gather/.block_mesh) "
                   "naming a string axis that no mesh of the analyzed "
                   "project declares (a KeyError at run time, or worse, "
                   "only at scale)")

    def check(self, m: ModuleInfo, project: ProjectContext
              ) -> Iterator[Finding]:
        declared = project.declared_axes
        if not declared:
            return
        for node in ast.walk(m.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _COLLECTIVES
                    and m.resolve(node.func) is None):
                continue
            method = node.func.attr
            for arg in self._axis_args(node, _COLLECTIVES[method]):
                for ax in string_elements(arg, m.str_constants):
                    if ax not in declared:
                        yield self.finding(
                            m, node,
                            f".{method} names axis '{ax}' but the "
                            f"analyzed tree declares only "
                            f"{sorted(declared)} — collectives must name "
                            f"a declared mesh axis")

    @staticmethod
    def _axis_args(node: ast.Call, idx: int) -> List[ast.AST]:
        out = list(node.args[idx:idx + 1])
        out += [kw.value for kw in node.keywords
                if kw.arg in ("axes", "over")]
        return out


# ---------------------------------------------------------------------------
# RL104 — no densify
# ---------------------------------------------------------------------------

_DENSIFY_METHODS = {"todense", "toarray", "to_dense"}


@register_rule
class NoDensify(Rule):
    id = "RL104"
    name = "no-densify"
    description = (".todense()/.toarray()/.to_dense() outside whitelisted "
                   "oracle/test sites — the sparse path must never "
                   "materialize the matrix")

    def check(self, m: ModuleInfo, project: ProjectContext
              ) -> Iterator[Finding]:
        if _is_test_path(m):
            return
        for node in ast.walk(m.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _DENSIFY_METHODS):
                yield self.finding(
                    m, node,
                    f".{node.func.attr}() densifies a sparse container "
                    f"outside a whitelisted oracle/test site; keep the "
                    f"sparse-native path (or mark an oracle site with "
                    f"'# ranky-lint: disable=RL104')")


# ---------------------------------------------------------------------------
# RL105 — recompile hazard
# ---------------------------------------------------------------------------

_TENSOR_FUNCS = {"any", "all", "sum", "max", "min", "mean", "prod",
                 "argmax", "argmin", "count_nonzero", "isnan", "isinf",
                 "isfinite", "equal", "allclose", "isclose", "eq", "ne",
                 "gt", "lt", "ge", "le", "norm", "abs", "where", "nonzero"}
_TENSOR_METHODS = {"any", "all", "sum", "max", "min", "mean", "prod",
                   "argmax", "argmin", "count_nonzero", "isnan", "isinf",
                   "isfinite", "eq", "ne", "gt", "lt", "ge", "le", "norm",
                   "abs"}


def _test_on_tensor(test: ast.AST, m: ModuleInfo) -> Optional[str]:
    for n in ast.walk(test):
        if not isinstance(n, ast.Call):
            continue
        name = m.resolve(n.func) or ""
        head, _, tail = name.rpartition(".")
        if head == "torch" and tail in _TENSOR_FUNCS:
            return name
        if (isinstance(n.func, ast.Attribute)
                and n.func.attr in _TENSOR_METHODS
                and m.resolve(n.func) is None):
            return f".{n.func.attr}()"
    return None


@register_rule
class RecompileHazard(Rule):
    id = "RL105"
    name = "recompile-hazard"
    description = ("Python branching on a tensor value inside a "
                   "torch.compile function or a CUDA-graph capture — a "
                   "graph break or a recompile per value, illegal under "
                   "capture")

    def check(self, m: ModuleInfo, project: ProjectContext
              ) -> Iterator[Finding]:
        for unit in region_units(m):
            for node in unit.nodes:
                if not isinstance(node, (ast.If, ast.While, ast.IfExp,
                                         ast.Assert)):
                    continue
                hit = _test_on_tensor(node.test, m)
                if hit:
                    yield self.finding(
                        m, node,
                        f"Python branch on a tensor value ({hit}) inside "
                        f"compiled region '{unit.label}' — use "
                        f"torch.where / torch.cond, or hoist the decision "
                        f"to the host")


# ---------------------------------------------------------------------------
# RL107 — host sync inside a serving/ingest hot loop
# ---------------------------------------------------------------------------

_HOT_PATH_DIRS = {"serve", "stream"}
_DATA_DEPENDENT = {"torch.nonzero", "torch.unique", "torch.masked_select"}


def in_hot_path(m: ModuleInfo) -> bool:
    """RL107's scope: a module under a serve/ or stream/ directory."""
    return bool(_HOT_PATH_DIRS & set(_dirs(m)))


def hot_loop_nodes(m: ModuleInfo
                   ) -> Iterator[Tuple[Optional[FunctionInfo], ast.AST]]:
    """(enclosing function, node) for every node lexically in the body of
    a host ``for`` / ``while`` loop (nested defs excluded; loops inside a
    compiled region are RL101's).  A node in nested loops comes once."""
    seen: Set[int] = set()
    for loop in ast.walk(m.tree):
        if not isinstance(loop, (ast.For, ast.While)):
            continue
        fi = m.enclosing_function(loop)
        if fi is not None and fi.in_region:
            continue
        for stmt in loop.body:
            for node in (stmt, *walk_skipping_functions(stmt)):
                if id(node) not in seen:
                    seen.add(id(node))
                    yield fi, node


@register_rule
class HostSyncInHotLoop(Rule):
    id = "RL107"
    name = "host-sync-in-hot-loop"
    description = (".item()/.tolist()/.cpu()/.numpy()/torch.cuda."
                   "synchronize()/float()/int()/bool() on device values, "
                   "or a data-dependent shape (.nonzero()/torch.unique/"
                   "torch.masked_select), per iteration of a host loop "
                   "in a serving or ingest hot path — every pass "
                   "round-trips the device, serializing the dispatch "
                   "pipeline")

    def check(self, m: ModuleInfo, project: ProjectContext
              ) -> Iterator[Finding]:
        # Scoped to the hot-path subsystems: modules living under a
        # serve/ or stream/ directory.  Host code elsewhere may loop
        # and sync freely (benchmarks, examples, checkpoint restore).
        if not in_hot_path(m):
            return
        for fi, node in hot_loop_nodes(m):
            if not isinstance(node, ast.Call):
                continue
            hit = self._classify(node, fi, m)
            if hit:
                where = fi.qualname if fi is not None else "<module>"
                yield self.finding(
                    m, node,
                    f"{hit} inside a host loop of hot path '{where}' "
                    f"syncs the device EVERY iteration, serializing the "
                    f"serving/ingest dispatch pipeline; batch the work "
                    f"into one dispatch or hoist ONE sync after the loop")

    @staticmethod
    def _classify(node: ast.Call, fi: Optional[FunctionInfo],
                  m: ModuleInfo) -> Optional[str]:
        hit = _host_sync(node, fi, m)
        if hit:
            return hit.replace("a tensor value", "a potential device value")
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr == "nonzero"
                and m.resolve(node.func) is None):
            return ".nonzero() (a data-dependent shape)"
        name = m.resolve(node.func)
        if name in _DATA_DEPENDENT:
            return f"{name} (a data-dependent shape)"
        return None


# ---------------------------------------------------------------------------
# RL108 — ad-hoc timing/printing outside the observability layer
# ---------------------------------------------------------------------------

_OBS_SCOPE_DIRS = {"core", "serve", "stream"}
_RAW_CLOCKS = {
    "time.time": "obs clock (repro_torch.obs.clock.wall)",
    "time.perf_counter": "obs clock (repro_torch.obs.clock.now)",
}


@register_rule
class RawClockOrPrint(Rule):
    id = "RL108"
    name = "raw-clock-or-print"
    description = ("direct time.time()/time.perf_counter()/print() in "
                   "src/repro_torch/{stream,serve,core} outside obs/ — "
                   "timing and logging must route through the "
                   "observability clock (repro_torch.obs.clock) and "
                   "structured spans/metrics, or traces lose their one "
                   "shared timebase and output bypasses the ring buffer")

    def check(self, m: ModuleInfo, project: ProjectContext
              ) -> Iterator[Finding]:
        # Scoped to the production subsystems; the obs package IS the
        # clock/logger, and benchmarks/tests/examples time and print
        # freely by design.
        dirs = set(_dirs(m))
        if not (_OBS_SCOPE_DIRS & dirs) or "obs" in dirs:
            return
        for node in ast.walk(m.tree):
            if not isinstance(node, ast.Call):
                continue
            name = m.resolve_or_name(node.func)
            if name in _RAW_CLOCKS:
                yield self.finding(
                    m, node,
                    f"{name}() bypasses the observability timebase — "
                    f"route through the {_RAW_CLOCKS[name]} so spans, "
                    f"metrics and Diagnostics share ONE clock")
            elif name == "print":
                yield self.finding(
                    m, node,
                    "print() in a production subsystem bypasses the "
                    "observability layer — record an obs span/event/"
                    "metric (repro_torch.obs) so output is structured, "
                    "gated and exportable")
