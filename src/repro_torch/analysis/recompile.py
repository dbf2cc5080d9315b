"""Pass 3 — CUDA-graph capture hazards and executor cache keys.

The port of ``repro/analysis/recompile.py``.  The port has no ``jax.jit``:
its fixed-shape executors are CUDA graphs (``core/dso.py``
``capture_graph`` / ``Executor``), so the JAX pass's two jit rules become
capture rules; its two framework-free rules are copies.

R1  ``FC-CAPTURE-HOT``: a capture reachable from the serving hot path
    (``host_sync.ROOT_METHODS``): ``torch.compile(...)``,
    ``torch.jit.script`` / ``trace``, ``torch.cuda.CUDAGraph()``,
    ``torch.cuda.graph(...)``, ``capture_graph(...)``, ``Executor(...)``,
    or the construction of an analysed class whose ``__init__`` does one of
    these.  Executors are captured up front; such a call means a capture
    (warm-ups, a graph pool) can happen on a request.

R2  ``FC-CAPTURE-FROZEN``: inside a captured region, what a replay cannot
    see.  A region is a function handed to ``Executor(...)`` or
    ``capture_graph(...)`` (by name, by lambda, or as a local ``def``), and
    what it reaches among the analysed files by name: a bare call to a
    module function or a sibling local ``def``, an attribute call to a
    method.  The model code a captured executor runs (``core/climber.py``,
    ``core/sumi.py``, ``models/*``: reached through the bundle's
    attributes) is not analysed, so the region is the executors' closures
    and the serving methods they call.  Flagged there:

    (a) a host sync as host_sync detects it — the capture raises on it, and
        the CPU tests never capture;
    (b) a Python ``if`` / ``while`` on a value that is not static (JAX's
        ``_StaticExpr``, with ``.shape``, ``.dim()``, ``.dtype`` and
        ``.device`` static) — the capture records one branch for good;
    (c) a read of host state that can change after construction:
        ``self.<attr>`` where the class (or a base) assigns ``attr`` outside
        ``__init__``, a mutable module global, or ``time.*`` / ``random.*``
        / ``np.random.*`` — a replay keeps the value the capture saw,
        without any error.

R3  ``FC-CACHE-KEY`` (a copy of JAX's, with ``torch.tensor`` /
    ``torch.as_tensor`` among the array constructors): unhashable or
    non-canonical keys stored into executor caches.

R4  ``FC-SHAPE-BRANCH`` (a copy of JAX's): ``if`` / ``while`` on
    ``.shape[...]`` inside ``engine.py`` / ``dso.py`` outside ``__init__``.

A ``recompile-ok`` pragma on R1 and R2 covers its own statement only
(``common.STATEMENT_CODES``).
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.common import Finding, ModuleSource, dotted_name, \
    self_attr
from repro_torch.analysis.host_sync import build_call_graph, \
    reachable_from_roots, sync_sites

PASS = "recompile"

CACHE_ATTR_RE = re.compile(r"cache|memo|seen|inflight|executor")
R4_FILES = ("engine.py", "dso.py")
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda"}
_STATIC_CALLS = {"len", "isinstance", "min", "max", "bool"}
#: tensor methods whose result is shape metadata
_STATIC_METHODS = {"dim", "size", "numel", "stride", "is_contiguous"}
#: calls that capture (or compile) a graph, by dotted name
_CAPTURE_CALLS = {"torch.compile", "torch.jit.script", "torch.jit.trace",
                  "torch.cuda.CUDAGraph", "torch.cuda.graph"}
#: ... and by the last component of the name: these also take the
#: captured region as their first argument
_CAPTURE_NAMES = {"capture_graph", "Executor"}
#: call prefixes that read host state a replay freezes
_HOST_STATE = ("time.", "random.", "np.random.", "numpy.random.")
#: annotations of parameters that hold host scalars
_SCALAR_TYPES = {"int", "str", "bool", "float"}

_Def = (ast.FunctionDef, ast.AsyncFunctionDef)


# -- R1 ------------------------------------------------------------------

def _is_capture(call: ast.Call, capturing: Set[str]) -> Optional[str]:
    dn = dotted_name(call.func)
    if dn is None:
        return None
    last = dn.split(".")[-1]
    if dn in _CAPTURE_CALLS or last in _CAPTURE_NAMES:
        return f"{dn}()"
    if last in capturing:
        return f"{dn}() (its __init__ captures)"
    return None


def _capturing_classes(sources: Sequence[ModuleSource]) -> Set[str]:
    """Analysed classes whose ``__init__`` captures directly."""
    out: Set[str] = set()
    for src in sources:
        for cls in ast.walk(src.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            for item in cls.body:
                if isinstance(item, _Def) and item.name == "__init__" and any(
                        isinstance(n, ast.Call) and _is_capture(n, set())
                        for n in ast.walk(item)):
                    out.add(cls.name)
    return out


def _r1(sources: Sequence[ModuleSource]) -> List[Finding]:
    capturing = _capturing_classes(sources)
    nodes, reach = reachable_from_roots(sources)
    out: List[Finding] = []
    for i in sorted(reach):
        node = nodes[i]
        for n in ast.walk(node.fn):
            what = isinstance(n, ast.Call) and _is_capture(n, capturing)
            if what:
                out.append(Finding(
                    node.module.path, n.lineno, PASS, "FC-CAPTURE-HOT",
                    f"{node.qualname}: {what} on the serving hot path — "
                    f"a capture can happen per request; capture executors "
                    f"at construction instead"))
    return out


# -- R2 ------------------------------------------------------------------

class _StaticExpr:
    """Classifies whether an expression is capture-time static (JAX's
    classifier, with torch's shape metadata)."""

    def __init__(self, static_names: Set[str]):
        self.static = set(static_names) | {"self"}

    def is_static(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Constant):
            return True
        if isinstance(node, ast.Name):
            return node.id in self.static
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return True
            return self.is_static(node.value)
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and f.id in _STATIC_CALLS:
                return True
            return isinstance(f, ast.Attribute) and \
                f.attr in _STATIC_METHODS
        if isinstance(node, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return True
            return self.is_static(node.left) and \
                all(self.is_static(c) for c in node.comparators)
        if isinstance(node, ast.BoolOp):
            return all(self.is_static(v) for v in node.values)
        if isinstance(node, ast.BinOp):
            return self.is_static(node.left) and self.is_static(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_static(node.operand)
        if isinstance(node, (ast.Tuple, ast.List)):
            return all(self.is_static(e) for e in node.elts)
        if isinstance(node, ast.Subscript):
            return self.is_static(node.value)
        if isinstance(node, ast.IfExp):
            return all(self.is_static(e)
                       for e in (node.test, node.body, node.orelse))
        return False


def _module_constants(src: ModuleSource) -> Set[str]:
    """Module-level names bound to literal constants, and imported names
    (``torch.int8`` is as static as ``8``)."""
    out: Set[str] = set()
    for stmt in src.tree.body:
        if isinstance(stmt, ast.Assign) and \
                isinstance(stmt.value, ast.Constant):
            out.update(t.id for t in stmt.targets
                       if isinstance(t, ast.Name))
        elif isinstance(stmt, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0]
                       for a in stmt.names)
    return out


def _mutable_globals(src: ModuleSource) -> Set[str]:
    """Module-level names bound to a list / dict / set, or rebound by a
    function's ``global`` statement."""
    out: Set[str] = set()
    for stmt in src.tree.body:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)) and isinstance(
                stmt.value, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                             ast.DictComp, ast.SetComp)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            out.update(t.id for t in targets if isinstance(t, ast.Name))
    for n in ast.walk(src.tree):
        if isinstance(n, ast.Global):
            out.update(n.names)
    return out


def _late_attrs(sources: Sequence[ModuleSource]) -> Dict[str, Set[str]]:
    """class name -> the ``self`` attributes it, or an analysed base,
    (re)binds outside ``__init__``."""
    own: Dict[str, Set[str]] = {}
    bases: Dict[str, List[str]] = {}
    for src in sources:
        for cls in ast.walk(src.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            bases[cls.name] = [dotted_name(b).split(".")[-1]
                               for b in cls.bases if dotted_name(b)]
            attrs = own.setdefault(cls.name, set())
            for item in cls.body:
                if not isinstance(item, _Def) or item.name == "__init__":
                    continue
                for n in ast.walk(item):
                    targets: List[ast.AST] = []
                    if isinstance(n, ast.Assign):
                        targets = list(n.targets)
                    elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                        targets = [n.target]
                    for t in targets:
                        for e in (t.elts if isinstance(t, (ast.Tuple,
                                                           ast.List))
                                  else [t]):
                            a = self_attr(e)
                            if a is not None:
                                attrs.add(a)
    out: Dict[str, Set[str]] = {}
    for name in own:
        seen, work, acc = set(), [name], set()
        while work:
            c = work.pop()
            if c in seen:
                continue
            seen.add(c)
            acc |= own.get(c, set())
            work.extend(bases.get(c, []))
        out[name] = acc
    return out


class _Region:
    """One function of a captured region: a def or a lambda, with the module
    it is in, the class its ``self`` is, and the top-level def around it
    (for its sibling local defs)."""
    __slots__ = ("module", "cls", "fn", "outer", "name")

    def __init__(self, module, cls, fn, outer, name):
        self.module = module
        self.cls = cls
        self.fn = fn
        self.outer = outer
        self.name = name


def _top_defs(src: ModuleSource) -> Iterable[Tuple[Optional[str], ast.AST]]:
    for top in src.tree.body:
        if isinstance(top, _Def):
            yield None, top
        elif isinstance(top, ast.ClassDef):
            for item in top.body:
                if isinstance(item, _Def):
                    yield top.name, item


def _local_defs(outer: ast.AST, name: str) -> List[ast.AST]:
    return [n for n in ast.walk(outer)
            if isinstance(n, _Def) and n is not outer and n.name == name]


def _region_roots(sources: Sequence[ModuleSource]) -> List[_Region]:
    roots: List[_Region] = []
    methods: Dict[Tuple[str, str], Tuple[ModuleSource, ast.AST]] = {}
    funcs: Dict[str, List[Tuple[ModuleSource, ast.AST]]] = {}
    for src in sources:
        for cls, fn in _top_defs(src):
            if cls is None:
                funcs.setdefault(fn.name, []).append((src, fn))
            else:
                methods[(cls, fn.name)] = (src, fn)
    for src in sources:
        for cls, outer in _top_defs(src):
            for call in ast.walk(outer):
                if not isinstance(call, ast.Call):
                    continue
                dn = dotted_name(call.func)
                if dn is None or dn.split(".")[-1] not in _CAPTURE_NAMES:
                    continue
                arg = call.args[0] if call.args else next(
                    (kw.value for kw in call.keywords if kw.arg == "fn"),
                    None)
                if isinstance(arg, ast.Lambda):
                    roots.append(_Region(src, cls, arg, outer, "<lambda>"))
                elif isinstance(arg, ast.Name):
                    found = _local_defs(outer, arg.id)
                    if found:
                        roots.extend(_Region(src, cls, d, outer, d.name)
                                     for d in found)
                    else:
                        roots.extend(_Region(m, None, d, d, d.name)
                                     for m, d in funcs.get(arg.id, ()))
                elif self_attr(arg) is not None and cls is not None \
                        and (cls, arg.attr) in methods:
                    m, d = methods[(cls, arg.attr)]
                    roots.append(_Region(m, cls, d, d, d.name))
    return roots


def _region(sources: Sequence[ModuleSource]) -> List[_Region]:
    """Every function of every captured region, each once."""
    nodes, edges = build_call_graph(sources)
    index = {id(n.fn): i for i, n in enumerate(nodes)}
    work = _region_roots(sources)
    seen: Set[int] = set()
    out: List[_Region] = []
    while work:
        r = work.pop()
        if id(r.fn) in seen:
            continue
        seen.add(id(r.fn))
        out.append(r)
        i = index.get(id(r.fn))
        if i is not None:      # a top-level def: host_sync's edges
            work.extend(_Region(nodes[j].module, nodes[j].cls, nodes[j].fn,
                                nodes[j].fn, nodes[j].name)
                        for j in edges[i])
            continue
        # a local def or a lambda: what it calls by name among its sibling
        # local defs, and among the analysed files as host_sync resolves
        for n in ast.walk(r.fn):
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            name = f.id if isinstance(f, ast.Name) else \
                f.attr if isinstance(f, ast.Attribute) else None
            if name is None:
                continue
            if isinstance(f, ast.Name):
                work.extend(_Region(r.module, r.cls, d, r.outer, d.name)
                            for d in _local_defs(r.outer, name))
            work.extend(_Region(nd.module, nd.cls, nd.fn, nd.fn, nd.name)
                        for nd in nodes
                        if nd.name == name and (nd.cls is None)
                        == isinstance(f, ast.Name))
    return out


def _local_names(fn: ast.AST) -> Set[str]:
    """Parameters and names the function binds (shadowing globals)."""
    out: Set[str] = set()
    args = fn.args
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        out.add(a.arg)
    for a in (args.vararg, args.kwarg):
        if a is not None:
            out.add(a.arg)
    for n in ast.walk(fn):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
            out.add(n.id)
    return out


def _scalar_params(r: _Region) -> Set[str]:
    """Parameters annotated as host scalars (``int``, ``str``, ``bool``,
    ``float``, optionally ``Optional[...]``) of the region function and of
    the defs around it: fixed Python values, static to a capture."""
    out: Set[str] = set()
    line = r.fn.lineno
    for d in ast.walk(r.outer):
        if not isinstance(d, _Def + (ast.Lambda,)) or not (
                d.lineno <= line <= (d.end_lineno or d.lineno)):
            continue
        a = d.args
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            ann = p.annotation
            if isinstance(ann, ast.Subscript) and \
                    dotted_name(ann.value) in ("Optional", "typing.Optional"):
                ann = ann.slice
            if isinstance(ann, ast.Name) and ann.id in _SCALAR_TYPES:
                out.add(p.arg)
    return out


def _static_locals(fn: ast.AST, classifier: _StaticExpr) -> None:
    """Grow the static-local set in statement order, as JAX's R2 does."""
    for stmt in ast.walk(fn):
        if isinstance(stmt, ast.Assign) and \
                classifier.is_static(stmt.value):
            for t in stmt.targets:
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                    else [t]
                for e in elts:
                    if isinstance(e, ast.Name):
                        classifier.static.add(e.id)


def _scan_region(r: _Region, late: Dict[str, Set[str]]) -> List[Finding]:
    src = r.module
    who = f"{r.cls}.{r.name}" if r.cls else r.name
    out: List[Finding] = []

    def add(line: int, msg: str):
        out.append(Finding(src.path, line, PASS, "FC-CAPTURE-FROZEN",
                           f"{who}: {msg} inside a captured region"))

    for line, _, msg in sync_sites(r.fn):
        add(line, f"{msg} — the capture raises on it")
    classifier = _StaticExpr(_module_constants(src) | _scalar_params(r))
    _static_locals(r.fn, classifier)
    for stmt in ast.walk(r.fn):
        if isinstance(stmt, (ast.If, ast.While)) and \
                not classifier.is_static(stmt.test):
            kw = "while" if isinstance(stmt, ast.While) else "if"
            add(stmt.lineno, f"Python `{kw}` on a value that is not static "
                f"— the graph keeps the branch the capture took")
    mutable = _mutable_globals(src) - _local_names(r.fn)
    late_here = late.get(r.cls, set()) if r.cls else set()
    for n in ast.walk(r.fn):
        if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load) \
                and self_attr(n) in late_here:
            add(n.lineno, f"reads self.{n.attr}, which {r.cls} rebinds "
                f"after construction — a replay keeps the captured value")
        elif isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                and n.id in mutable:
            add(n.lineno, f"reads the mutable module global {n.id!r} — a "
                f"replay keeps the captured value")
        elif isinstance(n, ast.Call):
            dn = dotted_name(n.func) or ""
            if dn.startswith(_HOST_STATE):
                add(n.lineno, f"{dn}() reads host state — a replay keeps "
                    f"the captured value")
    return out


def _r2(sources: Sequence[ModuleSource]) -> List[Finding]:
    late = _late_attrs(sources)
    out: List[Finding] = []
    for r in _region(sources):
        out.extend(_scan_region(r, late))
    return out


# -- R3 ------------------------------------------------------------------

def _bad_key(expr: ast.AST) -> Optional[str]:
    for n in ast.walk(expr):
        if isinstance(n, (ast.List, ast.Set, ast.Dict, ast.ListComp,
                          ast.SetComp, ast.DictComp)):
            return "unhashable list/set/dict"
        if isinstance(n, ast.Call) and dotted_name(n.func) in (
                "np.array", "np.asarray", "numpy.array", "numpy.asarray",
                "jnp.array", "jnp.asarray", "torch.tensor",
                "torch.as_tensor"):
            return "array object (identity-hashed / unhashable)"
        if isinstance(n, ast.Constant) and isinstance(n.value, float):
            return "bare float literal (non-canonical)"
    return None


def _r3(sources: Sequence[ModuleSource]) -> List[Finding]:
    out: List[Finding] = []
    for src in sources:
        for n in ast.walk(src.tree):
            key: Optional[ast.AST] = None
            attr: Optional[str] = None
            if isinstance(n, (ast.Assign, ast.AugAssign)):
                targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                for t in targets:
                    if isinstance(t, ast.Subscript):
                        attr = self_attr(t.value)
                        key = t.slice
            elif isinstance(n, ast.Call) and \
                    isinstance(n.func, ast.Attribute) and \
                    n.func.attr in ("add", "get", "setdefault", "pop") \
                    and n.args:
                attr = self_attr(n.func.value)
                key = n.args[0]
            if attr is None or key is None or \
                    not CACHE_ATTR_RE.search(attr):
                continue
            why = _bad_key(key)
            if why is not None:
                out.append(Finding(
                    src.path, n.lineno, PASS, "FC-CACHE-KEY",
                    f"non-canonical key into self.{attr}: {why} — "
                    f"canonicalize to a tuple of hashable scalars"))
    return out


# -- R4 ------------------------------------------------------------------

def _r4(sources: Sequence[ModuleSource]) -> List[Finding]:
    out: List[Finding] = []
    for src in sources:
        if os.path.basename(src.path) not in R4_FILES:
            continue
        for node in ast.walk(src.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                    or node.name == "__init__":
                continue
            for stmt in ast.walk(node):
                if not isinstance(stmt, (ast.If, ast.While)):
                    continue
                for n in ast.walk(stmt.test):
                    if isinstance(n, ast.Subscript) and \
                            isinstance(n.value, ast.Attribute) and \
                            n.value.attr == "shape":
                        out.append(Finding(
                            src.path, stmt.lineno, PASS, "FC-SHAPE-BRANCH",
                            f"{node.name}: branching on .shape[...] — "
                            f"shape-dependent control flow fragments AOT "
                            f"executor families; route through the bucket "
                            f"tables"))
                        break
    return out


def run(sources: Sequence[ModuleSource]) -> List[Finding]:
    return _r1(sources) + _r2(sources) + _r3(sources) + _r4(sources)
