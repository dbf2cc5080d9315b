"""Pass 2 — hidden device→host synchronization on the port's hot path.

The port of ``repro/analysis/host_sync.py``, with torch's syncs in place of
JAX's.  It builds an intra-repo call graph rooted at the request hot path —
``FlameEngine.submit`` (inherited from ``_PipelinedEngine``), the pipelined
worker loop, the ``CoalescingOrchestrator`` flush loop and the ``Executor``
call — and flags every construct reachable from it that waits for the
device or copies between host and device:

- ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()`` method calls
  (FC-SYNC-METHOD: a CUDA tensor's value reaches the host only after the
  device has finished the work that makes it);
- ``torch.cuda.synchronize(...)`` (FC-SYNC-CUDA) and ``.synchronize()`` of
  a stream or an event (FC-SYNC-METHOD);
- ``float(...)`` / ``int(...)`` / ``bool(...)`` of a tensor expression
  (FC-SYNC-SCALAR: an argument that mentions ``torch.`` or ends in a
  reduction such as ``.sum()`` or ``.max()``);
- ``torch.tensor(...)`` / ``torch.as_tensor(...)`` with a ``device=``, and
  ``.to(<device>)`` / ``.cuda()`` (FC-SYNC-PUT: a host→device copy staged
  from the hot path; a pageable source makes the copy synchronous).

Call resolution is name-based (CHA-style): ``self.m(...)`` and ``obj.m(...)``
link to every analyzed class defining ``m``; bare names link to module-level
functions.  This over-approximates — acceptable, because the flagged
constructs are precisely the ones that need a written justification anywhere
near the hot path.  Deliberate syncs at a dispatch boundary carry
``# flamecheck: host-sync-ok(reason)`` pragmas.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.common import Finding, ModuleSource, dotted_name

PASS = "host-sync"

#: (class name, method name) roots of the hot path.  Name-based so test
#: fixtures defining a class with one of these shapes are analyzed too.
ROOT_METHODS = {
    ("FlameEngine", "submit"),
    ("_PipelinedEngine", "submit"),
    ("_PipelinedEngine", "_worker_loop"),
    ("CoalescingOrchestrator", "submit"),
    ("CoalescingOrchestrator", "_worker"),
    ("Executor", "__call__"),
}

#: callback indirection the name-based resolver cannot see: a method that
#: stores/passes a bound helper which a callee later invokes.
EXTRA_EDGES = {
    "pad_slice": ("_pad_slice",),
    "gather": ("_gather",),
}

#: tensor methods whose result is on the host: each waits for the device
SYNC_METHODS = {"item", "cpu", "tolist", "numpy", "synchronize"}
#: ``torch.*`` factories that stage host data onto a device
PUT_FUNCS = {"tensor", "as_tensor"}
#: tensor reductions: ``float(x.sum())`` reads a device scalar
REDUCTIONS = {"sum", "max", "min", "mean", "amax", "amin", "norm", "any",
              "all", "prod", "argmax", "argmin", "count_nonzero"}


class _Node:
    __slots__ = ("module", "cls", "name", "fn")

    def __init__(self, module: ModuleSource, cls: Optional[str], name: str,
                 fn: ast.AST):
        self.module = module
        self.cls = cls
        self.name = name
        self.fn = fn

    @property
    def qualname(self) -> str:
        return f"{self.cls}.{self.name}" if self.cls else self.name


def _collect_nodes(sources: Sequence[ModuleSource]) -> List[_Node]:
    nodes: List[_Node] = []
    for src in sources:
        for top in src.tree.body:
            if isinstance(top, (ast.FunctionDef, ast.AsyncFunctionDef)):
                nodes.append(_Node(src, None, top.name, top))
            elif isinstance(top, ast.ClassDef):
                for item in top.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        nodes.append(_Node(src, top.name, item.name, item))
    return nodes


def _called_names(fn: ast.AST) -> Set[str]:
    """Names of everything syntactically called inside ``fn``."""
    out: Set[str] = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Call):
            f = n.func
            if isinstance(f, ast.Name):
                out.add(f.id)
            elif isinstance(f, ast.Attribute):
                out.add(f.attr)
    return out


def build_call_graph(sources: Sequence[ModuleSource]
                     ) -> Tuple[List[_Node], Dict[int, Set[int]]]:
    """Returns (nodes, edges) with edges keyed/valued by node index."""
    nodes = _collect_nodes(sources)
    by_method: Dict[str, List[int]] = {}
    by_func: Dict[str, List[int]] = {}
    for i, node in enumerate(nodes):
        (by_method if node.cls else by_func).setdefault(
            node.name, []).append(i)

    edges: Dict[int, Set[int]] = {}
    for i, node in enumerate(nodes):
        callees: Set[int] = set()
        names = set(_called_names(node.fn))
        for name in list(names):
            names.update(EXTRA_EDGES.get(name, ()))
        for name in names:
            callees.update(by_method.get(name, []))
            callees.update(by_func.get(name, []))
        edges[i] = callees
    return nodes, edges


def reachable_from_roots(sources: Sequence[ModuleSource],
                         roots: Iterable[Tuple[str, str]] = ROOT_METHODS
                         ) -> Tuple[List[_Node], Set[int]]:
    nodes, edges = build_call_graph(sources)
    roots = set(roots)
    work = [i for i, n in enumerate(nodes) if (n.cls, n.name) in roots]
    seen: Set[int] = set(work)
    while work:
        i = work.pop()
        for j in edges.get(i, ()):
            if j not in seen:
                seen.add(j)
                work.append(j)
    return nodes, seen


def _mentions_tensor(node: ast.AST) -> bool:
    """True if the expression names ``torch`` or ends in a tensor reduction
    (``x.sum()``; not ``np.sum(...)`` or ``math.prod(...)``, host
    arithmetic)."""
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name) \
                and n.value.id == "torch":
            return True
    return isinstance(node, ast.Call) \
        and isinstance(node.func, ast.Attribute) \
        and node.func.attr in REDUCTIONS \
        and dotted_name(node.func.value) not in ("np", "numpy", "math")


def _names_device(node: ast.AST) -> bool:
    """A ``.to(...)`` target that is a device: a "cuda..." string, a
    ``torch.device(...)``, or a name / attribute ending in ``device``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.startswith("cuda")
    dn = dotted_name(node.func if isinstance(node, ast.Call) else node)
    return dn is not None and (dn == "torch.device"
                               or dn.split(".")[-1].endswith("device"))


def sync_sites(fn: ast.AST) -> Iterable[Tuple[int, str, str]]:
    """``(line, code, message)`` of every sync or host->device copy inside
    ``fn`` (a def or a lambda, nested scopes included)."""
    for n in ast.walk(fn):
        if not isinstance(n, ast.Call):
            continue
        f = n.func
        dn = dotted_name(f)
        if dn == "torch.cuda.synchronize":
            yield n.lineno, "FC-SYNC-CUDA", f"{dn}() waits for the device"
            continue
        if dn is not None and dn.startswith("torch.") \
                and dn[len("torch."):] in PUT_FUNCS \
                and any(kw.arg == "device" for kw in n.keywords):
            yield (n.lineno, "FC-SYNC-PUT",
                   f"{dn}(..., device=) stages a host->device copy")
            continue
        if isinstance(f, ast.Attribute) and f.attr in SYNC_METHODS \
                and dotted_name(f.value) not in ("np", "numpy", "torch"):
            yield n.lineno, "FC-SYNC-METHOD", f".{f.attr}() waits for the device"
            continue
        if isinstance(f, ast.Attribute) and (
                f.attr == "cuda" or (f.attr == "to" and (
                    any(_names_device(a) for a in n.args)
                    or any(kw.arg == "device" for kw in n.keywords)))):
            yield (n.lineno, "FC-SYNC-PUT",
                   f".{f.attr}() stages a host->device copy")
            continue
        if isinstance(f, ast.Name) and f.id in ("float", "int", "bool") \
                and n.args and _mentions_tensor(n.args[0]):
            yield (n.lineno, "FC-SYNC-SCALAR",
                   f"{f.id}() of a tensor expression waits for the device")


def _scan_function(node: _Node) -> List[Finding]:
    return [Finding(node.module.path, line, PASS, code,
                    f"{node.qualname}: {msg}"
                    + (" on the hot path" if code == "FC-SYNC-PUT" else "")
                    + " (reachable from the serving hot path)")
            for line, code, msg in sync_sites(node.fn)]


def run(sources: Sequence[ModuleSource]) -> List[Finding]:
    nodes, reach = reachable_from_roots(sources)
    findings: List[Finding] = []
    for i in sorted(reach):
        findings.extend(_scan_function(nodes[i]))
    return findings
