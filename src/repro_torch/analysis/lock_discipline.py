"""Pass 1 — lock discipline for the threaded serving/core classes.

For every class that uses instance locks (``self._lock = threading.Lock()``
in ``__init__``, or ``with self._x:`` anywhere), the pass *infers* which
``self._*`` attributes are lock-guarded: an attribute is guarded iff it is
mutated at least once while a lock is held, outside ``__init__``.  Each
guarded attribute accumulates a *guard set* (every lock observed held at one
of its guarded mutations); any read or write of the attribute that holds
none of the locks in its guard set is flagged.

This matches how the repo actually uses locks: ``CoalescingOrchestrator``
guards its EDF heaps with per-(kind,bucket) condition variables and its
cost/stat counters with ``_stat_lock``; ``HistoryKVPool`` guards everything
with one ``_lock``; an access is fine under *any* lock in the attribute's
guard set (per-key conditions are statically one attribute).

Conventions understood:

- local aliases: ``cond = self._cond[key]`` then ``with cond:`` counts as
  holding ``_cond`` (tuple assignments too);
- mutations: attribute stores/augstores/deletes, subscript stores through
  the attribute (``self._x[k] = v``), nested attribute stores
  (``self._stats.hits += 1`` mutates ``_stats``), mutating method calls
  (``self._x.append(...)``, also via aliases), and calls taking the
  attribute (or an alias) as first argument (``heapq.heappush(self._x[k],
  item)``);
- ``__init__`` is construction-time and exempt;
- ``# flamecheck: locked-by-caller(self._lock)`` on a method header makes
  the body analyze as if ``_lock`` were held on entry;
- ``# flamecheck: unguarded-ok(reason)`` suppresses a finding.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.common import (Finding, ModuleSource, attr_chain_base,
                                   self_attr)

PASS = "lock-discipline"

LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                  "BoundedSemaphore"}
MUTATOR_METHODS = {"append", "appendleft", "add", "update", "clear", "pop",
                   "popleft", "popitem", "remove", "discard", "extend",
                   "extendleft", "insert", "setdefault", "move_to_end",
                   "sort", "reverse", "difference_update",
                   "intersection_update", "symmetric_difference_update"}
#: construction-time methods whose accesses are exempt (object not shared)
CTOR_METHODS = {"__init__", "__post_init__"}
# free functions that mutate their first argument in place
_FIRST_ARG_MUTATORS = {"heappush", "heappop", "heapify", "heappushpop",
                       "heapreplace"}


def _is_lock_factory_value(node: ast.AST) -> bool:
    """True if the expression constructs a Lock/RLock/Condition somewhere
    (covers ``threading.Lock()`` and dict-comprehension-of-Condition)."""
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            fn = n.func
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else None)
            if name in LOCK_FACTORIES:
                return True
    return False


class _Access:
    __slots__ = ("attr", "line", "mutation", "held", "method")

    def __init__(self, attr: str, line: int, mutation: bool,
                 held: Set[str], method: str):
        self.attr = attr
        self.line = line
        self.mutation = mutation
        self.held = frozenset(held)
        self.method = method


class _MethodVisitor(ast.NodeVisitor):
    """Walks one method body tracking held locks and local lock aliases."""

    def __init__(self, method_name: str, initial_held: Set[str],
                 accesses: List[_Access], lock_attrs: Set[str]):
        self.method = method_name
        self.held: Set[str] = set(initial_held)
        self.accesses = accesses
        self.lock_attrs = lock_attrs      # grown as `with self.X:` is seen
        self.aliases: Dict[str, str] = {}  # local name -> self attr

    # -- helpers ---------------------------------------------------------
    def _record(self, attr: Optional[str], line: int, mutation: bool):
        if attr is not None:
            self.accesses.append(
                _Access(attr, line, mutation, self.held, self.method))

    def _aliased_attr(self, node: ast.AST) -> Optional[str]:
        """Resolve a Name (or Name[...] chain) back to a self attribute."""
        base = attr_chain_base(node)
        attr = self_attr(base)
        if attr is not None:
            return attr
        if isinstance(base, ast.Name):
            return self.aliases.get(base.id)
        return None

    def _mutation_targets(self, target: ast.AST) -> List[ast.AST]:
        if isinstance(target, (ast.Tuple, ast.List)):
            out: List[ast.AST] = []
            for elt in target.elts:
                out.extend(self._mutation_targets(elt))
            return out
        return [target]

    def _record_store(self, target: ast.AST):
        for t in self._mutation_targets(target):
            if isinstance(t, ast.Starred):
                t = t.value
            attr = self_attr(t)
            if attr is not None:               # self.X = ...
                self._record(attr, t.lineno, True)
                continue
            if isinstance(t, (ast.Subscript, ast.Attribute)):
                # self.X[k] = v / self.X.y = v / alias[k] = v
                attr = self._aliased_attr(t)
                if attr is not None:
                    self._record(attr, t.lineno, True)

    def _maybe_alias(self, target: ast.AST, value: ast.AST):
        """Track ``name = self.X`` / ``name = self.X[k]`` aliases."""
        if isinstance(target, (ast.Tuple, ast.List)) and \
                isinstance(value, (ast.Tuple, ast.List)) and \
                len(target.elts) == len(value.elts):
            for t, v in zip(target.elts, value.elts):
                self._maybe_alias(t, v)
            return
        if not isinstance(target, ast.Name):
            return
        base = attr_chain_base(value)
        attr = self_attr(base)
        if attr is not None:
            self.aliases[target.id] = attr
        else:
            self.aliases.pop(target.id, None)

    # -- visitors --------------------------------------------------------
    def visit_With(self, node: ast.With):
        acquired: Set[str] = set()
        for item in node.items:
            expr = item.context_expr
            # `with self._lock:` / `with cond:` where cond aliases self._cond
            attr = self._aliased_attr(expr)
            if attr is not None:
                self.lock_attrs.add(attr)
                acquired.add(attr)
            self.visit(expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        self.held |= acquired
        for stmt in node.body:
            self.visit(stmt)
        self.held -= acquired

    def visit_Assign(self, node: ast.Assign):
        for t in node.targets:
            self._record_store(t)
        self.visit(node.value)
        for t in node.targets:
            self._maybe_alias(t, node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        self._record_store(node.target)
        if node.value is not None:
            self.visit(node.value)
            self._maybe_alias(node.target, node.value)

    def visit_AugAssign(self, node: ast.AugAssign):
        self._record_store(node.target)
        self.visit(node.value)

    def visit_Delete(self, node: ast.Delete):
        for t in node.targets:
            self._record_store(t)
            for child in ast.walk(t):
                if child is not t:
                    self.visit(child)

    def visit_Call(self, node: ast.Call):
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in MUTATOR_METHODS:
            attr = self._aliased_attr(fn.value)
            if attr is not None and attr not in self.lock_attrs:
                self._record(attr, node.lineno, True)
        fname = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else None)
        if node.args and fname in _FIRST_ARG_MUTATORS:
            # heapq.heappush(self._pending[key], item) mutates _pending
            attr = self._aliased_attr(node.args[0])
            if attr is not None and attr not in self.lock_attrs:
                self._record(attr, node.lineno, True)
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute):
        attr = self_attr(node)
        if attr is not None and isinstance(node.ctx, ast.Load):
            self._record(attr, node.lineno, False)
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef):
        # nested closures run with whatever the enclosing context holds at
        # definition point — a pragmatic approximation for local helpers
        for stmt in node.body:
            self.visit(stmt)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda):
        self.visit(node.body)


def _caller_locks(src: ModuleSource, fn: ast.FunctionDef) -> Set[str]:
    held: Set[str] = set()
    for p in src.header_pragmas(fn, "locked-by-caller"):
        p.used = True
        for part in p.reason.split(","):
            part = part.strip()
            if part.startswith("self."):
                part = part[len("self."):]
            if part:
                held.add(part)
    return held


def analyze_class(src: ModuleSource, cls: ast.ClassDef) -> List[Finding]:
    methods = [n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    lock_attrs: Set[str] = set()
    lock_equiv: Dict[str, str] = {}   # cv attr -> the Lock it wraps
    accesses: List[_Access] = []

    # attrs assigned a Lock/RLock/Condition anywhere in the class; a
    # Condition built over an existing lock (``threading.Condition(
    # self._x_lock)``) shares that lock — holding either is holding both
    for m in methods:
        for n in ast.walk(m):
            if isinstance(n, ast.Assign) and _is_lock_factory_value(n.value):
                for t in n.targets:
                    attr = self_attr(t)
                    if attr is None:
                        continue
                    lock_attrs.add(attr)
                    v = n.value
                    if isinstance(v, ast.Call) and v.args:
                        wrapped = self_attr(v.args[0])
                        if wrapped is not None:
                            lock_equiv[attr] = wrapped

    def canon(lock: str) -> str:
        seen_chain = set()
        while lock in lock_equiv and lock not in seen_chain:
            seen_chain.add(lock)
            lock = lock_equiv[lock]
        return lock

    for m in methods:
        visitor = _MethodVisitor(m.name, _caller_locks(src, m),
                                 accesses, lock_attrs)
        for stmt in m.body:
            visitor.visit(stmt)

    if not lock_attrs:
        return []

    # guarded attrs: mutated under some lock, outside construction
    guards: Dict[str, Set[str]] = {}
    for a in accesses:
        if (a.mutation and a.method not in CTOR_METHODS
                and a.attr not in lock_attrs and a.held):
            guards.setdefault(a.attr, set()).update(
                canon(h) for h in a.held)

    findings: List[Finding] = []
    seen: Set[Tuple[int, str]] = set()
    for a in accesses:
        if a.method in CTOR_METHODS or a.attr not in guards:
            continue
        if {canon(h) for h in a.held} & guards[a.attr]:
            continue
        key = (a.line, a.attr)
        if key in seen:
            continue
        seen.add(key)
        kind = "write to" if a.mutation else "read of"
        locks = " or ".join(f"self.{g}" for g in sorted(guards[a.attr]))
        findings.append(Finding(
            src.path, a.line, PASS, "FC-LOCK",
            f"{cls.name}.{a.method}: unguarded {kind} self.{a.attr} "
            f"(guarded by {locks} elsewhere)"))
    return findings


def run(sources: Sequence[ModuleSource]) -> List[Finding]:
    findings: List[Finding] = []
    for src in sources:
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(analyze_class(src, node))
    return findings
