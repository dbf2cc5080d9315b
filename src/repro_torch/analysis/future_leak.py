"""Pass 5 — ResponseFuture leak lint (liveness at the API boundary).

The serving API's liveness contract is that every :class:`ResponseFuture` a
caller can block on eventually resolves — the overload/fault machinery
(watchdog, shed errors, drain-on-shutdown) exists to guarantee it.  That
guarantee is easiest to break at the source: a future constructed and then
dropped on an early-return path resolves never, and the submitter hangs.

This pass flags every ``ResponseFuture(...)`` construction that, within the
same function, is neither

- *resolved* — ``.set_result(...)`` / ``.set_exception(...)`` /
  ``.cancel()`` called on it,
- *returned or yielded* — ownership passes to the caller,
- *handed off* — passed as an argument to any call (registration in an
  admission record, ``_try_fail(fut, ...)``, ``list.append``), or stored
  into an attribute / container slot (``self._futs[k] = fut``),

nor a bare-expression construction (created and immediately dropped — no
name ever binds it, nothing can resolve it).

The check is intraprocedural and name-based: handing the future anywhere
counts as discharging the obligation, so the pass only catches the
outright leak, not a callee that forgets.  That is deliberate — the
fan-out makes whole-graph tracking noisy, and the leak-at-birth case is
the one the overload work actually hit.  Deliberate leaks (test
fixtures building dead futures on purpose) carry
``# flamecheck: future-ok(reason)``.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Sequence

from repro_torch.analysis.common import Finding, ModuleSource, walk_scoped

PASS = "future-leak"

#: constructor names whose result carries the resolve-or-hang obligation
FUTURE_CTORS = {"ResponseFuture"}
#: attribute calls on the future that discharge the obligation
RESOLVE_METHODS = {"set_result", "set_exception", "cancel"}


def _ctor_name(call: ast.Call) -> Optional[str]:
    f = call.func
    name = f.id if isinstance(f, ast.Name) else (
        f.attr if isinstance(f, ast.Attribute) else None)
    return name if name in FUTURE_CTORS else None


def _mentions(node: ast.AST, name: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == name
               for n in ast.walk(node))


def _is_discharged(fn: ast.AST, name: str, birth: ast.Assign) -> bool:
    """Does ``fn`` resolve, return, or hand off the future bound to
    ``name``?  Closures count: a nested def that resolves it is a valid
    discharge (the watchdog-forget callback pattern)."""
    for n in ast.walk(fn):
        if isinstance(n, ast.Call):
            f = n.func
            # fut.set_result(...) / fut.set_exception(...) / fut.cancel()
            if (isinstance(f, ast.Attribute) and f.attr in RESOLVE_METHODS
                    and isinstance(f.value, ast.Name)
                    and f.value.id == name):
                return True
            # handed off as an argument: record(fut=...), append(fut), ...
            for arg in list(n.args) + [kw.value for kw in n.keywords]:
                if _mentions(arg, name):
                    return True
        elif isinstance(n, (ast.Return, ast.Yield, ast.YieldFrom)):
            if n.value is not None and _mentions(n.value, name):
                return True
        elif isinstance(n, ast.Assign) and n is not birth:
            # stored into shared state: self._futs[k] = fut / d[k] = fut
            if _mentions(n.value, name):
                for t in n.targets:
                    if isinstance(t, (ast.Attribute, ast.Subscript)):
                        return True
    return False


def _scan_function(src: ModuleSource, cls: Optional[str],
                   fn: ast.AST) -> List[Finding]:
    qual = f"{cls}.{fn.name}" if cls else fn.name
    out: List[Finding] = []
    for n in walk_scoped(fn):
        if isinstance(n, ast.Expr) and isinstance(n.value, ast.Call):
            ctor = _ctor_name(n.value)
            if ctor is not None:
                out.append(Finding(
                    src.path, n.lineno, PASS, "FC-FUTURE",
                    f"{qual}: {ctor}() constructed and dropped — nothing "
                    f"can ever resolve it, a blocked caller hangs"))
        elif isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
            ctor = _ctor_name(n.value)
            if ctor is None:
                continue
            names = [t.id for t in n.targets if isinstance(t, ast.Name)]
            if not names:
                continue  # attribute/subscript target IS the hand-off
            if not any(_is_discharged(fn, name, n) for name in names):
                out.append(Finding(
                    src.path, n.lineno, PASS, "FC-FUTURE",
                    f"{qual}: {ctor}() bound to {names[0]!r} is never "
                    f"resolved, returned, or handed off — a caller "
                    f"blocking on .result() hangs forever"))
    return out


def run(sources: Sequence[ModuleSource]) -> List[Finding]:
    findings: List[Finding] = []
    for src in sources:
        for top in src.tree.body:
            if isinstance(top, (ast.FunctionDef, ast.AsyncFunctionDef)):
                findings.extend(_scan_function(src, None, top))
            elif isinstance(top, ast.ClassDef):
                for item in top.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        findings.extend(
                            _scan_function(src, top.name, item))
    return findings
