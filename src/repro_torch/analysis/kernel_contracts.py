"""Pass 4 — the CUDA kernels' C ABI and launch contracts.

The port of ``repro/analysis/kernel_contracts.py``, for the ``ctypes``
wrappers in place of Pallas.  Each binding
``_build.function(lib, symbol, argtypes)`` in a wrapper module is held
against ``csrc/<lib>.cu`` (the ``csrc`` directory nearest above the
module), read as text with its comments stripped.  The rules answer JAX's
K1-K3:

``FC-ABI-SYMBOL`` / ``FC-ABI-ARITY`` / ``FC-ABI-KIND`` (JAX's K3, arity
    misbinding): ``symbol`` is an ``extern "C"`` function of the source,
    ``argtypes`` (a list display, ``+`` / ``*`` of them, or a module-level
    constant) has its parameter count, and each argtype its parameter's
    kind — pointer, ``int``, ``long long``, ``float``.  A ``ctypes`` call
    converts whatever it is given, so a dropped or extra argtype misbinds
    every argument after it without an error.  An out-buffer handed to
    the function — ``(ctypes.c_X * n)()`` or ``ctypes.byref(ctypes.c_X())``
    — must have the element width of the C pointee.

``FC-LAUNCH-STREAM`` (JAX's K1, the index map's purity; here a launch that
    depends only on what a capture records): every call of a ``*_fwd``
    entry passes ``_build.stream_handle(...)`` as its ``stream`` — a 0 or a
    ``None`` launches on the legacy stream, outside both the capture and
    the dispatcher's stream.

``FC-NO-DIM-GUARD`` / ``FC-NO-GRAD-GUARD`` (JAX's K2, the pad guard): a
    wrapper that launches a ``*_fwd`` entry first takes a route or plan
    decision or raises on dims, and first calls ``_build.forbid_grad`` —
    in the launching function, in a function of its module it calls
    before the launch, or in every function of its module that calls it.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.common import Finding, ModuleSource, dotted_name

PASS = "kernel-contract"

#: ctypes type -> kind (``ptr`` for every pointer)
_CTYPES = {
    "c_void_p": "ptr", "c_char_p": "ptr", "c_wchar_p": "ptr",
    "c_int": "int", "c_int32": "int", "c_uint": "int", "c_uint32": "int",
    "c_longlong": "long long", "c_int64": "long long",
    "c_ulonglong": "long long", "c_uint64": "long long",
    "c_size_t": "long long", "c_ssize_t": "long long",
    "c_float": "float", "c_double": "double",
}
#: C scalar type -> kind
_C_SCALARS = {
    "int": "int", "int32_t": "int", "unsigned": "int", "unsigned int": "int",
    "uint32_t": "int", "long long": "long long", "int64_t": "long long",
    "unsigned long long": "long long", "uint64_t": "long long",
    "size_t": "long long", "float": "float", "double": "double",
}
_C_POINTERS = {"cudaStream_t"}
_EXTERN_RE = re.compile(
    r'extern\s+"C"\s+[^;{}()]*?\b(\w+)\s*\(([^)]*)\)\s*\{')


# -- the C side ----------------------------------------------------------

class CParam:
    __slots__ = ("name", "kind", "pointee")

    def __init__(self, decl: str):
        decl = " ".join(decl.replace("*", " * ").split())
        words = [w for w in decl.split() if w not in ("const", "volatile",
                                                       "__restrict__")]
        stars = words.count("*")
        words = [w for w in words if w != "*"]
        self.name = words[-1] if len(words) > 1 else ""
        base = " ".join(words[:-1] if len(words) > 1 else words)
        if stars or base in _C_POINTERS:
            self.kind = "ptr"
            self.pointee = _C_SCALARS.get(base) if stars == 1 else None
        else:
            self.kind = _C_SCALARS.get(base, base)
            self.pointee = None


def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def c_functions(path: str) -> Dict[str, List[CParam]]:
    """The ``extern "C"`` functions defined in a CUDA source: name ->
    parameters."""
    with open(path, "r", encoding="utf-8") as f:
        text = _strip_comments(f.read())
    out: Dict[str, List[CParam]] = {}
    for m in _EXTERN_RE.finditer(text):
        params = [p.strip() for p in m.group(2).split(",") if p.strip()]
        if params == ["void"]:
            params = []
        out[m.group(1)] = [CParam(p) for p in params]
    return out


def _csrc(module_path: str, lib: str) -> Optional[str]:
    """``csrc/<lib>.cu`` of the package a wrapper is in: beside the package's
    ``kernels`` directory, where ``_build`` compiles it from."""
    parts = os.path.abspath(module_path).split(os.sep)[:-1]
    if "kernels" not in parts:
        return None
    root = parts[:len(parts) - 1 - parts[::-1].index("kernels")]
    cand = os.sep.join(root + ["csrc", f"{lib}.cu"])
    return cand if os.path.exists(cand) else None


# -- the Python side -----------------------------------------------------

def _ctype_kind(node: ast.AST) -> Optional[str]:
    dn = dotted_name(node)
    if dn is not None:
        return _CTYPES.get(dn.split(".")[-1])
    if isinstance(node, ast.Call) and dotted_name(node.func) in (
            "ctypes.POINTER", "POINTER"):
        return "ptr"
    return None


def _argtypes(node: ast.AST, consts: Dict[str, ast.AST],
              depth: int = 0) -> Optional[List[str]]:
    """The kinds an argtypes expression lists, or None if it is not
    resolvable from the module's text."""
    if depth > 8:
        return None
    if isinstance(node, (ast.List, ast.Tuple)):
        kinds = [_ctype_kind(e) for e in node.elts]
        return None if None in kinds else kinds
    if isinstance(node, ast.Name) and node.id in consts:
        return _argtypes(consts[node.id], consts, depth + 1)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a = _argtypes(node.left, consts, depth + 1)
        b = _argtypes(node.right, consts, depth + 1)
        return None if a is None or b is None else a + b
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for seq, n in ((node.left, node.right), (node.right, node.left)):
            if isinstance(n, ast.Constant) and isinstance(n.value, int):
                a = _argtypes(seq, consts, depth + 1)
                return None if a is None else a * n.value
    return None


def _module_consts(src: ModuleSource) -> Dict[str, ast.AST]:
    out: Dict[str, ast.AST] = {}
    for stmt in src.tree.body:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = stmt.value
    return out


def _is_binding(call: ast.AST) -> bool:
    return isinstance(call, ast.Call) and dotted_name(call.func) in (
        "_build.function", "function") and len(call.args) == 3


def _top_defs(src: ModuleSource) -> List[ast.AST]:
    out = []
    for top in src.tree.body:
        if isinstance(top, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(top)
        elif isinstance(top, ast.ClassDef):
            out.extend(i for i in top.body
                       if isinstance(i, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)))
    return out


class _Binding:
    """One ``_build.function(lib, symbol, argtypes)`` call, the def it is
    in, and the calls of the function it returns."""
    __slots__ = ("call", "lib", "symbol", "fn", "launches")

    def __init__(self, call, lib, symbol, fn):
        self.call = call
        self.lib = lib
        self.symbol = symbol
        self.fn = fn               # the def it is in
        self.launches: List[ast.Call] = []


def _bindings(src: ModuleSource) -> List[_Binding]:
    out: List[_Binding] = []
    for fn in _top_defs(src):
        mine: List[_Binding] = []
        for n in ast.walk(fn):
            if not _is_binding(n):
                continue
            lib, sym = n.args[0], n.args[1]
            if isinstance(lib, ast.Constant) and isinstance(sym, ast.Constant):
                mine.append(_Binding(n, str(lib.value), str(sym.value), fn))
        # ``fn = _build.function(...)``: a call of ``fn`` launches the
        # binding assigned to it last before the call
        assigned: List[Tuple[int, str, _Binding]] = []
        for n in ast.walk(fn):
            if isinstance(n, ast.Assign):
                for b in mine:
                    if b.call is n.value:
                        assigned.extend((n.lineno, t.id, b) for t in n.targets
                                        if isinstance(t, ast.Name))
        for n in ast.walk(fn):
            if not isinstance(n, ast.Call):
                continue
            if isinstance(n.func, ast.Name):
                last = max((a for a in assigned if a[1] == n.func.id
                            and a[0] <= n.lineno),
                           key=lambda a: a[0], default=None)
                if last is not None:
                    last[2].launches.append(n)
            for b in mine:
                if n.func is b.call:
                    b.launches.append(n)
        out.extend(mine)
    return out


def _scalar_ctor(node: ast.AST) -> Optional[str]:
    """``ctypes.c_X(...)`` or ``(ctypes.c_X * n)()`` -> the kind of X."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.BinOp) and isinstance(f.op, ast.Mult):
        return _ctype_kind(f.left) or _ctype_kind(f.right)
    return _ctype_kind(f)


def _buffer_kind(arg: ast.AST, line: int,
                 local: Dict[str, List[Tuple[int, ast.AST]]]
                 ) -> Optional[str]:
    """The element kind of an out-buffer argument of a call at ``line``,
    where it is one (a name: its last assignment before the call)."""
    if isinstance(arg, ast.Call) and dotted_name(arg.func) in (
            "ctypes.byref", "byref", "ctypes.pointer") and arg.args:
        arg = arg.args[0]
    elif not (isinstance(arg, ast.Name) or isinstance(arg, ast.Call)
              and isinstance(arg.func, ast.BinOp)):
        return None
    if isinstance(arg, ast.Name):
        last = max((a for a in local.get(arg.id, ()) if a[0] <= line),
                   key=lambda a: a[0], default=None)
        if last is None:
            return None
        arg = last[1]
    return _scalar_ctor(arg)


def _local_values(fn: ast.AST) -> Dict[str, List[Tuple[int, ast.AST]]]:
    out: Dict[str, List[Tuple[int, ast.AST]]] = {}
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                isinstance(n.targets[0], ast.Name):
            out.setdefault(n.targets[0].id, []).append((n.lineno, n.value))
    return out


def _abi(src: ModuleSource, b: _Binding, consts, cu: Optional[str],
         params: Optional[List[CParam]]) -> List[Finding]:
    def finding(line, code, msg):
        return Finding(src.path, line, PASS, code,
                       f"{b.fn.name}: {b.lib}.{b.symbol}: {msg}")

    line = b.call.lineno
    if params is None:
        where = f"csrc/{b.lib}.cu" if cu else f"no csrc/{b.lib}.cu"
        return [finding(line, "FC-ABI-SYMBOL",
                        f"not an extern \"C\" function of {where}")]
    kinds = _argtypes(b.call.args[2], consts)
    if kinds is None:
        return [finding(line, "FC-ABI-ARITY",
                        "argtypes not resolvable from the module's text — "
                        "its arity cannot be checked")]
    if len(kinds) != len(params):
        return [finding(line, "FC-ABI-ARITY",
                        f"{len(kinds)} argtypes for {len(params)} C "
                        f"parameters — every argument after the first "
                        f"difference misbinds")]
    out = []
    for i, (k, p) in enumerate(zip(kinds, params)):
        if k != p.kind:
            out.append(finding(line, "FC-ABI-KIND",
                               f"argtype {i} is {k}, C parameter {p.name!r} "
                               f"is {p.kind}"))
    local = _local_values(b.fn)
    for call in b.launches:
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred) or i >= len(params):
                break
            want = params[i].pointee
            got = _buffer_kind(arg, call.lineno, local)
            if got is not None and want is not None and got != want:
                out.append(finding(
                    call.lineno, "FC-ABI-KIND",
                    f"argument {i} is a buffer of {got}, C parameter "
                    f"{params[i].name!r} points to {want}"))
    return out


def _stream(src: ModuleSource, b: _Binding,
            params: Optional[List[CParam]]) -> List[Finding]:
    if not b.symbol.endswith("_fwd") or params is None:
        return []
    at = [i for i, p in enumerate(params) if "stream" in p.name]
    out = []
    for call in b.launches:
        if not at:
            out.append(Finding(
                src.path, call.lineno, PASS, "FC-LAUNCH-STREAM",
                f"{b.fn.name}: {b.symbol} takes no stream — it launches on "
                f"the legacy stream"))
            continue
        if any(isinstance(a, ast.Starred) for a in call.args[:at[0] + 1]) \
                or at[0] >= len(call.args):
            continue
        arg = call.args[at[0]]
        dn = dotted_name(arg.func) if isinstance(arg, ast.Call) else None
        if dn is None or dn.split(".")[-1] != "stream_handle":
            out.append(Finding(
                src.path, call.lineno, PASS, "FC-LAUNCH-STREAM",
                f"{b.fn.name}: {b.symbol}'s stream is not "
                f"_build.stream_handle(...) — a launch outside the current "
                f"stream escapes both a capture and the dispatcher's "
                f"stream"))
    return out


# -- the guards ----------------------------------------------------------

def _dim_names(fn: ast.AST) -> Set[str]:
    """Locals unpacked or assigned from shape metadata."""
    out: Set[str] = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign) and _mentions_dims(n.value, set()):
            for t in n.targets:
                for e in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                          else [t]):
                    if isinstance(e, ast.Name):
                        out.add(e.id)
    return out


def _mentions_dims(expr: ast.AST, names: Set[str]) -> bool:
    for n in ast.walk(expr):
        if isinstance(n, ast.Attribute) and n.attr in ("shape", "ndim"):
            return True
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr in ("dim", "size", "stride", "numel"):
            return True
        if isinstance(n, ast.Call) and dotted_name(n.func) == "len":
            return True
        if isinstance(n, ast.Name) and n.id in names:
            return True
    return False


def _dim_guard_at(fn: ast.AST) -> List[int]:
    """Lines of ``fn``'s dim guards: a route / plan call, or a raise under
    an ``if`` on dims."""
    names = _dim_names(fn)
    out = []
    for n in ast.walk(fn):
        if isinstance(n, ast.Call):
            dn = dotted_name(n.func) or ""
            last = dn.split(".")[-1]
            if "route" in last or "plan" in last:
                out.append(n.lineno)
        elif isinstance(n, ast.If) and _mentions_dims(n.test, names) and \
                any(isinstance(s, ast.Raise) for b in n.body
                    for s in ast.walk(b)):
            out.append(n.lineno)
    return out


def _grad_guard_at(fn: ast.AST) -> List[int]:
    return [n.lineno for n in ast.walk(fn) if isinstance(n, ast.Call)
            and (dotted_name(n.func) or "").split(".")[-1] == "forbid_grad"]


class _Guards:
    """Whether a module's functions are guarded before a line."""

    def __init__(self, src: ModuleSource, direct):
        self.defs = {d.name: d for d in _top_defs(src)}
        self.direct = direct
        self._has: Dict[str, bool] = {}

    def _refs(self, fn: ast.AST) -> List[Tuple[str, int]]:
        """Module functions ``fn`` names (calls or references), by line."""
        return [(n.id, n.lineno) for n in ast.walk(fn)
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
                and n.id in self.defs and n.id != fn.name]

    def has(self, name: str, seen: Set[str]) -> bool:
        """``name`` guards somewhere in its body, itself or through a module
        function it names."""
        if name not in self._has:
            if name in seen:
                return False
            fn = self.defs[name]
            self._has[name] = bool(self.direct(fn)) or any(
                self.has(r, seen | {name}) for r, _ in self._refs(fn))
        return self._has[name]

    def before(self, fn: ast.AST, line: int, seen: Set[str]) -> bool:
        if any(g < line for g in self.direct(fn)):
            return True
        if any(ln < line and self.has(r, {fn.name})
               for r, ln in self._refs(fn)):
            return True
        callers = [(c, ln) for c in self.defs.values() if c is not fn
                   for r, ln in self._refs(c) if r == fn.name]
        if not callers or fn.name in seen:
            return False
        return all(self.before(c, ln, seen | {fn.name}) for c, ln in callers)


def _guards(src: ModuleSource, bindings: List[_Binding]) -> List[Finding]:
    dims = _Guards(src, _dim_guard_at)
    grads = _Guards(src, _grad_guard_at)
    out = []
    for b in bindings:
        if not b.symbol.endswith("_fwd"):
            continue
        for call in b.launches:
            if not dims.before(b.fn, call.lineno, set()):
                out.append(Finding(
                    src.path, call.lineno, PASS, "FC-NO-DIM-GUARD",
                    f"{b.fn.name}: launches {b.symbol} with no route / plan "
                    f"decision or raise on dims before it — the kernel gets "
                    f"dims its grid may not cover"))
            if not grads.before(b.fn, call.lineno, set()):
                out.append(Finding(
                    src.path, call.lineno, PASS, "FC-NO-GRAD-GUARD",
                    f"{b.fn.name}: launches {b.symbol} without "
                    f"_build.forbid_grad first — the kernel has no "
                    f"backward, so autograd would be cut silently"))
    return out


def run(sources: Sequence[ModuleSource]) -> List[Finding]:
    out: List[Finding] = []
    for src in sources:
        bindings = _bindings(src)
        if not bindings:
            continue
        consts = _module_consts(src)
        for b in bindings:
            cu = _csrc(src.path, b.lib)
            params = c_functions(cu).get(b.symbol) if cu else None
            out.extend(_abi(src, b, consts, cu, params))
            out.extend(_stream(src, b, params))
        out.extend(_guards(src, bindings))
    return out
