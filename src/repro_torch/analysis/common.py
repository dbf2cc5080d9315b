"""Shared infrastructure for flamecheck on the PyTorch port
(`repro_torch.analysis`; a copy of ``repro/analysis/common.py``).

flamecheck is a repo-specific, stdlib-only static-analysis suite: it parses
the serving/core/kernel modules with :mod:`ast` and checks the invariants the
FLAME reproduction's performance story rests on (lock discipline, no hidden
host syncs on the hot path, no CUDA-graph capture hazards, the CUDA kernels'
C ABI and launch contracts, no leaked response futures).  It deliberately
imports neither torch nor numpy so `python -m repro_torch.analysis` stays
fast enough to gate CI.

Pragmas
-------
Findings are suppressed with written justifications::

    x = self._pending[key]  # flamecheck: unguarded-ok(dict frozen after init)

Grammar: ``# flamecheck: <token>(<reason>)``.  Several pragmas may share one
comment, separated by whitespace.  Suppression tokens map 1:1 to passes:

==================  =====================
pass                token
==================  =====================
lock-discipline     ``unguarded-ok``
host-sync           ``host-sync-ok``
recompile           ``recompile-ok``
kernel-contract     ``kernel-ok``
future-leak         ``future-ok``
==================  =====================

A pragma suppresses a finding when it sits on the finding's line, on the
header of an enclosing ``def`` (between ``def`` and the first body
statement), or on the header of an enclosing ``class``.  ``host-sync-ok``
is the exception: it suppresses only the statement it sits on, so every
sync carries its own reason and a sync added later to the same function is
reported.  So is ``recompile-ok`` on the recompile pass's capture rules
(``FC-CAPTURE-HOT``, ``FC-CAPTURE-FROZEN``): a capture or a frozen read
added later to a function with a reason for another is reported too.

One pragma is *semantic* rather than suppressive:
``locked-by-caller(self._lock)`` on a method header tells the
lock-discipline pass to analyze the body as if the named lock were held on
entry (for helpers whose docstring says "caller holds the lock").

``--strict`` additionally fails on pragmas with empty reasons and pragmas
that suppress nothing (so stale justifications rot loudly, not silently).
"""
from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

PRAGMA_RE = re.compile(r"flamecheck:\s*((?:[a-z-]+\([^)]*\)\s*)+)")
PRAGMA_ITEM_RE = re.compile(r"([a-z-]+)\(([^)]*)\)")

#: pass name -> pragma token that suppresses its findings
SUPPRESS_TOKENS = {
    "lock-discipline": "unguarded-ok",
    "host-sync": "host-sync-ok",
    "recompile": "recompile-ok",
    "kernel-contract": "kernel-ok",
    "future-leak": "future-ok",
}
#: tokens with semantics beyond suppression (never "unused")
SEMANTIC_TOKENS = {"locked-by-caller"}
KNOWN_TOKENS = set(SUPPRESS_TOKENS.values()) | SEMANTIC_TOKENS
#: tokens that suppress only the statement they sit on, never a whole scope
STATEMENT_TOKENS = {"host-sync-ok"}
#: finding codes whose pragma covers only their statement, whatever the
#: token's scope for the pass's other codes
STATEMENT_CODES = {"FC-CAPTURE-HOT", "FC-CAPTURE-FROZEN"}


@dataclasses.dataclass
class Pragma:
    token: str
    reason: str
    line: int
    used: bool = False


@dataclasses.dataclass
class Finding:
    path: str
    line: int
    pass_name: str
    code: str
    message: str
    suppressed: bool = False

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.code}] {self.message}"

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


def _iter_pragmas(text: str) -> Iterable[Pragma]:
    reader = io.StringIO(text).readline
    try:
        tokens = list(tokenize.generate_tokens(reader))
    except tokenize.TokenError:
        return
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = PRAGMA_RE.search(tok.string)
        if not m:
            continue
        for token, reason in PRAGMA_ITEM_RE.findall(m.group(1)):
            yield Pragma(token=token, reason=reason.strip(),
                         line=tok.start[0])


class ModuleSource:
    """A parsed module plus its pragmas and scope map."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.tree = ast.parse(text, filename=path)
        self.pragmas: Dict[int, List[Pragma]] = {}
        for p in _iter_pragmas(text):
            self.pragmas.setdefault(p.line, []).append(p)
        # (lineno, header_end, end_lineno) for every def/class, innermost last
        self._scopes: List[Tuple[int, int, int]] = []
        # line spans of simple (non-compound) statements, so a pragma may
        # trail any line of a multi-line statement
        self._stmt_spans: List[Tuple[int, int]] = []
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                header_end = node.body[0].lineno - 1 if node.body \
                    else node.lineno
                self._scopes.append(
                    (node.lineno, max(node.lineno, header_end),
                     node.end_lineno or node.lineno))
            elif isinstance(node, (ast.If, ast.While)):
                # a pragma may trail any line of a multi-line condition
                end = node.test.end_lineno or node.test.lineno
                if end > node.lineno:
                    self._stmt_spans.append((node.lineno, end))
            elif isinstance(node, ast.stmt) and not isinstance(
                    node, (ast.For, ast.AsyncFor,
                           ast.With, ast.AsyncWith, ast.Try)):
                end = node.end_lineno or node.lineno
                if end > node.lineno:
                    self._stmt_spans.append((node.lineno, end))

    @classmethod
    def load(cls, path: str) -> "ModuleSource":
        with open(path, "r", encoding="utf-8") as f:
            return cls(path, f.read())

    # -- pragma lookup ---------------------------------------------------
    def pragma_lines_for(self, line: int, scopes: bool = True) -> Set[int]:
        """Lines whose pragmas may suppress a finding at ``line``: its
        statement's, and with ``scopes`` the headers of the defs and
        classes around it."""
        lines = {line}
        for start, end in self._stmt_spans:
            if start <= line <= end:
                lines.update(range(start, end + 1))
        if scopes:
            for start, header_end, end in self._scopes:
                if start <= line <= end:
                    lines.update(range(start, header_end + 1))
        return lines

    def suppress(self, finding: Finding) -> bool:
        """Mark ``finding`` suppressed if a matching pragma covers it."""
        token = SUPPRESS_TOKENS.get(finding.pass_name)
        if token is None:
            return False
        lines = self.pragma_lines_for(
            finding.line, scopes=token not in STATEMENT_TOKENS
            and finding.code not in STATEMENT_CODES)
        for ln in sorted(lines):
            for p in self.pragmas.get(ln, []):
                if p.token == token:
                    p.used = True
                    finding.suppressed = True
                    return True
        return False

    def header_pragmas(self, node: ast.AST, token: str) -> List[Pragma]:
        """Pragmas with ``token`` on the header lines of a def/class."""
        body = getattr(node, "body", None)
        header_end = body[0].lineno - 1 if body else node.lineno
        out = []
        for ln in range(node.lineno, max(node.lineno, header_end) + 1):
            for p in self.pragmas.get(ln, []):
                if p.token == token:
                    out.append(p)
        return out

    # -- strict-mode checks ----------------------------------------------
    def pragma_findings(self) -> List[Finding]:
        out = []
        for plist in self.pragmas.values():
            for p in plist:
                if p.token not in KNOWN_TOKENS:
                    out.append(Finding(
                        self.path, p.line, "pragma", "FC-PRAGMA-UNKNOWN",
                        f"unknown flamecheck pragma token {p.token!r}"))
                if not p.reason:
                    out.append(Finding(
                        self.path, p.line, "pragma", "FC-PRAGMA-REASON",
                        f"flamecheck pragma {p.token!r} has an empty reason "
                        f"— justify the suppression"))
                if (p.token not in SEMANTIC_TOKENS and not p.used
                        and p.token in KNOWN_TOKENS):
                    out.append(Finding(
                        self.path, p.line, "pragma", "FC-PRAGMA-UNUSED",
                        f"flamecheck pragma {p.token!r} suppresses nothing "
                        f"— remove it or fix its placement"))
        return out


# -- small AST helpers shared by passes ----------------------------------

def self_attr(node: ast.AST) -> Optional[str]:
    """``self.X`` -> ``'X'`` else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def attr_chain_base(node: ast.AST) -> ast.AST:
    """Peel Subscript/Attribute layers: ``self.X[k].y`` -> the self.X node."""
    while True:
        if isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Attribute) and self_attr(node) is None:
            node = node.value
        else:
            return node


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` -> ``'a.b.c'`` for pure Name/Attribute chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def walk_scoped(node: ast.AST) -> Iterable[ast.AST]:
    """ast.walk that does not descend into nested def/class scopes."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(n))
