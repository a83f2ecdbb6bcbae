"""broad-except pass.

Invariant: a ``except Exception:`` (or bare ``except:``) whose body
does NOTHING — pass/continue/return — is forbidden in ``_private/``.
Silent swallows in the runtime core hide real failures (a dropped
completion, a dead-letter reply) behind happy-path behavior; at minimum
a swallow must debug-log or bump a drop counter, and a deliberately
silent one must carry ``# lint: broad-except-ok <reason>`` on the
``except`` line so the "why it is safe to ignore" survives review.

Handlers that DO something (assign a fallback, reply an error, log) are
not flagged — the pass targets pure swallows only.
"""

from __future__ import annotations

import ast
from typing import List

from . import registry
from .core import LintTree, Violation, walk

PASS = "broad-except"
RULE = "broad-except"

_BROAD = {"Exception", "BaseException"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except
    if isinstance(t, ast.Name):
        return t.id in _BROAD
    if isinstance(t, ast.Attribute):
        return t.attr in _BROAD
    if isinstance(t, ast.Tuple):
        return any(_is_broad(ast.ExceptHandler(type=e, name=None, body=[]))
                   for e in t.elts)
    return False


def _is_pure_swallow(body: List[ast.stmt]) -> bool:
    for stmt in body:
        if isinstance(stmt, (ast.Pass, ast.Continue, ast.Break)):
            continue
        if isinstance(stmt, ast.Return) and (
                stmt.value is None
                or isinstance(stmt.value, ast.Constant)):
            continue
        if isinstance(stmt, ast.Expr) \
                and isinstance(stmt.value, ast.Constant):
            continue  # docstring/ellipsis
        return False
    return True


def run(tree: LintTree) -> List[Violation]:
    out: List[Violation] = []
    for sf in tree.iter_files(registry.BROAD_EXCEPT_PREFIX):
        for node in walk(sf.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad(node) or not _is_pure_swallow(node.body):
                continue
            if sf.suppressed(RULE, node.lineno):
                continue
            caught = "bare except" if node.type is None \
                else "except " + ast.unparse(node.type)
            out.append(Violation(
                PASS, sf.relpath, node.lineno,
                f"silent swallow ({caught}: pass) in the runtime core — "
                f"debug-log or bump a drop counter, or annotate "
                f"`# lint: {RULE}-ok <reason>` on the except line",
                scope=sf.scope_of(node), key=f"swallow:{caught}"))
    return out
