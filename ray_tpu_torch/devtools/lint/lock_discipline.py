"""lock-discipline pass.

Invariant: no blocking call sits lexically inside a ``with <lock>:``
suite for a designated hot-path lock (registry.HOT_LOCKS) — socket
send/recv, ``os.writev``/``os.read``, payload pickling, ``time.sleep``,
thread ``.join()``, ``Future.result()``, subprocess, file I/O. These
locks serialize recv loops, dispatch, and writer drains; a holder that
blocks on a peer wedges every other thread behind it (the exact shape
of the blocking-send-under-``_req_lock`` bug fixed in PR 2 review).

``Condition.wait`` is deliberately NOT a blocking call here: waiting on
the condition of the very lock you hold is the one legitimate blocking
operation under a lock (it releases while parked).

Escape hatch: ``# lint: blocking-under-lock-ok <reason>`` on the call
line or the ``with`` line — for sites where the block is bounded and
intentional (e.g. a bounded backpressure wait).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set

from . import registry
from .core import LintTree, SourceFile, Violation, walk

PASS = "lock-discipline"
RULE = "blocking-under-lock"

# Attribute names too generic to match on a non-self receiver (every
# other class has a `_lock`); self-receivers are class-scoped instead.
_GENERIC_ATTRS = {"_lock", "_cond"}

_PICKLERS = {"pickle", "cloudpickle", "serialization", "P"}


def _walk_no_defs(stmts: Iterable[ast.stmt]):
    """Walk statements without descending into nested function/lambda
    bodies (those run later, not under the lock)."""
    stack: List[ast.AST] = list(stmts)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            stack.append(child)


def _blocking_desc(node: ast.Call) -> Optional[str]:
    """A short description when `node` is a blocking call, else None."""
    fn = node.func
    if isinstance(fn, ast.Name):
        if fn.id == "open":
            return "open()"
        return None
    if not isinstance(fn, ast.Attribute):
        return None
    attr = fn.attr
    recv = fn.value.id if isinstance(fn.value, ast.Name) else None
    if attr == "sleep":
        return f"{recv or '<expr>'}.sleep()"
    if recv in ("os", "_os") and attr in registry.BLOCKING_OS_ATTRS:
        return f"os.{attr}()"
    if recv in registry.BLOCKING_MODULES:
        return f"{recv}.{attr}()"
    if attr == "join":
        # str.join takes exactly one iterable arg; a thread/process join
        # takes none or a numeric timeout — only flag the latter shapes.
        if not node.args and not node.keywords:
            return f"{recv or '<expr>'}.join()"
        if len(node.args) == 1 and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, (int, float)):
            return f"{recv or '<expr>'}.join(timeout)"
        return None
    if attr in ("dumps", "dump_message", "dump_messages",
                "dump_message_parts"):
        if recv in _PICKLERS:
            return f"{recv}.{attr}()"
        return None
    if attr in registry.BLOCKING_ATTRS:
        return f"{recv + '.' if recv else ''}{attr}()"
    return None


def _hot_lock_name(sf: SourceFile, item: ast.withitem,
                   class_attrs: Dict[str, Set[str]],
                   file_attrs: Set[str],
                   scope: str) -> Optional[str]:
    expr = item.context_expr
    if not (isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)):
        return None
    recv, attr = expr.value.id, expr.attr
    cls = scope.split(".", 1)[0]
    if recv == "self":
        if attr in class_attrs.get(cls, ()):  # class-scoped designation
            return f"{cls}.{attr}"
        return None
    # Non-self receiver (e.g. `with handle.send_lock:` from the recv
    # mux): match by attr name alone, but only for names unique enough
    # to be unambiguous in this file.
    if attr in file_attrs and attr not in _GENERIC_ATTRS:
        return f"{recv}.{attr}"
    return None


def run(tree: LintTree) -> List[Violation]:
    out: List[Violation] = []
    by_file: Dict[str, Dict[str, Set[str]]] = {}
    for (relpath, cls), attrs in registry.HOT_LOCKS.items():
        by_file.setdefault(relpath, {})[cls] = set(attrs)

    for relpath, class_attrs in sorted(by_file.items()):
        sf = tree.get(relpath)
        if sf is None:
            continue
        file_attrs: Set[str] = set().union(*class_attrs.values())
        for node in walk(sf.tree):
            if not isinstance(node, ast.With):
                continue
            scope = sf.scope_of(node)
            lock = None
            for item in node.items:
                lock = _hot_lock_name(sf, item, class_attrs, file_attrs,
                                      scope)
                if lock:
                    break
            if not lock:
                continue
            for inner in _walk_no_defs(node.body):
                if not isinstance(inner, ast.Call):
                    continue
                desc = _blocking_desc(inner)
                if desc is None:
                    continue
                if sf.suppressed(RULE, inner.lineno, node.lineno):
                    continue
                out.append(Violation(
                    PASS, relpath, inner.lineno,
                    f"blocking call {desc} lexically inside "
                    f"`with {lock}:` — a stalled peer holds the hot "
                    f"lock against every other thread; move the call "
                    f"outside the critical section or annotate "
                    f"`# lint: {RULE}-ok <reason>`",
                    scope=scope, key=f"{lock}:{desc}"))
    return out
