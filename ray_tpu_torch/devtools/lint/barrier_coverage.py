"""barrier-coverage: every head-bound send is ordered after the
accounting barrier.

The PR 5 round-7/8 hang shape: a worker ships a message the head acts
on (a submission, a put, a pull) while refcount residuals for the ids
it references sit parked in the direct plane's buffers — the head
frees or blocks on an object whose deltas are still in flight. The
repo's discipline is that every head-bound send chokepoint either
calls ``flush_accounting`` first (lexically, in the same function,
before the send) or is a message class that provably references no
buffered accounting state, recorded with a reason in
``registry.BARRIER_EXEMPT``.

Discovered sites: ``*.send(P.CONST, ...)`` / ``*.send_lazy(P.CONST,
...)`` calls in ``registry.BARRIER_SEND_FILES``. Sends routed through
a verified wrapper (``registry.BARRIER_WRAPPERS`` — e.g.
``Worker.request``, which flushes before every request) are covered by
construction; the pass instead verifies each wrapper still flushes
before its first send. Escape hatch for a single site:
``# lint: barrier-ok <reason>``.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from . import registry
from .core import LintTree, Violation, walk

PASS = "barrier-coverage"
RULE = "barrier"


def _p_const(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "P":
        return node.attr
    if isinstance(node, ast.Name) and node.id.isupper():
        return node.id
    return None


def _barrier_lines(fn: ast.AST) -> List[int]:
    out = []
    for node in walk(fn):
        if isinstance(node, ast.Call):
            name = None
            if isinstance(node.func, ast.Name):
                name = node.func.id
            elif isinstance(node.func, ast.Attribute):
                name = node.func.attr
            if name in registry.REF_BARRIER_FUNCS:
                out.append(node.lineno)
    return out


def run(tree: LintTree) -> List[Violation]:
    out: List[Violation] = []
    sent_consts: Set[str] = set()

    for rel in registry.BARRIER_SEND_FILES:
        sf = tree.get(rel)
        if sf is None:
            continue
        for node in walk(sf.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            qual = sf.scope_of(node)
            in_barrier = node.name in registry.REF_BARRIER_FUNCS
            barriers = _barrier_lines(node)
            for sub in walk(node):
                if not (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in registry.BARRIER_SEND_ATTRS
                        and sub.args):
                    continue
                const = _p_const(sub.args[0])
                if const is None:
                    continue
                sent_consts.add(const)
                if in_barrier:
                    continue  # the barrier's own drain sends
                if const in registry.BARRIER_EXEMPT:
                    continue
                if any(ln < sub.lineno for ln in barriers):
                    continue
                if sf.suppressed(RULE, sub.lineno):
                    continue
                out.append(Violation(
                    PASS, rel, sub.lineno,
                    f"head-bound send of P.{const} in {qual} is not "
                    f"preceded by an accounting barrier "
                    f"({'/'.join(sorted(registry.REF_BARRIER_FUNCS))}) — "
                    f"the head can act on ids whose refcount residuals "
                    f"are still parked here (the PR 5 hang shape); "
                    f"flush first, route through a verified wrapper, or "
                    f"add a reasoned registry.BARRIER_EXEMPT entry",
                    scope=qual, key=f"unflushed-send:{const}"))

    # Verified wrappers must actually flush before their first send.
    for rel, qual in sorted(registry.BARRIER_WRAPPERS):
        sf = tree.get(rel)
        if sf is None:
            continue
        fns = sf.functions([qual])
        if not fns:
            out.append(Violation(
                PASS, rel, 1,
                f"registry.BARRIER_WRAPPERS names {qual} which no longer "
                f"exists in {rel} (registry rot)",
                scope="<module>", key=f"stale-wrapper:{qual}"))
            continue
        for fn in fns:
            barriers = _barrier_lines(fn)
            first_send = None
            for sub in walk(fn):
                if isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr in (registry.BARRIER_SEND_ATTRS
                                              | registry.BARRIER_WRAPPER_ATTRS):
                    if first_send is None or sub.lineno < first_send:
                        first_send = sub.lineno
            if first_send is None:
                continue
            if not any(ln < first_send for ln in barriers):
                out.append(Violation(
                    PASS, rel, first_send,
                    f"verified barrier wrapper {qual} no longer calls "
                    f"the accounting barrier before its first send — "
                    f"every site routed through it just lost coverage",
                    scope=qual, key=f"unflushed-wrapper:{qual}"))

    # Exemption hygiene: an exempted constant that is never sent from a
    # discovered chokepoint is registry rot (only when the real files
    # are in the analyzed tree — fixture subsets skip this).
    if all(tree.get(rel) is not None
           for rel in registry.BARRIER_SEND_FILES):
        for const in sorted(set(registry.BARRIER_EXEMPT) - sent_consts):
            out.append(Violation(
                PASS, registry.BARRIER_SEND_FILES[0], 1,
                f"registry.BARRIER_EXEMPT entry {const!r} matches no "
                f"discovered send chokepoint (registry rot)",
                scope="<module>", key=f"stale-exempt:{const}"))
    return out
