"""protocol-order pass.

Invariant: frames are SENT in a legal session order, not merely
dispatched somewhere (protocol-coverage's job). Three mechanical
properties of the wire protocol, checked against the declarative model
in ``ray_tpu_torch/_private/protocol_model.py``:

  * **send legality** — every send site's constant must be a legal
    transition from the states its enclosing function is registered to
    run in (registry.PROTOCOL_SEND_FUNCS, the RECV_LOOPS dual). A send
    from an unregistered function fails: like an unregistered recv
    loop, it would dodge the ordering contract.
  * **response paths** — every constant sent through a request wrapper
    must be registered in protocol_model.REQUESTS, and each registered
    request's response constant must actually be dispatched by the
    requester's recv loop (verified against RECV_LOOPS spans) — a
    request whose reply nothing consumes hangs its future forever.
  * **no send after teardown** — a send on a connection lexically after
    that same connection's ``close()`` in one function is a frame into
    a dead socket.

Model rot is checked both ways: a plane constant no session models is
a violation (new constants register against the DFA on day one), and a
model entry naming a constant protocol.py no longer defines is too.
Escape hatch: ``# lint: protocol-order-ok <reason>`` on the send line;
an annotation that suppresses nothing is itself flagged (stale).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..._private import protocol_model
from . import registry
from .core import LintTree, SourceFile, Violation, walk
from .protocol_coverage import PROTOCOL_FILE, dispatched_constants, \
    parse_planes

PASS = "protocol-order"
RULE = "protocol-order"

_REQUEST_ATTRS = frozenset({"request", "_request"})


# ---------------------------------------------------------------------------
# send-site discovery (shared with payload_schema)
# ---------------------------------------------------------------------------
def send_const(call: ast.Call) -> Optional[str]:
    """The protocol-constant name a send call names, if any: first
    positional arg shaped ``P.CONST`` or bare ``CONST``."""
    if not (isinstance(call.func, ast.Attribute)
            and call.func.attr in registry.PROTOCOL_SEND_ATTRS
            and call.args):
        return None
    a = call.args[0]
    if isinstance(a, ast.Attribute) and a.attr == a.attr.upper() \
            and isinstance(a.value, ast.Name):
        return a.attr
    if isinstance(a, ast.Name) and a.id == a.id.upper():
        return a.id
    return None


def iter_send_sites(sf: SourceFile, consts: Set[str]
                    ) -> Iterable[Tuple[ast.Call, str, str]]:
    """Yield (call, CONST, enclosing qualname) for every send of a
    protocol constant in `sf`."""
    for node in walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        const = send_const(node)
        if const is not None and const in consts:
            yield node, const, sf.scope_of(node)


def lookup_send_entries(relpath: str, qual: str):
    """PROTOCOL_SEND_FUNCS entries for `qual`, walking up dotted
    prefixes so nested defs inherit their enclosing registration."""
    parts = qual.split(".")
    for end in range(len(parts), 0, -1):
        hit = registry.PROTOCOL_SEND_FUNCS.get(
            (relpath, ".".join(parts[:end])))
        if hit is not None:
            return hit
    return None


# ---------------------------------------------------------------------------
# suppression tracking (with rot detection)
# ---------------------------------------------------------------------------
class Suppressions:
    """Per-run ledger of which ``<rule>-ok`` annotations earned their
    keep; the leftovers are stale (rot detection). Shared with the
    payload-schema pass."""

    def __init__(self, pass_name: str, rule: str) -> None:
        self.pass_name = pass_name
        self.rule = rule
        self.used: Set[Tuple[str, int]] = set()

    def consume(self, sf: SourceFile, node: ast.AST) -> bool:
        lines = range(node.lineno, (node.end_lineno or node.lineno) + 1)
        hit = False
        for ln in lines:
            entry = sf.suppressions.get(ln)
            if entry and entry[0] == self.rule and entry[1]:
                self.used.add((sf.relpath, ln))
                hit = True
        return hit

    def stale(self, tree: LintTree) -> List[Violation]:
        out: List[Violation] = []
        for sf in tree.iter_files():
            if sf.relpath.startswith("devtools/lint"):
                continue  # the linter's own docs MENTION the pattern
            for ln, (rule, reason) in sorted(sf.suppressions.items()):
                if rule != self.rule or not reason:
                    continue
                if (sf.relpath, ln) in self.used:
                    continue
                out.append(Violation(
                    self.pass_name, sf.relpath, ln,
                    f"stale annotation: this 'lint: {self.rule}-ok' "
                    f"comment suppressed nothing in this run — the "
                    f"deviation it documented is gone; remove it",
                    scope=_scope_at_line(sf, ln),
                    key="stale-annotation"))
        return out


def _scope_at_line(sf: SourceFile, line: int) -> str:
    best = "<module>"
    best_span = None
    for node in walk(sf.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        end = node.end_lineno or node.lineno
        if node.lineno <= line <= end:
            span = end - node.lineno
            if best_span is None or span < best_span:
                best, best_span = sf.scope_of(node), span
    return best


# ---------------------------------------------------------------------------
# teardown analysis
# ---------------------------------------------------------------------------
def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None  # call/subscript receivers: not a stable name


def _close_sites(fn: ast.AST) -> List[Tuple[int, str]]:
    out: List[Tuple[int, str]] = []
    for node in walk(fn):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in registry.PROTOCOL_CLOSE_ATTRS \
                and not node.args:
            recv = _dotted(node.func.value)
            if recv is not None:
                out.append((node.lineno, recv))
    return out


def _prefix_match(a: str, b: str) -> bool:
    return a == b or a.startswith(b + ".") or b.startswith(a + ".")


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------
def _const_lines(proto: SourceFile) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for node in proto.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = node.lineno
    return out


def _model_constants() -> Set[str]:
    names = protocol_model.all_modeled_constants()
    for const, req in protocol_model.REQUESTS.items():
        names.add(const)
        names.add(req["response"])
    names.update(protocol_model.PAYLOADS)
    return names


def _describe_entries(entries) -> str:
    return ", ".join(f"{s}/{r}@{'|'.join(states)}"
                     for s, r, states in entries)


def run(tree: LintTree) -> List[Violation]:
    proto = tree.get(PROTOCOL_FILE)
    if proto is None:
        return []  # fixture tree without a protocol module
    planes, _ = parse_planes(proto)  # plane parse errors belong to
    all_consts: Set[str] = set().union(*planes.values())  # coverage pass
    lines = _const_lines(proto)
    out: List[Violation] = []
    sup = Suppressions(PASS, RULE)

    # -- model <-> protocol.py drift ------------------------------------
    for name in sorted(_model_constants() - all_consts):
        out.append(Violation(
            PASS, PROTOCOL_FILE, 1,
            f"protocol model references {name}, which protocol.py no "
            f"longer defines — prune it from "
            f"_private/protocol_model.py",
            key=f"unknown-const:{name}"))
    modeled = protocol_model.all_modeled_constants()
    for name in sorted(all_consts - modeled):
        out.append(Violation(
            PASS, PROTOCOL_FILE, lines.get(name, 1),
            f"message constant {name} belongs to no session DFA — new "
            f"constants register their ordering contract in "
            f"_private/protocol_model.py SESSIONS on day one",
            key=f"unmodeled-constant:{name}"))

    # -- send sites ------------------------------------------------------
    for sf in tree.iter_files():
        if sf.relpath == PROTOCOL_FILE:
            continue
        close_cache: Dict[ast.AST, List[Tuple[int, str]]] = {}
        for call, const, qual in iter_send_sites(sf, all_consts):
            entries = lookup_send_entries(sf.relpath, qual)
            if entries is None:
                if not sup.consume(sf, call):
                    out.append(Violation(
                        PASS, sf.relpath, call.lineno,
                        f"{qual} sends {const} but is not registered in "
                        f"devtools/lint/registry.py PROTOCOL_SEND_FUNCS "
                        f"— an unregistered send site dodges the "
                        f"session-ordering contract",
                        scope=qual, key=f"unregistered-send:{const}"))
                continue
            legal = False
            for session_name, role, states in entries:
                sends = protocol_model.SESSIONS[session_name]["roles"][
                    role]["sends"]
                if const in sends and set(states) & set(sends[const]):
                    legal = True
                    break
            if not legal and not sup.consume(sf, call):
                out.append(Violation(
                    PASS, sf.relpath, call.lineno,
                    f"{qual} sends {const}, which is not a legal send "
                    f"for any of its registered session states "
                    f"({_describe_entries(entries)}) — out-of-order "
                    f"or wrong-role frame",
                    scope=qual, key=f"illegal-send:{const}"))

            # request wrappers must have a registered response path
            if isinstance(call.func, ast.Attribute) \
                    and call.func.attr in _REQUEST_ATTRS \
                    and const not in protocol_model.REQUESTS \
                    and not sup.consume(sf, call):
                out.append(Violation(
                    PASS, sf.relpath, call.lineno,
                    f"{qual} sends {const} through a request wrapper "
                    f"but the constant has no protocol_model.REQUESTS "
                    f"entry — its response path is unverified",
                    scope=qual, key=f"no-response-path:{const}"))

            # send lexically after the connection's close()
            fn = next((p for p in sf.parents(call)
                       if isinstance(p, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))), None)
            recv = _dotted(call.func.value) \
                if isinstance(call.func, ast.Attribute) else None
            if fn is not None and recv is not None:
                if fn not in close_cache:
                    close_cache[fn] = _close_sites(fn)
                for close_line, close_recv in close_cache[fn]:
                    if close_line < call.lineno \
                            and _prefix_match(recv, close_recv):
                        if not sup.consume(sf, call):
                            out.append(Violation(
                                PASS, sf.relpath, call.lineno,
                                f"{qual} sends {const} on {recv!r} "
                                f"after closing it at line "
                                f"{close_line} — a frame into a dead "
                                f"connection",
                                scope=qual,
                                key=f"send-after-teardown:{const}"))
                        break

    # -- every registered request's response must be consumed ------------
    for const, req in sorted(protocol_model.REQUESTS.items()):
        loop_name = req["loop"]
        if loop_name is None:
            if not req.get("reason"):
                out.append(Violation(
                    PASS, PROTOCOL_FILE, lines.get(const, 1),
                    f"REQUESTS[{const}] registers no response loop and "
                    f"no reason — name the recv loop that dispatches "
                    f"{req['response']} or document why none does",
                    key=f"response-unverified:{const}"))
            continue
        loop = registry.RECV_LOOPS.get(loop_name)
        if loop is None:
            out.append(Violation(
                PASS, PROTOCOL_FILE, lines.get(const, 1),
                f"REQUESTS[{const}] names recv loop {loop_name!r}, "
                f"which is not in registry.RECV_LOOPS",
                key=f"response-loop-missing:{const}"))
            continue
        sf = tree.get(loop["file"])
        if sf is None:
            continue  # fixture tree without the loop's file
        handled = dispatched_constants(sf, loop["functions"],
                                       set(loop["dispatch_vars"]))
        if req["response"] not in handled:
            out.append(Violation(
                PASS, loop["file"], 1,
                f"request {const} expects response {req['response']} "
                f"from recv loop {loop_name}, but that loop's dispatch "
                f"span never handles it — the requester's future can "
                f"never resolve",
                key=f"response-undispatched:{const}"))

    out.extend(sup.stale(tree))
    return out
