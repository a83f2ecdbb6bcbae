"""protocol-coverage pass.

Invariant: every message constant defined in ``_private/protocol.py``
is dispatched by each recv loop that serves its plane (worker run loop,
daemon run loop, head daemon-serve, both worker-plane recv muxes), and
every dispatch chain's fallthrough HANDLES unknown types (log, counter,
error reply, or relay) instead of silently dropping the frame — the
exact bug class of the coalesced-frame drop fixed in review last PR.

Planes are parsed from protocol.py itself: section headers
(``# Message types: driver -> worker`` ...) give a default, and a
per-constant inline direction comment (``# head -> daemon: ...``)
overrides it — so a new constant is classified where it is declared,
and a constant the parser cannot classify is itself a violation.
The loop registry lives in registry.RECV_LOOPS.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from . import registry
from .core import LintTree, SourceFile, Violation, walk

PASS = "protocol-coverage"

PROTOCOL_FILE = "_private/protocol.py"

_SECTION_RE = re.compile(r"^#\s*Message types:\s*(?P<rest>.*)")
_SEPARATOR_RE = re.compile(r"^#\s*-{10,}")

_DIRECTIONS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("direct", (r"worker\s*<->\s*worker",)),
    ("to_worker", (r"(driver|owner|head|daemon)\s*->\s*worker",)),
    ("from_worker", (r"worker\s*->\s*(driver|owner|head|daemon)",)),
    ("head_to_daemon", (r"head\s*->\s*daemon",)),
    ("daemon_to_head", (r"daemon\s*->\s*head",)),
)
_EITHER_RE = re.compile(r"either\s+direction")


def _direction_of(text: str) -> List[str]:
    out = [plane for plane, pats in _DIRECTIONS
           if any(re.search(p, text) for p in pats)]
    return out


def _section_default(header_rest: str) -> Optional[str]:
    d = _direction_of(header_rest)
    if len(d) == 1:
        return d[0]
    return None  # e.g. "per-host daemon <-> head": per-constant comments


def parse_planes(sf: SourceFile) -> Tuple[Dict[str, Set[str]],
                                          List[Violation]]:
    """Classify every message constant into plane sets. Returns
    ({plane: {CONST, ...}}, violations) — a constant inside a message
    section that cannot be classified is a violation."""
    planes: Dict[str, Set[str]] = {
        "to_worker": set(), "from_worker": set(),
        "head_to_daemon": set(), "daemon_to_head": set(),
        "direct": set()}
    violations: List[Violation] = []

    # line -> section default plane ("" = inside a message section with
    # no single default; absent = outside any message section)
    section_at: Dict[int, str] = {}
    current: Optional[str] = None
    prev_blank = True
    for i, line in enumerate(sf.lines, start=1):
        stripped = line.strip()
        m = _SECTION_RE.match(stripped)
        if m:
            current = _section_default(m.group("rest")) or ""
        elif _SEPARATOR_RE.match(stripped):
            current = None
        elif prev_blank and line.startswith("#"):
            # A fresh column-0 comment paragraph (e.g. "# Object
            # location kinds") ends the message section; continuation
            # lines of a section header follow it WITHOUT a blank line,
            # so multi-line headers survive.
            current = None
        if current is not None:
            section_at[i] = current
        prev_blank = stripped == ""

    for node in sf.tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            continue
        name = node.targets[0].id
        if name != name.upper() or node.lineno not in section_at:
            continue
        # Inline comment on the declaration line decides; the section
        # header is the fallback.
        comment = ""
        line = sf.lines[node.lineno - 1]
        if "#" in line:
            comment = line.split("#", 1)[1]
        if _EITHER_RE.search(comment):
            planes["head_to_daemon"].add(name)
            planes["daemon_to_head"].add(name)
            continue
        d = _direction_of(comment)
        if len(d) == 1:
            planes[d[0]].add(name)
            continue
        default = section_at[node.lineno]
        if default:
            planes[default].add(name)
        else:
            violations.append(Violation(
                PASS, sf.relpath, node.lineno,
                f"message constant {name} has no parseable direction "
                f"comment (e.g. '# head -> daemon: ...'); recv-loop "
                f"coverage cannot be checked for it",
                scope=sf.scope_of(node), key=f"undirected:{name}"))
    return planes, violations


# ---------------------------------------------------------------------------
# dispatch extraction
# ---------------------------------------------------------------------------
def _const_names(node: ast.AST) -> List[str]:
    """Protocol-constant names referenced by a comparator expression:
    ``P.EXEC_TASK`` / bare ``EXEC_TASK`` / tuples of either."""
    out: List[str] = []
    elts = node.elts if isinstance(node, (ast.Tuple, ast.List, ast.Set)) \
        else [node]
    for e in elts:
        if isinstance(e, ast.Attribute) and e.attr == e.attr.upper() \
                and isinstance(e.value, ast.Name):
            out.append(e.attr)
        elif isinstance(e, ast.Name) and e.id == e.id.upper():
            out.append(e.id)
    return out


def _tests_dispatch_var(test: ast.AST, dispatch_vars: Set[str]) -> bool:
    for cmp_node in walk(test):
        if isinstance(cmp_node, ast.Compare) \
                and isinstance(cmp_node.left, ast.Name) \
                and cmp_node.left.id in dispatch_vars:
            return True
    return False


def dispatched_constants(sf: SourceFile, functions, dispatch_vars
                         ) -> Set[str]:
    found: Set[str] = set()
    dv = set(dispatch_vars)
    for fn in sf.functions(functions):
        for node in walk(fn):
            if not isinstance(node, ast.Compare):
                continue
            if isinstance(node.left, ast.Name) and node.left.id in dv:
                for comparator in node.comparators:
                    found.update(_const_names(comparator))
            elif any(isinstance(c, ast.Name) and c.id in dv
                     for c in node.comparators):
                found.update(_const_names(node.left))
    return found


# ---------------------------------------------------------------------------
# fallthrough analysis
# ---------------------------------------------------------------------------
def _chain_heads(sf: SourceFile, fn: ast.AST,
                 dispatch_vars: Set[str]) -> List[ast.If]:
    heads: List[ast.If] = []
    for node in walk(fn):
        if not (isinstance(node, ast.If)
                and _tests_dispatch_var(node.test, dispatch_vars)):
            continue
        parent = getattr(node, "_lint_parent", None)
        if isinstance(parent, ast.If) and node in parent.orelse \
                and _tests_dispatch_var(parent.test, dispatch_vars):
            continue  # an elif link, not a chain head
        heads.append(node)
    return heads


def _handles_unknown(stmts: List[ast.stmt]) -> bool:
    for stmt in stmts:
        for node in walk(stmt):
            if isinstance(node, ast.Raise):
                return True
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in \
                    registry.FALLTHROUGH_HANDLER_ATTRS:
                return True
    return False


def check_fallthrough(sf: SourceFile, qualname: str,
                      dispatch_vars: Set[str]) -> List[Violation]:
    out: List[Violation] = []
    for fn in sf.functions([qualname]):
        # EVERY chain is checked, not just the last one: a function
        # with two sequential dispatch chains (daemon._route's
        # NODE_SYNC fast path + the main chain) must not hide a silent
        # drop in the earlier chain. An early chain's fallthrough is
        # the code after it, which for non-terminal chains contains the
        # next chain's dispatching calls and passes naturally.
        for chain in _chain_heads(sf, fn, dispatch_vars):
            node: ast.If = chain
            while len(node.orelse) == 1 \
                    and isinstance(node.orelse[0], ast.If) \
                    and _tests_dispatch_var(node.orelse[0].test,
                                            dispatch_vars):
                node = node.orelse[0]
            if node.orelse:
                region = node.orelse
            else:
                # No terminal else: the fallthrough is whatever follows
                # the chain at the same nesting level.
                parent = getattr(chain, "_lint_parent", None)
                body = getattr(parent, "body", [])
                try:
                    idx = body.index(chain)
                    region = body[idx + 1:]
                except ValueError:
                    region = []
            if not _handles_unknown(region):
                out.append(Violation(
                    PASS, sf.relpath, node.lineno,
                    f"dispatch fallthrough in {qualname} drops unknown "
                    f"message types silently — log the msg_type (or "
                    f"bump a drop counter) so a protocol skew is "
                    f"visible",
                    scope=sf.scope_of(fn),
                    key=f"fallthrough:{qualname}"))
    return out


# ---------------------------------------------------------------------------
# unregistered-recv-loop detection
# ---------------------------------------------------------------------------
def _covered_by(qual: str, registered: Set[str]) -> bool:
    """True when `qual` is a registered function or nested inside one
    (inner defs of a registered dispatcher are part of its span)."""
    return any(qual == r or qual.startswith(r + ".")
               for r in registered)


def detect_unregistered_loops(tree: LintTree,
                              all_constants: Set[str]) -> List[Violation]:
    """A function that dispatches over protocol message constants but is
    absent from registry.RECV_LOOPS is a coverage HOLE, not a skip: a
    new recv loop (e.g. a direct-channel handler) must be registered so
    the plane-coverage invariant applies to it. Legitimate non-loop
    dispatchers carry a reasoned registry.NON_LOOP_DISPATCHERS entry."""
    registered_by_file: Dict[str, Set[str]] = {}
    for loop in registry.RECV_LOOPS.values():
        registered_by_file.setdefault(loop["file"], set()).update(
            loop["functions"])
    out: List[Violation] = []
    threshold = registry.RECV_LOOP_DETECT_MIN
    for sf in tree.iter_files():
        if sf.relpath == PROTOCOL_FILE:
            continue
        registered = registered_by_file.get(sf.relpath, set())
        for fn in walk(sf.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            qual = sf.scope_of(fn)
            if _covered_by(qual, registered):
                continue
            allow = registry.NON_LOOP_DISPATCHERS.get(
                (sf.relpath, qual))
            if allow:
                continue
            per_var: Dict[str, Set[str]] = {}
            for node in walk(fn):
                if not isinstance(node, ast.Compare):
                    continue
                if isinstance(node.left, ast.Name):
                    var = node.left.id
                    consts = [c for comp in node.comparators
                              for c in _const_names(comp)]
                else:
                    vars_ = [c.id for c in node.comparators
                             if isinstance(c, ast.Name)]
                    if not vars_:
                        continue
                    var = vars_[0]
                    consts = _const_names(node.left)
                hits = {c for c in consts if c in all_constants}
                if hits:
                    per_var.setdefault(var, set()).update(hits)
            for var, consts in per_var.items():
                if len(consts) >= threshold:
                    out.append(Violation(
                        PASS, sf.relpath, fn.lineno,
                        f"{qual} dispatches {len(consts)} protocol "
                        f"message constants over {var!r} but is not in "
                        f"devtools/lint/registry.py RECV_LOOPS — an "
                        f"unregistered recv loop dodges plane coverage; "
                        f"register it (or add a reasoned "
                        f"NON_LOOP_DISPATCHERS entry)",
                        scope=qual, key=f"unregistered-loop:{qual}"))
                    break  # one violation per function is enough
    return out


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------
def run(tree: LintTree) -> List[Violation]:
    proto = tree.get(PROTOCOL_FILE)
    if proto is None:
        return []  # fixture tree without a protocol module
    planes, out = parse_planes(proto)
    all_constants = set().union(*planes.values())
    out.extend(detect_unregistered_loops(tree, all_constants))

    for loop_name, loop in registry.RECV_LOOPS.items():
        sf = tree.get(loop["file"])
        if sf is None:
            continue
        dv = set(loop["dispatch_vars"])
        fns = sf.functions(loop["functions"])
        if not fns:
            out.append(Violation(
                PASS, loop["file"], 1,
                f"recv loop {loop_name}: none of the registered dispatch "
                f"functions {loop['functions']} exist — update "
                f"devtools/lint/registry.py RECV_LOOPS",
                key=f"loop-missing:{loop_name}"))
            continue
        anchor = min(fn.lineno for fn in fns)
        handled = dispatched_constants(sf, loop["functions"], dv)

        for const in sorted(handled - all_constants):
            out.append(Violation(
                PASS, loop["file"], anchor,
                f"recv loop {loop_name} dispatches {const}, which is not "
                f"a message constant in protocol.py",
                key=f"unknown-const:{loop_name}:{const}"))

        if not loop["relay"]:
            required = planes.get(loop["plane"], set())
            missing = required - handled - set(loop["exempt"])
            for const in sorted(missing):
                out.append(Violation(
                    PASS, loop["file"], anchor,
                    f"recv loop {loop_name} does not dispatch {const} "
                    f"(plane {loop['plane']}); handle it, or register an "
                    f"exemption with a reason in "
                    f"devtools/lint/registry.py",
                    key=f"missing:{loop_name}:{const}"))
            for const, reason in sorted(loop["exempt"].items()):
                if const in handled:
                    out.append(Violation(
                        PASS, loop["file"], anchor,
                        f"stale exemption: {loop_name} now dispatches "
                        f"{const} ({reason!r}) — drop it from the "
                        f"registry",
                        key=f"stale-exempt:{loop_name}:{const}"))

        if loop["fallthrough"]:
            out.extend(check_fallthrough(sf, loop["fallthrough"], dv))
    return out
