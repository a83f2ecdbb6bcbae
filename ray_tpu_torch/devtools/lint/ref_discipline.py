"""ref-discipline: ownership/refcount conservation as a static pass.

The direct-call plane re-derives the reference's core-worker invariant
— no object freed while any node holds a live reference — from
buffered accounting (``REF_DELTAS`` / ``DIRECT_DONE`` residual
transfers drained at ``flush_accounting`` barriers). PR 5 burned eight
review rounds on exactly this surface; this pass pins the four
properties those rounds converged on (registries in registry.py):

  unregistered-mutation-helper / stale-mutation-helper
      Every def named like a refcount mutator inside REF_FILES is
      declared in REF_MUTATION_HELPERS (a new helper is a new
      conservation obligation), and the registry carries no rot.

  unpaired-park
      A function that parks accounting (writes into ``_ref_buf`` /
      ``_done_buf`` / ``_refs``) is lexically paired with a drain
      barrier, is the barrier, or names its deferred barrier in
      REF_PARK_DEFERRED (escape hatch: ``# lint: ref-park-ok``).

  unguarded-elision
      A ``continue``-only guard inside a barrier function (the entry
      elision) must reference escape-marked state — directly or via a
      local derived from it — so an entry the head is already waiting
      on can never be silently dropped (the PR 5 elision bug).

  orphan-field / phantom-field / missing-producer / missing-consumer /
  stale-exempt
      Residual-transfer payload conservation: every field written into
      a DIRECT_DONE / REF_DELTAS / GEN_ITEM payload is read by the
      registered head-side (or caller-side) consumer, and vice versa.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from . import registry
from .core import LintTree, SourceFile, Violation, walk

PASS = "ref-discipline"
PARK_RULE = "ref-park"
ELISION_RULE = "ref-elision"
FIELD_RULE = "ref-field"
RESERVE_RULE = "reserve-seal"


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _self_attr(node: ast.AST) -> Optional[str]:
    """`self.<attr>` (or any single-name receiver) -> attr name."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        return node.attr
    return None


def _call_names(func: ast.AST) -> Iterable[str]:
    """Terminal names a call expression could resolve through."""
    if isinstance(func, ast.Name):
        yield func.id
    elif isinstance(func, ast.Attribute):
        yield func.attr


def _function_calls(fn: ast.AST, names: Set[str]) -> List[ast.Call]:
    out = []
    for node in walk(fn):
        if isinstance(node, ast.Call):
            for n in _call_names(node.func):
                if n in names:
                    out.append(node)
                    break
    return out


def _p_const(node: ast.AST) -> Optional[str]:
    """`P.<CONST>` (or bare `<CONST>` uppercase name) -> constant name."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "P":
        return node.attr
    if isinstance(node, ast.Name) and node.id.isupper():
        return node.id
    return None


def _dict_str_keys(node: ast.Dict) -> List[Tuple[str, int]]:
    out = []
    for k in node.keys:
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            out.append((k.value, k.lineno))
    return out


# ---------------------------------------------------------------------------
# check 1: mutation-helper inventory
# ---------------------------------------------------------------------------
def check_mutation_inventory(tree: LintTree) -> List[Violation]:
    out: List[Violation] = []
    found: Set[Tuple[str, str]] = set()
    for rel in registry.REF_FILES:
        sf = tree.get(rel)
        if sf is None:
            continue
        for node in walk(sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in registry.REF_MUTATION_METHOD_NAMES:
                qual = sf.scope_of(node)
                found.add((rel, qual))
                if (rel, qual) in registry.REF_MUTATION_HELPERS:
                    continue
                if sf.suppressed(PARK_RULE, node.lineno):
                    continue
                out.append(Violation(
                    PASS, rel, node.lineno,
                    f"refcount-mutation helper {qual} is not declared in "
                    f"registry.REF_MUTATION_HELPERS — a new mutation "
                    f"helper is a new conservation obligation; register "
                    f"it (and its journal hook under refdebug)",
                    scope=qual, key=f"unregistered-mutation-helper:{qual}"))
    for rel, qual in sorted(registry.REF_MUTATION_HELPERS):
        if tree.get(rel) is None:
            continue
        if (rel, qual) not in found:
            out.append(Violation(
                PASS, rel, 1,
                f"registry.REF_MUTATION_HELPERS names {qual} which no "
                f"longer exists in {rel} (registry rot)",
                scope="<module>", key=f"stale-mutation-helper:{qual}"))
    return out


# ---------------------------------------------------------------------------
# check 2: park sites lexically paired with a drain barrier
# ---------------------------------------------------------------------------
def _park_sites(sf: SourceFile, fn: ast.AST) -> List[Tuple[str, int]]:
    """(attr, line) for every accounting-park write inside `fn`:
    subscript stores / augmented subscript stores on a park attr, and
    ``.append(...)`` calls on one. Whole-attr reassignment (the drain)
    and reads/pops are NOT parks."""
    sites: List[Tuple[str, int]] = []
    for node in walk(fn):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Subscript):
                    attr = _self_attr(t.value)
                    if attr in registry.REF_PARK_ATTRS:
                        sites.append((attr, node.lineno))
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "append":
            attr = _self_attr(node.func.value)
            if attr in registry.REF_PARK_ATTRS:
                sites.append((attr, node.lineno))
    return sites


def check_park_pairing(tree: LintTree) -> List[Violation]:
    out: List[Violation] = []
    for rel in registry.REF_PARK_FILES:
        sf = tree.get(rel)
        if sf is None:
            continue
        for node in walk(sf.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            qual = sf.scope_of(node)
            if node.name in registry.REF_BARRIER_FUNCS:
                continue  # the barrier's own buffer handling
            sites = _park_sites(sf, node)
            if not sites:
                continue
            if _function_calls(node, set(registry.REF_BARRIER_FUNCS)):
                continue  # lexically paired
            if (rel, qual) in registry.REF_PARK_DEFERRED:
                continue  # reasoned deferral
            for attr, line in sites:
                if sf.suppressed(PARK_RULE, line):
                    continue
                out.append(Violation(
                    PASS, rel, line,
                    f"accounting parked into self.{attr} with no drain "
                    f"barrier in {qual} — call flush_accounting / "
                    f"_flush_accounting_locked, add a reasoned "
                    f"registry.REF_PARK_DEFERRED entry, or annotate "
                    f"`# lint: {PARK_RULE}-ok <reason>` (an idle worker "
                    f"has no later barrier: parked deltas strand head-"
                    f"side waiters — the PR 5 hang shape)",
                    scope=qual, key=f"unpaired-park:{attr}"))
    return out


# ---------------------------------------------------------------------------
# check 3: elision guards reference escape-marked state
# ---------------------------------------------------------------------------
def _escape_tainted_names(fn: ast.AST) -> Set[str]:
    """Local names assigned from an expression that reads escape state."""
    tainted: Set[str] = set()
    for node in walk(fn):
        if isinstance(node, ast.Assign):
            reads_escape = any(
                _self_attr(sub) in registry.REF_ESCAPE_STATE
                for sub in walk(node.value))
            if reads_escape:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        tainted.add(t.id)
    return tainted


def _references_escape_state(test: ast.AST, tainted: Set[str]) -> bool:
    for sub in walk(test):
        if _self_attr(sub) in registry.REF_ESCAPE_STATE:
            return True
        if isinstance(sub, ast.Name) and sub.id in tainted:
            return True
    return False


def check_elision_guards(tree: LintTree) -> List[Violation]:
    out: List[Violation] = []
    for rel, qual in sorted(registry.REF_ELISION_FUNCS):
        sf = tree.get(rel)
        if sf is None:
            continue
        fns = sf.functions([qual])
        if not fns:
            out.append(Violation(
                PASS, rel, 1,
                f"registry.REF_ELISION_FUNCS names {qual} which no "
                f"longer exists in {rel} (registry rot)",
                scope="<module>", key=f"stale-elision-func:{qual}"))
            continue
        for fn in fns:
            tainted = _escape_tainted_names(fn)
            for node in walk(fn):
                if not isinstance(node, ast.If):
                    continue
                if len(node.body) != 1 \
                        or not isinstance(node.body[0], ast.Continue):
                    continue
                if _references_escape_state(node.test, tainted):
                    continue
                if sf.suppressed(ELISION_RULE, node.lineno):
                    continue
                out.append(Violation(
                    PASS, rel, node.lineno,
                    f"accounting-entry elision in {qual} does not "
                    f"consult escape-marked state "
                    f"({', '.join(sorted(registry.REF_ESCAPE_STATE))}) "
                    f"— an escaped id netting zero residual would be "
                    f"silently dropped while the head holds a waiter "
                    f"on it (the PR 5 elision bug)",
                    scope=qual, key="unguarded-elision"))
    return out


# ---------------------------------------------------------------------------
# check 4: residual-transfer payload field conservation
# ---------------------------------------------------------------------------
def _produced_fields(sf: SourceFile, fn: ast.AST, entry_vars: Set[str],
                     send_const: str) -> Dict[str, int]:
    """field name -> first producing line inside one producer fn."""
    fields: Dict[str, int] = {}

    def note(key: str, line: int) -> None:
        fields.setdefault(key, line)

    for node in walk(fn):
        # {'k': ...} literal bound to an entry var
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id in entry_vars:
                    for k, line in _dict_str_keys(node.value):
                        note(k, line)
        # entry_var['k'] = ...
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Subscript) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id in entry_vars \
                        and isinstance(t.slice, ast.Constant) \
                        and isinstance(t.slice.value, str):
                    note(t.slice.value, node.lineno)
        # send(P.CONST, {...}) with the payload dict inline
        if isinstance(node, ast.Call) and node.args:
            if _p_const(node.args[0]) == send_const:
                for arg in node.args[1:]:
                    if isinstance(arg, ast.Dict):
                        for k, line in _dict_str_keys(arg):
                            note(k, line)
    return fields


def _consumed_fields(fn: ast.AST, payload_vars: Set[str]) -> Set[str]:
    """String keys read off the payload vars: var['k'] loads and
    var.get('k', ...) calls."""
    keys: Set[str] = set()
    for node in walk(fn):
        if isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Load) \
                and isinstance(node.value, ast.Name) \
                and node.value.id in payload_vars \
                and isinstance(node.slice, ast.Constant) \
                and isinstance(node.slice.value, str):
            keys.add(node.slice.value)
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "get" \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id in payload_vars \
                and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            keys.add(node.args[0].value)
    return keys


def check_payload_conservation(tree: LintTree) -> List[Violation]:
    out: List[Violation] = []
    for payload_name, spec in sorted(registry.REF_PAYLOADS.items()):
        psf = tree.get(spec["producer_file"])
        csf = tree.get(spec["consumer_file"])
        if psf is None or csf is None:
            continue  # fixture subset: payload not in scope
        entry_vars = set(spec.get("entry_vars") or ())
        payload_vars = set(spec.get("payload_vars") or ())
        exempt = spec.get("exempt") or {}

        produced: Dict[str, Tuple[int, str]] = {}  # key -> (line, scope)
        for qual in spec["producers"]:
            fns = psf.functions([qual])
            if not fns:
                out.append(Violation(
                    PASS, spec["producer_file"], 1,
                    f"registry.REF_PAYLOADS[{payload_name!r}] names "
                    f"producer {qual} which does not exist (registry "
                    f"rot)", scope="<module>",
                    key=f"missing-producer:{payload_name}:{qual}"))
                continue
            for fn in fns:
                for k, line in _produced_fields(
                        psf, fn, entry_vars, spec["send_const"]).items():
                    produced.setdefault(k, (line, psf.scope_of(fn)))

        consumed: Set[str] = set()
        for qual in spec["consumers"]:
            fns = csf.functions([qual])
            if not fns:
                out.append(Violation(
                    PASS, spec["consumer_file"], 1,
                    f"registry.REF_PAYLOADS[{payload_name!r}] names "
                    f"consumer {qual} which does not exist (registry "
                    f"rot)", scope="<module>",
                    key=f"missing-consumer:{payload_name}:{qual}"))
                continue
            for fn in fns:
                consumed |= _consumed_fields(fn, payload_vars)

        for k, (line, scope) in sorted(produced.items()):
            if k in consumed or k in exempt:
                continue
            if psf.suppressed(FIELD_RULE, line):
                continue
            out.append(Violation(
                PASS, spec["producer_file"], line,
                f"field {k!r} written into the {payload_name} payload "
                f"is never read by its consumer "
                f"({', '.join(spec['consumers'])}) — orphaned residual-"
                f"transfer fields rot into silent accounting loss; "
                f"consume it, delete it, or exempt it with a reason in "
                f"registry.REF_PAYLOADS",
                scope=scope, key=f"orphan-field:{payload_name}:{k}"))
        for k in sorted(consumed - set(produced) - set(exempt)):
            out.append(Violation(
                PASS, spec["consumer_file"], 1,
                f"consumer of {payload_name} reads field {k!r} which no "
                f"registered producer writes — a phantom read masks "
                f"producer regressions", scope=spec["consumers"][0],
                key=f"phantom-field:{payload_name}:{k}"))
        for k, reason in sorted(exempt.items()):
            if k in produced and k not in consumed:
                continue
            out.append(Violation(
                PASS, spec["producer_file"], 1,
                f"stale exemption for {payload_name} field {k!r} "
                f"(reason: {reason}): the field is "
                f"{'now consumed' if k in consumed else 'never produced'}"
                f" — drop the registry entry",
                scope="<module>", key=f"stale-exempt:{payload_name}:{k}"))
    return out


# ---------------------------------------------------------------------------
# check 5: reservations lexically paired with a settle (seal/abort)
# ---------------------------------------------------------------------------
def check_reserve_pairing(tree: LintTree) -> List[Violation]:
    """Every function that opens a store reservation
    (``reserve``/``_reserve`` call) must lexically settle it — a
    ``seal``/``abort``/``_abort_reserve`` call on every path is the
    contract, and a lexical settle is the statically checkable proxy
    (the same shape check_park_pairing uses for drain barriers).
    Streamed protocols that settle on a later message declare the
    terminal in registry.RESERVE_DEFERRED."""
    out: List[Violation] = []
    deferred_seen: Set[Tuple[str, str]] = set()
    for rel in registry.RESERVE_FILES:
        sf = tree.get(rel)
        if sf is None:
            continue
        for node in walk(sf.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if node.name in registry.RESERVE_CALL_NAMES \
                    or node.name in registry.RESERVE_SETTLE_NAMES:
                continue  # the implementations themselves
            calls = _function_calls(node, set(registry.RESERVE_CALL_NAMES))
            if not calls:
                continue
            qual = sf.scope_of(node)
            if (rel, qual) in registry.RESERVE_DEFERRED:
                deferred_seen.add((rel, qual))
                continue
            if _function_calls(node, set(registry.RESERVE_SETTLE_NAMES)):
                continue  # lexically paired
            for call in calls:
                if sf.suppressed(RESERVE_RULE, call.lineno):
                    continue
                out.append(Violation(
                    PASS, rel, call.lineno,
                    f"reservation opened in {qual} with no lexical "
                    f"seal/abort — an unsettled reservation is charged-"
                    f"but-unreadable capacity and a truncation hazard "
                    f"for readers; settle it, add a reasoned "
                    f"registry.RESERVE_DEFERRED entry, or annotate "
                    f"`# lint: {RESERVE_RULE}-ok <reason>`",
                    scope=qual, key=f"unsettled-reserve:{qual}"))
    for rel, qual in sorted(registry.RESERVE_DEFERRED):
        if tree.get(rel) is None:
            continue
        if (rel, qual) not in deferred_seen:
            out.append(Violation(
                PASS, rel, 1,
                f"registry.RESERVE_DEFERRED names {qual} which no longer "
                f"opens a reservation in {rel} (registry rot)",
                scope="<module>", key=f"stale-reserve-deferred:{qual}"))
    return out


def run(tree: LintTree) -> List[Violation]:
    out: List[Violation] = []
    out.extend(check_mutation_inventory(tree))
    out.extend(check_park_pairing(tree))
    out.extend(check_elision_guards(tree))
    out.extend(check_payload_conservation(tree))
    out.extend(check_reserve_pairing(tree))
    return out
