"""guarded-by pass.

The field-level data-race tier's static half (dynamic:
``_private/racedebug.py``). lockdep (PR 4) proves lock *ordering*;
this pass proves which lock guards which shared *field*:

1. **Guarded access** — every read/write of a field registered in
   ``registry.GUARDED_FIELDS`` must be lexically under a
   ``with <recv>.<lock_attr>:`` of the owning lock, inside a function
   declared lock-held (``registry.HOLDS_LOCK``), or carry a reasoned
   ``# lint: guarded-by-ok <reason>`` annotation. ``__init__`` is
   exempt (init-then-publish — no other thread can see the object
   yet; the dynamic half's first-thread state is the same exemption).
   A ``with``/holder in an ENCLOSING function does not cover a nested
   ``def`` (it runs later, possibly unlocked) — nested defs register
   their own qualname or annotate.

2. **Lock-held helper inventory** — ``*_locked`` defs in a registered
   class must be declared in ``HOLDS_LOCK`` (a new helper is a new
   obligation), declared helpers must still exist (rot), and every
   lexical call of one must itself sit under the held lock.

3. **Registry/lockdep agreement** — the registered ``lock_attr`` must
   be created in ``__init__`` through the lockdep factory under the
   registered ``lockdep_class`` name, so the static registry and the
   runtime lockset detector name the SAME lock.

4. **Coverage ratchet** — a field assigned in ``__init__`` of a
   registered class but absent from the registry is flagged
   (``unregistered-field``) and baselined like broad-except: new
   fields on the hot concurrent classes must be registered (accesses
   proven) or reason-annotated; the debt only burns down.

Stale ``guarded-by-ok`` annotations (suppressing nothing) are flagged
like protocol-order's.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from . import registry
from .core import LintTree, SourceFile, Violation, walk

PASS = "guarded-by"
RULE = "guarded-by"

_LOCKDEP_FACTORIES = {"lock", "rlock", "condition"}


def _with_guard(item: ast.withitem) -> Optional[Tuple[str, str]]:
    """``with <recv>.<attr>:`` -> (recv, attr); None otherwise."""
    expr = item.context_expr
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
        return expr.value.id, expr.attr
    return None


def _is_write(sf: SourceFile, node: ast.Attribute) -> bool:
    """Store/Del on the attribute itself, or a store through a
    subscript/augmented assignment rooted at it."""
    if isinstance(node.ctx, (ast.Store, ast.Del)):
        return True
    cur: ast.AST = node
    for parent in sf.parents(node):
        if isinstance(parent, ast.Subscript) and parent.value is cur:
            if isinstance(parent.ctx, (ast.Store, ast.Del)):
                return True
            cur = parent
            continue
        if isinstance(parent, ast.AugAssign) and parent.target is cur:
            return True
        break
    return False


def _lock_held(sf: SourceFile, node: ast.AST, recv: str,
               lock_attrs: frozenset,
               holds_lock: Dict[str, Set[str]]) -> bool:
    """Is `node` lexically under ``with <recv>.<attr>:`` for any attr in
    `lock_attrs` (the guard lock plus its aliases — e.g. a Condition
    wrapping it) within its own function frame, or inside a
    HOLDS_LOCK-declared function that holds one? Withs beyond the first
    function boundary belong to a different runtime frame and do not
    count."""
    cur: ast.AST = node
    for parent in sf.parents(node):
        if isinstance(parent, ast.With):
            for item in parent.items:
                guard = _with_guard(item)
                if guard is not None and guard[0] == recv \
                        and guard[1] in lock_attrs:
                    return True
        elif isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            if not isinstance(parent, ast.Lambda):
                held = holds_lock.get(sf.scope_of(parent))
                if held and held & lock_attrs:
                    return True
            return False
        cur = parent
    return False


def _enclosing_func(sf: SourceFile, node: ast.AST) -> Optional[ast.AST]:
    for parent in sf.parents(node):
        if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return parent
    return None


def run(tree: LintTree) -> List[Violation]:
    out: List[Violation] = []

    by_file: Dict[str, Dict[str, Dict[str, Tuple[str, str]]]] = {}
    for (relpath, cls), fields in registry.GUARDED_FIELDS.items():
        by_file.setdefault(relpath, {})[cls] = dict(fields)
    holds_by_file: Dict[str, Dict[str, Set[str]]] = {}
    for (relpath, qualname), attrs in registry.HOLDS_LOCK.items():
        holds_by_file.setdefault(relpath, {})[qualname] = set(attrs)

    for relpath in sorted(set(by_file) | set(holds_by_file)):
        sf = tree.get(relpath)
        class_fields = by_file.get(relpath, {})
        holds_lock = holds_by_file.get(relpath, {})
        if sf is None:
            continue
        used_suppressions: Set[int] = set()

        def suppress(*lines: int) -> bool:
            if sf.suppressed(RULE, *lines):
                used_suppressions.update(
                    ln for ln in lines
                    if sf.suppressions.get(ln, ("", ""))[0] == RULE)
                return True
            return False

        # -- class / field / lock-class rot --------------------------------
        # One scan of the cached node list builds every per-class index
        # the checks below need (re-walking each class subtree made this
        # the slowest pass; the wall-clock pin in test_torch_lint.py budgets
        # the whole suite).
        classes: Dict[str, ast.ClassDef] = {}
        self_attrs_by_cls: Dict[str, Set[str]] = {}
        assigns_by_cls: Dict[str, List[ast.Assign]] = {}
        func_defs: List[ast.AST] = []
        attr_nodes: List[ast.Attribute] = []
        call_nodes: List[ast.Call] = []
        for n in sf.nodes:
            if isinstance(n, ast.Attribute):
                if isinstance(n.value, ast.Name):
                    attr_nodes.append(n)
                    if n.value.id == "self":
                        self_attrs_by_cls.setdefault(
                            sf.scope_of(n).split(".", 1)[0],
                            set()).add(n.attr)
            elif isinstance(n, ast.ClassDef):
                classes.setdefault(n.name, n)
            elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                func_defs.append(n)
            elif isinstance(n, ast.Assign) and len(n.targets) == 1:
                assigns_by_cls.setdefault(
                    sf.scope_of(n).split(".", 1)[0], []).append(n)
            elif isinstance(n, ast.Call):
                call_nodes.append(n)
        # attr name -> owning classes (for non-self receiver matching)
        field_owners: Dict[str, List[str]] = {}
        # cls -> {lock_attr: frozenset of equivalent guard attrs}
        # (a Condition built over the lock shares its mutex: acquiring
        # either IS holding the guard).
        guard_groups: Dict[str, Dict[str, frozenset]] = {}
        for cls, fields in sorted(class_fields.items()):
            for field in fields:
                field_owners.setdefault(field, []).append(cls)
            node = classes.get(cls)
            if node is None:
                out.append(Violation(
                    PASS, relpath, 1,
                    f"GUARDED_FIELDS registers class {cls} which no "
                    f"longer exists in {relpath} — registry rot",
                    scope="<module>", key=f"stale-guarded-class:{cls}"))
                continue
            seen_attrs = self_attrs_by_cls.get(cls, set())
            # lockdep factory assignments in this class:
            #   self.<attr> = lockdep.lock("<class>")
            # plus Condition aliases over an already-named lock:
            #   self.<attr> = threading.Condition(self.<lock>)
            lock_classes: Dict[str, str] = {}
            aliases: Dict[str, str] = {}
            for a in assigns_by_cls.get(cls, []):
                tgt = a.targets[0]
                if not (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    continue
                call = a.value
                if not isinstance(call, ast.Call):
                    continue
                fn = call.func
                if isinstance(fn, ast.Attribute) \
                        and isinstance(fn.value, ast.Name) \
                        and fn.value.id == "lockdep" \
                        and fn.attr in _LOCKDEP_FACTORIES \
                        and call.args \
                        and isinstance(call.args[0], ast.Constant) \
                        and isinstance(call.args[0].value, str):
                    lock_classes[tgt.attr] = call.args[0].value
                elif ((isinstance(fn, ast.Attribute)
                       and fn.attr == "Condition")
                      or (isinstance(fn, ast.Name)
                          and fn.id == "Condition")) \
                        and call.args \
                        and isinstance(call.args[0], ast.Attribute) \
                        and isinstance(call.args[0].value, ast.Name) \
                        and call.args[0].value.id == "self":
                    aliases[tgt.attr] = call.args[0].attr
            def _root(attr: str) -> str:
                seen: Set[str] = set()
                while attr in aliases and attr not in seen:
                    seen.add(attr)
                    attr = aliases[attr]
                return attr
            groups: Dict[str, frozenset] = {}
            for lock_attr in {la for la, _lc in fields.values()}:
                root = _root(lock_attr)
                groups[lock_attr] = frozenset(
                    {lock_attr, root}
                    | {al for al in aliases if _root(al) == root})
                if lock_attr not in lock_classes \
                        and root in lock_classes:
                    lock_classes[lock_attr] = lock_classes[root]
            guard_groups[cls] = groups
            for field, (lock_attr, lockdep_class) in sorted(fields.items()):
                if field not in seen_attrs:
                    out.append(Violation(
                        PASS, relpath, node.lineno,
                        f"registered field {cls}.{field} is never "
                        f"accessed in the class — renamed or deleted; "
                        f"update GUARDED_FIELDS",
                        scope=cls, key=f"stale-guarded-field:{cls}.{field}"))
                got = lock_classes.get(lock_attr)
                if got is None:
                    out.append(Violation(
                        PASS, relpath, node.lineno,
                        f"guard lock {cls}.{lock_attr} (for field "
                        f"{field}) is not created through the lockdep "
                        f"factory in this class — the runtime lockset "
                        f"detector cannot see it; create it via "
                        f"lockdep.lock/rlock/condition",
                        scope=cls, key=f"unnamed-guard-lock:{cls}.{lock_attr}"))
                elif got != lockdep_class:
                    out.append(Violation(
                        PASS, relpath, node.lineno,
                        f"guard lock {cls}.{lock_attr} is lockdep class "
                        f"{got!r} but GUARDED_FIELDS registers "
                        f"{lockdep_class!r} for field {field} — the "
                        f"static registry and the runtime lockset "
                        f"detector must name the SAME lock",
                        scope=cls,
                        key=f"wrong-lock-class:{cls}.{lock_attr}"))

        # -- HOLDS_LOCK inventory (both directions) ------------------------
        qualnames = {sf.scope_of(n) for n in func_defs}
        for qualname in sorted(holds_lock):
            if qualname not in qualnames:
                out.append(Violation(
                    PASS, relpath, 1,
                    f"HOLDS_LOCK registers {qualname} which no longer "
                    f"exists in {relpath} — registry rot",
                    scope="<module>", key=f"stale-holds-lock:{qualname}"))
        for node in func_defs:
            qualname = sf.scope_of(node)
            cls = qualname.split(".", 1)[0]
            if cls in class_fields and node.name.endswith("_locked") \
                    and qualname not in holds_lock:
                if suppress(node.lineno):
                    continue
                out.append(Violation(
                    PASS, relpath, node.lineno,
                    f"{qualname} follows the *_locked convention but "
                    f"has no HOLDS_LOCK entry — declare which lock(s) "
                    f"its callers hold so field accesses inside it are "
                    f"checkable",
                    scope=qualname,
                    key=f"unregistered-locked-helper:{qualname}"))

        # -- calls of lock-held helpers must hold the lock -----------------
        helper_names = {q.rsplit(".", 1)[-1]: q for q in holds_lock}
        for node in call_nodes:
            if not (isinstance(node.func, ast.Attribute)
                    and node.func.attr in helper_names
                    and isinstance(node.func.value, ast.Name)):
                continue
            qualname = helper_names[node.func.attr]
            recv = node.func.value.id
            needed = holds_lock[qualname]
            hgroups = guard_groups.get(qualname.split(".", 1)[0], {})
            scope = sf.scope_of(node)
            # A helper calling a sibling helper under the same holds.
            caller_held = holds_lock.get(scope, set())
            missing = []
            for a in sorted(needed):
                group = hgroups.get(a, frozenset({a}))
                if not (caller_held & group) \
                        and not _lock_held(sf, node, recv, group,
                                           holds_lock):
                    missing.append(a)
            if not missing:
                continue
            if suppress(node.lineno):
                continue
            out.append(Violation(
                PASS, relpath, node.lineno,
                f"call of lock-held helper {qualname}() without "
                f"holding {', '.join(missing)} — take the lock or "
                f"annotate `# lint: {RULE}-ok <reason>`",
                scope=scope, key=f"unguarded-locked-call:{qualname}"))

        # -- guarded field accesses ----------------------------------------
        for node in attr_nodes:
            owners = field_owners.get(node.attr)
            if not owners:
                continue
            recv = node.value.id
            scope = sf.scope_of(node)
            scope_cls = scope.split(".", 1)[0]
            if recv == "self":
                if scope_cls not in class_fields \
                        or node.attr not in class_fields[scope_cls]:
                    continue
                cls = scope_cls
            else:
                # Cross-object access: unambiguous, non-generic names
                # only (mirrors lock-discipline's receiver rules).
                if len(owners) != 1 \
                        or node.attr in registry.GUARDED_GENERIC_ATTRS:
                    continue
                cls = owners[0]
                if scope_cls == cls:
                    # A self-class helper touching another instance
                    # (e.g. merge) still holds only its OWN lock;
                    # keep checking with the receiver name.
                    pass
            lock_attr, _lockdep_class = class_fields[cls][node.attr]
            func = _enclosing_func(sf, node)
            if func is not None and func.name == "__init__" \
                    and sf.scope_of(func) == f"{cls}.__init__" \
                    and recv == "self":
                continue  # init-then-publish: not shared yet
            group = guard_groups.get(cls, {}).get(
                lock_attr, frozenset({lock_attr}))
            if _lock_held(sf, node, recv, group, holds_lock):
                continue
            lines = [node.lineno]
            if func is not None:
                lines.append(func.lineno)
            if suppress(*lines):
                continue
            kind = "write" if _is_write(sf, node) else "read"
            out.append(Violation(
                PASS, relpath, node.lineno,
                f"unguarded {kind} of {cls}.{node.attr} — registered "
                f"as guarded by {cls}.{lock_attr}; take the lock, "
                f"register the function in HOLDS_LOCK, or annotate "
                f"`# lint: {RULE}-ok <reason>`",
                scope=scope, key=f"unguarded-{kind}:{cls}.{node.attr}"))

        # -- coverage ratchet: __init__ fields absent from the registry ----
        for cls, fields in sorted(class_fields.items()):
            node = classes.get(cls)
            if node is None:
                continue
            guard_attrs = {la for la, _lc in fields.values()}
            init = next((n for n in node.body
                         if isinstance(n, ast.FunctionDef)
                         and n.name == "__init__"), None)
            if init is None:
                continue
            seen: Set[str] = set()
            for a in walk(init):
                if not (isinstance(a, ast.Attribute)
                        and isinstance(a.ctx, ast.Store)
                        and isinstance(a.value, ast.Name)
                        and a.value.id == "self"):
                    continue
                attr = a.attr
                if attr in fields or attr in guard_attrs or attr in seen:
                    continue
                seen.add(attr)
                if suppress(a.lineno):
                    continue
                out.append(Violation(
                    PASS, relpath, a.lineno,
                    f"{cls}.{attr} is assigned in __init__ of a "
                    f"guarded class but absent from GUARDED_FIELDS — "
                    f"register it (and prove its accesses) or annotate "
                    f"`# lint: {RULE}-ok <reason>` (coverage ratchet)",
                    scope=f"{cls}.__init__",
                    key=f"unregistered-field:{cls}.{attr}"))

        # -- stale annotations ---------------------------------------------
        for lineno, (rule, reason) in sorted(sf.suppressions.items()):
            if rule != RULE or not reason:
                continue
            if lineno not in used_suppressions:
                out.append(Violation(
                    PASS, relpath, lineno,
                    f"stale `# lint: {RULE}-ok` annotation — it "
                    f"suppresses nothing; remove it or fix the drift",
                    scope="<module>", key=f"stale-annotation:{lineno}"))
    return out
