"""gate-discipline pass.

Three invariants keeping the debug planes honest:

1. **Site registry** — every ``fault.fire("<site>", ...)`` names a
   literal site that exists in ``fault.SITES`` (parsed from
   ``_private/fault.py``, never imported). A typo'd site would silently
   never inject; a dynamic site name can't be audited.

2. **Falsy-flag gating** — every instrumentation helper call
   (``fault.fire`` and the ``_ops``-bumping module functions of
   ``_private/telemetry.py``) sits lexically under an
   ``if <plane>.enabled`` guard, so the disabled hot path pays exactly
   one dict lookup (the perf_smoke contract). Helpers called through an
   indirect gate annotate ``# lint: ungated-instrumentation-ok <why>``.
   The hot paths' recording helpers (``RECORDING_HELPERS``:
   ``tracing.local_span``, ``local_call``, ``local_count``,
   ``device_range``) record in a torch.profiler session alone: their
   guard is ``if tracing.profiler._is_profiler_enabled``, and
   ``tracing.enabled``, which every process of a cluster inherits, does
   not stand for it.

3. **Globally unique metric names** — a metric name is created with one
   kind in one file; the registry dedups by name at runtime, so a
   second definition silently aliases the first (wrong kind = corrupt
   exposition, two owners = samples attributed to the wrong subsystem).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from . import registry
from .core import LintTree, SourceFile, Violation, walk

PASS = "gate-discipline"
RULE_UNGATED = "ungated-instrumentation"
# The hot paths' in-process recording helpers, by plane: gated on
# ``<plane>.profiler._is_profiler_enabled``, torch's profiler flag.
RECORDING_HELPERS = {
    "tracing": ("local_span", "local_call", "local_count", "device_range"),
}
RECORDING_GATE = ("profiler", "_is_profiler_enabled")

FAULT_FILE = "_private/fault.py"

_METRIC_CTORS = {"Counter": "counter", "Gauge": "gauge",
                 "Histogram": "histogram"}


def parse_fault_sites(sf: SourceFile) -> Set[str]:
    for node in sf.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "SITES" \
                and isinstance(node.value, (ast.Tuple, ast.List)):
            return {e.value for e in node.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)}
    return set()


def parse_gated_helpers(sf: SourceFile) -> Set[str]:
    """Module-level telemetry functions that bump the ``_ops``
    instrumentation counter — exactly the ones that must be gated."""
    out: Set[str] = set()
    for node in sf.tree.body:
        if isinstance(node, ast.FunctionDef):
            for inner in walk(node):
                if isinstance(inner, ast.Global) and "_ops" in inner.names:
                    out.add(node.name)
                    break
    return out


def _implies_enabled(test: ast.AST, module: str, want_true: bool) -> bool:
    """Does this branch condition imply ``<module>.enabled`` is truthy?
    ``want_true``: whether the branch under consideration is taken when
    `test` evaluates true (if-body) or false (else-branch). Polarity-
    aware, so ``if not telemetry.enabled: <call>`` does NOT count as
    gated while its else branch does — the inverted-gate bug (telemetry
    running only when OFF) must not pass the lint."""
    if isinstance(test, ast.Attribute) and test.attr == "enabled" \
            and isinstance(test.value, ast.Name) \
            and test.value.id == module:
        return want_true
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _implies_enabled(test.operand, module, not want_true)
    if isinstance(test, ast.BoolOp):
        return any(_implies_enabled(v, module, want_true)
                   for v in test.values)
    return False


def _is_gated(sf: SourceFile, call: ast.Call, module: str,
              implies=_implies_enabled) -> bool:
    """True when an ancestor ``if``/ternary branch implies
    ``<module>.enabled`` — the SAME plane module as the call (a
    ``fault.enabled`` guard does not gate a telemetry helper), with the
    branch (body vs else) and negation taken into account. ``implies``
    says which flag a test implies."""
    prev: ast.AST = call
    for parent in sf.parents(call):
        if isinstance(parent, (ast.If, ast.While)):
            in_body = any(prev is s for s in parent.body)
            in_orelse = not isinstance(parent, ast.While) and any(
                prev is s for s in parent.orelse)
            if in_body and implies(parent.test, module, True):
                return True
            if in_orelse and implies(parent.test, module, False):
                return True
        elif isinstance(parent, ast.IfExp):
            if prev is parent.body \
                    and implies(parent.test, module, True):
                return True
            if prev is parent.orelse \
                    and implies(parent.test, module, False):
                return True
        prev = parent
    return False


def _implies_recording(test: ast.AST, module: str, want_true: bool
                       ) -> bool:
    """Does this branch condition imply
    ``<module>.profiler._is_profiler_enabled`` is truthy? Strict about
    ``and``/``or``: ``tracing.enabled or <the flag>`` does not."""
    if isinstance(test, ast.Attribute) and test.attr == RECORDING_GATE[1] \
            and isinstance(test.value, ast.Attribute) \
            and test.value.attr == RECORDING_GATE[0] \
            and isinstance(test.value.value, ast.Name) \
            and test.value.value.id == module:
        return want_true
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _implies_recording(test.operand, module, not want_true)
    if isinstance(test, ast.BoolOp):
        # The branch taken with ``a and b`` true, or ``a or b`` false,
        # knows every operand's value; the other knows only one of them.
        every = isinstance(test.op, ast.And) == want_true
        hits = [_implies_recording(v, module, want_true)
                for v in test.values]
        return any(hits) if every else all(hits)
    return False


def _plane_call(call: ast.Call, module: str,
                names: Set[str]) -> Optional[str]:
    fn = call.func
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
            and fn.value.id == module and fn.attr in names:
        return fn.attr
    return None


def run(tree: LintTree) -> List[Violation]:
    out: List[Violation] = []
    fault_sf = tree.get(FAULT_FILE)
    sites = parse_fault_sites(fault_sf) if fault_sf else set()
    # Per-module helper sets parsed from each plane's impl file (the
    # `_ops`-bumping functions — exactly the ones that must be gated).
    module_helpers: Dict[str, Set[str]] = {}
    for module, relpath in registry.GATED_HELPER_FILES.items():
        sf = tree.get(relpath)
        if sf is not None:
            module_helpers[module] = parse_gated_helpers(sf)

    metric_defs: Dict[str, List[Tuple[str, int, str]]] = {}

    for sf in tree.iter_files():
        impl_file = sf.relpath in registry.GATE_IMPL_FILES
        for node in walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue

            # -- fault.fire site validity + gating ---------------------
            if fault_sf is not None \
                    and _plane_call(node, "fault", {"fire"}):
                if not impl_file:
                    arg = node.args[0] if node.args else None
                    if not (isinstance(arg, ast.Constant)
                            and isinstance(arg.value, str)):
                        out.append(Violation(
                            PASS, sf.relpath, node.lineno,
                            "fault.fire() site must be a string literal "
                            "(auditable against fault.SITES)",
                            scope=sf.scope_of(node), key="dynamic-site"))
                    elif arg.value not in sites:
                        out.append(Violation(
                            PASS, sf.relpath, node.lineno,
                            f"fault.fire site {arg.value!r} is not in "
                            f"fault.SITES — a typo'd site never "
                            f"injects; register it or fix the name",
                            scope=sf.scope_of(node),
                            key=f"unknown-site:{arg.value}"))
                    if not _is_gated(sf, node, "fault") \
                            and not sf.suppressed(RULE_UNGATED,
                                                  node.lineno):
                        out.append(Violation(
                            PASS, sf.relpath, node.lineno,
                            "fault.fire() outside an `if fault.enabled` "
                            "guard — the disabled hot path must pay one "
                            "dict lookup, not a function call",
                            scope=sf.scope_of(node),
                            key="ungated:fault.fire"))

            # -- gated-plane helper gating (telemetry, tracing) --------
            for module, helpers in module_helpers.items():
                helper = _plane_call(node, module, helpers) \
                    if helpers else None
                if not helper or impl_file:
                    continue
                recording = helper in RECORDING_HELPERS.get(module, ())
                implies = _implies_recording if recording \
                    else _implies_enabled
                if not _is_gated(sf, node, module, implies) \
                        and not sf.suppressed(RULE_UNGATED, node.lineno):
                    guard = (f"{module}.{'.'.join(RECORDING_GATE)}"
                             if recording else f"{module}.enabled")
                    out.append(Violation(
                        PASS, sf.relpath, node.lineno,
                        f"{module}.{helper}() outside an "
                        f"`if {guard}` guard (annotate "
                        f"`# lint: {RULE_UNGATED}-ok <why>` when gated "
                        f"indirectly)",
                        scope=sf.scope_of(node),
                        key=f"ungated:{module}.{helper}"))

            # -- metric definitions ------------------------------------
            kind = None
            fn = node.func
            if isinstance(fn, ast.Name) and fn.id == "_metric" \
                    or isinstance(fn, ast.Attribute) \
                    and fn.attr == "_metric":
                if len(node.args) >= 2 \
                        and isinstance(node.args[1], ast.Constant):
                    kind = str(node.args[1].value)
            elif (isinstance(fn, ast.Name) and fn.id in _METRIC_CTORS):
                kind = _METRIC_CTORS[fn.id]
            elif (isinstance(fn, ast.Attribute)
                  and fn.attr in _METRIC_CTORS
                  and isinstance(fn.value, ast.Name)):
                kind = _METRIC_CTORS[fn.attr]
            if kind and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                metric_defs.setdefault(node.args[0].value, []).append(
                    (sf.relpath, node.lineno, kind))

    # -- global metric-name uniqueness ---------------------------------
    for name, defs in sorted(metric_defs.items()):
        files = {d[0] for d in defs}
        kinds = {d[2] for d in defs}
        if len(files) <= 1 and len(kinds) <= 1:
            continue
        detail = "kinds " + "/".join(sorted(kinds)) \
            if len(kinds) > 1 else "files " + ", ".join(sorted(files))
        for relpath, lineno, _kind in defs:
            out.append(Violation(
                PASS, relpath, lineno,
                f"metric {name!r} is defined in multiple places "
                f"({detail}) — the registry dedups by name, so one "
                f"definition silently wins; metric names must be "
                f"globally unique with one kind",
                key=f"dup-metric:{name}"))
    return out
