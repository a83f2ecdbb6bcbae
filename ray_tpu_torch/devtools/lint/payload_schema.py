"""payload-schema pass.

Invariant: every frame's payload matches its declared shape in
protocol_model.PAYLOADS — the whole-protocol generalization of
ref-discipline's REF_PAYLOADS conservation (which pins 3 accounting
payloads; this pins all of them). Three drift directions:

  * **producer drift** — a send site's payload literal (plus any
    conditional ``payload["k"] = ...`` stores before the send, including
    tuple-target stores) must match one declared variant: every
    required key present, no key outside required|optional, and any
    declared compact-tuple arity honored (``ACTOR_CALL["c"]`` is an
    11-slot tuple; adding a slot without bumping the model breaks every
    peer's unpack).
  * **consumer drift (phantoms)** — a registered consumer
    (registry.PAYLOAD_CONSUMERS) reading a key no variant declares is
    reading a field nothing produces — the exact shape that masks a
    producer regression.
  * **model rot (dead keys)** — a declared key that no send site in the
    whole tree ever writes is schema fiction; prune it or fix the
    producer. ("req_id" is exempt: the request wrappers inject it at
    their chokepoint, never at call sites.)

Payloads assembled dynamically are declared ``open`` in the model
(key checks skipped, the constant stays modeled); a site whose payload
expression cannot be resolved to a dict literal is skipped. Escape
hatch: ``# lint: payload-schema-ok <reason>``, with stale-annotation
rot detection like protocol-order.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..._private import protocol_model
from . import registry
from .core import LintTree, SourceFile, Violation, walk
from .protocol_coverage import PROTOCOL_FILE, parse_planes
from .protocol_order import Suppressions, _const_lines, iter_send_sites

PASS = "payload-schema"
RULE = "payload-schema"

#: keys injected by covered wrappers (Worker.request / DaemonHandle
#: .request write ``payload["req_id"]`` at the chokepoint), so no send
#: site ever writes them literally — exempt from dead-key detection.
WRAPPER_INJECTED_KEYS = frozenset({"req_id"})


# ---------------------------------------------------------------------------
# payload-shape resolution
# ---------------------------------------------------------------------------
def _literal_keys(node: ast.Dict) -> Optional[Set[str]]:
    """Keys of a dict literal, or None when the literal is not fully
    static (``**`` unpacking, computed keys)."""
    keys: Set[str] = set()
    for k in node.keys:
        if k is None:  # ** unpacking
            return None
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
            return None
        keys.add(k.value)
    return keys


def _subscript_stores(fn: ast.AST, name: str, before: int) -> Set[str]:
    """String keys stored via ``name["k"] = ...`` (plain, augmented, or
    tuple-target — ``p["a"], p["b"] = snap``) before line `before`."""
    out: Set[str] = set()

    def keys_of(target: ast.AST) -> List[str]:
        if isinstance(target, ast.Subscript) \
                and isinstance(target.value, ast.Name) \
                and target.value.id == name \
                and isinstance(target.slice, ast.Constant) \
                and isinstance(target.slice.value, str):
            return [target.slice.value]
        if isinstance(target, (ast.Tuple, ast.List)):
            return [k for elt in target.elts for k in keys_of(elt)]
        return []

    for node in walk(fn):
        if getattr(node, "lineno", before) >= before:
            continue
        if isinstance(node, ast.Assign):
            for target in node.targets:
                out.update(keys_of(target))
        elif isinstance(node, ast.AugAssign):
            out.update(keys_of(node.target))
    return out


def resolve_payload(sf: SourceFile, call: ast.Call
                    ) -> Optional[Tuple[Set[str], Optional[ast.Dict]]]:
    """(keys, dict-literal node) for a send call's payload argument, or
    None when the shape cannot be statically resolved."""
    if len(call.args) < 2:
        return None
    expr = call.args[1]
    if isinstance(expr, ast.Dict):
        keys = _literal_keys(expr)
        return None if keys is None else (keys, expr)
    if not isinstance(expr, ast.Name):
        return None
    fn = next((p for p in sf.parents(call)
               if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef))),
              None)
    if fn is None:
        return None
    lit: Optional[ast.Dict] = None
    lit_line = -1
    for node in walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign):  # msg: Dict[...] = {...}
            target = node.target
        else:
            continue
        if isinstance(target, ast.Name) and target.id == expr.id \
                and isinstance(node.value, ast.Dict) \
                and lit_line < node.lineno < call.lineno:
            lit, lit_line = node.value, node.lineno
    if lit is None:
        return None
    keys = _literal_keys(lit)
    if keys is None:
        return None
    keys = set(keys)
    keys.update(_subscript_stores(fn, expr.id, call.lineno + 1))
    return keys, lit


def _variant_keys(schema: dict) -> Set[str]:
    out: Set[str] = set()
    for v in schema.get("variants", ()):
        out.update(v["required"])
        out.update(v["optional"])
    return out


def _check_arity(sf: SourceFile, lit: ast.Dict, variant: dict,
                 const: str, qual: str) -> List[Violation]:
    out: List[Violation] = []
    arity = variant.get("arity")
    if not arity or lit is None:
        return out
    for k, v in zip(lit.keys, lit.values):
        if not (isinstance(k, ast.Constant) and k.value in arity):
            continue
        if isinstance(v, (ast.Tuple, ast.List)) \
                and not any(isinstance(e, ast.Starred) for e in v.elts):
            want = arity[k.value]
            if len(v.elts) != want:
                out.append(Violation(
                    PASS, sf.relpath, v.lineno,
                    f"{qual} packs {const}[{k.value!r}] with "
                    f"{len(v.elts)} slots; the model declares {want} — "
                    f"compact-tuple arity drift breaks every peer's "
                    f"unpack (update protocol_model.PAYLOADS with the "
                    f"new slot)",
                    scope=qual, key=f"arity-drift:{const}:{k.value}"))
    return out


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------
def run(tree: LintTree) -> List[Violation]:
    proto = tree.get(PROTOCOL_FILE)
    if proto is None:
        return []  # fixture tree without a protocol module
    planes, _ = parse_planes(proto)
    all_consts: Set[str] = set().union(*planes.values())
    lines = _const_lines(proto)
    out: List[Violation] = []
    sup = Suppressions(PASS, RULE)

    written: Dict[str, Set[str]] = {}   # const -> keys any site writes
    has_literal: Set[str] = set()       # consts with >=1 resolved site

    for sf in tree.iter_files():
        if sf.relpath == PROTOCOL_FILE:
            continue
        for call, const, qual in iter_send_sites(sf, all_consts):
            schema = protocol_model.PAYLOADS.get(const)
            if schema is None:
                if not sup.consume(sf, call):
                    out.append(Violation(
                        PASS, sf.relpath, call.lineno,
                        f"{qual} sends {const}, which has no "
                        f"protocol_model.PAYLOADS schema — declare its "
                        f"shape (or 'open': True for dynamic payloads)",
                        scope=qual, key=f"unmodeled-payload:{const}"))
                continue
            if schema.get("open"):
                continue
            resolved = resolve_payload(sf, call)
            if resolved is None:
                continue  # dynamic payload expression: runtime tap's job
            keys, lit = resolved
            has_literal.add(const)
            written.setdefault(const, set()).update(keys)

            allowed = _variant_keys(schema)
            undeclared = sorted(keys - allowed)
            if undeclared:
                if not sup.consume(sf, call):
                    for k in undeclared:
                        out.append(Violation(
                            PASS, sf.relpath, call.lineno,
                            f"{qual} writes {const}[{k!r}], which no "
                            f"schema variant declares — an orphan field "
                            f"the consumer will never read (add it to "
                            f"protocol_model.PAYLOADS or drop it)",
                            scope=qual, key=f"undeclared-key:{const}:{k}"))
                continue
            variants = schema["variants"]
            match = None
            for v in variants:
                if set(v["required"]) <= keys \
                        <= set(v["required"]) | set(v["optional"]):
                    match = v
                    break
            if match is None:
                best = max(variants,
                           key=lambda v: len(set(v["required"]) & keys))
                missing = sorted(set(best["required"]) - keys)
                if not sup.consume(sf, call):
                    for k in missing:
                        out.append(Violation(
                            PASS, sf.relpath, call.lineno,
                            f"{qual} sends {const} without required key "
                            f"{k!r} (closest variant needs "
                            f"{sorted(best['required'])})",
                            scope=qual, key=f"missing-key:{const}:{k}"))
                continue
            arity_violations = _check_arity(sf, lit, match, const, qual)
            if arity_violations and not sup.consume(sf, call):
                out.extend(arity_violations)

    # -- consumer phantom reads ------------------------------------------
    for const, consumers in sorted(registry.PAYLOAD_CONSUMERS.items()):
        schema = protocol_model.PAYLOADS.get(const)
        if schema is None or schema.get("open"):
            continue
        allowed = _variant_keys(schema)
        for spec in consumers:
            sf = tree.get(spec["file"])
            if sf is None:
                continue  # fixture tree without the consumer's file
            fns = sf.functions(spec["functions"])
            if not fns:
                out.append(Violation(
                    PASS, spec["file"], 1,
                    f"payload consumer for {const}: none of the "
                    f"registered functions {spec['functions']} exist — "
                    f"update devtools/lint/registry.py "
                    f"PAYLOAD_CONSUMERS",
                    key=f"consumer-missing:{const}"))
                continue
            pv = set(spec["payload_vars"])
            for fn in fns:
                qual = sf.scope_of(fn)
                for node in walk(fn):
                    key = line = None
                    if isinstance(node, ast.Subscript) \
                            and isinstance(node.value, ast.Name) \
                            and node.value.id in pv \
                            and isinstance(node.ctx, ast.Load) \
                            and isinstance(node.slice, ast.Constant) \
                            and isinstance(node.slice.value, str):
                        key, line = node.slice.value, node.lineno
                    elif isinstance(node, ast.Call) \
                            and isinstance(node.func, ast.Attribute) \
                            and node.func.attr == "get" \
                            and isinstance(node.func.value, ast.Name) \
                            and node.func.value.id in pv \
                            and node.args \
                            and isinstance(node.args[0], ast.Constant) \
                            and isinstance(node.args[0].value, str):
                        key, line = node.args[0].value, node.lineno
                    if key is not None and key not in allowed:
                        if not sup.consume(sf, node):
                            out.append(Violation(
                                PASS, sf.relpath, line,
                                f"{qual} reads {const}[{key!r}], which "
                                f"no schema variant declares — a "
                                f"phantom field masking producer "
                                f"regressions",
                                scope=qual,
                                key=f"phantom-field:{const}:{key}"))

    # -- dead schema keys (model rot) ------------------------------------
    for const in sorted(has_literal):
        schema = protocol_model.PAYLOADS[const]
        dead = _variant_keys(schema) - written.get(const, set()) \
            - WRAPPER_INJECTED_KEYS
        for k in sorted(dead):
            out.append(Violation(
                PASS, PROTOCOL_FILE, lines.get(const, 1),
                f"schema key {const}[{k!r}] is never written by any "
                f"send site in the tree — dead model entry; prune it "
                f"from protocol_model.PAYLOADS (or fix the producer "
                f"that should be writing it)",
                key=f"dead-schema-key:{const}:{k}"))

    out.extend(sup.stale(tree))
    return out
