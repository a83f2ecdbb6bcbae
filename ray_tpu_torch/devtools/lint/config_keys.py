"""config-keys pass.

Invariant: every config key read anywhere in the package has a declared
default in ``_private/config.py`` (``RayConfig._DEFAULTS``). RayConfig
raises AttributeError on unknown attributes at runtime — but only when
the typo'd line actually executes, which for rarely-taken branches
(reconnect paths, spill escalation) can be never-in-CI. This pass makes
the check static: ``ray_config.<key>``, ``ray_config.set("<key>", ..)``
and ``getattr(ray_config, "<key>")`` all resolve against the declared
defaults at lint time.
"""

from __future__ import annotations

import ast
from typing import List, Set

from .core import LintTree, SourceFile, Violation, walk

PASS = "config-keys"
CONFIG_FILE = "_private/config.py"

_METHODS = {"set", "snapshot"}


def parse_default_keys(sf: SourceFile) -> Set[str]:
    for node in walk(sf.tree):
        if isinstance(node, ast.ClassDef) and node.name == "RayConfig":
            for stmt in node.body:
                targets = []
                if isinstance(stmt, ast.Assign):
                    targets = stmt.targets
                    value = stmt.value
                elif isinstance(stmt, ast.AnnAssign):
                    targets = [stmt.target]
                    value = stmt.value
                else:
                    continue
                if any(isinstance(t, ast.Name) and t.id == "_DEFAULTS"
                       for t in targets) and isinstance(value, ast.Dict):
                    return {k.value for k in value.keys
                            if isinstance(k, ast.Constant)
                            and isinstance(k.value, str)}
    return set()


def run(tree: LintTree) -> List[Violation]:
    cfg = tree.get(CONFIG_FILE)
    if cfg is None:
        return []
    keys = parse_default_keys(cfg)
    out: List[Violation] = []

    def unknown(sf: SourceFile, node: ast.AST, key: str) -> None:
        out.append(Violation(
            PASS, sf.relpath, node.lineno,
            f"config key {key!r} has no declared default in "
            f"config.py _DEFAULTS — a typo here silently never "
            f"matches an env override (and raises only when this "
            f"branch finally executes)",
            scope=sf.scope_of(node), key=f"unknown-key:{key}"))

    for sf in tree.iter_files():
        if sf.relpath == CONFIG_FILE:
            continue
        for node in walk(sf.tree):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "ray_config":
                attr = node.attr
                if attr.startswith("_") or attr in _METHODS:
                    # .set("<key>", ...) checks its literal argument
                    parent = getattr(node, "_lint_parent", None)
                    if attr == "set" and isinstance(parent, ast.Call) \
                            and parent.func is node and parent.args \
                            and isinstance(parent.args[0], ast.Constant) \
                            and isinstance(parent.args[0].value, str) \
                            and parent.args[0].value not in keys:
                        unknown(sf, parent, parent.args[0].value)
                    continue
                if attr not in keys:
                    unknown(sf, node, attr)
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Name) \
                    and node.func.id == "getattr" \
                    and len(node.args) >= 2 \
                    and isinstance(node.args[0], ast.Name) \
                    and node.args[0].id == "ray_config" \
                    and isinstance(node.args[1], ast.Constant) \
                    and isinstance(node.args[1].value, str) \
                    and node.args[1].value not in keys:
                unknown(sf, node, node.args[1].value)
    return out
