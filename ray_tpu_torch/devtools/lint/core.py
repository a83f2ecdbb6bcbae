"""Shared infrastructure for the raylint passes.

Pure stdlib. A :class:`LintTree` loads every ``*.py`` under one package
root ONCE (source text, AST with parent/scope annotations, per-line
suppression comments); the five passes walk those shared trees, so a
full run parses the package a single time.

Fingerprints (the baseline ratchet keys) deliberately contain NO line
numbers: a violation is identified by (pass, file, enclosing scope,
message key), so unrelated edits moving code around don't churn the
baseline, while a *second* instance of a baselined violation appearing
in the same function still fails (counts are part of the ratchet).
"""

from __future__ import annotations

import ast
import json
import os
import re
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

#: Escape-hatch comment: ``# lint: <rule>-ok <reason>`` (an optional
#: ``:`` after ok). The reason is REQUIRED — an empty reason does not
#: suppress (the annotation exists to make the reviewer-visible "why"
#: permanent, not to silence the tool).
SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*(?P<rule>[a-z][a-z0-9-]*)-ok\b:?[ \t]*(?P<reason>.*)")


@dataclass
class Violation:
    pass_name: str
    file: str                  # path relative to the lint root
    line: int
    message: str
    scope: str = "<module>"    # enclosing function/class qualname
    key: Optional[str] = None  # fingerprint key; defaults to message

    @property
    def fingerprint(self) -> str:
        return (f"{self.pass_name}:{self.file}:{self.scope}:"
                f"{self.key if self.key is not None else self.message}")

    def render(self) -> str:
        return (f"{self.file}:{self.line}: [{self.pass_name}] "
                f"{self.message} (in {self.scope})")


class SourceFile:
    """One parsed source file: text, AST (with ``_lint_parent`` and
    ``_lint_scope`` annotations on every node), and the per-line
    suppression map."""

    def __init__(self, root: str, relpath: str):
        self.relpath = relpath
        self.path = os.path.join(root, relpath)
        with open(self.path, "r", encoding="utf-8") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=self.path)
        self.suppressions: Dict[int, Tuple[str, str]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = SUPPRESS_RE.search(line)
            if m:
                self.suppressions[i] = (m.group("rule"),
                                        m.group("reason").strip())
        self._annotate()

    def _annotate(self) -> None:
        scopes: List[str] = []
        # Every node in lexical (DFS pre-order) order, collected during
        # the same visit that wires parents/scopes: passes that only
        # FILTER nodes by type iterate this instead of re-walking the
        # tree (ast.walk re-derives child lists each call; over a full
        # run the repeated walks dominate a pass's wall clock).
        self.nodes: List[ast.AST] = []

        def visit(node: ast.AST, parent: Optional[ast.AST]) -> None:
            # DFS pre-order index + subtree end: nodes[idx:end] is the
            # node's whole subtree, so walk() serves both full-tree and
            # per-function scans from the one cached list.
            node._lint_idx = len(self.nodes)  # type: ignore[attr-defined]
            node._lint_nodes = self.nodes  # type: ignore[attr-defined]
            self.nodes.append(node)
            node._lint_parent = parent  # type: ignore[attr-defined]
            node._lint_scope = (  # type: ignore[attr-defined]
                ".".join(scopes) if scopes else "<module>")
            named = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef))
            if named:
                scopes.append(node.name)
                # The def/class node itself reports under its own name.
                node._lint_scope = ".".join(scopes)  # type: ignore
            for child in ast.iter_child_nodes(node):
                visit(child, node)
            if named:
                scopes.pop()
            node._lint_end = len(self.nodes)  # type: ignore[attr-defined]

        visit(self.tree, None)

    # -- helpers used by the passes ------------------------------------
    def walk(self, node: Optional[ast.AST] = None) -> List[ast.AST]:
        """The cached DFS pre-order node list — the whole file, or one
        node's subtree via the module-level :func:`walk`."""
        if node is None:
            return self.nodes
        return walk(node)

    def scope_of(self, node: ast.AST) -> str:
        return getattr(node, "_lint_scope", "<module>")

    def parents(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = getattr(node, "_lint_parent", None)
        while cur is not None:
            yield cur
            cur = getattr(cur, "_lint_parent", None)

    def suppressed(self, rule: str, *lines: int) -> bool:
        """True when any of the candidate lines carries a
        ``# lint: <rule>-ok <reason>`` annotation WITH a reason."""
        for ln in lines:
            entry = self.suppressions.get(ln)
            if entry and entry[0] == rule and entry[1]:
                return True
        return False

    def functions(self, qualnames: Iterable[str]) -> List[ast.AST]:
        """Function defs whose dotted qualname (Class.method or plain
        name) is in `qualnames`."""
        wanted = set(qualnames)
        out: List[ast.AST] = []
        for node in self.nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and self.scope_of(node) in wanted:
                out.append(node)
        return out


def walk(node: ast.AST) -> List[ast.AST]:
    """Drop-in for ``ast.walk`` over annotated nodes: returns the cached
    DFS pre-order subtree slice (node included) recorded while the
    owning SourceFile wired parents/scopes, so passes do not re-derive
    child lists on every scan — over a full run the repeated walks
    dominated several passes' wall clock (the <5s pin in
    test_torch_lint.py budgets the whole suite). Membership is identical
    to ``ast.walk``; order is lexical rather than breadth-first.
    Unannotated nodes (synthetic fixtures, ast.parse done by a pass
    itself) fall back to the real ``ast.walk``."""
    nodes = getattr(node, "_lint_nodes", None)
    if nodes is None:
        return list(ast.walk(node))
    return nodes[node._lint_idx:node._lint_end]


# Cross-LintTree source cache: a CLI run, the lint test suite, and the
# fixture helpers each build their own LintTree over the same (mostly
# unchanged) package dir; parsing + annotating dominates the wall clock,
# so parsed files are shared across constructions keyed by identity
# (root, relpath) and content freshness (mtime_ns, size). SourceFile is
# immutable after construction (passes only read), so sharing is safe.
_SOURCE_CACHE: Dict[Tuple[str, str, int, int], "SourceFile"] = {}
_SOURCE_CACHE_MAX = 4096  # fixture mirrors are deleted; bound the keys


def _load_source(root: str, relpath: str) -> "SourceFile":
    st = os.stat(os.path.join(root, relpath))
    key = (root, relpath, st.st_mtime_ns, st.st_size)
    sf = _SOURCE_CACHE.get(key)
    if sf is None:
        if len(_SOURCE_CACHE) >= _SOURCE_CACHE_MAX:
            _SOURCE_CACHE.clear()
        sf = SourceFile(root, relpath)
        _SOURCE_CACHE[key] = sf
    return sf


class LintTree:
    """Every python file under `root` (a package directory), parsed once.

    `root` is the directory that CONTAINS the code under analysis; file
    paths in violations/registries are relative to it (the real tree
    passes the ``ray_tpu_torch`` package dir, fixtures pass a temp
    mirror).
    """

    EXCLUDE_DIRS = {"__pycache__", ".git"}

    def __init__(self, root: str, exclude_prefixes: Tuple[str, ...] = ()):
        self.root = os.path.abspath(root)
        self.files: Dict[str, SourceFile] = {}
        self.parse_errors: List[Violation] = []
        for dirpath, dirnames, filenames in os.walk(self.root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in self.EXCLUDE_DIRS)
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn), self.root)
                if any(rel.startswith(p) for p in exclude_prefixes):
                    continue
                try:
                    self.files[rel] = _load_source(self.root, rel)
                except (SyntaxError, UnicodeDecodeError, OSError) as e:
                    self.parse_errors.append(Violation(
                        "parse", rel, getattr(e, "lineno", 0) or 0,
                        f"unparseable source: {type(e).__name__}"))

    def get(self, relpath: str) -> Optional[SourceFile]:
        return self.files.get(relpath)

    def iter_files(self, prefix: str = "") -> Iterable[SourceFile]:
        for rel in sorted(self.files):
            if rel.startswith(prefix):
                yield self.files[rel]


# ---------------------------------------------------------------------------
# pass driver
# ---------------------------------------------------------------------------
def run_passes(tree: LintTree,
               passes: Optional[Iterable[str]] = None,
               timings: Optional[Dict[str, float]] = None) -> List[Violation]:
    """Run the named passes (all by default). When `timings` is given it
    is filled with per-pass wall-clock milliseconds (surfaced in the
    CLI's ``--format json`` report)."""
    from . import barrier_coverage, broad_except, config_keys, \
        gate_discipline, guarded_by, lock_discipline, payload_schema, \
        protocol_coverage, protocol_order, ref_discipline
    table = {
        "protocol-coverage": protocol_coverage.run,
        "lock-discipline": lock_discipline.run,
        "gate-discipline": gate_discipline.run,
        "broad-except": broad_except.run,
        "config-keys": config_keys.run,
        "ref-discipline": ref_discipline.run,
        "barrier-coverage": barrier_coverage.run,
        "protocol-order": protocol_order.run,
        "payload-schema": payload_schema.run,
        "guarded-by": guarded_by.run,
    }
    names = list(passes) if passes is not None else list(table)
    out: List[Violation] = list(tree.parse_errors)
    for name in names:
        t0 = time.perf_counter()
        out.extend(table[name](tree))
        if timings is not None:
            timings[name] = (time.perf_counter() - t0) * 1e3
    out.sort(key=lambda v: (v.file, v.line, v.pass_name))
    return out


# ---------------------------------------------------------------------------
# baseline ratchet
# ---------------------------------------------------------------------------
def fingerprint_counts(violations: Iterable[Violation]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for v in violations:
        counts[v.fingerprint] = counts.get(v.fingerprint, 0) + 1
    return counts


def load_baseline(path: str) -> Dict[str, int]:
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return {str(k): int(v) for k, v in data.get("violations", {}).items()}


def save_baseline(path: str, violations: List[Violation]) -> None:
    counts = fingerprint_counts(violations)
    per_pass: Dict[str, int] = {}
    for v in violations:
        per_pass[v.pass_name] = per_pass.get(v.pass_name, 0) + 1
    data = {
        "__comment__": [
            "raylint baseline: pre-existing violations ratcheted so the",
            "suite is green while any NEW violation fails tier-1.",
            "Burn-down only — never add entries by hand; fix the code or",
            "annotate it with a reasoned `# lint: <rule>-ok` comment and",
            "regenerate via `python -m ray_tpu_torch.devtools.lint",
            "--update-baseline`. Policy: docs/STATIC_ANALYSIS.md.",
            "Per-pass counts: " + json.dumps(
                dict(sorted(per_pass.items())), sort_keys=True),
        ],
        "violations": dict(sorted(counts.items())),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=1)
        f.write("\n")


@dataclass
class BaselineResult:
    new: List[Violation] = field(default_factory=list)
    fixed: List[str] = field(default_factory=list)  # stale fingerprints


def apply_baseline(violations: List[Violation],
                   baseline: Dict[str, int]) -> BaselineResult:
    """Split a run against the ratchet: instances beyond a fingerprint's
    baselined count are NEW (ordered by line, the later ones overflow);
    baselined fingerprints with no remaining instances are FIXED (stale
    entries that should burn down)."""
    res = BaselineResult()
    seen: Dict[str, int] = {}
    for v in violations:
        fp = v.fingerprint
        seen[fp] = seen.get(fp, 0) + 1
        if seen[fp] > baseline.get(fp, 0):
            res.new.append(v)
    res.fixed = [fp for fp, n in baseline.items() if seen.get(fp, 0) < n]
    return res
