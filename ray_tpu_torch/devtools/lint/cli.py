"""Command-line entry: ``python -m ray_tpu_torch.devtools.lint``.

Modes:
    (default)            run all passes, ratchet against baseline.json;
                         exit 1 on any NEW violation
    --no-baseline        full report of every violation, exit 1 if any
    --update-baseline    rewrite baseline.json from the current tree
    --root DIR           analyze a different tree (fixtures/tests); the
                         baseline defaults to empty then
    --since REV          incremental gate: passes still run on the FULL
                         tree (the cross-file checks need it), but only
                         violations in files changed since REV (plus
                         untracked files) are reported/failed — the
                         fast-CI shape. Stale-fingerprint burndown is
                         skipped (unchanged files are out of scope), and
                         --update-baseline refuses a narrowed run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional, Set

from . import PASS_NAMES
from .core import (LintTree, apply_baseline, fingerprint_counts,
                   load_baseline, run_passes, save_baseline)

_LINT_DIR = os.path.dirname(os.path.abspath(__file__))
# ray_tpu_torch/
DEFAULT_ROOT = os.path.dirname(os.path.dirname(_LINT_DIR))
DEFAULT_BASELINE = os.path.join(_LINT_DIR, "baseline.json")


def changed_files(root: str, rev: str) -> Set[str]:
    """Lint-root-relative paths changed since `rev` (committed diffs,
    staged/unstaged edits, and untracked files). Raises
    ``subprocess.CalledProcessError`` on an unknown rev and
    ``FileNotFoundError`` when git is absent."""
    top = subprocess.run(
        ["git", "-C", root, "rev-parse", "--show-toplevel"],
        check=True, capture_output=True, text=True).stdout.strip()
    out: Set[str] = set()
    for cmd in (["git", "-C", root, "diff", "--name-only", rev, "--"],
                ["git", "-C", root, "ls-files", "--others",
                 "--exclude-standard"]):
        res = subprocess.run(cmd, check=True, capture_output=True,
                             text=True)
        for line in res.stdout.splitlines():
            line = line.strip()
            if not line:
                continue
            # git paths are repo-root-relative; violations are
            # lint-root-relative.
            rel = os.path.relpath(os.path.join(top, line), root)
            if not rel.startswith(".."):
                out.add(rel)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.devtools.lint",
        description="raylint: project-invariant static analysis "
                    "(docs/STATIC_ANALYSIS.md)")
    parser.add_argument("--root", default=None,
                        help="package directory to analyze "
                             "(default: the installed ray_tpu_torch "
                             "package)")
    parser.add_argument("--baseline", default=None,
                        help="baseline JSON path (default: the checked-in "
                             "devtools/lint/baseline.json; empty when "
                             "--root points elsewhere)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore the baseline: report everything")
    parser.add_argument("--update-baseline", action="store_true",
                        help="rewrite the baseline from the current tree")
    parser.add_argument("--passes", nargs="*", choices=PASS_NAMES,
                        default=None, metavar="PASS",
                        help="subset of passes to run")
    parser.add_argument("--since", default=None, metavar="REV",
                        help="report only violations in files changed "
                             "since REV (full-tree analysis, narrowed "
                             "reporting — the incremental CI gate)")
    parser.add_argument("--format", choices=("text", "json", "github"),
                        default="text", dest="fmt",
                        help="output format: human text (default), a "
                             "machine-readable JSON report, or GitHub "
                             "workflow ::error annotation lines")
    parser.add_argument("-q", "--quiet", action="store_true")
    args = parser.parse_args(argv)

    root = os.path.abspath(args.root) if args.root else DEFAULT_ROOT
    if not os.path.isdir(root):
        print(f"raylint: no such directory: {root}", file=sys.stderr)
        return 2
    baseline_path = args.baseline
    if baseline_path is None:
        baseline_path = DEFAULT_BASELINE if args.root is None else None

    tree = LintTree(root)
    timings = {}
    violations = run_passes(tree, args.passes, timings=timings)
    per_pass = {}
    for v in violations:
        per_pass[v.pass_name] = per_pass.get(v.pass_name, 0) + 1

    if args.update_baseline:
        # The checked-in baseline must only ever be rewritten from a
        # FULL run of the real tree: a narrowed run (--passes) or a
        # foreign tree (--root) would silently clobber it — deleting
        # the live fingerprints (every baselined violation turns NEW)
        # or masking real ones behind fixture fingerprints.
        if args.passes is not None:
            print("raylint: refusing --update-baseline with --passes "
                  "(a partial run would drop the other passes' "
                  "baselined fingerprints)", file=sys.stderr)
            return 2
        if args.root is not None and args.baseline is None:
            print("raylint: --update-baseline with --root requires an "
                  "explicit --baseline path (refusing to overwrite the "
                  "checked-in baseline with another tree's results)",
                  file=sys.stderr)
            return 2
        if args.since is not None:
            print("raylint: refusing --update-baseline with --since "
                  "(the ratchet must be rewritten from a full run, "
                  "never a changed-files slice)", file=sys.stderr)
            return 2
        path = baseline_path or DEFAULT_BASELINE
        save_baseline(path, violations)
        print(f"raylint: baseline updated: {path} "
              f"({len(violations)} violations, "
              f"{len(fingerprint_counts(violations))} fingerprints)")
        return 0

    baseline = {}
    if baseline_path and not args.no_baseline:
        baseline = load_baseline(baseline_path)
    res = apply_baseline(violations, baseline)

    if args.since is not None:
        try:
            scope = changed_files(root, args.since)
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            print(f"raylint: --since {args.since}: cannot resolve "
                  f"changed files: {detail.strip()}", file=sys.stderr)
            return 2
        res.new = [v for v in res.new if v.file in scope]
        # Unchanged files are out of scope: a fingerprint that stopped
        # firing there is the FULL run's burndown signal, not this one's.
        res.fixed = []
        if not args.quiet and args.fmt == "text":
            print(f"raylint: --since {args.since}: narrowed to "
                  f"{len(scope)} changed file(s)")

    if args.fmt == "json":
        new_set = {id(v) for v in res.new}
        report = {
            "total": len(violations),
            "new": len(res.new),
            "baselined": len(violations) - len(res.new),
            "per_pass": {k: per_pass.get(k, 0) for k in PASS_NAMES},
            "per_pass_ms": {k: round(timings[k], 3)
                            for k in PASS_NAMES if k in timings},
            "stale_fingerprints": sorted(res.fixed),
            "violations": [
                {"file": v.file, "line": v.line, "pass": v.pass_name,
                 "message": v.message, "scope": v.scope,
                 "fingerprint": v.fingerprint, "new": id(v) in new_set}
                for v in violations],
        }
        print(json.dumps(report, indent=1))
        return 1 if res.new else 0

    if args.fmt == "github":
        # Workflow-annotation lines: one ::error per NEW violation so
        # the PR diff view pins each regression to its source line.
        for v in res.new:
            print(f"::error file={v.file},line={v.line},"
                  f"title=raylint {v.pass_name}::{v.message}")
        for fp in sorted(res.fixed):
            print(f"::notice title=raylint stale baseline::{fp} no "
                  f"longer fires; refresh with --update-baseline")
        return 1 if res.new else 0

    if not args.quiet:
        for v in res.new:
            print(v.render())
        if res.fixed:
            print(f"raylint: {len(res.fixed)} baselined fingerprint(s) "
                  f"no longer fire — burn them down with "
                  f"--update-baseline:")
            for fp in sorted(res.fixed):
                print(f"  stale: {fp}")
        summary = ", ".join(f"{k}={per_pass.get(k, 0)}"
                            for k in PASS_NAMES)
        print(f"raylint: {len(violations)} total ({summary}); "
              f"{len(violations) - len(res.new)} baselined, "
              f"{len(res.new)} new")
    return 1 if res.new else 0


if __name__ == "__main__":
    sys.exit(main())
