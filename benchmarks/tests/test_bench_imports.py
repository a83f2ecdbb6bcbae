"""What the benchmark loads: no module of it imports JAX or the JAX
package by top-level name (compared whole, so ``ray_tpu_torch`` passes),
the reference imports nothing of the program, and a run on the CPU ends
with neither in ``sys.modules``."""

import ast
import os
import subprocess
import sys

import pytest

from benchmarks import harness

FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(harness.BENCH)
               for f in fs if f.endswith(".py"))


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: os.path.relpath(p, harness.BENCH))
def test_no_jax_nor_the_jax_package(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", [f for f in FILES if os.sep + "reference"
                                  + os.sep in f],
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "ray_tpu_torch" not in names
    assert "benchmarks" not in names     # relative imports stay inside


def test_forbidden_names_compare_whole():
    assert "ray_tpu_torch" not in harness.FORBIDDEN
    before = dict(sys.modules)
    try:
        sys.modules.pop("ray_tpu", None)
        assert "ray_tpu" not in harness.forbidden_modules() or \
            "ray_tpu" in before
    finally:
        sys.modules.update(before)


def test_a_cpu_run_loads_neither(tiny):
    root, bench = tiny
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {harness.ROOT!r})\n"
        "from benchmarks.run import run_cell\n"
        "from benchmarks import harness\n"
        f"out = run_cell('gpt2-small.batch-infer.code', 5, 0.5, False, "
        f"torch.device('cpu'), 0.0, bench_dir={bench!r}, root={root!r})\n"
        "print(harness.forbidden_modules(), out['correct'])\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[] True"
