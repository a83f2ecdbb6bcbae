"""The harness refuses to run where it cannot measure: without a card,
and in a directory that holds only the benchmark (no program). Either
way it exits non-zero and prints no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmarks import harness

ARGS = ["--workload", "gpt2-small.train.b64", "--seed", str(2**31 + 5),
        "--seconds", "1", "--trace", "0"]


def run_from(root, env=None):
    return subprocess.run(
        [sys.executable, os.path.join("benchmarks", "run.py"), *ARGS],
        cwd=root, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, **(env or {})))


def no_result(r):
    for line in r.stdout.strip().splitlines()[-1:]:
        with pytest.raises(ValueError):
            json.loads(line)
    return True


def test_no_card_exits_nonzero():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    r = run_from(harness.ROOT)
    assert r.returncode == 2 and no_result(r), r.stderr[-2000:]
    assert "no CUDA card" in r.stderr


def test_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    r = run_from(str(tmp_path), {"PYTHONPATH": ""})
    assert r.returncode != 0 and no_result(r)
