"""On the card: each cell runs whole from the checkout, briefly, and comes
out correct with its own metrics. Skips without a card."""

import json
import os
import subprocess
import sys

import pytest

from benchmarks import harness

CELLS = [w["name"] for w in harness.benchmark_spec()["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell):
    r = subprocess.run(
        [sys.executable, os.path.join("benchmarks", "run.py"), "--workload",
         cell, "--seed", str(2**31 + 99), "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    want = {m["name"] for m in harness.metrics_for(
        harness.benchmark_spec(), cell, "end_to_end")}
    assert set(out["metrics"]) == want
    assert out["device"]["platform"] == "gpu"
