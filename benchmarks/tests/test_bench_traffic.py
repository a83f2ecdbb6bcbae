"""The batch-generation traffic's prompt lengths: fixed quantiles of the
workload's log-normal, the same set for every seed, cut to the context."""

import numpy as np
import pytest

from benchmarks import harness
from benchmarks.traffic.batch_infer import prompt_lengths


def test_lengths_follow_the_median_and_the_cut():
    n, cap = 4096, 1011
    free = prompt_lengths(n, 1500.0, 1.0, 10**9)
    assert np.median(free) == pytest.approx(1500, rel=1e-3)
    cut = prompt_lengths(n, 1500.0, 1.0, cap)
    assert cut.max() == cap and cut.min() >= 1
    # A log-normal of median 1500 and sigma 1 lies above 1011 with
    # probability Phi(ln(1500 / 1011)) = 0.653.
    assert np.mean(cut == cap) == pytest.approx(0.653, abs=0.005)
    assert np.array_equal(np.sort(cut), cut)     # quantiles, in order


def test_the_cell_fits_its_context():
    cell = harness.find_cell("gpt2-small.batch-infer.code")
    p = cell.params
    seq = cell.family.sizes(cell.config)["seq"]
    lengths = prompt_lengths(int(p["rows"]), float(p["prompt_median"]),
                             float(p["prompt_sigma"]),
                             seq - int(p["max_new_tokens"]))
    assert lengths.max() + int(p["max_new_tokens"]) == seq
