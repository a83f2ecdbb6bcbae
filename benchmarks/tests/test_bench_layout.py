"""BENCHMARK.json against the contract's shape, and every name it gives
found as a file of its own; a new cell, configuration or metric dropped
into a copy is found by name."""

import json
import os
import re

import pytest

from benchmarks import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.benchmark_spec()


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmarks"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(set(names)) == len(names)
    for e in SPEC[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]


def test_cells_match_their_files():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        cell = harness.find_cell(w["name"])
        assert cell.workload["config"] == w["config"]
        assert cell.workload["chips"] == w["chips"] == 1
        assert cell.workload["why"] == w["why"]
        assert os.path.exists(os.path.join(harness.ROOT,
                                           configs[w["config"]]["file"]))
        assert cell.config["reduced"] == configs[w["config"]]["reduced"]
        harness.load_driver(cell)
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == set(configs)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in harness.metrics_for(SPEC, w["name"],
                                                      "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = harness.metrics_for(SPEC, w["name"], "per_layer")
        assert layers
        for m in layers:
            assert m["moves"] in e2e


def test_every_per_layer_metric_has_a_reader():
    for m in SPEC["per_layer"]:
        assert callable(harness.load_metric(m["name"]))


def test_limits_cover_every_number():
    wanted = {"train_resident": {"loss_gap", "grad_norm_gap",
                                 "update_norm_gap"},
              "train_fed": {"loss_gap", "grad_norm_gap", "update_norm_gap",
                            "feed_mismatch"},
              "batch_infer": {"logit_gap"}}
    for w in SPEC["workloads"]:
        cell = harness.find_cell(w["name"])
        assert set(cell.workload["limits"]) == wanted[
            cell.workload["traffic"]]


def test_new_files_are_found_by_name(tiny):
    root, bench = tiny
    w = harness.load_json(os.path.join(bench, "workloads",
                                       "gpt2-small.train.b64.json"))
    w["config"] = "gpt2-other"
    with open(os.path.join(bench, "workloads", "gpt2-other.train.json"),
              "w") as f:
        json.dump(w, f)
    c = harness.load_json(os.path.join(bench, "configs", "gpt2-small.json"))
    c["n_layer"] = 3
    with open(os.path.join(bench, "configs", "gpt2-other.json"), "w") as f:
        json.dump(c, f)
    with open(os.path.join(bench, "metrics", "steps_seen.train.py"),
              "w") as f:
        f.write("def read(ctx):\n    return ctx.window.get('steps')\n")
    cell = harness.find_cell("gpt2-other.train", bench)
    assert cell.config["n_layer"] == 3
    assert cell.family.sizes(cell.config)["layers"] == 3
    read = harness.load_metric("steps_seen.train", bench)
    assert read(harness.MetricContext(cell, None, {"steps": 7}, None)) == 7
    spec = harness.benchmark_spec(root)
    spec["per_layer"].append({"name": "steps_seen.train",
                              "workloads": ["gpt2-other.train"]})
    assert [m["name"] for m in harness.metrics_for(
        spec, "gpt2-other.train", "per_layer")] == ["steps_seen.train"]
