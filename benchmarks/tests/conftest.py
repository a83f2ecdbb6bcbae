"""Fixtures of the benchmark's own tests: a tiny copy of its data files
(the same cells, limits and metrics at widths a CPU runs in seconds), and
the card check for tests marked ``chip``, made inside the test."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks import harness  # noqa: E402

# Each cell's params at a tiny size; every other key as the cell has it.
TINY_PARAMS = {
    "gpt2-small.train.b64": {"batch": 4, "seq": 64, "reference_rows": 2},
    "vit-b16.train-fed.b512": {"batch": 8, "images": 64, "blocks": 4,
                               "reference_rows": 4, "check_within": 4,
                               "checked_batches": 2},
    "gpt2-small.batch-infer.code": {"batch": 4, "rows": 1500,
                                    "prompt_median": 60,
                                    "max_new_tokens": 4, "sample_rows": 40},
}
# Limits at the tiny size, set as the cells' are but from CPU readings
# over 8 seeds: sound runs read at most (GPT) loss 1.1e-3, gradient 9.3e-4,
# update 2.1e-3, (ViT) 7.0e-3, 4.6e-3, 2.6e-3, (generation) logit 1.9e-2;
# the float8 control at least 1.8e-3, 6.7e-3, 2.5e-3; 2.2e-2, 1.2e-2,
# 7.3e-3; 0.111. The cells' own limits were read at their full widths on
# the card and do not carry over to these widths.
TINY_LIMITS = {
    "gpt2-small.train.b64": {"loss_gap": 3e-3, "grad_norm_gap": 3e-3,
                             "update_norm_gap": 4e-3},
    "vit-b16.train-fed.b512": {"loss_gap": 1.5e-2, "grad_norm_gap": 8e-3,
                               "update_norm_gap": 5e-3,
                               "feed_mismatch": 0},
    "gpt2-small.batch-infer.code": {"logit_gap": 5e-2},
}
TINY_CONFIGS = {
    "gpt2-small": {"n_embd": 64, "n_layer": 2, "n_head": 4,
                   "n_positions": 128, "n_ctx": 128, "vocab_size": 500,
                   "padded_vocab_size": 512},
    "vit-b16": {"hidden_size": 64, "num_hidden_layers": 2,
                "num_attention_heads": 4, "intermediate_size": 128,
                "image_size": 32, "patch_size": 8, "num_labels": 10},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one (decided "
        "inside the test)")


def make_tiny(root: str) -> str:
    """A checkout-like ``root`` holding BENCHMARK.json and a
    ``benchmarks`` data directory of tiny cells; returns that
    directory."""
    bench = os.path.join(root, "benchmarks")
    for d in ("configs", "workloads"):
        os.makedirs(os.path.join(bench, d), exist_ok=True)
    shutil.copytree(os.path.join(harness.BENCH, "metrics"),
                    os.path.join(bench, "metrics"), dirs_exist_ok=True)
    for name, sizes in TINY_CONFIGS.items():
        c = harness.load_json(os.path.join(harness.BENCH, "configs",
                                           f"{name}.json"))
        c.update(sizes)
        with open(os.path.join(bench, "configs", f"{name}.json"), "w") as f:
            json.dump(c, f)
    for name, p in TINY_PARAMS.items():
        w = harness.load_json(os.path.join(harness.BENCH, "workloads",
                                           f"{name}.json"))
        w["params"].update(p)
        w["limits"] = TINY_LIMITS[name]
        with open(os.path.join(bench, "workloads", f"{name}.json"),
                  "w") as f:
            json.dump(w, f)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return bench


@pytest.fixture
def tiny(tmp_path):
    root = str(tmp_path)
    return root, make_tiny(root)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
