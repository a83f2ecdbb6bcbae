"""The port's profiling utilities (``ray_tpu_torch.util.profiling``, on
``torch.profiler``): ``tests/test_profiling.py``'s four cases, which run
the JAX package's (on ``jax.profiler``), on the port. On the CPU a trace
holds the host's operators; ``chip_smoke.py`` traces the card's kernels
and copies."""
import glob
import json
import os
import time

import torch

import ray_tpu_torch as rt
from ray_tpu_torch.util import profiling


class TestProfiling:
    def test_trace_writes_artifacts(self, tmp_path):
        with profiling.trace(str(tmp_path / "tb")) as logdir:
            x = torch.ones((128, 128))
            (x @ x).sum()
        files = glob.glob(os.path.join(logdir, "**", "*"), recursive=True)
        traces = [f for f in files if f.endswith(".pt.trace.json")]
        assert len(traces) == 1, files
        with open(traces[0]) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert "aten::mm" in names

    def test_profile_decorator(self, tmp_path):
        @profiling.profile(logdir=str(tmp_path / "tb2"))
        def compute():
            return float(torch.arange(8).sum())

        assert compute() == 28.0
        assert os.path.isdir(str(tmp_path / "tb2"))
        assert glob.glob(str(tmp_path / "tb2" / "*.pt.trace.json"))

    def test_annotate_and_memory_stats(self, tmp_path):
        with profiling.trace(str(tmp_path / "tb3")) as logdir:
            with profiling.annotate("section"):
                torch.ones(4).sum()
        (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        with open(path) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert "section" in names
        stats = profiling.device_memory_stats()
        assert stats == {}  # no card here, as JAX's CPU backend may say

    def test_timer_records_span(self):
        rt.init(num_cpus=1)
        try:
            before = time.time_ns() / 1e3
            with profiling.Timer("my-section") as t:
                pass
            after = time.time_ns() / 1e3
            assert t.elapsed_s is not None
            from ray_tpu_torch._private.state import get_node
            spans = get_node().gcs.spans()
            (mine,) = [s for s in spans if s["name"] == "my-section"]
            # Stamped on the wall clock every span and a profiler trace
            # share, in µs.
            assert before <= mine["ts"] <= mine["ts"] + mine["dur"] <= after
            assert profiling.default_logdir() == os.path.join(
                get_node().session_dir, "profiles")
        finally:
            rt.shutdown()
