"""GPU resources and per-worker pinning in ray_tpu_torch's control plane,
on the CPU with a faked GPU count.

The node counts its GPUs without torch (``RTT_NUM_GPUS`` fakes the count
here), ``num_gpus`` reserves them, and the scheduler pins each worker to
specific ids through ``CUDA_VISIBLE_DEVICES`` before it starts; a worker
that asks for no GPU gets it empty. One cluster (4 CPUs, 2 faked GPUs)
serves the module; every wait carries its own deadline.
"""

import os
import sys
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch._private.placement import gpus_in_demand
from ray_tpu_torch._private.resources import (GPUAcceleratorManager,
                                              detect_node_resources,
                                              gpu_worker_extra_env)

TIMEOUT = 60


class TestDetection:
    @pytest.mark.parametrize("env,want", [
        ({"RTT_NUM_GPUS": "3", "CUDA_VISIBLE_DEVICES": "0"}, 3),
        ({"CUDA_VISIBLE_DEVICES": "2,3"}, 2),
        ({"CUDA_VISIBLE_DEVICES": ""}, 0),
        ({"CUDA_VISIBLE_DEVICES": "GPU-1a2b"}, 1),
    ])
    def test_count(self, monkeypatch, env, want):
        monkeypatch.delenv("RTT_NUM_GPUS", raising=False)
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        assert GPUAcceleratorManager.get_current_node_num_accelerators() \
            == want

    def test_explicit_count_overrides_detection(self, monkeypatch):
        monkeypatch.setenv("RTT_NUM_GPUS", "2")
        assert detect_node_resources(num_cpus=1)["GPU"] == 2.0
        assert detect_node_resources(num_cpus=1, num_gpus=1)["GPU"] == 1.0
        assert "GPU" not in detect_node_resources(num_cpus=1, num_gpus=0)

    @pytest.mark.parametrize("driver,ids,want", [
        (None, [0], "0"), (None, [0, 1], "0,1"),
        ("4,6", [1], "6"), ("4,6", [0, 1], "4,6"), ("", [1], "1")])
    def test_pinned_env_indexes_the_drivers_devices(self, monkeypatch,
                                                    driver, ids, want):
        if driver is None:
            monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        else:
            monkeypatch.setenv("CUDA_VISIBLE_DEVICES", driver)
        assert gpu_worker_extra_env(ids) == {"CUDA_VISIBLE_DEVICES": want}

    @pytest.mark.parametrize("demand,want", [
        ({"CPU": 1.0}, 0), ({"GPU": 1.0}, 1), ({"GPU": 2.0}, 2),
        ({"GPU": 0.5}, 1),
        ({"GPU_group_ab12": 2.0, "GPU_group_0_ab12": 2.0}, 2)])
    def test_gpus_in_demand(self, demand, want):
        assert gpus_in_demand(demand) == want

    def test_counting_loads_no_torch(self):
        import subprocess

        code = ("import sys\n"
                "from ray_tpu_torch._private.resources import "
                "detect_node_resources\n"
                "detect_node_resources()\n"
                "print('torch' in sys.modules)")
        env = {k: v for k, v in os.environ.items() if k != "RTT_NUM_GPUS"}
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             cwd=os.path.dirname(os.path.dirname(
                                 os.path.abspath(__file__))),
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout.strip()
        assert out == "False"


@pytest.fixture(scope="module")
def cluster():
    old = os.environ.get("RTT_NUM_GPUS")
    os.environ["RTT_NUM_GPUS"] = "2"
    try:
        rt.init(num_cpus=4)
    finally:
        if old is None:
            del os.environ["RTT_NUM_GPUS"]
        else:
            os.environ["RTT_NUM_GPUS"] = old
    yield rt.get_runtime_context()
    rt.shutdown()


@rt.remote
def visible():
    return (os.environ.get("CUDA_VISIBLE_DEVICES"), rt.get_gpu_ids(),
            sys.flags.no_site, os.getpid())


@rt.remote(num_gpus=1)
def visible_after(seconds):
    time.sleep(seconds)
    return os.environ.get("CUDA_VISIBLE_DEVICES"), rt.get_gpu_ids()


class TestPinning:
    def test_detected_count_is_the_gpu_resource(self, cluster):
        assert rt.cluster_resources()["GPU"] == 2.0

    def test_zero_gpu_task_sees_no_device(self, cluster):
        env, ids, no_site, pid = rt.get(visible.remote(), timeout=TIMEOUT)
        assert env == "" and ids == []
        assert pid != os.getpid()
        # No device pinned: the lean (-S) boot.
        assert no_site == 1

    def test_gpu_tasks_get_distinct_devices(self, cluster):
        # Both run at once (each holds its GPU for 1.5 s), so each has
        # a worker of its own.
        got = rt.get([visible_after.remote(1.5) for _ in range(2)],
                     timeout=TIMEOUT)
        assert sorted(env for env, _ in got) == ["0", "1"]
        assert sorted(ids[0] for _, ids in got) == [0, 1]
        assert all(len(ids) == 1 and str(ids[0]) == env
                   for env, ids in got)

    def test_gpu_worker_keeps_the_full_site(self, cluster):
        env, ids, no_site, _ = rt.get(
            visible.options(num_gpus=1).remote(), timeout=TIMEOUT)
        assert env in ("0", "1") and ids == [int(env)]
        assert no_site == 0

    def test_idle_gpu_workers_are_reclaimed(self, cluster):
        # The tasks above left idle workers that hold GPU 0 and GPU 1; an
        # actor that needs both gets them once those workers retire.
        rt.get([visible_after.remote(0.0) for _ in range(2)],
               timeout=TIMEOUT)

        @rt.remote(num_gpus=2)
        class Both:
            def ids(self):
                return os.environ.get("CUDA_VISIBLE_DEVICES"), \
                    rt.get_gpu_ids()

        actor = Both.remote()
        assert rt.get(actor.ids.remote(), timeout=TIMEOUT) == \
            ("0,1", [0, 1])
        rt.kill(actor)
        # Its death hands both back: a one-GPU task runs again.
        env, _ = rt.get(visible_after.remote(0.0), timeout=TIMEOUT)
        assert env in ("0", "1")

    def test_driver_reports_no_gpu_ids(self, cluster, monkeypatch):
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        assert rt.get_gpu_ids() == []
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,GPU-aa")
        assert rt.get_gpu_ids() == [3, "GPU-aa"]


class Probe:
    """A map_batches actor that reports its device and resources."""

    def __call__(self, batch):
        n = len(batch["x"])
        res = rt.get_runtime_context().get_assigned_resources()
        return {"x": batch["x"],
                "cuda": [os.environ.get("CUDA_VISIBLE_DEVICES")] * n,
                "gpu": [float(res.get("GPU", 0.0))] * n}


class TestDataRequestsGPUs:
    @pytest.mark.parametrize("num_gpus,want_gpu", [(1, 1.0), (None, 0.0)])
    def test_map_batches_actor_pool(self, cluster, num_gpus, want_gpu):
        from ray_tpu_torch import data

        kw = {} if num_gpus is None else {"num_gpus": num_gpus}
        rows = data.from_items([{"x": i} for i in range(4)]).map_batches(
            Probe, batch_size=2, concurrency=1, **kw).take_all()
        assert sorted(r["x"] for r in rows) == [0, 1, 2, 3]
        assert {r["gpu"] for r in rows} == {want_gpu}
        cuda = {r["cuda"] for r in rows}
        assert cuda <= ({"0", "1"} if num_gpus else {""}), cuda

    def test_processor_stage_reserves_its_gpu(self, cluster):
        from ray_tpu_torch import data
        from ray_tpu_torch.llm import Processor, StageSpec

        ds = data.from_items([{"x": i} for i in range(3)])
        rows = Processor([StageSpec(Probe, num_gpus=1)], batch_size=3)(
            ds).take_all()
        assert {r["gpu"] for r in rows} == {1.0}
        assert {r["cuda"] for r in rows} <= {"0", "1"}

    def test_build_processor_gpt_stage_asks_for_a_gpu(self):
        from ray_tpu_torch.llm import ProcessorConfig, build_processor

        card = build_processor(ProcessorConfig())
        cpu = build_processor(ProcessorConfig(device="cpu"))
        assert [s.num_gpus for s in card.stages] == [0, 1, 0]
        assert [s.num_gpus for s in cpu.stages] == [0, 0, 0]


class TestNumTpusRaises:
    """The port's nodes declare GPUs and no TPU: ``num_tpus`` raises at
    once, naming ``num_gpus``, where the copy of ``ray_tpu``'s control
    plane used to turn it into a resource that no node has."""

    def add(self, x):
        return x + 1

    @pytest.mark.parametrize("how", ["decorator", "options"])
    @pytest.mark.parametrize("kind", ["function", "actor"])
    def test_remote(self, kind, how):
        target = self.add if kind == "function" else Probe
        with pytest.raises(ValueError, match="num_gpus"):
            if how == "decorator":
                rt.remote(num_tpus=1)(target)
            else:
                rt.remote(target).options(num_tpus=1)

    def test_zero_is_no_request(self):
        from ray_tpu_torch.api import RemoteFunction

        assert isinstance(rt.remote(num_tpus=0)(self.add), RemoteFunction)

    def test_map_batches(self, cluster):
        from ray_tpu_torch import data

        ds = data.from_items([{"x": 1}])
        with pytest.raises(ValueError, match="num_gpus"):
            ds.map_batches(Probe, concurrency=1, num_tpus=1)
