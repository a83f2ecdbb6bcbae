"""The port's autoscaler (``ray_tpu_torch/autoscaler``) on the CPU, held
against ray_tpu's.

The same demand tables go to both packages' ``get_nodes_to_launch`` and
``StandardAutoscaler`` (over ``FakeMultiNodeProvider``), with TPU renamed
to GPU on the port's side: their outputs must be equal. Then the v2
reconciler launches REAL node daemons on both: a queued demand brings a
daemon up, the task runs there, and the idle node is drained and
terminated, its process group reaped. The port's daemon declares the
node type's GPUs (faked here: no card is needed). Every wait has its own
deadline; every runtime and manager is shut down in a ``finally``.
"""

import importlib
import os
import time

import numpy as np
import pytest

from ray_tpu_torch._private.test_utils import group_members

PACKAGES = ("ray_tpu", "ray_tpu_torch")
TIMEOUT = 60


def _gpu(table):
    """A TPU table (dict, list or str key) with TPU renamed to GPU."""
    if isinstance(table, dict):
        return {_gpu(k): _gpu(v) for k, v in table.items()}
    if isinstance(table, list):
        return [_gpu(v) for v in table]
    return "GPU" if table == "TPU" else table


def _config(package, spec):
    """ClusterConfig of ``package`` from a TPU-keyed spec dict."""
    mod = importlib.import_module(package + ".autoscaler.config")
    return mod.ClusterConfig.from_dict(
        spec if package == "ray_tpu" else _gpu(spec))


# The node types of tests/test_autoscaler.py, as the YAML schema writes
# them: a CPU worker, an 8-chip host, and a 16-chip gang of 4 hosts.
SPEC = {"max_workers": 20, "idle_timeout_minutes": 0.2 / 60,
        "available_node_types": {
            "cpu_worker": {"resources": {"CPU": 8}, "max_workers": 10},
            "accel_8": {"resources": {"CPU": 120, "TPU": 8},
                        "max_workers": 4},
            "accel_16": {"resources": {"CPU": 120, "TPU": 4},
                         "hosts_per_node": 4, "max_workers": 2}}}

# (demands, placement-group bundles, current counts, spec changes)
CASES = {
    "basic": ([{"CPU": 4.0}] * 4, [], {}, {}),
    "gang_demand": ([{"TPU": 16.0}], [], {}, {}),
    "tight_fit": ([{"TPU": 8.0}], [], {}, {}),
    "type_cap": ([{"CPU": 8.0}] * 30, [], {"cpu_worker": 8}, {}),
    "gang_cap": ([{"TPU": 16.0}] * 5, [], {}, {}),
    "min_workers": ([], [], {}, {"cpu_worker": {"min_workers": 3}}),
    "bundles": ([], [{"TPU": 4.0}] * 4, {}, {}),
    "existing_absorbs": ([{"TPU": 4.0}] * 2, [], {"accel_8": 1}, {}),
    "infeasible": ([{"TPU": 64.0}, {"CPU": 1.0}], [], {}, {}),
    "mixed": ([{"CPU": 2.0, "TPU": 1.0}] * 9 + [{"CPU": 100.0}], [],
              {"cpu_worker": 1}, {}),
    "cluster_cap": ([{"CPU": 8.0}] * 40, [], {}, {"max_workers": 3}),
}


def _random_case(seed):
    rng = np.random.default_rng(seed)
    demands = []
    for _ in range(int(rng.integers(0, 24))):
        d = {"CPU": float(rng.choice([0.5, 1, 2, 4, 8, 16]))}
        if rng.random() < 0.5:
            d["TPU"] = float(rng.choice([1, 2, 4, 8, 16]))
        demands.append(d)
    bundles = [{"TPU": float(rng.choice([1, 4]))}
               for _ in range(int(rng.integers(0, 4)))]
    counts = {name: int(rng.integers(0, 3))
              for name in SPEC["available_node_types"]
              if rng.random() < 0.4}
    return demands, bundles, counts, {}


def _spec(changes):
    spec = {**SPEC, "available_node_types": {
        k: dict(v) for k, v in SPEC["available_node_types"].items()}}
    for key, value in changes.items():
        if isinstance(value, dict):
            spec["available_node_types"][key].update(value)
        else:
            spec[key] = value
    return spec


def _launch(package, case):
    demands, bundles, counts, changes = case
    mod = importlib.import_module(
        package + ".autoscaler.resource_demand_scheduler")
    if package == "ray_tpu_torch":
        demands, bundles = _gpu(demands), _gpu(bundles)
    return mod.get_nodes_to_launch(demands, bundles, dict(counts),
                                   _config(package, _spec(changes)))


class TestGetNodesToLaunch:
    @pytest.mark.parametrize("name", sorted(CASES))
    def test_table(self, name):
        ours = _launch("ray_tpu_torch", CASES[name])
        assert ours == _launch("ray_tpu", CASES[name])

    @pytest.mark.parametrize("seed", range(12))
    def test_random_table(self, seed):
        case = _random_case(seed)
        assert _launch("ray_tpu_torch", case) == _launch("ray_tpu", case)

    def test_known_answers(self):
        assert _launch("ray_tpu_torch", CASES["basic"]) == {"cpu_worker": 2}
        assert _launch("ray_tpu_torch", CASES["gang_demand"]) == \
            {"accel_16": 1}
        assert _launch("ray_tpu_torch", CASES["tight_fit"]) == {"accel_8": 1}


def _scaler(package, demands, placement_groups=None, changes=None):
    auto = importlib.import_module(package + ".autoscaler")
    if package == "ray_tpu_torch":
        demands = _gpu(demands)
        placement_groups = _gpu(placement_groups)
    provider = auto.FakeMultiNodeProvider()
    source = auto.StaticLoadSource(demands=demands)
    scaler = auto.StandardAutoscaler(
        _config(package, _spec(changes or {})), provider, source)
    if placement_groups:
        load = {"demands": [], "placement_groups": placement_groups}
        source.get_demands = lambda: load
    return auto, provider, source, scaler


def _nodes(auto, provider):
    tags = [provider.node_tags(n) for n in provider.non_terminated_nodes({})]
    return (sorted(t[auto.TAG_NODE_TYPE] for t in tags),
            len({t[auto.TAG_SLICE_ID] for t in tags}))


class TestStandardAutoscaler:
    def _up_and_down(self, package, changes):
        auto, provider, source, scaler = _scaler(
            package, [{"CPU": 8.0}] * 2 + [{"TPU": 16.0}], changes=changes)
        seen = [scaler.update(), _nodes(auto, provider)]
        scaler.update()  # the same demand launches nothing more
        seen.append(_nodes(auto, provider))
        source.set(demands=[], busy=set())
        scaler.update()  # starts the idle clocks
        time.sleep(0.25)
        scaler.update()  # past idle_timeout_s: terminate
        seen.append(_nodes(auto, provider))
        return seen

    @pytest.mark.parametrize("min_workers", [0, 1])
    def test_up_and_down(self, min_workers):
        changes = {"cpu_worker": {"min_workers": min_workers}}
        ours = self._up_and_down("ray_tpu_torch", changes)
        assert ours == self._up_and_down("ray_tpu", changes)
        # the CPU demands fit beside the gang demand on its 4 hosts
        assert ours[1] == (["accel_16"] * 4 + ["cpu_worker"] * min_workers,
                           1 + min_workers)
        assert ours[-1] == (["cpu_worker"] * min_workers, min_workers)

    def test_strict_pack_gang(self):
        def run(package):
            pg = [{"bundles": [{"TPU": 4.0}] * 4, "strategy": "STRICT_PACK"}]
            auto, provider, _, scaler = _scaler(package, [], pg)
            scaler.update()
            return _nodes(auto, provider)

        ours = run("ray_tpu_torch")
        assert ours == run("ray_tpu") == (["accel_16"] * 4, 1)

    def test_provider_failure_isolated(self):
        from ray_tpu_torch.autoscaler import (FakeMultiNodeProvider,
                                              StandardAutoscaler,
                                              StaticLoadSource)

        scaler = StandardAutoscaler(
            _config("ray_tpu_torch", SPEC),
            FakeMultiNodeProvider({"fail_types": ["accel_8"]}),
            StaticLoadSource(demands=[{"GPU": 8.0}]))
        with pytest.raises(RuntimeError, match="stockout"):
            scaler.update()


class TestGPUNodeTypes:
    def test_gpu_node_type(self):
        from ray_tpu_torch.autoscaler import gpu_node_type

        one = gpu_node_type("h100x1", "H100", 1, cpus_per_host=4,
                            max_workers=1)
        assert (one.resources, one.hosts_per_node, one.slice_extra) == (
            {"CPU": 4.0, "GPU": 1.0, "H100": 1.0}, 1, {})
        gang = gpu_node_type("h100x16", "H100", 16)
        assert gang.hosts_per_node == 2
        assert gang.slice_resources() == {"CPU": 192.0, "GPU": 16.0,
                                          "H100": 16.0}

    def test_gang_type_takes_a_gang_demand(self):
        from ray_tpu_torch.autoscaler import (ClusterConfig,
                                              get_nodes_to_launch,
                                              gpu_node_type)

        cfg = ClusterConfig(node_types={
            "one": gpu_node_type("one", "H100", 8),
            "two": gpu_node_type("two", "H100", 16)})
        assert get_nodes_to_launch([{"GPU": 16.0}], [], {}, cfg) == {"two": 1}
        assert get_nodes_to_launch([{"H100": 8.0, "GPU": 8.0}], [], {},
                                   cfg) == {"one": 1}

    def test_tpu_node_type_raises(self):
        from ray_tpu_torch.autoscaler import NodeTypeConfig

        with pytest.raises(ValueError, match="GPU"):
            NodeTypeConfig("v4", {"CPU": 8.0, "TPU": 4.0})
        _config("ray_tpu", SPEC)  # the reference takes TPU node types
        with pytest.raises(ValueError, match="GPU"):
            importlib.import_module("ray_tpu_torch.autoscaler").load_config(
                SPEC)

    def test_exports(self):
        ours = set(importlib.import_module("ray_tpu_torch.autoscaler").__all__)
        theirs = set(importlib.import_module("ray_tpu.autoscaler").__all__)
        assert ours == theirs - {"tpu_slice_node_type"} | {"gpu_node_type"}


# -- v2: real daemons ------------------------------------------------------

def _init(package, **kwargs):
    pkg = importlib.import_module(package)
    pkg.shutdown()
    if package == "ray_tpu_torch":
        kwargs.setdefault("num_gpus", 0)
    pkg.init(**kwargs)
    return pkg


@pytest.fixture
def shutdown_both():
    yield
    for package in PACKAGES:
        importlib.import_module(package).shutdown()


def demand_launches_real_daemon(package, resources, task_options):
    """The v2 test of tests/test_autoscaler.py: a queued demand launches a
    real daemon, the task runs there, and once idle past the timeout and
    its grace the node is drained and terminated. Returns what both
    packages must agree on, and the task's own report."""
    from importlib import import_module

    pkg = _init(package, num_cpus=1)
    v2 = import_module(package + ".autoscaler.v2")
    ray_config = import_module(package + "._private.config").ray_config
    mgr = v2.InstanceManager(
        node_types={"accel": {"resources": resources, "max_workers": 2}},
        max_workers=2, idle_timeout_s=2.0)
    saved_grace = ray_config.scale_down_idle_grace_s
    ray_config.set("scale_down_idle_grace_s", 0.3)
    statuses = []
    try:
        @pkg.remote(**task_options)
        def probe():
            return (os.getpid(), pkg.get_runtime_context().get_node_id(),
                    os.environ.get("CUDA_VISIBLE_DEVICES"))

        ref = probe.remote()
        deadline = time.monotonic() + TIMEOUT
        while not pkg.wait([ref], timeout=0.2)[0]:
            mgr.reconcile()
            statuses.append(sorted(mgr.status_counts()))
            assert time.monotonic() < deadline, mgr.status_counts()
        pid, node, visible = pkg.get(ref, timeout=TIMEOUT)
        while mgr.status_counts().get(v2.RAY_RUNNING, 0) < 1:
            assert time.monotonic() < deadline, mgr.status_counts()
            mgr.reconcile()
            time.sleep(0.1)
        (inst,) = mgr.instances.values()
        proc = inst.handle["proc"]
        resources_then = pkg.cluster_resources()
        deadline = time.monotonic() + TIMEOUT
        while any(i.status == v2.RAY_RUNNING for i in mgr.instances.values()):
            assert time.monotonic() < deadline, mgr.status_counts()
            mgr.reconcile()
            time.sleep(0.2)
        return {"node": node == inst.node_id_hex,
                "other_process": pid != os.getpid(),
                "statuses": mgr.status_counts(),
                "exited": proc.poll() is not None,
                "resources_then": {k: resources_then.get(k)
                                   for k in ("GPU", "accel")},
                "capacity_left": "accel" not in pkg.cluster_resources()
                and "GPU" not in pkg.cluster_resources(),
                "launched_once": all(s.count(v2.ALLOCATED) <= 1
                                     for s in statuses)}, visible, proc
    finally:
        ray_config.set("scale_down_idle_grace_s", saved_grace)
        mgr.shutdown()
        pkg.shutdown()


class TestAutoscalerV2:
    def test_demand_launches_real_daemon_and_task_runs(self, shutdown_both):
        resources = {"CPU": 1, "accel": 1}
        got, visible = {}, {}
        for package in PACKAGES:
            got[package], visible[package], proc = \
                demand_launches_real_daemon(package, resources,
                                            {"resources": {"accel": 1}})
            if package == "ray_tpu_torch":
                assert not group_members(proc.pid)
        assert got["ray_tpu_torch"] == got["ray_tpu"]
        # A worker without a GPU sees no card (ray_tpu leaves the key
        # unset: its workers are pinned through TPU_VISIBLE_CHIPS).
        assert visible == {"ray_tpu": None, "ray_tpu_torch": ""}
        assert got["ray_tpu_torch"] == {
            "node": True, "other_process": True,
            "statuses": {"TERMINATED": 1}, "exited": True,
            "resources_then": {"GPU": None, "accel": 1.0},
            "capacity_left": True, "launched_once": True}

    def test_gpu_demand_launches_a_gpu_daemon(self, shutdown_both):
        """The port's own case: the head holds no GPU, a num_gpus=1 task
        waits, and the autoscaler brings up a daemon that declares the
        node type's GPU (faked) and pins the task's worker to it."""
        got, visible, proc = demand_launches_real_daemon(
            "ray_tpu_torch", {"CPU": 1, "GPU": 1}, {"num_gpus": 1})
        assert not group_members(proc.pid)
        assert visible == "0"
        assert got == {
            "node": True, "other_process": True,
            "statuses": {"TERMINATED": 1}, "exited": True,
            "resources_then": {"GPU": 1.0, "accel": None},
            "capacity_left": True, "launched_once": True}

    def test_allocate_timeout_terminates_outside_lock(self, shutdown_both):
        """The ALLOCATE-timeout path releases the machine OUTSIDE the
        manager lock: a slow provider.terminate must not block launch
        decisions."""
        import threading

        from ray_tpu_torch.autoscaler.v2 import (TERMINATED, InstanceManager,
                                                 InstanceProvider)

        class SlowTerminateProvider(InstanceProvider):
            def __init__(self):
                self.in_terminate = threading.Event()
                self.release = threading.Event()

            def allocate(self, instance, node_type_config):
                instance.handle = {}

            def running_node_id(self, instance):
                return None  # never registers -> ALLOCATE timeout

            def terminate(self, instance):
                self.in_terminate.set()
                self.release.wait(timeout=10)

        _init("ray_tpu_torch", num_cpus=1)
        provider = SlowTerminateProvider()
        mgr = InstanceManager(
            node_types={"w": {"resources": {"CPU": 1},
                              "min_workers": 1, "max_workers": 1}},
            provider=provider, max_workers=1, idle_timeout_s=60.0)
        try:
            mgr.reconcile()
            inst = next(iter(mgr.instances.values()))
            assert inst.status == "ALLOCATED"
            inst.created_at -= mgr.ALLOCATE_TIMEOUT_S + 1
            t = threading.Thread(target=mgr.reconcile, daemon=True)
            t.start()
            assert provider.in_terminate.wait(timeout=10)
            got = mgr._lock.acquire(timeout=0.5)
            try:
                assert got, "reconcile held the lock across terminate()"
            finally:
                if got:
                    mgr._lock.release()
            provider.release.set()
            t.join(timeout=10)
            assert not t.is_alive() and inst.status == TERMINATED
        finally:
            provider.release.set()
            mgr.shutdown()

    def test_idle_grace_survives_oscillating_workload(self, shutdown_both):
        """Idle past idle_timeout_s is not enough: the node must also stay
        idle for scale_down_idle_grace_s, and a burst re-arms both."""
        from ray_tpu_torch._private.config import ray_config
        from ray_tpu_torch.autoscaler.v2 import (RAY_RUNNING, TERMINATED,
                                                 InstanceManager,
                                                 InstanceProvider)

        fake_hex = "ab" * 32

        class FakeProvider(InstanceProvider):
            def allocate(self, instance, node_type_config):
                instance.handle = {}

            def running_node_id(self, instance):
                return fake_hex

            def terminate(self, instance):
                pass

        class FakeRT:
            class _HS:
                daemons = {fake_hex: object()}
            head_server = _HS()

            def gcs_request(self, op, **kw):
                if op == "resource_demands":
                    return {"demands": [], "placement_groups": []}
                raise ValueError(op)  # drain of a fake node: degrade

        _init("ray_tpu_torch", num_cpus=1)
        saved = float(ray_config.scale_down_idle_grace_s)
        ray_config.set("scale_down_idle_grace_s", 0.5)
        busy = {"v": True}
        mgr = InstanceManager(
            node_types={"w": {"resources": {"CPU": 1}, "max_workers": 1}},
            provider=FakeProvider(), max_workers=1, idle_timeout_s=0.1)
        mgr._rt = FakeRT()
        mgr._node_busy = lambda node_hex: busy["v"]
        try:
            mgr._queue_instance("w")
            mgr.reconcile()
            mgr.reconcile()
            inst = next(iter(mgr.instances.values()))
            assert inst.status == RAY_RUNNING
            busy["v"] = False
            inst.updated_at = time.time() - 10
            mgr.reconcile()
            assert inst.status == RAY_RUNNING and inst.idle_since is not None
            busy["v"] = True
            mgr.reconcile()
            assert inst.idle_since is None and inst.status == RAY_RUNNING
            busy["v"] = False
            inst.updated_at = time.time() - 10
            mgr.reconcile()
            assert inst.status == RAY_RUNNING
            time.sleep(0.6)
            mgr.reconcile()
            assert inst.status == TERMINATED
        finally:
            ray_config.set("scale_down_idle_grace_s", saved)
            mgr.shutdown()

    def test_tpu_node_type_raises(self, shutdown_both):
        from ray_tpu_torch.autoscaler.v2 import InstanceManager

        _init("ray_tpu_torch", num_cpus=1)
        with pytest.raises(ValueError, match="GPU"):
            InstanceManager(node_types={"v4": {"resources": {"TPU": 4}}})
