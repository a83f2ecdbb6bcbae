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


# -- cloud providers ---------------------------------------------------------

class FakeGcloud:
    """Compute Engine instances behind ``gcloud compute instances``'s argv
    surface: create starts an instance PROVISIONING, delete sets it
    STOPPING; list returns them as gcloud's JSON."""

    def __init__(self):
        self.state = {}
        self.calls = []

    def __call__(self, argv):
        import json

        self.calls.append(list(argv))
        assert argv[:3] == ["gcloud", "compute", "instances"], argv
        verb = argv[3]
        if verb == "create":
            self.state[argv[4]] = "PROVISIONING"
            return ""
        if verb == "delete":
            self.state[argv[4]] = "STOPPING"
            return ""
        if verb == "list":
            return json.dumps([
                {"name": n, "status": s, "networkInterfaces": [
                    {"networkIP": f"10.0.0.{i + 2}"}]}
                for i, (n, s) in enumerate(self.state.items())])
        raise AssertionError(argv)


def _gcp(config=None, runner=None):
    from ray_tpu_torch.autoscaler.gcp_gpu_provider import (
        GcpGpuInstanceProvider)

    fake = runner or FakeGcloud()
    provider = GcpGpuInstanceProvider(
        {"project": "p", "zone": "us-central1-a",
         "machine_type": "a3-highgpu-8g", **(config or {})},
        cluster_name="ray", runner=fake)
    return provider, fake


class TestGcpGpuProvider:
    """The GPU counterpart of tests/test_autoscaler.py's queued-resource
    provider: one node is one Compute Engine VM and its GPUs."""

    def test_create_poll_terminate_lifecycle(self):
        from ray_tpu_torch.autoscaler.config import gpu_node_type
        from ray_tpu_torch.autoscaler.gcp_gpu_provider import node_config_for

        provider, fake = _gcp()
        node_type = gpu_node_type("h100x8", "H100", 8)
        ids = provider.create_node(node_config_for(node_type, "a3-highgpu-8g"),
                                   {"node-type": "h100x8"}, 2)
        assert len(ids) == 2 and all(i.startswith("ray-") for i in ids)
        create = fake.calls[0]
        assert create[3:5] == ["create", ids[0]]
        assert "--machine-type=a3-highgpu-8g" in create
        assert "--maintenance-policy=TERMINATE" in create
        assert not any(a.startswith("--accelerator") for a in create)
        assert {"--zone=us-central1-a", "--project=p"} <= set(create)
        assert provider.non_terminated_nodes({"node-type": "h100x8"}) == ids
        assert not provider.is_running(ids[0])
        fake.state[ids[0]] = "RUNNING"
        assert provider.is_running(ids[0])
        assert provider.internal_ip(ids[0]) == "10.0.0.2"
        provider.terminate_node(ids[1])
        assert fake.calls[-1][3:6] == ["delete", ids[1], "--quiet"]
        assert provider.non_terminated_nodes({}) == [ids[0]]
        assert provider.node_tags(ids[0]) == {"node-type": "h100x8"}
        assert provider.node_tags(ids[1]) == {}

    @pytest.mark.parametrize("status,want", [
        ("PROVISIONING", "pending"), ("STAGING", "pending"),
        ("REPAIRING", "pending"), ("RUNNING", "running"),
        ("STOPPING", "terminated"), ("STOPPED", "terminated"),
        ("SUSPENDING", "terminated"), ("SUSPENDED", "terminated"),
        ("TERMINATED", "terminated"), ("SOMETHING_NEW", "pending")])
    def test_status_map(self, status, want):
        provider, fake = _gcp()
        (nid,) = provider.create_node({}, {}, 1)
        fake.state[nid] = status
        assert provider._status({"status": status}) == want
        assert (nid in provider.non_terminated_nodes({})) == \
            (want != "terminated")
        assert provider.is_running(nid) == (want == "running")

    def test_other_clusters_instances_are_not_listed(self):
        provider, fake = _gcp()
        fake.state["other-1234"] = "RUNNING"
        (nid,) = provider.create_node({}, {}, 1)
        assert provider.non_terminated_nodes({}) == [nid]

    @pytest.mark.parametrize("config,flags", [
        ({"spot": True}, ["--provisioning-model=SPOT",
                          "--instance-termination-action=DELETE"]),
        ({"reserved": True}, ["--reservation-affinity=any"]),
        ({"reservation": "r1"}, ["--reservation-affinity=specific",
                                 "--reservation=r1"]),
        ({"head_address": "10.0.0.1:6379"},
         ["--metadata=startup-script=python3 -m ray_tpu_torch start "
          "--address=10.0.0.1:6379"]),
        ({"machine_type": "n1-standard-16", "gpus": 2,
          "accelerator_type": "nvidia-tesla-t4"},
         ["--accelerator=type=nvidia-tesla-t4,count=2"]),
    ])
    def test_flags(self, config, flags):
        # from the node type's config and from the provider's alike
        for where in ("node", "provider"):
            provider, fake = _gcp(config if where == "provider" else None)
            provider.create_node(config if where == "node" else {}, {}, 1)
            assert set(flags) <= set(fake.calls[0]), (where, fake.calls[0])

    @pytest.mark.parametrize("config,match", [
        ({"gpus": 4}, "carries 8"),                  # a3-highgpu-8g
        ({"machine_type": "n1-standard-16", "gpus": 2}, "accelerator_type"),
    ])
    def test_gpu_count_must_fit_the_machine(self, config, match):
        provider, fake = _gcp()
        with pytest.raises(ValueError, match=match):
            provider.create_node(config, {}, 1)
        assert fake.calls == []

    def test_missing_gcloud_errors_clearly(self, monkeypatch):
        import shutil

        from ray_tpu_torch.autoscaler.gcp_gpu_provider import (
            GcpGpuInstanceProvider)

        monkeypatch.setattr(shutil, "which", lambda name: None)
        provider = GcpGpuInstanceProvider({"project": "p", "zone": "z"})
        with pytest.raises(RuntimeError, match="gcloud"):
            provider.create_node({}, {}, 1)

    def test_registry(self):
        from ray_tpu_torch.autoscaler.gcp_gpu_provider import (
            GcpGpuInstanceProvider, make_provider)
        from ray_tpu_torch.autoscaler.node_provider import (
            FakeMultiNodeProvider)

        assert isinstance(make_provider("fake_multinode", {}),
                          FakeMultiNodeProvider)
        p = make_provider("gcp_gpu_instances", {"project": "p"},
                          runner=FakeGcloud())
        assert isinstance(p, GcpGpuInstanceProvider)
        with pytest.raises(ValueError, match="gcp_gpu_instances"):
            make_provider("gcp_tpu_queued_resources", {})
        with pytest.raises(ValueError, match="unknown provider"):
            make_provider("aws", {})

    def test_registry_kinds_match_the_reference(self):
        ref = importlib.import_module("ray_tpu.autoscaler.gcp_tpu_provider")
        port = importlib.import_module(
            "ray_tpu_torch.autoscaler.gcp_gpu_provider")
        assert set(port.PROVIDERS) == \
            set(ref.PROVIDERS) - {"gcp_tpu_queued_resources"} | \
            {"gcp_gpu_instances"}


class FakeKubectl:
    """tests/test_k8s_provider.py's in-memory pod store behind kubectl's
    argv surface."""

    def __init__(self):
        import threading

        self.pods = {}
        self.lock = threading.Lock()

    def __call__(self, argv, stdin_text=None):
        import json

        assert argv[0] == "kubectl" and argv[1] == "-n"
        args = argv[3:]
        with self.lock:
            if args[0] == "create":
                pod = json.loads(stdin_text)
                pod.setdefault("status", {})["phase"] = "Pending"
                self.pods[pod["metadata"]["name"]] = pod
                return ""
            if args[0] == "get":
                key, val = args[args.index("-l") + 1].split("=", 1)
                return json.dumps({"items": [
                    p for p in self.pods.values()
                    if p["metadata"]["labels"].get(key) == val]})
            if args[0] == "delete":
                self.pods.pop(args[2], None)
                return ""
        raise AssertionError(f"unexpected kubectl {args}")

    def set_running(self, name, ip="10.0.0.9"):
        with self.lock:
            self.pods[name]["status"] = {"phase": "Running", "podIP": ip}


# The reference's provider config (TPU node pool) and the port's (GPU).
K8S_CONFIG = {
    "ray_tpu": {"tpu_accelerator": "tpu-v5-lite-podslice",
                "tpu_topology": "2x4", "tpu_chips_per_host": 4},
    "ray_tpu_torch": {"gpu_accelerator": "nvidia-h100-80gb",
                      "gpus_per_host": 8},
}


def _k8s(package, **extra):
    mod = importlib.import_module(package + ".autoscaler.k8s_provider")
    fake = FakeKubectl()
    prov = mod.KubernetesNodeProvider(
        {"namespace": "ray", "image": "img:1",
         "head_address": "10.0.0.1:6379", **K8S_CONFIG[package], **extra},
        cluster_name="kc", runner=fake)
    return mod, prov, fake


class TestK8sProvider:
    def test_create_list_tags_terminate(self):
        def case(package):
            _, prov, fake = _k8s(package)
            ids = prov.create_node({}, {"node-type": "worker"}, 2)
            out = [len(ids), sorted(prov.non_terminated_nodes({})) ==
                   sorted(ids), prov.node_tags(ids[0]),
                   prov.is_running(ids[0])]
            fake.set_running(ids[0])
            prov._invalidate_pods()
            out += [prov.is_running(ids[0]), prov.internal_ip(ids[0])]
            prov.terminate_node(ids[1])
            return out + [prov.non_terminated_nodes({}) == [ids[0]]]

        outs = {package: case(package) for package in PACKAGES}
        assert outs["ray_tpu_torch"] == outs["ray_tpu"] == [
            2, True, {"node-type": "worker"}, False, True, "10.0.0.9", True]

    def test_manifest_targets_a_gke_gpu_node_pool(self):
        _, prov, fake = _k8s("ray_tpu_torch")
        (nid,) = prov.create_node({}, {"node-type": "gpu_worker"}, 1)
        spec = fake.pods[nid]["spec"]
        assert spec["nodeSelector"] == {
            "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
        (container,) = spec["containers"]
        assert container["resources"]["limits"] == {"nvidia.com/gpu": "8"}
        assert container["resources"]["requests"] == {"nvidia.com/gpu": "8"}
        assert container["command"] == [
            "python", "-m", "ray_tpu_torch.scripts.cli", "start",
            "--address=10.0.0.1:6379"]
        assert container["image"] == "img:1"

    def test_default_image_is_the_ports(self):
        mod = importlib.import_module("ray_tpu_torch.autoscaler.k8s_provider")
        prov = mod.KubernetesNodeProvider({}, runner=FakeKubectl())
        assert prov.image == "ray-tpu-torch:latest"

    @pytest.mark.parametrize("key,gpu_key", [
        ("tpu_chips_per_host", "gpus_per_host"),
        ("tpu_accelerator", "gpu_accelerator"),
        ("tpu_topology", "no topology")])
    def test_tpu_keys_raise(self, key, gpu_key):
        mod = importlib.import_module("ray_tpu_torch.autoscaler.k8s_provider")
        with pytest.raises(ValueError, match=gpu_key):
            mod.KubernetesNodeProvider({key: "x"}, runner=FakeKubectl())
        _, prov, fake = _k8s("ray_tpu_torch")
        with pytest.raises(ValueError, match=gpu_key):
            prov.create_node({key: "x"}, {}, 1)
        assert fake.pods == {}

    def test_v2_instance_manager_scales_up_and_down(self, shutdown_both):
        """test_k8s_provider.py's v2 case in both packages: a standing
        demand creates a pod, the pod's daemon "registers" (faked), the
        instance runs, and the instance is reconciled out, its pod
        deleted through kubectl."""
        def case(package):
            pkg = _init(package, num_cpus=1)
            mod, prov, fake = _k8s(package)
            v2 = importlib.import_module(package + ".autoscaler.v2")
            registered = {}
            mgr = v2.InstanceManager(
                node_types={"worker": {"resources": {"CPU": 1, "pool": 1},
                                       "max_workers": 2, "node_config": {}}},
                provider=mod.NodeProviderInstanceAdapter(
                    prov, daemon_lookup=registered.get),
                max_workers=2, idle_timeout_s=0.5)
            try:
                def probe():
                    return 1

                ref = pkg.remote(resources={"pool": 1})(probe).remote()
                deadline = time.monotonic() + TIMEOUT
                while not fake.pods:
                    assert time.monotonic() < deadline, "no pod created"
                    mgr.reconcile()
                    time.sleep(0.1)
                name = next(iter(fake.pods))
                fake.set_running(name)
                prov._invalidate_pods()
                registered[name] = "feedbeef" * 4
                while not any(i.status == v2.RAY_RUNNING
                              for i in mgr.instances.values()):
                    assert time.monotonic() < deadline, "never running"
                    mgr.reconcile()
                    time.sleep(0.1)
                pkg.cancel(ref)
                while name in fake.pods:
                    assert time.monotonic() < deadline, list(fake.pods)
                    mgr.reconcile()
                    time.sleep(0.1)
                return True
            finally:
                mgr.shutdown()
                pkg.shutdown()

        assert [case(package) for package in PACKAGES] == [True, True]
