"""The port's multi-host plane (``_private/daemon.py``, ``cluster_utils``)
on the CPU, held against ray_tpu's.

Every case of ``tests/test_daemon.py`` runs twice, on a ray_tpu cluster
of real daemon nodes and on the port's, built alike (a head of 2 CPUs,
daemon A with resource ``A``, daemon B with ``B``), with both clusters
alive in this process: values, the node each piece of work ran on (by
its position in ``add_node`` order), task attempts and actor restarts
must be equal. Then what only the port has: daemon nodes with faked
GPUs (``num_gpus=1`` each, no card needed) pin their workers through
``CUDA_VISIBLE_DEVICES``, and ``remove_node``/``shutdown`` reap a daemon,
its workers and its directories. Every wait has its own deadline, and
every cluster is shut down in a ``finally`` or a fixture's teardown.
"""

import importlib
import os
import signal
import sys
import tempfile
import time

import numpy as np
import pytest

from ray_tpu_torch._private.test_utils import (group_members, owned_dirs,
                                               proc_stat)

PACKAGES = ("ray_tpu", "ray_tpu_torch")
TIMEOUT = 60


# The module's shared clusters (fixture ``clusters``) while they are up.
_SHARED = {}


def _close_shared():
    """Shut the shared clusters down. ``Cluster(initialize_head=True)``
    joins a head already up in this process (``init`` with
    ``ignore_reinit_error``) and its ``shutdown`` stops that head: a case
    that builds clusters of its own would otherwise run on the shared
    head, beside its daemons A and B, and leave them orphaned."""
    while _SHARED:
        _SHARED.popitem()[1].shutdown()


class Side:
    """One package's cluster: its API module, its Cluster and the nodes
    in add_node order (the head first). A cluster of its own (not
    ``shared``) starts after the shared clusters are shut down."""

    def __init__(self, package, head_args, nodes, shared=False):
        if not shared:
            _close_shared()
        self.package = package
        self.ray = importlib.import_module(package)
        self.state = importlib.import_module(package + "._private.state")
        self.state_api = importlib.import_module(package + ".util.state")
        cluster_utils = importlib.import_module(package + ".cluster_utils")
        self.cluster = cluster_utils.Cluster(initialize_head=True,
                                             head_node_args=head_args)
        self.nodes = [self.cluster.head_node]
        try:
            for kwargs in nodes:
                self.nodes.append(self.cluster.add_node(**kwargs))
        except BaseException:
            self.shutdown()
            raise

    def add_node(self, **kwargs):
        node = self.cluster.add_node(**kwargs)
        self.nodes.append(node)
        return node

    def where(self, node_id) -> int:
        """The node's position in add_node order (0: the head; a worker
        of a virtual node reports the head's id, in both packages)."""
        return [n.node_id for n in self.nodes].index(node_id)

    def get(self, refs):
        return self.ray.get(refs, timeout=TIMEOUT)

    def shutdown(self):
        self.cluster.shutdown()


def _head_args(package):
    args = {"num_cpus": 2}
    if package == "ray_tpu_torch":
        args["num_gpus"] = 0
    return args


def _both(make):
    """``make(package)`` on each package in turn: {package: result}."""
    return {pkg: make(pkg) for pkg in PACKAGES}


def assert_same(results):
    ours, theirs = results["ray_tpu_torch"], results["ray_tpu"]
    assert ours == theirs
    return ours


@pytest.fixture(scope="module")
def clusters():
    try:
        for pkg in PACKAGES:
            _SHARED[pkg] = Side(pkg, _head_args(pkg), [
                {"num_cpus": 2, "resources": {"A": 4}, "daemon": True},
                {"num_cpus": 2, "resources": {"B": 4}, "daemon": True}],
                shared=True)
        yield dict(_SHARED)
    finally:
        _close_shared()


def run_case(clusters, case):
    """``case(side)`` on both packages' clusters; the results must be
    equal. Returns the port's."""
    return assert_same({pkg: case(side) for pkg, side in clusters.items()})


def test_remote_dispatch(clusters):
    def case(side):
        ray = side.ray

        @ray.remote(resources={"A": 1})
        def pid():
            return os.getpid(), ray.get_runtime_context().get_node_id()

        out = side.get([pid.remote() for _ in range(4)])
        return [(p != os.getpid(), side.where(n)) for p, n in out]

    assert run_case(clusters, case) == [(True, 1)] * 4


def test_driver_put_consumed_on_daemon(clusters):
    def case(side):
        ray = side.ray
        data = ray.put(np.ones(200_000))

        @ray.remote(resources={"A": 1})
        def consume(a):
            return float(a.sum()), ray.get_runtime_context().get_node_id()

        total, node = side.get(consume.remote(data))
        return total, side.where(node)

    assert run_case(clusters, case) == (200_000.0, 1)


def test_daemon_to_daemon_transfer(clusters):
    def case(side):
        ray = side.ray

        @ray.remote(resources={"A": 1})
        def produce():
            return np.arange(300_000, dtype=np.float32)

        @ray.remote(resources={"B": 1})
        def total(a):
            return float(a.sum()), ray.get_runtime_context().get_node_id()

        value, node = side.get(total.remote(produce.remote()))
        return value, side.where(node)

    want = float(np.arange(300_000, dtype=np.float32).sum())
    assert run_case(clusters, case) == (want, 2)


def test_daemon_result_pulled_to_driver(clusters):
    def case(side):
        ray = side.ray

        @ray.remote(resources={"B": 1})
        def produce():
            return np.full(250_000, 3.0)

        arr = side.get(produce.remote())
        return arr.shape, float(arr[0]), str(arr.dtype)

    assert run_case(clusters, case) == ((250_000,), 3.0, "float64")


def test_actor_on_daemon(clusters):
    def case(side):
        ray = side.ray

        @ray.remote(resources={"A": 1})
        class Counter:
            def __init__(self):
                self.n = 0

            def inc(self):
                self.n += 1
                return self.n, ray.get_runtime_context().get_node_id()

        c = Counter.remote()
        out = side.get([c.inc.remote() for _ in range(3)])
        ray.kill(c)
        return [(n, side.where(node)) for n, node in out]

    assert run_case(clusters, case) == [(1, 1), (2, 1), (3, 1)]


def test_nested_submission_from_daemon(clusters):
    def case(side):
        ray = side.ray

        @ray.remote(resources={"B": 1})
        def outer():
            @ray.remote
            def inner():
                return "inner-ok"

            return (ray.get(inner.remote()),
                    ray.get_runtime_context().get_node_id())

        value, node = side.get(outer.remote())
        return value, side.where(node)

    assert run_case(clusters, case) == ("inner-ok", 2)


def test_streaming_generator_on_daemon(clusters):
    def case(side):
        ray = side.ray

        @ray.remote(resources={"A": 1}, num_returns="streaming")
        def gen(n):
            for i in range(n):
                yield i * i

        return [side.get(r) for r in gen.remote(4)]

    assert run_case(clusters, case) == [0, 1, 4, 9]


def test_cluster_resources_include_daemon(clusters):
    def case(side):
        totals = side.ray.cluster_resources()
        return {k: totals.get(k) for k in ("CPU", "A", "B", "GPU", "TPU")}

    assert run_case(clusters, case) == {"CPU": 6.0, "A": 4.0, "B": 4.0,
                                        "GPU": None, "TPU": None}


def test_node_sync_gossip_reaches_daemons(clusters):
    """A worker on a daemon node reads the gossiped cluster view from its
    daemon (op local_node_view), without a head round trip."""
    def case(side):
        ray, package = side.ray, side.package

        @ray.remote(resources={"A": 1})
        def view_from_daemon():
            import importlib
            import time

            state = importlib.import_module(package + "._private.state")
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                out = state.current().gcs_request("local_node_view")
                if out.get("view") and len(out["view"]) >= 3:
                    return out
                time.sleep(0.5)  # the next heartbeat carries the sync
            return out

        out = side.get(view_from_daemon.remote())
        totals = sorted(sorted(k for k in n.get("resources_total", {})
                               if k in ("A", "B"))
                        for n in out["view"])
        head_view = side.state.current().gcs_request("local_node_view")
        return (side.where(out["node_id"]), out["ts"] is not None,
                len(out["view"]), totals, len(head_view["view"]))

    assert run_case(clusters, case) == (1, True, 3, [[], ["A"], ["B"]], 3)


def test_usage_record(clusters):
    """The usage report of each package on its cluster: the same fields
    and cluster view; the port's names its own libraries and, opted in,
    lands in the port's session directory and nowhere else."""
    importlib.import_module("ray_tpu_torch.data")

    def case(side):
        usage = importlib.import_module(side.package + "._private.usage")
        config = importlib.import_module(side.package + "._private.config")
        saved = config.ray_config.usage_stats_enabled
        config.ray_config.set("usage_stats_enabled", True)
        try:
            record = usage.record_usage()
        finally:
            config.ray_config.set("usage_stats_enabled", saved)
        session_dir = side.state.current().session_dir
        path = os.path.join(session_dir, "usage_report.json")
        return record, path if os.path.exists(path) else None

    (ours, path), (theirs, ref_path) = (
        case(clusters[pkg]) for pkg in ("ray_tpu_torch", "ray_tpu"))
    assert sorted(ours) == sorted(theirs)
    assert (ours["source"], theirs["source"]) == ("ray_tpu_torch", "ray_tpu")
    for key in ("cluster_size", "schema_version", "version"):
        assert ours[key] == theirs[key], key
    assert {k: ours["total_resources"].get(k) for k in ("CPU", "A", "B")} \
        == {k: theirs["total_resources"].get(k) for k in ("CPU", "A", "B")}
    from ray_tpu_torch._private.config import temp_root
    assert path is not None and ref_path is not None
    assert path.startswith(os.path.join(temp_root(), "rtt_sessions") + os.sep)
    # the libraries this process imported of the port, not of ray_tpu
    assert "data" in ours["libraries"]
    assert all(f"ray_tpu_torch.{lib}" in sys.modules
               for lib in ours["libraries"])


def test_worker_killer_and_wait_for_condition(clusters):
    """The chaos helpers on each package's cluster: busy workers killed
    mid-task, the tasks retried to the same results."""
    def case(side):
        helpers = importlib.import_module(side.package +
                                          "._private.test_utils")
        ray = side.ray

        @ray.remote(max_retries=3)
        def slow(i):
            import time
            time.sleep(0.4)
            return i * 2

        refs = [slow.remote(i) for i in range(12)]
        killer = helpers.WorkerKiller(kill_interval_s=0.3, max_kills=2,
                                      warmup_s=0.2).run()
        try:
            helpers.wait_for_condition(lambda: len(killer.killed) >= 1,
                                       timeout=TIMEOUT)
            out = side.get(refs)
        finally:
            killed = killer.stop()
        return out, len(killed) >= 1

    assert run_case(clusters, case) == ([i * 2 for i in range(12)], True)


# -- destructive cases: each package gets clusters of its own ----------

class _Marker:
    """A file a task touches once it runs, so the test kills its daemon
    only after the task is running there."""

    def __init__(self):
        fd, self.path = tempfile.mkstemp(prefix="rtt_mn_")
        os.close(fd)
        os.unlink(self.path)

    def wait(self):
        deadline = time.monotonic() + TIMEOUT
        while not os.path.exists(self.path):
            assert time.monotonic() < deadline, "the task never started"
            time.sleep(0.02)

    def clean(self):
        if os.path.exists(self.path):
            os.unlink(self.path)


def _victim_side(package):
    """A cluster whose only ``R`` node is a daemon (the victim)."""
    return Side(package, _head_args(package), [
        {"num_cpus": 2, "resources": {"R": 2}, "daemon": True}])


def test_daemon_kill_task_retry():
    """Killing a node daemon fails its running task through the worker
    death path; the retry lands on a node added afterwards."""
    def case(package):
        side, marker = _victim_side(package), _Marker()
        try:
            ray, path = side.ray, marker.path

            @ray.remote(resources={"R": 1}, max_retries=2)
            def slow():
                import time
                node = ray.get_runtime_context().get_node_id()
                if not os.path.exists(path):
                    open(path, "w").close()
                    time.sleep(5)
                return node

            ref = slow.remote()
            marker.wait()
            side.add_node(num_cpus=2, resources={"R": 2})
            side.nodes[1].proc.kill()
            node = side.get(ref)
            deadline = time.monotonic() + TIMEOUT
            while True:
                rows = [r for r in side.state_api.list_tasks()
                        if r["name"] == "slow"]
                if rows and rows[0]["state"] == "FINISHED":
                    break
                assert time.monotonic() < deadline, rows
                time.sleep(0.05)
            return side.where(node), rows[0]["attempt"]
        finally:
            marker.clean()
            side.shutdown()

    where, attempt = assert_same(_both(case))
    assert where == 0 and attempt >= 1


def test_daemon_kill_actor_restart():
    def case(package):
        side = _victim_side(package)
        try:
            ray = side.ray

            @ray.remote(resources={"R": 1}, max_restarts=1,
                        max_task_retries=1)
            class Sticky:
                def where(self):
                    return (os.getpid(),
                            ray.get_runtime_context().get_node_id())

            a = Sticky.remote()
            first, first_node = side.get(a.where.remote())
            side.add_node(num_cpus=2, resources={"R": 2})
            side.nodes[1].proc.kill()
            second, second_node = side.get(a.where.remote())
            restarts = [r["restarts_used"]
                        for r in side.state_api.list_actors()]
            return (second != first, side.where(first_node),
                    side.where(second_node), restarts)
        finally:
            side.shutdown()

    assert assert_same(_both(case)) == (True, 1, 0, [1])


def wait_lost(side, node_id: str, object_hex: str) -> None:
    """Until the head has handled the killed node's death: the node
    reported dead and the object whose only copy it held lost. A get
    issued before that races the death handling: it pulls from the dying
    node, and the death then re-points the object at a head copy whose
    bytes never arrived."""
    deadline = time.monotonic() + TIMEOUT
    while True:
        alive = {r["node_id"]: r["alive"] for r in side.state_api.list_nodes()}
        state = {r["object_id"]: r["state"]
                 for r in side.state_api.list_objects()}
        if not alive.get(node_id, False) and state.get(object_hex) == "lost":
            return
        assert time.monotonic() < deadline, (alive, state.get(object_hex))
        time.sleep(0.05)


def test_object_recovery_after_node_loss():
    """An object whose only copy lived on a dead node is rebuilt from its
    lineage on the next get, on the node that is left."""
    def case(package):
        side = _victim_side(package)
        try:
            ray = side.ray

            @ray.remote(resources={"R": 1}, max_retries=2)
            def produce():
                return (np.full(200_000, 9.0),
                        ray.get_runtime_context().get_node_id())

            ref = produce.remote()
            ray.wait([ref], timeout=TIMEOUT)
            side.add_node(num_cpus=2, resources={"R": 2})
            side.nodes[1].proc.kill()
            wait_lost(side, side.nodes[1].node_id, ref.id.hex())
            arr, node = side.get(ref)
            return arr.shape, float(arr[0]), side.where(node)
        finally:
            side.shutdown()

    assert assert_same(_both(case)) == ((200_000,), 9.0, 0)


def test_get_during_node_death_rebuilds_the_object():
    """The port only: a get issued at once after the kill, while the head
    is still handling the node's death, waits for that handling and
    rebuilds the object from its lineage. ``ray_tpu``'s get raises
    ObjectLostError there: its pull from the dead node fails, and the
    error reaches the caller (ROADMAP Queue 3)."""
    side = _victim_side("ray_tpu_torch")
    try:
        ray = side.ray

        @ray.remote(resources={"R": 1}, max_retries=2)
        def produce():
            return (np.full(200_000, 9.0),
                    ray.get_runtime_context().get_node_id())

        ref = produce.remote()
        ray.wait([ref], timeout=TIMEOUT)
        side.add_node(num_cpus=2, resources={"R": 2})
        side.nodes[1].proc.kill()
        arr, node = side.get(ref)
        assert (arr.shape, float(arr[0]), side.where(node)) == (
            (200_000,), 9.0, 0)
    finally:
        side.shutdown()


# -- the port only: GPUs on daemon nodes, and reaping -------------------

def _pid_alive(pid: int) -> bool:
    """Running, not a zombie that nobody has reaped yet."""
    fields = proc_stat(pid)
    return bool(fields) and fields[0] != "Z"


@pytest.fixture
def gpu_side(monkeypatch):
    """The port's head with no GPU, two daemon nodes of one faked GPU
    each and one of none, under a detected count of 4 that the explicit
    num_gpus (0 by default) must override."""
    monkeypatch.setenv("RTT_NUM_GPUS", "4")
    side = Side("ray_tpu_torch", {"num_cpus": 2, "num_gpus": 0}, [
        {"num_cpus": 2, "num_gpus": 1, "resources": {"X": 2},
         "daemon": True},
        {"num_cpus": 2, "num_gpus": 1, "resources": {"Y": 2},
         "daemon": True},
        {"num_cpus": 1, "resources": {"Z": 1}, "daemon": True}])
    try:
        yield side
    finally:
        side.shutdown()


class TestGPUsOnDaemonNodes:
    def test_resources_and_nodes(self, gpu_side):
        rt = gpu_side.ray
        assert rt.cluster_resources().get("GPU") == 2.0
        by_node = {row["node_id"]: row["resources_total"].get("GPU", 0.0)
                   for row in gpu_side.state_api.list_nodes()}
        assert [by_node[n.node_id] for n in gpu_side.nodes] == [
            0.0, 1.0, 1.0, 0.0]

    def test_two_gpu_tasks_at_once_on_two_nodes(self, gpu_side, tmp_path):
        rt = gpu_side.ray
        started = str(tmp_path)

        @rt.remote(num_gpus=1)
        def pinned(i):
            import time
            open(os.path.join(started, str(i)), "w").close()
            deadline = time.monotonic() + 30
            while len(os.listdir(started)) < 2:  # both must run at once
                if time.monotonic() > deadline:
                    return None
                time.sleep(0.02)
            return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                    rt.get_runtime_context().get_node_id(),
                    rt.get_runtime_context().get_accelerator_ids())

        out = gpu_side.get([pinned.remote(i) for i in range(2)])
        assert None not in out, out
        assert [(v, ids) for v, _, ids in out] == [("0", {"GPU": ["0"]})] * 2
        assert sorted(gpu_side.where(n) for _, n, _ in out) == [1, 2]

    def test_zero_gpu_task_on_a_gpu_node_sees_no_card(self, gpu_side):
        rt = gpu_side.ray

        @rt.remote(resources={"X": 1})
        def plain():
            return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                    rt.get_runtime_context().get_node_id())

        visible, node = gpu_side.get(plain.remote())
        assert (visible, gpu_side.where(node)) == ("", 1)

    def test_gpu_returns_to_the_node_when_its_worker_dies(self, gpu_side):
        rt = gpu_side.ray

        @rt.remote(num_gpus=1, resources={"X": 1})
        class Holder:
            def where(self):
                return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                        rt.get_runtime_context().get_node_id())

        for _ in range(2):  # the second needs the id the first held
            holder = Holder.remote()
            visible, node = gpu_side.get(holder.where.remote())
            assert (visible, gpu_side.where(node)) == ("0", 1)
            rt.kill(holder)

    def test_num_tpus_raises(self, gpu_side):
        with pytest.raises(ValueError, match="num_gpus"):
            gpu_side.cluster.add_node(num_tpus=1, daemon=True)


class TestReaping:
    def _start(self):
        """A port cluster with one daemon node, whose worker ran a task
        that left a child process behind (a task may start processes of
        its own; they join the daemon's process group)."""
        side = Side("ray_tpu_torch", {"num_cpus": 1, "num_gpus": 0}, [
            {"num_cpus": 2, "resources": {"D": 2}, "daemon": True}])
        rt = side.ray

        @rt.remote(resources={"D": 1})
        def pids():
            import subprocess
            child = subprocess.Popen(["sleep", "120"])
            return os.getpid(), child.pid

        try:
            worker, child = side.get(pids.remote())
        except BaseException:
            side.shutdown()
            raise
        return side, side.nodes[1].proc, worker, child

    @pytest.mark.parametrize("killed", [False, True])
    def test_remove_node_reaps_daemon_workers_and_dirs(self, killed):
        """Graceful or after a SIGKILL of the daemon alone: no process of
        its group and no directory it stamped is left."""
        side, proc, worker, child = self._start()
        try:
            assert proc.pid != os.getpid() and os.getpgid(proc.pid) == \
                proc.pid
            assert os.getpgid(worker) == os.getpgid(child) == proc.pid
            assert len(owned_dirs(proc.pid)) == 2
            if killed:
                proc.send_signal(signal.SIGKILL)
                proc.wait(timeout=TIMEOUT)
            side.cluster.remove_node(side.nodes[1])
            assert not group_members(proc.pid)
            assert not _pid_alive(worker) and not _pid_alive(child)
            assert owned_dirs(proc.pid) == []
        finally:
            side.shutdown()

    def test_shutdown_reaps_every_daemon(self):
        side, proc, worker, child = self._start()
        side.shutdown()
        assert not group_members(proc.pid)
        assert not _pid_alive(worker) and not _pid_alive(child)
        assert owned_dirs(proc.pid) == []
