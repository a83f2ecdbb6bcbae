"""Autoscaler v2: GCS-driven instance manager over REAL node daemons.

Reference parity: python/ray/autoscaler/v2/ — the v2 redesign where the
autoscaler is a reconciler around an InstanceManager with an explicit
per-instance lifecycle (instance_manager/), reading resource demand
straight from the GCS (autoscaler.proto) instead of scraping logs, and
where "a node" is a first-class instance record moving through

    QUEUED -> REQUESTED -> ALLOCATED -> RAY_RUNNING -> RAY_STOPPING
                                                        -> TERMINATED

Here an instance IS a per-host node daemon (_private/daemon.py):
scale-up launches a real daemon process that registers with the head
over TCP and adds schedulable capacity; scale-down drains and stops it.
`DaemonInstanceProvider` runs daemons as local subprocesses (the
fake-multinode pattern with REAL raylet-equivalents — SURVEY §4
mechanism (a)), each in a process group of its own that termination
reaps, declaring the node type's GPUs with ``--num-gpus``; cloud
deployments swap the provider to launch VMs whose startup command runs
``python -m ray_tpu_torch._private.daemon --address ...`` with the
token in RTT_CLUSTER_TOKEN_HEX.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .config import ClusterConfig, NodeTypeConfig
from .resource_demand_scheduler import get_nodes_to_launch

# Instance lifecycle (reference: autoscaler/v2/instance_manager/
# instance_storage.py statuses; trimmed to the states a daemon-backed
# instance actually passes through).
_grace_lock = threading.Lock()
_grace_holders = 0
_grace_saved = None


def _grace_acquire():
    """Park infeasible demand while ANY autoscaler is live (refcounted;
    restored when the last one releases — a constructor side effect
    would leak the override on abandoned managers)."""
    global _grace_holders, _grace_saved
    from .._private.config import ray_config
    with _grace_lock:
        if _grace_holders == 0:
            _grace_saved = float(ray_config.infeasible_task_grace_s)
            ray_config.set("infeasible_task_grace_s", 3600.0)
        _grace_holders += 1


def _grace_release():
    global _grace_holders, _grace_saved
    from .._private.config import ray_config
    with _grace_lock:
        if _grace_holders == 0:
            return
        _grace_holders -= 1
        if _grace_holders == 0 and _grace_saved is not None:
            ray_config.set("infeasible_task_grace_s", _grace_saved)


QUEUED = "QUEUED"
REQUESTED = "REQUESTED"
ALLOCATED = "ALLOCATED"
RAY_RUNNING = "RAY_RUNNING"
RAY_STOPPING = "RAY_STOPPING"
TERMINATED = "TERMINATED"


@dataclass
class Instance:
    instance_id: str
    instance_type: str
    status: str = QUEUED
    node_id_hex: Optional[str] = None
    created_at: float = field(default_factory=time.time)
    updated_at: float = field(default_factory=time.time)
    idle_since: Optional[float] = None  # first idle-past-timeout sighting
    handle: Optional[object] = None  # provider-private

    def transition(self, status: str):
        self.status = status
        self.updated_at = time.time()


class InstanceProvider:
    """Allocates/terminates the machines behind instances (reference:
    v2 instance_manager/cloud_providers/)."""

    def allocate(self, instance: Instance, node_type_config: Dict) -> None:
        """Start the machine; fill instance.handle. Must be async-fast."""
        raise NotImplementedError

    def running_node_id(self, instance: Instance) -> Optional[str]:
        """Node id once the daemon registered with the head, else None."""
        raise NotImplementedError

    def terminate(self, instance: Instance) -> None:
        raise NotImplementedError


class DaemonInstanceProvider(InstanceProvider):
    """Instances are real daemon subprocesses on this machine."""

    def __init__(self):
        from .._private import state
        self._rt = state.current()

    def allocate(self, instance: Instance, node_type_config: Dict) -> None:
        from ..cluster_utils import daemon_command, start_daemon
        resources = dict(node_type_config.get("resources", {}))
        num_cpus = resources.pop("CPU", 1)
        num_gpus = resources.pop("GPU", 0)
        # Tag the node with its instance id so registration is matchable.
        resources[f"_instance:{instance.instance_id}"] = 1.0
        argv, env = daemon_command(self._rt, num_cpus, num_gpus, resources)
        instance.handle = {"proc": start_daemon(argv, env)}

    def running_node_id(self, instance: Instance) -> Optional[str]:
        tag = f"_instance:{instance.instance_id}"
        for node_hex, handle in self._rt.head_server.daemons.items():
            if tag in (handle.resources or {}):
                return node_hex
        proc = (instance.handle or {}).get("proc")
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(
                f"daemon instance exited with {proc.returncode} before "
                f"registering")
        return None

    def terminate(self, instance: Instance) -> None:
        from ..cluster_utils import stop_daemon
        proc = (instance.handle or {}).get("proc")
        if proc is None:
            return
        stop_daemon(proc, self._rt.head_server.daemons.get(
            instance.node_id_hex or ""))


class InstanceManager:
    """The v2 reconciler: demand (from the GCS view) -> target instance
    set -> per-instance state machine (reference: v2/autoscaler.py +
    instance_manager/instance_manager.py)."""

    def __init__(self, node_types: Dict[str, Dict],
                 provider: Optional[InstanceProvider] = None,
                 max_workers: int = 8,
                 idle_timeout_s: float = 60.0):
        from .._private import state
        self._rt = state.current()
        self.node_types = node_types
        self._config = ClusterConfig(
            node_types={
                name: NodeTypeConfig(
                    name=name, resources=dict(nt.get("resources", {})),
                    min_workers=int(nt.get("min_workers", 0)),
                    max_workers=int(nt.get("max_workers", max_workers)))
                for name, nt in node_types.items()},
            max_workers=max_workers, idle_timeout_s=idle_timeout_s)
        self.provider = provider or DaemonInstanceProvider()
        self.max_workers = max_workers
        self.idle_timeout_s = idle_timeout_s
        self.instances: Dict[str, Instance] = {}
        self._lock = threading.Lock()
        # Shared cell, NOT self, so the finalizer holds no strong ref to
        # the manager (it would never be collected otherwise). Abandoned
        # managers (no shutdown()) still release the grace override.
        # Acquired at construction: demand submitted before the first
        # reconcile must already park instead of failing fast.
        self._grace_cell = [True]
        _grace_acquire()
        import weakref
        self._finalizer = weakref.finalize(self, _maybe_release,
                                           self._grace_cell)

    # -- demand view (reference: GCS autoscaler state, autoscaler.proto) --
    def _cluster_demand(self):
        try:
            view = self._rt.gcs_request("resource_demands")
        except Exception:
            return [], []
        demands = list(view.get("demands", []))
        bundles = []
        for pg in view.get("placement_groups", []):
            bundles.extend(pg.get("bundles", []))
        return demands, bundles

    def _live_instances(self) -> List[Instance]:
        return [i for i in self.instances.values()
                if i.status != TERMINATED]

    def _counts_by_type(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for inst in self._live_instances():
            counts[inst.instance_type] = counts.get(
                inst.instance_type, 0) + 1
        return counts

    ALLOCATE_TIMEOUT_S = 180.0

    # -- one reconcile pass -------------------------------------------
    def reconcile(self) -> Dict[str, int]:
        """One update: launch for unmet demand (and min_workers floors),
        progress lifecycles, terminate idle. Provider calls (process
        spawn/terminate, potentially seconds each) run OUTSIDE the lock
        so launch decisions never serialize behind slow drains."""
        with self._lock:
            self._pending_dead_terminations: List[Instance] = []
            self._progress_lifecycles()
            dead = self._pending_dead_terminations
            demands, bundles = self._cluster_demand()
            # get_nodes_to_launch is called EVERY pass (with possibly
            # empty demand): it is also what maintains min_workers
            # floors after terminations.
            to_launch = get_nodes_to_launch(
                demands, bundles, self._counts_by_type(), self._config)
            for node_type, count in to_launch.items():
                for _ in range(count):
                    self._queue_instance(node_type)
            launches = []
            for inst in self._live_instances():
                if inst.status == QUEUED:
                    inst.transition(REQUESTED)
                    launches.append(inst)
            # Scale-down runs EVERY pass: standing unsatisfiable demand
            # must not pin idle nodes; the busy check protects nodes
            # holding work, min_workers floors are re-launched above.
            drains = self._pick_idle_for_termination()
        for inst in launches:
            try:
                self.provider.allocate(
                    inst, self.node_types[inst.instance_type])
                inst.transition(ALLOCATED)
            except Exception:
                inst.transition(TERMINATED)
        for inst in drains:
            # Graceful first: ask the head to drain the node — stop new
            # placement, let running tasks finish, migrate actors
            # without charging restart budgets, re-home sole object
            # copies, pull serve replicas out of routing (docs/DRAIN.md)
            # — and only then release the machine. A failed or
            # deadline-expired drain falls back to plain termination;
            # the ordinary node-death paths own cleanup from there.
            if inst.node_id_hex:
                try:
                    from .._private.config import ray_config
                    self._rt.gcs_request(
                        "drain_node", node_id=inst.node_id_hex,
                        deadline_s=float(ray_config.drain_deadline_s),
                        wait=True)
                except Exception:  # lint: broad-except-ok drain is best-effort; terminate below regardless
                    pass
            try:
                self.provider.terminate(inst)
            finally:
                inst.transition(TERMINATED)
        for inst in dead:
            # Already TERMINATED state-wise; release the machine.
            try:
                self.provider.terminate(inst)
            except Exception:
                pass
        return self.status_counts()

    def _queue_instance(self, node_type: str):
        inst = Instance(instance_id=uuid.uuid4().hex[:12],
                        instance_type=node_type)
        self.instances[inst.instance_id] = inst

    def _progress_lifecycles(self):
        for inst in self._live_instances():
            if inst.status == ALLOCATED:
                try:
                    node_hex = self.provider.running_node_id(inst)
                except Exception:
                    inst.transition(TERMINATED)
                    continue
                if node_hex is not None:
                    inst.node_id_hex = node_hex
                    inst.transition(RAY_RUNNING)
                elif (time.time() - inst.created_at
                      > self.ALLOCATE_TIMEOUT_S):
                    # Machine up but never registered (bad address,
                    # network): stop counting it toward capacity so a
                    # replacement can launch. The provider call
                    # (process kill + wait, potentially seconds) must
                    # NOT run here — callers hold the lock — so release
                    # the machine via the dead list, exactly like
                    # externally-died daemons below.
                    inst.transition(TERMINATED)
                    self._pending_dead_terminations.append(inst)
            elif inst.status == RAY_RUNNING:
                # Instance whose daemon died externally: reconcile out.
                # The machine itself still needs releasing — for cloud
                # providers (k8s pod, GPU VM) it may still be
                # running/billing — but provider calls are slow, so the
                # caller terminates OUTSIDE the lock (dead_list).
                if inst.node_id_hex not in self._rt.head_server.daemons:
                    inst.transition(TERMINATED)
                    self._pending_dead_terminations.append(inst)

    def _node_busy(self, node_id_hex: str) -> bool:
        entry = self._rt.node_registry.get(node_id_hex)
        if entry is None:
            return False
        totals, avail = entry.rm.snapshot()
        return any(avail.get(k, 0.0) + 1e-9 < v
                   for k, v in totals.items())

    def _pick_idle_for_termination(self) -> List[Instance]:
        """Select idle instances to drain (callers hold the lock; the
        provider calls happen outside it). Never drains below a type's
        min_workers floor."""
        now = time.time()
        running_by_type: Dict[str, int] = {}
        for inst in self._live_instances():
            if inst.status == RAY_RUNNING:
                running_by_type[inst.instance_type] =                     running_by_type.get(inst.instance_type, 0) + 1
        picked: List[Instance] = []
        for inst in self._live_instances():
            if inst.status != RAY_RUNNING:
                continue
            if self._node_busy(inst.node_id_hex):
                inst.updated_at = now
                inst.idle_since = None
                continue
            if now - inst.updated_at < self.idle_timeout_s:
                continue
            # Idle past the timeout: require it to STAY idle for a
            # further grace window before draining, so an oscillating
            # workload whose gaps straddle the timeout doesn't churn
            # nodes (terminate, relaunch seconds later).
            from .._private.config import ray_config
            if inst.idle_since is None:
                inst.idle_since = now
                continue
            if now - inst.idle_since < float(
                    ray_config.scale_down_idle_grace_s):
                continue
            nt = self._config.node_types.get(inst.instance_type)
            floor = nt.min_workers if nt else 0
            if running_by_type.get(inst.instance_type, 0) <= floor:
                continue
            running_by_type[inst.instance_type] -= 1
            inst.transition(RAY_STOPPING)
            picked.append(inst)
        return picked

    def status_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for inst in self.instances.values():
            counts[inst.status] = counts.get(inst.status, 0) + 1
        return counts

    def wait_for_running(self, n: int, timeout: float = 120.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.reconcile()
            running = sum(1 for i in self.instances.values()
                          if i.status == RAY_RUNNING)
            if running >= n:
                return True
            time.sleep(0.2)
        return False

    def shutdown(self):
        if self._grace_cell[0]:
            self._grace_cell[0] = False
            _grace_release()
        victims: List[Instance] = []
        with self._lock:
            for inst in self._live_instances():
                if inst.status in (ALLOCATED, RAY_RUNNING, RAY_STOPPING):
                    victims.append(inst)
                inst.transition(TERMINATED)
        # Provider calls (SHUTDOWN_NODE + process wait, seconds each)
        # run OUTSIDE the lock — same discipline as reconcile().
        for inst in victims:
            try:
                self.provider.terminate(inst)
            except Exception:  # lint: broad-except-ok best-effort machine release at shutdown
                pass


def _maybe_release(cell):
    try:
        if cell[0]:
            cell[0] = False
            _grace_release()
    except Exception:
        pass


class AutoscalerV2:
    """Background reconciler (reference: v2/autoscaler.py driven from the
    monitor process)."""

    def __init__(self, node_types: Dict[str, Dict],
                 provider: Optional[InstanceProvider] = None,
                 max_workers: int = 8, idle_timeout_s: float = 60.0,
                 interval_s: float = 2.0):
        self.manager = InstanceManager(
            node_types, provider=provider, max_workers=max_workers,
            idle_timeout_s=idle_timeout_s)
        self._interval = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autoscaler-v2")
        self._thread.start()
        return self

    def _loop(self):
        import logging
        log = logging.getLogger(__name__)
        while not self._stop.wait(self._interval):
            try:
                self.manager.reconcile()
            except Exception:
                log.exception("autoscaler reconcile failed")

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.manager.shutdown()
