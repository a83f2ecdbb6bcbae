"""Multi-node cluster utility for tests and single-machine clusters.

Reference parity: python/ray/cluster_utils.py:135 `Cluster` — N real
raylet processes sharing one GCS, so distributed scheduling/failover is
testable on one machine (SURVEY.md §4, load-bearing test mechanism (a)).

Two node kinds:
  * virtual (default): entries in the scheduler's NodeRegistry — own
    resource pool, workers are local processes, `remove_node` kills the
    victims' workers so failover paths run without extra processes.
  * daemon (``add_node(daemon=True)`` or RTT_CLUSTER_DAEMONS=1):
    a REAL per-host daemon subprocess (_private/daemon.py) joining the
    head over TCP — own worker pool, own shm object store, cross-node
    object transfer; killing it exercises true node-failure handling
    (the reference's N-real-raylets pattern). The daemon runs in a
    process group of its own, so `remove_node` and `shutdown` reap it
    and every worker it started.

A daemon node declares the GPUs it is given (``num_gpus``, default 0),
never the ones it could detect: on a one-card host the head is started
with ``init(num_gpus=0)`` and the card is given to one daemon node.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

from . import api
from ._private import state


def daemon_command(rt, num_cpus: float, num_gpus: float,
                   resources: Optional[Dict[str, float]] = None,
                   labels: Optional[Dict[str, str]] = None
                   ) -> Tuple[List[str], Dict[str, str]]:
    """argv and environment of a node daemon joining the head of ``rt``
    on this machine, with ``num_gpus`` GPUs declared explicitly."""
    host, port = rt.head_server.address
    env = dict(os.environ)
    env["RTT_CLUSTER_TOKEN_HEX"] = rt.cluster_token.hex()
    # Direct-call plane coherence across nodes: the daemon's workers
    # read these from THEIR environment, so a programmatic
    # ray_config.set on the driver must override whatever the
    # operator's shell exported or the daemon would diverge (workers
    # marking results forward-pending that the head never forwards).
    from ._private.config import ray_config as _rc
    env["RTT_DIRECT_CALLS_ENABLED"] = \
        "1" if _rc.direct_calls_enabled else "0"
    env["RTT_DIRECT_RESULT_FORWARDING"] = \
        "1" if _rc.direct_result_forwarding else "0"
    env["RTT_DIRECT_REDIAL_BACKOFF_S"] = \
        str(_rc.direct_redial_backoff_s)
    env["RTT_DIRECT_REDIAL_MAX_ATTEMPTS"] = \
        str(int(_rc.direct_redial_max_attempts))
    env["RTT_DIRECT_SEQ_REORDER_CAP"] = \
        str(int(_rc.direct_seq_reorder_cap))
    env["RTT_DIRECT_SEQ_HOLD_TIMEOUT_S"] = \
        str(_rc.direct_seq_hold_timeout_s)
    # Shuffle-exchange knobs follow the same coherence rule: the
    # per-link pull gate and merge budget run in THIS daemon's
    # workers, so the driver's programmatic value must reach them.
    env["RTT_SHUFFLE_PARTITIONS"] = \
        str(int(_rc.shuffle_partitions))
    env["RTT_SHUFFLE_LINK_INFLIGHT"] = \
        str(int(_rc.shuffle_link_inflight))
    env["RTT_SHUFFLE_MERGE_BUDGET"] = \
        str(int(_rc.shuffle_merge_budget))
    argv = [sys.executable, "-m", "ray_tpu_torch._private.daemon",
            "--address", f"{host}:{port}",
            "--num-cpus", str(num_cpus), "--num-gpus", str(num_gpus)]
    if resources:
        argv += ["--resources", json.dumps(resources)]
    if labels:
        argv += ["--labels", json.dumps(labels)]
    return argv, env


def start_daemon(argv: List[str], env: Dict[str, str]) -> subprocess.Popen:
    """Start a daemon in a process group of its own (its workers join
    it), so that stop_daemon can reap them all."""
    return subprocess.Popen(argv, env=env, start_new_session=True)


def stop_daemon(proc: subprocess.Popen, head_handle=None,
                timeout: float = 5.0) -> None:
    """Stop a daemon started by start_daemon and every process of its
    group: SHUTDOWN_NODE over the head link when ``head_handle`` is
    given, then SIGTERM (the daemon's own shutdown removes its session
    and store directories), then SIGKILL of the whole group. A daemon
    that was killed before it could clean up leaves directories whose
    owner is dead: the head's stale-session sweep removes them here."""
    if head_handle is not None and proc.poll() is None:
        from ._private import protocol as P
        try:
            head_handle.send(P.SHUTDOWN_NODE, {})
            proc.wait(timeout=timeout)
        except Exception:  # lint: broad-except-ok the link may be gone already; SIGTERM below owns the stop
            pass
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=2 * timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=timeout)
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass  # no process of the group is left
    from ._private.runtime import _gc_stale_sessions
    _gc_stale_sessions()


class Node:
    """Handle to one cluster node."""

    def __init__(self, node_id_hex: str, is_head: bool = False,
                 proc: Optional[subprocess.Popen] = None):
        self.node_id = node_id_hex
        self.is_head = is_head
        self.proc = proc  # daemon subprocess (None for virtual/head)

    @property
    def is_daemon(self) -> bool:
        return self.proc is not None

    def __repr__(self):
        kind = ("head" if self.is_head
                else "daemon" if self.is_daemon else "worker")
        return f"ClusterNode({self.node_id[:8]}, {kind})"


class Cluster:
    """(reference: cluster_utils.Cluster)

    >>> cluster = Cluster(initialize_head=True,
    ...                   head_node_args={"num_cpus": 2, "num_gpus": 0})
    >>> node = cluster.add_node(num_cpus=4, num_gpus=1, daemon=True)
    >>> ... schedule work ...
    >>> cluster.remove_node(node)   # workers die; tasks fail over
    >>> cluster.shutdown()
    """

    def __init__(self, initialize_head: bool = False,
                 head_node_args: Optional[Dict] = None):
        self._nodes: List[Node] = []
        self._owns_runtime = False
        if initialize_head:
            api.init(**(head_node_args or {}), ignore_reinit_error=True)
            self._owns_runtime = True
        rt = state.current()
        self.head_node = Node(rt.node_id.hex(), is_head=True)
        self._nodes.append(self.head_node)

    def add_node(self, *, num_cpus: float = 1, num_gpus: float = 0,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 daemon: Optional[bool] = None, wait: bool = True,
                 **kwargs) -> Node:
        api._reject_num_tpus(kwargs)
        rt = state.current()
        if daemon is None:
            daemon = os.environ.get("RTT_CLUSTER_DAEMONS") == "1"
        if daemon:
            node = self._spawn_daemon(rt, num_cpus, num_gpus,
                                      resources, labels)
        else:
            res = {"CPU": float(num_cpus)}
            if num_gpus:
                res["GPU"] = float(num_gpus)
            res.update(resources or {})
            node = Node(rt.add_virtual_node(res, labels=labels))
        self._nodes.append(node)
        return node

    def _spawn_daemon(self, rt, num_cpus, num_gpus, resources,
                      labels) -> Node:
        argv, env = daemon_command(rt, num_cpus, num_gpus, resources,
                                   labels)
        before = set(rt.head_server.daemons)
        proc = start_daemon(argv, env)
        deadline = time.monotonic() + 60.0
        node_id = None
        while time.monotonic() < deadline:
            new = set(rt.head_server.daemons) - before
            if new:
                node_id = new.pop()
                break
            if proc.poll() is not None:
                stop_daemon(proc)
                raise RuntimeError(
                    f"node daemon exited with code {proc.returncode} "
                    f"before registering")
            time.sleep(0.05)
        if node_id is None:
            stop_daemon(proc)
            raise RuntimeError("node daemon failed to register in 60s")
        return Node(node_id, proc=proc)

    def remove_node(self, node: Node, allow_graceful: bool = True) -> bool:
        if node.is_head:
            raise ValueError("cannot remove the head node")
        rt = state.current()
        if node.is_daemon:
            # Stop the daemon and its process group; the head notices
            # the connection drop and runs node-failure handling (worker
            # death, object loss, actor restart) — the RayletKiller
            # chaos semantics.
            handle = (rt.head_server.daemons.get(node.node_id)
                      if allow_graceful else None)
            stop_daemon(node.proc, handle)
            # Wait for the head to process the disconnect.
            deadline = time.monotonic() + 10.0
            while (node.node_id in rt.head_server.daemons
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            ok = True
        else:
            ok = rt.remove_virtual_node(node.node_id)
        if ok:
            self._nodes.remove(node)
        return ok

    @property
    def list_all_nodes(self) -> List[Node]:
        return list(self._nodes)

    def shutdown(self):
        for node in [n for n in self._nodes if not n.is_head]:
            try:
                self.remove_node(node)
            except Exception:  # lint: broad-except-ok the runtime may be torn down already; every daemon is still reaped below
                if node.is_daemon:
                    stop_daemon(node.proc)
        if self._owns_runtime:
            api.shutdown()
