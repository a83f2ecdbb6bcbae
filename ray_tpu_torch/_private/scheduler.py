"""Raylet-equivalent: worker pool, resource accounting, task dispatch.

TPU-native collapse of the reference's per-node scheduling stack —
NodeManager + LocalTaskManager + ClusterTaskManager + WorkerPool
(src/ray/raylet/node_manager.cc, local_task_manager.cc:121,
scheduling/cluster_task_manager.cc:44, worker_pool.cc:447,1355) — into an
in-driver scheduler. The reference's worker *lease* protocol collapses to
direct dispatch: the scheduler owns both the resource view and the worker
pool, so "request lease → grant → push task" becomes "acquire resources →
pop worker → send EXEC_TASK".

Resources are float vectors like the reference's (fixed-point there,
src/ray/common/scheduling/fixed_point.h; python floats suffice here).
GPUs are first-class resources; a worker scheduled onto GPUs gets
``CUDA_VISIBLE_DEVICES`` pinned to specific ids in its environment before
it can import torch, and a worker with none gets it empty, mirroring the
reference's accelerator isolation
(python/ray/_private/accelerators/nvidia_gpu.py).
"""

from __future__ import annotations

import collections
import os
import random
import threading
from typing import Callable, Deque, Dict, List, Optional, Set, Tuple

from . import fault
from . import lockdep
from . import protocol as P
from . import racedebug
from . import telemetry
from .ids import ObjectID, TaskID, WorkerID


class ResourceManager:
    """Cluster resource bookkeeping (reference: ClusterResourceManager /
    LocalResourceManager, src/ray/raylet/scheduling/)."""

    def __init__(self, totals: Dict[str, float]):
        self._lock = lockdep.lock("scheduler.resource_manager")
        self.totals = dict(totals)
        self.available = dict(totals)
        # Formatted (placement-group) resources retired by remove():
        # key -> base resource to which later releases are redirected
        # (wildcard keys), or None to drop (indexed keys, which alias the
        # wildcard amount). Prevents phantom re-creation of removed keys
        # when an in-flight task finishes after the group is removed.
        self._retired: Dict[str, Optional[str]] = {}

    def try_acquire(self, demand: Dict[str, float]) -> bool:
        with self._lock:
            for k, v in demand.items():
                if v > 0 and self.available.get(k, 0.0) + 1e-9 < v:
                    return False
            for k, v in demand.items():
                if v > 0:
                    self.available[k] = self.available.get(k, 0.0) - v
            return True

    def release(self, demand: Dict[str, float]):
        with self._lock:
            for k, v in demand.items():
                if v <= 0:
                    continue
                if k not in self.totals:
                    # Retired placement-group resource: redirect the release
                    # to the base resource (wildcard) or drop it (indexed).
                    k = self._retired.get(k)
                    if k is None:
                        continue
                self.available[k] = min(
                    self.available.get(k, 0.0) + v,
                    self.totals.get(k, float("inf")))

    def feasible(self, demand: Dict[str, float]) -> bool:
        """Could this demand EVER be satisfied? (infeasible-task detection,
        reference: cluster_task_manager.cc infeasible queue)."""
        with self._lock:
            return all(
                v <= self.totals.get(k, 0.0) + 1e-9
                for k, v in demand.items() if v > 0)

    def add_total(self, resources: Dict[str, float]):
        with self._lock:
            for k, v in resources.items():
                self.totals[k] = self.totals.get(k, 0.0) + v
                self.available[k] = self.available.get(k, 0.0) + v

    def retire_group_resources(self, formatted_totals: Dict[str, float],
                               base_of: Dict[str, Optional[str]]):
        """Remove a placement group's formatted capacity (reference:
        PlacementGroupResourceManager::ReturnBundle). The *unused* fraction
        of each wildcard resource returns to its base resource immediately;
        the in-use fraction returns when the holding tasks release (their
        formatted release is redirected through ``_retired``)."""
        with self._lock:
            returned: Dict[str, float] = {}
            for k, v in formatted_totals.items():
                avail = self.available.pop(k, 0.0)
                self.totals.pop(k, None)
                base = base_of.get(k)
                self._retired[k] = base
                if base is not None:
                    returned[base] = returned.get(base, 0.0) + avail
            for k, v in returned.items():
                self.available[k] = min(
                    self.available.get(k, 0.0) + v,
                    self.totals.get(k, float("inf")))

    def snapshot(self) -> Tuple[Dict[str, float], Dict[str, float]]:
        with self._lock:
            return dict(self.totals), dict(self.available)


class NodeEntry:
    __slots__ = ("node_id_hex", "rm", "alive", "draining", "start_time",
                 "is_head", "daemon", "labels", "xfer_inflight")

    def __init__(self, node_id_hex: str, rm: ResourceManager,
                 is_head: bool = False, daemon=None,
                 labels: Optional[Dict[str, str]] = None):
        import time
        self.node_id_hex = node_id_hex
        self.rm = rm
        self.alive = True
        # DRAINING: the node is alive but leaving (planned removal).
        # No NEW placement lands on it; running work finishes or
        # migrates (reference: gcs_node_manager DrainNode — a drained
        # node keeps serving until its lease budget expires).
        self.draining = False
        self.start_time = time.time()
        self.is_head = is_head
        # Real per-host daemon backing this node (node_service.DaemonHandle);
        # None for the head and for virtual test nodes.
        self.daemon = daemon
        # Node labels for NodeLabelSchedulingStrategy (reference:
        # node labels on the NodeInfo table, scheduling/policy/
        # node_label_scheduling_policy.cc). The implicit
        # "ray.io/node_id" label always resolves.
        self.labels = dict(labels or {})
        self.labels.setdefault("ray.io/node_id", node_id_hex)
        # worker_id_hex -> in-flight direct object transfers reported by
        # that worker's METRICS_PUSH (telemetry.record_transfer_inflight).
        # The hybrid policy sums it per node to deprioritize nodes whose
        # links are saturated with bulk pulls. Plain dict: single-writer
        # (the head ingest loop), racy reads only cost one stale decision.
        self.xfer_inflight: Dict[str, int] = {}

    def transfer_load(self) -> int:
        """In-flight direct object transfers summed over this node's
        workers (0 when telemetry is off — the policy term vanishes)."""
        return sum(self.xfer_inflight.values())

    @property
    def schedulable(self) -> bool:
        """New placement may land here: alive and not draining.
        Liveness-facing paths (release, aggregate, heartbeats) keep
        using `alive` — a draining node still runs what it has."""
        return self.alive and not self.draining


from ..util.scheduling_strategies import (DoesNotExist, Exists, In,
                                          NodeAffinitySchedulingStrategy,
                                          NodeLabelSchedulingStrategy,
                                          NotIn)


def _labels_match(node_labels: Dict[str, str], expr: dict) -> bool:
    """Evaluate a label expression dict {key: In/NotIn/Exists/
    DoesNotExist or plain value} against a node's labels (reference:
    label match operators in scheduling_strategies.py / node label
    scheduling policy)."""
    for key, op in (expr or {}).items():
        val = node_labels.get(key)
        if isinstance(op, In):
            if val not in op.values:
                return False
        elif isinstance(op, NotIn):
            if val in op.values:
                return False
        elif isinstance(op, Exists):
            if val is None:
                return False
        elif isinstance(op, DoesNotExist):
            if val is not None:
                return False
        elif val != op:  # plain value == In(value)
            return False
    return True


class NodeRegistry:
    """Per-node resource pools with node selection (reference: the
    ClusterResourceManager's per-node view driving the hybrid policy,
    scheduling/cluster_resource_manager.* + hybrid_scheduling_policy.cc).

    One real head node; `cluster_utils.Cluster.add_node` registers
    virtual nodes whose workers are real local processes but whose
    resources are bin-packed per-node, so multi-node scheduling and
    failover semantics are testable in-process (the reference's
    cluster_utils.Cluster pattern, SURVEY.md §4)."""

    def __init__(self, head_id_hex: str, head_rm: ResourceManager,
                 head_labels: Optional[Dict[str, str]] = None):
        self._lock = lockdep.lock("scheduler.node_registry")
        self._nodes: Dict[str, NodeEntry] = {}
        self.head = NodeEntry(head_id_hex, head_rm, is_head=True,
                              labels=head_labels)
        self._nodes[head_id_hex] = self.head
        self._spread_rr = 0  # SPREAD round-robin cursor
        # Single-node fast path: the hybrid scorer is skipped entirely
        # until a second node registers (the sync-task hot path).
        self._multi_node = False

    def add_node(self, node_id_hex: str, resources: Dict[str, float],
                 daemon=None,
                 labels: Optional[Dict[str, str]] = None) -> NodeEntry:
        entry = NodeEntry(node_id_hex, ResourceManager(dict(resources)),
                          daemon=daemon, labels=labels)
        with self._lock:
            self._nodes[node_id_hex] = entry
            self._multi_node = sum(
                1 for e in self._nodes.values() if e.alive) > 1
        return entry

    def get(self, node_id_hex: str) -> Optional[NodeEntry]:
        with self._lock:
            return self._nodes.get(node_id_hex)

    def note_transfer_inflight(self, node_id_hex: str,
                               worker_id_hex: Optional[str],
                               value: int) -> None:
        """Ingest one worker's transfer-inflight gauge (METRICS_PUSH):
        the per-link load signal the hybrid policy reads back."""
        entry = self.get(node_id_hex)
        if entry is None or not worker_id_hex:
            return
        if value > 0:
            entry.xfer_inflight[worker_id_hex] = int(value)
        else:
            entry.xfer_inflight.pop(worker_id_hex, None)

    def set_draining(self, node_id_hex: str,
                     draining: bool = True) -> bool:
        """Flip a node's DRAINING flag (planned removal). Placement
        filters exclude draining nodes immediately; `alive` is
        untouched so running work keeps its resource accounting."""
        with self._lock:
            entry = self._nodes.get(node_id_hex)
            if entry is None or entry.is_head:
                return False
            entry.draining = bool(draining)
            return True

    def remove_node(self, node_id_hex: str) -> Optional[NodeEntry]:
        with self._lock:
            entry = self._nodes.get(node_id_hex)
            if entry is None or entry.is_head:
                return None
            entry.alive = False
            # Dead entries stay in the dict; recompute the fast-path
            # flag from what is actually alive.
            self._multi_node = sum(
                1 for e in self._nodes.values() if e.alive) > 1
            return entry

    def entries(self) -> List[NodeEntry]:
        with self._lock:
            return list(self._nodes.values())

    def acquire(self, demand: Dict[str, float],
                strategy=None,
                locality: Optional[Dict[str, int]] = None) -> Optional[str]:
        """Pick a node and acquire `demand` on it, honoring the task's
        scheduling strategy (reference: scheduling/policy/*.cc —
        hybrid [default], spread, node_affinity, node_label policies).
        Default: the hybrid policy — prefer the node holding the most
        bytes of the task's args (lease_policy.cc:38-58), else the
        head (the submitting node), while its critical-resource
        utilization stays below the spread threshold; past that,
        spread to the least-utilized node with top-k randomization
        (hybrid_scheduling_policy.cc:48-160)."""
        for entry in self._candidates(strategy, demand, locality):
            if entry.rm.try_acquire(demand):
                return entry.node_id_hex
        return None

    def _utilization(self, entry: NodeEntry,
                     demand: Optional[Dict[str, float]]) -> float:
        """Critical-resource utilization: the max used/total fraction
        over the resource kinds the task demands (reference scores on
        the dominant resource the same way)."""
        totals, avail = entry.rm.snapshot()
        keys = ([k for k, v in (demand or {}).items() if v > 0]
                or (["CPU"] if "CPU" in totals else list(totals)[:1]))
        u = 0.0
        for k in keys:
            tot = totals.get(k, 0.0)
            if tot <= 0:
                return 1.0
            u = max(u, (tot - avail.get(k, 0.0)) / tot)
        return min(max(u, 0.0), 1.0)

    def _hybrid_candidates(self, demand: Optional[Dict[str, float]],
                           locality: Optional[Dict[str, int]]
                           ) -> List[NodeEntry]:
        if not self._multi_node:  # lint: guarded-by-ok monotonic bool set once when a second node registers; a stale False takes the single-node fast path one extra time
            # Single node: nothing to score (the sync-task hot path).
            return [self.head] if self.head.alive else []
        alive = [e for e in self.entries() if e.schedulable]
        if len(alive) <= 1:
            return alive
        from .config import ray_config
        threshold = float(ray_config.scheduler_spread_threshold)
        # Preferred node: max arg-bytes already local, else the head.
        pref = None
        if locality:
            best_hex = max(sorted(locality), key=lambda h: locality[h])
            for e in alive:
                if e.node_id_hex == best_hex:
                    pref = e
                    break
        if pref is None:
            pref = self.head if self.head.alive else None
        util = {e.node_id_hex: self._utilization(e, demand)
                for e in alive}
        # Per-link transfer saturation (workers' transfer_inflight
        # gauges, summed per node): a node mid multi-GB object pulls
        # loses its tiebreak — co-scheduling more data-hungry work onto
        # a saturated link serializes both transfers. Zero everywhere
        # when telemetry is off, so the term vanishes.
        busy_at = max(1, int(ray_config.scheduler_transfer_busy_threshold))
        xbusy = {e.node_id_hex: e.transfer_load() >= busy_at
                 for e in alive}
        loc = locality or {}
        if pref is not None and util[pref.node_id_hex] < threshold \
                and not xbusy[pref.node_id_hex]:
            rest = sorted(
                (e for e in alive if e is not pref),
                key=lambda e: (util[e.node_id_hex] >= threshold,
                               xbusy[e.node_id_hex],
                               -loc.get(e.node_id_hex, 0),
                               util[e.node_id_hex]))
            return [pref] + rest
        # Preferred node saturated: spread. Below-threshold nodes all
        # score equal (0), so order them by locality then utilization,
        # and shuffle the top-k to avoid herding concurrent decisions
        # onto one node.
        ordered = sorted(
            alive,
            key=lambda e: (util[e.node_id_hex] >= threshold,
                           xbusy[e.node_id_hex],
                           -loc.get(e.node_id_hex, 0),
                           util[e.node_id_hex]))
        k = max(1, int(len(ordered)
                       * float(ray_config.scheduler_top_k_fraction)))
        if not loc and k > 1:
            top = ordered[:k]
            random.shuffle(top)
            ordered = top + ordered[k:]
        return ordered

    def _candidates(self, strategy,
                    demand: Optional[Dict[str, float]] = None,
                    locality: Optional[Dict[str, int]] = None
                    ) -> List[NodeEntry]:
        """Ordered candidate nodes for a strategy. Unplaceable-by-
        strategy (dead affinity target, unmatchable hard labels) yields
        an empty list — strategy_unschedulable() tells permanent from
        transient."""
        if strategy is None:  # the hot default: hybrid policy
            return self._hybrid_candidates(demand, locality)
        if isinstance(strategy, NodeAffinitySchedulingStrategy):
            with self._lock:
                target = self._nodes.get(strategy.node_id)
            if target is not None and target.schedulable:
                if strategy.soft or strategy._spill_on_unavailable:
                    rest = [e for e in self.entries()
                            if e.schedulable and e is not target]
                    return [target] + rest
                return [target]
            if strategy.soft:
                return [e for e in self.entries() if e.schedulable]
            return []
        if isinstance(strategy, NodeLabelSchedulingStrategy):
            alive = [e for e in self.entries() if e.schedulable]
            hard = [e for e in alive
                    if _labels_match(e.labels, strategy.hard)]
            if not strategy.soft:
                return hard
            preferred = [e for e in hard
                         if _labels_match(e.labels, strategy.soft)]
            return preferred + [e for e in hard if e not in preferred]
        if strategy == "SPREAD":
            # Round-robin over alive nodes (reference:
            # spread_scheduling_policy.cc — least-recently-used node
            # first, head not preferred). The cursor advances on
            # SUCCESSFUL dispatch only (note_spread_grant) — a grant
            # that fails for lack of a worker must not burn the node's
            # turn, or fast-path/slow-path aliasing can starve a node.
            alive = [e for e in self.entries() if e.schedulable]
            if not alive:
                return []
            start = self._spread_rr % len(alive)  # lint: guarded-by-ok racy cursor read: a stale value rotates from an old start; note_spread_grant advances it under the lock
            return alive[start:] + alive[:start]
        # DEFAULT / placement-group strategies: hybrid policy.
        return self._hybrid_candidates(demand, locality)

    def note_spread_grant(self, node_id_hex: str):
        """A SPREAD task was dispatched onto `node_id_hex`: rotate the
        round-robin cursor past it."""
        alive = [e for e in self.entries() if e.schedulable]
        for i, e in enumerate(alive):
            if e.node_id_hex == node_id_hex:
                with self._lock:
                    self._spread_rr = i + 1
                return

    def strategy_unschedulable(self, strategy) -> Optional[str]:
        """A reason string when the strategy can NEVER be satisfied
        (fail fast, skipping the autoscaler grace window): hard
        affinity to a dead/unknown node, or hard labels no node
        matches. Transient shortages return None (requeue)."""
        if strategy is None or isinstance(strategy, str):
            return None
        if isinstance(strategy, NodeAffinitySchedulingStrategy):
            if strategy.soft:
                return None
            with self._lock:
                target = self._nodes.get(strategy.node_id)
            if target is None or not target.schedulable:
                if target is None:
                    what = "unknown"
                elif not target.alive:
                    what = "dead"
                else:
                    what = "draining"
                return (f"NodeAffinitySchedulingStrategy: node "
                        f"{strategy.node_id[:16]} is {what} "
                        f"and soft=False")
        if isinstance(strategy, NodeLabelSchedulingStrategy):
            if not any(_labels_match(e.labels, strategy.hard)
                       for e in self.entries() if e.schedulable):
                return ("NodeLabelSchedulingStrategy: no alive node "
                        f"matches hard labels {strategy.hard!r}")
        return None

    def release(self, node_id_hex: str, demand: Dict[str, float]):
        with self._lock:
            entry = self._nodes.get(node_id_hex)
        if entry is not None and entry.alive:
            entry.rm.release(demand)

    def feasible(self, demand: Dict[str, float]) -> bool:
        # Draining nodes are about to leave — demand only they could
        # satisfy must park (autoscaler grace) or fail fast, not land.
        return any(e.schedulable and e.rm.feasible(demand)
                   for e in self.entries())

    def aggregate(self) -> Tuple[Dict[str, float], Dict[str, float]]:
        totals: Dict[str, float] = {}
        avail: Dict[str, float] = {}
        for e in self.entries():
            if not e.alive:
                continue
            t, a = e.rm.snapshot()
            for k, v in t.items():
                totals[k] = totals.get(k, 0.0) + v
            for k, v in a.items():
                avail[k] = avail.get(k, 0.0) + v
        return totals, avail

    def snapshot(self) -> List[dict]:
        rows = []
        for e in self.entries():
            t, a = e.rm.snapshot()
            row = {"node_id": e.node_id_hex, "alive": e.alive,
                   "draining": e.draining,
                   "is_head": e.is_head, "resources_total": t,
                   "resources_available": a,
                   "start_time": e.start_time}
            if e.daemon is not None:
                # Syncer-lite (reference: ray_syncer.h resource-view
                # gossip): the daemon's heartbeat carries its local load;
                # the head is the single scheduler, so this is the
                # observability face, not a second source of truth.
                row["hostname"] = e.daemon.hostname
                # The node's reachable IP as seen by the head (the
                # registration socket's peer) — what multi-host clients
                # must dial, NOT a 0.0.0.0 bind address.
                row["host"] = e.daemon.transfer_addr[0]
                row["last_heartbeat"] = e.daemon.last_ping
                row.update({f"load_{k}": v
                            for k, v in (e.daemon.load or {}).items()})
            rows.append(row)
        return rows


# Dispatch coalescing: while the native recv pump drains one frame
# batch, its EXEC_TASK sends buffer on each TARGET WORKER's handle
# (pickled immediately — blob swap state must be captured at send time)
# and flush as ONE EXEC_TASKS frame per worker when the drain ends.
# Amortizes the dominant per-dispatch costs (native send call, worker
# recv wake) across a burst. The buffer lives on the handle under its
# send_lock — NOT on the pump thread — so a send from ANY thread
# (a driver .remote() pipelining onto the same worker, a CANCEL_TASK, a
# REPLY) flushes the buffered frames first and per-worker FIFO order
# holds; only the pump thread (marked via this thread-local) appends.
_dispatch_coalesce = threading.local()


def _coalesce_flush(dirty) -> None:
    for handle in dirty:
        try:
            with handle.send_lock:
                handle._flush_coalesced_locked()
        except Exception:
            # Send failure == worker death; the EOF death callback fails
            # the in-flight tasks exactly as for inline dispatch errors.
            pass
    dirty.clear()


class WorkerHandle:
    """Driver-side handle to one worker process (reference: the raylet's
    view of a leased worker, worker_pool.h)."""

    def __init__(self, worker_id: WorkerID, proc, conn, env_key: str,
                 env: Dict[str, str]):
        self.worker_id = worker_id
        self.proc = proc
        self.conn = conn
        self.env_key = env_key
        self.env = env
        self.send_lock = lockdep.lock("scheduler.worker_send")
        # Pickled specs awaiting a coalesced EXEC_TASKS flush (guarded
        # by send_lock; see _dispatch_coalesce).
        self.coalesce_buf: list = []
        # Set (under send_lock) when a _NativeMux adopts this conn: sends
        # then enqueue into the C++ core instead of write(2)-ing inline.
        self.native_mux = None
        self.native_token = 0
        self.recv_thread: Optional[threading.Thread] = None
        self.dedicated_actor = None   # ActorID when pinned to an actor
        self.running: Dict[bytes, P.TaskSpec] = {}  # in-flight tasks
        # Serializes {fn-cache check -> EXEC_TASK send} per worker: with
        # pipelined dispatch two threads can target one worker, and the
        # blob-stripped second frame must not overtake the blob-carrying
        # first (the worker would see an uncached fn id).
        self.dispatch_lock = lockdep.lock("scheduler.worker_dispatch")
        # Worker-lease pipelining (reference: the owner pushes up to
        # max_tasks_in_flight_per_worker tasks onto one leased worker,
        # direct_task_transport). The worker executes its queue
        # strictly in order under ONE resource grant, so admission
        # semantics hold; workers blocked in get/wait are excluded as
        # pipeline targets, and GPU tasks never pipeline (device
        # exclusivity). lease = (node_id_hex, demand) while held.
        self.lease: Optional[Tuple[str, Dict[str, float]]] = None
        self.inflight = 0  # dispatched-not-finished count (sched._lock)
        # True while the lease's grant has been returned to the pool
        # because the current task is blocked in get/wait.
        self.lease_released = False
        # >0 while the worker's task sits in a blocking get/wait on the
        # head: pipelining behind a blocked task would park the new
        # task indefinitely (worker execution is sequential).
        self.blocked = 0
        self.fn_cache: Set[str] = set()
        self.gpu_ids: List[int] = []  # GPUs pinned to this worker
        self.alive = True
        self.last_dispatch_ts = 0.0  # OOM-killer victim ordering
        # Set once the death callback has run (or been suppressed during
        # pool shutdown) so it fires exactly once.
        self.death_handled = False

    def send(self, msg_type: str, payload: dict):
        if (msg_type == P.EXEC_TASK
                and getattr(_dispatch_coalesce, "dirty", None) is not None):
            # Pump-thread dispatch during a drain: buffer for the
            # end-of-drain batch flush. Capture the pickled spec NOW —
            # _dispatch restores the fn_blob swap right after this call
            # returns, so a deferred pickle would serialize the wrong
            # blob state.
            import pickle
            try:
                sb = pickle.dumps(payload["spec"], protocol=5)
            except Exception:
                sb = None  # exotic payload: inline cloudpickle path
            if sb is not None:
                with self.send_lock:
                    self.coalesce_buf.append(sb)
                _dispatch_coalesce.dirty.add(self)
                return
        data = P.dump_message(msg_type, payload)
        with self.send_lock:
            # Per-worker FIFO: ANY send (CANCEL_TASK, RECALL_QUEUED,
            # REPLY, an inline EXEC from another thread) must not
            # overtake frames buffered for this worker — a cancel or
            # recall arriving before the task it targets would miss it.
            if self.coalesce_buf:
                self._flush_coalesced_locked()
            # Native path: enqueue into the C++ IO thread (no syscall on
            # this thread). A False return means the conn is gone from
            # the core; fall through so conn.send_bytes raises the same
            # BrokenPipeError the failure paths expect.
            mux = self.native_mux
            if mux is not None and mux.send_framed(self.native_token, data):
                return
            self.conn.send_bytes(data)  # lint: blocking-under-lock-ok AF_UNIX pipe to a local worker; a full pipe buffer IS the per-worker backpressure, and FIFO vs coalesce_buf requires the send under this lock

    def send_raw(self, data) -> None:
        """Ship an ALREADY-PICKLED message body (daemon relay path:
        TO_WORKER frames forwarded verbatim). Same ordering rules as
        send(): buffered EXEC frames flush first, then the native queue
        or the connection."""
        if not isinstance(data, bytes):
            data = bytes(data)
        with self.send_lock:
            if self.coalesce_buf:
                self._flush_coalesced_locked()
            mux = self.native_mux
            if mux is not None and mux.send_framed(self.native_token, data):
                return
            self.conn.send_bytes(data)  # lint: blocking-under-lock-ok same contract as send(): local pipe, FIFO vs coalesce_buf needs the send under this lock

    def _flush_coalesced_locked(self):
        """Ship buffered EXEC frames as one EXEC_TASKS message.
        Caller holds send_lock."""
        if not self.coalesce_buf:
            return  # raced: another sender already flushed
        frames, self.coalesce_buf = self.coalesce_buf, []
        data = P.dump_message(P.EXEC_TASKS, {"specs_pickled": frames})
        mux = self.native_mux
        if mux is not None and mux.send_framed(self.native_token, data):
            return
        self.conn.send_bytes(data)

    def kill(self):
        """Force-kill the process (SIGKILL — jax.distributed installs a
        SIGTERM-catching preemption notifier, so terminate() would leave
        a collective worker alive and computing). Graceful shutdown is
        the SHUTDOWN message, not this. The recv mux's EOF fires the
        death callback, which fails in-flight tasks and releases
        resources — so `alive` is cleared (no new work) but death
        handling still runs."""
        self.alive = False
        try:
            self.proc.kill()
        except Exception:
            pass


class _ConnState:
    """Per-connection state for the recv mux; frame reassembly is the
    shared streaming parser (protocol.FrameParser — one parser
    implementation for every raw-socket recv loop)."""

    __slots__ = ("handle", "on_message", "on_eof", "on_batch", "sock",
                 "parser")

    def __init__(self, handle, on_message, on_eof, sock, on_batch=None):
        self.handle = handle
        self.on_message = on_message
        self.on_eof = on_eof
        self.on_batch = on_batch
        self.sock = sock
        self.parser = P.FrameParser()


class _RecvMux:
    """One epoll thread multiplexing every worker connection (replaces a
    recv thread per worker). On a busy many-core box per-worker threads
    all wake on the GIL when replies land; a single mux drains them
    sequentially with no thread-pile-up — the asio io_service pattern of
    the reference's C++ runtime (common/asio/instrumented_io_context.h).

    Reads are per-call nonblocking (MSG_DONTWAIT on a dup'd fd, so the
    writer side of the same socket stays blocking) with incremental
    frame reassembly: one frozen worker mid-frame can NOT wedge message
    handling or death detection for the others.
    """

    def __init__(self):
        import selectors
        self._sel = selectors.DefaultSelector()
        self._lock = lockdep.lock("scheduler.recv_mux")
        # Self-pipe to interrupt select() for (un)registration.
        self._rd, self._wr = os.pipe()
        os.set_blocking(self._rd, False)
        self._sel.register(self._rd, selectors.EVENT_READ, None)
        self._pending_add: list = []
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="recv-mux")
        self._thread.start()

    def register(self, handle: "WorkerHandle",
                 on_message: Callable, on_eof: Callable,
                 on_batch: Optional[Callable] = None):
        with self._lock:
            self._pending_add.append((handle, on_message, on_eof,
                                      on_batch))
        self._wake()

    def backlog_bytes(self) -> int:
        """Bytes buffered mid-frame across the mux's connections
        (exposition-time head self-gauge; best-effort racy reads of
        each parser's buffer length under the GIL)."""
        total = 0
        try:
            for key in list(self._sel.get_map().values()):
                state = key.data
                if state is not None:
                    total += len(state.parser.buf)
        except (RuntimeError, OSError):
            pass  # selector mutating mid-iteration: scrape-time only
        return total

    def _wake(self):
        try:
            os.write(self._wr, b"x")
        except OSError:
            pass

    def _close_conn(self, fd: int, state: _ConnState):
        try:
            self._sel.unregister(fd)
        except (KeyError, ValueError):
            pass
        try:
            state.sock.close()
        except OSError:
            pass
        state.on_eof(state.handle)

    def _loop(self):
        import socket as _socket

        import selectors
        _SCRATCH_N = 1 << 20
        scratch = bytearray(_SCRATCH_N)
        scratch_view = memoryview(scratch)
        while not self._stopped:
            with self._lock:
                adds, self._pending_add = self._pending_add, []
            for handle, on_message, on_eof, on_batch in adds:
                try:
                    fd = handle.conn.fileno()
                    sock = _socket.socket(fileno=os.dup(fd))
                    state = _ConnState(handle, on_message, on_eof, sock,
                                       on_batch)
                    self._sel.register(fd, selectors.EVENT_READ, state)
                except (OSError, ValueError):
                    on_eof(handle)
            for key, _ in self._sel.select(timeout=1.0):
                if key.data is None:
                    try:
                        while os.read(self._rd, 4096):
                            pass
                    except OSError:
                        pass
                    continue
                state: _ConnState = key.data
                eof = False
                while True:
                    try:
                        # recv_into a reused scratch buffer: no
                        # intermediate bytes object per read.
                        r = state.sock.recv_into(scratch, _SCRATCH_N,
                                                 _socket.MSG_DONTWAIT)
                    except (BlockingIOError, InterruptedError):
                        break
                    except OSError:
                        eof = True
                        break
                    if r == 0:
                        eof = True
                        break
                    state.parser.feed(scratch_view[:r])
                    if r < _SCRATCH_N:
                        break
                for frame in state.parser.frames():
                    try:
                        # One frame may carry a coalesced burst from the
                        # worker's writer thread (multi-message framing);
                        # burst-aware receivers take the whole batch in
                        # one call (submission-run coalescing).
                        msgs = P.load_messages(frame)
                        if len(msgs) > 1 and state.on_batch is not None:
                            state.on_batch(state.handle, msgs)
                        else:
                            for msg_type, payload in msgs:
                                state.on_message(state.handle, msg_type,
                                                 payload)
                    except Exception:
                        import traceback
                        traceback.print_exc()
                if eof:
                    self._close_conn(key.fd, state)

    def stop(self):
        self._stopped = True
        self._wake()


class _NativeMux:
    """Recv mux backed by the C++ dispatch core (_native/src/dispatch.cpp):
    socket IO, frame reassembly, and send queues all live on a native
    epoll thread with no GIL involvement; this pump thread drains
    completed frames in batches (one GIL entry amortized over the whole
    batch) and runs the same per-message handlers as _RecvMux.

    Reference analogue: the raylet's asio io_service owning the worker
    RPC sockets (common/asio/instrumented_io_context.h) with the Python
    layer only seeing parsed, batched completions."""

    def __init__(self):
        import ctypes

        from .. import _native
        self._ctypes = ctypes
        self._core = _native.NativeDispatcher()
        self._eof_len = _native.EOF_LEN
        self._lock = lockdep.lock("scheduler.native_mux")
        # token -> (handle, on_msg, on_eof, on_batch)
        self._states: Dict[int, tuple] = {}
        self._next_token = 0
        self._stopped = False
        # Serializes native-core registration against destroy(): a
        # prestart thread's register racing shutdown must never touch a
        # freed Dispatcher (segfault), it must see _stopped instead.
        self._reg_lock = lockdep.lock("scheduler.native_reg")
        self._cap = 8 << 20
        self._buf = ctypes.create_string_buffer(self._cap)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="native-recv-pump")
        self._thread.start()

    def register(self, handle: "WorkerHandle",
                 on_message: Callable, on_eof: Callable,
                 on_batch: Optional[Callable] = None):
        with self._lock:
            self._next_token += 1
            token = self._next_token
            self._states[token] = (handle, on_message, on_eof, on_batch)
        try:
            with self._reg_lock:
                if self._stopped:
                    ok = False  # shutdown raced this registration
                else:
                    ok = self._core.add(handle.conn.fileno(), token)
                    if ok:
                        # Publish INSIDE the reg lock: stop() detaches
                        # handles after setting _stopped under this
                        # lock, so a publish outside it could attach a
                        # handle to a core stop() already destroyed.
                        # send_lock still serializes against in-flight
                        # conn.send_bytes (no frame interleaving).
                        with handle.send_lock:
                            handle.native_token = token
                            handle.native_mux = self
        except (OSError, ValueError):
            ok = False
        if not ok:
            with self._lock:
                self._states.pop(token, None)
            on_eof(handle)
            return

    def send_framed(self, token: int, data: bytes) -> bool:
        return self._core.send(token, data)

    def _loop(self):
        import struct

        mv = memoryview(self._buf)
        while not self._stopped:
            n = self._core.recv_batch(self._buf, self._cap, 1000)
            if n == 0:
                continue
            if n < 0:
                # One frame larger than the buffer: grow and retry.
                self._cap = max(-n, self._cap * 2)
                self._buf = self._ctypes.create_string_buffer(self._cap)
                mv = memoryview(self._buf)
                continue
            pos = 0
            # Dispatch coalescing for this drain: EXEC_TASK sends from
            # the handlers below buffer per worker and flush as one
            # EXEC_TASKS frame each when the batch ends (see
            # _dispatch_coalesce).
            dirty = set()
            _dispatch_coalesce.dirty = dirty
            try:
                while pos < n:
                    token, ln = struct.unpack_from("=QQ", mv, pos)
                    with self._lock:
                        state = self._states.get(token)
                    if ln == self._eof_len:
                        pos += 16
                        self._core.remove(token)
                        if state is not None:
                            handle = state[0]
                            with handle.send_lock:
                                handle.native_mux = None
                            with self._lock:
                                self._states.pop(token, None)
                            state[2](handle)
                        continue
                    frame = mv[pos + 16:pos + 16 + ln]
                    pos += 16 + ln
                    if state is None:
                        continue
                    try:
                        # Writer-coalesced frames expand to their
                        # messages here — one GIL-held loads() amortized
                        # over the burst instead of one per message.
                        # Batch frames are materialized first: their
                        # out-of-band buffers alias `frame`, a view of
                        # the REUSED recv buffer, and a handler may
                        # defer payloads past this drain.
                        if P.is_batch(frame):
                            frame = bytes(frame)
                        msgs = P.load_messages(frame)
                        if len(msgs) > 1 and state[3] is not None:
                            state[3](state[0], msgs)
                        else:
                            for msg_type, payload in msgs:
                                state[1](state[0], msg_type, payload)
                    except Exception:
                        import traceback
                        traceback.print_exc()
            finally:
                _dispatch_coalesce.dirty = None
                _coalesce_flush(dirty)

    def stop(self):
        with self._reg_lock:
            self._stopped = True
        # Detach every handle first: a late send() must fall back to
        # conn.send_bytes, not enqueue into a core being torn down.
        with self._lock:
            states = list(self._states.values())
            self._states.clear()
        for handle, *_rest in states:
            with handle.send_lock:
                handle.native_mux = None
        self._core.stop()
        self._thread.join(timeout=2.0)
        if self._thread.is_alive():
            return  # pump stuck in a slow handler: leak, don't free
        with self._reg_lock:
            # No register() can be inside the core now (_stopped was
            # set under this lock before any destroy).
            self._core.destroy()


def _make_recv_mux():
    """Native dispatch core when buildable (RTT_NATIVE_DISPATCH=0
    forces the pure-Python epoll mux)."""
    if os.environ.get("RTT_NATIVE_DISPATCH", "1") != "0":
        try:
            return _NativeMux()
        except Exception:
            pass
    return _RecvMux()


class WorkerPool:
    """Spawns and pools worker processes (reference: WorkerPool,
    src/ray/raylet/worker_pool.cc:447 StartWorkerProcess / :1355 PopWorker)."""

    def __init__(self, session_dir: str, store_dir: str,
                 on_worker_message: Callable, on_worker_death: Callable,
                 worker_env: Optional[Dict[str, str]] = None,
                 node_id_hex: Optional[str] = None,
                 on_worker_message_batch: Optional[Callable] = None):
        self._session_dir = session_dir
        self._store_dir = store_dir
        self._on_message = on_worker_message
        self._on_batch = on_worker_message_batch
        self._on_death = on_worker_death
        self._base_env = worker_env or {}
        self._node_id_hex = node_id_hex
        self._authkey = os.urandom(16)
        self._lock = lockdep.lock("scheduler.worker_pool")
        self._mux = _make_recv_mux()
        self._idle: Dict[str, Deque[WorkerHandle]] = collections.defaultdict(
            collections.deque)
        self.workers: Dict[WorkerID, WorkerHandle] = {}

    def _lean_boot_safe(self) -> bool:
        """-S skips .pth processing; editable installs (pip's
        __editable__*.pth import finders) would silently vanish from
        workers, so their presence disables lean boot (cached)."""
        cached = getattr(self, "_lean_boot_safe_cached", None)
        if cached is None:
            import glob
            import site
            cached = True
            try:
                dirs = list(site.getsitepackages())
                user = site.getusersitepackages()
                if user:
                    dirs.append(user)
                for d in dirs:
                    if glob.glob(os.path.join(d, "__editable__*.pth")):
                        cached = False
                        break
            except Exception:
                cached = False
            self._lean_boot_safe_cached = cached
        return cached

    def start_worker(self, env_key: str = "",
                     extra_env: Optional[Dict[str, str]] = None
                     ) -> WorkerHandle:
        """Launch `python -m ray_tpu_torch._private.worker_proc` (reference:
        worker_pool.cc:447 StartWorkerProcess execs default_worker.py) and
        hand it a duplex unix-socket connection."""
        import subprocess
        import sys
        from multiprocessing.connection import Listener

        import cloudpickle

        if fault.enabled:
            fault.fire("worker.start", env_key=env_key)
        worker_id = WorkerID.from_random()
        env = dict(self._base_env)
        # Direct-call plane coherence: workers must agree with the HEAD
        # about the flag (a programmatic ray_config.set in the driver
        # would otherwise diverge from the env the worker reads) — a
        # worker that marks results forward-pending while the head never
        # forwards would stall its local waits.
        from .config import ray_config as _rc
        env["RTT_DIRECT_CALLS_ENABLED"] = \
            "1" if _rc.direct_calls_enabled else "0"
        env["RTT_DIRECT_RESULT_FORWARDING"] = \
            "1" if _rc.direct_result_forwarding else "0"
        # Sequencing + re-dial knobs follow the same coherence rule:
        # the merge gate and redial backoff run IN workers, so a
        # programmatic ray_config.set on the driver must win over
        # whatever the operator's shell exported.
        env["RTT_DIRECT_REDIAL_BACKOFF_S"] = \
            str(_rc.direct_redial_backoff_s)
        env["RTT_DIRECT_REDIAL_MAX_ATTEMPTS"] = \
            str(int(_rc.direct_redial_max_attempts))
        env["RTT_DIRECT_SEQ_REORDER_CAP"] = \
            str(int(_rc.direct_seq_reorder_cap))
        env["RTT_DIRECT_SEQ_HOLD_TIMEOUT_S"] = \
            str(_rc.direct_seq_hold_timeout_s)
        # Shuffle-exchange coherence: reducer actors and partition maps
        # run IN workers, and the per-link pull gate + merge budget are
        # read there — a driver-side ray_config.set must win over the
        # operator's shell env, same rule as the direct-plane knobs.
        env["RTT_SHUFFLE_PARTITIONS"] = \
            str(int(_rc.shuffle_partitions))
        env["RTT_SHUFFLE_LINK_INFLIGHT"] = \
            str(int(_rc.shuffle_link_inflight))
        env["RTT_SHUFFLE_MERGE_BUDGET"] = \
            str(int(_rc.shuffle_merge_budget))
        # Never inherit the DRIVER's device visibility: a worker with no
        # GPU assigned sees no card (torch.cuda.is_available() is False
        # there) and reports no id through get_gpu_ids().
        env.setdefault("CUDA_VISIBLE_DEVICES", "")
        if extra_env:
            env.update(extra_env)
        address = os.path.join(self._session_dir,
                               f"w_{worker_id.hex()[:16]}.sock")
        listener = Listener(address, family="AF_UNIX",
                            authkey=self._authkey)
        proc_env = dict(os.environ)
        proc_env.update(env)
        proc_env["RTT_WORKER_SOCKET"] = address
        proc_env["RTT_WORKER_AUTHKEY"] = self._authkey.hex()
        # stdout/stderr land in log FILES (below): without this, CPython
        # block-buffers (~8 KiB) and log_to_driver streaming stalls
        # until worker exit.
        proc_env["PYTHONUNBUFFERED"] = "1"
        # Workers inherit the driver's import paths (reference: workers
        # receive the driver's sys.path via the job config / runtime env)
        # so by-reference pickles of driver-module functions resolve.
        driver_paths = [p for p in sys.path if p and os.path.isdir(p)]
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        proc_env["PYTHONPATH"] = os.pathsep.join(
            [repo_root] + driver_paths
            + ([proc_env["PYTHONPATH"]] if proc_env.get("PYTHONPATH")
               else []))
        # pip runtime envs run the worker under THEIR venv python
        # (reference: the runtime env agent's per-env interpreter).
        py = env.get("RTT_PYTHON") or sys.executable
        argv = [py, "-m", "ray_tpu_torch._private.worker_proc"]
        from .config import ray_config
        if (bool(ray_config.worker_lean_boot)
                and self._lean_boot_safe()
                and not env.get("CUDA_VISIBLE_DEVICES")
                and not env.get("RTT_PYTHON")):
            # (pip-env workers skip -S: the venv's site-packages IS the
            # point of the environment.)
            # Workers with no device assigned boot with -S: site hooks
            # (sitecustomize, .pth processing) cost every process startup
            # time and a worker without a device never needs them.
            # PYTHONPATH below already carries site-packages via the
            # driver's sys.path, so imports resolve identically. Workers
            # pinned to a GPU (CUDA_VISIBLE_DEVICES) keep the full site.
            argv.insert(1, "-S")
        # Worker stdout/stderr go to per-worker session log files
        # (reference: session_latest/logs/worker-*.out|err); the driver's
        # LogMonitor tails them for log_to_driver streaming.
        logs_dir = os.path.join(self._session_dir, "logs")
        os.makedirs(logs_dir, exist_ok=True)
        stem = os.path.join(logs_dir, f"worker-{worker_id.hex()[:12]}")
        out_f = open(stem + ".out", "ab", buffering=0)
        err_f = open(stem + ".err", "ab", buffering=0)
        try:
            proc = subprocess.Popen(
                argv, env=proc_env, cwd=os.getcwd(),
                stdout=out_f, stderr=err_f,
                start_new_session=False)
        finally:
            out_f.close()
            err_f.close()
        # accept() with a poll loop: a worker that dies on boot (bad env,
        # OOM kill) must not hang the dispatch thread forever.
        import socket as _socket
        import time as _time
        listener._listener._socket.settimeout(0.5)
        conn = None
        from .config import ray_config
        boot_timeout = float(ray_config.worker_register_timeout_s)
        deadline = _time.monotonic() + boot_timeout
        while conn is None:
            try:
                conn = listener.accept()
            except _socket.timeout:
                if proc.poll() is not None:
                    listener.close()
                    raise RuntimeError(
                        f"worker process exited with code "
                        f"{proc.returncode} before connecting")
                if _time.monotonic() > deadline:
                    proc.terminate()
                    listener.close()
                    raise RuntimeError(
                        f"worker process failed to connect within "
                        f"{boot_timeout:g}s")
        try:
            # A concurrent shutdown may have swept the session dir; the
            # unlink inside close() must not kill a prestart thread.
            listener.close()
        except OSError:
            pass
        try:
            os.unlink(address)
        except OSError:
            pass
        config = P.WorkerConfig(
            worker_id=worker_id, session_dir=self._session_dir,
            store_dir=self._store_dir, resources={}, env=env,
            node_id_hex=self._node_id_hex)
        conn.send_bytes(cloudpickle.dumps(config))
        handle = WorkerHandle(worker_id, proc, conn, env_key, env)
        with self._lock:
            self.workers[worker_id] = handle
        self._mux.register(handle, self._on_message, self._handle_eof,
                           self._on_batch)
        return handle

    def _handle_eof(self, handle: WorkerHandle):
        if not handle.death_handled:
            handle.death_handled = True
            handle.alive = False
            self._on_death(handle)

    def pop_idle(self, env_key: str = "") -> Optional[WorkerHandle]:
        with self._lock:
            dq = self._idle.get(env_key)
            while dq:
                h = dq.popleft()
                if h.alive:
                    return h
            return None

    def push_idle(self, handle: WorkerHandle):
        if not handle.alive or handle.dedicated_actor is not None:
            return
        with self._lock:
            self._idle[handle.env_key].append(handle)

    def remove(self, handle: WorkerHandle):
        with self._lock:
            self.workers.pop(handle.worker_id, None)
            dq = self._idle.get(handle.env_key)
            if dq:
                try:
                    dq.remove(handle)
                except ValueError:
                    pass

    def idle_count(self, env_key: str = "") -> int:
        with self._lock:
            return len(self._idle.get(env_key, ()))

    def count_blocked(self, env_key: str = "") -> int:
        """Alive pooled workers whose current task is parked in a
        blocking get/wait (under the pool lock — the workers dict is
        mutated concurrently by worker starts)."""
        with self._lock:
            return sum(1 for h in self.workers.values()
                       if h.alive and getattr(h, "blocked", 0) > 0
                       and h.dedicated_actor is None
                       and h.env_key == env_key)

    def pipeline_candidate(self, env_key: str, demand: Dict[str, float],
                           cap: int,
                           exclude_wid: Optional[bytes] = None
                           ) -> Optional[WorkerHandle]:
        """Least-loaded BUSY worker whose lease matches (env + exact
        resource shape) with pipeline headroom — the target for
        dispatching another task under its existing grant (reference:
        max_tasks_in_flight_per_worker pipelining in the owner's
        direct task transport). `exclude_wid` bars a nested task from
        its own submitter's queue (see _try_pipeline)."""
        best = None
        with self._lock:
            for h in self.workers.values():
                if (h.alive and h.dedicated_actor is None
                        and h.env_key == env_key
                        and h.lease is not None
                        and not getattr(h, "lease_released", False)
                        and 0 < h.inflight < cap
                        and h.blocked == 0
                        and h.lease[1] == demand
                        and (exclude_wid is None
                             or h.worker_id.binary() != exclude_wid)
                        and (best is None
                             or h.inflight < best.inflight)):
                    best = h
        return best

    def shutdown(self):
        with self._lock:
            handles = list(self.workers.values())
        for h in handles:
            h.death_handled = True  # suppress failure handling at shutdown
            try:
                h.send(P.SHUTDOWN, {})
            except Exception:  # lint: broad-except-ok best-effort teardown: every subsystem stops even if one is already dead
                pass
        for h in handles:
            try:
                h.proc.wait(timeout=0.5)
            except Exception:  # lint: broad-except-ok best-effort teardown: every subsystem stops even if one is already dead
                pass
            if h.proc.poll() is None:
                h.kill()
        self._mux.stop()


class PendingTask:
    __slots__ = ("spec", "unresolved", "callback")

    def __init__(self, spec: P.TaskSpec, unresolved: Set[ObjectID],
                 callback=None):
        self.spec = spec
        self.unresolved = unresolved
        self.callback = callback


class Scheduler:
    """Dependency-aware resource scheduler (reference: ClusterTaskManager
    QueueAndScheduleTask/ScheduleAndDispatchTasks,
    cluster_task_manager.cc:44,141 + DependencyManager,
    raylet/dependency_manager.cc)."""

    def __init__(self, resources: ResourceManager, pool: WorkerPool,
                 dispatch_fn: Callable[[P.TaskSpec, WorkerHandle], None],
                 max_workers: Optional[int] = None,
                 is_object_ready: Optional[Callable[[ObjectID], bool]] = None,
                 nodes: Optional[NodeRegistry] = None,
                 locality_fn: Optional[Callable] = None):
        self.resources = resources
        # Per-node view; single-node clusters get a one-entry registry so
        # the dispatch path is uniform.
        self.nodes = nodes or NodeRegistry("head", resources)
        # Which node each in-flight task's resources were acquired on.
        self._task_node: Dict[bytes, str] = {}  # lint: guarded-by-ok deliberately GIL-atomic table: the pop is the idempotence arbiter between concurrent failure paths (release_task_resources)
        self.pool = pool
        self._dispatch_fn = dispatch_fn
        self._is_object_ready = is_object_ready or (lambda oid: False)
        # spec -> {node_hex: bytes of the task's args already there}
        # (reference: LocalityAwareLeasePolicy, lease_policy.cc:38-58).
        # Only consulted once a second node registers.
        self._locality_fn = locality_fn
        # Worker-lease pipelining (reference:
        # max_tasks_in_flight_per_worker in the owner's direct task
        # transport): spec keys running under a worker's lease rather
        # than holding their own grant.
        from .config import ray_config
        self._leased: Set[bytes] = set()
        self._max_inflight = max(
            1, int(ray_config.max_tasks_in_flight_per_worker))
        # GPU allocator: specific device ids handed to workers so two
        # workers never share a GPU (reference: nvidia_gpu.py visible-
        # devices isolation; the resource COUNT alone can't prevent
        # collisions).
        self._free_gpus = list(range(int(resources.totals.get("GPU", 0))))  # lint: guarded-by-ok startup read: the manager is not shared until the dispatch loop starts below
        self._lock = lockdep.lock("scheduler.queue")
        self._cond = threading.Condition(self._lock)
        self._ready: Deque[P.TaskSpec] = collections.deque()
        self._waiting: Dict[ObjectID, List[PendingTask]] = {}
        self._infeasible_since: Dict[bytes, float] = {}  # lint: guarded-by-ok dispatch-loop-thread-only: _try_dispatch is the sole reader and writer
        self._cancelled: Set[bytes] = set()  # lint: guarded-by-ok deliberately GIL-atomic set: membership + discard race only against a task already leaving the queue
        ncpu = os.cpu_count() or 4
        self._max_workers = max_workers or max(ncpu, 4)
        self._started_workers = 0
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="scheduler")
        self._thread.start()

    # -- submission --------------------------------------------------------
    def submit(self, spec: P.TaskSpec, unresolved: Set[ObjectID]):
        if telemetry.enabled:
            # Dispatch-latency stamp; runtime._dispatch pops it before
            # the spec can be pickled (keeps the slim-pickle fast path).
            import time as _time
            spec._t_submit = _time.monotonic()
        if not unresolved and not isinstance(spec, P.ActorSpec):
            # Fast path: dispatch inline on the submitter's thread when
            # resources and an idle worker are immediately available —
            # skips the dispatch-thread hop (cond wake + context switch),
            # which dominates small-task latency. Queue-empty check keeps
            # rough FIFO fairness; worker starts / infeasibility fall
            # through to the dispatch loop.
            with self._cond:
                queue_empty = not self._ready
            if queue_empty and self._try_dispatch_fast(spec):
                return
        with self._cond:
            self._enqueue_locked(spec, unresolved)
            self._cond.notify()

    def submit_batch(self, items) -> None:
        """Submit a burst of (spec, unresolved) in one tick: fast-path
        dispatches run per item (pipelining is the throughput path),
        but everything that has to queue is enqueued under ONE cond
        acquisition with ONE dispatch-loop wake — a 10k-task burst
        costs one notify, not 10k lock round-trips (the per-tick
        batching face of the multi-message framing: the transport
        delivers submissions in bursts, the scheduler absorbs them in
        bursts)."""
        if telemetry.enabled and items:
            import time as _time
            now = _time.monotonic()
            for spec, _u in items:
                spec._t_submit = now
        queued = []
        for spec, unresolved in items:
            # Once anything has queued, FIFO forbids fast-pathing later
            # items past it — skip the lock entirely for the rest.
            if (not queued and not unresolved
                    and not isinstance(spec, P.ActorSpec)):
                with self._cond:
                    queue_empty = not self._ready
                if queue_empty and self._try_dispatch_fast(spec):
                    continue
            queued.append((spec, unresolved))
        if not queued:
            return
        with self._cond:
            for spec, unresolved in queued:
                self._enqueue_locked(spec, unresolved)
            self._cond.notify()

    def _enqueue_locked(self, spec, unresolved: Set[ObjectID]) -> None:
        """Queue one submission (caller holds self._cond)."""
        if racedebug.enabled:
            racedebug.access(self, "_ready", write=True)
        if unresolved:
            pt = PendingTask(spec, set(unresolved))
            for oid in unresolved:
                self._waiting.setdefault(oid, []).append(pt)
            # Close the check-then-register race: a dep may have become
            # ready between the caller's snapshot and this registration,
            # in which case its notify already fired and will not recur.
            for oid in list(pt.unresolved):
                if self._is_object_ready(oid):
                    pt.unresolved.discard(oid)
                    pts = self._waiting.get(oid)
                    if pts is not None:
                        try:
                            pts.remove(pt)
                        except ValueError:
                            pass
                        if not pts:
                            del self._waiting[oid]
            if not pt.unresolved:
                self._ready.append(pt.spec)
        else:
            self._ready.append(spec)

    def notify_object_ready(self, oid: ObjectID):
        with self._cond:
            pts = self._waiting.pop(oid, None)
            if not pts:
                return
            for pt in pts:
                pt.unresolved.discard(oid)
                if not pt.unresolved:
                    self._ready.append(pt.spec)
            self._cond.notify()

    def notify_worker_free(self):
        # Cheap no-op when nothing is parked: waking the dispatch thread
        # per completion just to find an empty queue is a GIL convoy on
        # a many-core box (each wake is a futex + context switch racing
        # the completion pump for the GIL).
        if not self._ready and not self._waiting:  # lint: guarded-by-ok documented racy fast path: waking the dispatch thread per completion to find an empty queue is a GIL convoy
            return
        with self._cond:
            self._cond.notify()

    def _try_dispatch_fast(self, spec) -> bool:
        """Dispatch without starting workers: resources + an idle worker
        or nothing. Runs on submitter/recv threads (the reference's
        direct-dispatch when a lease is already held)."""
        strategy = getattr(spec, "scheduling_strategy", None)
        if strategy == "SPREAD":
            # SPREAD placement goes through the dispatch loop: the
            # round-robin cursor only advances on successful dispatch,
            # and this path can't start workers on the chosen node.
            return False
        demand = spec.resources
        node_id = self.nodes.acquire(demand, strategy,
                                     self._locality_of(spec))
        if node_id is None:
            return self._try_pipeline(spec, demand, strategy)
        env_key = self._env_key_for(spec)
        entry = self.nodes.get(node_id)
        if entry is not None and entry.daemon is not None:
            worker = entry.daemon.pop_idle(env_key)
            local = False
        else:
            worker = self.pool.pop_idle(env_key)
            local = True
        if worker is None:
            self.nodes.release(node_id, demand)
            return self._try_pipeline(spec, demand, strategy)
        key = self._spec_key(spec)
        self._task_node[key] = node_id
        if local and not isinstance(spec, P.ActorSpec):
            self._begin_lease(worker, node_id, demand, key)
        self._dispatch_fn(spec, worker)
        return True

    def _begin_lease(self, worker: WorkerHandle, node_id: str,
                     demand: Dict[str, float], key: bytes):
        """First task of a fresh worker lease: the grant acquired for it
        becomes the worker's, shared by pipelined followers."""
        with self._lock:
            worker.lease = (node_id, dict(demand))
            worker.inflight = 1
            self._leased.add(key)

    def _try_pipeline(self, spec, demand, strategy) -> bool:
        """Dispatch onto a BUSY worker's existing lease (no new grant):
        the async-burst fast path once every grant is held (reference:
        max_tasks_in_flight_per_worker pipelining)."""
        nested = getattr(spec, "_nested", False)
        submitter_wid = getattr(spec, "_submitter_wid", None)
        if (self._max_inflight <= 1
                or isinstance(spec, P.ActorSpec)
                or (strategy is not None
                    and strategy != "DEFAULT")
                or spec.placement_group_id is not None
                or (nested and submitter_wid is None)):
            # Nested tasks pipeline like driver tasks — with one hard
            # exclusion below: never onto the SUBMITTER's own worker
            # (a child queued behind its about-to-block parent on that
            # sequential worker is the self-deadlock case; cross-worker
            # queues are covered by the blocked-worker recall, exactly
            # as for driver-submitted pipelined tasks). Nested specs
            # missing submitter identity keep the conservative
            # no-pipeline path.
            return False
        env_key = self._env_key_for(spec)
        if env_key.startswith("gpu:"):
            # Never pipeline GPU tasks: two computations sharing one
            # pinned GPU means device OOM / contended execution.
            return False
        worker = self.pool.pipeline_candidate(
            env_key, demand, self._max_inflight,
            exclude_wid=submitter_wid if nested else None)
        if worker is None:
            return False
        key = self._spec_key(spec)
        with self._lock:
            # Re-verify EVERYTHING under the lock: between the scan and
            # here the lease can drain and restart with a different
            # shape/node, the pipeline can fill, or the worker's task
            # can enter a blocking get.
            if (worker.lease is None or not worker.alive
                    or worker.blocked != 0
                    or getattr(worker, "lease_released", False)
                    or not (0 < worker.inflight < self._max_inflight)
                    or worker.lease[1] != demand):
                return False
            worker.inflight += 1
            self._task_node[key] = worker.lease[0]
            self._leased.add(key)
        self._dispatch_fn(spec, worker)
        with self._lock:
            raced_block = worker.blocked > 0
        if raced_block:
            # The worker blocked between our re-check and the send: its
            # one-shot recall may have fired before our frame arrived,
            # leaving this task parked behind the blocked head. A
            # second recall is idempotent and cheap.
            try:
                worker.send(P.RECALL_QUEUED, {})
            except Exception:  # lint: broad-except-ok dead worker pipe: the recall is a lost-wakeup patch and WORKER_DIED requeues the task anyway
                pass
        return True

    def dispatch_after_completion(self) -> bool:
        """Completion-driven dispatch: a finished task freed resources +
        an idle worker; hand the next queued task straight out on the
        recv thread instead of waking the dispatch loop. Returns True if
        a task was dispatched."""
        with self._cond:
            if not self._ready:
                return False
            spec = self._ready.popleft()
        tid = getattr(spec, "task_id", None)
        if tid is not None and tid.binary() in self._cancelled:
            self._cancelled.discard(tid.binary())
            return False
        if isinstance(spec, P.ActorSpec) or not self._try_dispatch_fast(
                spec):
            with self._cond:
                self._ready.appendleft(spec)
                self._cond.notify()
            return False
        return True

    def try_cancel(self, task_id: TaskID) -> bool:
        """Remove a queued task; returns True if it had not been dispatched."""
        with self._cond:
            self._infeasible_since.pop(task_id.binary(), None)
            for i, spec in enumerate(self._ready):
                if spec.task_id == task_id:
                    del self._ready[i]
                    return True
            for pts in self._waiting.values():
                for pt in list(pts):
                    if pt.spec.task_id == task_id:
                        pts.remove(pt)
                        return True
            self._cancelled.add(task_id.binary())
            return False

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._ready) + sum(
                len(v) for v in self._waiting.values())

    def pending_demands(self) -> list:
        """Resource demands of queued-but-undispatched work — the
        autoscaler's upscale signal (reference: load_metrics.py pending
        demands fed to resource_demand_scheduler.py)."""
        with self._cond:
            return [dict(s.resources or {}) for s in self._ready]

    # -- dispatch loop -----------------------------------------------------
    def _env_key_for(self, spec) -> str:
        from . import runtime_env as re_mod
        from .placement import gpus_in_demand
        n = gpus_in_demand(spec.resources)
        key = f"gpu:{n}" if n > 0 else ""
        re_hash = re_mod.env_hash(getattr(spec, "runtime_env", None))
        if re_hash:
            # Segregate the worker pool per runtime env (reference: env
            # caching by URI, _private/runtime_env/plugin.py).
            key = f"{key}|re:{re_hash}" if key else f"re:{re_hash}"
        return key

    def _loop(self):
        while True:
            with self._cond:
                while not self._ready and not self._stop:
                    self._cond.wait(timeout=1.0)
                if self._stop:
                    return
                if racedebug.enabled:
                    racedebug.access(self, "_ready", write=True)
                spec = self._ready.popleft()
            tid = getattr(spec, "task_id", None)
            if tid is not None and tid.binary() in self._cancelled:
                self._cancelled.discard(tid.binary())
                continue
            if not self._try_dispatch(spec):
                # Resources or workers unavailable: requeue at the back and
                # block briefly to avoid a hot spin (the reference parks such
                # tasks in the NotDispatched queue until a resource event).
                with self._cond:
                    self._ready.append(spec)
                    self._cond.wait(timeout=0.05)

    def _locality_of(self, spec) -> Optional[Dict[str, int]]:
        """Bytes of `spec`'s args per holder node, or None when the
        cluster has one node / no locality source (skips the directory
        walk on the single-node hot path) or the strategy ignores
        locality (affinity/label/SPREAD candidates never read it)."""
        if self._locality_fn is None or not self.nodes._multi_node:
            return None
        strategy = getattr(spec, "scheduling_strategy", None)
        if strategy is not None and not isinstance(strategy, str):
            return None  # NodeAffinity / NodeLabel pin their own order
        if strategy == "SPREAD":
            return None
        try:
            return self._locality_fn(spec)
        except Exception:  # lint: broad-except-ok locality is advisory: a failing user-supplied or stale locality fn degrades to "no preference", never blocks placement
            return None

    @staticmethod
    def _spec_key(spec) -> bytes:
        return (spec.actor_id.binary() if isinstance(spec, P.ActorSpec)
                else spec.task_id.binary())

    def release_task_resources(self, spec):
        """Release a finished/failed task's resources on the node that
        granted them. Idempotent: the _task_node pop is the arbiter, so
        concurrent failure paths (send-failure branch vs worker-death
        handler) can both call this without double-releasing. Tasks
        running under a worker lease release nothing here — the lease
        (released in note_task_finished / on_worker_removed) owns the
        grant."""
        key = self._spec_key(spec)
        node_id = self._task_node.pop(key, None)
        with self._lock:
            if key in self._leased:
                self._leased.discard(key)
                return
        if node_id is not None:
            self.nodes.release(node_id, spec.resources)

    def note_task_finished(self, spec, worker: WorkerHandle) -> bool:
        """Accounting when a dispatched non-actor task leaves its
        worker (completion or send-failure). Returns True when the
        worker became idle and may rejoin the pool."""
        key = self._spec_key(spec)
        node_id = self._task_node.pop(key, None)
        lease = None
        with self._lock:
            if key in self._leased:
                self._leased.discard(key)
                worker.inflight = max(0, worker.inflight - 1)
                if worker.inflight > 0:
                    return False  # pipeline still draining
                lease, worker.lease = worker.lease, None
                if getattr(worker, "lease_released", False):
                    # Grant already returned while the task sat blocked
                    # in get/wait (note_worker_blocked) and was never
                    # reacquired: nothing to release now.
                    worker.lease_released = False
                    lease = None
            else:
                # Per-task grant (daemon-node workers).
                if node_id is not None:
                    lease = (node_id, spec.resources)
        if lease is not None:
            self.nodes.release(lease[0], lease[1])
        return True

    def note_worker_blocked(self, worker: WorkerHandle) -> bool:
        """The worker's current task parked in a blocking get/wait:
        bump the blocked counter (under the SAME lock _try_pipeline's
        re-check reads it under, closing the dispatch race) and return
        its lease grant to the pool so dependency tasks can schedule
        (reference: a worker blocked in ray.get releases its CPU to
        the raylet — the classic nested-task deadlock mitigation).
        Returns True on the 0->1 transition."""
        with self._lock:
            worker.blocked += 1
            first = worker.blocked == 1
            if (worker.lease is None
                    or getattr(worker, "lease_released", False)):
                return first
            worker.lease_released = True
            lease = worker.lease
        self.nodes.release(lease[0], lease[1])
        self.notify_worker_free()
        return first

    def note_worker_unblocked(self, worker: WorkerHandle):
        """Borrow-back on unblock: reacquire the lease grant if it is
        available; if not, the task simply finishes oversubscribed
        (reference CPU-borrowing semantics) and the drain path skips
        the final release."""
        with self._lock:
            worker.blocked -= 1
            if (worker.blocked > 0 or worker.lease is None
                    or not getattr(worker, "lease_released", False)):
                return
            lease = worker.lease
        entry = self.nodes.get(lease[0])
        if entry is not None and entry.rm.try_acquire(lease[1]):
            with self._lock:
                if (worker.lease is not None and worker.blocked == 0
                        and worker.lease_released):
                    # lease_released check: a concurrent unblock may
                    # have already reclaimed the grant — only ONE
                    # reacquisition may stick or capacity leaks.
                    worker.lease_released = False
                    return
            # Lease drained — or the worker re-blocked while we
            # reacquired (its note_worker_blocked saw lease_released
            # and skipped releasing): either way the grant goes back,
            # or a blocked worker would sit on resources its
            # dependency tasks need.
            self.nodes.release(lease[0], lease[1])

    def node_of_task(self, spec) -> Optional[str]:
        return self._task_node.get(self._spec_key(spec))

    def _try_dispatch(self, spec) -> bool:
        demand = spec.resources
        is_actor_creation = isinstance(spec, P.ActorSpec)
        strategy = getattr(spec, "scheduling_strategy", None)
        reason = self.nodes.strategy_unschedulable(strategy)
        if reason is not None:
            # Permanently unplaceable BY STRATEGY (dead affinity target,
            # unmatchable hard labels): fail fast — no autoscaler grace,
            # a dead node id never comes back (reference:
            # node_affinity_scheduling_policy.cc fails the lease when
            # the target node is gone).
            from ..exceptions import TaskUnschedulableError
            spec._env_error = TaskUnschedulableError(
                f"Task {spec.name}: {reason}")
            self._dispatch_fn(spec, None)
            return True
        if not self.nodes.feasible(demand):
            # Infeasible NOW. With an active autoscaler the demand is its
            # upscale signal, so the task parks for the grace window
            # (reference: the infeasible queue feeding
            # resource_demand_scheduler); without one (grace 0, the
            # default) fail fast via dispatch_fn(None).
            from .config import ray_config
            grace = float(ray_config.infeasible_task_grace_s)
            key = self._spec_key(spec)
            if grace > 0:
                import time as _time
                first = self._infeasible_since.setdefault(
                    key, _time.monotonic())
                if _time.monotonic() - first < grace:
                    return False  # requeue; autoscaler may add capacity
            self._infeasible_since.pop(key, None)
            self._dispatch_fn(spec, None)
            return True
        self._infeasible_since.pop(self._spec_key(spec), None)
        node_id = self.nodes.acquire(demand, strategy,
                                     self._locality_of(spec))
        if node_id is None:
            if getattr(strategy, "_fail_on_unavailable", False):
                from ..exceptions import TaskUnschedulableError
                spec._env_error = TaskUnschedulableError(
                    f"Task {spec.name}: affinity target node "
                    f"{strategy.node_id[:16]} cannot grant {demand} "
                    f"now and _fail_on_unavailable=True")
                self._dispatch_fn(spec, None)
                return True
            return self._try_pipeline(spec, demand, strategy)
        env_key = self._env_key_for(spec)
        entry = self.nodes.get(node_id)
        if entry is not None and entry.daemon is not None:
            # Remote dispatch: the node's daemon owns the worker pool
            # (reference: lease granted by the remote raylet,
            # node_manager.cc:1868).
            worker = entry.daemon.pop_idle(env_key)
            if (worker is not None and is_actor_creation
                    and env_key == ""):
                # Conversion: the daemon stops counting this worker
                # against its pool cap (local path does the same with
                # _started_workers below).
                try:
                    entry.daemon.send(P.WORKER_DEDICATED, {
                        "worker": worker.worker_id.binary(),
                        "actor_id": spec.actor_id.binary()})
                except Exception:
                    pass
            if worker is None:
                try:
                    worker = entry.daemon.start_worker(
                        env_key, spec, dedicated=is_actor_creation)
                except Exception:
                    worker = None
            if worker is None:
                self.nodes.release(node_id, demand)
                return False
            self._task_node[self._spec_key(spec)] = node_id
            if strategy == "SPREAD":
                self.nodes.note_spread_grant(node_id)
            self._dispatch_fn(spec, worker)
            return True
        worker = self.pool.pop_idle(env_key)
        if worker is not None and is_actor_creation and env_key == "":
            # An idle pooled worker becomes a dedicated actor process; it no
            # longer counts against the task-pool cap. (GPU workers are
            # never counted, so only the generic pool decrements.)
            with self._lock:
                self._started_workers -= 1
        if worker is None:
            try:
                worker = self._maybe_start_worker(
                    env_key, spec, dedicated=is_actor_creation)
            except Exception as e:
                from .runtime_env import RuntimeEnvSetupError
                if isinstance(e, RuntimeEnvSetupError):
                    # Env materialization failures are the TASK's error
                    # (reference: RuntimeEnvSetupError on the ref), not
                    # an infinite requeue.
                    self.nodes.release(node_id, demand)
                    spec._env_error = e
                    self._dispatch_fn(spec, None)
                    return True
                worker = None  # boot failure: release + retry later
        if worker is None:
            self.nodes.release(node_id, demand)
            return self._try_pipeline(spec, demand, strategy)
        key = self._spec_key(spec)
        self._task_node[key] = node_id
        if strategy == "SPREAD":
            self.nodes.note_spread_grant(node_id)
        if not is_actor_creation:
            self._begin_lease(worker, node_id, demand, key)
        self._dispatch_fn(spec, worker)
        return True

    def on_worker_removed(self, handle: WorkerHandle):
        """A worker died; open a cap slot / return its GPUs, and
        release its lease grant ONCE (the per-spec failure path then
        skips leased specs)."""
        lease = None
        if not getattr(handle, "is_remote", False):
            with self._lock:
                if handle.dedicated_actor is None and handle.env_key == "":
                    self._started_workers -= 1
                if handle.gpu_ids:
                    self._free_gpus.extend(handle.gpu_ids)
                    handle.gpu_ids = []
                lease, handle.lease = handle.lease, None
                handle.inflight = 0
                if getattr(handle, "lease_released", False):
                    handle.lease_released = False
                    lease = None  # grant already back in the pool
        if lease is not None:
            self.nodes.release(lease[0], lease[1])
        self.notify_worker_free()

    def _maybe_start_worker(self, env_key: str, spec,
                            dedicated: bool = False
                            ) -> Optional[WorkerHandle]:
        # Workers parked in a blocking get/wait don't consume CPU; the
        # pool may grow past the cap by their count so their DEPENDENCY
        # tasks can run (reference: the worker pool starts replacement
        # workers for blocked ones — why Ray shows more worker
        # processes than cores).
        blocked_extra = self.pool.count_blocked(env_key)
        counted = False
        with self._lock:
            # Actor workers are dedicated processes and bypass the pool cap
            # (the reference starts a fresh worker per actor too); only
            # generic pooled workers count against it.
            if not dedicated and env_key == "":
                if self._started_workers >= self._max_workers + blocked_extra:
                    return None
                self._started_workers += 1
                counted = True
        extra_env = {}
        gpu_ids: List[int] = []
        try:
            if env_key.startswith("gpu:"):
                # Pin specific GPUs before the worker can import torch
                # (reference: nvidia_gpu.py
                # set_current_process_visible_accelerator_ids); specific
                # ids (not just counts) so concurrent GPU workers never
                # collide on a device.
                from .placement import gpus_in_demand
                ngpus = gpus_in_demand(spec.resources) or 1
                with self._lock:
                    if len(self._free_gpus) < ngpus:
                        reclaim = True
                    else:
                        gpu_ids = sorted(self._free_gpus.pop(0)
                                         for _ in range(ngpus))
                        reclaim = False
                if reclaim:
                    # Idle GPU workers hold devices; reclaim by retiring
                    # them and retrying once their death returns the
                    # ids.
                    self._reclaim_idle_gpu_workers()
                    return None
                from .resources import gpu_worker_extra_env
                extra_env = gpu_worker_extra_env(gpu_ids)
            spec_re = getattr(spec, "runtime_env", None)
            if spec_re:
                from . import runtime_env as re_mod
                extra_env.update(re_mod.worker_extra_env(spec_re))
            handle = self.pool.start_worker(env_key, extra_env)
        except BaseException:
            # ANY start failure (env materialization, subprocess spawn,
            # an injected worker.start fault) must hand back what was
            # reserved: the cap slot and the pinned GPUs — or the
            # phantom count/missing GPUs starve every later start.
            with self._lock:
                if counted:
                    self._started_workers -= 1
                if gpu_ids:
                    self._free_gpus.extend(gpu_ids)
            raise
        handle.gpu_ids = gpu_ids
        return handle

    def _reclaim_idle_gpu_workers(self):
        for key in list(self.pool._idle.keys()):
            if not key.startswith("gpu:"):
                continue
            while True:
                h = self.pool.pop_idle(key)
                if h is None:
                    break
                try:
                    h.send(P.SHUTDOWN, {})
                except Exception:
                    h.kill()

    def prestart(self, n: int):
        """Warm the pool (reference: worker_pool.cc prestart)."""
        def _start():
            try:
                h = self.pool.start_worker("")
            except Exception:
                # Shutdown raced the prestart, or the start failed:
                # release the cap slot reserved below, or the phantom
                # count starves _maybe_start_worker forever.
                with self._lock:
                    self._started_workers -= 1
                return
            self.pool.push_idle(h)
            self.notify_worker_free()
        with self._lock:
            n = min(n, self._max_workers - self._started_workers)
            self._started_workers += max(0, n)
        threads = [threading.Thread(target=_start, daemon=True)
                   for _ in range(max(0, n))]
        for t in threads:
            t.start()

    def stop(self):
        with self._cond:
            self._stop = True
            self._cond.notify_all()
