"""Driver runtime: the Node that owns the GCS, scheduler, and object store.

TPU-native collapse of the reference's head-node process set — GCS server +
raylet + driver core worker (SURVEY.md §3.1 ray.init call stack) — into one
process with threads. The driver is the *owner* of all objects and tasks it
submits, holding the reference-counting and lineage state the reference keeps
in the core worker's ReferenceCounter/TaskManager
(src/ray/core_worker/reference_count.h:66, task_manager.cc).
"""

from __future__ import annotations

import atexit
import collections
import logging
import os
import sys
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Set, Tuple

from ..exceptions import (
    ActorDiedError,
    ActorError,
    GetTimeoutError,
    NodeDrainedError,
    ObjectLostError,
    TaskCancelledError,
    TaskError,
    TaskUnschedulableError,
    WorkerCrashedError,
)
from . import gcs as gcs_mod
from . import lockdep
from . import protocol as P
from . import racedebug
from . import refdebug
from . import serialization
from . import telemetry
from . import wiretap
from .config import session_dirs
from .ids import ActorID, NodeID, ObjectID, TaskID, WorkerID
from .object_store import ObjectStore, create_store, inline_threshold
from .resources import detect_node_resources
from .scheduler import ResourceManager, Scheduler, WorkerHandle, WorkerPool

logger = logging.getLogger(__name__)

# Per-thread forward batch scope (see Node._forward_results): while a
# recv thread drains one coalesced completion frame, nested-submission
# result forwards buffer here and flush as one RESULT_FWD per submitter
# at scope exit — per-frame batching instead of per-completion messages.
_fwd_scope = threading.local()


def _gc_stale_sessions(max_age_s: Optional[float] = None):
    """Sweep shm/session dirs left by crashed runs (reference: ray's
    session dir GC in _private/utils.py). Dirs whose stamped owner pid
    is dead go immediately; ownerless dirs keep a grace period —
    `max_age_s` when they hold content, one minute when they are
    logs-only husks. A store's `<store>_spill` dir (object_store.py)
    matches the store glob too and belongs to its store: it is swept
    with the store, never on its own while the store is there."""
    import glob
    import shutil
    if max_age_s is None:
        from .config import ray_config
        max_age_s = float(ray_config.session_gc_max_age_s)
    now = time.time()
    # Only this TMPDIR's stores and sessions, the head's and the node
    # daemons' (see config.session_dirs); all carry .owner_pid stamps.
    session_glob, store_glob = session_dirs("*")
    for d in glob.glob(store_glob) + glob.glob(session_glob):
        if d.endswith("_spill") and os.path.isdir(d.removesuffix("_spill")):
            continue
        try:
            # A live session's dir can be legitimately empty (worker
            # sockets are unlinked right after accept), so emptiness is
            # not staleness: only the owner pid's death proves a husk.
            age = now - os.path.getmtime(d)
            pid, stamped = _session_owner_pid(d)
            if pid is not None and not _owner_alive(pid, stamped):
                shutil.rmtree(d, ignore_errors=True)
                shutil.rmtree(d + "_spill", ignore_errors=True)
            elif pid is None:
                # No .owner_pid. Content decides: a dir holding nothing
                # but logs/ is a husk (a prestart thread recreating
                # logs/ after shutdown's rmtree) and goes after a
                # minute; anything with real content keeps the full
                # max_age_s grace in case the stamp write failed on a
                # LIVE session (Node.__init__ swallows that OSError).
                try:
                    contentful = bool(set(os.listdir(d)) - {"logs"})
                except OSError:
                    contentful = True
                if age > (max_age_s if contentful else 60.0):
                    shutil.rmtree(d, ignore_errors=True)
                    shutil.rmtree(d + "_spill", ignore_errors=True)
        except OSError:
            pass


def _session_owner_pid(session_dir: str):
    """(pid, pidfile mtime) from the dir's .owner_pid, or (None, 0)."""
    path = os.path.join(session_dir, ".owner_pid")
    try:
        with open(path) as f:
            return int(f.read().strip()), os.path.getmtime(path)
    except (OSError, ValueError):
        return None, 0.0


def _owner_alive(pid: int, stamped_at: float) -> bool:
    """Is `pid` alive AND the same process that stamped the pidfile?
    A recycled pid shows alive but started after the stamp — compare
    /proc start time so recycled pids don't immortalize stale dirs."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        pass
    start = _proc_start_time(pid)
    if start is not None and stamped_at and start > stamped_at + 5.0:
        return False  # pid recycled since the session stamped it
    return True


def _proc_start_time(pid: int):
    """Process start time as a unix timestamp (Linux /proc), else None."""
    try:
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime "))
        with open(f"/proc/{pid}/stat") as f:
            stat = f.read()
        # field 22 (1-indexed) after the parenthesized comm, which may
        # itself contain spaces — split after the last ')'.
        fields = stat.rsplit(")", 1)[1].split()
        ticks = int(fields[19])  # fields[0] is state, so 22-3=19
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except Exception:  # lint: broad-except-ok /proc parse on a racing or non-Linux pid; None means unknown
        return None


class _ActorState:
    """Driver-side per-actor submit queue (reference: ActorTaskSubmitter +
    SequentialActorSubmitQueue, transport/actor_task_submitter.cc:158)."""

    __slots__ = ("spec", "worker", "ready", "dead", "queue", "lock",
                 "in_flight", "seq_settled")

    def __init__(self, spec: P.ActorSpec):
        self.spec = spec
        self.worker: Optional[WorkerHandle] = None
        self.ready = False
        self.dead = False
        self.lock = lockdep.lock("runtime.actor_queue")
        # Ordered pending (spec, unresolved_deps) items.
        self.queue: collections.deque = collections.deque()
        self.in_flight: Set[bytes] = set()
        # Cross-plane sequencing settlement store, per caller worker:
        # caller_id bytes -> [below, set] — every stamped seq < below
        # plus those in the set is terminally settled (executed
        # somewhere, or typed-errored). Fed by terminal registrations,
        # DIRECT_DONE entries, and caller snapshots at reconcile /
        # re-dial; consulted by callee merge-gate resync queries so a
        # fresh incarnation never wedges on a predecessor that already
        # settled against an earlier one. Guarded by `lock`.
        self.seq_settled: Dict[bytes, list] = {}


class Node:
    """The driver-side runtime (head node)."""

    def __init__(self, num_cpus=None, num_gpus=None, resources=None,
                 namespace: str = "default", session_dir: Optional[str] = None,
                 object_store_memory: Optional[int] = None):
        self.namespace = namespace
        # Snappier GIL handoff for the head's recv pump / handler pool /
        # submitter threads (see worker_proc.worker_main for the
        # measured rationale). Scoped to the runtime's lifetime: the
        # prior interval is restored in shutdown() so an embedding
        # process (pytest, a notebook) gets its own setting back.
        self._prev_switch_interval = sys.getswitchinterval()
        sys.setswitchinterval(float(os.environ.get(
            "RTT_GIL_SWITCH_INTERVAL", "0.001")))
        self.node_id = NodeID.from_random()
        _gc_stale_sessions()
        session_name = f"session_{int(time.time())}_{uuid.uuid4().hex[:8]}"
        default_session, self.store_dir = session_dirs(session_name)
        self.session_dir = session_dir or default_session
        os.makedirs(self.session_dir, exist_ok=True)
        self.store = create_store(self.store_dir,
                                 capacity=object_store_memory)
        for d in (self.session_dir, self.store_dir):
            try:
                with open(os.path.join(d, ".owner_pid"), "w") as f:
                    f.write(str(os.getpid()))
            except OSError:
                pass
        self.gcs = gcs_mod.Gcs()
        self.gcs.node_id_hex = self.node_id.hex()
        totals = detect_node_resources(num_cpus, num_gpus, resources)
        self.resources_mgr = ResourceManager(totals)
        from .placement import PlacementGroupManager
        self.pg_manager = PlacementGroupManager(self.resources_mgr)
        self._pg_ready_refs: Dict[str, ObjectID] = {}
        self._pg_ready_lock = lockdep.lock("runtime.pg_ready")
        self.pool = WorkerPool(
            self.session_dir, self.store_dir,
            on_worker_message=self._on_worker_message,
            on_worker_death=self._on_worker_death,
            node_id_hex=self.node_id.hex(),
            on_worker_message_batch=self._on_worker_messages)
        ncpu = int(totals.get("CPU", 4))
        from .scheduler import NodeRegistry
        self.node_registry = NodeRegistry(self.node_id.hex(),
                                          self.resources_mgr)
        self.scheduler = Scheduler(
            self.resources_mgr, self.pool, self._dispatch,
            max_workers=max(ncpu, 4),
            is_object_ready=self._is_object_ready,
            nodes=self.node_registry,
            locality_fn=self._arg_locality)
        self._handler_pool = ThreadPoolExecutor(
            max_workers=32, thread_name_prefix="handler")
        self._fn_registry: Dict[str, bytes] = {}
        self._retries_used: Dict[bytes, int] = {}
        # task_id bytes -> worker_id bytes: reconcile-requeued direct
        # calls whose granted attempt would die with that incarnation.
        # Kept OFF the spec (a dynamic attr would demote its dispatch
        # pickle off the slim fast path and leak a head-internal marker
        # to the worker). Entries are one-shot: popped by the death
        # drain or at normal completion.
        self._direct_prepaid: Dict[bytes, bytes] = {}
        # -- graceful drain (docs/DRAIN.md; reference: gcs_node_manager
        # DrainNode). node_id_hex set: deaths on these nodes are the
        # CLUSTER's fault — migration must not charge max_restarts /
        # max_task_retries and terminal errors are NodeDrainedError.
        # Empty set ⇒ every drain check is one falsy `in` test (the
        # steady-state zero-cost guarantee).
        self._draining_nodes: Set[str] = set()
        # node_id_hex -> mutable status dict (state/progress gauges);
        # the coordinator thread owns writes, readers copy.
        self._drains: Dict[str, dict] = {}
        self._drain_lock = lockdep.lock("runtime.drain")
        self._recovery_lock = lockdep.lock("runtime.recovery")
        self._cancel_requested: Set[bytes] = set()
        self._actors: Dict[ActorID, _ActorState] = {}  # lint: guarded-by-ok GIL-atomic table: inserted once per actor at registration, read via .get() everywhere; per-actor mutable state lives behind _ActorState.lock
        self._actor_dep_waiters: Dict[ObjectID, List[Tuple[_ActorState, list]]] = {}
        self._actor_dep_lock = lockdep.lock("runtime.actor_deps")
        self._ready_cond = lockdep.condition("runtime.object_ready")
        self._release_buf: List[ObjectID] = []
        self._release_lock = lockdep.lock("runtime.release_buf")
        # Streaming generator tasks: task binary -> stream state
        self._gen_lock = lockdep.lock("runtime.gen_streams")
        self._gen_cond = threading.Condition(self._gen_lock)
        self._gen_streams: Dict[bytes, dict] = {}
        self.gcs.objects.subscribe_ready(self._on_object_ready)
        self.gcs.objects.subscribe_free(self._on_objects_freed)
        # OOM defense (reference: MemoryMonitor memory_monitor.h:52 +
        # WorkerKillingPolicy worker_killing_policy.h:34): spill shm first,
        # then shed one worker per tick above the usage threshold.
        from .memory_monitor import MemoryMonitor
        self.memory_monitor = MemoryMonitor(self._on_memory_pressure)
        self.memory_monitor.start()
        # Worker log tailing (reference: log_monitor.py); started by
        # api.init when log_to_driver=True.
        from .log_monitor import LogMonitor
        self.log_monitor = LogMonitor(
            os.path.join(self.session_dir, "logs"))
        # -- multi-host control plane (reference: the GCS gRPC server the
        # raylets register with, gcs_server_main.cc:47 + the object
        # manager data plane, object_manager.h:117). The head listens for
        # per-host daemons (daemon.py) over authenticated TCP and serves
        # its local objects to peers via a chunked transfer server.
        from .config import ray_config
        from .netcomm import PullManager, TransferServer, \
            store_paths_factory
        from .node_service import HeadServer
        token_hex = os.environ.get("RTT_CLUSTER_TOKEN_HEX", "")
        if token_hex:
            self.cluster_token = bytes.fromhex(token_hex)
        else:
            # Durable-storage heads keep their token across restarts so
            # daemons and clients re-authenticate after a head crash
            # (reference: GCS FT — the restarted gcs_server serves the
            # same cluster identity from Redis).
            stored = self.gcs.kv.get("cluster_token", namespace="__head__")
            self.cluster_token = stored or os.urandom(16)
        self.gcs.kv.put("cluster_token", self.cluster_token,
                        namespace="__head__")
        paths_for, view_for = store_paths_factory(self.store)
        from .netcomm import store_local_locator
        self.transfer_server = TransferServer(
            paths_for, self.cluster_token,
            host=str(ray_config.node_host), view_for=view_for,
            locate_for=store_local_locator(self.store))
        self.transfer_port = self.transfer_server.port
        self.pull_mgr = PullManager(
            self.store, self.cluster_token,
            max_concurrent=int(ray_config.pull_max_concurrent))
        self.head_server = HeadServer(
            self, self.cluster_token,
            host=str(ray_config.node_host),
            port=int(ray_config.head_port))
        # -- direct worker<->worker call plane (direct.py; reference:
        # transport/direct_actor_task_submitter): the head only BROKERS
        # channels (CHANNEL_REQ/OPEN/ADDR) and ingests batched
        # accounting; steady-state calls bypass it entirely.
        self._direct_on = bool(ray_config.direct_calls_enabled)
        self._fwd_on = self._direct_on and bool(
            ray_config.direct_result_forwarding)
        self._chan_waiters: Dict[int, Any] = {}
        self._chan_lock = lockdep.lock("runtime.chan_broker")
        self._chan_token = 0
        # Nested-submission result forwarding: per-submitter buffers
        # with group-commit flush (one RESULT_FWD frame per burst).
        self._fwd_lock = lockdep.lock("runtime.result_fwd")
        self._fwd_bufs: Dict[bytes, list] = {}
        self._fwd_flushing: Set[bytes] = set()
        self._shutdown = False
        if refdebug.enabled:
            refdebug.boot()
        atexit.register(self.shutdown)

    def _on_memory_pressure(self, fraction: float):
        """One relief action per monitor tick: spill if anything is
        spillable, otherwise kill the policy-chosen worker (its in-flight
        tasks fail through the normal worker-death path and retry on their
        `max_retries` budget)."""
        spill = getattr(self.store, "spill_objects", None)
        if spill is not None:
            used = getattr(self.store, "used_bytes", 0)
            target = used // 2 if isinstance(used, int) else 0
            if spill(target) > 0:
                return
        from .memory_monitor import pick_victim
        candidates = []
        for h in list(self.pool.workers.values()):
            if not h.alive or not (h.running or h.dedicated_actor):
                continue
            if h.dedicated_actor is not None:
                st = self._actors.get(h.dedicated_actor)
                retriable = bool(st and st.spec.max_restarts != 0)
                owner = f"actor:{h.dedicated_actor.hex()}"
            else:
                specs = list(h.running.values())
                retriable = bool(specs) and all(
                    self._retries_used.get(s.task_id.binary(), 0)
                    < s.max_retries for s in specs)
                owner = specs[0].fn_id if specs else "idle"
            candidates.append(
                (h, retriable, getattr(h, "last_dispatch_ts", 0.0), owner))
        victim = pick_victim(candidates)
        if victim is not None:
            self.gcs.record_task_event({
                "task_id": "", "name": "oom_killer",
                "state": f"KILLED_WORKER:{victim.worker_id.hex()}",
                "ts": time.time()})
            victim.kill()

    # ------------------------------------------------------------------
    # object plane (owner side)
    # ------------------------------------------------------------------
    def put(self, value: Any) -> ObjectID:
        """Owner-side put. serialize() is a sizing pass (pickle-5
        out-of-band: buffers are collected as views, not copied);
        above the inline threshold the store reserves a segment of
        total_size and lands each buffer in place — the value's bytes
        are copied exactly once, serialize-to-shm (object_store
        put_in_place)."""
        oid = ObjectID.from_random()
        sobj = serialization.serialize(value)
        if sobj.total_size <= inline_threshold():
            self.gcs.objects.register_ready(
                oid, (P.LOC_INLINE, sobj.to_bytes()), sobj.total_size)
        else:
            size = self.store.put_serialized(oid, sobj)
            self.gcs.objects.register_ready(
                oid, (P.LOC_SHM, size, self.node_id.hex()), size)
        return oid

    def _tag_local_loc(self, loc):
        """Normalize an untagged shm location to carry this node's id —
        the object directory always records WHERE a shm object lives so
        workers on other nodes know to pull it."""
        if loc and loc[0] == P.LOC_SHM and len(loc) < 3:
            return (P.LOC_SHM, loc[1], self.node_id.hex())
        return loc

    def placement_group_ready_ref(self, pg_id_hex: str) -> ObjectID:
        """An ObjectID that resolves to True once the PG's bundles are
        reserved (the reference's ``pg.ready()`` ObjectRef,
        util/placement_group.py:41). Backed by a watcher thread instead of a
        task so readiness costs no worker. One ref + one watcher per group
        (cached, pinned) so ready()-polling loops can't accumulate threads
        or pending objects."""
        entry = self.pg_manager.get(pg_id_hex)
        if entry is None:
            oid = ObjectID.from_random()
            blob = serialization.dumps(
                ValueError(f"Unknown placement group {pg_id_hex}"))
            self.gcs.objects.register_ready(oid, (P.LOC_ERROR, blob))
            return oid
        with self._pg_ready_lock:
            oid = self._pg_ready_refs.get(pg_id_hex)
            if oid is not None and self.gcs.objects.entry(oid) is not None:
                return oid
            oid = ObjectID.from_random()
            self.gcs.objects.register_pending(oid, None)
            # Pin: survives user ObjectRefs coming and going.
            self.gcs.objects.incref(oid)
            self._pg_ready_refs[pg_id_hex] = oid

        def _watch():
            entry.ready_event.wait()
            from . import placement as pl
            if entry.state == pl.PG_CREATED:
                sobj = serialization.serialize(True)
                self.gcs.objects.register_ready(
                    oid, (P.LOC_INLINE, sobj.to_bytes()), sobj.total_size)
            else:
                blob = serialization.dumps(TaskUnschedulableError(
                    entry.error or f"Placement group {pg_id_hex} "
                    f"is {entry.state}"))
                self.gcs.objects.register_ready(oid, (P.LOC_ERROR, blob))

        threading.Thread(target=_watch, daemon=True,
                         name=f"pg-ready-{pg_id_hex[:8]}").start()
        return oid

    def _read_location(self, oid: ObjectID, location: Tuple) -> Any:
        kind = location[0]
        if kind == P.LOC_INLINE:
            value = serialization.deserialize(location[1])
        elif kind == P.LOC_SHM:
            if len(location) > 2 and location[2] != self.node_id.hex():
                self._ensure_local(oid, location[2])
            value = self.store.get(oid)
        elif kind == P.LOC_ERROR:
            raise serialization.deserialize(location[1])
        else:
            raise ObjectLostError(oid.hex())
        if isinstance(value, TaskError):
            raise value
        return value

    # ------------------------------------------------------------------
    # multi-host: daemon lifecycle + cross-node object movement
    # ------------------------------------------------------------------
    @property
    def cluster_address(self) -> str:
        host, port = self.head_server.address
        return f"{host}:{port}"

    def transfer_addr_of(self, node_hex: str):
        """(host, port) of a node's transfer server, or None if gone."""
        if node_hex == self.node_id.hex():
            return ("127.0.0.1", self.transfer_port)
        handle = self.head_server.daemons.get(node_hex)
        if handle is None or not handle.alive:
            return None
        return handle.transfer_addr

    def _ensure_local(self, oid: ObjectID, node_hex: str):
        """Pull a remote object's bytes into the head-local store
        (reference: PullManager fetch on ray.get of a remote object)."""
        if self.store.contains(oid):
            return
        addr = self.transfer_addr_of(node_hex)
        if addr is None:
            raise ObjectLostError(
                oid.hex(), f"source node {node_hex[:8]} is gone")
        self.pull_mgr.pull(oid, addr[0], addr[1])

    def _on_daemon_registered(self, handle):
        self.node_registry.add_node(handle.node_id_hex, handle.resources,
                                    daemon=handle,
                                    labels=getattr(handle, "labels", None))
        self.gcs.pubsub.publish("node", {
            "event": "registered", "node_id": handle.node_id_hex,
            "hostname": handle.hostname, "resources": handle.resources})
        self.scheduler.notify_worker_free()

    def _on_daemon_lost(self, handle):
        """A node daemon disconnected/died: fail its workers through the
        standard death paths and mark its primary object copies LOST so
        getters trigger lineage reconstruction (reference: node failure
        handling in GcsNodeManager + ObjectRecoveryManager)."""
        self.node_registry.remove_node(handle.node_id_hex)
        # A node that dies MID-drain degrades to plain node-death
        # semantics: drop the drain attribution first so the worker
        # deaths below charge budgets exactly like an unplanned loss,
        # and settle the drain status for observers.
        with self._drain_lock:
            if handle.node_id_hex in self._draining_nodes:
                self._draining_nodes.discard(handle.node_id_hex)
                dst = self._drains.get(handle.node_id_hex)
                if dst is not None and dst["state"] == "DRAINING":
                    dst["state"] = "NODE_DIED"
        self.gcs.pubsub.publish("node", {
            "event": "dead", "node_id": handle.node_id_hex})
        # Stop re-exporting the dead node's last metrics snapshot.
        self.gcs.telemetry.forget_node(handle.node_id_hex)
        # Mark objects lost BEFORE failing workers: retries submitted by
        # the death path must see dead-node deps as unresolved (and
        # recover them), not dispatch against locations that are gone.
        # Copies already pulled into the head store stay READY,
        # re-pointed at the head.
        head_hex = self.node_id.hex()
        # A copy still being pulled from the dead node is no copy: its
        # pull fails and removes it.
        self.gcs.objects.mark_node_lost(
            handle.node_id_hex,
            relocate=lambda oid, size:
                (P.LOC_SHM, size, head_hex)
                if self.store.contains(oid)
                and not self.pull_mgr.in_flight(oid) else None)
        self._fail_daemon_worker_proxies(handle)

    def _fail_daemon_worker_proxies(self, handle):
        """Fail every worker proxy of a daemon connection through the
        standard death paths. Also used alone when a reconnecting
        daemon SUPERSEDES its old connection: the node stays alive (no
        object loss, no registry removal), but the old connection's
        workers were killed daemon-side and can never deliver
        WORKER_DIED — without this, drivers blocked on their tasks wait
        forever."""
        for proxy in list(handle.proxies.values()):
            if not proxy.death_handled:
                proxy.death_handled = True
                proxy.alive = False
                self._on_worker_death(proxy)
        with self._ready_cond:
            self._ready_cond.notify_all()
        self.scheduler.notify_worker_free()

    def broadcast_object(self, object_id: ObjectID,
                         timeout: float = 300.0) -> int:
        """Push one shm object to EVERY alive daemon node via a binomial
        tree: each round, every node that already holds a copy feeds one
        that doesn't, so a 1->N broadcast costs O(log N) rounds with all
        links busy (reference: push_manager.h push scheduling; the
        1 GiB broadcast scalability benchmark,
        release/benchmarks README). Returns the number of nodes holding
        a copy afterwards (including the source)."""
        import collections
        from concurrent.futures import wait as _fwait

        entry = self.gcs.objects.entry(object_id)
        if entry is None or not entry.event.is_set():
            raise ValueError(
                f"broadcast_object: {object_id.hex()} is not ready")
        loc = entry.location
        if loc is None or loc[0] != P.LOC_SHM:
            # Inline objects ride control messages; nothing to push.
            return 1
        src_hex = loc[2] if len(loc) > 2 else self.node_id.hex()
        holders = [src_hex]
        remaining = collections.deque(
            h for h in self.head_server.all_daemons()
            if h.alive and h.node_id_hex != src_hex)
        while remaining:
            batch = [remaining.popleft()
                     for _ in range(min(len(holders), len(remaining)))]
            futs = {}
            for i, target in enumerate(batch):
                source = holders[i % len(holders)]
                futs[self._handler_pool.submit(
                    target.request, P.LOCALIZE_OBJECT,
                    {"object_id": object_id, "node": source},
                    timeout)] = target
            _fwait(list(futs))
            for fut, target in futs.items():
                try:
                    fut.result()
                    holders.append(target.node_id_hex)
                except Exception:
                    pass  # target died mid-broadcast: skip it
        return len(holders)

    # ------------------------------------------------------------------
    # graceful node drain (docs/DRAIN.md; reference: gcs_node_manager
    # DrainNode + autoscaler-v2 drain requests)
    # ------------------------------------------------------------------
    def drain_node(self, node_id_hex: str,
                   deadline_s: Optional[float] = None,
                   wait: bool = False) -> dict:
        """Begin (or observe) a graceful drain of one node: stop new
        placement immediately, then — on a coordinator thread — drain
        serve replicas out of routing, let running tasks finish,
        migrate dedicated actors without charging restart budgets, and
        re-home sole-copy objects, all under `deadline_s`. Returns a
        status snapshot; with wait=True, blocks until the drain settles
        (DRAINED / DEADLINE_EXCEEDED / NODE_DIED)."""
        from .config import ray_config
        if deadline_s is None:
            deadline_s = float(ray_config.drain_deadline_s)
        entry = self.node_registry.get(node_id_hex)
        if entry is None:
            raise ValueError(f"unknown node {node_id_hex[:16]}")
        if entry.is_head:
            raise ValueError("cannot drain the head node")
        with self._drain_lock:
            st = self._drains.get(node_id_hex)
            if st is None or st["state"] != "DRAINING":
                st = {"node_id": node_id_hex, "state": "DRAINING",
                      "started_at": time.time(),
                      "deadline_s": float(deadline_s),
                      "daemon_ack": False, "objects_remaining": -1,
                      "tasks_remaining": -1, "replicas_drained": 0,
                      "error": None}
                thread = threading.Thread(
                    target=self._drain_worker, args=(node_id_hex, st),
                    daemon=True, name=f"drain-{node_id_hex[:8]}")
                st["_thread"] = thread
                self._drains[node_id_hex] = st
                # Placement stops BEFORE the coordinator starts: from
                # here every death on the node is drain-attributed.
                self._draining_nodes.add(node_id_hex)
                self.node_registry.set_draining(node_id_hex, True)
                thread.start()
        thread = st.get("_thread")
        if wait and thread is not None:
            thread.join(float(deadline_s) + 10.0)
        return self.drain_status(node_id_hex)

    def drain_status(self, node_id_hex: Optional[str] = None):
        """Snapshot of one drain (dict or None) or all drains keyed by
        node id."""
        def _pub(st):
            return {k: v for k, v in st.items()
                    if not k.startswith("_")}
        with self._drain_lock:
            if node_id_hex is not None:
                st = self._drains.get(node_id_hex)
                return _pub(st) if st is not None else None
            return {n: _pub(st) for n, st in self._drains.items()}

    def _on_drain_status(self, payload: dict):
        """DRAIN_STATUS from the draining daemon (ack/progress)."""
        node = payload.get("node_id")
        with self._drain_lock:
            st = self._drains.get(node)
            if st is not None:
                st["daemon_ack"] = True

    def _drain_worker(self, node_hex: str, st: dict):
        deadline = time.monotonic() + float(st["deadline_s"])

        def remaining() -> float:
            return deadline - time.monotonic()

        ok = True
        try:
            # Phase 1 — daemon notice (oneway; its DRAIN_STATUS reply
            # flips daemon_ack). A daemon that dies right here (the
            # drain-vs-SIGKILL race) degrades to node-death semantics
            # via _on_daemon_lost.
            handle = self.head_server.daemons.get(node_hex)
            if handle is not None and handle.alive:
                try:
                    handle.send(P.DRAIN_NODE, {
                        "node_id": node_hex,
                        "deadline_s": st["deadline_s"]})
                except Exception:  # lint: broad-except-ok dying daemon pipe; loss path owns it
                    pass
            # Phase 2 — serve replicas: out of routing first, in-flight
            # requests complete, then stop (zero failed requests).
            ok = self._drain_serve_replicas(node_hex, st, remaining) \
                and ok
            # Phase 3 — running (non-actor) tasks finish; no new ones
            # can land (placement already filtered).
            ok = self._drain_wait_tasks(node_hex, st, remaining) and ok
            # Phase 4 — migrate dedicated actors: kill their workers;
            # the drain-aware death path restarts them elsewhere
            # without charging max_restarts, and in-flight calls (both
            # planes) requeue uncharged.
            ok = self._drain_migrate_actors(node_hex, st, remaining) \
                and ok
            # Phase 5 — re-home primary object copies (last: nothing
            # produces on the node anymore).
            ok = self._drain_rehome_objects(node_hex, st, remaining) \
                and ok
        except Exception as e:  # lint: broad-except-ok coordinator thread must always settle the status
            ok = False
            st["error"] = repr(e)
        entry = self.node_registry.get(node_hex)
        if entry is None or not entry.alive:
            st["state"] = "NODE_DIED"
        elif ok:
            st["state"] = "DRAINED"
        else:
            st["state"] = "DEADLINE_EXCEEDED"
        if telemetry.enabled:
            telemetry.record_drain_progress(
                node_hex, max(0, st["objects_remaining"]),
                max(0, st["tasks_remaining"]), 0)

    def _drain_serve_replicas(self, node_hex: str, st: dict,
                              remaining) -> bool:
        """Ask the serve controller (if any) to drain the node's
        replicas: long-poll routing update first, queues empty, then
        stop; the controller's reconcile starts replacements off-node."""
        from ..api import get, get_actor
        try:
            ctrl = get_actor("SERVE_CONTROLLER")
        except Exception:  # lint: broad-except-ok no controller registered == serve not running; nothing to drain
            return True
        try:
            budget = max(1.0, remaining())
            drained = get(ctrl.drain_node.remote(node_hex),
                          timeout=budget)
            st["replicas_drained"] = int(drained or 0)
            return True
        except Exception as e:  # lint: broad-except-ok controller may be mid-teardown; drain degrades
            st["error"] = f"serve drain: {e!r}"
            return remaining() > 0

    def _drain_wait_tasks(self, node_hex: str, st: dict,
                          remaining) -> bool:
        """Wait for the node's running plain tasks to finish under the
        budget (dedicated actors migrate in the next phase)."""
        while True:
            handle = self.head_server.daemons.get(node_hex)
            if handle is None or not handle.alive:
                return False
            n = sum(len(p.running) for p in list(handle.proxies.values())
                    if p.alive and p.dedicated_actor is None)
            st["tasks_remaining"] = n
            if telemetry.enabled:
                telemetry.record_drain_progress(
                    node_hex, max(0, st["objects_remaining"]), n, 0)
            if n == 0:
                return True
            if remaining() <= 0:
                return False
            time.sleep(0.05)

    def _drain_migrate_actors(self, node_hex: str, st: dict,
                              remaining) -> bool:
        """Kill the node's dedicated-actor workers; the drain-attributed
        death path reschedules each actor off-node without charging its
        restart budget. Waits until the deaths are processed."""
        handle = self.head_server.daemons.get(node_hex)
        if handle is None or not handle.alive:
            return False
        victims = [p for p in list(handle.proxies.values())
                   if p.alive and p.dedicated_actor is not None]
        for p in victims:
            try:
                p.kill()
            except Exception:  # lint: broad-except-ok worker already gone; death path owns it
                pass
        # Wait for death_handled, NOT `alive`: kill() flips alive
        # optimistically at send time, but the drain-attributed restart
        # only runs once the daemon reports WORKER_DIED. If the daemon
        # was SIGKILLed instead (the drain-vs-kill race), that report
        # never comes — the node-loss path eventually fails the proxies
        # (charged, NODE_DIED), which is exactly the degradation the
        # protocol promises.
        while not all(p.death_handled for p in victims):
            if remaining() <= 0:
                return False
            time.sleep(0.05)
        return True

    def _drain_rehome_objects(self, node_hex: str, st: dict,
                              remaining) -> bool:
        """Re-home every primary copy whose only location is the
        draining node: push to a live peer daemon (LOCALIZE_OBJECT)
        when one exists, else pull into the head store, then swap the
        directory location. Loops until the node holds no primaries.
        Each object is incref-pinned for the copy so a concurrent free
        can't race the transfer (symmetric decref keeps the refdebug
        ledger conserved)."""
        head_hex = self.node_id.hex()
        while True:
            prim = self.gcs.objects.primaries_on_node(node_hex)
            st["objects_remaining"] = len(prim)
            if telemetry.enabled:
                telemetry.record_drain_progress(
                    node_hex, len(prim), max(0, st["tasks_remaining"]),
                    0)
            if not prim:
                return True
            if remaining() <= 0:
                return False
            peers = [h for h in self.head_server.all_daemons()
                     if h.alive
                     and h.node_id_hex not in self._draining_nodes]  # lint: guarded-by-ok racy membership read: a stale miss rehomes onto a draining peer, which the drain's own rehome pass then moves again
            for i, (oid, size) in enumerate(prim):
                if remaining() <= 0:
                    return False
                self.gcs.objects.incref(oid)
                try:
                    new_loc = None
                    if peers:
                        peer = peers[i % len(peers)]
                        try:
                            peer.request(
                                P.LOCALIZE_OBJECT,
                                {"object_id": oid, "node": node_hex},
                                timeout=max(1.0, remaining()))
                            new_loc = (P.LOC_SHM, size,
                                       peer.node_id_hex)
                        except Exception:  # lint: broad-except-ok peer push failed; head pull below
                            new_loc = None
                    if new_loc is None:
                        self._ensure_local(oid, node_hex)
                        new_loc = (P.LOC_SHM, size, head_hex)
                    self.gcs.objects.relocate(oid, node_hex, new_loc)
                except Exception:  # lint: broad-except-ok freed/lost mid-copy; next pass re-checks
                    pass
                finally:
                    self.gcs.objects.decref(oid)

    def _all_worker_handles(self):
        handles = list(self.pool.workers.values())
        handles.extend(self.head_server.all_proxies())
        return handles

    def _ensure_ready(self, oid: ObjectID,
                      timeout: Optional[float]) -> gcs_mod.ObjectEntry:
        deadline = None if timeout is None else time.monotonic() + timeout
        for _attempt in range(4):
            entry = self.gcs.objects.entry(oid)
            if entry is None:
                raise ObjectLostError(oid.hex())
            remaining = None if deadline is None else max(
                0.0, deadline - time.monotonic())
            if not entry.event.wait(remaining):
                raise GetTimeoutError(
                    f"Get timed out on object {oid.hex()}")
            if entry.state == gcs_mod.LOST:
                # Lineage reconstruction (reference: ObjectRecoveryManager,
                # object_recovery_manager.h:38): resubmit the producing task.
                if entry.lineage is None:
                    raise ObjectLostError(oid.hex())
                self._resubmit_for_recovery(entry.lineage)
                continue
            return entry
        raise ObjectLostError(oid.hex(), "reconstruction attempts exhausted")

    def _resubmit_for_recovery(self, spec: P.TaskSpec, _depth: int = 0):
        # Guard + register atomically: concurrent getters woken by the
        # same node loss must not double-submit the producing task.
        with self._recovery_lock:
            entries = [self.gcs.objects.entry(rid)
                       for rid in spec.return_ids]
            if entries and all(e is not None
                               and e.state == gcs_mod.PENDING
                               for e in entries):
                return
            for rid in spec.return_ids:
                self.gcs.objects.register_pending(rid, spec)
        # Recursively recover LOST arguments first (reference:
        # ObjectRecoveryManager walks the lineage of missing deps).
        if _depth < 16:
            for a in list(spec.args) + list(spec.kwargs.values()):
                if a.kind == "ref":
                    e = self.gcs.objects.entry(a.object_id)
                    if (e is not None and e.state == gcs_mod.LOST
                            and e.lineage is not None):
                        self._resubmit_for_recovery(e.lineage, _depth + 1)
        unresolved = self._unresolved_deps(spec)
        self.scheduler.submit(spec, unresolved)

    def get(self, object_ids: List[ObjectID],
            timeout: Optional[float] = None) -> List[Any]:
        # One overall deadline for the whole call, not per object.
        deadline = None if timeout is None else time.monotonic() + timeout
        entries = []
        for oid in object_ids:
            remaining = None if deadline is None else max(
                0.0, deadline - time.monotonic())
            entries.append(self._ensure_ready(oid, remaining))
        return [self._read_ready(oid, e.location, deadline)
                for oid, e in zip(object_ids, entries)]

    def _read_ready(self, oid: ObjectID, location: Tuple,
                    deadline: Optional[float]) -> Any:
        """Read a ready object. Its only copy may die with its node
        between the get's readiness check and the pull; once the head
        has handled that death the entry is LOST (rebuilt from its
        lineage) or re-pointed at a head copy, and is read again."""
        for _attempt in range(4):
            try:
                return self._read_location(oid, location)
            except ObjectLostError:
                if not self._await_source_death(oid, location, deadline):
                    raise
            remaining = None if deadline is None else max(
                0.0, deadline - time.monotonic())
            location = self._ensure_ready(oid, remaining).location
        raise ObjectLostError(oid.hex(), "reconstruction attempts exhausted")

    def _await_source_death(self, oid: ObjectID, location: Tuple,
                            deadline: Optional[float]) -> bool:
        """True once the head has handled the death of the node that
        held ``location`` and the entry no longer points there. False
        when the location is not another node's copy or the node is
        alive: a failed pull from a live node is the caller's error."""
        if (location[0] != P.LOC_SHM or len(location) < 3
                or location[2] == self.node_id.hex()
                or self.transfer_addr_of(location[2]) is not None):
            return False
        from .config import ray_config
        # At most the head's own window for declaring a node dead.
        until = time.monotonic() + (
            float(ray_config.node_heartbeat_s)
            * float(ray_config.node_heartbeat_miss_limit))
        if deadline is not None:
            until = min(until, deadline)
        while True:
            entry = self.gcs.objects.entry(oid)
            if (entry is None or entry.state != gcs_mod.READY
                    or entry.location != location):
                return entry is not None
            if time.monotonic() >= until:
                return False
            time.sleep(0.01)

    def get_locations(self, object_ids: List[ObjectID],
                      timeout: Optional[float] = None) -> List[Tuple]:
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for oid in object_ids:
            remaining = None if deadline is None else max(
                0.0, deadline - time.monotonic())
            out.append(self._ensure_ready(oid, remaining).location)
        return out

    def wait(self, object_ids: List[ObjectID], num_returns: int,
             timeout: Optional[float], fetch_local: bool = True):
        if num_returns > len(object_ids):
            raise ValueError(
                f"num_returns ({num_returns}) exceeds the number of "
                f"objects waited on ({len(object_ids)})")
        if num_returns < 1:
            raise ValueError("num_returns must be >= 1")
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._ready_cond:
            while True:
                ready = []
                for oid in object_ids:
                    e = self.gcs.objects.entry(oid)
                    if e is None or not e.event.is_set():
                        continue
                    if e.state == gcs_mod.LOST:
                        # Not fetchable: kick lineage reconstruction
                        # (idempotent) and report not-ready until it
                        # lands; no lineage -> "ready" (get raises
                        # ObjectLostError immediately).
                        if e.lineage is not None:
                            self._resubmit_for_recovery(e.lineage)
                            continue
                    ready.append(oid)
                if len(ready) >= num_returns:
                    ready = ready[:num_returns]
                    break
                remaining = None if deadline is None else \
                    deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    break
                self._ready_cond.wait(
                    timeout=remaining if remaining is not None else 1.0)
        ready_set = set(ready)
        not_ready = [oid for oid in object_ids if oid not in ready_set]
        return ready, not_ready

    def _is_object_ready(self, oid: ObjectID) -> bool:
        e = self.gcs.objects.entry(oid)
        return (e is not None and e.event.is_set()
                and e.state != gcs_mod.LOST)

    def _arg_locality(self, spec) -> Dict[str, int]:
        """Bytes of `spec`'s by-ref args per holder node — the
        scheduler's locality signal (reference: LocalityDataProviderInterface
        feeding LocalityAwareLeasePolicy, lease_policy.cc:38-58). Inline
        and pending args contribute nothing."""
        out: Dict[str, int] = {}
        args = list(spec.args or [])
        if getattr(spec, "kwargs", None):
            args.extend(spec.kwargs.values())
        seen: Set[bytes] = set()  # a ref passed N times is pulled once
        for a in args:
            oids = []
            if getattr(a, "kind", None) == "ref" and a.object_id is not None:
                oids.append(a.object_id)
            # Refs nested inside by-value args are pull dependencies too
            # (the dispatch path pins + localizes them the same way).
            oids.extend(getattr(a, "nested_ids", None) or ())
            for oid in oids:
                key = oid.binary()
                if key in seen:
                    continue
                seen.add(key)
                loc = self._tag_local_loc(self.gcs.objects.location(oid))
                if loc is not None and loc[0] == P.LOC_SHM:
                    out[loc[2]] = out.get(loc[2], 0) + int(loc[1])
        return out

    def incref(self, oid: ObjectID):
        self.gcs.objects.incref(oid)

    def decref(self, oid: ObjectID):
        if not self._shutdown:
            self.gcs.objects.decref(oid)

    def _on_object_ready(self, oid: ObjectID):
        self.scheduler.notify_object_ready(oid)
        self._flush_actor_dep_waiters(oid)
        with self._ready_cond:
            self._ready_cond.notify_all()

    def _on_objects_freed(self, freed: List[Tuple[ObjectID, str]]):
        shm_oids = []
        for oid, loc_kind in freed:
            # Only LOC_SHM objects have a segment to unlink/unmap; inline
            # values, error blobs, and never-produced pending objects have
            # no backing anywhere (skipping their broadcast is the
            # task-throughput hot path — one freed return per task would
            # otherwise fan out to every worker).
            if loc_kind != P.LOC_SHM:
                continue
            self.store.free(oid)
            shm_oids.append(oid)
        if shm_oids:
            with self._release_lock:
                flush = not self._release_buf
                self._release_buf.extend(shm_oids)
            if flush:
                # Coalesce: one broadcast drains everything buffered
                # since the last one (release storms during dataset
                # sweeps become a handful of messages per worker).
                self._handler_pool.submit(self._broadcast_releases)

    def _broadcast_releases(self):
        from .config import ray_config
        time.sleep(float(ray_config.release_broadcast_delay_s))
        with self._release_lock:
            batch, self._release_buf = self._release_buf, []
        if not batch:
            return
        for h in list(self.pool.workers.values()):
            if h.alive:
                try:
                    h.send(P.RELEASE_OBJECTS, {"object_ids": batch})
                except Exception:
                    pass
        # Remote nodes free their local copies (and relay to their
        # workers) — the daemon handles P.RELEASE_OBJECTS itself.
        self.head_server.broadcast(P.RELEASE_OBJECTS,
                                   {"object_ids": batch})

    # ------------------------------------------------------------------
    # task submission (owner side)
    # ------------------------------------------------------------------
    def register_function(self, fn_id: str, blob: bytes):
        self._fn_registry.setdefault(fn_id, blob)

    def _pin_task_args(self, spec) -> None:
        """Pin ref arguments (top-level and nested inside values) for the
        task's lifetime so a caller dropping its ObjectRef before dispatch
        can't free an argument out from under the task (reference:
        ReferenceCounter submitted-task references, reference_count.h:66)."""
        for a in list(spec.args) + list(spec.kwargs.values()):
            if a.kind == "ref":
                self.gcs.objects.incref(a.object_id)
            for oid in a.nested_ids:
                self.gcs.objects.incref(oid)

    def _unpin_task_args(self, spec) -> None:
        for a in list(spec.args) + list(spec.kwargs.values()):
            if a.kind == "ref":
                self.gcs.objects.decref(a.object_id)
            for oid in a.nested_ids:
                self.gcs.objects.decref(oid)

    def _unresolved_deps(self, spec: P.TaskSpec) -> Set[ObjectID]:
        unresolved = set()
        args = list(spec.args) + list(spec.kwargs.values())
        for a in args:
            if a.kind == "ref":
                e = self.gcs.objects.entry(a.object_id)
                if (e is None or e.state == gcs_mod.LOST
                        or not e.event.is_set()):
                    unresolved.add(a.object_id)
        return unresolved

    # The head owns the submit-time incref of a task's return ids (one
    # fused gcs pass instead of a per-ref incref from the ObjectRef
    # constructor); api._make_return_refs skips its per-ref incref and
    # marks the refs owned, so dropping them balances (the same
    # contract WorkerClient has always used for nested submissions).
    head_increfs_returns = True

    def submit_task(self, spec: P.TaskSpec):
        if spec.fn_blob is not None:
            self.register_function(spec.fn_id, spec.fn_blob)
        self._pin_task_args(spec)
        self.gcs.objects.register_submitted(spec.return_ids, spec,
                                            incref_delta=1)
        self.gcs.record_task_event({
            "task_id": spec.task_id.hex(), "name": spec.name,
            "state": "PENDING_SCHEDULING", "attempt": 1,
            "ts": time.time()})
        self.scheduler.submit(spec, self._unresolved_deps(spec))

    def _resolve_arg_locations(self, spec) -> None:
        for a in list(spec.args) + list(spec.kwargs.values()):
            if a.kind == "ref":
                a.location = self.gcs.objects.location(a.object_id)

    def _attempt_of(self, spec) -> int:
        """1-based attempt number from the head's retry ledger."""
        try:
            return self._retries_used.get(spec.task_id.binary(), 0) + 1
        except AttributeError:
            return 1

    def _node_hex_of(self, worker) -> str:
        return getattr(worker, "node_id_hex", None) or self.node_id.hex()

    def _register_error_returns(self, spec, blob: bytes) -> None:
        """Register a terminal error on every return id AND push it to
        a nested spec's submitter — every failure path that ends a
        worker-submitted task must unblock its submitter's local wait
        (the forwarding analogue of "errors surface on the ref")."""
        for rid in spec.return_ids:
            self.gcs.objects.register_ready(rid, (P.LOC_ERROR, blob))
        if self._fwd_on and getattr(spec, "_submitter_wid", None) \
                is not None:
            self._forward_spec_results(
                spec, [(P.LOC_ERROR, blob)] * len(spec.return_ids))

    def _dispatch(self, spec, worker: Optional[WorkerHandle]):
        """Scheduler callback: ship a ready task/actor-creation to a worker."""
        # The submit-time stamp must not ride the spec onto the wire (a
        # dynamic attr would demote every spec off the slim-pickle fast
        # path); pop it here whether or not telemetry is on.
        t_submit = spec.__dict__.pop("_t_submit", None)
        if isinstance(spec, P.ActorSpec):
            self._dispatch_actor_creation(spec, worker)
            return
        if telemetry.enabled and t_submit is not None:
            telemetry.record_dispatch_latency(time.monotonic() - t_submit)
        if worker is None:
            env_err = getattr(spec, "_env_error", None)
            err = env_err if env_err is not None else \
                TaskUnschedulableError(
                    f"Task {spec.name} demands {spec.resources}, which "
                    f"exceeds cluster totals "
                    f"{self.node_registry.aggregate()[0]}")
            blob = serialization.dumps(err)
            self._register_error_returns(spec, blob)
            self._unpin_task_args(spec)
            return
        self._resolve_arg_locations(spec)
        worker.running[spec.task_id.binary()] = spec
        worker.last_dispatch_ts = time.time()
        self.gcs.record_task_event({
            "task_id": spec.task_id.hex(), "name": spec.name,
            "state": "SUBMITTED", "worker_id": worker.worker_id.hex(),
            "node_id": self._node_hex_of(worker),
            "attempt": self._attempt_of(spec), "ts": time.time()})
        try:
            # Blob handling without rebuilding the dataclass (hot path):
            # swap the field around the pickle. dispatch_lock makes
            # {cache check -> send} atomic per worker — with pipelining
            # two threads can dispatch to one worker, and a
            # blob-stripped frame must not overtake the blob-carrying
            # one that populated the cache.
            with worker.dispatch_lock:
                blob_swap = False
                if spec.fn_id in worker.fn_cache:
                    if spec.fn_blob is not None:
                        saved_blob, spec.fn_blob, blob_swap = \
                            spec.fn_blob, None, True
                else:
                    if spec.fn_blob is None:
                        saved_blob, blob_swap = None, True
                        spec.fn_blob = self._fn_registry.get(spec.fn_id)
                    worker.fn_cache.add(spec.fn_id)
                try:
                    worker.send(P.EXEC_TASK, {"spec": spec})
                finally:
                    if blob_swap:
                        spec.fn_blob = saved_blob
                        blob_swap = False
        except Exception as send_err:
            # The atomic pop decides which failure path owns this spec:
            # the worker-death handler may race us here (send fails
            # BECAUSE the worker died), and exactly one of us must
            # release + resubmit. (Blob restore already ran in the
            # inner finally.) Non-IO errors here are DISPATCHER bugs,
            # not worker deaths — without the log they masquerade as
            # crashed workers through the retry path.
            if not isinstance(send_err, (OSError, EOFError, ValueError)):
                import logging
                logging.getLogger(__name__).warning(
                    "dispatch of %s failed pre-send: %r",
                    spec.name, send_err)
            owned = worker.running.pop(spec.task_id.binary(),
                                       None) is not None
            if owned:
                self.scheduler.note_task_finished(spec, worker)
                self._handle_worker_failure_for_task(spec)

    def _on_gen_item(self, handle: WorkerHandle, payload: dict):
        """One streamed item landed (reference: TaskManager handling of
        dynamically created return objects)."""
        from .ids import object_id_for_return

        task_id: TaskID = payload["task_id"]
        oid = object_id_for_return(task_id, payload["index"])
        # Lineage: the producing spec (from the worker's running table)
        # makes items cancellable/recoverable like normal returns.
        spec = handle.running.get(task_id.binary())
        self._register_result_loc(oid, payload["loc"], spec,
                                  payload.get("nested") or [])
        with self._gen_lock:
            st = self._gen_stream_state(task_id)
            st["count"] = max(st["count"], payload["index"] + 1)
            abandoned = st.get("abandoned", False)
            self._gen_cond.notify_all()
        if abandoned:
            self.gcs.objects.decref(oid)

    def _gen_stream_state(self, task_id: TaskID) -> dict:
        """Callers hold self._gen_lock."""
        return self._gen_streams.setdefault(
            task_id.binary(), {"count": 0, "finished": False,
                               "error": None, "callbacks": []})

    def supports_streaming(self) -> bool:
        """The driver consumes streams from its own stream state; the
        worker-side counterpart (WorkerClient) requires the direct
        plane (channel streams, head-routed fallback via gcs ops)."""
        return True

    def gen_wait(self, task_id: TaskID, index: int,
                 timeout: Optional[float] = None):
        """Block until item `index` of a streaming task exists or the
        stream ends. Returns (available: bool, finished_count or None,
        error_blob or None)."""
        deadline = None if timeout is None else time.time() + timeout
        with self._gen_lock:
            while True:
                st = self._gen_streams.get(task_id.binary())
                if st is not None:
                    # Items yielded before a failure stay readable; the
                    # error surfaces only once the consumer passes them
                    # (reference: generator items are normal objects,
                    # the exception lands at the failure point).
                    if index < st["count"]:
                        return True, None, None
                    if st["error"] is not None:
                        return False, st["count"], st["error"]
                    if st["finished"]:
                        return False, st["count"], None
                remaining = None if deadline is None \
                    else deadline - time.time()
                if remaining is not None and remaining <= 0:
                    raise GetTimeoutError(
                        f"Timed out waiting for streamed item {index} of "
                        f"task {task_id.hex()}")
                self._gen_cond.wait(timeout=remaining)

    def _finish_gen_stream(self, task_id: TaskID, count: Optional[int],
                           error: Optional[bytes]):
        with self._gen_lock:
            st = self._gen_stream_state(task_id)
            if count is not None:
                st["count"] = max(st["count"], count)
            st["finished"] = True
            if error is not None:
                st["error"] = error
            callbacks, st["callbacks"] = list(st.get("callbacks", ())), []
            if st.get("abandoned"):
                self._gen_streams.pop(task_id.binary(), None)
            self._gen_cond.notify_all()
        for cb in callbacks:
            try:
                cb()
            except Exception:  # lint: broad-except-ok user callback; stream completion must reach every waiter
                logger.debug("gen-stream done-callback for %s raised",
                             task_id.hex()[:8], exc_info=True)

    def gen_add_done_callback(self, task_id: TaskID, cb) -> None:
        """Invoke `cb()` when the stream finishes (now if already done)."""
        with self._gen_lock:
            st = self._gen_stream_state(task_id)
            if not st["finished"]:
                st["callbacks"].append(cb)
                return
        cb()

    def gen_release(self, task_id: TaskID, consumed: int) -> None:
        """Consumer dropped its ObjectRefGenerator: free unconsumed items
        (registered but never wrapped in an ObjectRef, so no other decref
        will ever come) and drop the stream state. A still-running stream
        is marked abandoned so later items are freed on arrival."""
        from .ids import object_id_for_return

        with self._gen_lock:
            st = self._gen_streams.get(task_id.binary())
            if st is None:
                return
            count = st["count"]
            finished = st["finished"]
            if finished:
                self._gen_streams.pop(task_id.binary(), None)
            else:
                st["abandoned"] = True
        if not finished:
            # Nobody will ever consume this stream: cancel the producer
            # (an unbounded generator would otherwise run forever — e.g.
            # a token stream whose HTTP client disconnected).
            self._cancel_running_task(task_id)
        for i in range(consumed, count):
            oid = object_id_for_return(task_id, i)
            if self.gcs.objects.entry(oid) is not None:
                self.gcs.objects.decref(oid)

    def _cancel_running_task(self, task_id: TaskID) -> None:
        self._cancel_requested.add(task_id.binary())
        if self.scheduler.try_cancel(task_id):
            return
        for h in self._all_worker_handles():
            if task_id.binary() in h.running:
                try:
                    h.send(P.CANCEL_TASK, {"task_id": task_id})
                except Exception:
                    pass
                return

    def _loc_is_local(self, loc) -> bool:
        return len(loc) < 3 or loc[2] == self.node_id.hex()

    def _push_idle(self, handle):
        """Return a worker to ITS node's idle pool (remote workers belong
        to their daemon, not the head pool)."""
        if getattr(handle, "is_remote", False):
            handle.daemon.push_idle(handle)
        else:
            self.pool.push_idle(handle)

    def _on_tasks_recalled(self, handle: WorkerHandle, tids: list):
        """A blocked worker evacuated queued pipelined tasks: return
        their lease slots and put them back on the scheduler queue so
        any other worker (or this one, once unblocked) can take them."""
        for tid in tids:
            spec = handle.running.pop(tid, None)
            if spec is None:
                continue  # completed/cancelled concurrently
            if self.scheduler.note_task_finished(spec, handle):
                # Rare but real: the blocked head completed before the
                # recall landed, so this recall drained the lease — the
                # worker must rejoin the idle pool or it leaks.
                self._push_idle(handle)
            self.scheduler.submit(spec, self._unresolved_deps(spec))
        self.scheduler.notify_worker_free()

    def _on_task_done(self, handle: WorkerHandle, payload: dict):
        task_id: TaskID = payload["task_id"]
        spec = handle.running.pop(task_id.binary(), None)
        # A reconcile-requeued direct call that ran to completion keeps
        # its normal accounting: drop the (rare) prepaid marker so it
        # cannot linger and grant a later death an uncharged attempt.
        if self._direct_prepaid:
            self._direct_prepaid.pop(task_id.binary(), None)
        is_actor_task = payload.get("actor_id") is not None
        if spec is not None and not is_actor_task:
            if self.scheduler.note_task_finished(spec, handle):
                # Lease drained (or per-task grant released): the worker
                # is genuinely idle again.
                self._push_idle(handle)
            # Keep the pipeline full without a dispatch-thread hop; the
            # notify still runs so the loop re-checks remaining slack.
            self.scheduler.dispatch_after_completion()
            self.scheduler.notify_worker_free()
        if spec is None:
            return
        if is_actor_task:
            st = self._actors.get(payload["actor_id"])
            if st is not None:
                with st.lock:
                    st.in_flight.discard(task_id.binary())
        error = payload.get("error")
        if spec.streaming:
            # Streaming tasks never retry: items already consumed can't
            # be replayed coherently, so a failure terminates the stream
            # with its error instead of re-running the generator.
            self._unpin_task_args(spec)
            self._finish_gen_stream(task_id, payload.get("streamed"),
                                    error)
            self._note_seq_settled(spec)
            self.gcs.record_task_event({
                "task_id": task_id.hex(), "name": spec.name,
                "state": "FAILED" if error is not None else "FINISHED",
                "worker_id": handle.worker_id.hex(),
                "node_id": self._node_hex_of(handle),
                "attempt": self._attempt_of(spec), "ts": time.time()})
            return
        if error is not None:
            if spec.retry_exceptions and self._retry_budget(spec):
                self._resubmit(spec)
                return
            self._unpin_task_args(spec)
            self._register_error_returns(spec, error)
            self._note_seq_settled(spec)
        else:
            self._unpin_task_args(spec)
            self._note_seq_settled(spec)
            nested_lists = payload.get("nested") or [[]] * len(
                spec.return_ids)
            fwd_locs = []
            for rid, loc, nested in zip(spec.return_ids,
                                        payload["results"], nested_lists):
                fwd_locs.append(self._register_result_loc(
                    rid, loc, spec, nested))
            if self._fwd_on and getattr(spec, "_submitter_wid", None) \
                    is not None:
                self._forward_spec_results(spec, fwd_locs)
        self.gcs.record_task_event({
            "task_id": task_id.hex(), "name": spec.name,
            "state": "FAILED" if error is not None else "FINISHED",
            "worker_id": handle.worker_id.hex(),
            "node_id": self._node_hex_of(handle),
            "attempt": self._attempt_of(spec), "ts": time.time()})

    def _retry_budget(self, spec: P.TaskSpec) -> bool:
        used = self._retries_used.get(spec.task_id.binary(), 0)
        if spec.max_retries < 0:
            # -1: retry forever (reference: max_retries=-1 /
            # max_task_retries=-1 documented infinite-retry semantics).
            # Still bump the ledger: attempt numbers on task events (and
            # the timeline's per-attempt span dedup) read it.
            self._retries_used[spec.task_id.binary()] = used + 1
            return True
        if used >= spec.max_retries:
            return False
        self._retries_used[spec.task_id.binary()] = used + 1
        return True

    def _resubmit(self, spec: P.TaskSpec):
        # Idempotence backstop: a failure signal that arrives after the
        # task's results already landed (the atomic worker.running pop
        # is the primary arbiter between concurrent failure paths; this
        # guards the late-signal case it can't see) must not re-run a
        # completed task — completion already unpinned the args and
        # registered the returns.
        entries = [self.gcs.objects.entry(rid) for rid in spec.return_ids]
        if entries and all(e is not None and e.event.is_set()
                           and e.state != gcs_mod.LOST for e in entries):
            return
        self.gcs.record_task_event({
            "task_id": spec.task_id.hex(), "name": spec.name,
            "state": "PENDING_SCHEDULING",
            "attempt": self._attempt_of(spec), "ts": time.time()})
        for rid in spec.return_ids:
            self.gcs.objects.register_pending(rid, spec)
        # Arguments lost with a dead node must be reconstructed, or the
        # retry parks in the scheduler's waiting queue forever (only
        # register_ready fires notify_object_ready).
        for a in list(spec.args) + list(spec.kwargs.values()):
            if a.kind == "ref":
                e = self.gcs.objects.entry(a.object_id)
                if (e is not None and e.state == gcs_mod.LOST
                        and e.lineage is not None):
                    self._resubmit_for_recovery(e.lineage)
        if spec.actor_id is not None and not isinstance(spec, P.ActorSpec):
            # Actor-task retry goes back onto ITS actor's ordered queue,
            # not the cluster scheduler (args stay pinned from the
            # original submission).
            st = self._actors.get(spec.actor_id)
            if st is None or st.dead:  # lint: guarded-by-ok GIL-atomic liveness snapshot: a stale False routes to the queue where the death path drains it
                blob = serialization.dumps(ActorDiedError(
                    f"Actor {spec.actor_id.hex()} died before task "
                    f"{spec.task_id.hex()} could be retried"))
                self._register_error_returns(spec, blob)
                self._unpin_task_args(spec)
                return
            self._enqueue_actor_task(st, spec)
            return
        self.scheduler.submit(spec, self._unresolved_deps(spec))

    # ------------------------------------------------------------------
    # actors
    # ------------------------------------------------------------------
    def create_actor(self, spec: P.ActorSpec):
        entry = self.gcs.actors.register(spec)
        st = _ActorState(spec)
        self._actors[spec.actor_id] = st
        self._pin_task_args(spec)
        unresolved = self._unresolved_deps(spec)
        if spec.lifetime == "detached":
            self._persist_detached(spec)
        self.scheduler.submit(spec, unresolved)
        return entry

    # ------------------------------------------------------------------
    # detached-actor persistence (reference: GCS fault tolerance —
    # gcs_client_reconnection_test.cc; actor table persisted so a
    # restarted GCS re-schedules actors whose processes are gone. Here
    # the head restart respawns detached actors from their persisted
    # specs; in-memory actor state follows the same
    # restart-after-node-failure semantics as the reference.)
    # ------------------------------------------------------------------
    _DETACHED_NS = "_detached_actors"

    def _kv_durable(self) -> bool:
        return isinstance(self.gcs.kv, gcs_mod.SqliteKvStore)

    def _persist_detached(self, spec: P.ActorSpec):
        if not self._kv_durable():
            return
        # ObjectRef arguments reference objects of THIS session — they
        # cannot resolve after a head restart, so such specs are not
        # recoverable (the respawn would park forever on dead deps).
        has_refs = any(
            a.kind == "ref" or a.nested_ids
            for a in list(spec.args) + list(spec.kwargs.values()))
        if has_refs:
            import warnings
            warnings.warn(
                f"Detached actor {spec.name or spec.actor_id.hex()} takes "
                f"ObjectRef arguments; it will NOT be respawned after a "
                f"head restart (refs don't survive the session).",
                stacklevel=3)
            return
        import cloudpickle
        try:
            self.gcs.kv.put(spec.actor_id.hex(), cloudpickle.dumps(spec),
                            namespace=self._DETACHED_NS)
        except Exception:  # lint: broad-except-ok persistence is best-effort; the actor still runs this session
            logger.debug("failed to persist detached actor %s",
                         spec.actor_id.hex()[:8], exc_info=True)

    def _unpersist_detached(self, actor_id: ActorID):
        if not self._kv_durable():
            return
        try:
            self.gcs.kv.delete(actor_id.hex(),
                               namespace=self._DETACHED_NS)
        except Exception:  # lint: broad-except-ok best-effort unpersist; a stale record is skipped on recovery
            logger.debug("failed to unpersist detached actor %s",
                         actor_id.hex()[:8], exc_info=True)

    def recover_detached_actors(self) -> int:
        """Respawn detached actors persisted by a previous head with the
        same RTT_GCS_STORAGE_PATH (called by api.init AFTER the
        runtime is registered as current, so actor creation can resolve
        argument refs). Returns the number respawned."""
        if not self._kv_durable():
            return 0
        import cloudpickle
        count = 0
        for key in self.gcs.kv.keys(namespace=self._DETACHED_NS):
            raw = self.gcs.kv.get(key, namespace=self._DETACHED_NS)
            if not raw:
                continue
            try:
                spec: P.ActorSpec = cloudpickle.loads(raw)
                if self.gcs.actors.get(spec.actor_id) is not None:
                    continue  # already alive in this session
                self.create_actor(spec)
                count += 1
            except Exception:
                import traceback
                print(f"[ray_tpu_torch] failed to respawn detached actor "
                      f"{key}:\n{traceback.format_exc()}",
                      flush=True)
                continue
        return count

    def _dispatch_actor_creation(self, spec: P.ActorSpec,
                                 worker: Optional[WorkerHandle]):
        st = self._actors[spec.actor_id]
        if worker is None:
            env_err = getattr(spec, "_env_error", None)
            err = env_err if env_err is not None else \
                TaskUnschedulableError(
                    f"Actor {spec.cls_id} demands {spec.resources}, "
                    f"which exceeds cluster totals "
                    f"{self.node_registry.aggregate()[0]}")
            blob = serialization.dumps(err)
            self._fail_actor(st, blob, "infeasible resources"
                             if env_err is None else "env setup failed")
            self._unpin_task_args(spec)
            return
        worker.dedicated_actor = spec.actor_id
        with st.lock:
            st.worker = worker
        self._resolve_arg_locations(spec)
        try:
            worker.send(P.CREATE_ACTOR, {"spec": spec})
        except Exception:
            self._fail_actor(st, serialization.dumps(
                ActorDiedError("actor worker died during creation")),
                "worker send failed")

    def _on_actor_ready(self, handle: WorkerHandle, payload: dict):
        actor_id = payload["actor_id"]
        st = self._actors.get(actor_id)
        if st is None:
            return
        error = payload.get("error")
        self._unpin_task_args(st.spec)
        if error is not None:
            self._fail_actor(st, error, "creation failed")
            handle.kill()  # death callback releases resources
            return
        self.gcs.actors.set_alive(actor_id, handle.worker_id)
        with st.lock:
            st.ready = True
        self._flush_actor_queue(st)

    def _fail_actor(self, st: _ActorState, error_blob: bytes, cause: str):
        # Whatever killed the actor (unschedulable restart, env setup,
        # worker crash), method calls must surface a DETERMINISTIC typed
        # error: ActorDiedError carrying the underlying cause
        # (reference: ActorDiedError wraps the creation task error) —
        # not the raw cause type, which varies with submission timing.
        try:
            err = serialization.loads(error_blob)
        except Exception:
            err = None
        if not isinstance(err, (ActorDiedError, ActorError)):
            error_blob = serialization.dumps(ActorDiedError(
                f"Actor {st.spec.actor_id.hex()} died ({cause}): "
                f"{err!r}"))
        self.gcs.actors.set_dead(st.spec.actor_id, cause,
                                 creation_error=error_blob)
        if st.spec.lifetime == "detached":
            self._unpersist_detached(st.spec.actor_id)
        with st.lock:
            st.dead = True
            pending = list(st.queue)
            st.queue.clear()
        for item in pending:
            if item[0].streaming:
                self._finish_gen_stream(item[0].task_id, None, error_blob)
            self._register_error_returns(item[0], error_blob)
            self._unpin_task_args(item[0])
            self._note_seq_settled(item[0])

    def submit_actor_task(self, spec: P.TaskSpec):
        st = self._actors.get(spec.actor_id)
        entry = self.gcs.actors.get(spec.actor_id)
        if st is None or entry is None:
            raise ValueError(f"Unknown actor {spec.actor_id}")
        self.gcs.objects.register_submitted(spec.return_ids, spec,
                                            incref_delta=1)
        if st.dead:  # lint: guarded-by-ok GIL-atomic liveness snapshot: a stale False enqueues onto a queue the death path is about to drain
            blob = entry.creation_error or serialization.dumps(
                ActorDiedError(f"Actor {spec.actor_id.hex()} is dead "
                               f"({entry.death_cause})"))
            if spec.streaming:
                self._finish_gen_stream(spec.task_id, None, blob)
            self._register_error_returns(spec, blob)
            self._note_seq_settled(spec)
            return
        if spec.max_retries == -2:
            # Per-call budget unset: inherit the actor's max_task_retries
            # (reference: actor method retries default to the actor
            # option, core_worker task retry path). -1 = infinite; an
            # explicit per-call 0 disables retries.
            spec.max_retries = int(
                getattr(st.spec, "max_task_retries", 0) or 0)
        self._pin_task_args(spec)
        self._enqueue_actor_task(st, spec)

    def _enqueue_actor_task(self, st: "_ActorState", spec: P.TaskSpec,
                            front: bool = False):
        """Queue an (already-pinned) actor task and flush when its deps
        resolve — shared by first submission and retries. `front` puts
        retried in-flight tasks BEFORE already-queued ones so the
        restarted actor preserves per-actor submission order. STAMPED
        specs (cross-plane sequencing) requeue by ORDERED INSERT
        instead: a reconcile- or restart-requeued call lands before any
        queued call from the same caller with a higher sequence number,
        so the head pipe delivers one caller's calls in seq order and
        the callee merge gate only ever waits on cross-plane arrivals."""
        unresolved = self._unresolved_deps(spec)
        item = [spec, unresolved]
        stamped = getattr(spec, "caller_seq", -1) >= 0 \
            and getattr(spec, "caller_id", None) is not None
        with st.lock:
            if racedebug.enabled:
                racedebug.access(st, "queue", write=True)
            if stamped and (front or any(
                    it[0].caller_id == spec.caller_id
                    for it in st.queue)):
                idx = None
                for i, it in enumerate(st.queue):
                    if (it[0].caller_id == spec.caller_id
                            and it[0].caller_seq > spec.caller_seq):
                        idx = i
                        break
                if idx is None:
                    st.queue.append(item)
                else:
                    st.queue.insert(idx, item)
            elif front:
                st.queue.appendleft(item)
            else:
                st.queue.append(item)
        if unresolved:
            with self._actor_dep_lock:
                for oid in unresolved:
                    self._actor_dep_waiters.setdefault(oid, []).append(
                        (st, item))
            # Close the check-then-register race (a dep may have become
            # ready between the snapshot and waiter registration).
            for oid in list(unresolved):
                if self._is_object_ready(oid):
                    with self._actor_dep_lock:
                        item[1].discard(oid)
        self._flush_actor_queue(st)

    def _flush_actor_dep_waiters(self, oid: ObjectID):
        with self._actor_dep_lock:
            waiters = self._actor_dep_waiters.pop(oid, None)
        if not waiters:
            return
        states = []
        for st, item in waiters:
            item[1].discard(oid)
            if not item[1] and st not in states:
                states.append(st)
        for st in states:
            self._flush_actor_queue(st)

    def _flush_actor_queue(self, st: _ActorState):
        """Send head-of-line tasks whose deps are resolved, preserving
        submission order (reference: sequential_actor_submit_queue.cc)."""
        to_send = []
        with st.lock:
            if racedebug.enabled:
                racedebug.access(st, "queue", write=True)
            if not st.ready or st.dead or st.worker is None:
                return
            while st.queue and not st.queue[0][1]:
                spec, _ = st.queue.popleft()
                st.in_flight.add(spec.task_id.binary())
                to_send.append(spec)
            worker = st.worker
        for spec in to_send:
            self._resolve_arg_locations(spec)
            worker.running[spec.task_id.binary()] = spec
            try:
                worker.send(P.EXEC_TASK, {"spec": spec})
            except Exception:
                pass  # death path handles in-flight failures
            if not worker.alive:
                # The death path may have drained worker.running BEFORE
                # our insert (flush raced the death callback): whoever
                # pops the spec owns it. Re-queue at the FRONT without
                # re-flushing (no retry burned, no recursion into the
                # same dead handle) — the death path / restart
                # completion flushes the queue later. Only if the actor
                # is already terminally dead do we fail the call here.
                if worker.running.pop(spec.task_id.binary(),
                                      None) is not None:
                    with st.lock:
                        dead = st.dead
                        if not dead:
                            st.in_flight.discard(spec.task_id.binary())
                            st.queue.appendleft([spec, set()])
                        # A restart may ALREADY have produced a fresh
                        # worker; flushing to it is safe (its own death
                        # path guards it) and nothing else would.
                        refetch = (not dead and st.ready
                                   and st.worker is not None
                                   and st.worker is not worker)
                    if dead:
                        blob = serialization.dumps(ActorDiedError(
                            f"Actor {spec.actor_id.hex()}'s worker "
                            f"died before the call could run"))
                        if spec.streaming:
                            self._finish_gen_stream(
                                spec.task_id, None, blob)
                        self._register_error_returns(spec, blob)
                        self._unpin_task_args(spec)
                    elif refetch:
                        self._flush_actor_queue(st)

    def get_actor(self, name: str, namespace: Optional[str] = None):
        entry = self.gcs.actors.get_by_name(name,
                                            namespace or self.namespace)
        if entry is None or entry.state == gcs_mod.ACTOR_DEAD:
            raise ValueError(f"Failed to look up actor '{name}'")
        return entry.spec

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        st = self._actors.get(actor_id)
        if st is None:
            return
        with st.lock:
            st.dead = True
            worker = st.worker
        if no_restart:
            st.spec.max_restarts = 0
        blob = serialization.dumps(ActorDiedError(
            f"Actor {actor_id.hex()} was killed via kill()"))
        self._fail_actor(st, blob, "killed")
        if worker is not None:
            # Resource release and in-flight failure happen in the worker
            # death callback, which kill() leaves armed.
            worker.kill()

    # ------------------------------------------------------------------
    # worker failure handling
    # ------------------------------------------------------------------
    def _on_worker_death(self, handle: WorkerHandle):
        self.pool.remove(handle)
        self.scheduler.on_worker_removed(handle)
        # Stop re-exporting the dead worker's pushed metrics snapshot
        # (worker churn must not grow the store or pin stale gauges).
        self.gcs.telemetry.forget_worker(handle.worker_id.hex())
        # A dead worker's transfer-inflight gauge must not pin its node
        # "link-saturated" in the hybrid policy forever (the handle does
        # not carry a node id: scan the few node entries).
        wid_hex = handle.worker_id.hex()
        for entry in self.node_registry.entries():
            entry.xfer_inflight.pop(wid_hex, None)
        # A dead CALLER's unsettled sequence slots (channel sends that
        # died in its outbound queue) could wedge callee merge gates
        # forever: release its whole sequencing domain at every live
        # actor worker.
        dead_wid_b = handle.worker_id.binary()
        for st_a in list(self._actors.values()):
            with st_a.lock:
                w_a = st_a.worker
            if w_a is not None and w_a is not handle and w_a.alive:
                try:
                    w_a.send(P.SEQ_SETTLED, {
                        "caller_id": dead_wid_b, "seqs": (),
                        "all": True})
                except Exception:  # lint: broad-except-ok dying callee pipe; its gate dies with it
                    pass
        aid = handle.dedicated_actor
        # Planned removal: a death on a DRAINING node is the cluster's
        # fault — downstream failure paths migrate without charging
        # retry budgets (empty set ⇒ one falsy check).
        drain = bool(self._draining_nodes) and (  # lint: guarded-by-ok racy emptiness fast path: empty set => one falsy check (comment above)
            getattr(handle, "node_id_hex", None) in self._draining_nodes)  # lint: guarded-by-ok racy membership read: worst case a mid-drain death charges the retry budget like an unplanned loss
        # Drain via atomic popitem: a concurrent send-failure branch in
        # _dispatch also pops, and each spec must be owned by exactly
        # one failure path.
        running: Dict[bytes, P.TaskSpec] = {}
        while True:
            try:
                k, v = handle.running.popitem()
            except KeyError:
                break
            running[k] = v
        if aid is not None:
            self._on_actor_worker_death(aid, running,
                                        handle.worker_id.binary(),
                                        drain=drain)
            return
        for spec in running.values():
            self.scheduler.release_task_resources(spec)
            self._handle_worker_failure_for_task(spec, drain=drain)
        self.scheduler.notify_worker_free()

    def _handle_worker_failure_for_task(self, spec: P.TaskSpec,
                                        drain: bool = False):
        if spec.task_id.binary() in self._cancel_requested:
            blob = serialization.dumps(
                TaskCancelledError(spec.task_id.hex()))
            if spec.streaming:
                self._finish_gen_stream(spec.task_id, None, blob)
            self._register_error_returns(spec, blob)
            self._unpin_task_args(spec)
            return
        # Streaming tasks are not retryable (consumed items can't be
        # replayed coherently) — their worker death ends the stream.
        # Drain-driven deaths resubmit WITHOUT consulting (or charging)
        # the retry ledger: the node was leaving, not the task failing.
        if not spec.streaming and (drain or self._retry_budget(spec)):
            self._resubmit(spec)
        else:
            reason = "streams are not retryable" if spec.streaming \
                else "retries exhausted"
            # Terminal failure with no worker left to report it: the
            # SIGKILLed-worker case — record FAILED here (with the final
            # attempt count) or the state API never sees it end.
            # The attempt that just died is retries_used + 1 (the ledger
            # counts only granted retries, so it was NOT bumped for this
            # terminal failure).
            self.gcs.record_task_event({
                "task_id": spec.task_id.hex(), "name": spec.name,
                "state": "FAILED", "attempt": self._attempt_of(spec),
                "ts": time.time()})
            if drain:
                err: Exception = NodeDrainedError(
                    message=f"The node running task {spec.name} was "
                    f"drained and the task could not migrate ({reason}).")
            else:
                err = WorkerCrashedError(
                    f"The worker running task {spec.name} died ({reason}).")
            blob = serialization.dumps(err)
            if spec.streaming:
                self._finish_gen_stream(spec.task_id, None, blob)
            self._register_error_returns(spec, blob)
            self._unpin_task_args(spec)

    def _on_actor_worker_death(self, actor_id: ActorID,
                               running: Dict[bytes, P.TaskSpec],
                               dead_wid: Optional[bytes] = None,
                               drain: bool = False):
        st = self._actors.get(actor_id)
        entry = self.gcs.actors.get(actor_id)
        if st is None or entry is None:
            return
        self.scheduler.release_task_resources(st.spec)
        if drain:
            blob = serialization.dumps(NodeDrainedError(
                message=f"Actor {actor_id.hex()}'s node was drained "
                "and the actor could not migrate."))
        else:
            blob = serialization.dumps(ActorDiedError(
                f"Actor {actor_id.hex()}'s worker process died."))
        with st.lock:
            already_dead = st.dead
        # A drain migration restarts regardless of (and without
        # charging) the max_restarts budget — planned removal is the
        # cluster's fault, not the actor's.
        will_restart = (not already_dead
                        and (drain or entry.restarts_used
                             < st.spec.max_restarts))
        # In-flight tasks with retry budget survive a restart: they
        # re-queue on the actor and run after the creation replay
        # (reference: max_task_retries — TaskManager resubmits actor
        # tasks once the GcsActorManager restart completes). Streaming
        # tasks never retry (consumed items can't be replayed).
        retry_specs = []
        for spec in running.values():
            # A spec the direct-reconcile path requeued onto THIS dying
            # incarnation already paid for its retry there and never
            # ran (the channel EOF and this death are the same event) —
            # requeue it again without a second ledger charge. The
            # marker is one-shot and incarnation-scoped: a spec that
            # genuinely ran on a later worker charges normally.
            prepaid = (dead_wid is not None and self._direct_prepaid.pop(
                spec.task_id.binary(), None) == dead_wid)
            if (will_restart and not spec.streaming
                    and spec.task_id.binary() not in self._cancel_requested
                    and (prepaid or drain or self._retry_budget(spec))):
                retry_specs.append(spec)
                continue
            if spec.streaming:
                self._finish_gen_stream(spec.task_id, None, blob)
            for rid in spec.return_ids:
                self.gcs.objects.register_ready(rid, (P.LOC_ERROR, blob))
            self._unpin_task_args(spec)
            # Dropped at the death drain (stream / no budget): the NEXT
            # incarnation's merge gate must not wait for this slot.
            self._note_seq_settled(spec, release_to_callee=True)
        if already_dead:
            return
        if will_restart:
            # Elastic restart: replay the creation spec on a fresh worker
            # (reference: GcsActorManager restart path; state transitions in
            # gcs.proto ActorTableData).
            self.gcs.actors.set_restarting(actor_id, charge=not drain)
            with st.lock:
                st.ready = False
                st.worker = None
                st.in_flight.clear()
            # appendleft in reverse so retried in-flight tasks land at
            # the queue FRONT in their collected order, ahead of tasks
            # submitted after them (per-actor order; with
            # max_concurrency=1 there is at most one).
            for spec in reversed(retry_specs):
                for rid in spec.return_ids:
                    self.gcs.objects.register_pending(rid, spec)
                self._enqueue_actor_task(st, spec, front=True)
            # Re-pin creation args for the replayed creation (they were
            # unpinned when the first creation completed).
            self._pin_task_args(st.spec)
            self.scheduler.submit(st.spec, self._unresolved_deps(st.spec))
        else:
            self._fail_actor(st, blob, "worker died")

    # ------------------------------------------------------------------
    # cancellation
    # ------------------------------------------------------------------
    def cancel(self, object_id: ObjectID, force: bool = False,
               recursive: bool = True):
        entry = self.gcs.objects.entry(object_id)
        if entry is None or entry.lineage is None:
            return
        spec = entry.lineage
        task_id = spec.task_id
        self._cancel_requested.add(task_id.binary())
        if self.scheduler.try_cancel(task_id):
            blob = serialization.dumps(TaskCancelledError(task_id.hex()))
            self._register_error_returns(spec, blob)
            self._unpin_task_args(spec)
            return
        for h in self._all_worker_handles():
            if task_id.binary() in h.running:
                if force:
                    h.kill()
                else:
                    h.send(P.CANCEL_TASK, {"task_id": task_id})
                return

    # ------------------------------------------------------------------
    # worker message routing
    # ------------------------------------------------------------------
    def _reply(self, handle: WorkerHandle, req_id, result=None,
               error: Optional[BaseException] = None):
        if req_id is None:
            return  # oneway message: nobody is waiting
        payload = {"req_id": req_id,
                   "result": {"__error__": error} if error is not None
                   else result}
        try:
            handle.send(P.REPLY, payload)
        except Exception:  # lint: broad-except-ok dead worker pipe; its death callback fails the waiter
            logger.debug("dropping REPLY %s to dead worker %s", req_id,
                         handle.worker_id.hex()[:8], exc_info=True)

    def _on_worker_messages(self, handle: WorkerHandle, msgs) -> None:
        """Burst entry (one coalesced frame from a worker's writer):
        consecutive SUBMIT_TASK runs collapse into one batched
        submission — per-tick scheduler work instead of per-message —
        while everything else routes in arrival order (a REF_COUNT
        decref between two submits MUST stay between them: reordering
        it ahead of a submit's arg pin frees the arg early)."""
        scoped = self._fwd_on and self._fwd_scope_begin()
        try:
            i, n = 0, len(msgs)
            while i < n:
                msg_type, payload = msgs[i]
                if msg_type == P.SUBMIT_TASK:
                    j = i + 1
                    while j < n and msgs[j][0] == P.SUBMIT_TASK:
                        j += 1
                    if j - i > 1:
                        self._submit_task_run(
                            handle, [m[1] for m in msgs[i:j]])
                        i = j
                        continue
                self._on_worker_message(handle, msg_type, payload)
                i += 1
        finally:
            if scoped:
                self._fwd_scope_end()

    def _submit_task_run(self, handle: WorkerHandle, payloads) -> None:
        """Batched worker-originated submissions: per-spec registration
        still runs in order, but the scheduler absorbs the whole run
        through submit_batch (one queue lock + one dispatch wake)."""
        if telemetry.enabled:
            # These bypass _on_worker_message's per-type counter.
            telemetry.count_msg(P.SUBMIT_TASK, len(payloads))
        if wiretap.enabled:
            wiretap.frames("worker", "head", id(handle), "recv",
                           [(P.SUBMIT_TASK, p) for p in payloads])
        items = []
        for p in payloads:
            spec = p["spec"]
            spec._nested = True
            spec._submitter_wid = handle.worker_id.binary()
            try:
                if spec.fn_blob is not None:
                    self.register_function(spec.fn_id, spec.fn_blob)
                self._pin_task_args(spec)
                self.gcs.objects.register_submitted(spec.return_ids,
                                                    spec, incref_delta=1)
                self.gcs.record_task_event({
                    "task_id": spec.task_id.hex(), "name": spec.name,
                    "state": "PENDING_SCHEDULING", "attempt": 1,
                    "ts": time.time()})
                items.append((spec, self._unresolved_deps(spec)))
            except BaseException as e:  # noqa: BLE001
                self._register_submit_error(spec, e)
        if items:
            self.scheduler.submit_batch(items)

    def _ingest_task_events(self, handle: WorkerHandle, payload: dict):
        """One drained worker TaskEventBuffer batch. The head stamps the
        attempt number at ingest (workers don't see the retry ledger):
        events for attempt N arrive before the head grants retry N, so
        the ledger read here is the right attempt."""
        events = payload.get("events") or ()
        for ev in events:
            if "attempt" not in ev:
                try:
                    ev["attempt"] = self._retries_used.get(
                        bytes.fromhex(ev["task_id"]), 0) + 1
                except (KeyError, ValueError, TypeError):
                    ev["attempt"] = 1
        sub = payload.get("sub")
        if sub:
            # Raw SUBMITTED tuples for stamped direct calls (caller
            # ships (task_id_bytes, name, ts, callee_wid) — the dict
            # build happens HERE, off the worker's call hot path), so
            # state.list_tasks rows for direct calls carry
            # submission-side state like head-path calls.
            node_hex = self._node_hex_of(handle)
            events = list(events) + [
                {"task_id": tb.hex(), "name": name, "state": "SUBMITTED",
                 "ts": ts, "src": "worker", "node_id": node_hex,
                 "worker_id": cwid,
                 "attempt": self._retries_used.get(tb, 0) + 1}
                for tb, name, ts, cwid in sub]
        self.gcs.record_task_events(events,
                                    dropped=payload.get("dropped", 0),
                                    from_worker=True)
        spans = payload.get("spans")
        if spans or payload.get("span_drops"):
            # Tracing spans ride the same frame; the head stamps the
            # reporting node/worker so the per-span hot path never
            # builds those strings (the chrome export's pid/tid keys).
            self.gcs.record_spans(
                spans or (), dropped=payload.get("span_drops", 0),
                node_id=self._node_hex_of(handle),
                worker_id=handle.worker_id.hex())

    # ------------------------------------------------------------------
    # cross-plane call sequencing (head side: settlement authority)
    # ------------------------------------------------------------------
    @staticmethod
    def _seq_record(st: "_ActorState", caller: bytes, seq: int) -> None:  # lint: guarded-by-ok caller holds st.lock (docstring contract); a staticmethod cannot name the receiver for HOLDS_LOCK
        """Record one settled (caller, seq) slot (caller holds
        st.lock). Contiguous slots compact into the `below` watermark;
        past the sparse cap the OLDEST entries drop — a resync may then
        answer "unsettled" for ancient slots (bounded hold-timeout
        backstop), never "settled" for a live one."""
        store = st.seq_settled.setdefault(caller, [0, set()])
        if seq < store[0]:
            return
        store[1].add(seq)
        while store[0] in store[1]:
            store[1].discard(store[0])
            store[0] += 1
        if len(store[1]) > 8192:
            for s in sorted(store[1])[:4096]:
                store[1].discard(s)

    @staticmethod
    def _seq_merge(st: "_ActorState", caller: bytes, below: int,  # lint: guarded-by-ok caller holds st.lock (docstring contract); a staticmethod cannot name the receiver for HOLDS_LOCK
                   extra) -> None:
        """Fold a caller's settlement snapshot in (caller holds
        st.lock) — the reconcile/re-dial chokepoints ship (min-
        unsettled watermark, settled set above it)."""
        store = st.seq_settled.setdefault(caller, [0, set()])
        if below > store[0]:
            store[0] = below
        store[1].update(extra or ())
        store[1] = {s for s in store[1] if s >= store[0]}
        while store[0] in store[1]:
            store[1].discard(store[0])
            store[0] += 1

    @staticmethod
    def _seq_is_settled(st: "_ActorState", caller: bytes,  # lint: guarded-by-ok caller holds st.lock (docstring contract); a staticmethod cannot name the receiver for HOLDS_LOCK
                        seq: int) -> bool:
        store = st.seq_settled.get(caller)
        return store is not None and (seq < store[0] or seq in store[1])

    def _worker_handle_by_wid(self, wid: bytes):
        """The live handle of a worker by id bytes (head-local or
        daemon proxy), or None."""
        h = self.pool.workers.get(WorkerID(wid))
        if h is not None:
            return h if h.alive else None
        for p in self.head_server.all_proxies():
            if p.worker_id.binary() == wid:
                return p if p.alive else None
        return None

    def _note_seq_settled(self, spec, push_caller: bool = True,
                          release_to_callee: bool = False) -> None:
        """A stamped actor call reached TERMINAL registration here:
        record the slot in the actor's settlement store, tell the
        caller (so its unsettled map — the source of future calls'
        predecessor lists — shrinks), and, when the slot was settled
        WITHOUT delivery (typed reconcile errors, drops at death
        drains), release any merge-gate hold at the live incarnation
        waiting on it — a dead plane must never wedge the live one."""
        seq = getattr(spec, "caller_seq", -1)
        caller = getattr(spec, "caller_id", None)
        if seq is None or seq < 0 or caller is None \
                or spec.actor_id is None:
            return
        st = self._actors.get(spec.actor_id)
        callee = None
        if st is not None:
            with st.lock:
                self._seq_record(st, caller, seq)
                if release_to_callee:
                    callee = st.worker
        # Split payloads: the CALLER half keys on actor_id (prune its
        # unsettled map), the CALLEE half on caller_id (release gate
        # holds). Sending both keys to both would cross-contaminate a
        # worker that both hosts the actor AND calls it — the release
        # for caller C's slot must never settle the host's own
        # same-numbered slot toward that actor.
        if push_caller:
            h = self._worker_handle_by_wid(caller)
            if h is not None:
                try:
                    h.send(P.SEQ_SETTLED, {
                        "actor_id": spec.actor_id.binary(),
                        "seqs": [seq]})
                except Exception:  # lint: broad-except-ok dying caller pipe; its death releases its whole domain
                    pass
        if callee is not None and callee.alive:
            try:
                callee.send(P.SEQ_SETTLED, {
                    "caller_id": caller, "seqs": [seq]})
            except Exception:  # lint: broad-except-ok dying callee pipe; its gate dies with it
                pass

    # ------------------------------------------------------------------
    # direct worker<->worker call plane (head side: broker + accounting)
    # ------------------------------------------------------------------
    def _broker_channel(self, handle: WorkerHandle, payload: dict):
        """CHANNEL_REQ: hand the caller a dialable endpoint of the
        actor's worker. The head validates liveness, asks the callee to
        stand its listener up (CHANNEL_OPEN -> CHANNEL_ADDR), and fixes
        the cross-node host up from its registration view. One round
        trip per (caller, actor) pair — steady-state calls then bypass
        the head entirely."""
        req_id = payload.get("req_id")
        actor_id = payload["actor_id"]
        if not self._direct_on:
            self._reply(handle, req_id, {
                "ok": False, "reason": "direct_calls_enabled is off"})
            return
        st = self._actors.get(actor_id)
        if st is not None and payload.get("settled_below") is not None:
            # Re-dial chokepoint: the caller ships its settlement
            # snapshot so a fresh incarnation's merge gate can resolve
            # predecessor references to calls that settled against an
            # earlier incarnation (elided accounting the head never
            # heard otherwise).
            with st.lock:
                self._seq_merge(st, handle.worker_id.binary(),
                                int(payload["settled_below"]),
                                payload.get("settled_set"))
        caller_node = self._node_hex_of(handle)
        self._reply(handle, req_id,
                    self._broker_channel_info(actor_id, caller_node))

    def _broker_channel_info(self, actor_id, caller_node: str) -> dict:  # lint: guarded-by-ok liveness snapshot reads (st.dead/st.worker): a stale value yields a transient refusal the caller retries, never a wrong route
        """Broker core shared by worker callers (CHANNEL_REQ) and the
        driver-process serve proxy (broker_serve_channel): validate the
        actor, stand the callee listener up, fix the cross-node host.
        Returns the reply dict ({"ok": True, ...} or a refusal)."""
        from concurrent.futures import Future as _Future
        st = self._actors.get(actor_id)
        entry = self.gcs.actors.get(actor_id)
        if (st is None or entry is None or st.dead
                or entry.state == gcs_mod.ACTOR_DEAD):
            return {"ok": False, "reason": "actor is not alive"}
        if (entry.state != gcs_mod.ACTOR_ALIVE or st.worker is None
                or not st.worker.alive):
            # PENDING/RESTARTING: the callee will usually be dialable
            # in a moment. Marked transient so the caller routes THIS
            # call through the head but does NOT pin the pair to the
            # fallback path — a first burst racing the actor's
            # construction would otherwise lose the direct plane for
            # the pair's whole lifetime.
            return {"ok": False, "transient": True,
                    "reason": "actor is not ready yet"}
        callee = st.worker
        with self._chan_lock:
            self._chan_token += 1
            token = self._chan_token
            fut: "_Future" = _Future()
            self._chan_waiters[token] = fut
        try:
            callee.send(P.CHANNEL_OPEN, {"token": token})
            from .config import ray_config
            info = fut.result(
                timeout=float(ray_config.direct_channel_timeout_s))
        except Exception:
            return {"ok": False, "reason": "callee listener unavailable"}
        finally:
            with self._chan_lock:
                self._chan_waiters.pop(token, None)
        if not isinstance(info, dict) or info.get("error"):
            return {"ok": False,
                    "reason": f"callee listener failed: {info.get('error')}"}
        callee_node = self._node_hex_of(callee)
        tcp = info.get("tcp")
        if tcp is not None and caller_node != callee_node:
            # The callee bound its node-local host; cross-node callers
            # dial the node's head-registered reachable address.
            addr = self.transfer_addr_of(callee_node)
            if addr is not None:
                tcp = (addr[0], tcp[1])
        return {
            "ok": True,
            "unix": info.get("unix") if caller_node == callee_node
            else None,
            "tcp": tcp, "key": info["key"], "callee_node": callee_node,
            "callee_worker": info.get("worker_id")}

    def broker_serve_channel(self, actor_id) -> dict:
        """Driver-process entry to the channel broker: the serve proxy
        runs in the head process (no WorkerHandle, no request pipe), so
        it asks in-process for a dialable endpoint of a replica's
        worker. Same reply shape as CHANNEL_REQ."""
        if not self._direct_on:
            return {"ok": False, "reason": "direct_calls_enabled is off"}
        return self._broker_channel_info(actor_id, self.node_id.hex())

    def _on_channel_addr(self, payload: dict):
        with self._chan_lock:
            fut = self._chan_waiters.pop(payload.get("token"), None)
        if fut is not None:
            fut.set_result(payload)

    def _note_blocked_and_recall(self, handle: WorkerHandle) -> None:
        """Blocked worker (a blocking get/wait request, or the oneway
        WORKER_BLOCKED from a local direct/forwarded-result wait): hand
        the lease's grant back so dependency tasks can schedule
        (reference: blocked workers release their CPU), and evacuate
        any tasks queued behind the blocked one — they may BE its
        dependencies (sequential executor). Counter managed under the
        scheduler lock (pipeline-dispatch race)."""
        if (self.scheduler.note_worker_blocked(handle)
                and getattr(handle, "inflight", 0) > 1):
            try:
                handle.send(P.RECALL_QUEUED, {})
            except Exception:  # lint: broad-except-ok dying worker pipe; its death callback requeues the tasks
                pass

    def _register_result_loc(self, rid, loc, lineage, nested):
        """One completed return id into the object directory: shm
        adoption, node tagging, size, lineage. THE shared registration
        for the head path (TASK_DONE) and the direct plane
        (DIRECT_DONE) — direct results must stay byte-equivalent to
        head-path results, so there is exactly one copy of this
        sequence. Returns the tagged location (the forward push ships
        it)."""
        size = loc[1] if loc[0] == P.LOC_SHM else len(loc[1])
        if loc[0] == P.LOC_SHM and self._loc_is_local(loc):
            self.store.adopt(rid, size)
        loc = self._tag_local_loc(loc)
        self.gcs.objects.register_ready(
            rid, loc, size, lineage=lineage, nested_ids=nested)
        return loc

    def _on_direct_done(self, handle: WorkerHandle, payload: dict):
        """Batched completion accounting for direct calls: register the
        results in the object directory (shm adoption + location
        tagging, exactly like TASK_DONE) and absorb the caller's
        residual local refcounts."""
        caller_wid = handle.worker_id.binary()
        for ent in payload.get("entries", ()):
            error = ent.get("error")
            oids = ent.get("oids") or ()
            locs = ent.get("locs") or ()
            nested = ent.get("nested") or ()
            deltas = ent.get("deltas") or ()
            for i, oid in enumerate(oids):
                if error is not None:
                    loc = (P.LOC_ERROR, error)
                else:
                    loc = locs[i] if i < len(locs) else None
                    if loc is None:
                        continue
                nst = list(nested[i]) if i < len(nested) and nested[i] \
                    else []
                self._register_result_loc(oid, loc, ent.get("spec"), nst)
                self.gcs.objects.apply_delta(
                    oid, deltas[i] if i < len(deltas) else 0)
            aseq = ent.get("aseq")
            if aseq is not None:
                # Caller-settled slot: feed the sequencing settlement
                # store (merge-gate resyncs on later incarnations).
                st = self._actors.get(ActorID(aseq[0]))
                if st is not None:
                    with st.lock:
                        self._seq_record(st, caller_wid, aseq[1])
            gen = ent.get("gen")
            if gen is not None:
                # Channel-stream terminal: close the head's stream
                # state too, so a generator handle passed beyond the
                # submitting worker (driver, other workers) resolves
                # against the just-registered items instead of hanging
                # on an empty stream.
                self._finish_gen_stream(gen[0], gen[1],
                                        ent.get("stream_error"))

    def _on_ref_deltas(self, payload: dict):
        """Coalesced per-burst refcount deltas from a worker. Positive
        deltas apply first so a burst can never dip an object's count
        through zero transiently."""
        items = payload.get("deltas") or ()
        for oid, d in items:
            if d > 0:
                self.gcs.objects.apply_delta(oid, d)
        for oid, d in items:
            if d < 0:
                self.gcs.objects.apply_delta(oid, d)

    def _on_direct_reconcile(self, handle: WorkerHandle, payload: dict):
        """A caller's direct channel died with calls in flight: route
        every drained spec through the normal retry machinery — the
        ledger-bumped `attempt` accounting, requeue onto a restarting
        actor when budget remains, typed ActorDiedError otherwise —
        and absorb the caller's local refcounts either way."""
        req_id = payload.get("req_id")
        actor_id = payload["actor_id"]
        specs = payload.get("specs") or []
        deltas = payload.get("deltas") or []
        chan_wid = payload.get("callee_wid")
        st = self._actors.get(actor_id)
        entry = self.gcs.actors.get(actor_id)
        if st is not None and payload.get("settled_below") is not None:
            # Channel-death chokepoint: fold the caller's settlement
            # snapshot in (covers direct calls whose elided accounting
            # the head never saw — a later incarnation's merge gate
            # resolves stale predecessor references against it).
            with st.lock:
                self._seq_merge(st, handle.worker_id.binary(),
                                int(payload["settled_below"]),
                                payload.get("settled_set"))
        out = []
        for i, spec in enumerate(specs):
            ds = deltas[i] if i < len(deltas) else [0] * len(
                spec.return_ids)
            entries = [self.gcs.objects.entry(rid)
                       for rid in spec.return_ids]
            if entries and all(e is not None and e.event.is_set()
                               and e.state != gcs_mod.LOST
                               for e in entries):
                # The callee's result landed (DIRECT_DONE / fallback)
                # before the channel tore down: nothing to redo.
                for rid, d in zip(spec.return_ids, ds):
                    self.gcs.objects.apply_delta(rid, d)
                self._note_seq_settled(spec, push_caller=False)
                out.append({"status": "done"})
                continue
            if spec.max_retries == -2:
                spec.max_retries = int(
                    getattr(st.spec, "max_task_retries", 0) or 0) \
                    if st is not None else 0
            self.gcs.objects.register_submitted(spec.return_ids, spec,
                                                incref_delta=0)
            for rid, d in zip(spec.return_ids, ds):
                self.gcs.objects.apply_delta(rid, d)
            alive = (st is not None and entry is not None and not st.dead  # lint: guarded-by-ok GIL-atomic liveness snapshot: reconcile is idempotent, a stale read just defers to the next reconcile
                     and entry.state != gcs_mod.ACTOR_DEAD)
            # Channel death caused by a node DRAIN: requeue without
            # charging the ledger (same no-fault rule as the worker
            # death paths).
            drain = bool(self._draining_nodes) and st is not None and (  # lint: guarded-by-ok racy emptiness fast path: empty set => one falsy check
                self.scheduler.node_of_task(st.spec)
                in self._draining_nodes)  # lint: guarded-by-ok racy membership read: worst case a mid-drain channel death charges the retry budget
            if alive and not spec.streaming and (
                    drain or self._retry_budget(spec)):
                self.gcs.record_task_event({
                    "task_id": spec.task_id.hex(), "name": spec.name,
                    "state": "PENDING_SCHEDULING",
                    "attempt": self._attempt_of(spec), "ts": time.time()})
                self._pin_task_args(spec)
                with st.lock:
                    w = st.worker
                if w is not None and chan_wid is not None \
                        and w.worker_id.hex() == chan_wid:
                    # The channel EOF that triggered this reconcile is
                    # usually the callee worker's own death racing ahead
                    # of the head's WORKER_DIED processing (different
                    # connection, no cross-pipe ordering). If this
                    # requeue dispatches into that dying incarnation,
                    # the attempt just granted never runs — mark it
                    # prepaid so the death drain requeues it once more
                    # without charging the ledger a second time. The
                    # guard matters when the orderings flip: a requeue
                    # onto an already-restarted incarnation genuinely
                    # RUNS there, and stamping it would hand out one
                    # uncharged attempt past max_task_retries if that
                    # incarnation later died mid-run.
                    self._direct_prepaid[spec.task_id.binary()] = \
                        w.worker_id.binary()
                self._enqueue_actor_task(st, spec)
                out.append({"status": "requeued"})
            else:
                if drain and entry is not None \
                        and entry.creation_error is None:
                    # Typed drain reason on the direct plane: the caller
                    # prefers this reply blob over its local
                    # ActorDiedError (the drain settlement path).
                    fallback = serialization.dumps(NodeDrainedError(
                        message=f"Actor {actor_id.hex()}'s node was "
                        f"drained with direct call {spec.name} in "
                        "flight and the call could not migrate"))
                else:
                    fallback = serialization.dumps(ActorDiedError(
                        f"Actor {actor_id.hex()} died with direct "
                        f"call {spec.name} in flight"))
                blob = (entry.creation_error if entry is not None
                        else None) or fallback
                self.gcs.record_task_event({
                    "task_id": spec.task_id.hex(), "name": spec.name,
                    "state": "FAILED",
                    "attempt": self._attempt_of(spec), "ts": time.time()})
                for rid in spec.return_ids:
                    self.gcs.objects.register_ready(
                        rid, (P.LOC_ERROR, blob))
                # Typed-errored WITHOUT delivery: the caller settles it
                # from this reply, but a merge-gate hold at the (still
                # live, or next) incarnation must be released by the
                # head — a dead plane never wedges the live one.
                self._note_seq_settled(spec, push_caller=False,
                                       release_to_callee=True)
                out.append({"status": "failed", "error": blob})
        self._reply(handle, req_id, out)

    def _submitter_handle(self, spec):
        """The live handle of a nested spec's submitting worker, or
        None (dead/unknown — its local waiters died with it)."""
        wid = getattr(spec, "_submitter_wid", None)
        if wid is None:
            return None
        return self._worker_handle_by_wid(wid)

    def _forward_spec_results(self, spec, locs) -> None:
        """Inline forwarding at a registration chokepoint: push the
        just-registered locations of a worker-submitted task straight
        to its submitter (one buffer append per rid inside a forward
        scope; the scope flush ships one RESULT_FWD per submitter per
        completion frame). Paths that bypass the chokepoints (lost-
        object recovery) are covered by the worker's resync fallback.
        `locs` aligns with spec.return_ids; a None loc demotes that id
        to the head-request path."""
        handle = self._submitter_handle(spec)
        if handle is None:
            return
        for rid, loc in zip(spec.return_ids, locs):
            self._forward_results(handle, rid, loc)

    def _forward_results(self, handle: WorkerHandle, rid, loc) -> None:
        """Forward one registered location to its submitter. Inside a
        forward scope (a recv thread draining a coalesced completion
        frame — see _fwd_scope) entries buffer per submitter and flush
        as ONE RESULT_FWD when the frame's processing ends; outside a
        scope (handler-pool error paths, dispatch-thread failures) the
        per-submitter group-commit flush runs immediately."""
        scope = getattr(_fwd_scope, "bufs", None)
        if scope is not None:
            scope.setdefault(handle, []).append((rid, loc))
            return
        wid = handle.worker_id.binary()
        with self._fwd_lock:
            self._fwd_bufs.setdefault(wid, []).append((rid, loc))
            if wid in self._fwd_flushing:
                return
            self._fwd_flushing.add(wid)
        while True:
            with self._fwd_lock:
                batch = self._fwd_bufs.get(wid) or []
                self._fwd_bufs[wid] = []
                if not batch:
                    self._fwd_flushing.discard(wid)
                    self._fwd_bufs.pop(wid, None)
                    return
            if telemetry.enabled:
                telemetry.record_result_forward(len(batch))
            try:
                handle.send(P.RESULT_FWD, {"entries": batch})
            except Exception:
                # Dead submitter: its local waiters die with it.
                with self._fwd_lock:
                    self._fwd_bufs.pop(wid, None)
                    self._fwd_flushing.discard(wid)
                return

    def _fwd_scope_begin(self):
        """Enter a forward batch scope on this thread (returns False if
        one is already active — nested scopes join the outer one)."""
        if getattr(_fwd_scope, "bufs", None) is not None:
            return False
        _fwd_scope.bufs = {}
        return True

    def _fwd_scope_end(self):
        bufs, _fwd_scope.bufs = _fwd_scope.bufs, None
        for handle, entries in bufs.items():
            if telemetry.enabled:
                telemetry.record_result_forward(len(entries))
            try:
                handle.send(P.RESULT_FWD, {"entries": entries})
            except Exception:  # lint: broad-except-ok dead submitter: its local waiters die with it
                logger.debug("dropping result forward to dead worker",
                             exc_info=True)

    def _on_worker_message(self, handle: WorkerHandle, msg_type: str,
                           payload: dict):
        if telemetry.enabled:
            # Head self-instrumentation: per-type ingest counters (the
            # scale harness's msgs/s signal), exported as gauges at
            # exposition time. One dict bump per message.
            telemetry.count_msg(msg_type)
        if wiretap.enabled:
            # Per-message chokepoint: both mux dispatch shapes (single
            # frames and coalesced bursts) and daemon-relayed proxies
            # funnel through here; SUBMIT_TASK runs are fed in
            # _submit_task_run.
            wiretap.frame("worker", "head", id(handle), "recv",
                          msg_type, payload)
        if msg_type == P.REF_COUNT:
            # Oneway borrow count from a worker (no reply).
            if payload["delta"] > 0:
                self.gcs.objects.incref(payload["object_id"])
            else:
                self.gcs.objects.decref(payload["object_id"])
        elif msg_type == P.TASK_DONE:
            self._on_task_done(handle, payload)
        elif msg_type == P.TASKS_DONE:
            # Coalesced completions from a pipelined worker burst; the
            # forward scope turns their per-completion result forwards
            # into one RESULT_FWD per submitter for the whole batch.
            scoped = self._fwd_on and self._fwd_scope_begin()
            try:
                for done in payload["batch"]:
                    self._on_task_done(handle, done)
            finally:
                if scoped:
                    self._fwd_scope_end()
        elif msg_type == P.TASKS_RECALLED:
            self._on_tasks_recalled(handle, payload["task_ids"])
        elif msg_type == P.GEN_ITEM:
            self._on_gen_item(handle, payload)
        elif msg_type == P.TASK_EVENTS:
            self._ingest_task_events(handle, payload)
        elif msg_type == P.METRICS_PUSH:
            groups = payload.get("groups") or []
            self.gcs.telemetry.metrics_put(
                scope="worker",
                node_id=payload.get("node_id") or self.node_id.hex(),
                worker_id=payload.get("worker_id"),
                groups=groups,
                ts=payload.get("ts"))
            # Feed the worker's transfer-inflight gauge back into the
            # scheduler's node view: the hybrid policy deprioritizes
            # nodes whose links are saturated with bulk object pulls.
            for g in groups:
                if g.get("name") == "transfer_inflight":
                    for _n, _t, v in g.get("samples") or ():
                        self.node_registry.note_transfer_inflight(
                            payload.get("node_id") or self.node_id.hex(),
                            payload.get("worker_id"), int(v))
                    break
        elif msg_type == P.ACTOR_READY:
            self._on_actor_ready(handle, payload)
        elif msg_type == P.DIRECT_DONE:
            self._on_direct_done(handle, payload)
        elif msg_type == P.REF_DELTAS:
            self._on_ref_deltas(payload)
        elif msg_type == P.CHANNEL_ADDR:
            self._on_channel_addr(payload)
        elif msg_type == P.WORKER_BLOCKED:
            # A worker parked in a LOCAL direct/forwarded-result wait:
            # same lease-release + queued-task-recall semantics the
            # blocking GET_LOCATIONS round trip used to carry.
            self._note_blocked_and_recall(handle)
        elif msg_type == P.WORKER_UNBLOCKED:
            self.scheduler.note_worker_unblocked(handle)
        elif msg_type in (P.GET_LOCATIONS, P.WAIT_OBJECTS, P.GCS_REQUEST,
                          P.PULL_OBJECT, P.CHANNEL_REQ,
                          P.DIRECT_RECONCILE):
            # GCS requests may block (placement-group waits, cross-node
            # pulls), so they run on the handler pool, never the
            # per-worker recv thread.
            try:
                self._handler_pool.submit(
                    self._handle_blocking_request, handle, msg_type,
                    payload)
            except RuntimeError:
                # Pool already shut down: a worker message raced
                # runtime teardown; dropping it is correct (the worker
                # is about to be killed) and beats a traceback storm.
                pass
        else:
            self._handle_quick_request(handle, msg_type, payload)

    def _handle_blocking_request(self, handle: WorkerHandle, msg_type: str,
                                 payload: dict):
        req_id = payload["req_id"]
        # The worker's current task is (potentially) parked in a
        # get/wait: exclude it from pipeline targeting while it waits —
        # worker execution is sequential, so a task queued behind a
        # blocked one would wait with it.
        mark = msg_type in (P.GET_LOCATIONS, P.WAIT_OBJECTS)
        if mark:
            self._note_blocked_and_recall(handle)
        try:
            if msg_type == P.GET_LOCATIONS:
                locs = self.get_locations(payload["object_ids"],
                                          payload.get("timeout"))
                self._reply(handle, req_id, locs)
            elif msg_type == P.CHANNEL_REQ:
                self._broker_channel(handle, payload)
            elif msg_type == P.DIRECT_RECONCILE:
                self._on_direct_reconcile(handle, payload)
            elif msg_type == P.PULL_OBJECT:
                oid = payload["object_id"]
                self._ensure_local(oid, payload["node"])
                # Zero-copy adoption: ship the foreign-arena mapping so
                # the head-attached worker adopts instead of copying.
                # A dead owner's unlinked arena can't be re-mmapped by
                # the worker — materialize a local copy instead.
                ext = getattr(self.store, "export_adoption",
                              lambda _o: None)(oid)
                if ext is not None and (payload.get("materialize")
                                        or not os.path.exists(ext[0])):
                    self.store.materialize_external(oid)
                    ext = None
                self._reply(handle, req_id,
                            {"adopt": ext} if ext is not None else True)
            elif msg_type == P.GCS_REQUEST:
                result = self._gcs_op(payload["op"], payload["kwargs"])
                self._reply(handle, req_id, result)
            else:
                ready, not_ready = self.wait(
                    payload["object_ids"], payload["num_returns"],
                    payload.get("timeout"))
                self._reply(handle, req_id, (ready, not_ready))
        except BaseException as e:  # noqa: BLE001
            self._reply(handle, req_id, error=e)
        finally:
            if mark:
                self.scheduler.note_worker_unblocked(handle)

    def _register_submit_error(self, spec, exc: BaseException) -> None:
        """Route a failed oneway submission to its return refs: the
        submitting worker never blocks on an ack, so errors must surface
        where the caller will look — ray_tpu_torch.get on the returned ids
        (reference: submission failures surface as errors on the ref)."""
        try:
            blob = serialization.dumps(
                exc if isinstance(exc, TaskError)
                else TaskError(f"{type(exc).__name__}: {exc}"))
            if getattr(spec, "return_ids", None):
                self._register_error_returns(spec, blob)
        except Exception:
            pass

    def _worker_submit(self, handle: WorkerHandle, spec, req_id,
                       submit_fn) -> None:
        """Shared scaffolding for worker-originated task/actor-task
        submissions: the return-id incref now rides inside
        submit_task/submit_actor_task's fused registration
        (api._make_return_refs skips the per-ref REF_COUNT frame; the
        worker's refs decref on drop to balance), submit, and route
        failures to the return refs when the submitter isn't waiting."""
        try:
            submit_fn(spec)
        except BaseException as e:  # noqa: BLE001
            if req_id is not None:
                raise
            self._register_submit_error(spec, e)
        if req_id is not None:
            self._reply(handle, req_id, True)

    def _handle_quick_request(self, handle: WorkerHandle, msg_type: str,
                              payload: dict):
        # Submits and puts arrive ONEWAY (req_id None): the worker does
        # not wait, so failures are registered on the object ids instead
        # of replied. Request/reply remains for the informational calls
        # below (get_actor, gcs ops, legacy callers).
        req_id = payload.get("req_id")
        try:
            if msg_type == P.OWNED_PUT:
                oid = payload["object_id"]
                try:
                    nested = payload.get("nested") or []
                    if "inline" in payload:
                        self.gcs.objects.register_ready(
                            oid, (P.LOC_INLINE, payload["inline"]),
                            len(payload["inline"]), nested_ids=nested)
                    else:
                        size = payload["size"]
                        node = payload.get("node")
                        if node and node != self.node_id.hex():
                            loc = (P.LOC_SHM, size, node)
                        else:
                            self.store.adopt(oid, size)
                            loc = (P.LOC_SHM, size, self.node_id.hex())
                        self.gcs.objects.register_ready(
                            oid, loc, size, nested_ids=nested)
                except BaseException as e:  # noqa: BLE001
                    if req_id is not None:
                        raise
                    blob = serialization.dumps(
                        TaskError(f"{type(e).__name__}: {e}"))
                    self.gcs.objects.register_ready(
                        oid, (P.LOC_ERROR, blob))
                if req_id is not None:
                    self._reply(handle, req_id, True)
            elif msg_type == P.SUBMIT_TASK:
                spec = payload["spec"]
                # Worker-submitted (nested) tasks pipeline like driver
                # tasks EXCEPT onto their own submitter's worker (the
                # self-deadlock case — child queued behind its blocked
                # parent on a sequential worker); see _try_pipeline.
                spec._nested = True
                spec._submitter_wid = handle.worker_id.binary()
                self._worker_submit(handle, spec, req_id,
                                    self.submit_task)
            elif msg_type == P.SUBMIT_ACTOR_TASK:
                spec = payload["spec"]
                # Head-routed (fallback) actor calls marked their
                # return ids forward-pending caller-side; without the
                # submitter the RESULT_FWD push never fires and every
                # get() pays the full resync delay. Gated on _fwd_on:
                # with forwarding off no worker marks results pending
                # (env coherence), and the dynamic attr would demote
                # the spec off the slim-pickle fast path on every
                # dispatch — the flag-off contract is zero extra work.
                if self._fwd_on:
                    spec._submitter_wid = handle.worker_id.binary()
                self._worker_submit(handle, spec, req_id,
                                    self.submit_actor_task)
            elif msg_type == P.CREATE_ACTOR_REQ:
                self.create_actor(payload["spec"])
                self._reply(handle, req_id, True)
            elif msg_type == P.GET_ACTOR:
                spec = self.get_actor(payload["name"], payload["namespace"])
                safe = P.ActorSpec(**{**spec.__dict__, "cls_blob": None,
                                      "args": [], "kwargs": {}})
                self._reply(handle, req_id, safe)
            elif msg_type == P.KILL_ACTOR:
                self.kill_actor(payload["actor_id"], payload["no_restart"])
                self._reply(handle, req_id, True)
            elif msg_type == P.GCS_REQUEST:
                result = self._gcs_op(payload["op"], payload["kwargs"])
                self._reply(handle, req_id, result)
            else:
                # Unknown worker-plane type: surface it BOTH ways — the
                # log catches oneway messages (req_id None, nobody
                # waits), the error reply catches request/reply skew.
                logger.warning("head dropping unknown worker message "
                               "type %r (protocol skew?)", msg_type)
                self._reply(handle, req_id,
                            error=ValueError(f"unknown message {msg_type}"))
        except BaseException as e:  # noqa: BLE001
            self._reply(handle, req_id, error=e)

    def _gcs_op(self, op: str, kwargs: dict) -> Any:
        if op == "cluster_resources":
            return self.cluster_resources()
        if op == "available_resources":
            return self.available_resources()
        if op == "kv_put":
            return self.gcs.kv.put(**kwargs)
        if op == "kv_get":
            return self.gcs.kv.get(**kwargs)
        if op == "kv_del":
            return self.gcs.kv.delete(**kwargs)
        if op == "kv_keys":
            return self.gcs.kv.keys(**kwargs)
        if op == "list_actors":
            return [{"actor_id": e.spec.actor_id.hex(),
                     "class_name": e.spec.cls_id.split(":")[0],
                     "state": e.state, "name": e.spec.name,
                     "node_id": self.scheduler.node_of_task(e.spec),
                     "restarts_used": e.restarts_used}
                    for e in self.gcs.actors.list()]
        if op == "task_events":
            return self.gcs.task_events()
        if op == "cluster_metrics":
            return telemetry.federated_prometheus_text(self)
        if op == "telemetry_dropped":
            return self.gcs.telemetry.dropped_counts()
        if op == "direct_seq_settled":
            # Callee merge-gate resync: which of these (caller, seq)
            # slots are terminally settled? Unknown actor state means
            # no ordering obligations remain — release everything.
            st = self._actors.get(ActorID(kwargs["actor_id"]))
            seqs = list(kwargs.get("seqs") or ())
            if st is None:
                return seqs
            caller = kwargs["caller_id"]
            with st.lock:
                return [s for s in seqs
                        if self._seq_is_settled(st, caller, s)]
        if op == "gen_wait":
            # Worker-side consumption of a HEAD-routed stream (the
            # direct-plane fallback): blocks in the head's stream state.
            return self.gen_wait(kwargs["task_id"], kwargs["index"],
                                 kwargs.get("timeout"))
        if op == "gen_release":
            return self.gen_release(kwargs["task_id"],
                                    int(kwargs.get("consumed", 0)))
        if op == "record_spans":
            return self.gcs.record_spans(**kwargs)
        if op == "get_spans":
            return self.gcs.spans(kwargs.get("trace_id"))
        if op == "get_trace":
            from ..util.tracing import build_trace
            return build_trace(self.gcs.spans(kwargs["trace_id"]))
        if op == "span_dropped":
            return self.gcs.telemetry.span_drop_counts()
        if op == "object_stats":
            return self.gcs.objects.stats()
        if op == "local_node_view":
            # Head-attached workers get the authoritative view directly
            # (daemon-attached workers are answered by their daemon's
            # gossiped snapshot — daemon.py NODE_SYNC intercept).
            return {"node_id": self.node_id.hex(), "ts": time.time(),
                    "view": self.node_registry.snapshot()}
        if op == "spill_store":
            # A head-attached worker's create() hit a full arena: only
            # the owner may spill other processes' sealed blocks (it
            # adopted them). Daemon nodes intercept this op locally
            # (daemon.py) so it always targets the full node's store.
            from .object_store import escalated_spill
            return escalated_spill(self.store, kwargs.get("need", 0))
        if op == "list_objects":
            return self.gcs.objects.list_entries(
                limit=kwargs.get("limit", 1000))
        if op == "list_workers":
            rows = [{"worker_id": wid.hex(),
                     "pid": h.proc.pid if h.proc else None,
                     "node_id": self.node_id.hex(),
                     "dedicated_actor": (h.dedicated_actor.hex()
                                         if h.dedicated_actor else None),
                     "running_tasks": len(h.running)}
                    for wid, h in self.pool.workers.items()]
            # Workers on daemon nodes (their absence here broke the
            # elastic shutdown wait for multi-node gangs).
            for p in self.head_server.all_proxies():
                rows.append({
                    "worker_id": p.worker_id.hex(), "pid": None,
                    "node_id": p.node_id_hex,
                    "dedicated_actor": (p.dedicated_actor.hex()
                                        if p.dedicated_actor else None),
                    "running_tasks": len(p.running)})
            return rows
        if op == "resource_demands":
            demands = self.scheduler.pending_demands()
            pending_pgs = [
                {"bundles": e.bundles, "strategy": e.strategy}
                for e in self.pg_manager.pending_entries()
            ] if hasattr(self.pg_manager, "pending_entries") else []
            return {"demands": demands, "placement_groups": pending_pgs}
        if op == "list_nodes":
            return self.node_registry.snapshot()
        if op == "drain_node":
            return self.drain_node(kwargs["node_id"],
                                   deadline_s=kwargs.get("deadline_s"),
                                   wait=bool(kwargs.get("wait", False)))
        if op == "drain_status":
            return self.drain_status(kwargs.get("node_id"))
        if op == "pg_create":
            e = self.pg_manager.create(
                kwargs["pg_id_hex"], kwargs["bundles"], kwargs["strategy"],
                kwargs.get("name", ""))
            return e.state
        if op == "pg_remove":
            return self.pg_manager.remove(kwargs["pg_id_hex"])
        if op == "pg_wait_ready":
            return self.pg_manager.wait_ready(kwargs["pg_id_hex"],
                                              kwargs.get("timeout"))
        if op == "pg_table":
            return self.pg_manager.table()
        if op == "pg_get_by_name":
            e = self.pg_manager.get_by_name(kwargs["name"])
            if e is None:
                return None
            return {"pg_id_hex": e.pg_id_hex, "bundles": e.bundles,
                    "strategy": e.strategy, "state": e.state, "name": e.name}
        if op == "pg_validate":
            e = self.pg_manager.get(kwargs["pg_id_hex"])
            if e is None:
                raise ValueError(
                    f"Unknown placement group {kwargs['pg_id_hex']}")
            self.pg_manager.validate_demand(
                e, kwargs["resources"], kwargs["bundle_index"])
            return True
        raise ValueError(f"unknown gcs op {op}")

    # parity with WorkerClient so library code is context-agnostic
    def gcs_request(self, op: str, **kwargs) -> Any:
        return self._gcs_op(op, kwargs)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def cluster_resources(self) -> Dict[str, float]:
        totals, _ = self.node_registry.aggregate()
        return totals

    def available_resources(self) -> Dict[str, float]:
        _, avail = self.node_registry.aggregate()
        return avail

    # ------------------------------------------------------------------
    # virtual nodes (cluster_utils.Cluster; reference:
    # python/ray/cluster_utils.py:135 — N raylets sharing one GCS)
    # ------------------------------------------------------------------
    def add_virtual_node(self, resources: Dict[str, float],
                         labels: Optional[Dict[str, str]] = None) -> str:
        node_id = NodeID.from_random().hex()
        self.node_registry.add_node(node_id, resources, labels=labels)
        self.scheduler.notify_worker_free()
        return node_id

    def remove_virtual_node(self, node_id_hex: str) -> bool:
        """Simulate node failure: the node stops granting resources and
        every worker whose current task was scheduled onto it is killed
        (task retries / actor restarts then reschedule onto surviving
        nodes — the reference's RayletKiller chaos semantics,
        _private/test_utils.py:1618)."""
        entry = self.node_registry.remove_node(node_id_hex)
        if entry is None:
            return False
        doomed = []
        for handle in list(self.pool.workers.values()):
            if handle.dedicated_actor is not None:
                st = self._actors.get(handle.dedicated_actor)
                if st is not None and \
                        self.scheduler.node_of_task(st.spec) == node_id_hex:
                    doomed.append(handle)
                continue
            for spec in list(handle.running.values()):
                if self.scheduler.node_of_task(spec) == node_id_hex:
                    doomed.append(handle)
                    break
        for handle in doomed:
            handle.kill()
        self.scheduler.notify_worker_free()
        return True

    # ------------------------------------------------------------------
    def prestart_workers(self, n: int):
        self.scheduler.prestart(n)

    def shutdown(self):
        if self._shutdown:
            return
        self._shutdown = True
        try:
            self.memory_monitor.stop()
        except Exception:  # lint: broad-except-ok best-effort teardown: every subsystem stops even if one is already dead
            pass
        try:
            self.log_monitor.stop()
        except Exception:  # lint: broad-except-ok best-effort teardown: every subsystem stops even if one is already dead
            pass
        try:
            self.head_server.stop()
            self.transfer_server.stop()
            self.pull_mgr.shutdown()
        except Exception:  # lint: broad-except-ok best-effort teardown: every subsystem stops even if one is already dead
            pass
        try:
            self.pg_manager.shutdown()
            self.scheduler.stop()
            self.pool.shutdown()
        except Exception:  # lint: broad-except-ok best-effort teardown: every subsystem stops even if one is already dead
            pass
        if refdebug.enabled:
            # After the pool drains (workers' final accounting frames
            # are processed before their handles close) but before the
            # store dies: whatever the directory still holds is the
            # deliberately-leaked set the checker reconciles against.
            refdebug.snapshot(self.gcs.objects.live_counts())
        try:
            self.store.shutdown()
        except Exception:  # lint: broad-except-ok best-effort teardown: every subsystem stops even if one is already dead
            pass
        close_kv = getattr(self.gcs.kv, "close", None)
        if close_kv is not None:
            close_kv()
        try:
            sys.setswitchinterval(self._prev_switch_interval)
        except Exception:  # lint: broad-except-ok best-effort teardown: interpreter may be finalizing under atexit
            pass
        import shutil
        shutil.rmtree(self.session_dir, ignore_errors=True)
        from . import state
        if state.get_node() is self:
            state.set_node(None)
