"""Per-host node daemon: worker pool + local object store + transfer.

The raylet-equivalent (reference: src/ray/raylet/main.cc — per-node daemon
owning a worker pool, a plasma store, and an object manager, registering
with the GCS over gRPC). The head remains the single scheduler (the
collapsed design), so the reference's worker-lease protocol
(node_manager.cc:1868 HandleRequestWorkerLease) becomes: head sends
START_WORKER / relays task frames via TO_WORKER; the daemon owns process
lifecycles, GPU pinning (``CUDA_VISIBLE_DEVICES``, as the head pins its
own workers), the node-local shm store, and pull-based object
localization (object_manager/pull_manager.h:53).

Run on each host of the cluster:

    python -m ray_tpu_torch._private.daemon --address HEAD_HOST:PORT \
        [--num-cpus N] [--num-gpus N] [--resources '{"custom": 1}']

with the cluster token in RTT_CLUSTER_TOKEN_HEX (or --token-hex). Without
``--num-gpus`` the daemon counts the GPUs it can see, as ``init()`` does
(``RTT_NUM_GPUS``, then ``CUDA_VISIBLE_DEVICES``, then the NVIDIA
driver's list): on a host whose head declares the same cards, pass the
count explicitly.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from ..util import tracing
from . import fault
from . import lockdep
from . import protocol as P
from . import racedebug
from . import telemetry
from . import wiretap
from .config import ray_config, session_dirs
from .ids import NodeID, WorkerID
from .netcomm import PullManager, TransferServer, store_paths_factory
from .object_store import create_store
from .resources import detect_node_resources, gpu_worker_extra_env
from .scheduler import WorkerHandle, WorkerPool

logger = logging.getLogger(__name__)


class NodeDaemon:
    def __init__(self, address: Tuple[str, int], token: bytes,
                 num_cpus: Optional[float] = None,
                 num_gpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None,
                 object_store_memory: Optional[int] = None,
                 labels: Optional[Dict[str, str]] = None):
        self.labels = dict(labels or {})
        self.node_id = NodeID.from_random()
        self.node_hex = self.node_id.hex()
        session_name = f"node_{int(time.time())}_{uuid.uuid4().hex[:8]}"
        # The head's own places, so its stale-session sweep covers a
        # daemon killed before its shutdown ran.
        self.session_dir, self.store_dir = session_dirs(session_name)
        os.makedirs(self.session_dir, exist_ok=True)
        self.store = create_store(self.store_dir,
                                  capacity=object_store_memory)
        for d in (self.session_dir, self.store_dir):
            try:
                with open(os.path.join(d, ".owner_pid"), "w") as f:
                    f.write(str(os.getpid()))
            except OSError:
                pass
        self.totals = detect_node_resources(num_cpus, num_gpus, resources)
        self.pool = WorkerPool(
            self.session_dir, self.store_dir,
            on_worker_message=self._on_worker_message,
            on_worker_death=self._on_worker_death,
            node_id_hex=self.node_hex)
        from .config import ray_config
        paths_for, view_for = store_paths_factory(self.store)
        from .netcomm import store_local_locator
        self.transfer = TransferServer(
            paths_for, token, host=str(ray_config.node_host),
            view_for=view_for, locate_for=store_local_locator(self.store))
        self.pull_mgr = PullManager(
            self.store, token,
            max_concurrent=int(ray_config.pull_max_concurrent))
        # GPU ids handed to workers, so two never share a card.
        self._free_gpus: List[int] = list(
            range(int(self.totals.get("GPU", 0))))
        self._pool_workers = 0
        ncpu = int(self.totals.get("CPU", 4))
        self._max_pool_workers = max(ncpu, 4)
        self._lock = lockdep.lock("daemon.state")
        # Head-link writer (per connection; swapped on reconnect under
        # _conn_lock): sends from any daemon thread enqueue and
        # coalesce into one vectored write per wakeup.
        self._conn_lock = lockdep.lock("daemon.conn")
        self._writer = None
        # Recv-side: the head's writer may coalesce several messages
        # into one frame; the ACK read in _connect_head consumes one
        # FRAME, so trailing messages park here for run().
        self._recv_backlog: List[Tuple[str, dict]] = []
        self._exec = ThreadPoolExecutor(max_workers=16,
                                        thread_name_prefix="daemon")
        # Ordered routing executor: the recv loop hands worker-plane
        # messages (task relays, kills, releases) here instead of
        # running them inline — a wedged worker pipe can't stall frame
        # parsing, while per-worker FIFO order holds.
        from .netcomm import SerialExecutor
        self._route_exec = SerialExecutor(name="daemon-route")
        self._req_lock = lockdep.lock("daemon.req")
        self._req_counter = 0
        self._pending: Dict[int, Future] = {}
        self._transfer_addrs: Dict[str, Tuple[str, int]] = {}
        self._stopped = threading.Event()
        # Graceful-drain flag (DRAIN_NODE): informational daemon-side —
        # the head owns drain orchestration; workers keep running until
        # migrated or SHUTDOWN_NODE lands.
        self._draining = False

        self._address = tuple(address)
        self._token = token
        self.head_host = address[0]
        self._heartbeat_interval = float(ray_config.node_heartbeat_s)
        self._connect_head()

    def _connect_head(self):
        """(Re)establish the head link and register this node
        (reference: the raylet registering with the GCS server,
        gcs_server_main.cc:47; on reconnection the node re-registers
        like a fresh join — gcs_client_reconnection_test.cc)."""
        from multiprocessing.connection import Client

        from .netcomm import ConnectionWriter, tune_control_socket
        if fault.enabled:
            fault.fire("daemon.connect", head=str(self._address))
        conn = Client(self._address, family="AF_INET",
                      authkey=self._token)
        # Socket audit parity with the head side: NODELAY + KEEPALIVE
        # on every control connection (the daemon side used to set
        # neither).
        tune_control_socket(conn.fileno())
        reg_payload = {
            "node_id_hex": self.node_hex,
            "resources": dict(self.totals),
            "transfer_port": self.transfer.port,
            "hostname": os.uname().nodename,
            "pid": os.getpid(),
            "labels": self.labels,
        }
        register = P.dump_message(P.REGISTER_NODE, reg_payload)
        if wiretap.enabled:
            wiretap.frame("daemon", "daemon", id(conn), "send",
                          P.REGISTER_NODE, reg_payload)
        # REGISTER_NODE is enqueued on the FRESH writer before it is
        # published: the long-lived heartbeat thread can only reach the
        # new connection through self._writer, and the writer queue is
        # FIFO — so no NODE_PING can precede the registration (the head
        # closes conns whose first message isn't a registration).
        writer = ConnectionWriter(conn, name="head-writer")
        writer.send_frame(register)
        with self._conn_lock:
            old = self._writer
            self.conn = conn
            self._writer = writer
            # Frames already parsed off a DEAD connection must not be
            # served as this connection's NODE_ACK.
            self._recv_backlog.clear()
        if old is not None:
            try:
                old.close(flush_timeout=0.0)
            except Exception:  # lint: broad-except-ok retiring the DEAD connection's writer; the fresh link above is already live and owns delivery
                pass
        msg_type, payload = self._recv()
        if wiretap.enabled:
            wiretap.frame("daemon", "daemon", id(conn), "recv",
                          msg_type, payload)
        if msg_type != P.NODE_ACK:
            raise RuntimeError(f"head rejected registration: {msg_type}")
        self.head_node_hex = payload["head_node_id_hex"]
        head_tport = payload.get("head_transfer_port")
        if head_tport:
            self._transfer_addrs[self.head_node_hex] = (
                self.head_host, head_tport)
        # One heartbeat thread across reconnects: the loop survives send
        # failures and just picks up the fresh self.conn.
        hb = getattr(self, "_hb_thread", None)
        if hb is None or not hb.is_alive():
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True, name="heartbeat")
            self._hb_thread.start()

    def _reset_for_reconnect(self):
        """Head restarted: its view of our workers/tasks is gone. Kill
        the pool (in-flight work is unowned now), return GPUs, and
        start clean — the reconnect registers the node fresh.

        death_handled is set FIRST: the recv-mux EOF callbacks for these
        kills fire asynchronously and would otherwise re-release GPUs /
        re-decrement the pool counter on top of the wholesale reset
        below (duplicate GPU ids -> two workers pinned to one card)."""
        for handle in list(self.pool.workers.values()):
            handle.death_handled = True
            handle.gpu_ids = []
            handle.counted_in_pool = False
            try:
                handle.kill()
            except Exception:  # lint: broad-except-ok worker pipe already dead during reconnect reset; pool.remove below is the cleanup that matters
                pass
            self.pool.remove(handle)
        with self._lock:
            self._pool_workers = 0
            self._free_gpus = list(range(int(self.totals.get("GPU", 0))))
        # The dead head's gossiped cluster view must not be served with
        # a valid-looking timestamp after the rejoin; the first
        # post-rejoin NODE_SYNC repopulates it.
        self.cluster_view = None

    def _reconnect_with_backoff(self) -> bool:
        """Try to rejoin the head, doubling backoff per attempt (capped
        5s). Returns True once reconnected, False when attempts are
        exhausted (or reconnect is disabled)."""
        import random
        attempts = int(ray_config.head_reconnect_attempts)
        delay = float(ray_config.head_reconnect_backoff_s)
        for i in range(attempts):
            # Jitter decorrelates a cluster's daemons re-joining a
            # restarted head (thundering-herd on the accept loop).
            if self._stopped.wait(min(delay, 5.0)
                                  * (0.5 + 0.5 * random.random())):
                return False
            delay *= 2
            try:
                self._connect_head()
                print(f"[ray_tpu_torch daemon {self.node_hex[:8]}] rejoined "
                      f"head at {self._address} (attempt {i + 1})",
                      flush=True)
                return True
            except Exception:
                try:
                    self.conn.close()
                except Exception:  # lint: broad-except-ok half-open conn from the failed rejoin attempt; the next attempt dials fresh
                    pass
        return False

    # -- head link -----------------------------------------------------
    def _send(self, msg_type: str, payload: dict):
        with self._conn_lock:
            w = self._writer
        w.send_message(msg_type, payload)

    def _recv(self):  # lint: guarded-by-ok recv-thread-only: the daemon loop is the sole consumer; _connect_head resets the backlog on this same thread (under _conn_lock for the writer pair)
        """Read the next message, buffering coalesced frame-mates."""
        if self._recv_backlog:
            return self._recv_backlog.pop(0)
        msgs = P.load_messages(self.conn.recv_bytes())
        self._recv_backlog.extend(msgs[1:])
        return msgs[0]

    def _request(self, op: str, **kwargs):
        """Blocking metadata request to the head (NODE_REQUEST). The
        req lock scopes reply-slot bookkeeping only; the send is a
        lock-free writer enqueue."""
        fut: Future = Future()
        with self._req_lock:
            self._req_counter += 1
            req_id = self._req_counter
            if racedebug.enabled:
                racedebug.access(self, "_pending", write=True)
            self._pending[req_id] = fut
        try:
            self._send(P.NODE_REQUEST, {"req_id": req_id, "op": op,
                                        "kwargs": kwargs})
            result = fut.result(timeout=60.0)
        finally:
            with self._req_lock:
                self._pending.pop(req_id, None)
        if isinstance(result, dict) and result.get("__error__") is not None:
            raise result["__error__"]
        return result

    def _fail_pending(self, error: BaseException):
        with self._req_lock:
            pending, self._pending = dict(self._pending), {}
        for fut in pending.values():
            if not fut.done():
                fut.set_result({"__error__": error})

    def _heartbeat_loop(self):
        while not self._stopped.wait(self._heartbeat_interval):
            if fault.enabled:
                # raise => exactly one missed ping (the head's
                # miss-limit path) — NOT the send-failure branch below,
                # which would end the loop; kill => this daemon dies
                # mid-job (chaos tier).
                try:
                    fault.fire("daemon.heartbeat", node=self.node_hex[:8])
                except Exception:
                    continue
            try:
                payload = {
                    "ts": time.time(),
                    "store_used": getattr(self.store, "used_bytes", 0),
                    "num_workers": len(self.pool.workers),
                    "free_chips": len(getattr(self, "_free_gpus", ())),
                    "pool_workers": getattr(self, "_pool_workers", 0)}
                if telemetry.enabled:
                    # Metric federation: refresh this node's gauges and
                    # piggyback the whole process-local registry on the
                    # heartbeat (reference: the per-node MetricsAgent
                    # scrape, collapsed onto the existing ping).
                    try:
                        telemetry.record_node_stats(
                            int(payload["store_used"] or 0),
                            payload["num_workers"],
                            payload["free_chips"])
                        telemetry.record_pool_reclaimed(
                            self.node_hex,
                            int(getattr(self.store,
                                        "pool_reclaimed_bytes", 0)))
                        from ..util import metrics as M
                        payload["metrics"] = M.registry_samples()
                        payload["metrics_ts"] = payload["ts"]
                    except Exception:
                        pass
                    self._hb_sent_mono = time.monotonic()
                self._send(P.NODE_PING, payload)
                if telemetry.enabled or tracing.enabled:
                    # Idle-drain nudge to THIS node's workers on the
                    # same heartbeat tick (no new thread): trailing
                    # direct-call events/spans flush without waiting
                    # for the 256-event threshold or the next
                    # head-bound frame.
                    for h in list(self.pool.workers.values()):
                        if h.alive:
                            try:
                                h.send(P.TELEMETRY_DRAIN, {})
                            except Exception:  # lint: broad-except-ok dying worker pipe; WORKER_DIED owns it
                                pass
            except Exception:
                if int(ray_config.head_reconnect_attempts) > 0:
                    # Reconnect mode: the run() loop owns rejoining;
                    # keep ticking so pings resume on the fresh conn.
                    continue
                return

    # -- main loop -----------------------------------------------------
    def run(self):
        try:
            while not self._stopped.is_set():
                try:
                    msg_type, payload = self._recv()
                except (EOFError, OSError):
                    # Head gone. Unblock threads waiting on head replies,
                    # then either rejoin a restarted head (standalone
                    # join mode, head_reconnect_attempts > 0) or die with
                    # the cluster (the in-process test-cluster default).
                    self._fail_pending(
                        ConnectionError("head connection lost"))
                    if int(ray_config.head_reconnect_attempts) > 0:
                        self._reset_for_reconnect()
                        if self._reconnect_with_backoff():
                            continue
                    break
                self._route(msg_type, payload)
        finally:
            self.shutdown()

    def _route(self, msg_type: str, payload: dict):
        if wiretap.enabled:
            wiretap.frame("daemon", "daemon", id(self.conn), "recv",
                          msg_type, payload)
        if msg_type == P.NODE_SYNC:
            # Heartbeat ACK carrying the head's cluster resource view
            # (reference: ray_syncer bidirectional gossip). Kept fresh
            # for local observers and workers (GCS_REQUEST op
            # "local_node_view" serves it without a head round trip).
            self.cluster_view = {"ts": payload.get("ts"),
                                 "view": payload.get("view") or []}
            if telemetry.enabled:
                # Ping->ack round trip (includes head routing time) —
                # the cluster's control-plane health signal. One-shot
                # pairing: clear the stamp so a late ack (or the first
                # sync after a reconnect) can't pair with the wrong
                # ping and record a garbage sample.
                sent = getattr(self, "_hb_sent_mono", None)
                self._hb_sent_mono = None
                if sent is not None:
                    telemetry.record_heartbeat_rtt(
                        time.monotonic() - sent)
            return
        if msg_type in (P.TO_WORKER, P.KILL_WORKER, P.WORKER_DEDICATED,
                        P.RELEASE_OBJECTS):
            # Worker-plane routing runs on the ordered executor, not
            # this recv thread: relays to a wedged worker pipe must not
            # stall heartbeat replies or SHUTDOWN handling, and the
            # executor's FIFO preserves the relay/kill order per
            # worker.
            self._route_exec.submit(self._route_worker_plane, msg_type,
                                    payload)
        elif msg_type == P.START_WORKER:
            self._exec.submit(self._start_worker, payload)
        elif msg_type == P.LOCALIZE_OBJECT:
            # Head-orchestrated push (broadcast tree): pull the object
            # from the named source node and ack (reference:
            # push_manager.h — the sender drives chunked pushes; here
            # the head drives pulls, which reuses the authenticated
            # transfer path).
            def _localize(payload=payload):
                req_id = payload["req_id"]
                try:
                    self.localize(payload["object_id"], payload["node"])
                    result = True
                except BaseException as e:  # noqa: BLE001
                    result = {"__error__": e}
                try:
                    self._send(P.NODE_REPLY,
                               {"req_id": req_id, "result": result})
                except Exception:
                    pass
            self._exec.submit(_localize)
        elif msg_type == P.NODE_REPLY:
            with self._req_lock:
                if racedebug.enabled:
                    racedebug.access(self, "_pending", write=True)
                fut = self._pending.pop(payload["req_id"], None)
            if fut is not None:
                fut.set_result(payload.get("result"))
        elif msg_type == P.DRAIN_NODE:
            # Graceful drain notice: the HEAD coordinates the drain
            # (placement stop, migration, object re-homing) — daemon-
            # side this only acks and flips the local flag so the
            # heartbeat keeps flowing while work evacuates. The fault
            # site lets chaos tests race a drain against SIGKILL.
            if fault.enabled:
                fault.fire("daemon.drain", node=self.node_hex[:8])
            self._draining = True
            try:
                self._send(P.DRAIN_STATUS,
                           {"node_id": self.node_hex,
                            "state": "DRAINING", "ts": time.time()})
            except Exception:  # lint: broad-except-ok head link dying; loss path owns it
                pass
        elif msg_type == P.SHUTDOWN_NODE:
            self._stopped.set()
        else:
            # Unknown head->daemon type: log, never drop silently (a
            # head/daemon version skew would otherwise look like lost
            # work with no trace on either side).
            logger.warning("daemon %s dropping unknown message type %r "
                           "from head (protocol skew?)",
                           self.node_hex[:8], msg_type)

    def _route_worker_plane(self, msg_type: str, payload: dict):
        """Ordered worker-plane handlers (see _route)."""
        if msg_type == P.TO_WORKER:
            handle = self.pool.workers.get(WorkerID(payload["worker"]))
            if handle is not None and handle.alive:
                try:
                    handle.send_raw(payload["frame"])
                except Exception:
                    pass
        elif msg_type == P.KILL_WORKER:
            handle = self.pool.workers.get(WorkerID(payload["worker"]))
            if handle is not None:
                handle.kill()
        elif msg_type == P.WORKER_DEDICATED:
            # An idle pooled worker became a dedicated actor process: it
            # no longer counts against the pool cap (mirrors the head
            # scheduler's conversion accounting).
            handle = self.pool.workers.get(WorkerID(payload["worker"]))
            if handle is not None:
                with self._lock:
                    if getattr(handle, "counted_in_pool", False):
                        self._pool_workers -= 1
                        handle.counted_in_pool = False
                handle.dedicated_actor = payload.get("actor_id")
        elif msg_type == P.RELEASE_OBJECTS:
            oids = payload["object_ids"]
            for oid in oids:
                self.store.free(oid)
            frame = P.dump_message(P.RELEASE_OBJECTS,
                                   {"object_ids": oids})
            for handle in list(self.pool.workers.values()):
                if handle.alive:
                    try:
                        handle.send_raw(frame)
                    except Exception:
                        pass

    # -- worker lifecycle ----------------------------------------------
    def _start_worker(self, payload: dict):
        req_id = payload["req_id"]
        env_key: str = payload["env_key"]
        dedicated: bool = payload.get("dedicated", False)
        counted = False
        gpu_ids: List[int] = []
        try:
            if not dedicated and env_key == "":
                with self._lock:
                    if self._pool_workers >= self._max_pool_workers:
                        raise RuntimeError("worker pool at capacity")
                    self._pool_workers += 1
                    counted = True
            extra_env: Dict[str, str] = {}
            # GPUs to pin; the head sends them under the wire field
            # "nchips" (node_service.py).
            ngpus = int(payload.get("nchips", 0))
            if ngpus > 0:
                with self._lock:
                    if len(self._free_gpus) >= ngpus:
                        gpu_ids = sorted(self._free_gpus.pop(0)
                                         for _ in range(ngpus))
                if not gpu_ids:
                    # Idle GPU workers hold cards; retire them so their
                    # death returns the ids, then let the head's
                    # dispatch retry (same recovery as the head pool's
                    # _reclaim_idle_gpu_workers).
                    self._reclaim_idle_gpu_workers()
                    raise RuntimeError(
                        f"node has no {ngpus} free GPUs "
                        f"(reclaiming idle GPU workers)")
                extra_env = gpu_worker_extra_env(gpu_ids)
            spec_re = payload.get("runtime_env")
            if spec_re:
                from . import runtime_env as re_mod
                extra_env.update(re_mod.worker_extra_env(spec_re))
            handle = self.pool.start_worker(env_key, extra_env)
            handle.gpu_ids = gpu_ids
            handle.counted_in_pool = counted
            self._send(P.NODE_REPLY, {
                "req_id": req_id,
                "result": {"worker_id": handle.worker_id.binary()}})
        except BaseException as e:  # noqa: BLE001
            with self._lock:
                if counted:
                    self._pool_workers -= 1
                if gpu_ids:
                    self._free_gpus.extend(gpu_ids)
            self._send(P.NODE_REPLY, {
                "req_id": req_id, "result": {"__error__": e}})

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

    def _on_worker_death(self, handle: WorkerHandle):
        self.pool.remove(handle)
        with self._lock:
            if getattr(handle, "counted_in_pool", False):
                self._pool_workers -= 1
                handle.counted_in_pool = False
            if handle.gpu_ids:
                self._free_gpus.extend(handle.gpu_ids)
                handle.gpu_ids = []
        try:
            self._send(P.WORKER_DIED,
                       {"worker": handle.worker_id.binary()})
        except Exception:
            pass

    # -- worker messages -----------------------------------------------
    def _on_worker_message(self, handle: WorkerHandle, msg_type: str,
                           payload: dict):
        if wiretap.enabled:
            wiretap.frame("worker", "head", id(handle), "recv",
                          msg_type, payload)
        if msg_type == P.PULL_OBJECT:
            self._exec.submit(self._handle_pull, handle, payload)
            return
        if (msg_type == P.GCS_REQUEST
                and payload.get("op") == "local_node_view"):
            # Serve the gossiped cluster view locally: a worker asking
            # about cluster shape gets the daemon's last NODE_SYNC
            # snapshot without a head round trip (reference: raylets
            # answering from their synced resource view).
            try:
                handle.send(P.REPLY, {
                    "req_id": payload.get("req_id"),
                    "result": {"node_id": self.node_hex,
                               **(getattr(self, "cluster_view", None)
                                  or {"ts": None, "view": []})}})
            except Exception:
                pass
            return
        if (msg_type == P.GCS_REQUEST
                and payload.get("op") == "spill_store"):
            # Full-arena escalation targets the FULL NODE's store — this
            # one, not the head's (relaying would spill the head's arena
            # while the worker's local arena stays full). Dispatched on
            # the executor like PULL_OBJECT: a multi-GB spill is seconds
            # of disk IO, and running it inline would stall this
            # message-routing thread (heartbeats, task relays) for the
            # duration.
            def _spill(payload=payload):
                try:
                    from .object_store import escalated_spill
                    reclaimed = escalated_spill(
                        self.store,
                        payload.get("kwargs", {}).get("need", 0))
                except Exception:  # lint: broad-except-ok best-effort escalated spill: 0 reclaimed tells the requesting worker to fail its own reserve with the real ObjectStoreFullError
                    reclaimed = 0
                try:
                    handle.send(P.REPLY,
                                {"req_id": payload.get("req_id"),
                                 "result": reclaimed})
                except Exception:  # lint: broad-except-ok dying worker pipe: the spill reply has nowhere to go and WORKER_DIED owns the cleanup
                    pass
            self._exec.submit(_spill)
            return
        # Tag node-local shm locations with this node's id so the head
        # registers WHERE the object lives (ownership-based object
        # directory, ownership_based_object_directory.h) and skips its
        # local-store adoption.
        if msg_type == P.TASK_DONE:
            payload = self._tag_done(payload)
        elif msg_type == P.TASKS_DONE:
            payload = dict(payload)
            payload["batch"] = [self._tag_done(d)
                                for d in payload["batch"]]
        elif msg_type == P.GEN_ITEM:
            from .ids import object_id_for_return
            payload = dict(payload)
            payload["loc"] = self._tag_loc(
                payload["loc"],
                object_id_for_return(payload["task_id"], payload["index"]))
        elif msg_type == P.OWNED_PUT and "size" in payload:
            payload = dict(payload)
            payload["node"] = self.node_hex
            self.store.adopt(payload["object_id"], payload["size"])
        try:
            self._send(P.FROM_WORKER, {
                "worker": handle.worker_id.binary(),
                "frame": P.dump_message(msg_type, payload)})
        except Exception:  # lint: broad-except-ok head link down mid-relay: the reconnect loop owns recovery and the worker's own request timeout surfaces the lost frame
            pass

    def _tag_done(self, done: dict) -> dict:
        """Tag one TASK_DONE payload's result locations with this
        node's id (shared by the single and batched completion
        relays)."""
        if not done.get("results"):
            return done
        done = dict(done)
        oids = done.get("return_oids") or [None] * len(done["results"])
        done["results"] = [self._tag_loc(loc, oid) for loc, oid
                           in zip(done["results"], oids)]
        return done

    def _tag_loc(self, loc, oid=None):
        if loc and loc[0] == P.LOC_SHM:
            if oid is not None:
                # Node-local capacity accounting for the worker-created
                # segment (the head only adopts segments on its own node).
                self.store.adopt(oid, loc[1])
            return (P.LOC_SHM, loc[1], self.node_hex)
        return loc

    def _handle_pull(self, handle: WorkerHandle, payload: dict):
        req_id = payload["req_id"]
        try:
            oid = payload["object_id"]
            self.localize(oid, payload["node"])
            # Adopted (zero-copy) objects live in ANOTHER node's arena;
            # the worker's own store handle can't see them, so ship the
            # mapping and let the worker adopt unpinned (our pin + the
            # head's task-arg refs cover the read's lifetime). If the
            # owner's arena file is gone (node died; our established
            # mmap still works but NEW mmaps can't), materialize a real
            # local copy instead of shipping a dead path.
            import os as _os
            ext = getattr(self.store, "export_adoption",
                          lambda _o: None)(oid)
            if ext is not None and (payload.get("materialize")
                                    or not _os.path.exists(ext[0])):
                self.store.materialize_external(oid)
                ext = None
            result = {"adopt": ext} if ext is not None else True
        except BaseException as e:  # noqa: BLE001
            result = {"__error__": e}
        try:
            handle.send(P.REPLY, {"req_id": req_id, "result": result})
        except Exception:  # lint: broad-except-ok dying worker pipe: the pull reply has nowhere to go and WORKER_DIED owns the cleanup
            pass

    def localize(self, object_id, source_node_hex: str):
        """Pull `object_id` into the node-local store from wherever the
        directory says it lives (reference: raylet DependencyManager +
        PullManager fetch)."""
        if self.store.contains(object_id):
            return
        addr = self._transfer_addrs.get(source_node_hex)
        if addr is None:
            addr = self._request("transfer_addr", node_hex=source_node_hex)
            if addr is None:
                from ..exceptions import NodeDiedError
                raise NodeDiedError(
                    source_node_hex,
                    f"object {object_id.hex()[:8]}: source node "
                    f"{source_node_hex[:8]} is gone")
            addr = tuple(addr)
            self._transfer_addrs[source_node_hex] = addr
        self.pull_mgr.pull(object_id, addr[0], addr[1])

    def shutdown(self):
        if getattr(self, "_shutdown_done", False):
            return
        self._shutdown_done = True
        self._stopped.set()
        try:
            self.pool.shutdown()
        except Exception:  # lint: broad-except-ok best-effort teardown: every subsystem stops even if one is already dead
            pass
        try:
            self.transfer.stop()
            self.pull_mgr.shutdown()
        except Exception:  # lint: broad-except-ok best-effort teardown: every subsystem stops even if one is already dead
            pass
        try:
            self.store.shutdown()
        except Exception:  # lint: broad-except-ok best-effort teardown: every subsystem stops even if one is already dead
            pass
        import shutil
        shutil.rmtree(self.session_dir, ignore_errors=True)
        try:
            self._route_exec.close(drain_timeout=0.5)
        except Exception:  # lint: broad-except-ok best-effort teardown: every subsystem stops even if one is already dead
            pass
        with self._conn_lock:
            w = self._writer
        try:
            if w is not None:
                w.close(flush_timeout=0.5)
        except Exception:  # lint: broad-except-ok best-effort teardown: every subsystem stops even if one is already dead
            pass
        try:
            self.conn.close()
        except Exception:  # lint: broad-except-ok best-effort teardown: every subsystem stops even if one is already dead
            pass


def _main():
    import argparse
    import json

    parser = argparse.ArgumentParser(description="ray_tpu_torch node daemon")
    parser.add_argument("--address", required=True,
                        help="head control address host:port")
    parser.add_argument("--token-hex", default=None)
    parser.add_argument("--num-cpus", type=float, default=None)
    parser.add_argument("--num-gpus", type=float, default=None,
                        help="GPUs of this node (default: detected)")
    parser.add_argument("--resources", default=None,
                        help="JSON dict of custom resources")
    parser.add_argument("--labels", default=None,
                        help="JSON dict of node labels (reference: "
                             "`ray start --labels`)")
    args = parser.parse_args()
    token_hex = args.token_hex or os.environ.get(
        "RTT_CLUSTER_TOKEN_HEX")
    if not token_hex:
        raise SystemExit("cluster token required: --token-hex or "
                         "RTT_CLUSTER_TOKEN_HEX")
    host, _, port = args.address.rpartition(":")
    if (host not in ("127.0.0.1", "localhost")
            and "RTT_NODE_HOST" not in os.environ):
        # Remote head: this node's transfer server must be reachable
        # from the other hosts, not loopback-only (mirrors cli.py).
        from .config import ray_config
        ray_config.set("node_host", "0.0.0.0")
    daemon = NodeDaemon(
        (host, int(port)), bytes.fromhex(token_hex),
        num_cpus=args.num_cpus, num_gpus=args.num_gpus,
        resources=json.loads(args.resources) if args.resources else None,
        labels=json.loads(args.labels) if args.labels else None)

    # SIGTERM (cluster_utils remove_node / operator stop) must run the
    # shutdown path so session/store dirs are cleaned — but must NOT
    # interrupt a shutdown already in progress (it would abort the
    # rmtree half way).
    import signal
    import sys as _sys

    def _on_term(*_):
        if not daemon._stopped.is_set():
            _sys.exit(0)

    signal.signal(signal.SIGTERM, _on_term)
    daemon.run()


if __name__ == "__main__":
    _main()
