"""Head-side multi-host control plane: daemon registry + worker proxies.

The GCS-server face of the cluster (reference: gcs/gcs_server/
gcs_server_main.cc:47 — the service raylets register with;
gcs_node_manager.cc node membership; gcs_health_check_manager.h:45
liveness). The head keeps one authenticated TCP connection per node
daemon; workers on remote nodes appear to the runtime as
``RemoteWorkerProxy`` objects that quack exactly like local
``WorkerHandle``s, so task dispatch, actor restart, retry, and death
handling reuse the single-host code paths unchanged.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from concurrent.futures import Future
from typing import Callable, Deque, Dict, List, Optional, Tuple

import collections

from ..util import tracing
from . import fault
from . import lockdep
from . import protocol as P
from . import racedebug
from . import telemetry
from . import wiretap
from .ids import WorkerID

logger = logging.getLogger(__name__)


class RemoteWorkerProxy:
    """Head-side stand-in for a worker process on another node
    (reference: the GCS/driver's view of a leased remote worker)."""

    is_remote = True

    def __init__(self, daemon: "DaemonHandle", worker_id: WorkerID,
                 env_key: str):
        self.daemon = daemon
        self.worker_id = worker_id
        self.env_key = env_key
        self.env: Dict[str, str] = {}
        self.proc = None
        # dispatch_lock guards {fn-cache check -> enqueue} exactly like
        # the local WorkerHandle's; the enqueue itself is the daemon
        # writer queue (nonblocking), so unlike the old send-lock days
        # nothing IO-bound ever runs under it. No send_lock here: sends
        # serialize on the daemon connection's writer queue.
        self.dispatch_lock = lockdep.lock("node_service.proxy_dispatch")
        self.dedicated_actor = None
        self.running: Dict[bytes, P.TaskSpec] = {}
        self.fn_cache: set = set()
        self.lease = None      # handle parity with WorkerHandle
        self.inflight = 0
        self.blocked = 0
        self.lease_released = False
        self.gpu_ids: List[int] = []
        self.alive = True
        self.last_dispatch_ts = 0.0
        self.death_handled = False
        self.node_id_hex = daemon.node_id_hex

    def send(self, msg_type: str, payload: dict):
        # The relayed frame is pickled HERE (payload state captured at
        # call time) and rides the TO_WORKER envelope as a pickle-5
        # out-of-band buffer when large — the daemon writer ships it as
        # its own iovec instead of copying it into the envelope.
        frame = P.dump_message(msg_type, payload)
        if len(frame) > 16 * 1024:
            import pickle
            frame = pickle.PickleBuffer(frame)
        self.daemon.send(P.TO_WORKER, {
            "worker": self.worker_id.binary(), "frame": frame})

    def kill(self):
        self.alive = False
        try:
            self.daemon.send(P.KILL_WORKER,
                             {"worker": self.worker_id.binary()})
        except Exception:  # lint: broad-except-ok dying daemon link; node-loss path owns its workers
            pass


class DaemonHandle:
    """One registered node daemon: connection, worker proxies, idle pool
    (the head's view of a raylet; reference: GcsNodeManager node entry +
    the per-node RayletClient)."""

    def __init__(self, conn, node_id_hex: str, resources: Dict[str, float],
                 transfer_addr: Tuple[str, int], hostname: str, pid: int,
                 labels: Optional[Dict[str, str]] = None, loop=None):
        self.conn = conn
        self.node_id_hex = node_id_hex
        self.resources = resources
        self.transfer_addr = transfer_addr
        self.hostname = hostname
        self.pid = pid
        self.labels = dict(labels or {})
        self.alive = True
        self.last_ping = time.time()        # wall clock: display only
        self.last_ping_mono = time.monotonic()  # liveness decisions
        self.load: dict = {}
        # Outbound writer: sends from ANY head thread (scheduler
        # dispatch, broadcasts, request replies) enqueue here and the
        # drain coalesces them into one vectored write per wakeup.
        # With a ControlLoop the drain rides the loop's EVENT_WRITE
        # (netcomm.LoopWriter — zero threads per connection); without
        # one (direct construction in tests) the threaded
        # ConnectionWriter stands in with identical semantics.
        if loop is not None:
            from .netcomm import LoopWriter
            self._writer = LoopWriter(
                conn, loop, name=f"daemon-writer-{node_id_hex[:8]}")
        else:
            from .netcomm import ConnectionWriter
            self._writer = ConnectionWriter(
                conn, name=f"daemon-writer-{node_id_hex[:8]}")
        self._lock = lockdep.lock("node_service.daemon_handle")
        self.proxies: Dict[bytes, RemoteWorkerProxy] = {}
        self._idle: Dict[str, Deque[RemoteWorkerProxy]] = \
            collections.defaultdict(collections.deque)
        # _req_lock scope: reply-slot bookkeeping ONLY (counter +
        # pending-future table). Holding it across the send used to
        # serialize unrelated head->daemon requests behind one
        # write(2); sends are lock-free enqueues now.
        self._req_lock = lockdep.lock("node_service.daemon_req")
        self._req_counter = 0
        self._pending: Dict[int, Future] = {}
        # Workers whose WORKER_DIED arrived before start_worker() could
        # register the proxy (boot-crash race).
        self.dead_workers: set = set()
        # Per-connection ordered routing executor: the recv thread
        # parses frames and hands worker-plane messages here (see
        # HeadServer._route) instead of running handlers inline.
        from .netcomm import SerialExecutor
        self._route_exec = SerialExecutor(
            name=f"daemon-route-{node_id_hex[:8]}")

    # -- link ----------------------------------------------------------
    def send(self, msg_type: str, payload: dict):
        self._writer.send_message(msg_type, payload)

    def request(self, msg_type: str, payload: dict, timeout: float = 120.0):
        fut: Future = Future()
        with self._req_lock:
            self._req_counter += 1
            req_id = self._req_counter
            if racedebug.enabled:
                racedebug.access(self, "_pending", write=True)
            self._pending[req_id] = fut
        payload = dict(payload)
        payload["req_id"] = req_id
        try:
            self.send(msg_type, payload)
            result = fut.result(timeout=timeout)
        finally:
            with self._req_lock:
                self._pending.pop(req_id, None)
        if isinstance(result, dict) and result.get("__error__") is not None:
            raise result["__error__"]
        return result

    def resolve_reply(self, payload: dict):
        with self._req_lock:
            if racedebug.enabled:
                racedebug.access(self, "_pending", write=True)
            fut = self._pending.pop(payload["req_id"], None)
        if fut is not None:
            fut.set_result(payload.get("result"))

    def fail_pending(self, error: BaseException):
        with self._req_lock:
            pending, self._pending = dict(self._pending), {}
        for fut in pending.values():
            if not fut.done():
                fut.set_result({"__error__": error})

    def close_link(self):
        """Tear down the writer + routing executor (connection gone)."""
        try:
            self._route_exec.close()
        except Exception:  # lint: broad-except-ok teardown of an already-dead link; logged below
            logger.debug("route-executor close failed", exc_info=True)
        try:
            self._writer.close(flush_timeout=0.5)
        except Exception:  # lint: broad-except-ok teardown of an already-dead link; logged below
            logger.debug("writer close failed", exc_info=True)

    # -- worker pool face (mirrors WorkerPool pop/push/remove) ---------
    def pop_idle(self, env_key: str = "") -> Optional[RemoteWorkerProxy]:
        with self._lock:
            dq = self._idle.get(env_key)
            while dq:
                h = dq.popleft()
                if h.alive:
                    return h
            return None

    def push_idle(self, handle: RemoteWorkerProxy):
        if not handle.alive or handle.dedicated_actor is not None \
                or not self.alive:
            return
        with self._lock:
            self._idle[handle.env_key].append(handle)

    def remove(self, handle: RemoteWorkerProxy):
        with self._lock:
            self.proxies.pop(handle.worker_id.binary(), None)
            dq = self._idle.get(handle.env_key)
            if dq:
                try:
                    dq.remove(handle)
                except ValueError:
                    pass

    def start_worker(self, env_key: str, spec,
                     dedicated: bool = False) -> RemoteWorkerProxy:
        """Synchronous remote worker start (the lease-grant round trip,
        node_manager.cc:1868)."""
        from .placement import gpus_in_demand
        nchips = 0  # GPUs to pin (the wire field keeps its name)
        if env_key.startswith("gpu:"):
            nchips = gpus_in_demand(spec.resources) or 1
        reply = self.request(P.START_WORKER, {
            "env_key": env_key, "dedicated": dedicated, "nchips": nchips,
            "runtime_env": getattr(spec, "runtime_env", None)})
        wid = WorkerID(reply["worker_id"])
        proxy = RemoteWorkerProxy(self, wid, env_key)
        with self._lock:
            self.proxies[wid.binary()] = proxy
            if wid.binary() in self.dead_workers:
                self.dead_workers.discard(wid.binary())
                self.proxies.pop(wid.binary(), None)
                raise RuntimeError("remote worker died during startup")
        return proxy


class HeadServer:
    """Accepts daemon registrations over TCP and pumps their messages
    into the runtime (reference: the GCS gRPC server face)."""

    def __init__(self, node, token: bytes, host: str = "127.0.0.1",
                 port: int = 0):
        import socket as _socket
        from concurrent.futures import ThreadPoolExecutor
        from .config import ray_config
        from .netcomm import ControlLoopGroup
        self._node = node
        self._token = token
        self._sock = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
        self._sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self.address: Tuple[str, int] = self._sock.getsockname()
        self.daemons: Dict[str, DaemonHandle] = {}
        self._lock = lockdep.lock("node_service.head_registry")
        self._stopped = False
        self._stop_event = threading.Event()
        # Sharded selector event loops own every daemon connection —
        # reads, frame reassembly and writer drains all run on
        # O(loops) threads instead of 2-3 threads per connection (the
        # reference's GCS server: one asio io_service face for every
        # raylet; SURVEY L1). head_event_loops=0 means auto (half the
        # cores, capped at 2 — control traffic is cheap per event).
        n_loops = int(ray_config.head_event_loops)
        if n_loops <= 0:
            n_loops = min(2, max(1, (os.cpu_count() or 1) // 2))
        self._loops = ControlLoopGroup(n_loops, name="head-loop")  # lint: guarded-by-ok immutable after __init__: the loop group owns its own locking
        # The auth challenge + REGISTER_NODE read are BLOCKING
        # (multiprocessing's deliver/answer_challenge, bounded by a 10s
        # SO_RCVTIMEO) — a small pool keeps a connect-and-send-nothing
        # dialer from wedging registration, without hand-rolling the
        # hmac dance as a nonblocking DFA.
        self._hs_pool = ThreadPoolExecutor(  # lint: guarded-by-ok immutable after __init__: stdlib executor is internally synchronized
            max_workers=4, thread_name_prefix="head-handshake")
        # Connection teardown (close_link drains the route executor +
        # writer for up to ~2.5s) gets its OWN pool: under a mass
        # disconnect (partition, head restart) teardowns would
        # otherwise occupy every handshake worker and reconnecting
        # daemons' registrations would queue behind them for minutes.
        # Threads spawn lazily, so an idle head pays nothing.
        self._td_pool = ThreadPoolExecutor(  # lint: guarded-by-ok immutable after __init__: stdlib executor is internally synchronized
            max_workers=16, thread_name_prefix="head-teardown")
        self._loops.add_acceptor(self._sock, self._on_accept)
        # Liveness beyond TCP: a frozen daemon (or a half-open link)
        # keeps its connection "up" while pings stop. Bounded tolerance,
        # then the node is declared dead (reference:
        # gcs_health_check_manager.h failure_threshold).
        self._monitor_thread = threading.Thread(
            target=self._heartbeat_monitor, daemon=True,
            name="head-hb-monitor")
        self._monitor_thread.start()

    def loop_stats(self) -> List[dict]:
        """Per-event-loop gauges (registered fds, wakeups, iteration
        lag) for the federated /metrics exposition."""
        return self._loops.stats()

    def _heartbeat_monitor(self):
        from .config import ray_config
        last_drain = 0.0
        while not self._stop_event.is_set():
            interval = float(ray_config.node_heartbeat_s)
            self._stop_event.wait(min(max(interval / 2, 0.05), 1.0))
            now_mono = time.monotonic()
            if ((telemetry.enabled or tracing.enabled)
                    and now_mono - last_drain >= interval):
                # Idle-drain nudge to HEAD-ATTACHED workers on the
                # heartbeat cadence (daemons nudge their own workers
                # from their heartbeat loop): flushes trailing
                # direct-call events/spans with no completion frame to
                # ride, without any new thread. The nudge is a oneway
                # enqueue on each worker pipe — a dead pipe is the
                # death path's problem, not this loop's.
                last_drain = now_mono
                try:
                    for h in list(self._node.pool.workers.values()):
                        if h.alive:
                            try:
                                h.send(P.TELEMETRY_DRAIN, {})
                            except Exception:  # lint: broad-except-ok dying worker pipe; the death callback owns it
                                pass
                except Exception:  # lint: broad-except-ok pool mutating mid-teardown; the nudge is best-effort
                    pass
            limit = float(ray_config.node_heartbeat_miss_limit)
            if limit <= 0:
                continue
            budget = interval * limit
            # Monotonic on both sides: an NTP step or a VM suspend must
            # not make every node's wall-clock ping age jump past the
            # budget at once (a mass spurious node death).
            now = time.monotonic()
            for handle in self.all_daemons():
                if (not handle.alive
                        or now - handle.last_ping_mono <= budget):
                    continue
                import logging
                logging.getLogger(__name__).warning(
                    "node %s missed heartbeats for %.1fs "
                    "(> %g x %.1fs): declaring it dead",
                    handle.node_id_hex[:8], now - handle.last_ping_mono,
                    limit, interval)
                handle.alive = False
                # Tear the socket down with shutdown(), not just
                # close(): the daemon's recv loop is blocked in read on
                # this fd, and closing an fd another thread is reading
                # does NOT wake the reader — shutdown() does. The woken
                # loop then runs the one true death path
                # (_on_daemon_lost: object loss marking, worker
                # failure, registry removal).
                # shutdown() only — no close() here: the woken recv
                # loop's finally owns closing the Connection. Closing
                # from this thread would free the fd number while
                # sender threads may be mid-write on it (fd-reuse
                # cross-connection corruption).
                import socket as _socket
                try:
                    s = _socket.socket(
                        fileno=os.dup(handle.conn.fileno()))
                    try:
                        s.shutdown(_socket.SHUT_RDWR)
                    finally:
                        s.close()
                except Exception:  # lint: broad-except-ok fd already closed by the recv loop's finally; either path ends the link
                    pass

    def _on_accept(self, sock):
        """Loop-thread accept callback: hand the blocking auth
        handshake to the pool — the loop itself never blocks on a
        dialer."""
        if self._stopped:
            try:
                sock.close()
            except OSError:
                pass
            return
        try:
            self._hs_pool.submit(self._handshake_and_register, sock)
        except RuntimeError:
            # Pool already shut down (stop() raced the accept).
            try:
                sock.close()
            except OSError:
                pass

    def _handshake(self, sock):
        """multiprocessing-compatible auth with a deadline, then wrap the
        fd in a Connection (the daemon side uses plain Client())."""
        import socket as _socket
        import struct as _struct
        from multiprocessing.connection import (Connection,
                                                answer_challenge,
                                                deliver_challenge)
        # SO_RCVTIMEO bounds the raw reads Connection does during auth.
        sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_RCVTIMEO,
                        _struct.pack("ll", 10, 0))
        # Uniform control-socket setup: NODELAY (the micro-batching
        # writers replace Nagle) + KEEPALIVE (half-open daemon links
        # must eventually error, not wedge recv loops forever).
        sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_KEEPALIVE, 1)
        conn = Connection(sock.detach())
        deliver_challenge(conn, self._token)
        answer_challenge(conn, self._token)
        return conn

    def _handshake_and_register(self, sock):
        """Pool-thread registration: blocking auth + the REGISTER_NODE
        first frame (both bounded by the 10s SO_RCVTIMEO), then the
        connection is ADOPTED by its assigned event loop — from that
        point reads, routing and writer drains cost this connection
        zero dedicated threads."""
        handle: Optional[DaemonHandle] = None
        conn = None
        try:
            try:
                conn = self._handshake(sock)
            except Exception:  # lint: broad-except-ok unauthenticated/garbage dialer; drop the socket, nothing registered yet
                try:
                    sock.close()
                except OSError:
                    pass
                return
            first_msgs = P.load_messages(conn.recv_bytes())
            msg_type, payload = first_msgs[0]
            if msg_type != P.REGISTER_NODE:
                conn.close()
                return
            # Registration done: drop the handshake read deadline — the
            # daemon link is long-lived and legitimately idle.
            try:
                import socket as _socket
                import struct as _struct
                s = _socket.socket(fileno=os.dup(conn.fileno()))
                s.setsockopt(_socket.SOL_SOCKET, _socket.SO_RCVTIMEO,
                             _struct.pack("ll", 0, 0))
                s.close()
            except OSError:
                pass
            peer_host = "127.0.0.1"
            try:
                # multiprocessing.Connection doesn't expose the peer; the
                # daemon's reachable host comes from the socket (fromfd
                # dups the fd, so closing it leaves the connection alone).
                import socket as _s
                s = _s.fromfd(conn.fileno(), _s.AF_INET, _s.SOCK_STREAM)
                peer_host = s.getpeername()[0]
                s.close()
            except Exception:  # lint: broad-except-ok peer address is cosmetic; loopback default stands
                pass
            loop = self._loops.assign()
            handle = DaemonHandle(
                conn, payload["node_id_hex"], payload["resources"],
                (peer_host, payload["transfer_port"]),
                payload.get("hostname", ""), payload.get("pid", 0),
                labels=payload.get("labels"), loop=loop)
            if wiretap.enabled:
                wiretap.frame("daemon", "head", id(handle), "recv",
                              P.REGISTER_NODE, payload)
            # ACK strictly FIRST: registration wakes the scheduler, which
            # may dispatch START_WORKER to this daemon immediately — the
            # daemon's handshake must not see that before the ack. The
            # enqueue order on the writer queue is the wire order; the
            # bytes ship when the loop adopts the connection below.
            ack = {
                "head_node_id_hex": self._node.node_id.hex(),
                "head_transfer_port": self._node.transfer_port}
            if wiretap.enabled:
                wiretap.frame("daemon", "head", id(handle), "send",
                              P.NODE_ACK, ack)
            handle.send(P.NODE_ACK, ack)
            self._node._on_daemon_registered(handle)
            with self._lock:
                self.daemons[handle.node_id_hex] = handle
            # A reconnecting daemon's writer may have coalesced early
            # messages (heartbeats, worker relays) into the SAME frame
            # as REGISTER_NODE; route them now or they are lost. This
            # MUST precede loop adoption: once the loop owns the fd it
            # may dispatch later frames, and those must not overtake
            # the frame-mates.
            for mt, pl in first_msgs[1:]:
                self._route(handle, mt, pl)
            loop.register_conn(conn, handle._writer, self._on_daemon_msgs,
                               self._on_conn_eof, handle)
        except Exception:  # noqa: BLE001 — registration failed mid-flight (EOF, reset, malformed frame, or a registration callback); run the one true loss path
            if handle is not None:
                self._teardown_conn(handle)
            elif conn is not None:
                try:
                    conn.close()
                except Exception:  # lint: broad-except-ok conn half-open from a failed handshake; teardown is idempotent
                    pass

    def _on_daemon_msgs(self, handle: DaemonHandle, msgs):
        """Loop-thread frame dispatch: a frame may carry a coalesced
        burst from the daemon's writer; expand and route in order."""
        for msg_type, payload in msgs:
            self._route(handle, msg_type, payload)

    def _on_conn_eof(self, handle: DaemonHandle):
        """Loop-thread EOF/error: the loop already dropped the fd;
        offload the teardown (executor drains block for up to seconds
        and must never stall the other connections on this loop —
        nor the handshake pool, which disconnect storms would
        starve)."""
        try:
            self._td_pool.submit(self._teardown_conn, handle)
        except RuntimeError:
            # Pool gone: stop() owns teardown of every live handle.
            pass

    def _teardown_conn(self, handle: DaemonHandle):
        handle.alive = False
        # Drain routed-but-unprocessed worker messages (bounded)
        # BEFORE death handling: completions that arrived ahead
        # of the EOF must not be retried as failures, exactly as
        # under the old inline routing.
        handle.close_link()
        from ..exceptions import NodeDiedError
        handle.fail_pending(
            NodeDiedError(handle.node_id_hex,
                          f"node {handle.node_id_hex[:8]} "
                          f"disconnected"))
        # A reconnecting daemon re-registers the SAME node id on
        # a fresh connection; this stale connection's cleanup
        # must not evict the new registration (reference: GCS
        # node re-registration vs. old-channel teardown race).
        with self._lock:
            current = self.daemons.get(handle.node_id_hex)
            superseded = current is not None and current is not handle
            if not superseded:
                self.daemons.pop(handle.node_id_hex, None)
        if not self._stopped:
            if superseded:
                # The node re-registered on a fresh connection;
                # keep it alive but fail THIS connection's
                # worker proxies (their processes are gone and
                # can never report WORKER_DIED).
                self._node._fail_daemon_worker_proxies(handle)
            else:
                self._node._on_daemon_lost(handle)
        try:
            handle.conn.close()
        except Exception:  # lint: broad-except-ok conn may already be closed; teardown is idempotent
            pass

    def _route(self, handle: DaemonHandle, msg_type: str, payload: dict):
        # Worker-plane messages run on the handle's ordered executor,
        # not this recv thread: decode stays hot while slow handlers
        # (task-done bookkeeping, death handling) drain off-thread in
        # arrival order (WORKER_DIED must never overtake the worker's
        # final TASK_DONE).
        if telemetry.enabled:
            # Daemon-plane half of the head's per-type ingest counters
            # (relayed worker messages count again at the worker mux —
            # the two planes are separate loops with separate budgets).
            telemetry.count_msg(msg_type)
        if wiretap.enabled:
            wiretap.frame("daemon", "head", id(handle), "recv",
                          msg_type, payload)
        if msg_type == P.FROM_WORKER:
            handle._route_exec.submit(self._route_from_worker, handle,
                                      payload)
        elif msg_type == P.WORKER_DIED:
            handle._route_exec.submit(self._route_worker_died, handle,
                                      payload)
        elif msg_type == P.NODE_PING:
            handle.last_ping = time.time()
            handle.last_ping_mono = time.monotonic()
            handle.load = {k: payload.get(k)
                           for k in ("store_used", "num_workers",
                                     "free_chips", "pool_workers")}
            # Metric federation: the daemon's registry snapshot rides
            # the ping; store the latest per node for the dashboard's
            # merged /metrics exposition (telemetry.py).
            snap = payload.get("metrics")
            if snap is not None:
                try:
                    self._node.gcs.telemetry.metrics_put(
                        scope="node", node_id=handle.node_id_hex,
                        worker_id=None, groups=snap,
                        ts=payload.get("metrics_ts"))
                except Exception:  # lint: broad-except-ok malformed metrics snapshot must not kill the ping route
                    pass
            # Bidirectional sync (reference: ray_syncer.h — raylets and
            # the GCS gossip per-node resource views over a stream):
            # every heartbeat is acknowledged with the scheduler's
            # current cluster view, so each daemon holds a fresh map of
            # every node's totals/availability — the data a local
            # fallback scheduler or observer needs without asking the
            # head. ONE snapshot per second is shared across all N
            # daemons' acks (the reference sends versioned deltas for
            # the same reason): rebuilding O(N) rows per ping would be
            # O(N^2) registry scans per interval.
            try:
                now = time.time()
                cached = getattr(self, "_sync_cache", None)
                if cached is None or now - cached[0] > 1.0:
                    cached = (now, self._node.node_registry.snapshot())
                    self._sync_cache = cached
                handle.send(P.NODE_SYNC, {"ts": cached[0],
                                          "view": cached[1]})
            except Exception:  # lint: broad-except-ok dying conn: the heartbeat monitor handles it
                pass
        elif msg_type == P.NODE_REPLY:
            handle.resolve_reply(payload)
        elif msg_type == P.NODE_REQUEST:
            self._node._handler_pool.submit(
                self._handle_node_request, handle, payload)
        elif msg_type == P.DRAIN_STATUS:
            # Draining daemon's ack/progress for the head coordinator.
            self._node._on_drain_status(payload)
        else:
            # Unknown daemon->head type: log, never drop silently — a
            # daemon running newer protocol code would otherwise lose
            # messages without a trace on either side.
            logger.warning("head dropping unknown message type %r from "
                           "node %s (protocol skew?)", msg_type,
                           handle.node_id_hex[:8])

    def _route_from_worker(self, handle: DaemonHandle, payload: dict):
        proxy = handle.proxies.get(payload["worker"])  # lint: guarded-by-ok GIL-atomic get on the hot routing path; a miss during registration is indistinguishable from the frame arriving first
        if proxy is None:
            return
        for inner_type, inner_payload in P.load_messages(payload["frame"]):
            self._node._on_worker_message(proxy, inner_type, inner_payload)

    def _route_worker_died(self, handle: DaemonHandle, payload: dict):
        proxy = handle.proxies.get(payload["worker"])  # lint: guarded-by-ok GIL-atomic get; the dead_workers fallback below re-checks under the lock
        if proxy is None:
            with handle._lock:
                handle.dead_workers.add(payload["worker"])
            return
        handle.remove(proxy)
        if not proxy.death_handled:
            proxy.death_handled = True
            proxy.alive = False
            self._node._on_worker_death(proxy)

    def _handle_node_request(self, handle: DaemonHandle, payload: dict):
        req_id = payload["req_id"]
        try:
            op = payload["op"]
            kwargs = payload.get("kwargs") or {}
            if fault.enabled:
                fault.fire("gcs.op", op=op)
            if op == "transfer_addr":
                result = self._node.transfer_addr_of(kwargs["node_hex"])
            else:
                result = self._node._gcs_op(op, kwargs)
        except BaseException as e:  # noqa: BLE001
            result = {"__error__": e}
        try:
            handle.send(P.NODE_REPLY, {"req_id": req_id, "result": result})
        except Exception:  # lint: broad-except-ok requester's conn died; its daemon retries or the loss path runs
            pass

    def broadcast(self, msg_type: str, payload: dict):
        with self._lock:
            daemons = list(self.daemons.values())
        for d in daemons:
            if d.alive:
                try:
                    d.send(msg_type, payload)
                except Exception:  # lint: broad-except-ok one dead daemon must not stop the broadcast; its loss path runs separately
                    pass

    def all_daemons(self) -> List[DaemonHandle]:
        """Snapshot under the lock — registration/eviction are
        concurrent with callers iterating."""
        with self._lock:
            return list(self.daemons.values())

    def all_proxies(self) -> List[RemoteWorkerProxy]:
        out: List[RemoteWorkerProxy] = []
        for d in self.all_daemons():
            # Snapshot under the daemon's lock: start_worker/remove
            # mutate the table concurrently with this iteration.
            with d._lock:
                out.extend(d.proxies.values())
        return out

    def stop(self):
        self._stopped = True
        self._stop_event.set()
        with self._lock:
            daemons = list(self.daemons.values())
            self.daemons.clear()
        # Goodbyes FIRST, while the loops still drain writers; the
        # flush bounds how long each daemon's SHUTDOWN_NODE may take to
        # reach the wire.
        for d in daemons:
            try:
                d.send(P.SHUTDOWN_NODE, {})
            except Exception:  # lint: broad-except-ok best-effort teardown: every subsystem stops even if one is already dead
                pass
            try:
                d._writer.flush(0.5)
            except Exception:  # lint: broad-except-ok best-effort teardown: every subsystem stops even if one is already dead
                pass
        self._loops.stop()
        self._hs_pool.shutdown(wait=False)
        self._td_pool.shutdown(wait=False)
        try:
            self._sock.close()
        except Exception:  # lint: broad-except-ok best-effort teardown: every subsystem stops even if one is already dead
            pass
        from ..exceptions import NodeDiedError
        for d in daemons:
            d.alive = False
            d.close_link()
            d.fail_pending(NodeDiedError(
                d.node_id_hex,
                f"node {d.node_id_hex[:8]} disconnected"))
            try:
                d.conn.close()
            except Exception:  # lint: broad-except-ok best-effort teardown: every subsystem stops even if one is already dead
                pass
