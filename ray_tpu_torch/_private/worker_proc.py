"""Worker process: task/actor execution loop.

TPU-native analogue of the reference's worker process stack — the
`default_worker.py` entrypoint running `CoreWorker.run_task_loop`
(python/ray/_private/workers/default_worker.py:297, _raylet.pyx:3035) and the
server side of task transport (TaskReceiver + scheduling queues,
src/ray/core_worker/transport/). One process == one worker; an actor worker
holds exactly one actor instance, like the reference.

Threading model:
  * main thread: recv loop over the duplex pipe to the driver; it only routes
    (never blocks on user code), like the reference's io_service.
  * task pool: normal tasks run on a thread pool (driver admission-controls
    how many run concurrently via resource accounting).
  * actor executor: ordered single thread by default (the reference's
    ActorSchedulingQueue sequencing); `max_concurrency>1` uses a pool, and
    async actors get a dedicated asyncio event loop (the reference's fibers,
    transport/fiber.h).

Nested API calls (get/put/remote inside a task) round-trip to the driver over
the same pipe with request ids; replies are routed to waiting futures.
"""

from __future__ import annotations

import asyncio
import ctypes
import inspect
import logging
import os
import sys
import threading
import time
import traceback
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import cloudpickle

from ..exceptions import TaskCancelledError, TaskError
from ..util import tracing
from . import fault
from . import lockdep
from . import protocol as P
from . import racedebug
from . import refdebug
from . import serialization
from . import telemetry
from . import wiretap
from .ids import ActorID, ObjectID, TaskID
from .object_store import ObjectStore, create_store, inline_threshold

logger = logging.getLogger(__name__)


# Currently-executing task spec (reference: the worker's runtime
# context / current task in _private/worker.py + runtime_context.py).
# A ContextVar, not a threading.local: async actor methods run on the
# actor's event-loop thread, and run_coroutine_threadsafe propagates the
# submitting thread's context into the Task — so coroutines see their
# own spec even when many interleave on one loop.
import contextvars

_task_ctx_var: contextvars.ContextVar[Optional[P.TaskSpec]] = \
    contextvars.ContextVar("ray_tpu_torch_current_task", default=None)


def current_task_spec() -> Optional[P.TaskSpec]:
    return _task_ctx_var.get()


class SequenceGate:
    """Callee-side cross-plane merge point (reference: the actor
    scheduling queue's per-caller seq_no ordering + client_processed_up_to
    fast-forwarding in core_worker/transport/task_receiver).

    Both arrival paths — head-dispatched EXEC_TASK(S) and channel
    ACTOR_CALL bursts — route stamped actor calls through here before
    touching an executor, so one caller's calls execute in EXACT
    submission order no matter which transport carried each one. Within
    a plane arrivals are already per-caller FIFO (channel socket; head
    pipe + seq-ordered per-actor queue), so an arrival only waits on
    its stamped CROSS-plane predecessors (spec.seq_preds) and on any
    older same-caller arrival already held.

    A held slot is released by: its predecessor executing here, the
    head settling the predecessor (SEQ_SETTLED push, or the resync
    query against the head's per-(actor, caller) settlement store —
    covers calls settled on a previous incarnation this gate never
    saw), or — liveness backstop only, never the exact path — the
    bounded reorder cap / hold timeout force-admitting the oldest slot
    with a warning."""

    _GRACE_S = 1.0      # hold age before the first resync query
    _REQUERY_S = 2.0    # between resync queries for one slot

    def __init__(self, worker: "Worker"):
        self._worker = worker
        self._lock = lockdep.lock("worker.seq_gate")
        # caller_id -> {"lo": int|None, "hi": set, "held": {seq: slot}}
        # lo/hi: all seqs < lo plus those in hi are admitted-or-settled
        # (lo initializes to the first observed seq: anything below it
        # predates this incarnation's gate and can only be a replay).
        # held slot: [runner, preds_tuple, held_since, last_query_ts]
        self._callers: Dict[bytes, dict] = {}
        self._resync_running = False

    # -- state helpers (caller holds self._lock) -----------------------
    def _caller_locked(self, cid: bytes) -> dict:
        if racedebug.enabled:
            racedebug.access(self, "_callers", write=True)
        st = self._callers.get(cid)
        if st is None:
            st = self._callers[cid] = {"lo": None, "hi": set(),
                                       "held": {}}
        return st

    @staticmethod
    def _covered(st: dict, seq: int) -> bool:
        lo = st["lo"]
        return lo is not None and (seq < lo or seq in st["hi"])

    @staticmethod
    def _mark_locked(st: dict, seq: int) -> None:
        if st["lo"] is None:
            st["lo"] = seq
        if seq < st["lo"]:
            return
        st["hi"].add(seq)
        while st["lo"] in st["hi"]:
            st["hi"].discard(st["lo"])
            st["lo"] += 1

    def _admissible_locked(self, st: dict, seq: int, preds) -> bool:
        if st["held"] and min(st["held"]) < seq:
            return False  # an older same-caller arrival is parked
        return all(self._covered(st, p) for p in preds or ())

    def _hold_locked(self, st: dict, seq: int, preds, runner) -> List:
        from .config import ray_config
        st["held"][seq] = [runner, tuple(preds or ()),
                           time.monotonic(), 0.0]
        self._ensure_resync_locked()
        if len(st["held"]) > int(ray_config.direct_seq_reorder_cap):
            logger.warning(
                "sequence gate reorder buffer overflow (cap %s): "
                "force-admitting the oldest held call",
                ray_config.direct_seq_reorder_cap)
            return self._force_oldest_locked(st)
        return []

    def _drain_locked(self, st: dict) -> List:
        """Pop newly-admissible held slots IN SEQ ORDER; returns their
        runners (the caller invokes them, still under the gate lock,
        to keep executor-submission order exact)."""
        out: List = []
        while st["held"]:
            s = min(st["held"])
            slot = st["held"][s]
            if not all(self._covered(st, p) for p in slot[1]):
                break
            del st["held"][s]
            self._mark_locked(st, s)
            out.append(slot[0])
        return out

    def _force_oldest_locked(self, st: dict) -> List:
        s = min(st["held"])
        slot = st["held"].pop(s)
        self._mark_locked(st, s)
        return [slot[0]] + self._drain_locked(st)

    @staticmethod
    def _run(runner) -> None:
        try:
            runner()
        except Exception:
            logger.exception("sequence-gate admission runner failed")

    # -- arrival entry points ------------------------------------------
    def admit(self, spec, runner) -> None:
        """One stamped arrival: run now (in order) or hold until its
        predecessors execute/settle. Runners only enqueue to the
        actor's executors (cheap, non-blocking), so they run under the
        gate lock — admission order IS executor order."""
        with self._lock:
            st = self._caller_locked(spec.caller_id)
            seq = spec.caller_seq
            if self._covered(st, seq):
                to_run = [runner]  # replay of an executed/settled slot
            elif self._admissible_locked(st, seq, spec.seq_preds):
                self._mark_locked(st, seq)
                to_run = [runner] + self._drain_locked(st)
            else:
                to_run = self._hold_locked(st, seq, spec.seq_preds,
                                           runner)
            for r in to_run:
                self._run(r)

    def admit_burst(self, specs: List, batch_runner) -> None:
        """A channel burst from one caller: contiguous admissible runs
        still ship as one batch item; a held slot splits the run (its
        successors hold behind it via the older-held rule), and drained
        cross-plane slots are interleaved at their seq position."""
        with self._lock:
            ready: List = []

            def flush():
                nonlocal ready
                if ready:
                    batch = ready
                    ready = []
                    self._run(lambda: batch_runner(batch))

            callers = self._callers
            for spec in specs:
                seq = spec.caller_seq
                if seq < 0 or spec.caller_id is None:
                    ready.append(spec)
                    continue
                st = callers.get(spec.caller_id)
                # Steady-state fast path: next contiguous slot, nothing
                # held, no cross-plane predecessors — one dict probe +
                # one increment.
                if st is not None and st["lo"] == seq \
                        and not spec.seq_preds and not st["held"]:
                    # (the compaction invariant keeps lo out of hi, so
                    # lo == seq implies seq is unmarked)
                    st["lo"] = seq + 1
                    while st["lo"] in st["hi"]:
                        st["hi"].discard(st["lo"])
                        st["lo"] += 1
                    ready.append(spec)
                    continue
                if st is None:
                    st = self._caller_locked(spec.caller_id)
                if self._covered(st, seq):
                    ready.append(spec)
                    continue
                if self._admissible_locked(st, seq, spec.seq_preds):
                    self._mark_locked(st, seq)
                    ready.append(spec)
                    drained = self._drain_locked(st)
                    if drained:
                        flush()
                        for r in drained:
                            self._run(r)
                else:
                    drained = self._hold_locked(
                        st, seq, spec.seq_preds,
                        lambda s=spec: batch_runner([s]))
                    flush()
                    for r in drained:
                        self._run(r)
            flush()

    def on_settled(self, caller_id: bytes, seqs, all_: bool = False
                   ) -> None:
        """The head settled these slots without delivering them here
        (typed reconcile errors, dead-caller cleanup): release holds."""
        with self._lock:
            st = self._callers.get(caller_id)
            if st is None:
                return
            if all_:
                runs = [st["held"][s][0] for s in sorted(st["held"])]
                self._callers.pop(caller_id, None)
            else:
                for s in seqs or ():
                    self._mark_locked(st, s)
                runs = self._drain_locked(st)
            for r in runs:
                self._run(r)

    # -- resync: ask the head about stale predecessors ------------------
    def _ensure_resync_locked(self) -> None:
        if self._resync_running:
            return
        self._resync_running = True
        threading.Thread(target=self._resync_loop, daemon=True,
                         name="seq-gate-resync").start()

    def _resync_loop(self) -> None:
        """While holds exist: query the head's settlement store for
        uncovered predecessors past the grace period (catches slots
        settled on a previous incarnation / elided accounting), and
        force-admit slots past the hold timeout. Exits when empty."""
        from .config import ray_config
        while True:
            time.sleep(0.5)
            queries: Dict[bytes, List[int]] = {}
            with self._lock:
                now = time.monotonic()
                hold_to = float(ray_config.direct_seq_hold_timeout_s)
                any_held = False
                for cid, st in list(self._callers.items()):
                    if not st["held"]:
                        continue
                    any_held = True
                    oldest = min(st["held"])
                    if now - st["held"][oldest][2] > hold_to:
                        logger.warning(
                            "sequence gate hold timeout (%.0fs): "
                            "force-admitting seq %s", hold_to, oldest)
                        for r in self._force_oldest_locked(st):
                            self._run(r)
                        continue
                    want = set()
                    for s, slot in st["held"].items():
                        if now - slot[2] < self._GRACE_S \
                                or now - slot[3] < self._REQUERY_S:
                            continue
                        slot[3] = now
                        want.update(p for p in slot[1]
                                    if not self._covered(st, p))
                    if want:
                        queries[cid] = sorted(want)
                if not any_held:
                    self._resync_running = False
                    return
            aspec = self._worker._actor_spec
            if aspec is None:
                continue
            for cid, seqs in queries.items():
                try:
                    settled = self._worker.client.gcs_request(
                        "direct_seq_settled",
                        actor_id=aspec.actor_id.binary(),
                        caller_id=cid, seqs=seqs)
                except Exception:
                    settled = None
                if settled:
                    self.on_settled(cid, settled)


class WorkerClient:
    """Worker-side client for the driver's GCS/scheduler services.

    The in-worker counterpart of the reference's CoreWorker submission side
    (core_worker.cc SubmitTask/Put/Get) — everything proxies to the owner
    (driver) over the pipe.
    """

    # api._make_return_refs: the head increfs a nested submission's
    # return ids itself (one frame per call instead of submit + incref).
    head_increfs_returns = True

    def __init__(self, worker):
        self._worker = worker

    def _request(self, msg_type: str, payload: dict) -> Any:
        return self._worker.request(msg_type, payload)

    # -- borrow refcounting (oneway; pipe ordering guarantees the incref
    # from arg deserialization lands before this task's TASK_DONE unpin —
    # on the direct plane the deltas coalesce per burst and _emit_done
    # drains the buffer before every completion send, preserving it) --
    def incref(self, object_id: ObjectID):
        try:
            w = self._worker
            if w._direct_on:
                w.direct.ref_delta(object_id, 1)
            else:
                w.send_lazy(P.REF_COUNT,
                            {"object_id": object_id, "delta": 1})
        except Exception:  # lint: broad-except-ok pipe died: head reconciles this worker's refs on disconnect
            pass

    def decref(self, object_id: ObjectID):
        try:
            w = self._worker
            if w._direct_on:
                w.direct.ref_delta(object_id, -1)
            else:
                w.send_lazy(P.REF_COUNT,
                            {"object_id": object_id, "delta": -1})
        except Exception:  # lint: broad-except-ok pipe died: head reconciles this worker's refs on disconnect
            pass

    # -- objects ----------------------------------------------------------
    def put(self, value: Any) -> ObjectID:
        # Oneway (no round trip): pipe ordering guarantees the head
        # registers the object before it sees ANY later message that
        # could reference the id from this worker (a nested submit, a
        # TASK_DONE result, a GET_LOCATIONS) — and other workers can
        # only learn the id through the head. Registration failures
        # surface as LOC_ERROR on the id, not at the put() call
        # (reference: plasma put errors surface on get).
        oid = ObjectID.from_random()
        w = self._worker
        with serialization.collect_object_refs() as nested:
            sobj = serialization.serialize(value)
        if w._direct_on:
            # Mark BEFORE the barrier: a direct result retiring during
            # serialize() parks unmarked, and a flush that ran before
            # the marking would strand it (head-side waiter, idle
            # worker). Marked first, the barrier below ships anything
            # already parked, and later retirements flush themselves.
            if nested:
                w.direct.note_escaped([list(nested)])
            # The put value may nest direct-owned ids: their accounting
            # must reach the head before this registration pins them.
            w.direct.flush_accounting()
        if sobj.total_size <= inline_threshold():
            self._worker.send_lazy(P.OWNED_PUT,
                                   {"object_id": oid,
                                    "inline": sobj.to_bytes(),
                                    "nested": list(nested)})
        else:
            # Client-side reserve-write-seal: put_serialized reserves
            # the segment from this thread's pool stripe and lands the
            # collected out-of-band views in place — the only copy of
            # the value's payload bytes on this whole path (the
            # serialize() above only gathered views). A torch tensor
            # was brought to host inside serialize
            # (serialization._to_host): a CPU tensor as a numpy view
            # of its storage, so there is no host bounce buffer
            # either; a CUDA tensor through one device-to-host copy.
            size = self._worker.store.put_serialized(oid, sobj)
            self._worker.send_lazy(P.OWNED_PUT,
                                   {"object_id": oid, "size": size,
                                    "nested": list(nested)})
        return oid

    def get_locations(self, object_ids: List[ObjectID], timeout=None) -> List:
        w = self._worker
        if w._direct_on:
            # Local-first: direct-call results and forwarded nested
            # results resolve from the worker's cache (waiting on the
            # channel/forward signal), only the rest round-trips.
            return w.direct.get_locations(object_ids, timeout)
        return self._request(
            P.GET_LOCATIONS, {"object_ids": object_ids, "timeout": timeout})

    def get(self, object_ids: List[ObjectID], timeout=None) -> List[Any]:
        locs = self.get_locations(object_ids, timeout)
        out = []
        for oid, loc in zip(object_ids, locs):
            out.append(self._worker.read_location(oid, loc))
        return out

    def wait(self, object_ids, num_returns, timeout, fetch_local=True):
        return self._request(P.WAIT_OBJECTS, {
            "object_ids": object_ids, "num_returns": num_returns,
            "timeout": timeout})

    # -- tasks / actors ---------------------------------------------------
    def submit_task(self, spec: P.TaskSpec):
        # Oneway: the old synchronous ack made every nested .remote() a
        # full head round trip — the dominant cost of worker-as-client
        # submission bursts (the reference submits from workers without
        # blocking on the raylet either; errors surface on the returned
        # ref). Head-side failures are registered as LOC_ERROR on the
        # return ids.
        w = self._worker
        if w._direct_on:
            # Accounting barrier first (args may reference direct-owned
            # ids the head must know before it pins them), then mark the
            # return ids forward-pending: result delivery rides
            # head->submitter RESULT_FWD frames and get() resolves
            # locally, no pull round trip.
            w.direct.note_spec_escapes(spec)
            w.direct.flush_accounting()
            w.direct.note_nested_submission(spec)
        w.send_lazy(P.SUBMIT_TASK, {"spec": spec})

    def submit_actor_task(self, spec: P.TaskSpec):
        w = self._worker
        if w._direct_on:
            # The per-(caller, actor) sequence slot is stamped at
            # routing (inside the channel registration, or right here
            # for the head path) so the callee's merge gate replays
            # exact submission order on whichever plane carries it.
            if w.direct.submit_actor_call(spec):
                return  # shipped caller->callee; head sees accounting only
            # Head path owns the slot (fallback, streaming without a
            # channel, retry_exceptions): stamp + snapshot its
            # in-flight channel predecessors for the callee gate.
            w.direct.mark_head_routed(spec)
            w.direct.note_spec_escapes(spec)
            w.direct.flush_accounting()
            w.direct.note_nested_submission(spec)
        w.send_lazy(P.SUBMIT_ACTOR_TASK, {"spec": spec})

    # -- streaming generators (worker-side consumption) -------------------
    # Channel streams resolve from the DirectPlane's local stream state;
    # head-routed streams (fallback/warm-up) degrade to blocking GCS
    # round trips against the head's stream state. Requires the direct
    # plane: with it off, workers keep the historical "driver only"
    # refusal (api.py gates on supports_streaming()).
    def supports_streaming(self) -> bool:
        return self._worker._direct_on

    def gen_wait(self, task_id, index: int, timeout=None):
        w = self._worker
        if w._direct_on:
            out = w.direct.gen_wait(task_id, index, timeout)
            if out is not None:
                return out
        return self.gcs_request("gen_wait", task_id=task_id,
                                index=index, timeout=timeout)

    def gen_release(self, task_id, consumed: int) -> None:
        w = self._worker
        if w._direct_on and w.direct.gen_release(task_id, consumed):
            return
        try:
            self.gcs_request("gen_release", task_id=task_id,
                             consumed=consumed)
        except Exception:  # lint: broad-except-ok generator GC path; release is best-effort on a dying head pipe
            pass

    def gen_add_done_callback(self, task_id, cb) -> None:
        w = self._worker
        if w._direct_on and w.direct.gen_add_done_callback(task_id, cb):
            return

        def _watch():
            from ..exceptions import GetTimeoutError
            while True:
                try:
                    # Short-poll the head's stream state (index far
                    # past any real stream => returns at stream end):
                    # each poll occupies a head handler-pool thread for
                    # at most the timeout, instead of parking one for
                    # the stream's whole lifetime.
                    self.gcs_request("gen_wait", task_id=task_id,
                                     index=1 << 60, timeout=2.0)
                    break
                except GetTimeoutError:
                    continue
                except Exception:  # lint: broad-except-ok stream-end watcher; cb still fires below
                    break
            try:
                cb()
            except Exception:  # lint: broad-except-ok user callback; watcher thread must exit clean
                pass

        threading.Thread(target=_watch, daemon=True,
                         name="gen-done-watch").start()

    def create_actor(self, spec: P.ActorSpec):
        self._request(P.CREATE_ACTOR_REQ, {"spec": spec})

    def get_actor(self, name: str, namespace: Optional[str]):
        return self._request(P.GET_ACTOR, {"name": name, "namespace": namespace})

    def kill_actor(self, actor_id: ActorID, no_restart: bool):
        self._request(P.KILL_ACTOR, {"actor_id": actor_id,
                                     "no_restart": no_restart})

    def gcs_request(self, op: str, **kwargs) -> Any:
        return self._request(P.GCS_REQUEST, {"op": op, "kwargs": kwargs})

    def cluster_resources(self) -> Dict[str, float]:
        return self.gcs_request("cluster_resources")

    def available_resources(self) -> Dict[str, float]:
        return self.gcs_request("available_resources")


class Worker:
    def __init__(self, conn, config: P.WorkerConfig):
        self.conn = conn
        self.config = config
        self.store = create_store(config.store_dir)
        self.client = WorkerClient(self)
        # Full-arena escalation: ask the owner to spill (see
        # object_store create()).
        self.store.request_spill = (
            lambda need: self.client.gcs_request("spill_store",
                                                 need=need))
        # Outbound writer thread: every send enqueues and the writer
        # coalesces the queue into one vectored write per wakeup
        # (netcomm.ConnectionWriter) — replaces the old send-lock +
        # per-message write and the 1 ms lazy flusher. Strict FIFO per
        # connection, so the borrow-incref-before-TASK_DONE pipe
        # ordering contract holds unchanged.
        from .netcomm import ConnectionWriter
        self._writer = ConnectionWriter(conn, name="worker-writer")
        self._req_counter = 0
        self._req_lock = lockdep.lock("worker.req")
        self._pending: Dict[int, Future] = {}
        self._fn_cache: Dict[str, Any] = {}
        # fn_id -> cloudpickled blob, stashed by the (single-threaded)
        # recv loop BEFORE the task is handed to the executor pool:
        # pipelined tasks arrive blob-stripped and may reach _load_fn
        # before the blob-carrying task does.
        self._fn_blobs: Dict[str, bytes] = {}
        # ONE thread: plain tasks execute strictly sequentially, so
        # pipelined tasks queued on this worker (scheduler worker-lease
        # pipelining) respect the resource contract — a queued task
        # must not run while the lease's current task runs (reference:
        # the worker executes its scheduling queue in order).
        self._task_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="task")
        self._running: Dict[bytes, int] = {}  # task_id bytes -> thread ident
        self._running_lock = lockdep.lock("worker.running")
        # Cancellations for tasks queued in this worker but not yet
        # started (pipelined dispatch): checked at _execute entry.
        self._cancelled_pending: set = set()
        # tid -> executor Future for plain tasks not yet started —
        # recallable (Future.cancel) when the owner evacuates a blocked
        # worker's queue.
        self._queued_futures: Dict[bytes, Future] = {}
        # tid -> (actor_id, fn_id) for tasks received but not yet
        # started, so a queued-task cancel reports with the right
        # identity, a cancel racing a completed task is ignored (no
        # leak, no spurious TASK_DONE), and a cancelled task's stashed
        # fn blob can be dropped when no other queued task needs it.
        self._queued_meta: Dict[bytes, Any] = {}
        # TASK_DONE group-commit coalescing: completions that land while
        # another thread is mid-send ride along in one TASKS_DONE frame
        # (fewer owner wakeups/syscalls per task under pipelined
        # bursts); nothing ever WAITS to be sent.
        self._done_lock = lockdep.lock("worker.done")
        self._done_buf: list = []
        self._done_flushing = False
        # Direct worker<->worker call plane (direct.py): caller-side
        # channels + local result cache + coalesced head accounting.
        # _direct_on is the per-op falsy gate — with the flag off the
        # submit/complete paths do zero additional work.
        from . import direct as direct_mod
        self.direct = direct_mod.DirectPlane(self)
        self._direct_on = self.direct.enabled
        # Cross-plane merge gate (created lazily on the first STAMPED
        # arrival: unstamped traffic — flag-off, driver calls — pays
        # nothing).
        self._seq_gate: Optional[SequenceGate] = None
        # Telemetry plane: bounded lifecycle-event buffer, drained as a
        # TASK_EVENTS message enqueued right before each completion so
        # both ride ONE writer wakeup / vectored write (telemetry.py).
        self._task_events = telemetry.TaskEventBuffer()
        self._metrics_last_push = 0.0
        # Actor state
        self._actor_instance = None
        self._actor_spec: Optional[P.ActorSpec] = None
        self._actor_executor: Optional[ThreadPoolExecutor] = None
        self._cg_executors: Dict[str, ThreadPoolExecutor] = {}
        self._actor_loop: Optional[asyncio.AbstractEventLoop] = None
        self._actor_loop_lock = lockdep.lock("worker.actor_loop")
        self._shutdown = threading.Event()

    # -- plumbing ----------------------------------------------------------
    def send(self, msg_type: str, payload: dict):
        """Enqueue for the writer thread: bursts from any thread
        coalesce into one multi-message frame / one syscall per writer
        wakeup; a oneway flood and a synchronous request share the same
        FIFO queue, so ordering is inherent rather than maintained by
        flush barriers."""
        self._writer.send_message(msg_type, payload)

    # Oneway sends ride the same writer queue (kept as a distinct name
    # for call-site intent; the old 1 ms lazy flusher is gone — the
    # writer coalesces without adding latency).
    send_lazy = send

    def request(self, msg_type: str, payload: dict) -> Any:
        if self._direct_on:
            # Any blocking request may reference direct-owned ids
            # (get/wait/gcs ops): their accounting must precede it on
            # the pipe.
            self.direct.flush_accounting()
        fut: Future = Future()
        with self._req_lock:
            self._req_counter += 1
            req_id = self._req_counter
            self._pending[req_id] = fut
        payload = dict(payload)
        payload["req_id"] = req_id
        if wiretap.enabled:
            wiretap.request_sent(msg_type, req_id)
        self.send(msg_type, payload)
        result = fut.result()
        if isinstance(result, dict) and result.get("__error__") is not None:
            raise result["__error__"]
        return result

    def read_location(self, oid: ObjectID, loc) -> Any:
        kind = loc[0]
        if kind == P.LOC_INLINE:
            value = serialization.deserialize(loc[1])
        elif kind == P.LOC_SHM:
            if (len(loc) > 2 and loc[2]
                    and loc[2] != (self.config.node_id_hex or loc[2])
                    and not self.store.contains(oid)):
                # Object lives on another node: ask our node (daemon or
                # head) to localize it before the shm read (reference:
                # raylet-mediated plasma fetch via PullManager). Pull
                # waits join the trace tree — the slow half of a traced
                # task is usually this fetch, not the compute — and the
                # span cm itself records a failed fetch as failed.
                import contextlib
                cm = tracing.span(  # lint: ungated-instrumentation-ok gated by is_enabled (adopted-context gate; only traced tasks reach it)
                    "pull", object_id=oid.hex(), source=loc[2][:8]) \
                    if tracing.is_enabled() else contextlib.nullcontext()
                with cm:
                    # Object-transfer fast path: pull worker->worker
                    # over an already-brokered direct channel to the
                    # owning node (no daemon routing, no extra copy).
                    # Any failure inside returns False and the daemon
                    # PULL_OBJECT path below runs unchanged.
                    if (self._direct_on
                            and self.direct.pull_object(
                                oid, loc[2],
                                loc[1] if len(loc) > 1 else 0)):
                        return self._finish_read(self.store.get(oid))
                    res = self.client._request(P.PULL_OBJECT,
                                               {"object_id": oid,
                                                "node": loc[2]})
                    adopt = (res.get("adopt")
                             if isinstance(res, dict) else None)
                    if adopt is not None and hasattr(self.store,
                                                     "adopt_native"):
                        # The node holds it zero-copy in ANOTHER node's
                        # arena: map the same slot (unpinned — the
                        # node's pin + the owner's task-arg refs cover
                        # the read).
                        try:
                            self.store.adopt_native(oid, *adopt,
                                                    pin=False)
                        except Exception:
                            # Mapping unusable in THIS process (owner's
                            # arena vanished or unreadable): have the
                            # node materialize a real local copy.
                            self.client._request(P.PULL_OBJECT,
                                                 {"object_id": oid,
                                                  "node": loc[2],
                                                  "materialize": True})
            value = self.store.get(oid)
        elif kind == P.LOC_ERROR:
            raise serialization.deserialize(loc[1])
        else:
            raise RuntimeError(f"unresolvable location {kind} for {oid}")
        return self._finish_read(value)

    @staticmethod
    def _finish_read(value: Any) -> Any:
        if isinstance(value, TaskError):
            raise value
        return value

    def resolve_arg(self, arg: P.Arg) -> Any:
        if arg.kind == "value":
            return serialization.deserialize(arg.data)
        return self.read_location(arg.object_id, arg.location)

    # -- task execution ----------------------------------------------------
    def _load_fn(self, spec: P.TaskSpec):
        fn = self._fn_cache.get(spec.fn_id)
        if fn is None:
            if spec.fn_blob is None:
                spec.fn_blob = self._fn_blobs.get(spec.fn_id)
            if spec.fn_blob is None:
                raise RuntimeError(f"function {spec.fn_id} not cached on worker")
            fn = cloudpickle.loads(spec.fn_blob)
            self._fn_cache[spec.fn_id] = fn
            self._fn_blobs.pop(spec.fn_id, None)
        return fn

    def _put_return(self, oid, sobj) -> int:
        """Land one task return in the store, waiting out transient
        full-store pressure. A full store is not always terminal: a
        concurrent writer on this node (e.g. a neighboring shuffle
        reducer mid-merge) holds an unsealed segment that will seal —
        and become spillable — shortly. Blocking here is the return
        path's share of store backpressure; only a store that stays
        full past the deadline fails the task."""
        from ..exceptions import ObjectStoreFullError
        from .config import ray_config
        deadline_s = float(ray_config.put_pressure_deadline_s)
        deadline = time.monotonic() + deadline_s
        while True:
            try:
                return self.store.put_serialized(oid, sobj)
            except ObjectStoreFullError:
                if deadline_s <= 0 or time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)

    def _package_returns(self, spec: P.TaskSpec, result: Any):
        if spec.num_returns == 1:
            values = [result]
        else:
            values = list(result)
            if len(values) != spec.num_returns:
                raise ValueError(
                    f"Task {spec.name} declared num_returns="
                    f"{spec.num_returns} but returned {len(values)} values")
        locs, nested_per_return = [], []
        for oid, value in zip(spec.return_ids, values):
            with serialization.collect_object_refs() as nested:
                sobj = serialization.serialize(value)
            nested_per_return.append(list(nested))
            if sobj.total_size <= inline_threshold():
                locs.append((P.LOC_INLINE, sobj.to_bytes()))
            else:
                try:
                    size = self._put_return(oid, sobj)
                except FileExistsError:
                    # Deterministic return id already landed (idempotent
                    # re-execution of the same task): keep the original.
                    size = sobj.total_size
                locs.append((P.LOC_SHM, size))
        return locs, nested_per_return

    def _stream_generator(self, spec: P.TaskSpec, gen,
                          direct_chan=None) -> int:
        """Ship each yielded item as its own object, one GEN_ITEM message
        per item (reference: streaming generator execution,
        _raylet.pyx:1348 — dynamic return objects created as the
        generator runs, not buffered until completion). Channel streams
        (`direct_chan` set) ship items callee->caller on the brokered
        channel — the head hears about them only in the caller's
        terminal accounting entry."""
        from .ids import object_id_for_return

        if not inspect.isgenerator(gen) and not hasattr(gen, "__next__"):
            gen = iter([gen] if gen is not None else [])
        index = 0
        for item in gen:
            oid = object_id_for_return(spec.task_id, index)
            with serialization.collect_object_refs() as nested:
                sobj = serialization.serialize(item)
            if sobj.total_size <= inline_threshold():
                loc = (P.LOC_INLINE, sobj.to_bytes())
            else:
                size = self._put_return(oid, sobj)
                loc = (P.LOC_SHM, size)
            if direct_chan is not None:
                self.direct.send_gen_item(direct_chan, spec.task_id,
                                          index, loc, list(nested))
            else:
                self.send(P.GEN_ITEM, {
                    "task_id": spec.task_id, "index": index, "loc": loc,
                    "nested": list(nested)})
            index += 1
        return index

    def record_stream_failed_event(self, spec: P.TaskSpec,
                                   callee_wid=None) -> None:
        """Terminal FAILED for a channel stream that died with its
        callee — the callee may never flush one itself."""
        self._task_events.record(
            task_id=spec.task_id.hex(), name=spec.name, state="FAILED",
            ts=time.time(), src="worker",
            node_id=self.config.node_id_hex, worker_id=callee_wid)

    def _record_task_event(self, spec: P.TaskSpec, state: str, ts: float,
                           start_ts: Optional[float] = None):
        """Buffer one lifecycle transition (lock + deque append — no
        syscalls; callers gate on telemetry.enabled)."""
        ev = {"task_id": spec.task_id.hex(), "name": spec.name,
              "state": state, "ts": ts, "src": "worker",
              "node_id": self.config.node_id_hex,
              "worker_id": self.config.worker_id.hex()}
        if start_ts is not None:
            # Same-clock span bounds: the timeline pairs start_ts/ts
            # without mixing worker and head clocks.
            ev["start_ts"] = start_ts
        self._task_events.record(**ev)

    def _flush_telemetry(self):
        """Drain buffered events AND tracing spans (+ a throttled
        metrics snapshot) onto the writer queue. Called right before a
        completion send, so the frames coalesce into the SAME vectored
        write — the piggyback that makes enabled-mode flushing
        syscall-free; spans ride the TASK_EVENTS frame instead of the
        old blocking record_spans round trip. Failures never break
        completion delivery."""
        try:
            events, dropped = self._task_events.drain()
            sub = self.direct.drain_submitted() if self._direct_on \
                else []
            spans, sdropped = tracing.drain_spans() \
                if (tracing._buffer or tracing._dropped) else ([], 0)
            if events or dropped or sub or spans or sdropped:
                payload = {"events": events, "dropped": dropped}
                if sub:
                    # Raw SUBMITTED tuples for stamped direct calls;
                    # the head converts at ingest.
                    payload["sub"] = sub
                if spans or sdropped:
                    payload["spans"] = spans
                    payload["span_drops"] = sdropped
                self.send(P.TASK_EVENTS, payload)
            if not telemetry.enabled:
                return  # tracing-only flush: no metrics machinery
            from .config import ray_config
            now = time.monotonic()
            if (now - self._metrics_last_push
                    >= float(ray_config.worker_metrics_push_interval_s)):
                self._metrics_last_push = now
                from ..util import metrics as M
                telemetry.flush_serve_gauges()  # lint: ungated-instrumentation-ok the telemetry.enabled early return above gates this
                groups = M.registry_samples()
                if groups:
                    self.send(P.METRICS_PUSH, {
                        "worker_id": self.config.worker_id.hex(),
                        "node_id": self.config.node_id_hex,
                        "groups": groups, "ts": time.time()})
        except Exception:  # lint: broad-except-ok telemetry flush must never break completion delivery (docstring contract)
            pass

    def _emit_done(self, payload: dict, direct_chan=None):
        """Ship one task's completion with group-commit coalescing:
        every completion flushes immediately UNLESS another thread is
        mid-flush, in which case it parks in the buffer and the flusher
        drains it in the same TASKS_DONE frame. Batching emerges only
        under genuine completion bursts — a lone task (or a fast task
        next to slow siblings) never waits.

        Direct calls (`direct_chan` set) return the inline result
        straight to the CALLER on the brokered channel; only telemetry
        piggybacks to the head (the caller ships the batched completion
        accounting)."""
        if self._direct_on:
            # Results nesting still-IN-FLIGHT direct ids hand the head
            # a waiter this worker must satisfy: mark them so their
            # retirement flushes instead of parking (idle workers have
            # no later barrier).
            self.direct.note_escaped(payload.get("nested"))
            # Accounting barrier: parked direct-call completions and
            # borrow deltas buffered by this task must be on the head
            # pipe BEFORE its completion can unpin args or ship results
            # that nest direct-owned ids.
            self.direct.flush_accounting()
        if direct_chan is not None:
            # Direct completions don't touch the head, so the telemetry
            # piggyback has no frame to ride — flush event/span batches
            # on a size threshold instead of per completion (the
            # drop-oldest buffer bounds still hold; freshness for idle
            # workers comes from the TELEMETRY_DRAIN heartbeat nudge).
            # ADOPTED-context spans (process tracing flag off — e.g. a
            # traceparent request on an otherwise untraced cluster)
            # flush per completion instead: no head/daemon sends the
            # nudge when its own flags are off, and such spans are
            # per-traced-request rare.
            nspans = len(tracing._buffer)
            if (telemetry.enabled and (
                    len(self._task_events)
                    + len(self.direct._sub_evts) + nspans >= 256
                    or self._task_events.dropped)) or nspans >= 256 \
                    or (nspans and not tracing.enabled):
                self._flush_telemetry()
            self.direct.send_result(direct_chan, payload)
            return
        # Head path: the head resolves the spec from its own running
        # table — shipping it would just fatten the TASK_DONE frame.
        payload.pop("spec", None)
        if telemetry.enabled or tracing._buffer:
            self._flush_telemetry()
        with self._done_lock:
            self._done_buf.append(payload)
            if self._done_flushing:
                return
            self._done_flushing = True
        while True:
            with self._done_lock:
                buf, self._done_buf = self._done_buf, []
                if not buf:
                    self._done_flushing = False
                    return
            try:
                if len(buf) == 1:
                    self.send(P.TASK_DONE, buf[0])
                else:
                    self.send(P.TASKS_DONE, {"batch": buf})
            except BaseException:
                # Re-stash and clear the flag so a send failure (dying
                # pipe, unpicklable payload) can't wedge the flusher
                # forever with completions silently parking in the
                # buffer.
                with self._done_lock:
                    self._done_buf = buf + self._done_buf
                    self._done_flushing = False
                raise

    def _recall_queued(self):
        """Evacuate not-yet-started plain tasks back to the owner (the
        owner's worker blocked in a get/wait; tasks queued behind it on
        this strictly-sequential executor could be its own
        dependencies — a permanent deadlock unless they reschedule
        elsewhere). Future.cancel() is the arbiter: it fails for the
        running task and races with task start safely."""
        recalled = []
        with self._running_lock:
            for tid, fut in list(self._queued_futures.items()):
                if fut.cancel():
                    self._queued_futures.pop(tid, None)
                    self._queued_meta.pop(tid, None)
                    recalled.append(tid)
        if recalled:
            self.send(P.TASKS_RECALLED, {"task_ids": recalled})

    def _execute(self, spec: P.TaskSpec):
        tid = spec.task_id.binary()
        # Direct calls bind their result back to the caller's channel;
        # popped so the spec keeps the slim-pickle fast path if it ever
        # rides a wire again (reconcile resubmission).
        direct_chan = spec.__dict__.pop("_direct_chan", None)
        with self._running_lock:
            self._queued_futures.pop(tid, None)
            self._queued_meta.pop(tid, None)
            if tid in self._cancelled_pending:
                # Cancelled while queued; _cancel already reported it.
                self._cancelled_pending.discard(tid)
                return
            self._running[tid] = threading.get_ident()
        run_ts = None
        if telemetry.enabled:
            run_ts = time.time()
            self._record_task_event(spec, "RUNNING", run_ts)
        ctx_token = _task_ctx_var.set(spec)
        trace_token = exec_span = None
        if spec.trace_ctx:
            trace_token, exec_span = self._trace_enter(spec)
        try:
            if fault.enabled:
                # raise => the task fails (retry_exceptions path);
                # kill => this worker dies mid-exec (idempotent
                # resubmit path on the owner).
                fault.fire("worker.exec", task=spec.name)
            args = [self.resolve_arg(a) for a in spec.args]
            kwargs = {k: self.resolve_arg(a) for k, a in spec.kwargs.items()}
            if spec.actor_id is not None:
                if self._actor_instance is None:
                    raise RuntimeError("actor task on non-actor worker")
                if spec.method_name == "__adag_exec_loop__":
                    # Compiled-DAG persistent loop (reference: the
                    # worker-side executable-task loop in
                    # dag/compiled_dag_node.py); occupies this executor
                    # slot until the DAG is torn down.
                    from ..dag.compiled import _run_actor_loop
                    result = _run_actor_loop(self._actor_instance,
                                             *args, **kwargs)
                else:
                    method = getattr(self._actor_instance, spec.method_name)
                    result = method(*args, **kwargs)
                if inspect.iscoroutine(result):
                    result = self._run_coroutine(result)
            else:
                fn = self._load_fn(spec)
                result = fn(*args, **kwargs)
                if inspect.iscoroutine(result):
                    result = asyncio.run(result)
            if spec.streaming:
                n_items = self._stream_generator(spec, result,
                                                 direct_chan)
                if telemetry.enabled:
                    self._record_task_event(spec, "FINISHED", time.time(),
                                            start_ts=run_ts)
                # Close the span BEFORE the completion send so it rides
                # the same TASK_EVENTS piggyback as the FINISHED event.
                if exec_span is not None:
                    trace_token = self._trace_exit(trace_token, exec_span)
                    exec_span = None
                self._emit_done({
                    "task_id": spec.task_id, "results": [], "error": None,
                    "streamed": n_items, "actor_id": spec.actor_id},
                    direct_chan)
            else:
                locs, nested = self._package_returns(spec, result)
                if telemetry.enabled:
                    self._record_task_event(spec, "FINISHED", time.time(),
                                            start_ts=run_ts)
                if exec_span is not None:
                    trace_token = self._trace_exit(trace_token, exec_span)
                    exec_span = None
                self._emit_done({
                    "task_id": spec.task_id, "results": locs,
                    "error": None, "nested": nested,
                    "actor_id": spec.actor_id,
                    # Node daemons need the ids to account shm segments
                    # their workers created (head adopts via the spec).
                    "return_oids": list(spec.return_ids),
                    # For the direct caller-death fallback only: shm
                    # results keep their lineage (stripped before any
                    # head TASK_DONE frame — the head holds the spec).
                    "spec": spec}, direct_chan)
        except BaseException as e:  # noqa: BLE001 — all errors ship to owner
            if exec_span is not None:
                # Close the span WITH the failure so traces show failed
                # tasks as failed.
                trace_token = self._trace_exit(trace_token, exec_span, e)
                exec_span = None
            if isinstance(e, TaskCancelledError):
                err = e
            else:
                err = TaskError(e, task_repr=spec.name,
                                remote_tb=traceback.format_exc())
            try:
                blob = serialization.dumps(err)
            except Exception:
                blob = serialization.dumps(
                    TaskError(RuntimeError(repr(e)), task_repr=spec.name))
            if telemetry.enabled:
                self._record_task_event(spec, "FAILED", time.time(),
                                        start_ts=run_ts)
            self._emit_done({
                "task_id": spec.task_id, "results": None, "error": blob,
                "actor_id": spec.actor_id,
                "return_oids": list(spec.return_ids)}, direct_chan)
        finally:
            if exec_span is not None or trace_token is not None:
                self._trace_exit(trace_token, exec_span)
            _task_ctx_var.reset(ctx_token)
            with self._running_lock:
                self._running.pop(tid, None)

    def _trace_enter(self, spec: P.TaskSpec):
        """Adopt the caller's propagated span context and open the
        execution span — shared by BOTH call planes (reference: context
        extracted from the task spec, tracing_helper.py). Tracing
        failures must never fail the task; returns (token, span_cm) or
        (None, None)."""
        try:
            token = tracing.activate_context(spec.trace_ctx)  # lint: ungated-instrumentation-ok gated by the spec.trace_ctx check at every call site
            cm = tracing.span(  # lint: ungated-instrumentation-ok same spec.trace_ctx gate
                f"task:{spec.name}", task_id=spec.task_id.hex(),
                worker_id=self.config.worker_id.hex())
            cm.__enter__()
            return token, cm
        except Exception:
            return None, None

    def _trace_exit(self, token, cm, exc: Optional[BaseException] = None):
        """Close the execution span (with the failure, when there was
        one — traces show failed tasks as failed) and drop the adopted
        context. Returns None so callers can clear their token."""
        try:
            if cm is not None:
                if exc is not None:
                    cm.__exit__(type(exc), exc, exc.__traceback__)
                else:
                    cm.__exit__(None, None, None)
        except BaseException:  # lint: broad-except-ok tracing must never fail the task; the span is simply lost
            pass
        try:
            tracing.deactivate_context(token)
        except Exception:  # lint: broad-except-ok same contract: context cleanup is best-effort
            pass
        return None

    def _execute_direct_batch(self, chan, specs: List[P.TaskSpec]):
        """Lean exec loop for a burst of direct actor calls on a
        max_concurrency=1 actor: ONE executor item runs the whole run
        (executor submit/Future cost amortized over the burst), with
        the cancellation/recall bookkeeping direct calls can't use
        stripped. Per-spec failure semantics match _execute exactly:
        errors ship as typed blobs on that call's result."""
        for spec in specs:
            run_ts = None
            if telemetry.enabled:
                run_ts = time.time()
                self._record_task_event(spec, "RUNNING", run_ts)
            ctx_token = _task_ctx_var.set(spec)
            trace_token = exec_span = None
            if spec.trace_ctx:
                # Traced calls keep the lean batch path: adopting the
                # context + opening the exec span is the only extra
                # work, and only for specs that actually carry one.
                trace_token, exec_span = self._trace_enter(spec)
            try:
                if fault.enabled:
                    fault.fire("worker.exec", task=spec.name)
                args = [self.resolve_arg(a) for a in spec.args]
                kwargs = {k: self.resolve_arg(a)
                          for k, a in spec.kwargs.items()}
                method = getattr(self._actor_instance, spec.method_name)
                result = method(*args, **kwargs)
                if inspect.iscoroutine(result):
                    result = self._run_coroutine(result)
                locs, nested = self._package_returns(spec, result)
                if telemetry.enabled:
                    self._record_task_event(spec, "FINISHED", time.time(),
                                            start_ts=run_ts)
                if exec_span is not None:
                    trace_token = self._trace_exit(trace_token, exec_span)
                    exec_span = None
                payload = {"task_id": spec.task_id, "results": locs,
                           "error": None, "nested": nested,
                           "actor_id": spec.actor_id,
                           "return_oids": list(spec.return_ids),
                           "spec": spec}
            except BaseException as e:  # noqa: BLE001 — ships to caller
                err = TaskError(e, task_repr=spec.name,
                                remote_tb=traceback.format_exc())
                try:
                    blob = serialization.dumps(err)
                except Exception:
                    blob = serialization.dumps(TaskError(
                        RuntimeError(repr(e)), task_repr=spec.name))
                if telemetry.enabled:
                    self._record_task_event(spec, "FAILED", time.time(),
                                            start_ts=run_ts)
                if exec_span is not None:
                    trace_token = self._trace_exit(trace_token,
                                                   exec_span, e)
                    exec_span = None
                payload = {"task_id": spec.task_id, "results": None,
                           "error": blob, "actor_id": spec.actor_id,
                           "return_oids": list(spec.return_ids)}
            finally:
                if exec_span is not None or trace_token is not None:
                    self._trace_exit(trace_token, exec_span)
                _task_ctx_var.reset(ctx_token)
            self._emit_done(payload, chan)

    def _run_coroutine(self, coro):
        loop = self._ensure_actor_loop()
        return asyncio.run_coroutine_threadsafe(coro, loop).result()

    def _ensure_actor_loop(self) -> asyncio.AbstractEventLoop:
        # Lock-guarded: concurrent first async calls from the actor's
        # executor threads must not each create a loop — all coroutines of
        # one actor share ONE loop (the reference's per-actor asyncio loop,
        # _raylet.pyx async actor path), or futures created on one loop get
        # resolved on another and their waiters never wake.
        with self._actor_loop_lock:
            if self._actor_loop is None:
                loop = asyncio.new_event_loop()
                t = threading.Thread(target=loop.run_forever, daemon=True,
                                     name="actor-asyncio")
                t.start()
                self._actor_loop = loop
            return self._actor_loop

    # -- actor lifecycle ---------------------------------------------------
    def _create_actor(self, spec: P.ActorSpec):
        try:
            cls = self._fn_cache.get(spec.cls_id)
            if cls is None:
                cls = cloudpickle.loads(spec.cls_blob)
                self._fn_cache[spec.cls_id] = cls
            args = [self.resolve_arg(a) for a in spec.args]
            kwargs = {k: self.resolve_arg(a) for k, a in spec.kwargs.items()}
            self._actor_instance = cls(*args, **kwargs)
            self._actor_spec = spec
            n = max(1, spec.max_concurrency)
            self._actor_executor = ThreadPoolExecutor(
                max_workers=n, thread_name_prefix="actor")
            # Concurrency groups (reference: ConcurrencyGroupManager,
            # transport/concurrency_group_manager.cc): each named group
            # gets its own executor with its own cap; methods tagged
            # @method(concurrency_group=...) route there, everything
            # else shares the default executor above.
            self._cg_executors = {
                name: ThreadPoolExecutor(
                    max_workers=max(1, int(cap)),
                    thread_name_prefix=f"actor-cg-{name}")
                for name, cap in spec.concurrency_groups.items()}
            if self._direct_on:
                # Accounting barrier BEFORE the readiness signal: borrow
                # increfs from ctor-arg deserialization must be on the
                # head pipe before ACTOR_READY lets the head unpin the
                # creation args (the same contract _emit_done enforces
                # for task completions).
                self.direct.flush_accounting()
            self.send(P.ACTOR_READY, {"actor_id": spec.actor_id, "error": None})
        except BaseException as e:  # noqa: BLE001
            err = TaskError(e, task_repr=f"{spec.cls_id}.__init__",
                            remote_tb=traceback.format_exc())
            if self._direct_on:
                self.direct.flush_accounting()
            self.send(P.ACTOR_READY, {"actor_id": spec.actor_id,
                                      "error": serialization.dumps(err)})

    def _executor_for(self, spec: P.TaskSpec) -> ThreadPoolExecutor:
        """Route an actor task to its method's concurrency-group
        executor (default executor when untagged/unknown)."""
        meta = (self._actor_spec.method_meta or {}).get(
            spec.method_name or "", {})
        group = meta.get("concurrency_group")
        return self._cg_executors.get(group, self._actor_executor)

    # -- cancellation ------------------------------------------------------
    def _cancel(self, task_id: TaskID):
        """Raise TaskCancelledError inside the executing thread (the
        reference interrupts running tasks similarly via
        execute_task_with_cancellation_handler, _raylet.pyx:2077)."""
        tid = task_id.binary()
        with self._running_lock:
            ident = self._running.get(tid)
            queued = ident is None and tid in self._queued_meta
            if queued:
                # Dispatched but not started (queued behind the lease's
                # current task): report the cancellation NOW — the
                # caller must not wait for the queue to drain to see
                # it. (The stashed fn blob stays: the owner's fn-cache
                # bookkeeping already marks this worker as holding the
                # fn, so later blob-stripped dispatches still need it.)
                actor_id, _fn_id = self._queued_meta.pop(tid)
                fut = self._queued_futures.pop(tid, None)
                if fut is None or not fut.cancel():
                    # About to start (or untracked): _execute consumes
                    # this marker and skips silently.
                    self._cancelled_pending.add(tid)
        if ident is not None:
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_long(ident),
                ctypes.py_object(TaskCancelledError))
        elif queued:
            self._emit_done({
                "task_id": task_id, "results": None,
                "error": serialization.dumps(
                    TaskCancelledError(task_id.hex())),
                "actor_id": actor_id})
        # else: already finished — the real completion won the race.

    def _seq_gate_for(self) -> SequenceGate:
        gate = self._seq_gate
        if gate is None:
            gate = self._seq_gate = SequenceGate(self)
        return gate

    def seq_gate_admit_burst(self, specs: List[P.TaskSpec],
                             batch_runner) -> None:
        """Channel-burst entry into the merge gate (direct.py's lean
        path); unstamped bursts bypass it wholesale."""
        if all(s.caller_seq < 0 for s in specs):
            batch_runner(specs)
            return
        self._seq_gate_for().admit_burst(specs, batch_runner)

    def seq_gate_settled(self, caller_id, seqs, all_: bool = False
                         ) -> None:
        gate = self._seq_gate
        if gate is not None and caller_id is not None:
            gate.on_settled(caller_id, seqs, all_=all_)

    def _handle_exec(self, spec: P.TaskSpec):
        if (spec.fn_blob is not None
                and spec.fn_id not in self._fn_cache):
            self._fn_blobs[spec.fn_id] = spec.fn_blob
        if spec.actor_id is not None and spec.caller_seq >= 0 \
                and spec.caller_id is not None:
            # Stamped actor call: the merge gate decides when it may
            # reach an executor (exact per-caller submission order
            # across BOTH planes). Runners only enqueue, so admission
            # order is executor order. Register the queued-meta FIRST
            # so a CANCEL_TASK landing while the call is held reports
            # through the normal queued-cancel path instead of being
            # silently dropped (the admission runner's _execute then
            # consumes the _cancelled_pending marker and skips).
            with self._running_lock:
                self._queued_meta[spec.task_id.binary()] = \
                    (spec.actor_id, spec.fn_id)
            self._seq_gate_for().admit(
                spec, lambda: self._dispatch_exec(spec))
            return
        self._dispatch_exec(spec)

    def _dispatch_exec(self, spec: P.TaskSpec):
        with self._running_lock:
            self._queued_meta[spec.task_id.binary()] = \
                (spec.actor_id, spec.fn_id)
        if spec.actor_id is not None and self._actor_executor is not None:
            self._executor_for(spec).submit(self._execute, spec)
        else:
            fut = self._task_pool.submit(self._execute, spec)
            with self._running_lock:
                # Only while still queued: if _execute already
                # ran (popped the meta) this entry would be a
                # permanent orphan — done futures never cancel.
                if spec.task_id.binary() in self._queued_meta:
                    self._queued_futures[
                        spec.task_id.binary()] = fut

    # -- main loop ---------------------------------------------------------
    def run(self):
        while not self._shutdown.is_set():
            try:
                data = self.conn.recv_bytes()
            except (EOFError, OSError):
                break
            # One frame may carry many coalesced messages (writer-side
            # micro-batching); handle in order.
            for msg_type, payload in P.load_messages(data):
                if self._handle_message(msg_type, payload):
                    self._shutdown.set()
                    break
        self._shutdown.set()
        if self._actor_instance is not None:
            # Best-effort __ray_terminate__-style atexit hook parity.
            term = getattr(self._actor_instance, "__on_exit__", None)
            if callable(term):
                try:
                    term()
                except Exception:  # lint: broad-except-ok user exit hook: its failure must not block worker teardown
                    pass
        # Clean exit is a worker's LAST accounting barrier: deltas
        # parked past this point would strand head-side waiters forever
        # (the refdebug parked-at-exit invariant).
        if self._direct_on:
            try:
                self.direct.flush_accounting()
            except Exception:  # lint: broad-except-ok head pipe dead: the process is exiting, accounting dies with it
                pass
            if refdebug.enabled:
                refdebug.exit_event(len(self.direct._ref_buf)
                                    + len(self.direct._done_buf))
        elif refdebug.enabled:
            refdebug.exit_event(0)
        # Ship anything still queued (TASK_DONEs racing shutdown)
        # before the hard exit tears the pipe down.
        try:
            self._writer.flush(2.0)
        except Exception:  # lint: broad-except-ok head pipe dead: the process is exiting, nothing left to ship
            pass
        os._exit(0)

    def _handle_message(self, msg_type: str, payload: dict) -> bool:
        """Route one decoded message; returns True on SHUTDOWN."""
        import pickle
        if wiretap.enabled:
            wiretap.frame("worker", "worker", "head", "recv", msg_type,
                          payload)
        if msg_type == P.EXEC_TASK:
            self._handle_exec(payload["spec"])
        elif msg_type == P.EXEC_TASKS:
            # Coalesced dispatch burst: one frame, N specs pickled
            # individually (the owner buffers per-worker while
            # draining a recv batch — one send syscall and one recv
            # wake amortized over the burst).
            for sb in payload["specs_pickled"]:
                self._handle_exec(pickle.loads(sb))
        elif msg_type == P.RECALL_QUEUED:
            self._recall_queued()
        elif msg_type == P.REPLY:
            fut = self._pending.pop(payload["req_id"], None)  # lint: guarded-by-ok GIL-atomic pop happens-after the locked insert: a reply only arrives once request() sent the frame
            if fut is not None:
                fut.set_result(payload.get("result"))
        elif msg_type == P.CREATE_ACTOR:
            threading.Thread(
                target=self._create_actor, args=(payload["spec"],),
                daemon=True).start()
        elif msg_type == P.CANCEL_TASK:
            self._cancel(payload["task_id"])
        elif msg_type == P.RELEASE_OBJECTS:
            for oid in payload["object_ids"]:
                self.store.release(oid)
        elif msg_type == P.CHANNEL_OPEN:
            # Head-brokered direct channel: make sure the listener is
            # up and report its endpoints (direct.py).
            self.direct.on_channel_open(payload)
        elif msg_type == P.RESULT_FWD:
            self.direct.on_result_fwd(payload)
        elif msg_type == P.SEQ_SETTLED:
            # Head settled sequence slots without delivery: prune the
            # caller-side unsettled map and release merge-gate holds.
            self.direct.on_seq_settled(payload)
        elif msg_type == P.TELEMETRY_DRAIN:
            # Idle-drain nudge riding the heartbeat cadence: direct-call
            # completions have no head frame to piggyback on, so an idle
            # callee's trailing FINISHED events/spans flush here instead
            # of waiting for the 256-event threshold.
            if (len(self._task_events) or self._task_events.dropped
                    or tracing._buffer or tracing._dropped
                    or (self._direct_on and self.direct._sub_evts)):
                self._flush_telemetry()
        elif msg_type == P.SHUTDOWN:
            return True
        else:
            # Never silently drop a frame: an unknown type here means
            # protocol skew between owner and worker (version mismatch,
            # mis-framed batch) — exactly the failure the coalesced-
            # frame-drop bug hid. Oneway, so a log IS the surfacing.
            logger.warning("worker dropping unknown message type %r "
                           "(protocol skew?)", msg_type)
        return False


def worker_main(conn, config: P.WorkerConfig):
    for k, v in config.env.items():
        os.environ[k] = v
    # Snappier GIL handoff (default 5 ms): the recv loop, task thread,
    # and lazy flusher trade the lock constantly on task bursts, and a
    # thread returning from a GIL-released call (socket IO, jax
    # dispatch) otherwise waits out the holder's full quantum. Measured
    # ~10% on the multi-client task rows; sub-ms quanta cost compute
    # threads little because jax releases the GIL for device work.
    sys.setswitchinterval(float(os.environ.get(
        "RTT_GIL_SWITCH_INTERVAL", "0.001")))
    sys.path.insert(0, os.getcwd())
    # Apply working_dir / py_modules runtime env (reference: the runtime
    # env agent preparing the env before the worker serves tasks).
    from . import runtime_env as re_mod
    re_mod.apply_in_worker()
    from . import state
    worker = Worker(conn, config)
    state.set_worker_context(worker)
    worker.run()


def _main():
    """Worker process entrypoint (reference:
    python/ray/_private/workers/default_worker.py). Launched as
    ``python -m ray_tpu_torch._private.worker_proc`` so the driver's ``__main__``
    is never re-executed in workers."""
    from multiprocessing.connection import Client

    address = os.environ["RTT_WORKER_SOCKET"]
    authkey = bytes.fromhex(os.environ["RTT_WORKER_AUTHKEY"])
    conn = Client(address, family="AF_UNIX", authkey=authkey)
    config: P.WorkerConfig = cloudpickle.loads(conn.recv_bytes())
    # Under ``-m`` this file executes as ``__main__``; delegate to the
    # canonical import so module-level state (_task_ctx, caches) is the
    # single copy user code reaches via `import ray_tpu_torch._private.worker_proc`.
    from ray_tpu_torch._private import worker_proc as _canonical
    _canonical.worker_main(conn, config)


if __name__ == "__main__":
    _main()
