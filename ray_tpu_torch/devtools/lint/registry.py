"""Project registries: the raylint passes' knowledge of the runtime.

This is the ONE file to touch when the control plane grows — a new recv
loop, a newly-designated hot lock, a new plane. Everything is declared
by (file, class/function, name) so the passes stay generic and the
fixture trees in tests/test_torch_lint.py can mirror the layout.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# protocol-coverage: the recv loops and the planes they serve.
#
# Planes are derived from _private/protocol.py itself (section headers +
# per-constant direction comments; see protocol_coverage._parse_planes):
#
#   to_worker       driver/daemon -> worker control messages
#   from_worker     worker -> owner messages (both recv muxes)
#   head_to_daemon  head -> node daemon control
#   daemon_to_head  node daemon -> head
#
# Each loop entry:
#   file         path relative to the lint root
#   functions    the dispatch spans these qualnames together (a loop may
#                fan out across helper methods — coverage is their union)
#   plane        which plane's constants must ALL be dispatched
#   dispatch_vars  names the message-type variable goes by in those
#                functions (comparisons against other vars are ignored)
#   fallthrough  qualname whose terminal else/trailing code must HANDLE
#                unknown types (log / counter / reply / relay) instead of
#                silently dropping the frame; None for relay loops whose
#                fallthrough IS the relay (checked via relay=True)
#   relay        the loop forwards anything it doesn't special-case, so
#                full-plane coverage is satisfied by construction
#   exempt       {CONSTANT: reason} — intentionally not dispatched here;
#                the reason is mandatory and surfaces in reports
# ---------------------------------------------------------------------------
RECV_LOOPS = {
    "worker.run": {
        "file": "_private/worker_proc.py",
        "functions": ("Worker._handle_message",),
        "plane": "to_worker",
        "dispatch_vars": ("msg_type",),
        "fallthrough": "Worker._handle_message",
        "relay": False,
        "exempt": {},
    },
    "head.worker_mux": {
        # The head's worker-plane recv mux: burst entry + single-message
        # router + the blocking/quick handler split.
        "file": "_private/runtime.py",
        "functions": ("Node._on_worker_messages", "Node._on_worker_message",
                      "Node._handle_blocking_request",
                      "Node._handle_quick_request"),
        "plane": "from_worker",
        "dispatch_vars": ("msg_type",),
        "fallthrough": "Node._handle_quick_request",
        "relay": False,
        "exempt": {},
    },
    "daemon.worker_mux": {
        # The daemon's worker-plane recv mux special-cases node-local
        # operations (pulls, spill, view) and location tagging, then
        # relays EVERYTHING else to the head as FROM_WORKER — coverage
        # of the plane is by construction (relay=True); the pass still
        # validates that the constants it does mention are plane
        # members.
        "file": "_private/daemon.py",
        "functions": ("NodeDaemon._on_worker_message",),
        "plane": "from_worker",
        "dispatch_vars": ("msg_type",),
        "fallthrough": None,
        "relay": True,
        "exempt": {},
    },
    "daemon.run": {
        "file": "_private/daemon.py",
        "functions": ("NodeDaemon._route", "NodeDaemon._route_worker_plane"),
        "plane": "head_to_daemon",
        "dispatch_vars": ("msg_type",),
        "fallthrough": "NodeDaemon._route",
        "relay": False,
        "exempt": {
            "NODE_ACK": "consumed synchronously by the registration "
                        "handshake (_connect_head) before run() starts; "
                        "an ACK arriving later is an unknown-type log",
        },
    },
    "head.daemon_serve": {
        "file": "_private/node_service.py",
        "functions": ("HeadServer._handshake_and_register",
                      "HeadServer._on_daemon_msgs",
                      "HeadServer._route"),
        "plane": "daemon_to_head",
        "dispatch_vars": ("msg_type",),
        "fallthrough": "HeadServer._route",
        "relay": False,
        "exempt": {},
    },
    "worker.direct": {
        # The direct worker<->worker channel recv loop (direct.py):
        # both roles share one dispatcher — callees see ACTOR_CALL,
        # callers see ACTOR_RESULT on the same channel.
        "file": "_private/direct.py",
        "functions": ("DirectPlane._on_channel_messages",
                      "DirectPlane._handle_direct_message"),
        "plane": "direct",
        "dispatch_vars": ("msg_type",),
        "fallthrough": "DirectPlane._handle_direct_message",
        "relay": False,
        "exempt": {
            "SERVE_RESP": "responses return on the serve client's OWN "
                          "dedicated connection and are consumed by its "
                          "recv loop (serve.client below); the plane's "
                          "shared dispatcher never sees one",
        },
    },
    "serve.client": {
        # The serve data plane's caller side: the proxy process holds a
        # dedicated brokered connection per replica worker and this
        # loop completes rid-keyed response futures on it. The channel
        # is serve-only by construction — the actor-call constants ride
        # DirectPlane connections, never this one.
        "file": "serve/_private/direct_client.py",
        "functions": ("_ServeChannel._recv_loop",),
        "plane": "direct",
        "dispatch_vars": ("msg_type",),
        "fallthrough": "_ServeChannel._recv_loop",
        "relay": False,
        "exempt": {
            "ACTOR_CALL": "caller-only serve connection: actor calls "
                          "ride DirectPlane channels, not this one",
            "ACTOR_RESULT": "caller-only serve connection: inline "
                            "results ride DirectPlane channels",
            "GEN_CANCEL": "the serve data plane is unary-only; streams "
                          "stay on the actor-call plane",
            "SERVE_REQ": "this end SENDS requests; only the replica "
                         "worker's DirectPlane dispatcher receives them",
            "PULL_DIRECT": "object pulls ride DirectPlane channels; the "
                           "serve connection is unary request/response "
                           "by construction",
            "OBJ_CHUNK": "object-transfer chunks ride DirectPlane "
                         "channels, never the serve connection",
            "OBJ_EOF": "object-transfer terminals ride DirectPlane "
                       "channels, never the serve connection",
        },
    },
}

# A function dispatching >= this many protocol message constants over
# one variable is a recv loop and must be registered above (or carry a
# reasoned NON_LOOP_DISPATCHERS entry) — unregistered loops FAIL rather
# than silently dodge plane coverage.
RECV_LOOP_DETECT_MIN = 2

# (file, qualname) -> reason: functions that legitimately compare
# several protocol constants without BEING a recv dispatch loop.
NON_LOOP_DISPATCHERS = {}

# Calls that count as "handling" a fallthrough (vs silently dropping):
# logging, a metrics/counter bump, an error reply, a relay send, raise.
FALLTHROUGH_HANDLER_ATTRS = frozenset({
    "debug", "info", "warning", "error", "exception", "log",
    "inc", "_reply", "send", "_send",
})

# ---------------------------------------------------------------------------
# lock-discipline: designated hot-path locks, scoped (file, class) ->
# {attr name, ...}. A `with self.<attr>:` in that class is a hot
# section: no blocking call may sit lexically inside it (escape hatch:
# `# lint: blocking-under-lock-ok <reason>`).
#
# These are the locks on the recv/dispatch/writer hot paths — the ones
# where a blocked holder stalls frame parsing, dispatch, or teardown for
# every other thread. Registry-driven so newly-hot locks are ONE line.
# ---------------------------------------------------------------------------
HOT_LOCKS = {
    ("_private/netcomm.py", "ConnectionWriter"): {"_cond"},
    ("_private/netcomm.py", "LoopWriter"): {"_cond"},
    ("_private/netcomm.py", "ControlLoop"): {"_lock"},
    ("_private/netcomm.py", "SerialExecutor"): {"_cond"},
    ("_private/netcomm.py", "HostCopyGate"): {"_lock"},
    ("_private/scheduler.py", "Scheduler"): {"_lock", "_cond"},
    ("_private/scheduler.py", "WorkerHandle"): {"send_lock",
                                                "dispatch_lock"},
    ("_private/scheduler.py", "WorkerPool"): {"_lock"},
    ("_private/daemon.py", "NodeDaemon"): {"_lock", "_conn_lock",
                                           "_req_lock"},
    ("_private/node_service.py", "DaemonHandle"): {"_lock", "_req_lock"},
    ("_private/node_service.py", "HeadServer"): {"_lock"},
    ("_private/node_service.py", "RemoteWorkerProxy"): {"dispatch_lock"},
    ("_private/worker_proc.py", "Worker"): {"_req_lock", "_running_lock",
                                            "_done_lock"},
    ("_private/runtime.py", "Node"): {"_release_lock", "_gen_lock",
                                      "_actor_dep_lock"},
}

# Blocking-call shapes (see lock_discipline for the matching rules).
BLOCKING_ATTRS = frozenset({
    # socket / pipe IO
    "send", "sendall", "sendmsg", "send_bytes", "sendfile",
    "recv", "recv_bytes", "recv_into", "recvmsg", "recv_bytes_into",
    "connect", "accept", "flush",
    # blocking waits (Condition.wait on the SAME lock is the one
    # legitimate blocking op under a lock and is excluded in the pass)
    "result",
    # serialization of payloads
    "dumps", "dump_message", "dump_messages", "dump_message_parts",
})
BLOCKING_OS_ATTRS = frozenset({
    "read", "write", "writev", "sendfile", "pread", "pwrite",
})
BLOCKING_MODULES = frozenset({"subprocess", "shutil"})

# ---------------------------------------------------------------------------
# gate-discipline
# ---------------------------------------------------------------------------
# Module aliases whose `.enabled` truthiness is THE gate; instrumentation
# helper calls must sit under an `if <alias>.enabled` (any depth).
# "tracing" joined in PR 7: span-recording hot-path sites must sit under
# the tracing gate (or annotate the indirect gate — e.g. the
# spec.trace_ctx check on the execution paths, the is_enabled()
# adopted-context check on pull spans).
# "refdebug" joined in PR 9: the shadow-ledger journal hooks sit on the
# refcount hot paths (every incref/decref/park/flush) and must be
# zero-work when RTT_REFDEBUG is off.
# "wiretap" joined in PR 14: the protocol-conformance tap's frame hooks
# sit on every recv mux and send chokepoint and must be zero-work when
# RTT_WIRETAP is off.
GATED_MODULES = ("telemetry", "fault", "tracing", "refdebug",
                 "wiretap", "racedebug")
# Files that implement the planes themselves (helpers live here; their
# internal calls are exempt from the gating requirement).
GATE_IMPL_FILES = ("_private/telemetry.py", "_private/fault.py",
                   "util/tracing.py", "_private/refdebug.py",
                   "_private/wiretap.py", "_private/racedebug.py")
# Where each gated module's ``_ops``-bumping helpers are parsed from
# (the functions that MUST be gated at call sites).
GATED_HELPER_FILES = {
    "telemetry": "_private/telemetry.py",
    "tracing": "util/tracing.py",
    "refdebug": "_private/refdebug.py",
    "wiretap": "_private/wiretap.py",
    "racedebug": "_private/racedebug.py",
}

# ---------------------------------------------------------------------------
# broad-except: scope — only the runtime core is held to the standard.
# ---------------------------------------------------------------------------
BROAD_EXCEPT_PREFIX = "_private/"

# ---------------------------------------------------------------------------
# guarded-by: the field-level data-race tier (static half; dynamic:
# _private/racedebug.py).
#
# GUARDED_FIELDS maps shared mutable attributes of the hot concurrent
# classes to the lock that guards them:
#
#   (file, Class) -> {field: (lock_attr, lockdep_class)}
#
# `lock_attr` is the attribute the guarding lock lives at on the same
# object (`with self.<lock_attr>:` is the guard); `lockdep_class` is
# the name the lock was created under via the lockdep factory
# (`self.<lock_attr> = lockdep.lock("<class>")`) — the pass verifies
# the two still agree, so the static registry and the runtime lockset
# detector describe the SAME lock and neither can rot silently.
#
# Every read/write of a registered field must be lexically under a
# `with <recv>.<lock_attr>:` of the owning lock, inside a function
# registered as lock-held (HOLDS_LOCK below), or carry a reasoned
# `# lint: guarded-by-ok <reason>` annotation. `__init__` is exempt
# (init-then-publish: the object is not visible to other threads yet —
# the dynamic half's first-thread state encodes the same exemption).
#
# Coverage ratchet: a field assigned in `__init__` of a registered
# class but absent from its registry entry is flagged
# (`unregistered-field`) and baselined like broad-except — new fields
# on these classes must either be registered (and their accesses
# proven) or annotated with a reason; the debt only burns down.
# ---------------------------------------------------------------------------
GUARDED_FIELDS = {
    # -- gcs.py: the metadata directories ------------------------------
    ("_private/gcs.py", "ObjectDirectory"): {
        "_entries": ("_lock", "gcs.object_dir"),
    },
    ("_private/gcs.py", "ActorDirectory"): {
        "_actors": ("_lock", "gcs.actor_dir"),
        "_named": ("_lock", "gcs.actor_dir"),
    },
    ("_private/gcs.py", "Pubsub"): {
        "_subs": ("_lock", "gcs.pubsub"),
    },
    # -- scheduler.py: queues, pools, muxes ----------------------------
    ("_private/scheduler.py", "ResourceManager"): {
        "totals": ("_lock", "scheduler.resource_manager"),
        "available": ("_lock", "scheduler.resource_manager"),
        "_retired": ("_lock", "scheduler.resource_manager"),
    },
    ("_private/scheduler.py", "NodeRegistry"): {
        "_nodes": ("_lock", "scheduler.node_registry"),
        "_spread_rr": ("_lock", "scheduler.node_registry"),
        "_multi_node": ("_lock", "scheduler.node_registry"),
    },
    ("_private/scheduler.py", "WorkerHandle"): {
        "coalesce_buf": ("send_lock", "scheduler.worker_send"),
        "native_mux": ("send_lock", "scheduler.worker_send"),
        "native_token": ("send_lock", "scheduler.worker_send"),
    },
    ("_private/scheduler.py", "_RecvMux"): {
        "_pending_add": ("_lock", "scheduler.recv_mux"),
    },
    ("_private/scheduler.py", "_NativeMux"): {
        "_states": ("_lock", "scheduler.native_mux"),
        "_next_token": ("_lock", "scheduler.native_mux"),
    },
    ("_private/scheduler.py", "WorkerPool"): {
        "_idle": ("_lock", "scheduler.worker_pool"),
        "workers": ("_lock", "scheduler.worker_pool"),
    },
    # NOT registered on Scheduler: _task_node and _cancelled are
    # deliberately GIL-atomic tables (the pop is the idempotence
    # arbiter between concurrent failure paths — see
    # release_task_resources), and _infeasible_since is touched only
    # by the dispatch-loop thread; their __init__ assignments carry
    # the reasoned ratchet annotations.
    ("_private/scheduler.py", "Scheduler"): {
        "_ready": ("_lock", "scheduler.queue"),
        "_waiting": ("_lock", "scheduler.queue"),
        "_leased": ("_lock", "scheduler.queue"),
        "_free_gpus": ("_lock", "scheduler.queue"),
        "_started_workers": ("_lock", "scheduler.queue"),
    },
    # -- runtime.py: the head node's shared tables ---------------------
    ("_private/runtime.py", "_ActorState"): {
        "worker": ("lock", "runtime.actor_queue"),
        "ready": ("lock", "runtime.actor_queue"),
        "dead": ("lock", "runtime.actor_queue"),
        "queue": ("lock", "runtime.actor_queue"),
        "in_flight": ("lock", "runtime.actor_queue"),
        "seq_settled": ("lock", "runtime.actor_queue"),
    },
    ("_private/runtime.py", "Node"): {
        "_pg_ready_refs": ("_pg_ready_lock", "runtime.pg_ready"),
        "_draining_nodes": ("_drain_lock", "runtime.drain"),
        "_drains": ("_drain_lock", "runtime.drain"),
        "_actor_dep_waiters": ("_actor_dep_lock", "runtime.actor_deps"),
        "_release_buf": ("_release_lock", "runtime.release_buf"),
        "_gen_streams": ("_gen_lock", "runtime.gen_streams"),
        "_chan_waiters": ("_chan_lock", "runtime.chan_broker"),
        "_chan_token": ("_chan_lock", "runtime.chan_broker"),
        "_fwd_bufs": ("_fwd_lock", "runtime.result_fwd"),
        "_fwd_flushing": ("_fwd_lock", "runtime.result_fwd"),
    },
    # -- worker_proc.py: the worker's shared tables --------------------
    ("_private/worker_proc.py", "SequenceGate"): {
        "_callers": ("_lock", "worker.seq_gate"),
        "_resync_running": ("_lock", "worker.seq_gate"),
    },
    ("_private/worker_proc.py", "Worker"): {
        "_req_counter": ("_req_lock", "worker.req"),
        "_pending": ("_req_lock", "worker.req"),
        "_running": ("_running_lock", "worker.running"),
        "_done_buf": ("_done_lock", "worker.done"),
        "_done_flushing": ("_done_lock", "worker.done"),
        "_actor_loop": ("_actor_loop_lock", "worker.actor_loop"),
    },
    # -- daemon.py: the per-host daemon --------------------------------
    ("_private/daemon.py", "NodeDaemon"): {
        "_free_gpus": ("_lock", "daemon.state"),
        "_pool_workers": ("_lock", "daemon.state"),
        "_writer": ("_conn_lock", "daemon.conn"),
        "_recv_backlog": ("_conn_lock", "daemon.conn"),
        "_req_counter": ("_req_lock", "daemon.req"),
        "_pending": ("_req_lock", "daemon.req"),
    },
    # -- direct.py: the direct-call plane ------------------------------
    ("_private/direct.py", "DirectPlane"): {
        "_chans": ("_cond", "direct.state"),
        "_results": ("_cond", "direct.state"),
        "_pending": ("_cond", "direct.state"),
        "_waiters": ("_cond", "direct.state"),
        "_refs": ("_cond", "direct.state"),
        "_ref_buf": ("_cond", "direct.state"),
        "_done_buf": ("_cond", "direct.state"),
        "_seq": ("_cond", "direct.state"),
        "_streams": ("_cond", "direct.state"),
        "_sub_evts": ("_cond", "direct.state"),
        "_escaped": ("_cond", "direct.state"),
        "_pulls": ("_pull_lock", "direct.pulls"),
        "_pull_seq": ("_pull_lock", "direct.pulls"),
        "_inflight_pulls": ("_pull_lock", "direct.pulls"),
        "_serving_pulls": ("_pull_lock", "direct.pulls"),
        "_link_sems": ("_pull_lock", "direct.pulls"),
    },
    # -- netcomm.py: gates, executors, writers -------------------------
    ("_private/netcomm.py", "HostCopyGate"): {
        "_queue": ("_lock", "netcomm.host_copy_gate"),
        "_holders": ("_lock", "netcomm.host_copy_gate"),
    },
    ("_private/netcomm.py", "SerialExecutor"): {
        "_q": ("_cond", "netcomm.serial_exec"),
        "_stopped": ("_cond", "netcomm.serial_exec"),
        "_busy": ("_cond", "netcomm.serial_exec"),
        # Lazy drain thread: spawned/retired under the condvar so the
        # queue-non-empty => thread-alive invariant holds.
        "_thread": ("_cond", "netcomm.serial_exec"),
    },
    ("_private/netcomm.py", "ConnectionWriter"): {
        "_q": ("_cond", "netcomm.writer"),
        "_q_bytes": ("_cond", "netcomm.writer"),
        "_busy": ("_cond", "netcomm.writer"),
        "_stopped": ("_cond", "netcomm.writer"),
        "_error": ("_cond", "netcomm.writer"),
    },
    ("_private/netcomm.py", "ControlLoop"): {
        # Cross-thread seam of the head event loop: every other field
        # is loop-thread-owned (the _RecvMux model).
        "_pending_ops": ("_lock", "netcomm.control_loop"),
        "_stopped": ("_lock", "netcomm.control_loop"),
    },
    ("_private/netcomm.py", "ControlLoopGroup"): {
        "_next": ("_lock", "netcomm.control_loop_group"),
    },
    ("_private/netcomm.py", "PullManager"): {
        "_inflight": ("_lock", "netcomm.pull_manager"),
        "_conns": ("_lock", "netcomm.pull_manager"),
    },
    # -- object_store.py: segment tables + pools -----------------------
    ("_private/object_store.py", "_PoolStripe"): {
        "cache": ("lock", "object_store.pool_stripe"),
        "bytes": ("lock", "object_store.pool_stripe"),
    },
    ("_private/object_store.py", "ObjectStore"): {
        "_segments": ("_lock", "object_store.file_store"),
        "_used": ("_lock", "object_store.file_store"),
        "_graveyard": ("_lock", "object_store.file_store"),
        "_freeing": ("_lock", "object_store.file_store"),
    },
    ("_private/object_store.py", "ArenaObjectStore"): {
        "_meta": ("_lock", "object_store.arena_store"),
        "_access": ("_lock", "object_store.arena_store"),
        "_clock": ("_lock", "object_store.arena_store"),
        "_pending_delete": ("_lock", "object_store.arena_store"),
        "_external": ("_lock", "object_store.arena_store"),
        "_foreign": ("_lock", "object_store.arena_store"),
    },
    # -- node_service.py: the head's daemon registry -------------------
    ("_private/node_service.py", "DaemonHandle"): {
        "proxies": ("_lock", "node_service.daemon_handle"),
        "_idle": ("_lock", "node_service.daemon_handle"),
        "dead_workers": ("_lock", "node_service.daemon_handle"),
        "_req_counter": ("_req_lock", "node_service.daemon_req"),
        "_pending": ("_req_lock", "node_service.daemon_req"),
    },
    ("_private/node_service.py", "HeadServer"): {
        "daemons": ("_lock", "node_service.head_registry"),
    },
}

# Functions that run WITH a guarded lock already held by their caller
# (the `*_locked` convention): (file, qualname) -> {lock_attr, ...}.
# Checked both directions for rot, like REF_MUTATION_HELPERS: every
# entry must still exist in the tree, every `*_locked` def in a
# registered class must be declared here, and every lexical CALL of a
# declared helper must itself sit under the held lock(s).
HOLDS_LOCK = {
    ("_private/scheduler.py", "WorkerHandle._flush_coalesced_locked"):
        {"send_lock"},
    ("_private/scheduler.py", "Scheduler._enqueue_locked"): {"_lock"},
    ("_private/worker_proc.py", "SequenceGate._caller_locked"): {"_lock"},
    ("_private/worker_proc.py", "SequenceGate._mark_locked"): {"_lock"},
    ("_private/worker_proc.py", "SequenceGate._admissible_locked"):
        {"_lock"},
    ("_private/worker_proc.py", "SequenceGate._hold_locked"): {"_lock"},
    ("_private/worker_proc.py", "SequenceGate._drain_locked"): {"_lock"},
    ("_private/worker_proc.py", "SequenceGate._force_oldest_locked"):
        {"_lock"},
    ("_private/worker_proc.py", "SequenceGate._ensure_resync_locked"):
        {"_lock"},
    ("_private/direct.py", "DirectPlane._flush_accounting_locked"):
        {"_cond"},
    ("_private/direct.py", "DirectPlane._seq_state_locked"): {"_cond"},
    ("_private/direct.py", "DirectPlane._mark_routed_locked"): {"_cond"},
    ("_private/direct.py", "DirectPlane._settle_seq_locked"): {"_cond"},
    ("_private/direct.py", "DirectPlane._seq_snapshot_locked"): {"_cond"},
    ("_private/direct.py", "DirectPlane._cache_put_locked"): {"_cond"},
    ("_private/direct.py", "DirectPlane._resolve_pending_locked"):
        {"_cond"},
    ("_private/direct.py", "DirectPlane._retire_locked"): {"_cond"},
    ("_private/direct.py", "DirectPlane._retire_stream_locked"): {"_cond"},
    ("_private/netcomm.py", "HostCopyGate._pump_locked"): {"_lock"},
    ("_private/netcomm.py", "SerialExecutor._ensure_thread_locked"):
        {"_cond"},
    ("_private/runtime.py", "Node._gen_stream_state"): {"_gen_lock"},
    ("_private/object_store.py", "ObjectStore._collect_graveyard"):
        {"_lock"},
    ("_private/object_store.py", "ObjectStore._audit_report_locked"):
        {"_lock"},
    ("_private/object_store.py", "ObjectStore._drain_pool_locked"):
        {"_lock"},
    ("_private/object_store.py", "ObjectStore._spill_locked"): {"_lock"},
    ("_private/object_store.py", "ObjectStore._segment_census_locked"):
        {"_lock"},
    ("_private/object_store.py", "ObjectStore._spill_candidates_locked"):
        {"_lock"},
    ("_private/object_store.py", "ObjectStore._stage_remote_spill_locked"):
        {"_lock"},
    ("_private/object_store.py", "ObjectStore._commit_staged_spill_locked"):
        {"_lock"},
    ("_private/object_store.py", "ArenaObjectStore._spill_locked"):
        {"_lock"},
}

# Attribute names too generic to match on a non-self receiver when
# resolving cross-object accesses to a registered class's field.
GUARDED_GENERIC_ATTRS = frozenset({
    "_lock", "_cond", "lock", "_state", "_queue", "_refs", "_closed"})

# ---------------------------------------------------------------------------
# ref-discipline: the ownership/refcount conservation surface.
#
# The direct-call plane re-derives the reference's "no object freed
# while any node holds a live reference" invariant from buffered
# accounting (REF_DELTAS / DIRECT_DONE residual transfers drained at
# flush_accounting barriers). The pass pins four mechanical properties
# of that surface; each registry block below is one of them.
# ---------------------------------------------------------------------------
# Files that make up the refcounting surface (mutation-helper inventory
# scope).
REF_FILES = ("_private/gcs.py", "_private/direct.py",
             "_private/worker_proc.py", "_private/runtime.py",
             "_private/object_store.py")

# Method names that mutate a refcount wherever they are defined. A def
# with one of these names inside REF_FILES must appear in
# REF_MUTATION_HELPERS (and every entry there must still exist) — a new
# mutation helper is a new conservation obligation and must be declared.
REF_MUTATION_METHOD_NAMES = frozenset({
    "incref", "decref", "apply_delta", "ref_delta"})
REF_MUTATION_HELPERS = {
    ("_private/gcs.py", "ObjectDirectory.incref"),
    ("_private/gcs.py", "ObjectDirectory.decref"),
    ("_private/gcs.py", "ObjectDirectory.apply_delta"),
    ("_private/direct.py", "DirectPlane.ref_delta"),
    ("_private/worker_proc.py", "WorkerClient.incref"),
    ("_private/worker_proc.py", "WorkerClient.decref"),
    ("_private/runtime.py", "Node.incref"),
    ("_private/runtime.py", "Node.decref"),
}

# Park sites: caller-side buffers that hold UNSHIPPED accounting
# (coalesced deltas, retired-but-unflushed completion entries, local
# in-flight counts). A function writing into one (subscript store,
# augmented subscript store, or .append) must lexically contain a call
# to a drain barrier, be a barrier itself, carry a REF_PARK_DEFERRED
# entry naming where it drains, or annotate the park line with
# `# lint: ref-park-ok <reason>`.
REF_PARK_FILES = ("_private/direct.py",)
REF_PARK_ATTRS = frozenset({"_ref_buf", "_done_buf", "_refs"})
REF_BARRIER_FUNCS = frozenset({"flush_accounting",
                               "_flush_accounting_locked"})
# (file, qualname) -> reason the drain barrier lives elsewhere.
REF_PARK_DEFERRED = {
    ("_private/direct.py", "DirectPlane._on_gen_items"):
        "streamed items carry only their arrival count; the stream's "
        "terminal registration (_retire_stream_locked) pops the "
        "residuals and flushes in the same critical section",
}

# Reserve/seal discipline (zero-copy put path): a reservation returned
# by a store ``reserve()``/``_reserve()`` call is an open write — until
# settled by seal (object becomes immutable/readable) or abort
# (segment popped, partial file unlinked), the store carries charged-
# but-unreadable capacity and readers can mmap truncated bytes as if
# sealed. Any function in RESERVE_FILES that calls a reserve must
# lexically call a settle, name its deferred settle in
# RESERVE_DEFERRED (streamed protocols settle on a later message), or
# annotate `# lint: reserve-seal-ok <reason>`. Defs NAMED like a
# reserve/settle are the implementations and are exempt.
RESERVE_FILES = ("_private/object_store.py", "_private/direct.py",
                 "_private/worker_proc.py", "_private/runtime.py")
RESERVE_CALL_NAMES = frozenset({"reserve", "_reserve"})
RESERVE_SETTLE_NAMES = frozenset({"seal", "abort", "_abort_reserve"})
# (file, qualname) -> reason the settle lives elsewhere.
RESERVE_DEFERRED = {
    ("_private/direct.py", "DirectPlane._on_obj_chunk"):
        "streamed pull: the reservation settles at the stream terminal "
        "(_on_obj_eof seals a complete byte count; _abort_pull_state "
        "aborts on failure/fallback)",
}

# Escape-marked state: ids referenced by a head-bound message while
# still locally owned. Any elision (a `continue`-only guard skipping an
# accounting entry) inside REF_ELISION_FUNCS must reference this state
# — directly or through a local derived from it — so an entry the head
# is waiting on can never be silently dropped (the PR 5 elision bug).
REF_ESCAPE_STATE = frozenset({"_escaped"})
REF_ELISION_FUNCS = {
    ("_private/direct.py", "DirectPlane._flush_accounting_locked"),
}

# Residual-transfer payload conservation: every field a producer writes
# into one of these payloads must be read by its registered consumer
# (orphan fields rot into silent accounting loss), and the consumer
# must not read fields nothing produces (phantoms mask producer
# regressions). Key discovery: dict literals passed to a send call
# whose first argument is P.<send_const>, dict literals assigned to an
# `entry_vars` name inside a producer function, and string-subscript
# stores on those names. Consumer reads come off `payload_vars` only.
# A payload is skipped when the fixture tree lacks its files; a present
# file missing a registered function is a violation (registry rot).
REF_PAYLOADS = {
    "DIRECT_DONE": {
        "send_const": "DIRECT_DONE",
        "producer_file": "_private/direct.py",
        "producers": ("DirectPlane._retire_locked",
                      "DirectPlane._retire_stream_locked",
                      "DirectPlane._flush_accounting_locked",
                      "DirectPlane.send_result"),
        "entry_vars": ("ent", "entry"),
        "consumer_file": "_private/runtime.py",
        "consumers": ("Node._on_direct_done",),
        "payload_vars": ("payload", "ent"),
        "exempt": {},
    },
    "REF_DELTAS": {
        "send_const": "REF_DELTAS",
        "producer_file": "_private/direct.py",
        "producers": ("DirectPlane._flush_accounting_locked",),
        "entry_vars": (),
        "consumer_file": "_private/runtime.py",
        "consumers": ("Node._on_ref_deltas",),
        "payload_vars": ("payload",),
        "exempt": {},
    },
    "GEN_ITEM(channel)": {
        "send_const": "GEN_ITEM",
        "producer_file": "_private/direct.py",
        "producers": ("DirectPlane.send_gen_item",),
        # The payload literal is bound to a local first (the wiretap
        # hook records the same object the writer ships).
        "entry_vars": ("payload",),
        "consumer_file": "_private/direct.py",
        "consumers": ("DirectPlane._on_gen_items",),
        "payload_vars": ("p",),
        "exempt": {},
    },
    "GEN_ITEM(head)": {
        "send_const": "GEN_ITEM",
        "producer_file": "_private/worker_proc.py",
        "producers": ("Worker._stream_generator",),
        "entry_vars": (),
        "consumer_file": "_private/runtime.py",
        "consumers": ("Node._on_gen_item",),
        "payload_vars": ("payload",),
        "exempt": {},
    },
}

# ---------------------------------------------------------------------------
# barrier-coverage: head-bound send chokepoints (the PR 5 round-7/8
# hang shape as a lint rule). Every send of a P.<CONST> message to the
# head from worker-side code must be preceded — lexically, in the same
# function — by a call to the accounting barrier, unless the constant
# is in the reasoned exemption list below or the send line carries
# `# lint: barrier-ok <reason>`. Sends routed through the covered
# wrappers (Worker.request flushes first, by construction) are exempt;
# the pass verifies the wrappers themselves contain the barrier.
# ---------------------------------------------------------------------------
BARRIER_SEND_FILES = ("_private/worker_proc.py", "_private/direct.py")
BARRIER_SEND_ATTRS = frozenset({"send", "send_lazy"})
BARRIER_WRAPPER_ATTRS = frozenset({"request", "_request"})
# The covered wrappers: these functions must themselves call the
# barrier before their send (verified), which is what makes every
# call THROUGH them barrier-covered.
BARRIER_WRAPPERS = {
    ("_private/worker_proc.py", "Worker.request"),
}
BARRIER_EXEMPT = {
    "DIRECT_DONE": "this send IS the accounting barrier's own drain",
    "REF_DELTAS": "this send IS the accounting barrier's own drain",
    "DIRECT_RECONCILE": "channel-death chokepoint: ships the drained "
                        "residuals itself under the plane lock",
    "REF_COUNT": "oneway fallback when the direct plane is off — "
                 "nothing is ever buffered to order against",
    "CHANNEL_ADDR": "listener advertisement; references no object ids",
    "GEN_ITEM": "head-path stream items reference only ids created by "
                "this statement; the producing task's arg accounting "
                "flushed at submission",
    "TASK_EVENTS": "telemetry plane: events reference ids by hex "
                   "string only, never as refcount state",
    "METRICS_PUSH": "telemetry plane: numeric gauges only",
    "WORKER_BLOCKED": "advisory scheduler hint; no object references",
    "WORKER_UNBLOCKED": "advisory scheduler hint; no object references",
    "TASKS_RECALLED": "recalled specs never executed here: no local "
                      "accounting exists for their returns yet",
}

# ---------------------------------------------------------------------------
# protocol-order: the send-site registry (the RECV_LOOPS dual).
#
# (file, qualname) -> tuple of (session, role, states) entries from
# protocol_model.SESSIONS: the session conversations this function is
# registered to speak in and the DFA states it may run in. A send
# site's constant must be a legal send for AT LEAST ONE entry (const in
# that session/role's send table, with overlapping states). A send of a
# protocol constant from an unregistered function fails — like an
# unregistered recv loop, it would dodge the ordering contract.
# Nested defs (NodeDaemon._route._localize) inherit the enclosing
# registered function's entries. Escape hatch on the send line:
# `# lint: protocol-order-ok <reason>` (stale annotations are flagged).
#
# A handful of functions speak in TWO sessions at once: the direct
# channel's handshake/teardown constants (CHANNEL_REQ, CHANNEL_ADDR,
# DIRECT_RECONCILE) ride the worker pipe, so their senders carry both
# the direct-session entry (the conversation they advance) and the
# worker-session entry (the transport they ride).
# ---------------------------------------------------------------------------
PROTOCOL_SEND_FUNCS = {
    # -- head side of the worker pipe ----------------------------------
    ("_private/runtime.py", "Node._broadcast_releases"):
        (("worker", "head", ("OPEN",)),
         ("daemon", "head", ("REGISTERED",))),
    ("_private/runtime.py", "Node._dispatch"):
        (("worker", "head", ("OPEN",)),),
    ("_private/runtime.py", "Node._dispatch_actor_creation"):
        (("worker", "head", ("OPEN",)),),
    ("_private/runtime.py", "Node._flush_actor_queue"):
        (("worker", "head", ("OPEN",)),),
    ("_private/runtime.py", "Node._cancel_running_task"):
        (("worker", "head", ("OPEN",)),),
    ("_private/runtime.py", "Node.cancel"):
        (("worker", "head", ("OPEN",)),),
    ("_private/runtime.py", "Node._on_worker_death"):
        (("worker", "head", ("OPEN",)),),
    ("_private/runtime.py", "Node._reply"):
        (("worker", "head", ("OPEN",)),),
    ("_private/runtime.py", "Node._note_seq_settled"):
        (("worker", "head", ("OPEN",)),),
    ("_private/runtime.py", "Node._broker_channel_info"):
        (("worker", "head", ("OPEN",)),),
    ("_private/runtime.py", "Node._note_blocked_and_recall"):
        (("worker", "head", ("OPEN",)),),
    ("_private/runtime.py", "Node._forward_results"):
        (("worker", "head", ("OPEN",)),),
    ("_private/runtime.py", "Node._fwd_scope_end"):
        (("worker", "head", ("OPEN",)),),
    ("_private/scheduler.py", "WorkerHandle._flush_coalesced_locked"):
        (("worker", "head", ("OPEN",)),),
    ("_private/scheduler.py", "WorkerPool.shutdown"):
        (("worker", "head", ("OPEN",)),),
    ("_private/scheduler.py", "Scheduler._try_pipeline"):
        (("worker", "head", ("OPEN",)),),
    ("_private/scheduler.py", "Scheduler._reclaim_idle_gpu_workers"):
        (("worker", "head", ("OPEN",)),),
    ("_private/node_service.py", "HeadServer._heartbeat_monitor"):
        (("worker", "head", ("OPEN",)),),
    # The daemon answers node-local worker-plane requests (spill, pull,
    # view) in the head role of the worker session, and relays the rest.
    ("_private/daemon.py", "NodeDaemon._heartbeat_loop"):
        (("daemon", "daemon", ("REGISTERED",)),
         ("worker", "head", ("OPEN",))),
    ("_private/daemon.py", "NodeDaemon._on_worker_message"):
        (("daemon", "daemon", ("REGISTERED",)),
         ("worker", "head", ("OPEN",))),
    ("_private/daemon.py", "NodeDaemon._handle_pull"):
        (("worker", "head", ("OPEN",)),),
    ("_private/daemon.py", "NodeDaemon._route_worker_plane"):
        (("worker", "head", ("OPEN",)),),
    ("_private/daemon.py", "NodeDaemon._reclaim_idle_gpu_workers"):
        (("worker", "head", ("OPEN",)),),
    # -- worker side of the worker pipe --------------------------------
    ("_private/worker_proc.py", "WorkerClient.incref"):
        (("worker", "worker", ("OPEN",)),),
    ("_private/worker_proc.py", "WorkerClient.decref"):
        (("worker", "worker", ("OPEN",)),),
    ("_private/worker_proc.py", "WorkerClient.put"):
        (("worker", "worker", ("OPEN",)),),
    ("_private/worker_proc.py", "WorkerClient.get_locations"):
        (("worker", "worker", ("OPEN",)),),
    ("_private/worker_proc.py", "WorkerClient.wait"):
        (("worker", "worker", ("OPEN",)),),
    ("_private/worker_proc.py", "WorkerClient.submit_task"):
        (("worker", "worker", ("OPEN",)),),
    ("_private/worker_proc.py", "WorkerClient.submit_actor_task"):
        (("worker", "worker", ("OPEN",)),),
    ("_private/worker_proc.py", "WorkerClient.create_actor"):
        (("worker", "worker", ("OPEN",)),),
    ("_private/worker_proc.py", "WorkerClient.get_actor"):
        (("worker", "worker", ("OPEN",)),),
    ("_private/worker_proc.py", "WorkerClient.kill_actor"):
        (("worker", "worker", ("OPEN",)),),
    ("_private/worker_proc.py", "WorkerClient.gcs_request"):
        (("worker", "worker", ("OPEN",)),),
    ("_private/worker_proc.py", "Worker.read_location"):
        (("worker", "worker", ("OPEN",)),),
    ("_private/worker_proc.py", "Worker._stream_generator"):
        (("worker", "worker", ("OPEN",)),),
    ("_private/worker_proc.py", "Worker._flush_telemetry"):
        (("worker", "worker", ("OPEN",)),),
    ("_private/worker_proc.py", "Worker._emit_done"):
        (("worker", "worker", ("OPEN",)),),
    ("_private/worker_proc.py", "Worker._recall_queued"):
        (("worker", "worker", ("OPEN",)),),
    ("_private/worker_proc.py", "Worker._create_actor"):
        (("worker", "worker", ("OPEN",)),),
    ("_private/direct.py", "DirectPlane._flush_accounting_locked"):
        (("worker", "worker", ("OPEN",)),),
    ("_private/direct.py", "DirectPlane.get_locations"):
        (("worker", "worker", ("OPEN",)),),
    # -- direct channel (handshake constants ride the worker pipe) -----
    ("_private/direct.py", "DirectPlane._establish"):
        (("direct", "caller", ("ESTABLISHING",)),
         ("worker", "worker", ("OPEN",))),
    ("_private/direct.py", "DirectPlane.on_channel_open"):
        (("direct", "callee", ("ESTABLISHING",)),
         ("worker", "worker", ("OPEN",))),
    ("_private/direct.py", "DirectPlane._send_call"):
        (("direct", "caller", ("OPEN",)),),
    ("_private/direct.py", "DirectPlane.gen_release"):
        (("direct", "caller", ("OPEN",)),),
    ("_private/direct.py", "DirectPlane._on_channel_down"):
        (("direct", "caller", ("DRAINING",)),
         ("worker", "worker", ("OPEN",))),
    ("_private/direct.py", "DirectPlane.send_gen_item"):
        (("direct", "callee", ("OPEN", "DRAINING")),),
    ("_private/direct.py", "DirectPlane.send_result"):
        (("direct", "callee", ("OPEN", "DRAINING")),
         ("worker", "worker", ("OPEN",))),
    ("_private/direct.py", "DirectPlane._on_serve_req"):
        (("direct", "callee", ("OPEN", "DRAINING")),),
    ("_private/direct.py", "DirectPlane._serve_exec"):
        (("direct", "callee", ("OPEN", "DRAINING")),),
    # -- direct object transfer plane ----------------------------------
    ("_private/direct.py", "DirectPlane.pull_object"):
        (("direct", "caller", ("OPEN",)),),
    # pull_object's send body after the in-process duplicate-pull
    # dedup gate was split out (r18); same session/role/states.
    ("_private/direct.py", "DirectPlane._pull_object_gated"):
        (("direct", "caller", ("OPEN",)),),
    ("_private/direct.py", "DirectPlane._send_pull_eof"):
        (("direct", "callee", ("OPEN", "DRAINING")),),
    ("_private/direct.py", "DirectPlane._pull_serve_exec"):
        (("direct", "callee", ("OPEN", "DRAINING")),),
    ("serve/_private/direct_client.py", "_broker"):
        (("direct", "caller", ("ESTABLISHING",)),
         ("worker", "worker", ("OPEN",))),
    ("serve/_private/direct_client.py", "_ServeChannel.call"):
        (("direct", "caller", ("OPEN",)),),
    ("serve/_private/direct_client.py", "_ServeChannel._on_resp"):
        (("direct", "caller", ("OPEN",)),),
    # -- head side of the daemon link ----------------------------------
    ("_private/node_service.py", "RemoteWorkerProxy.send"):
        (("daemon", "head", ("REGISTERED",)),),
    ("_private/node_service.py", "RemoteWorkerProxy.kill"):
        (("daemon", "head", ("REGISTERED",)),),
    ("_private/node_service.py", "DaemonHandle.start_worker"):
        (("daemon", "head", ("REGISTERED",)),),
    ("_private/node_service.py", "HeadServer._handshake_and_register"):
        (("daemon", "head", ("NEW",)),),
    ("_private/node_service.py", "HeadServer._route"):
        (("daemon", "head", ("REGISTERED",)),),
    ("_private/node_service.py", "HeadServer._handle_node_request"):
        (("daemon", "head", ("REGISTERED",)),),
    ("_private/node_service.py", "HeadServer.stop"):
        (("daemon", "head", ("REGISTERED",)),),
    ("_private/runtime.py", "Node._drain_worker"):
        (("daemon", "head", ("REGISTERED",)),),
    ("_private/runtime.py", "Node._drain_rehome_objects"):
        (("daemon", "head", ("REGISTERED",)),),
    ("_private/scheduler.py", "Scheduler._try_dispatch"):
        (("daemon", "head", ("REGISTERED",)),),
    # Cluster.remove_node stops a daemon node through stop_daemon, which
    # sends SHUTDOWN_NODE over the head's link to a registered daemon.
    ("cluster_utils.py", "stop_daemon"):
        (("daemon", "head", ("REGISTERED",)),),
    ("autoscaler/v2.py", "DaemonInstanceProvider.terminate"):
        (("daemon", "head", ("REGISTERED",)),),
    # -- daemon side of the daemon link --------------------------------
    ("_private/daemon.py", "NodeDaemon._connect_head"):
        (("daemon", "daemon", ("NEW",)),),
    ("_private/daemon.py", "NodeDaemon._request"):
        (("daemon", "daemon", ("REGISTERED",)),),
    ("_private/daemon.py", "NodeDaemon._route"):
        (("daemon", "daemon", ("REGISTERED",)),),
    ("_private/daemon.py", "NodeDaemon._start_worker"):
        (("daemon", "daemon", ("REGISTERED",)),),
    ("_private/daemon.py", "NodeDaemon._on_worker_death"):
        (("daemon", "daemon", ("REGISTERED",)),),
}

# Attribute names that move a protocol frame toward a transport: the
# protocol-order/payload-schema passes treat a call of one of these
# with a P.<CONST> first argument as a send site.
PROTOCOL_SEND_ATTRS = frozenset({
    "send", "send_lazy", "send_message", "request", "_request", "_send",
    "broadcast", "dump_message",
})

# Attribute names that tear a connection down; a send on the same
# receiver lexically after one of these (same function) is flagged.
PROTOCOL_CLOSE_ATTRS = frozenset({"close"})

# ---------------------------------------------------------------------------
# payload-schema: registered consumers whose reads are diffed against
# protocol_model.PAYLOADS (the phantom-field direction; producers are
# discovered from send sites). Each entry: the payload dict goes by
# `payload_vars` inside `functions` of `file`. A consumer read of a key
# no schema variant declares is a phantom (masks producer regressions).
# ---------------------------------------------------------------------------
PAYLOAD_CONSUMERS = {
    "ACTOR_CALL": (
        {"file": "_private/direct.py",
         "functions": ("DirectPlane._wire_spec",),
         "payload_vars": ("payload",)},
    ),
    "SERVE_REQ": (
        {"file": "_private/direct.py",
         "functions": ("DirectPlane._serve_exec",
                       "DirectPlane._on_serve_req"),
         "payload_vars": ("payload",)},
    ),
    "SERVE_RESP": (
        {"file": "serve/_private/direct_client.py",
         "functions": ("_ServeChannel._on_resp",),
         "payload_vars": ("payload",)},
    ),
    "SERVE_BODY_FREE": (
        {"file": "_private/direct.py",
         "functions": ("DirectPlane._on_serve_body_free",),
         "payload_vars": ("payload",)},
    ),
    "GEN_CANCEL": (
        {"file": "_private/direct.py",
         "functions": ("DirectPlane._handle_direct_message",),
         "payload_vars": ("payload",)},
    ),
    "PULL_DIRECT": (
        {"file": "_private/direct.py",
         "functions": ("DirectPlane._on_pull_direct",
                       "DirectPlane._pull_serve_exec"),
         "payload_vars": ("payload",)},
    ),
    "OBJ_CHUNK": (
        {"file": "_private/direct.py",
         "functions": ("DirectPlane._on_obj_chunk",),
         "payload_vars": ("payload",)},
    ),
    "OBJ_EOF": (
        {"file": "_private/direct.py",
         "functions": ("DirectPlane._on_obj_eof",),
         "payload_vars": ("payload",)},
    ),
    "REGISTER_NODE": (
        {"file": "_private/node_service.py",
         "functions": ("HeadServer._handshake_and_register",),
         "payload_vars": ("payload",)},
    ),
}
