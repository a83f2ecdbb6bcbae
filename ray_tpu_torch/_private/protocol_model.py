"""Declarative wire-protocol model: session DFAs + payload schemas.

(The port's lint, ``ray_tpu_torch/devtools/lint``, imports this module
for its protocol-order and payload-schema passes; the wiretap imports it
too, so the static and the dynamic checks read one model.)

One model, three consumers:

  * the **protocol-order** static pass
    (``devtools/lint/protocol_order.py``) — every send site's constant
    must be a legal transition from the states its enclosing function
    is registered to run in, every request constant
    must have a registered response path, and no send may be reachable
    after the connection's teardown;
  * the **payload-schema** static pass
    (``devtools/lint/payload_schema.py``) — send-site payload shapes
    are diffed against :data:`PAYLOADS` (orphan keys,
    phantom consumer reads, compact-tuple arity drift);
  * the **runtime conformance tap** (``_private/wiretap.py``) — live
    frame sequences are replayed through :class:`SessionDFA` instances
    per connection (RTT_WIRETAP=1).

This module is pure data + a pure-stdlib DFA interpreter: the runtime
MAY import it (wiretap does, lazily, only when enabled); nothing here
imports the runtime. New planes from the roadmap (direct object
transfer, compiled DAGs) register their sessions/constants HERE on day
one — an unmodeled constant is itself a protocol-order violation.

DFA notation (docs/STATIC_ANALYSIS.md#the-protocol-model): a *session*
is one logical conversation over one transport (the worker pipe, the
daemon TCP link, a brokered direct channel). Each session declares its
states, the initial state, per-role send tables (``CONST -> states in
which sending it is legal``), the handshake constants (first frame(s)
of the session, ``advance`` moves the DFA forward when one is seen),
and the teardown constant (after which the connection is CLOSED and any
further frame is a violation). Constants may belong to several sessions
— the direct channel's handshake (CHANNEL_REQ/CHANNEL_ADDR) rides the
worker pipe, so those constants appear in both the "worker" session
(plane membership) and the "direct" session (handshake states).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------
# Three sessions cover the five parsed planes: "worker" carries
# to_worker + from_worker (one pipe, two directions), "daemon" carries
# head_to_daemon + daemon_to_head, "direct" carries the worker<->worker
# channel plane (actor calls, streams, AND the serve data plane — serve
# frames ride brokered DirectPlane connections).
SESSIONS = {
    "worker": {
        # head <-> worker pipe. No handshake (the fork/spawn plumbing
        # IS the establishment); SHUTDOWN is the head-side teardown.
        "states": ("OPEN", "CLOSED"),
        "initial": "OPEN",
        "handshake": (),
        "advance": {},
        "teardown": "SHUTDOWN",
        "roles": {
            "head": {
                "sends": {
                    "EXEC_TASK": ("OPEN",), "EXEC_TASKS": ("OPEN",),
                    "CREATE_ACTOR": ("OPEN",), "CANCEL_TASK": ("OPEN",),
                    "RELEASE_OBJECTS": ("OPEN",), "SHUTDOWN": ("OPEN",),
                    "REPLY": ("OPEN",), "CHANNEL_OPEN": ("OPEN",),
                    "RESULT_FWD": ("OPEN",), "SEQ_SETTLED": ("OPEN",),
                    "TELEMETRY_DRAIN": ("OPEN",),
                    "RECALL_QUEUED": ("OPEN",),
                },
            },
            "worker": {
                "sends": {
                    "REF_COUNT": ("OPEN",), "TASK_DONE": ("OPEN",),
                    "TASKS_DONE": ("OPEN",), "TASKS_RECALLED": ("OPEN",),
                    "GEN_ITEM": ("OPEN",), "ACTOR_READY": ("OPEN",),
                    "OWNED_PUT": ("OPEN",), "GET_LOCATIONS": ("OPEN",),
                    "WAIT_OBJECTS": ("OPEN",), "SUBMIT_TASK": ("OPEN",),
                    "SUBMIT_ACTOR_TASK": ("OPEN",),
                    "CREATE_ACTOR_REQ": ("OPEN",), "GET_ACTOR": ("OPEN",),
                    "KILL_ACTOR": ("OPEN",), "GCS_REQUEST": ("OPEN",),
                    "PULL_OBJECT": ("OPEN",), "TASK_EVENTS": ("OPEN",),
                    "METRICS_PUSH": ("OPEN",), "CHANNEL_REQ": ("OPEN",),
                    "CHANNEL_ADDR": ("OPEN",), "DIRECT_DONE": ("OPEN",),
                    "DIRECT_RECONCILE": ("OPEN",),
                    "REF_DELTAS": ("OPEN",),
                    "WORKER_BLOCKED": ("OPEN",),
                    "WORKER_UNBLOCKED": ("OPEN",),
                },
            },
        },
        # req_id-keyed REPLY pairing: outstanding requests are fed by
        # the Worker.request chokepoint (wiretap.request_sent); a REPLY
        # arriving for a req_id never sent is a violation.
        "rid_resp": "REPLY",
        # WORKER_BLOCKED/UNBLOCKED is a counter, not an alternation:
        # with max_concurrency > 1 several blocks overlap legally, but
        # the count may never dip negative.
        "counters": ({"up": "WORKER_BLOCKED", "down": "WORKER_UNBLOCKED"},),
        "pairs": (),
        "streams": None,
        "frees": None,
    },
    "daemon": {
        # head <-> node-daemon TCP link. REGISTER_NODE opens, NODE_ACK
        # confirms (strictly before any routed frame), SHUTDOWN_NODE
        # tears down.
        "states": ("NEW", "REGISTERED", "CLOSED"),
        "initial": "NEW",
        "handshake": ("REGISTER_NODE", "NODE_ACK"),
        "advance": {"REGISTER_NODE": "REGISTERED",
                    "NODE_ACK": "REGISTERED"},
        "teardown": "SHUTDOWN_NODE",
        "roles": {
            "head": {
                "sends": {
                    "NODE_ACK": ("NEW",),
                    "NODE_SYNC": ("REGISTERED",),
                    "START_WORKER": ("REGISTERED",),
                    "TO_WORKER": ("REGISTERED",),
                    "KILL_WORKER": ("REGISTERED",),
                    "WORKER_DEDICATED": ("REGISTERED",),
                    "SHUTDOWN_NODE": ("REGISTERED",),
                    "LOCALIZE_OBJECT": ("REGISTERED",),
                    "DRAIN_NODE": ("REGISTERED",),
                    "NODE_REPLY": ("REGISTERED",),
                    # release broadcasts fan out to daemons too (each
                    # relays to its own workers and frees its store)
                    "RELEASE_OBJECTS": ("REGISTERED",),
                },
            },
            "daemon": {
                "sends": {
                    "REGISTER_NODE": ("NEW",),
                    "NODE_PING": ("REGISTERED",),
                    "NODE_REQUEST": ("REGISTERED",),
                    "NODE_REPLY": ("REGISTERED",),
                    "FROM_WORKER": ("REGISTERED",),
                    "WORKER_DIED": ("REGISTERED",),
                    "DRAIN_STATUS": ("REGISTERED",),
                },
            },
        },
        "rid_resp": None,
        "counters": (),
        "pairs": (),
        "streams": None,
        "frees": None,
    },
    "direct": {
        # Brokered worker<->worker channel: actor calls, generator
        # streams, and the serve data plane. The handshake constants
        # ride the worker pipe (brokered establishment), so a live
        # channel object starts at OPEN (runtime_initial); the static
        # states still model handshake-before-call. DIRECT_RECONCILE
        # (also pipe-borne) is the caller's channel-death drain: it
        # settles every outstanding call that will never see its
        # ACTOR_RESULT.
        "states": ("ESTABLISHING", "OPEN", "DRAINING"),
        "initial": "ESTABLISHING",
        "runtime_initial": "OPEN",
        "handshake": ("CHANNEL_REQ", "CHANNEL_ADDR"),
        "advance": {"CHANNEL_REQ": "ESTABLISHING", "CHANNEL_ADDR": "OPEN",
                    "DIRECT_RECONCILE": "DRAINING"},
        "teardown": None,
        "roles": {
            "caller": {
                "sends": {
                    "CHANNEL_REQ": ("ESTABLISHING",),
                    "ACTOR_CALL": ("OPEN",),
                    "GEN_CANCEL": ("OPEN",),
                    "SERVE_REQ": ("OPEN",),
                    "SERVE_BODY_FREE": ("OPEN",),
                    "PULL_DIRECT": ("OPEN",),
                    "DIRECT_RECONCILE": ("DRAINING",),
                },
            },
            "callee": {
                "sends": {
                    "CHANNEL_ADDR": ("ESTABLISHING",),
                    "ACTOR_RESULT": ("OPEN", "DRAINING"),
                    "GEN_ITEM": ("OPEN", "DRAINING"),
                    "SERVE_RESP": ("OPEN", "DRAINING"),
                    "SERVE_BODY_FREE": ("OPEN", "DRAINING"),
                    "OBJ_CHUNK": ("OPEN", "DRAINING"),
                    "OBJ_EOF": ("OPEN", "DRAINING"),
                },
            },
        },
        "rid_resp": None,
        "counters": (),
        # Every ACTOR_CALL pairs with exactly one ACTOR_RESULT (or the
        # reconcile drain); SERVE_REQ rid-pairs with SERVE_RESP;
        # PULL_DIRECT rid-pairs with its OBJ_EOF terminal.
        "pairs": ({"req": "ACTOR_CALL", "resp": "ACTOR_RESULT"},
                  {"req": "SERVE_REQ", "resp": "SERVE_RESP"},
                  {"req": "PULL_DIRECT", "resp": "OBJ_EOF"}),
        # Stream specs (one or many): GEN_ITEM streams carry a dense
        # per-call index between the opening (streaming) ACTOR_CALL and
        # its terminal ACTOR_RESULT, with GEN_CANCEL moving the stream
        # to a draining set where late in-flight items stay legal.
        # OBJ_CHUNK streams are the object-transfer plane's ranged
        # chunks: gapless dense indexes between the opening PULL_DIRECT
        # and its OBJ_EOF terminal (no cancel — a dropped pull just
        # abandons the rid and the chunks drop on arrival).
        "streams": ({"item": "GEN_ITEM", "cancel": "GEN_CANCEL",
                     "opener": "ACTOR_CALL", "terminal": "ACTOR_RESULT"},
                    {"item": "OBJ_CHUNK", "cancel": None,
                     "opener": "PULL_DIRECT", "terminal": "OBJ_EOF"}),
        # SERVE_BODY_FREE only for a body the peer actually staged.
        "frees": {"free": "SERVE_BODY_FREE",
                  "stagers": ("SERVE_REQ", "SERVE_RESP")},
    },
}

# ---------------------------------------------------------------------------
# request/response registry
# ---------------------------------------------------------------------------
# Every request-shaped constant and where its response comes back.
# ``loop`` names the registry.RECV_LOOPS entry whose dispatch span must
# dispatch the response constant (the protocol-order pass verifies it);
# ``loop: None`` requires a written reason (responses consumed outside
# any registered loop).
REQUESTS = {
    "GET_LOCATIONS": {"response": "REPLY", "loop": "worker.run"},
    "WAIT_OBJECTS": {"response": "REPLY", "loop": "worker.run"},
    "CREATE_ACTOR_REQ": {"response": "REPLY", "loop": "worker.run"},
    "GET_ACTOR": {"response": "REPLY", "loop": "worker.run"},
    "KILL_ACTOR": {"response": "REPLY", "loop": "worker.run"},
    "GCS_REQUEST": {"response": "REPLY", "loop": "worker.run"},
    "PULL_OBJECT": {"response": "REPLY", "loop": "worker.run"},
    "CHANNEL_REQ": {"response": "REPLY", "loop": "worker.run"},
    "DIRECT_RECONCILE": {"response": "REPLY", "loop": "worker.run"},
    "NODE_REQUEST": {"response": "NODE_REPLY", "loop": "daemon.run"},
    "START_WORKER": {"response": "NODE_REPLY", "loop": "head.daemon_serve"},
    "LOCALIZE_OBJECT": {"response": "NODE_REPLY",
                        "loop": "head.daemon_serve"},
    "REGISTER_NODE": {
        "response": "NODE_ACK", "loop": None,
        "reason": "the ACK is consumed synchronously by the "
                  "registration handshake (_connect_head) before the "
                  "daemon run loop starts; daemon.run carries a "
                  "matching NODE_ACK recv-loop exemption"},
    "SERVE_REQ": {"response": "SERVE_RESP", "loop": "serve.client"},
    "ACTOR_CALL": {"response": "ACTOR_RESULT", "loop": "worker.direct"},
    "PULL_DIRECT": {"response": "OBJ_EOF", "loop": "worker.direct"},
}

# ---------------------------------------------------------------------------
# payload schemas
# ---------------------------------------------------------------------------
# One entry per constant. ``variants`` is a tuple of alternative shapes
# (most constants have one); a send-site dict literal must match one
# variant: contain every ``required`` key, contain no key outside
# required|optional, and honor any declared compact-tuple ``arity``.
# ``optional`` also covers keys added conditionally via subscript
# stores after the literal. ``open: True`` marks payloads assembled
# dynamically (relay envelopes, result dicts built across functions) —
# key checking is skipped but the constant stays modeled.
#
# Request payloads list "req_id" optional everywhere: the request
# wrappers (Worker.request / DaemonHandle.request) inject it after the
# call-site literal, and responders read it back.
PAYLOADS = {
    # -- head -> worker ----------------------------------------------------
    "EXEC_TASK": {"variants": ({"required": ("spec",), "optional": ()},)},
    "EXEC_TASKS": {"variants": (
        {"required": ("specs_pickled",), "optional": ()},)},
    "CREATE_ACTOR": {"variants": ({"required": ("spec",), "optional": ()},)},
    "CANCEL_TASK": {"variants": (
        {"required": ("task_id",), "optional": ()},)},
    "RELEASE_OBJECTS": {"variants": (
        {"required": ("object_ids",), "optional": ()},)},
    "SHUTDOWN": {"variants": ({"required": (), "optional": ()},)},
    "REPLY": {"variants": (
        {"required": ("req_id", "result"), "optional": ()},)},
    "CHANNEL_OPEN": {"variants": ({"required": ("token",), "optional": ()},)},
    "RESULT_FWD": {"variants": ({"required": ("entries",), "optional": ()},)},
    "SEQ_SETTLED": {"variants": (
        {"required": ("caller_id", "seqs"), "optional": ("all",)},
        {"required": ("actor_id", "seqs"), "optional": ()},)},
    "TELEMETRY_DRAIN": {"variants": ({"required": (), "optional": ()},)},
    "RECALL_QUEUED": {"variants": ({"required": (), "optional": ()},)},
    # -- worker -> head ----------------------------------------------------
    "REF_COUNT": {"variants": (
        {"required": ("object_id", "delta"), "optional": ()},)},
    # Completion dicts are assembled across worker_proc execution paths
    # (results/error/nested/streamed/spec...) and pruned per route.
    "TASK_DONE": {"open": True},
    "TASKS_DONE": {"variants": ({"required": ("batch",), "optional": ()},)},
    "TASKS_RECALLED": {"variants": (
        {"required": ("task_ids",), "optional": ()},)},
    "GEN_ITEM": {"variants": (
        # channel path (DirectPlane.send_gen_item)
        {"required": ("t", "i", "loc", "nested"), "optional": ()},
        # head path (Worker._stream_generator)
        {"required": ("task_id", "index", "loc", "nested"),
         "optional": ()},)},
    "ACTOR_READY": {"variants": (
        {"required": ("actor_id", "error"), "optional": ()},)},
    "OWNED_PUT": {"variants": (
        {"required": ("object_id", "inline", "nested"), "optional": ()},
        {"required": ("object_id", "size", "nested"), "optional": ()},)},
    "GET_LOCATIONS": {"variants": (
        {"required": ("object_ids", "timeout"),
         "optional": ("req_id",)},)},
    "WAIT_OBJECTS": {"variants": (
        {"required": ("object_ids", "num_returns", "timeout"),
         "optional": ("req_id",)},)},
    "SUBMIT_TASK": {"variants": ({"required": ("spec",), "optional": ()},)},
    "SUBMIT_ACTOR_TASK": {"variants": (
        {"required": ("spec",), "optional": ()},)},
    "CREATE_ACTOR_REQ": {"variants": (
        {"required": ("spec",), "optional": ("req_id",)},)},
    "GET_ACTOR": {"variants": (
        {"required": ("name", "namespace"), "optional": ("req_id",)},)},
    "KILL_ACTOR": {"variants": (
        {"required": ("actor_id", "no_restart"),
         "optional": ("req_id",)},)},
    "GCS_REQUEST": {"variants": (
        {"required": ("op", "kwargs"), "optional": ("req_id",)},)},
    "PULL_OBJECT": {"variants": (
        {"required": ("object_id", "node"),
         "optional": ("materialize", "req_id")},)},
    "TASK_EVENTS": {"variants": (
        {"required": ("events", "dropped"),
         "optional": ("spans", "span_drops", "sub")},)},
    "METRICS_PUSH": {"variants": (
        {"required": ("worker_id", "node_id", "groups", "ts"),
         "optional": ()},)},
    "CHANNEL_REQ": {"variants": (
        {"required": ("actor_id",),
         "optional": ("req_id", "settled_below", "settled_set")},)},
    "CHANNEL_ADDR": {"variants": (
        {"required": ("token", "error"), "optional": ()},)},
    "DIRECT_DONE": {"variants": ({"required": ("entries",), "optional": ()},)},
    "DIRECT_RECONCILE": {"variants": (
        {"required": ("actor_id", "specs", "deltas", "req_id",
                      "callee_wid"),
         "optional": ("settled_below", "settled_set")},)},
    "REF_DELTAS": {"variants": ({"required": ("deltas",), "optional": ()},)},
    "WORKER_BLOCKED": {"variants": ({"required": (), "optional": ()},)},
    "WORKER_UNBLOCKED": {"variants": ({"required": (), "optional": ()},)},
    # -- direct channel ----------------------------------------------------
    "ACTOR_CALL": {"variants": (
        # compact fast path: one 11-slot tuple (task_id, actor, method,
        # name, return_ids, num_returns, fn_id, caller_id, caller_seq,
        # seq_preds, trace_ctx) — arity drift breaks _wire_spec
        {"required": ("c",), "optional": (), "arity": {"c": 11}},
        {"required": ("spec",), "optional": ()},)},
    "ACTOR_RESULT": {"variants": (
        {"required": ("t", "results", "error", "nested"),
         "optional": ("streamed",)},)},
    "GEN_CANCEL": {"variants": ({"required": ("t",), "optional": ()},)},
    "SERVE_REQ": {"variants": (
        {"required": ("r", "m", "b", "sn"), "optional": ("tr",)},)},
    "SERVE_RESP": {"variants": (
        {"required": ("r",), "optional": ("v", "e")},)},
    "SERVE_BODY_FREE": {"variants": ({"required": ("o",), "optional": ()},)},
    # -- direct object transfer --------------------------------------------
    "PULL_DIRECT": {"variants": (
        {"required": ("r", "o"), "optional": ()},)},
    # compact chunk tuple (rid, index, offset, total, oob-bytes) — the
    # bytes slot is a pickle-5 out-of-band view of the sealed segment,
    # never a pickled copy; arity drift breaks the chunk unpack.
    "OBJ_CHUNK": {"variants": (
        {"required": ("c",), "optional": (), "arity": {"c": 5}},)},
    "OBJ_EOF": {"variants": (
        {"required": ("r", "ok"), "optional": ("e",)},)},
    # -- head -> daemon ----------------------------------------------------
    "NODE_ACK": {"variants": (
        {"required": ("head_node_id_hex", "head_transfer_port"),
         "optional": ()},)},
    "NODE_SYNC": {"variants": (
        {"required": ("ts", "view"), "optional": ()},)},
    "START_WORKER": {"variants": (
        {"required": ("env_key", "dedicated", "nchips", "runtime_env"),
         "optional": ("req_id",)},)},
    "TO_WORKER": {"variants": (
        {"required": ("worker", "frame"), "optional": ()},)},
    "KILL_WORKER": {"variants": ({"required": ("worker",), "optional": ()},)},
    "WORKER_DEDICATED": {"variants": (
        {"required": ("worker", "actor_id"), "optional": ()},)},
    "SHUTDOWN_NODE": {"variants": ({"required": (), "optional": ()},)},
    "LOCALIZE_OBJECT": {"variants": (
        {"required": ("object_id", "node"), "optional": ("req_id",)},)},
    "DRAIN_NODE": {"variants": (
        {"required": ("node_id", "deadline_s"), "optional": ()},)},
    "NODE_REPLY": {"variants": (
        {"required": ("req_id", "result"), "optional": ()},)},
    # -- daemon -> head ----------------------------------------------------
    "REGISTER_NODE": {"variants": (
        {"required": ("node_id_hex", "resources", "transfer_port",
                      "hostname", "pid", "labels"), "optional": ()},)},
    "NODE_PING": {"variants": (
        {"required": ("ts", "store_used", "num_workers", "free_chips",
                      "pool_workers"),
         "optional": ("metrics", "metrics_ts")},)},
    "NODE_REQUEST": {"variants": (
        {"required": ("req_id", "op", "kwargs"), "optional": ()},)},
    "FROM_WORKER": {"variants": (
        {"required": ("worker", "frame"), "optional": ()},)},
    "WORKER_DIED": {"variants": ({"required": ("worker",), "optional": ()},)},
    "DRAIN_STATUS": {"variants": (
        {"required": ("node_id", "state", "ts"), "optional": ()},)},
}


def session_constants(session: dict) -> set:
    """Every constant any role of `session` may send."""
    out = set()
    for role in session["roles"].values():
        out.update(role["sends"])
    return out


def all_modeled_constants() -> set:
    out = set()
    for session in SESSIONS.values():
        out |= session_constants(session)
    return out


# ---------------------------------------------------------------------------
# runtime DFA interpreter (the wiretap's engine; also unit-testable
# without a cluster)
# ---------------------------------------------------------------------------
class SessionDFA:
    """Replays one connection's frame sequence against a SESSIONS entry.

    ``feed(direction, const_name, payload)`` returns the violations that
    frame produced (empty list == conforming). The interpreter checks
    sequencing invariants that hold regardless of which endpoint we are:
    plane membership, handshake-before-traffic, frame-after-teardown,
    request/response pairing, stream density/terminality, staged-body
    frees, and counter non-negativity. Per-state *send legality* is the
    static pass's job (it knows which states each send site is
    registered for); enforcing it here against the peer's inferred
    state would false-positive on legal races.

    ``extractors`` maps constant name -> callable(payload) -> dict with
    any of: ``key`` (pairing/stream key), ``index`` (stream index),
    ``streaming`` (opener starts a stream), ``stage`` (body oid this
    frame stages). Extractors never raise into the caller: a payload
    the extractor cannot read simply skips the keyed checks.
    """

    #: remembered terminated stream keys (item-after-terminal detection)
    TERMINATED_RING = 256

    def __init__(self, session_name: str, role: str, conn: str,
                 extractors: Optional[Dict[str, Callable]] = None):
        self.session_name = session_name
        self.session = SESSIONS[session_name]
        self.role = role
        self.conn = conn
        self.extractors = extractors or {}
        self.state = self.session.get("runtime_initial",
                                      self.session["initial"])
        self.consts = session_constants(self.session)
        self.recent: List[Tuple[str, str]] = []  # (direction, const) ring
        self.outstanding: Dict[Any, int] = {}    # pairing key -> count
        self.rids: set = set()                   # rid_resp outstanding
        self.streams: Dict[Any, int] = {}        # stream key -> next index
        self.cancelled: set = set()
        self.terminated: List[Any] = []
        self.staged_by_us: set = set()
        self.staged_by_peer: set = set()
        self.counters: Dict[str, int] = {}

    # -- plumbing ------------------------------------------------------
    def _extract(self, const: str, payload: Any) -> Dict[str, Any]:
        fn = self.extractors.get(const)
        if fn is None:
            return {}
        try:
            return fn(payload) or {}
        except Exception:
            return {}

    def _violation(self, kind: str, const: str, direction: str,
                   **detail: Any) -> Dict[str, Any]:
        v = {"kind": kind, "session": self.session_name,
             "conn": self.conn, "role": self.role, "state": self.state,
             "dir": direction, "const": const,
             "recent": list(self.recent)}
        v.update(detail)
        return v

    def note_request(self, rid: Any) -> None:
        """Register an outstanding rid-keyed request (fed from the
        request-wrapper chokepoint; the response constant must drain
        it)."""
        self.rids.add(rid)

    # -- the interpreter -----------------------------------------------
    def feed(self, direction: str, const: str,
             payload: Any) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        sess = self.session
        if const not in self.consts:
            out.append(self._violation("wrong-plane", const, direction))
            self._remember(direction, const)
            return out
        if self.state == "CLOSED":
            out.append(self._violation(
                "frame-after-teardown", const, direction,
                teardown=sess["teardown"]))
        handshake = sess["handshake"]
        if handshake and self.state == sess["initial"] \
                and const not in handshake:
            out.append(self._violation(
                "frame-before-handshake", const, direction,
                expected=handshake[0]))
        if handshake and const == handshake[0] \
                and self.state != sess["initial"] and self.state != "CLOSED":
            out.append(self._violation(
                "duplicate-handshake", const, direction))

        ext = self._extract(const, payload)

        # pairing -------------------------------------------------------
        for pair in sess["pairs"]:
            key = ext.get("key")
            if const == pair["req"] and key is not None:
                self.outstanding[key] = self.outstanding.get(key, 0) + 1
                if ext.get("streaming"):
                    self.streams[key] = 0
            elif const == pair["resp"] and key is not None:
                if self.outstanding.get(key, 0) <= 0:
                    out.append(self._violation(
                        "response-without-request", const, direction,
                        pair_req=pair["req"], key=repr(key)))
                else:
                    self.outstanding[key] -= 1
                    if not self.outstanding[key]:
                        del self.outstanding[key]

        # rid_resp (request-wrapper pairing) ----------------------------
        if sess.get("rid_resp") and const == sess["rid_resp"] \
                and direction == "recv":
            rid = ext.get("key")
            if rid is not None:
                if rid in self.rids:
                    self.rids.discard(rid)
                else:
                    out.append(self._violation(
                        "response-without-request", const, direction,
                        key=repr(rid)))

        # streams -------------------------------------------------------
        # One session may carry several stream kinds (generator items,
        # object-transfer chunks); a bare dict is the one-stream form.
        specs = sess["streams"]
        if isinstance(specs, dict):
            specs = (specs,)
        for streams in specs or ():
            key = ext.get("key")
            if const == streams["item"] and key is not None:
                idx = ext.get("index")
                if key in self.streams:
                    want = self.streams[key]
                    if idx is not None and idx != want:
                        out.append(self._violation(
                            "stream-gap", const, direction,
                            key=repr(key), expected=want, got=idx))
                        self.streams[key] = (idx + 1) if idx is not None \
                            else want
                    else:
                        self.streams[key] = want + 1
                elif key in self.cancelled:
                    pass  # post-cancel in-flight items drain legally
                elif key in self.terminated:
                    out.append(self._violation(
                        "item-after-terminal", const, direction,
                        key=repr(key)))
                else:
                    out.append(self._violation(
                        "stream-item-without-call", const, direction,
                        key=repr(key)))
            elif const == streams["terminal"]:
                if key is not None and (key in self.streams
                                        or key in self.cancelled):
                    self.streams.pop(key, None)
                    self.cancelled.discard(key)
                    self._terminate(key)
                elif key is not None and ext.get("streamed"):
                    self._terminate(key)
            elif streams["cancel"] is not None \
                    and const == streams["cancel"]:
                # Cancel of an unknown/finished stream is a legal race.
                if key is not None and key in self.streams:
                    del self.streams[key]
                    self.cancelled.add(key)

        # staged-body frees ---------------------------------------------
        frees = sess["frees"]
        if frees is not None:
            stage = ext.get("stage")
            if const in frees["stagers"] and stage is not None:
                (self.staged_by_us if direction == "send"
                 else self.staged_by_peer).add(stage)
            elif const == frees["free"]:
                oid = ext.get("key")
                pool = self.staged_by_peer if direction == "send" \
                    else self.staged_by_us
                if oid is not None:
                    if oid in pool:
                        pool.discard(oid)
                    else:
                        out.append(self._violation(
                            "free-without-stage", const, direction,
                            oid=repr(oid)))

        # counters ------------------------------------------------------
        for counter in sess["counters"]:
            if const == counter["up"]:
                self.counters[counter["up"]] = \
                    self.counters.get(counter["up"], 0) + 1
            elif const == counter["down"]:
                n = self.counters.get(counter["up"], 0) - 1
                self.counters[counter["up"]] = n
                if n < 0:
                    out.append(self._violation(
                        "unbalanced-counter", const, direction,
                        counter=counter["up"], count=n))

        # state advance / teardown --------------------------------------
        if const in sess["advance"] and self.state != "CLOSED":
            self.state = sess["advance"][const]
        if sess["teardown"] is not None and const == sess["teardown"]:
            self.state = "CLOSED"
        if const == "DIRECT_RECONCILE" and self.session_name == "direct":
            # Reconcile IS the drain: every outstanding call/stream is
            # settled by the head from the shipped residuals.
            self.outstanding.clear()
            self.streams.clear()
            self.cancelled.clear()

        self._remember(direction, const)
        return out

    def _remember(self, direction: str, const: str) -> None:
        self.recent.append((direction, const))
        if len(self.recent) > 8:
            del self.recent[0]

    def _terminate(self, key: Any) -> None:
        self.terminated.append(key)
        if len(self.terminated) > self.TERMINATED_RING:
            del self.terminated[0]
