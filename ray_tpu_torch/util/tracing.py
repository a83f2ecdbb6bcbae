"""Distributed tracing: a first-class citizen of the telemetry plane.

Reference parity: python/ray/util/tracing/tracing_helper.py — the
reference injects OpenTelemetry spans around task/actor submission and
execution and propagates span context *inside task specs*
(_DictPropagator:165, span decorators :195+), and aggregates per-task
events in the GCS task manager (SURVEY §2.2, §5). Same design here
without a hard OpenTelemetry dependency.

Architecture (everything piggybacks on the telemetry plane):

  * **Recording** is a lock + bounded deque append into a process-local
    drop-oldest buffer with an EXACT drop counter — never a syscall,
    never a head round trip (the old ``record_spans`` gcs_request flush
    after every traced task is gone).
  * **Shipping**: workers drain the buffer into the ``TASK_EVENTS``
    frame enqueued right before each completion (worker_proc
    ``_flush_telemetry``), so spans ride the SAME vectored write as the
    TASK_DONE — zero extra syscalls; idle workers drain on the
    TELEMETRY_DRAIN heartbeat nudge. The driver flushes straight into
    the in-process store.
  * **Aggregation**: ``Gcs.telemetry`` keeps bounded per-trace rings
    (``TelemetryStore.record_spans``) with per-trace drop counters and
    a global LRU cap — replacing the old unbounded ``Gcs._spans`` list.
  * **Propagation**: submit spans stamp ``spec.trace_ctx`` (api.py);
    the direct plane carries the context as a compact-wire tail slot
    (traced calls keep the no-arg fast path); the serve proxy speaks
    W3C ``traceparent`` in and out.

Gate discipline: ``tracing.enabled`` is a module attribute (falsy-flag,
like ``telemetry.enabled`` / ``fault.enabled``); every helper that does
tracing work bumps the ``_ops`` counter so the tracing-off hot path is
provably zero-work (counter-based perf_smoke guard). ``enable()``
mirrors the flag into ``RTT_TRACING`` so spawned daemons, workers,
and serve replicas inherit it.

In-process records (the model, feed, generation and Data hot paths):

  * **When**: while a torch.profiler session is active in the process
    (``torch.autograd.profiler._is_profiler_enabled``, which the
    profiler's start and stop hooks set, read through
    ``tracing.profiler``), as ``record_function`` records. A hot site
    tests ``tracing.profiler._is_profiler_enabled`` inline and calls
    nothing when it is false. ``tracing.enabled``, the control plane's
    switch that ``enable()`` hands to every process of a cluster, does
    not turn them on.
  * **What**: spans (name, id, parent id, start ns, end ns), counts
    (name, ns, n) and device ranges (name, host start ns, then CUDA
    events around the forward and, under autograd, the backward). They
    stay in this process (never shipped on ``TASK_EVENTS``), in a
    drop-oldest store of ``LOCAL_CAP`` records with an exact drop
    count; ``local_records()`` resolves the events to device ms after a
    sync, ``clear_local()`` empties the store.
  * **Clock**: every stamp is ``time.time_ns()``, the host clock a
    torch.profiler trace puts its events on; control-plane spans keep
    their float-second fields, read from the same clock.

Usage:
    from ray_tpu_torch.util import tracing
    tracing.enable()
    with tracing.span("ingest", source="s3"):
        ref = f.remote(...)        # submit span + context ride the spec
    tracing.get_trace(trace_id)    # cross-node tree + critical path
    tracing.export_chrome_trace("/tmp/trace.json")
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import os
import sys
import threading
import itertools
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

_ENV_VAR = "RTT_TRACING"


def _env_enabled() -> bool:
    return os.environ.get(_ENV_VAR, "0").strip().lower() in (
        "1", "true", "yes", "on")


# Hot-path gate: module attribute looked up as `tracing.enabled` (one
# dict lookup); instrumentation sites check it (or an adopted context)
# before doing ANY tracing work. Default OFF (tracing is opt-in, unlike
# telemetry).
enabled = _env_enabled()

# Counter of tracing-helper invocations in THIS process — the
# perf_smoke guard's counter-based proxy for "the disabled path did no
# tracing work" (same discipline as telemetry.instrument_ops).
_ops = 0

_lock = threading.Lock()
# Bounded drop-oldest span buffer (drained by the worker's telemetry
# flush / the driver's in-process flush). Exact accounting: every
# record beyond capacity since the last drain counts in _dropped once.
_buffer: collections.deque = collections.deque()
_dropped = 0

_current: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_trace", default=None)   # (trace_id, span_id) or None


_cap: Optional[int] = None


def _buffer_cap() -> int:
    """The control-plane buffer's capacity, read from the config once."""
    global _cap
    if _cap is None:
        from .._private.config import ray_config
        _cap = max(16, int(ray_config.span_buffer_size))
    return _cap


# Ids: a random per-process prefix and a counter (re-drawn in a forked
# child), unique across the processes whose spans meet in one trace.
_ids = itertools.count(1)
_prefix = _prefix8 = ""


def _new_prefix() -> None:
    global _prefix, _prefix8, _ids
    _prefix = os.urandom(8).hex()
    _prefix8 = _prefix[:8]
    _ids = itertools.count(1)


_new_prefix()
os.register_at_fork(after_in_child=_new_prefix)


def _span_id() -> str:
    """16 hex digits: the prefix's first 8 and the counter's low 32 bits."""
    return f"{_prefix8}{next(_ids) & 0xFFFFFFFF:08x}"


def _trace_id() -> str:
    """32 hex digits: the prefix and the counter."""
    return f"{_prefix}{next(_ids):016x}"


def trace_ops() -> int:
    """Tracing-helper invocations so far (perf_smoke guard)."""
    return _ops


def enable(propagate_env: bool = True) -> None:
    """Turn on tracing in this process (reference:
    ray.init(_tracing_startup_hook=...) switch). With ``propagate_env``
    the flag is mirrored into RTT_TRACING so spawned daemons and
    workers inherit it."""
    global enabled
    enabled = True
    if propagate_env:
        os.environ[_ENV_VAR] = "1"


def disable(propagate_env: bool = True) -> None:
    global enabled
    enabled = False
    if propagate_env:
        os.environ[_ENV_VAR] = "0"


def is_enabled() -> bool:
    """Tracing is on if enabled process-wide OR a propagated context is
    active in this task (workers trace exactly the requests whose
    driver/proxy had tracing on, without flipping process state)."""
    return enabled or _current.get() is not None


def current_context() -> Optional[Dict[str, str]]:
    """Propagatable context dict of the active span (reference:
    _DictPropagator.inject_current_context)."""
    cur = _current.get()
    if cur is None:
        return None
    return {"trace_id": cur[0], "parent_span_id": cur[1]}


# ---------------------------------------------------------------------------
# W3C traceparent (the serve-proxy wire form of the context)
# ---------------------------------------------------------------------------
def parse_traceparent(header: Optional[str]) -> Optional[Dict[str, str]]:
    """``00-<32hex trace>-<16hex parent>-<2hex flags>`` -> context dict
    (None on anything malformed — a bad client header must never fail
    the request)."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) < 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    try:
        int(parts[1], 16), int(parts[2], 16)
    except ValueError:
        return None
    return {"trace_id": parts[1], "parent_span_id": parts[2]}


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------
def _record(span: dict) -> None:
    """Buffer one finished span: lock + deque append, drop-oldest with
    an exact counter. NO flush round trip here — spans leave the
    process on the telemetry plane's existing frames."""
    global _dropped
    cap = _cap or _buffer_cap()
    with _lock:
        if len(_buffer) >= cap:
            _buffer.popleft()
            _dropped += 1
        _buffer.append(span)


def drain_spans() -> Tuple[List[dict], int]:
    """Pop everything buffered; returns (spans, dropped_since_last).
    Called by the worker's telemetry flush (spans ride the TASK_EVENTS
    frame) and by the driver-side flush below."""
    global _dropped
    if not _buffer and not _dropped:
        return [], 0
    with _lock:
        spans = list(_buffer)
        _buffer.clear()
        dropped, _dropped = _dropped, 0
    return spans, dropped


def flush() -> None:
    """Consumer-path flush: move buffered spans into the head's store.
    On the driver this is an in-process call; in a worker it is ONE
    explicit gcs request (reached only from get_spans/get_trace — the
    task hot path ships spans on the TASK_EVENTS piggyback instead).
    Before init the bounded buffer simply holds."""
    if not _buffer and not _dropped:
        return
    from .._private import state
    node = state.get_node()
    if node is not None:
        spans, dropped = drain_spans()
        if spans or dropped:
            node.gcs.record_spans(spans, dropped=dropped,
                                  node_id=node.node_id.hex(),
                                  worker_id="driver")
        return
    rt = state.current_or_none()
    if rt is None or not hasattr(rt, "gcs_request"):
        return
    spans, dropped = drain_spans()
    if spans or dropped:
        # Stamp THIS worker's identity: the head's generic gcs-op path
        # has no sender context, and an unstamped batch would render
        # under the head node / "driver" in the tree.
        kw = {"spans": spans, "dropped": dropped}
        w = getattr(state, "_worker", None)
        if w is not None:
            kw["node_id"] = w.config.node_id_hex
            kw["worker_id"] = w.config.worker_id.hex()
        try:
            rt.gcs_request("record_spans", **kw)
        except Exception:
            # Bounded loss, surfaced: no silent swallow, no unbounded
            # retry re-queue (the old `_buffer = batch + _buffer` bug).
            import logging
            logging.getLogger(__name__).warning(
                "dropping %d spans: head flush failed", len(spans),
                exc_info=True)


class _Span:
    """One control-plane span, open from ``__enter__`` (which yields its
    span id) to ``__exit__`` (which buffers it, with the error that ended
    it, if any)."""
    __slots__ = ("name", "attributes", "cur", "trace_id", "span_id",
                 "token", "start", "otel")

    def __init__(self, name: str, attributes: Dict):
        self.name, self.attributes = name, attributes

    def __enter__(self) -> str:
        cur = self.cur = _current.get()
        self.trace_id = cur[0] if cur else _trace_id()
        self.span_id = _span_id()
        self.token = _current.set((self.trace_id, self.span_id))
        self.start = time.time_ns() / 1e9
        tracer = _otel()
        self.otel = None if tracer is None else \
            tracer.start_as_current_span(self.name, attributes={
                k: str(v) for k, v in (self.attributes or {}).items()})
        if self.otel is not None:
            self.otel.__enter__()
        return self.span_id

    def __exit__(self, exc_type, exc, tb) -> bool:
        try:
            if self.otel is not None:
                self.otel.__exit__(exc_type, exc, tb)
        finally:
            _current.reset(self.token)
            cur = self.cur
            _record({
                "name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id,
                "parent_span_id": cur[1] if cur else None,
                "start": self.start, "end": time.time_ns() / 1e9,
                "attributes": self.attributes or None,
                "error": None if exc is None else repr(exc),
            })
        return False


def span(name: str, **attributes: Any):
    """Record a span; nests under the active span, and downstream
    task/actor submissions inside it carry the context remotely."""
    global _ops
    if not (enabled or _current.get() is not None):
        return contextlib.nullcontext()
    _ops += 1
    return _Span(name, attributes)


def activate_context(ctx: Optional[Dict[str, str]]):
    """Adopt a propagated context (worker side; reference: extract from
    the task spec before running the user function). Returns a reset
    token or None. Deliberately does NOT flip the process-global enable
    flag: once the context is reset, this worker stops tracing unless
    the next task carries a context too."""
    global _ops
    if not ctx:
        return None
    _ops += 1
    return _current.set((ctx["trace_id"], ctx["parent_span_id"]))


def deactivate_context(token) -> None:
    if token is not None:
        _current.reset(token)


_UNRESOLVED = object()
_otel_tracer: Any = _UNRESOLVED


def _otel() -> Any:
    """The OpenTelemetry tracer, or None without the package: resolved
    once a process (a failed import is not retried at every span)."""
    global _otel_tracer
    if _otel_tracer is _UNRESOLVED:
        try:
            from opentelemetry import trace as otel_trace
            _otel_tracer = otel_trace.get_tracer("ray_tpu_torch")
        except Exception:
            _otel_tracer = None
    return _otel_tracer


# ---------------------------------------------------------------------------
# collection / consumers (driver side)
# ---------------------------------------------------------------------------
def get_spans(trace_id: Optional[str] = None) -> List[dict]:
    """Spans aggregated in the head's telemetry store (flushing this
    process's buffer first)."""
    flush()
    from .._private import state
    node = state.get_node()
    if node is not None:
        return node.gcs.spans(trace_id)
    rt = state.current_or_none()
    if rt is not None and hasattr(rt, "gcs_request"):
        try:
            # `or []`: local mode answers unknown ops with None.
            return rt.gcs_request("get_spans", trace_id=trace_id) or []
        except Exception:
            return []
    return []


def build_trace(spans: List[dict]) -> dict:
    """Assemble one trace's spans into a tree + critical-path summary.
    Pure function of the span list (unit-testable; get_trace feeds it
    the store's ring)."""
    by_id: Dict[str, dict] = {}
    for s in spans:
        sid = s.get("span_id")
        if sid:
            # First writer wins: a SIGKILL/retry replay of the same
            # span id must not duplicate a node in the tree.
            by_id.setdefault(sid, dict(s, children=[]))
    roots: List[dict] = []
    for node in by_id.values():
        parent = by_id.get(node.get("parent_span_id") or "")
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    for node in by_id.values():
        node["children"].sort(key=lambda c: c.get("start", 0.0))
    roots.sort(key=lambda c: c.get("start", 0.0))

    # Critical path: from the earliest root, descend into the child
    # whose END is latest (the chain the trace's wall time waited on).
    path: List[dict] = []
    cur = roots[0] if roots else None
    while cur is not None:
        path.append({
            "name": cur.get("name"), "span_id": cur.get("span_id"),
            "start": cur.get("start"), "end": cur.get("end"),
            "duration_s": round(
                (cur.get("end") or 0.0) - (cur.get("start") or 0.0), 6),
            "node_id": cur.get("node_id"),
            "worker_id": cur.get("worker_id"),
            "error": cur.get("error")})
        kids = cur["children"]
        cur = max(kids, key=lambda c: c.get("end", 0.0)) if kids else None
    starts = [s.get("start") for s in spans if s.get("start") is not None]
    ends = [s.get("end") for s in spans if s.get("end") is not None]
    return {
        "trace_id": spans[0].get("trace_id") if spans else None,
        "span_count": len(by_id),
        "node_ids": sorted({s.get("node_id") for s in spans
                            if s.get("node_id")}),
        "duration_s": round(max(ends) - min(starts), 6)
        if starts and ends else 0.0,
        "roots": roots,
        "critical_path": path,
    }


def get_trace(trace_id: str) -> dict:
    """Reassemble the cross-node span tree of one trace with a
    critical-path summary (reference: what a Jaeger/Zipkin UI renders
    from the collector; the `ray_tpu_torch trace <id>` CLI prints this)."""
    return build_trace(get_spans(trace_id))


def format_trace(trace: dict) -> str:
    """Human-readable tree of a get_trace() result (the CLI's renderer)."""
    lines = [f"trace {trace.get('trace_id')}  "
             f"{trace.get('span_count')} spans  "
             f"{trace.get('duration_s')}s  "
             f"nodes={','.join(n[:8] for n in trace.get('node_ids', []))}"]

    def walk(node, depth):
        dur = (node.get("end") or 0.0) - (node.get("start") or 0.0)
        where = (node.get("worker_id") or "driver")[:8]
        err = "  ERROR" if node.get("error") else ""
        lines.append(f"{'  ' * depth}{node.get('name')}  "
                     f"[{dur * 1000:.2f} ms @ {where}]{err}")
        for c in node.get("children", ()):
            walk(c, depth + 1)

    for r in trace.get("roots", ()):
        walk(r, 1)
    crit = trace.get("critical_path") or ()
    if crit:
        lines.append("critical path: " + " -> ".join(
            f"{s['name']} ({s['duration_s'] * 1000:.2f} ms)"
            for s in crit))
    return "\n".join(lines)


def export_chrome_trace(filename: Optional[str] = None,
                        trace_id: Optional[str] = None) -> List[dict]:
    """Spans + task timeline as ONE Chrome-trace JSON with a shared
    layout — **rows (pid) are nodes, threads (tid) are workers**, the
    same convention as `ray_tpu_torch timeline`, so a serve request's proxy,
    replica, and nested-task spans line up under the workers that ran
    them (reference: `ray timeline` merged with span events)."""
    import json

    from . import state as state_api

    events = state_api.timeline()
    for s in get_spans(trace_id):
        if "ph" in s:
            # Pre-formed chrome event (util/profiling.py records these
            # straight into the span store).
            events.append(s)
            continue
        if s.get("start") is None or s.get("end") is None:
            continue
        events.append({
            "cat": "span", "name": s.get("name") or "?", "ph": "X",
            "ts": s["start"] * 1e6, "dur": (s["end"] - s["start"]) * 1e6,
            "pid": (s.get("node_id") or "ray_tpu_torch")[:8],
            "tid": (s.get("worker_id") or "driver")[:8],
            "args": {k: v for k, v in s.items()
                     if k in ("trace_id", "span_id", "parent_span_id",
                              "attributes", "error")},
        })
    if filename:
        with open(filename, "w") as f:
            json.dump(events, f)
    return events


# ---------------------------------------------------------------------------
# in-process records: the hot paths' spans, counts and device ranges
# ---------------------------------------------------------------------------
class _Unbound:
    """Stands in for ``torch.autograd.profiler`` until torch is imported
    (the Data layer runs without it): the first read of the flag after
    that binds ``profiler`` to the module, so no caller has to."""

    def __getattr__(self, attr: str) -> Any:
        global profiler
        module = sys.modules.get("torch.autograd.profiler")
        if module is None:
            return False
        profiler = module
        return getattr(module, attr)


# The hot sites' gate reads ``profiler._is_profiler_enabled``.
profiler: Any = sys.modules.get("torch.autograd.profiler") or _Unbound()

# At least 8 times what a 10-s traced benchmark window makes in any cell.
LOCAL_CAP = 65536

_local: collections.deque = collections.deque()
# Taken only to drop: appends are atomic, and a drop re-checks the length
# under it, so every record dropped is counted once.
_local_lock = threading.Lock()
_now = time.time_ns
_local_dropped = 0
# The latest stamp among the dropped records (0: none dropped).
_local_dropped_ns = 0
_local_ids = itertools.count(1)
_local_current: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_local_span", default=0)   # the open span's id, 0: none

# Slots of a device range record: ["range", name, host start ns, forward
# start, forward end, backward start, backward end]. A stamp is a CUDA
# event, or host ns for a range on CPU tensors.
_FWD0, _FWD1, _BWD0, _BWD1 = 3, 4, 5, 6


def _keep(record: list) -> None:
    """Store one record; past LOCAL_CAP the oldest goes (counted, with the
    latest stamp dropped)."""
    if len(_local) >= LOCAL_CAP:
        _drop_oldest()
    _local.append(record)


def _drop_oldest() -> None:
    global _local_dropped, _local_dropped_ns
    with _local_lock:
        if len(_local) >= LOCAL_CAP:
            old = _local.popleft()
            _local_dropped += 1
            _local_dropped_ns = max(_local_dropped_ns, _stamp_of(old))


def _stamp_of(record: list) -> int:
    """A record's latest host stamp: a span's end, a count's or a range's
    start."""
    return record[5] if record[0] == "span" else record[2]


class _LocalSpan:
    """A hot span; with a device, also a device range over the enclosed
    work on the current stream (no autograd node)."""
    __slots__ = ("record", "token", "range")

    def __init__(self, name: str, device):
        self.record = ["span", name, next(_local_ids), 0, 0, 0]
        self.range = None if device is None else _stream_range(name, device)

    def __enter__(self):
        rec = self.record
        rec[3] = _local_current.get()
        self.token = _local_current.set(rec[2])
        rec[4] = _now()
        if self.range is not None:
            self.range[2] = rec[4]
            self.range[_FWD0] = self.range.stamp()
        return self

    def __exit__(self, *exc):
        rec = self.record
        if self.range is not None:
            self.range[_FWD1] = self.range.stamp()
            _keep(self.range)
        rec[5] = _now()
        _local_current.reset(self.token)
        _keep(rec)
        return False


class _Range(list):
    """A device range record, and the stamp its device takes."""
    __slots__ = ("stamp",)

    def __init__(self, name: str, start_ns: int, stamp: Callable):
        super().__init__(("range", name, start_ns, None, None, None, None))
        self.stamp = stamp


def _stream_range(name: str, device) -> Optional[_Range]:
    import torch
    stamp = _stamper(torch.device(device).type == "cuda")
    return None if stamp is None else _Range(name, 0, stamp)


def _stamper(cuda: bool) -> Optional[Callable[[], Any]]:
    """How a range is stamped: on a card by a timed CUDA event on the
    current stream, on the CPU by host ns; None while a CUDA graph is
    being captured (a timed event cannot be)."""
    if not cuda:
        return _now
    import torch
    if torch.cuda.is_current_stream_capturing():
        return None
    return _cuda_event


def _cuda_event():
    import torch
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def local_span(name: str, device=None) -> _LocalSpan:
    """A context manager recording a hot span ``name`` (nested under the
    open one); with ``device``, also a device range of the same name over
    the enclosed work on the current stream. Call it under the gate."""
    global _ops
    _ops += 1
    return _LocalSpan(name, device)


def local_call(name: str, fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` inside a hot span ``name``. Call it under
    the gate."""
    global _ops
    _ops += 1
    with _LocalSpan(name, None):
        return fn(*args, **kwargs)


def local_count(name: str, n: int) -> None:
    """Record a count of ``n`` under ``name``, stamped now. Call it under
    the gate."""
    global _ops
    _ops += 1
    _keep(["count", name, _now(), n])


_mark_cls = None


def _mark():
    """The identity autograd node that stamps a range's backward: on the
    range's output it runs first (the backward starts), on its input
    last (the backward ends). Built at first use (torch is imported
    then)."""
    global _mark_cls
    if _mark_cls is None:
        import torch

        class _Mark(torch.autograd.Function):
            @staticmethod
            def forward(ctx, record, slot, x):
                ctx.record, ctx.slot = record, slot
                return x.view_as(x)

            @staticmethod
            def backward(ctx, grad):
                ctx.record[ctx.slot] = ctx.record.stamp()
                return None, None, grad

        _mark_cls = _Mark
    return _mark_cls


def device_range(name: str, fn: Callable, x, *args, **kwargs):
    """``fn(x, *args, **kwargs)`` as a device range ``name``: its forward
    between two stamps on the current stream and, when ``x`` needs a
    gradient, its backward between the stamps two identity autograd
    nodes take, one on the output and one on ``x``. A CUDA tensor is
    stamped by timed events, a CPU one by host ns. Call it under the
    gate."""
    global _ops
    _ops += 1
    stamp = _stamper(x.is_cuda)
    if stamp is None:
        return fn(x, *args, **kwargs)
    import torch
    rec = _Range(name, _now(), stamp)
    grad = torch.is_grad_enabled() and x.requires_grad
    rec[_FWD0] = stamp()
    if grad:
        x = _mark().apply(rec, _BWD1, x)
    out = fn(x, *args, **kwargs)
    if grad and out.requires_grad:
        out = _mark().apply(rec, _BWD0, out)
    rec[_FWD1] = stamp()
    _keep(rec)
    return out


def _ms(a, b) -> Optional[float]:
    if a is None or b is None:
        return None
    if isinstance(a, int):
        return (b - a) / 1e6
    return float(a.elapsed_time(b))


def local_records() -> List[dict]:
    """The stored records, oldest first, as dicts: ``{"kind": "span",
    "name", "id", "parent", "start_ns", "end_ns"}`` (parent 0: a root),
    ``{"kind": "count", "name", "ns", "n"}`` and ``{"kind": "range",
    "name", "start_ns", "forward_ms", "backward_ms"}`` (backward None
    where no backward ran). Synchronizes the card first when a range
    holds CUDA events."""
    with _local_lock:
        records = list(_local)
    if any(r[0] == "range" and r[_FWD0] is not None
           and not isinstance(r[_FWD0], int) for r in records):
        import torch
        torch.cuda.synchronize()
    out = []
    for r in records:
        kind = r[0]
        if kind == "span":
            out.append({"kind": kind, "name": r[1], "id": r[2],
                        "parent": r[3], "start_ns": r[4], "end_ns": r[5]})
        elif kind == "count":
            out.append({"kind": kind, "name": r[1], "ns": r[2], "n": r[3]})
        else:
            out.append({"kind": kind, "name": r[1], "start_ns": r[2],
                        "forward_ms": _ms(r[_FWD0], r[_FWD1]),
                        "backward_ms": _ms(r[_BWD0], r[_BWD1])})
    return out


def local_dropped() -> Tuple[int, int]:
    """(records dropped since the last ``clear_local``, the latest stamp
    among them in ns; 0 when none)."""
    return _local_dropped, _local_dropped_ns


def clear_local() -> None:
    """Empty the in-process store and its drop count."""
    global _local_dropped, _local_dropped_ns
    with _local_lock:
        _local.clear()
        _local_dropped = 0
        _local_dropped_ns = 0
