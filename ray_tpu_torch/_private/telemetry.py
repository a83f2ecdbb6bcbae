"""Cluster-wide telemetry plane: task lifecycle events + metric federation.

Reference parity: the reference's observability stack — per-worker task
event buffers flushed to the GCS-side task manager
(src/ray/core_worker/task_event_buffer.h -> gcs_task_manager.cc), the
per-node MetricsAgent federating each process's metrics into one
Prometheus exposition (_private/metrics_agent.py, prometheus_exporter.py),
and the dashboard/state API answering ``ray list tasks`` from that
aggregated state (SURVEY §2.2, §5).

Architecture (no new connections — everything piggybacks on the existing
control plane):

  * **Task events** — every worker keeps a bounded :class:`TaskEventBuffer`
    of lifecycle transitions (RUNNING -> FINISHED/FAILED with monotonic
    wall timestamps, node/worker ids). Buffers flush as one ``TASK_EVENTS``
    message enqueued on the per-connection writer immediately before
    the task's completion message, so the events ride the SAME vectored
    write as the TASK_DONE — zero extra syscalls even when enabled. The
    head records PENDING_SCHEDULING / SUBMITTED / FAILED-with-attempt
    transitions itself (it owns scheduling and retry state). Drop-oldest
    under pressure with an exact ``dropped`` counter; recording never
    blocks the hot path.

  * **Metric federation** — each node daemon snapshots its process-local
    ``util/metrics.py`` registry into the NODE_PING heartbeat; workers
    piggyback a throttled ``METRICS_PUSH`` on task completion. The head
    aggregates the snapshots in :class:`TelemetryStore` and re-exports
    one merged Prometheus exposition with ``node_id`` / ``worker_id``
    tags (:func:`federated_prometheus_text`), served by the dashboard's
    ``/metrics`` and the ``ray_tpu_torch metrics`` CLI.

  * **Hot-path instrumentation** — scheduler queue depth + dispatch
    latency, writer coalescing batch size, host-copy-gate wait, store
    put/get bytes, pull retries, heartbeat RTT. Every site is gated on a
    single module-attribute truthiness check (``telemetry.enabled`` —
    the exact discipline of ``fault.py``), so the disabled hot path pays
    one dict lookup and performs no additional work (asserted by the
    ``perf_smoke`` guard in tests/test_observability.py).

Enable/disable via the ``RTT_TELEMETRY`` env var (default on) or
:func:`configure`; the setting propagates to spawned daemons and workers
through the environment, like RTT_FAULT_CONFIG.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

_ENV_VAR = "RTT_TELEMETRY"


def _env_enabled() -> bool:
    return os.environ.get(_ENV_VAR, "1").strip().lower() not in (
        "0", "false", "no", "off")


# Hot-path gate: module attribute looked up as `telemetry.enabled` (one
# dict lookup); every instrumentation site checks it before doing ANY
# telemetry work (same discipline as fault.enabled).
enabled = _env_enabled()

# Counter of instrumentation-helper invocations in THIS process — the
# perf_smoke guard's counter-based proxy for "the disabled path did no
# telemetry work": every helper below increments it, so a run with
# telemetry off must leave it untouched.
_ops = 0


def configure(on: bool, propagate_env: bool = True) -> None:
    """Flip the plane on/off for this process; with ``propagate_env``
    the setting is mirrored into RTT_TELEMETRY so spawned daemons
    and workers inherit it."""
    global enabled
    enabled = bool(on)
    if propagate_env:
        os.environ[_ENV_VAR] = "1" if on else "0"


def instrument_ops() -> int:
    """Instrumentation helper invocations so far (perf_smoke guard)."""
    return _ops


# ---------------------------------------------------------------------------
# head self-instrumentation: per-message-type ingest counters
# ---------------------------------------------------------------------------
# Dict bumped on the head's recv paths (gated at the call sites);
# exported as gauges at exposition time. A Metric.inc per message would
# tax the exact hot path ROADMAP item 2's scale harness measures; the
# small lock keeps concurrent recv threads (worker mux + one per
# daemon) from losing increments of the same type.
_msg_counts: Dict[str, int] = {}
_msg_counts_lock = threading.Lock()


def count_msg(msg_type: str, n: int = 1) -> None:
    """One ingested control message (head recv muxes; callers gate)."""
    global _ops
    _ops += 1
    with _msg_counts_lock:
        _msg_counts[msg_type] = _msg_counts.get(msg_type, 0) + n


def message_counts() -> Dict[str, int]:
    with _msg_counts_lock:
        return dict(_msg_counts)


# ---------------------------------------------------------------------------
# metric helpers (process-local util/metrics registry, lazily created so
# a disabled process never materializes a single Metric object)
# ---------------------------------------------------------------------------
_LAT_BOUNDS = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)
_BATCH_BOUNDS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 512.0)


_metric_create_lock = threading.Lock()


def _metric(name: str, kind: str, desc: str = "",
            boundaries: Optional[Tuple[float, ...]] = None,
            tag_keys: Optional[Tuple[str, ...]] = None):
    from ..util import metrics as M
    m = M._REGISTRY.get(name)  # GIL-safe read; the common hot case
    if m is not None:
        return m
    # Double-checked create under OUR lock (Metric.__init__ registers
    # last-writer-wins, so two concurrent constructors would silently
    # orphan one object's samples).
    with _metric_create_lock:
        m = M._REGISTRY.get(name)
        if m is None:
            if kind == "counter":
                m = M.Counter(name, desc, tag_keys=tag_keys)
            elif kind == "gauge":
                m = M.Gauge(name, desc, tag_keys=tag_keys)
            else:
                m = M.Histogram(name, desc, boundaries=list(
                    boundaries or _LAT_BOUNDS), tag_keys=tag_keys)
    return m


def record_dispatch_latency(dt: float) -> None:
    """Submit -> dispatch latency of one task (scheduler hot path)."""
    global _ops
    _ops += 1
    _metric("scheduler_dispatch_latency_s", "histogram",
            "Task latency from scheduler submit to worker dispatch"
            ).observe(max(dt, 1e-9))


def record_queue_depth(n: int) -> None:
    global _ops
    _ops += 1
    _metric("scheduler_queue_depth", "gauge",
            "Tasks queued or dependency-parked in the scheduler").set(n)


def record_writer_batch(n: int) -> None:
    """Messages coalesced into one vectored write by a ConnectionWriter."""
    global _ops
    _ops += 1
    _metric("writer_coalesce_batch_size", "histogram",
            "Messages shipped per connection-writer vectored write",
            boundaries=_BATCH_BOUNDS).observe(float(n))


def record_gate_wait(dt: float) -> None:
    global _ops
    _ops += 1
    _metric("host_copy_gate_wait_s", "histogram",
            "Time big copies queued for host-copy-gate admission"
            ).observe(max(dt, 1e-9))


def record_put_bytes(n: int) -> None:
    global _ops
    _ops += 1
    if n > 0:  # Counter.inc rejects 0; zero-byte objects add nothing
        _metric("store_put_bytes_total", "counter",
                "Bytes written into the local object store").inc(n)


def record_get_bytes(n: int) -> None:
    global _ops
    _ops += 1
    if n > 0:
        _metric("store_get_bytes_total", "counter",
                "Bytes read from the local object store").inc(n)


def record_pool_claim(hit: bool) -> None:
    """Segment-pool observability (zero-copy put path): did a reserve
    land on a recycled, already-faulted segment (hit) or pay a fresh
    create (miss)? A falling hit rate under a steady put workload means
    the pool limit or stripe count is mis-tuned (docs/PERF.md, "Layer:
    put path")."""
    global _ops
    _ops += 1
    name = ("store_pool_hits_total" if hit
            else "store_pool_misses_total")
    desc = ("Reserves served from the segment pool (pre-faulted pages)"
            if hit else
            "Reserves that created a fresh segment (pool empty/miss)")
    _metric(name, "counter", desc).inc()


def record_pool_reclaimed(node_id_hex: str, nbytes: int) -> None:
    """Node-tagged gauge of pooled bytes reclaimed under capacity
    pressure since store creation — sustained growth means the pool is
    fighting the capacity budget instead of caching it."""
    global _ops
    _ops += 1
    _metric("store_pool_reclaimed_bytes", "gauge",
            "Pooled segment bytes drained for capacity on this node",
            tag_keys=("node_id",)).set(
                nbytes, tags={"node_id": node_id_hex[:16]})


def record_pull_retry() -> None:
    global _ops
    _ops += 1
    _metric("store_pull_retries_total", "counter",
            "Transient-failure retries of cross-node object pulls").inc()


def record_heartbeat_rtt(dt: float) -> None:
    """Daemon-side: NODE_PING send -> NODE_SYNC ack round trip."""
    global _ops
    _ops += 1
    _metric("node_heartbeat_rtt_s", "histogram",
            "Daemon heartbeat round-trip time to the head"
            ).observe(max(dt, 1e-9))


def record_node_stats(store_used: int, num_workers: int,
                      free_gpus: int) -> None:
    """Per-node gauges refreshed on each daemon heartbeat tick."""
    global _ops
    _ops += 1
    _metric("object_store_used_bytes", "gauge",
            "Bytes resident in this node's object store").set(store_used)
    _metric("node_num_workers", "gauge",
            "Worker processes alive on this node").set(num_workers)
    _metric("node_free_gpus", "gauge",
            "Unassigned GPUs on this node").set(free_gpus)


def record_drain_progress(node_id_hex: str, objects_remaining: int,
                          tasks_remaining: int,
                          replicas_remaining: int) -> None:
    """Drain-progress gauges for one draining node (docs/DRAIN.md):
    how much work still pins the node. All zero ⇒ safe to terminate.
    Only emitted while a drain is active — steady state never touches
    these."""
    global _ops
    _ops += 1
    tags = {"node_id": node_id_hex[:16]}
    _metric("drain_objects_remaining", "gauge",
            "Primary object copies still to re-home off a draining node",
            tag_keys=("node_id",)).set(objects_remaining, tags=tags)
    _metric("drain_tasks_remaining", "gauge",
            "Running tasks still finishing on a draining node",
            tag_keys=("node_id",)).set(tasks_remaining, tags=tags)
    _metric("drain_replicas_remaining", "gauge",
            "Serve replicas still draining on a draining node",
            tag_keys=("node_id",)).set(replicas_remaining, tags=tags)


# -- direct worker<->worker call plane --------------------------------------
def record_direct_calls(n: int) -> None:
    """Actor calls shipped on direct channels (batched at the plane's
    accounting flush — a per-call Metric.inc would tax the exact hot
    path the plane exists to strip)."""
    global _ops
    _ops += 1
    if n > 0:
        _metric("direct_calls_total", "counter",
                "Actor calls shipped caller->callee on direct channels"
                ).inc(n)


def record_direct_results(n: int) -> None:
    """Inline results delivered callee->caller (batched, as above)."""
    global _ops
    _ops += 1
    if n > 0:
        _metric("direct_results_total", "counter",
                "Inline results delivered on direct channels").inc(n)


def record_direct_fallback(reason: str) -> None:
    """A call (or channel) fell back to the head-routed path."""
    global _ops
    _ops += 1
    _metric("direct_fallbacks_total", "counter",
            "Direct-path calls/channels that fell back to the head path",
            tag_keys=("reason",)).inc(tags={"reason": reason})


def record_result_forward(n: int) -> None:
    """Nested-submission result locations forwarded head->submitter."""
    global _ops
    _ops += 1
    if n > 0:
        _metric("nested_results_forwarded_total", "counter",
                "Result locations pushed head->submitting worker").inc(n)


# -- direct object transfer plane -------------------------------------------
# Per-process running count of in-flight direct object transfers (pulls
# this process is waiting on + pulls it is serving). Published as the
# `transfer_inflight` gauge so the worker METRICS_PUSH carries it to the
# head, where the scheduler's hybrid policy reads it back per node and
# stops co-scheduling onto saturated links.
_transfer_lock = threading.Lock()
_transfer_inflight = 0


def record_transfer_inflight(delta: int) -> None:
    global _ops, _transfer_inflight
    _ops += 1
    with _transfer_lock:
        _transfer_inflight = max(0, _transfer_inflight + int(delta))
        n = _transfer_inflight
    _metric("transfer_inflight", "gauge",
            "In-flight direct object transfers in this process").set(n)


def record_transfer_bytes(n: int) -> None:
    """Bytes moved worker->worker on the direct transfer plane."""
    global _ops
    _ops += 1
    if n > 0:
        _metric("direct_transfer_bytes_total", "counter",
                "Object bytes pulled over direct channels").inc(n)


# -- streaming shuffle exchange ----------------------------------------------
# Per-process shuffle-exchange gauges/counters (data/shuffle.py). They
# ride the same worker METRICS_PUSH as transfer_inflight, so the head's
# federated /metrics shows each exchange's shard flow per process: how
# many shard pulls a reducer has outstanding, the bytes it pulled per
# producer link, and how deep its un-merged backlog runs.
_shuffle_lock = threading.Lock()
_shuffle_shards_inflight = 0


def record_shuffle_shards_inflight(delta: int) -> None:
    """Shard pulls a shuffle reducer has scheduled but not landed."""
    global _ops, _shuffle_shards_inflight
    _ops += 1
    with _shuffle_lock:
        _shuffle_shards_inflight = max(
            0, _shuffle_shards_inflight + int(delta))
        n = _shuffle_shards_inflight
    _metric("shuffle_shards_inflight", "gauge",
            "In-flight shuffle shard pulls in this process").set(n)


def record_shuffle_bytes(n: int, link: str = "") -> None:
    """Shard bytes a reducer pulled, tagged by producer-node link."""
    global _ops
    _ops += 1
    if n > 0:
        _metric("shuffle_bytes_pulled_total", "counter",
                "Shuffle shard bytes pulled, by producer-node link",
                tag_keys=("link",)).inc(n, tags={"link": link or "local"})


def record_shuffle_merge_backlog(n: int) -> None:
    """Un-merged shard blocks buffered by a shuffle reducer."""
    global _ops
    _ops += 1
    _metric("shuffle_merge_backlog", "gauge",
            "Shard blocks a shuffle reducer holds un-merged").set(
                max(0, int(n)))


# -- serve plane ------------------------------------------------------------
# Request-path gauge writes are DEFERRED: the per-request hot path only
# touches a plain dict under one lock and marks the deployment dirty;
# the Metric objects sync at sample time (flush_serve_gauges — called
# by the head's scrape refresh and by the worker metrics push). Profiled
# on the serve bench: per-request tagged Metric.set calls were a
# measurable slice of a serve throughput regression.
_serve_inflight_lock = threading.Lock()
_serve_inflight: Dict[str, int] = {}
_serve_ongoing: Dict[str, float] = {}
_serve_qdepth: Dict[str, float] = {}
_serve_dirty: set = set()


def serve_inflight(deployment: str, delta: int) -> None:
    global _ops
    _ops += 1
    with _serve_inflight_lock:
        n = _serve_inflight.get(deployment, 0) + delta
        _serve_inflight[deployment] = max(n, 0)
        _serve_dirty.add(deployment)


def flush_serve_gauges() -> None:
    """Sync deferred serve gauges into the metric registry (sample
    time: head scrape refresh / worker METRICS_PUSH)."""
    global _ops
    _ops += 1
    with _serve_inflight_lock:
        if not _serve_dirty:
            return
        dirty = list(_serve_dirty)
        _serve_dirty.clear()
        inflight = {d: _serve_inflight.get(d) for d in dirty}
        ongoing = {d: _serve_ongoing.get(d) for d in dirty}
        qdepth = {d: _serve_qdepth.get(d) for d in dirty}
    for d in dirty:
        if inflight[d] is not None:
            _metric("serve_inflight_requests", "gauge",
                    "In-flight HTTP requests per deployment",
                    tag_keys=("deployment",)).set(
                        float(inflight[d]), tags={"deployment": d})
        if ongoing[d] is not None:
            _metric("serve_replica_ongoing_requests", "gauge",
                    "Requests currently executing in this replica",
                    tag_keys=("deployment",)).set(
                        float(ongoing[d]), tags={"deployment": d})
        if qdepth[d] is not None:
            _metric("serve_proxy_queue_depth", "gauge",
                    "Proxy-tracked in-flight requests across a "
                    "deployment's replicas (admission-control view)",
                    tag_keys=("deployment",)).set(
                        float(qdepth[d]), tags={"deployment": d})


# Per-deployment histogram HANDLES, resolved once and cached: the
# per-request path pays a dict probe + a sharded-bin observe instead of
# the full tag merge/validate/sort + single-lock observe (profiled on
# the serve bench: the two per-request latency histograms were the bulk
# of the remaining telemetry-on gap, docs/OBSERVABILITY.md).
_serve_hist_handles: Dict[Tuple[str, str], Any] = {}
_clear_hook_installed = False


def _serve_handle(name: str, desc: str, deployment: str):
    h = _serve_hist_handles.get((name, deployment))
    if h is None:
        global _clear_hook_installed
        from ..util import metrics as M
        if not _clear_hook_installed:
            # clear_registry() must invalidate this cache too, or the
            # handles keep feeding orphaned unregistered metrics.
            _clear_hook_installed = True
            M.on_clear_registry(_serve_hist_handles.clear)
        h = _metric(name, "histogram", desc,
                    tag_keys=("deployment",)).handle(
                        {"deployment": deployment})
        _serve_hist_handles[(name, deployment)] = h
    return h


def serve_request(deployment: str, dt: float) -> None:
    global _ops
    _ops += 1
    _serve_handle("serve_request_latency_s",
                  "End-to-end proxy request latency per deployment",
                  deployment).observe(max(dt, 1e-9))


def serve_replica_request(deployment: str, dt: float) -> None:
    global _ops
    _ops += 1
    _serve_handle("serve_replica_latency_s",
                  "Replica-side request handling latency per deployment",
                  deployment).observe(max(dt, 1e-9))


def serve_replica_ongoing(deployment: str, n: int) -> None:
    global _ops
    _ops += 1
    with _serve_inflight_lock:
        _serve_ongoing[deployment] = float(n)
        _serve_dirty.add(deployment)


def serve_direct_request(deployment: str) -> None:
    """One request dispatched on the direct serve data plane."""
    global _ops
    _ops += 1
    _metric("serve_direct_requests_total", "counter",
            "Serve requests shipped proxy->replica on direct channels",
            tag_keys=("deployment",)).inc(
                tags={"deployment": deployment})


def serve_queue_depth(deployment: str, depth: int) -> None:
    """Proxy-tracked in-flight depth across a deployment's replicas
    (deferred like the other serve gauges: hot path touches a dict,
    the Metric syncs at sample time)."""
    global _ops
    _ops += 1
    with _serve_inflight_lock:
        _serve_qdepth[deployment] = float(depth)
        _serve_dirty.add(deployment)


def serve_shed(deployment: str) -> None:
    """One request shed with 503: every replica's queue was at
    serve_max_queue_per_replica."""
    global _ops
    _ops += 1
    _metric("serve_shed_requests_total", "counter",
            "Requests shed 503 by proxy-side admission control",
            tag_keys=("deployment",)).inc(
                tags={"deployment": deployment})


# ---------------------------------------------------------------------------
# worker/daemon-side task event buffer
# ---------------------------------------------------------------------------
class TaskEventBuffer:
    """Bounded, drop-oldest buffer of task lifecycle events (reference:
    core_worker/task_event_buffer.h — bounded, periodically flushed,
    drops with an explicit counter rather than blocking the task loop).
    Thread-safe; record() is a deque append under a lock (no syscalls,
    no allocation beyond the event dict the caller built)."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            from .config import ray_config
            capacity = int(ray_config.task_event_buffer_size)
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque()
        self.dropped = 0  # total dropped since the last drain()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def record(self, **event) -> None:
        with self._lock:
            if len(self._events) >= self.capacity:
                self._events.popleft()
                self.dropped += 1
            self._events.append(event)

    def drain(self) -> Tuple[List[dict], int]:
        """Pop everything buffered; returns (events, dropped_since_last).
        Exact accounting: every record beyond capacity since the last
        drain is counted in `dropped` exactly once."""
        with self._lock:
            events = list(self._events)
            self._events.clear()
            dropped, self.dropped = self.dropped, 0
        return events, dropped


# ---------------------------------------------------------------------------
# head-side aggregator
# ---------------------------------------------------------------------------
_DEFAULT_JOB = "default"


class TelemetryStore:
    """GCS-side aggregate: bounded per-job rings of task events plus the
    latest metrics snapshot per node/worker (reference: GcsTaskManager's
    per-job ring buffers, gcs_task_manager.cc; the dashboard's metrics
    federation)."""

    def __init__(self, max_events_per_job: int = 10_000,
                 max_spans_total: Optional[int] = None,
                 max_spans_per_trace: Optional[int] = None):
        from .config import ray_config
        self.max_events_per_job = max(1, int(max_events_per_job))
        self.max_spans_total = int(
            max_spans_total if max_spans_total is not None
            else ray_config.max_spans)
        self.max_spans_per_trace = max(1, int(
            max_spans_per_trace if max_spans_per_trace is not None
            else ray_config.max_spans_per_trace))
        self._lock = threading.Lock()
        self._rings: Dict[str, collections.deque] = {}
        self._dropped: Dict[str, int] = {}
        # ("node"|"worker", key_hex) -> snapshot dict
        self._metrics: Dict[Tuple[str, str], dict] = {}
        # Tracing spans: bounded per-trace rings, LRU-ordered so the
        # global cap evicts the coldest trace whole (reference: the GCS
        # task manager's bounded per-job rings, applied to spans).
        self._traces: "collections.OrderedDict[str, collections.deque]" \
            = collections.OrderedDict()
        self._span_total = 0
        self._span_dropped: Dict[str, int] = {}
        # Exact counts for the drop/ingest accounting tests + /metrics.
        self.events_ingested = 0
        self.events_ingested_from_workers = 0
        self.worker_reported_dropped = 0
        self.spans_ingested = 0
        self.worker_reported_span_dropped = 0
        self.traces_evicted = 0
        self.spans_evicted = 0

    # -- task events ---------------------------------------------------
    def record_events(self, events, dropped: int = 0,
                      from_worker: bool = False) -> None:
        with self._lock:
            for ev in events:
                job = ev.get("job_id") or _DEFAULT_JOB
                ring = self._rings.get(job)
                if ring is None:
                    ring = collections.deque()
                    self._rings[job] = ring
                if len(ring) >= self.max_events_per_job:
                    ring.popleft()
                    self._dropped[job] = self._dropped.get(job, 0) + 1
                ring.append(ev)
                self.events_ingested += 1
                if from_worker:
                    self.events_ingested_from_workers += 1
            if dropped:
                self.worker_reported_dropped += int(dropped)

    def events(self, job_id: Optional[str] = None) -> List[dict]:
        with self._lock:
            if job_id is not None:
                return list(self._rings.get(job_id, ()))
            rings = [list(r) for r in self._rings.values()]
        if len(rings) == 1:
            return rings[0]
        out = [ev for ring in rings for ev in ring]
        out.sort(key=lambda ev: ev.get("ts", 0.0))
        return out

    def dropped_counts(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self._dropped)
        out["_worker_buffers"] = self.worker_reported_dropped
        return out

    # -- tracing spans -------------------------------------------------
    def record_spans(self, spans, dropped: int = 0,
                     node_id: Optional[str] = None,
                     worker_id: Optional[str] = None) -> None:
        """Ingest a drained span batch into bounded per-trace rings.
        ``node_id``/``worker_id`` stamp spans that don't carry them (the
        head knows the reporting connection; the worker hot path never
        builds those strings per span). Drop-oldest per trace with an
        exact counter; past the global cap the LRU trace evicts whole."""
        with self._lock:
            for s in spans:
                if not isinstance(s, dict):
                    continue
                if node_id and not s.get("node_id"):
                    s["node_id"] = node_id
                if worker_id and not s.get("worker_id"):
                    s["worker_id"] = worker_id
                t = s.get("trace_id") or "_untraced"
                ring = self._traces.get(t)
                if ring is None:
                    ring = self._traces[t] = collections.deque()
                self._traces.move_to_end(t)
                if len(ring) >= self.max_spans_per_trace:
                    ring.popleft()
                    self._span_dropped[t] = \
                        self._span_dropped.get(t, 0) + 1
                else:
                    self._span_total += 1
                ring.append(s)
                self.spans_ingested += 1
            while (self._span_total > self.max_spans_total
                   and len(self._traces) > 1):
                _t, old = self._traces.popitem(last=False)
                self._span_total -= len(old)
                # Exact span-unit accounting survives the eviction: the
                # evicted trace's resident spans AND its earlier ring
                # drops fold into the evicted-span counter.
                self.spans_evicted += len(old) + \
                    self._span_dropped.pop(_t, 0)
                self.traces_evicted += 1
            if dropped:
                self.worker_reported_span_dropped += int(dropped)

    def spans(self, trace_id: Optional[str] = None) -> List[dict]:
        with self._lock:
            if trace_id is not None:
                return list(self._traces.get(trace_id, ()))
            rings = [list(r) for r in self._traces.values()]
        out = [s for ring in rings for s in ring]
        out.sort(key=lambda s: s.get("start") or 0.0)
        return out

    def span_drop_counts(self) -> Dict[str, int]:
        """Span-unit drop counts (per live trace ring, worker buffers,
        evicted traces) — every value is a number of SPANS, so the
        summed gauge stays exact across whole-trace evictions."""
        with self._lock:
            out = dict(self._span_dropped)
        out["_worker_buffers"] = self.worker_reported_span_dropped
        out["_evicted"] = self.spans_evicted
        return out

    # -- metrics snapshots ---------------------------------------------
    def metrics_put(self, scope: str, node_id: Optional[str],
                    worker_id: Optional[str], groups: List[dict],
                    ts: Optional[float] = None) -> None:
        key = (scope, worker_id if scope == "worker" else (node_id or ""))
        with self._lock:
            self._metrics[key] = {
                "node_id": node_id, "worker_id": worker_id,
                "groups": groups, "ts": ts or time.time()}

    def metrics_snapshots(self, max_age_s: Optional[float] = None
                          ) -> List[dict]:
        now = time.time()
        with self._lock:
            snaps = list(self._metrics.values())
        if max_age_s is not None:
            snaps = [s for s in snaps if now - s["ts"] <= max_age_s]
        return snaps

    def forget_node(self, node_id_hex: str) -> None:
        """Drop a dead node's snapshots so /metrics stops re-exporting
        stale samples for it."""
        with self._lock:
            for key in [k for k, v in self._metrics.items()
                        if v.get("node_id") == node_id_hex]:
                self._metrics.pop(key, None)

    def forget_worker(self, worker_id_hex: str) -> None:
        """Drop a dead worker's snapshot — without this, worker churn
        (OOM kills, actor restarts) grows the store without bound and
        /metrics keeps exporting the dead replica's last gauges."""
        with self._lock:
            self._metrics.pop(("worker", worker_id_hex), None)


# ---------------------------------------------------------------------------
# federation / exposition
# ---------------------------------------------------------------------------
def _render_groups(tagged_groups) -> str:
    """One Prometheus text exposition from [(group, extra_tags)] where
    `group` is a util.metrics.registry_samples() entry. Samples of the
    same metric name from different sources merge under one HELP/TYPE
    header (required by the exposition format)."""
    order: List[str] = []
    merged: Dict[str, Tuple[str, str, List]] = {}
    for group, extra in tagged_groups:
        name = group.get("name")
        if not name:
            continue
        ent = merged.get(name)
        if ent is None:
            ent = (group.get("type", "untyped"), group.get("help", ""), [])
            merged[name] = ent
            order.append(name)
        for sample in group.get("samples", ()):
            try:
                sname, tags, value = sample
            except (TypeError, ValueError):
                continue
            t = dict(tags or {})
            t.update(extra)
            ent[2].append((sname, t, value))
    from ..util.metrics import format_sample
    lines: List[str] = []
    for name in order:
        mtype, mhelp, samples = merged[name]
        lines.append(f"# HELP {name} {mhelp}")
        lines.append(f"# TYPE {name} {mtype}")
        for sname, tags, value in samples:
            lines.append(format_sample(sname, tags, value))
    return "\n".join(lines) + "\n"


def _refresh_head_gauges(node) -> None:
    """Point-in-time head gauges set at exposition time — zero hot-path
    cost: nothing is tracked continuously, the values are read off the
    live runtime when someone actually scrapes."""
    try:
        flush_serve_gauges()  # deferred serve request-path gauges
    except Exception:  # lint: broad-except-ok scrape-time gauge on a live runtime mid-teardown; exposition must not 500
        logger.debug("serve gauge flush failed", exc_info=True)
    try:
        record_queue_depth(node.scheduler.queue_depth())
    except Exception:  # lint: broad-except-ok scrape-time gauge on a live runtime mid-teardown; exposition must not 500
        logger.debug("queue-depth gauge refresh failed", exc_info=True)
    try:
        record_node_stats(
            int(getattr(node.store, "used_bytes", 0) or 0),
            len(node.pool.workers),
            len(getattr(node.scheduler, "_free_gpus", ())))
        record_pool_reclaimed(
            node.node_id.hex(),
            int(getattr(node.store, "pool_reclaimed_bytes", 0)))
    except Exception:  # lint: broad-except-ok scrape-time gauge on a live runtime mid-teardown; exposition must not 500
        logger.debug("node-stats gauge refresh failed", exc_info=True)
    try:
        tstore = node.gcs.telemetry
        _metric("task_events_ingested_total_gauge", "gauge",
                "Task lifecycle events aggregated on the head"
                ).set(tstore.events_ingested)
        _metric("task_events_dropped", "gauge",
                "Task events dropped across rings and worker buffers"
                ).set(sum(tstore.dropped_counts().values()))
        if tstore.spans_ingested:
            _metric("trace_spans_ingested_total_gauge", "gauge",
                    "Tracing spans aggregated on the head"
                    ).set(tstore.spans_ingested)
            _metric("trace_spans_dropped", "gauge",
                    "Spans dropped across trace rings and process buffers"
                    ).set(sum(tstore.span_drop_counts().values()))
    except Exception:  # lint: broad-except-ok scrape-time gauge on a live runtime mid-teardown; exposition must not 500
        logger.debug("task-event gauge refresh failed", exc_info=True)
    _refresh_head_self_gauges(node)


def _refresh_head_self_gauges(node) -> None:
    """Head SELF-instrumentation, read point-in-time at exposition
    (the measurement contract for ROADMAP item 2's virtual-scale
    harness): per-message-type ingest counters, routing-loop queue
    depths, handler-pool utilization, outbound writer queue bytes.
    Everything here reads live structures at scrape time — the only
    hot-path cost is the per-frame count_msg/count_msgs bump."""
    if _msg_counts:
        m = _metric("head_ingest_messages", "gauge",
                    "Control messages ingested by the head since "
                    "start, by type", tag_keys=("msg_type",))
        for t, n in list(_msg_counts.items()):
            m.set(float(n), tags={"msg_type": t})
    writer_bytes = 0
    try:
        depth_m = _metric("head_loop_queue_depth", "gauge",
                          "Queued messages per head routing loop",
                          tag_keys=("loop",))
        for d in node.head_server.all_daemons():
            depth_m.set(float(d._route_exec.qsize()),
                        tags={"loop": f"daemon-route-"
                              f"{d.node_id_hex[:8]}"})
            writer_bytes += int(d._writer.queued_bytes())
    except Exception:  # lint: broad-except-ok daemons may tear down mid-scrape; exposition must not 500
        logger.debug("loop-depth gauge refresh failed", exc_info=True)
    try:
        mux = getattr(node.pool, "_mux", None)
        backlog = getattr(mux, "backlog_bytes", None)
        if backlog is not None:
            _metric("head_recv_mux_backlog_bytes", "gauge",
                    "Bytes buffered mid-frame in the worker recv mux"
                    ).set(float(backlog()))
    except Exception:  # lint: broad-except-ok mux may be native/absent; exposition must not 500
        logger.debug("recv-mux gauge refresh failed", exc_info=True)
    try:
        pool = node._handler_pool
        _metric("head_handler_pool_queue_depth", "gauge",
                "Blocking-request items queued for the handler pool"
                ).set(float(pool._work_queue.qsize()))
        nthreads = len(pool._threads)
        idle = getattr(pool._idle_semaphore, "_value", 0)
        _metric("head_handler_pool_active", "gauge",
                "Handler-pool threads currently executing a request"
                ).set(float(max(0, nthreads - idle)))
    except Exception:  # lint: broad-except-ok stdlib executor internals; exposition must not 500
        logger.debug("handler-pool gauge refresh failed", exc_info=True)
    _metric("head_writer_queue_bytes", "gauge",
            "Bytes queued on the head's outbound connection writers"
            ).set(float(writer_bytes))
    try:
        stats = node.head_server.loop_stats()
    except Exception:  # lint: broad-except-ok head server may be absent/tearing down mid-scrape; exposition must not 500
        stats = []
        logger.debug("event-loop gauge refresh failed", exc_info=True)
    if stats:
        fds_m = _metric("head_loop_fds", "gauge",
                        "Daemon connections registered per head "
                        "control-plane event loop", tag_keys=("loop",))
        lag_m = _metric("head_loop_iter_lag_s", "gauge",
                        "Seconds the last dispatch pass of each head "
                        "event loop spent off select()",
                        tag_keys=("loop",))
        wake_m = _metric("head_loop_wakeups_total", "gauge",
                         "select() returns per head event loop since "
                         "start (with the iteration counter this "
                         "yields wakeups/s)", tag_keys=("loop",))
        backlog_m = _metric("head_loop_backlog_bytes", "gauge",
                            "Bytes buffered mid-frame per head event "
                            "loop", tag_keys=("loop",))
        for st in stats:
            tags = {"loop": st["name"]}
            fds_m.set(float(st["fds"]), tags=tags)
            lag_m.set(float(st["last_iter_s"]), tags=tags)
            wake_m.set(float(st["wakeups"]), tags=tags)
            backlog_m.set(float(st["backlog_bytes"]), tags=tags)


def federated_prometheus_text(node) -> str:
    """The cluster-wide exposition: the head's process-local registry
    tagged with the head's node id, merged with the latest snapshot
    pushed by every daemon (NODE_PING) and worker (METRICS_PUSH)."""
    from ..util import metrics as M
    if not enabled:
        return M.prometheus_text()
    _refresh_head_gauges(node)
    head_hex = node.node_id.hex()
    tagged = [(g, {"node_id": head_hex}) for g in M.registry_samples()]
    for snap in node.gcs.telemetry.metrics_snapshots():
        extra = {}
        if snap.get("node_id"):
            extra["node_id"] = snap["node_id"]
        if snap.get("worker_id"):
            extra["worker_id"] = snap["worker_id"]
        tagged.extend((g, extra) for g in snap.get("groups", ()))
    return _render_groups(tagged)


def cluster_metrics_text() -> str:
    """Entry point for the dashboard /metrics and the CLI: federated
    when this process hosts the head runtime, process-local otherwise."""
    from . import state as _state
    node = _state.get_node()
    if node is None or not hasattr(node, "gcs"):
        from ..util.metrics import prometheus_text
        return prometheus_text()
    return federated_prometheus_text(node)


__all__ = ["TaskEventBuffer", "TelemetryStore", "cluster_metrics_text",
           "configure", "enabled", "federated_prometheus_text",
           "instrument_ops"]
