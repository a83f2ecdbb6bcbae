"""Dashboard-equivalent: REST API + Prometheus metrics + minimal UI.

Reference parity: python/ray/dashboard/ (DashboardHead head.py:65 with
REST modules over GCS state — SURVEY.md §2.2). The React client is
explicitly out of idiomatic scope (SURVEY.md §7 end); this serves the
same observability data as JSON endpoints, a Prometheus text endpoint,
and a single self-contained HTML status page.

Endpoints (all GET):
  /api/cluster_status   resources total/available, node count
  /api/nodes            state list_nodes
  /api/actors           state list_actors
  /api/tasks            state list_tasks
  /api/objects          state list_objects
  /api/placement_groups state list_placement_groups
  /api/jobs             job submission KV listing
  /api/summary/tasks    state summarize_tasks
  /api/timeline         Chrome-trace JSON (load in perfetto)
  /metrics              Prometheus text exposition
  /                     HTML status page
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, Optional

_server = None

_INDEX_HTML = """<!doctype html>
<html><head><title>ray_tpu_torch dashboard</title>
<style>
body { font-family: system-ui, sans-serif; margin: 2rem; color: #222; }
h1 { font-size: 1.3rem; } h2 { font-size: 1.05rem; margin-top: 1.5rem; }
table { border-collapse: collapse; margin-top: .5rem; }
td, th { border: 1px solid #ccc; padding: .25rem .6rem; font-size: .85rem;
         text-align: left; }
code { background: #f4f4f4; padding: 0 .3em; }
</style></head><body>
<h1>ray_tpu_torch dashboard</h1>
<div id="status"></div>
<h2>Nodes</h2><table id="nodes"></table>
<h2>Actors</h2><table id="actors"></table>
<h2>Recent tasks</h2><table id="tasks"></table>
<p>Endpoints: <code>/api/cluster_status</code> <code>/api/nodes</code>
<code>/api/actors</code> <code>/api/tasks</code> <code>/api/objects</code>
<code>/api/placement_groups</code> <code>/api/jobs</code>
<code>/api/timeline</code> <code>/metrics</code></p>
<script>
function fillTable(id, rows) {
  const t = document.getElementById(id);
  if (!rows.length) { t.innerHTML = "<tr><td>(none)</td></tr>"; return; }
  const cols = Object.keys(rows[0]);
  t.innerHTML = "<tr>" + cols.map(c => `<th>${c}</th>`).join("") + "</tr>" +
    rows.map(r => "<tr>" + cols.map(c => `<td>${r[c]}</td>`).join("") +
    "</tr>").join("");
}
async function refresh() {
  const s = await (await fetch("/api/cluster_status")).json();
  document.getElementById("status").innerText =
    JSON.stringify(s.resources_available) + " available of " +
    JSON.stringify(s.resources_total);
  fillTable("nodes", await (await fetch("/api/nodes")).json());
  fillTable("actors", await (await fetch("/api/actors")).json());
  fillTable("tasks", (await (await fetch("/api/tasks")).json()).slice(-25));
}
refresh(); setInterval(refresh, 3000);
</script></body></html>"""


def _routes() -> Dict[str, Any]:
    from .. import api
    from ..util import state as state_api

    def jobs():
        from .._private import state as _state
        from ..job import _KV_NS
        rows = []
        rt = _state.current()
        for key in rt.gcs_request("kv_keys", namespace=_KV_NS):
            raw = rt.gcs_request("kv_get", key=key, namespace=_KV_NS)
            if raw is not None:
                try:
                    rows.append(json.loads(raw))
                except (ValueError, TypeError):
                    pass
        return rows

    return {
        "/api/cluster_status": lambda: {
            "resources_total": api.cluster_resources(),
            "resources_available": api.available_resources(),
            "nodes": len([n for n in state_api.list_nodes()
                          if n.get("alive", True)]),
        },
        "/api/nodes": state_api.list_nodes,
        "/api/actors": state_api.list_actors,
        "/api/tasks": state_api.list_tasks,
        "/api/objects": state_api.list_objects,
        "/api/placement_groups": state_api.list_placement_groups,
        "/api/summary/tasks": state_api.summarize_tasks,
        "/api/timeline": state_api.timeline,
        "/api/jobs": jobs,
        # reference dashboard modules: healthz, reporter (node stats),
        # serve, log — collapsed to JSON routes.
        "/api/healthz": lambda: {"status": "ok"},
        "/api/usage": _usage_record,
        "/api/object_store": _object_store_stats,
        "/api/memory": _memory_stats,
        "/api/serve": _serve_status,
        "/api/logs": _log_files,
    }


def _usage_record():
    from .._private.usage import build_usage_record
    return build_usage_record()


def _object_store_stats():
    from .._private import state as _state
    store = _state.current().store
    stats = getattr(store, "stats", None)
    return stats() if stats else {}


def _memory_stats():
    from .._private import state as _state
    from .._private.memory_monitor import system_memory_fraction
    node = _state.current()
    mon = getattr(node, "memory_monitor", None)
    return {"system_memory_fraction": system_memory_fraction(),
            "last_sampled_fraction": getattr(mon, "last_fraction", None)}


def _serve_status():
    try:
        from .. import serve
        return serve.status()
    except Exception:
        return {}


def _log_files():
    import os

    from .._private import state as _state
    logs_dir = os.path.join(_state.current().session_dir, "logs")
    if not os.path.isdir(logs_dir):
        return []
    return [{"file": f, "bytes": os.path.getsize(
        os.path.join(logs_dir, f))} for f in sorted(os.listdir(logs_dir))]


def start_dashboard(host: str = "127.0.0.1", port: int = 0) -> int:
    """Start the dashboard HTTP server; returns the bound port.
    (reference: DashboardHead, dashboard/head.py:65 — collapsed to one
    in-process thread since the GCS-equivalent lives in this process)."""
    global _server
    if _server is not None:
        return _server.server_address[1]
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    routes = _routes()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, body: bytes, ctype: str, code: int = 200):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?", 1)[0].rstrip("/") or "/"
            try:
                if path == "/":
                    self._send(_INDEX_HTML.encode(), "text/html")
                elif path == "/metrics":
                    # Federated exposition: this process's registry plus
                    # the latest snapshot from every node daemon and
                    # worker, node_id/worker_id-tagged (telemetry.py).
                    from .._private.telemetry import cluster_metrics_text
                    self._send(cluster_metrics_text().encode(),
                               "text/plain; version=0.0.4")
                elif path in routes:
                    body = json.dumps(routes[path](), default=str)
                    self._send(body.encode(), "application/json")
                else:
                    self._send(b'{"error": "not found"}',
                               "application/json", 404)
            except Exception as e:  # noqa: BLE001 — surface as 500 JSON
                self._send(json.dumps({"error": repr(e)}).encode(),
                           "application/json", 500)

    _server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=_server.serve_forever, daemon=True,
                     name="dashboard").start()
    return _server.server_address[1]


def stop_dashboard():
    global _server
    if _server is not None:
        _server.shutdown()
        _server.server_close()
        _server = None
