"""Workflow events: durable external triggers.

Reference parity: python/ray/workflow/event_listener.py (EventListener +
TimerListener) and http_event_provider.py (HTTPEventProvider — an HTTP
endpoint external systems POST events to; workflows block on
`workflow.wait_for_event(...)` steps until the event arrives, and the
received payload checkpoints like any step result, so a resumed workflow
does not re-wait for an event it already consumed).

Events are files under `<storage>/_events/<key>.json` — same durability
story as step results. `deliver_event` writes one directly (in-process
producers); `HTTPEventProvider` accepts `POST /event/<key>` with a JSON
body (external producers).
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional


def _events_dir() -> str:
    from . import _storage
    d = os.path.join(_storage(), "_events")
    os.makedirs(d, exist_ok=True)
    return d


def _event_path(key: str) -> str:
    safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in key)
    return os.path.join(_events_dir(), f"{safe}.json")


def deliver_event(key: str, payload: Any = None) -> None:
    """Make the event `key` available (reference: the provider's POST
    handler resolving pending listeners)."""
    tmp = _event_path(key) + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"payload": payload, "delivered_at": time.time()}, f)
    os.replace(tmp, _event_path(key))


class EventListener:
    """Reference: workflow/event_listener.py EventListener — subclass and
    implement poll_for_event; instances are created fresh inside the
    waiting task."""

    def poll_for_event(self, *args, **kwargs) -> Any:
        raise NotImplementedError


class TimerListener(EventListener):
    """Reference: workflow/event_listener.py TimerListener."""

    def poll_for_event(self, seconds: float) -> float:
        time.sleep(float(seconds))
        return time.time()


class FileEventListener(EventListener):
    """Poll the durable event store for `key` (the listener side of
    HTTPEventProvider / deliver_event)."""

    def __init__(self, poll_interval_s: float = 0.1,
                 timeout_s: Optional[float] = None):
        self.poll_interval_s = poll_interval_s
        self.timeout_s = timeout_s

    def poll_for_event(self, key: str) -> Any:
        deadline = (time.monotonic() + self.timeout_s
                    if self.timeout_s is not None else None)
        path = _event_path(key)
        while True:
            try:
                with open(path) as f:
                    return json.load(f)["payload"]
            except FileNotFoundError:
                pass
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"event {key!r} not delivered within "
                                   f"{self.timeout_s}s")
            time.sleep(self.poll_interval_s)


def wait_for_event(listener_cls=FileEventListener, *args,
                   **listener_kwargs):
    """Build a workflow step that blocks until the listener fires
    (reference: workflow/api.py wait_for_event). The returned DAG node
    composes with other nodes; the event payload is the step's
    (checkpointed) result."""
    import cloudpickle

    import ray_tpu_torch
    from . import _storage
    listener_blob = cloudpickle.dumps((listener_cls, listener_kwargs))
    storage_root = _storage()

    @ray_tpu_torch.remote
    def wait_for_event_step(*poll_args):
        from ray_tpu_torch import workflow as wf
        wf.init(storage_root)
        cls, kw = cloudpickle.loads(listener_blob)
        return cls(**kw).poll_for_event(*poll_args)

    return wait_for_event_step.bind(*args)


class _Handler(BaseHTTPRequestHandler):
    def do_POST(self):  # noqa: N802 (stdlib naming)
        if not self.path.startswith("/event/"):
            self.send_error(404)
            return
        key = self.path[len("/event/"):]
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length) if length else b"null"
        try:
            payload = json.loads(body)
        except json.JSONDecodeError:
            self.send_error(400, "body must be JSON")
            return
        deliver_event(key, payload)
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        self.wfile.write(b'{"status": "ok"}')

    def log_message(self, *a):  # quiet
        pass


class HTTPEventProvider:
    """Reference: workflow/http_event_provider.py — an HTTP endpoint
    (`POST /event/<key>`, JSON body) that resolves waiting workflow
    steps. Runs a daemon-thread server; port 0 picks a free port."""

    def __init__(self, port: int = 0):
        self._server = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HTTPEventProvider":
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="wf_event_http",
            daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2)
