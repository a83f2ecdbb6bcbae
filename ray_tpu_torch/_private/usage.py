"""Local usage report built from the telemetry aggregator (reference:
_private/usage/usage_lib.py — usage reporting; SURVEY.md §2.2).

Opt-IN and strictly local: the reference phones home by default; this
build NEVER transmits (zero-egress environments are the norm for GPU
clusters). When ``usage_stats_enabled`` is set (default off), ``record_usage``
writes the report as ``usage_report.json`` into the session directory —
and nowhere else. The record is built from the same cluster-wide
telemetry plane the state API reads: cluster size from the node
registry, task counts from the aggregated lifecycle events, plus which
ray_tpu_torch libraries the driver actually imported.
"""

from __future__ import annotations

import json
import os
import platform
import sys
import time
from typing import Any, Dict

from .config import ray_config

_KV_NS = "usage_stats"
_REPORT_NAME = "usage_report.json"
_LIBRARIES = ("air", "dag", "data", "experimental", "job", "llm",
              "rllib", "serve", "train", "tune", "workflow")


def usage_stats_enabled() -> bool:
    return bool(ray_config.usage_stats_enabled)


def _library_imports() -> list:
    """ray_tpu_torch sub-libraries imported in THIS process (reference:
    usage_lib's library usage tags, minus the network)."""
    return [lib for lib in _LIBRARIES
            if f"ray_tpu_torch.{lib}" in sys.modules]


def build_usage_record() -> Dict[str, Any]:
    from .. import __version__

    record: Dict[str, Any] = {
        "schema_version": "0.2",
        "source": "ray_tpu_torch",
        "version": __version__,
        "python_version": platform.python_version(),
        "os": platform.system().lower(),
        "collected_at": time.time(),
        "libraries": _library_imports(),
    }
    try:
        from . import state

        rt = state.current_or_none()
        if rt is None:
            return record
        record["total_resources"] = rt.cluster_resources()
        # One reduction, owned by the state API: list_tasks' latest-
        # state-per-task rows back the counts here too, so the usage
        # report can never disagree with state.list_tasks().
        from ..util import state as state_api
        record["cluster_size"] = sum(
            1 for n in state_api.list_nodes() if n.get("alive", True))
        counts: Dict[str, int] = {}
        rows = state_api.list_tasks(limit=100_000)
        for row in rows:
            st = row.get("state") or "?"
            counts[st] = counts.get(st, 0) + 1
        record["task_state_counts"] = counts
        record["num_tasks_seen"] = len(rows)
        record["telemetry_dropped"] = rt.gcs_request("telemetry_dropped")
    except Exception:  # lint: broad-except-ok usage enrichment probes a live cluster that may be mid-teardown; the base record still returns
        pass
    return record


def record_usage() -> Dict[str, Any]:
    """Build the record and — only when the opt-in flag is set — write
    it to ``<session_dir>/usage_report.json``. Never the network."""
    record = build_usage_record()
    if not usage_stats_enabled():
        return record
    try:
        from . import state

        rt = state.current_or_none()
        session_dir = getattr(rt, "session_dir", None)
        if session_dir and os.path.isdir(session_dir):
            tmp = os.path.join(session_dir, _REPORT_NAME + ".tmp")
            with open(tmp, "w") as f:
                json.dump(record, f, indent=2, sort_keys=True)
            os.replace(tmp, os.path.join(session_dir, _REPORT_NAME))
        # Mirror into the internal KV so remote drivers / the dashboard
        # can read the last report without filesystem access.
        if rt is not None:
            rt.gcs_request("kv_put", key="latest",
                           value=json.dumps(record).encode(),
                           namespace=_KV_NS)
    except Exception:  # lint: broad-except-ok opt-in local report write; telemetry never breaks the runtime
        pass
    return record
