"""Named API operations callable locally or through the client server.

Reference parity: the Ray Client server proxies `ray.*` and state/job
API calls for remote drivers (util/client/server/server.py
RayletServicer); this registry is the whitelist of proxied operations —
the CLI uses the same names against either a local runtime or a remote
head (`--address`), so `python -m ray_tpu_torch status` reflects the
actual cluster it points at.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


def registry() -> Dict[str, Callable[..., Any]]:
    import ray_tpu_torch
    from ray_tpu_torch.job import JobSubmissionClient
    from ray_tpu_torch.util import state

    def job_client() -> JobSubmissionClient:
        return JobSubmissionClient()

    return {
        "cluster_resources": ray_tpu_torch.cluster_resources,
        "available_resources": ray_tpu_torch.available_resources,
        "list_nodes": state.list_nodes,
        "list_tasks": state.list_tasks,
        "list_actors": state.list_actors,
        "list_objects": state.list_objects,
        "list_workers": state.list_workers,
        "list_placement_groups": state.list_placement_groups,
        # Graceful drain (docs/DRAIN.md): runs ON the head — the CLI can
        # fire-and-poll a drain against a remote cluster.
        "drain_node": state.drain_node,
        "drain_status": state.drain_status,
        "summarize_tasks": state.summarize_tasks,
        "summarize_actors": state.summarize_actors,
        "summarize_objects": state.summarize_objects,
        "timeline": lambda: state.timeline(filename=None),
        "cluster_metrics": _cluster_metrics,
        # Tracing consumers (PR 7): cross-node trace tree + the merged
        # chrome export, served from the head's span store.
        "get_trace": _get_trace,
        "export_chrome_trace": _export_chrome_trace,
        "job_submit": lambda **kw: job_client().submit_job(**kw),
        "job_status": lambda job_id: job_client().get_job_status(job_id),
        "job_logs": lambda job_id: job_client().get_job_logs(job_id),
        "job_list": lambda: job_client().list_jobs(),
        "job_stop": lambda job_id: job_client().stop_job(job_id),
        # Serve control plane (reference: serve CLI → controller REST):
        # deploy runs ON the head, so apps outlive the CLI process.
        "serve_deploy": _serve_deploy,
        "serve_status": _serve_status,
        "serve_shutdown": _serve_shutdown,
    }


def _get_trace(trace_id: str) -> dict:
    from ray_tpu_torch.util import tracing
    return tracing.get_trace(trace_id)


def _export_chrome_trace(trace_id=None) -> list:
    from ray_tpu_torch.util import tracing
    return tracing.export_chrome_trace(filename=None, trace_id=trace_id)


def _cluster_metrics() -> str:
    """Federated Prometheus text (telemetry.py): head registry + every
    node's / worker's latest pushed snapshot, node/worker tagged."""
    from ray_tpu_torch._private.telemetry import cluster_metrics_text
    return cluster_metrics_text()


def _serve_deploy(config: dict):
    from ray_tpu_torch.serve import schema as serve_schema
    return serve_schema.deploy_config(
        serve_schema.ServeDeploySchema.from_dict(config))


def _serve_status():
    from ray_tpu_torch import serve
    return serve.status()


def _serve_shutdown():
    from ray_tpu_torch import serve
    serve.shutdown()
    return True
