"""Cluster-on-Spark launcher surface (reference: python/ray/util/spark/
— setup_ray_cluster/shutdown_ray_cluster run Ray nodes inside Spark
executors via a barrier-mode job, cluster_init.py).

Spark-hosted provisioning is a cloud-integration concern out of the
single-host runtime's scope; the surface exists so callers get a clear
error (and the autoscaler's provider plugin API —
autoscaler/node_provider.py — is the supported path for custom
provisioning)."""

from typing import Any

__all__ = ["setup_ray_cluster", "shutdown_ray_cluster"]


def setup_ray_cluster(*args: Any, **kwargs: Any):
    try:
        import pyspark  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "ray_tpu_torch.util.spark requires `pyspark` to be installed."
        ) from e
    raise NotImplementedError(
        "Spark-hosted clusters are not implemented in this build; "
        "implement a NodeProvider (ray_tpu_torch.autoscaler.node_provider) "
        "that launches hosts via your Spark deployment instead.")


def shutdown_ray_cluster():
    raise NotImplementedError(
        "Spark-hosted clusters are not implemented in this build.")
