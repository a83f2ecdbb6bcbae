"""Kubernetes/GKE node provider: pods over kubectl.

Reference parity: the kuberay autoscaler path
(python/ray/autoscaler/_private/kuberay/node_provider.py — a
NodeProvider speaking to the Kubernetes API to create/delete worker
pods). A "node" here is one POD scheduled onto a GPU node pool: the
``nvidia.com/gpu`` resource (the NVIDIA device plugin's) for its cards,
and GKE's ``cloud.google.com/gke-accelerator`` node selector (e.g.
``nvidia-h100-80gb``) for their kind. GPU node pools have no topology
selector, so the JAX package's TPU keys (``tpu_chips_per_host``,
``tpu_accelerator``, ``tpu_topology``) raise, naming the GPU key.

All cluster interaction goes through `kubectl` via an injectable
`runner` callable (argv list, optional stdin text -> stdout string), so
the provisioning logic is fully testable with a fake runner (the image
has no cluster access) — the same seam as
gcp_gpu_provider.GcpGpuInstanceProvider.
"""

from __future__ import annotations

import json
import shutil
import uuid
from typing import Any, Callable, Dict, List, Optional

from .node_provider import (NodeProvider, STATUS_PENDING, STATUS_RUNNING,
                            STATUS_TERMINATED, TAG_NODE_TYPE)

_LABEL_PREFIX = "ray.io/"
_CLUSTER_LABEL = "ray.io/cluster"

GPU_RESOURCE = "nvidia.com/gpu"
GPU_SELECTOR = "cloud.google.com/gke-accelerator"
# The JAX package's TPU keys -> what a GPU pod is given instead.
_TPU_KEYS = {
    "tpu_chips_per_host": "gpus_per_host",
    "tpu_accelerator": "gpu_accelerator",
    "tpu_topology": "gpus_per_host (GPU node pools have no topology "
                    "selector)",
}


def _check_gpu_keys(cfg: Dict[str, Any]) -> None:
    for key, gpu_key in _TPU_KEYS.items():
        if key in cfg:
            raise ValueError(
                f"{key!r}: ray_tpu_torch provisions GPU pods; use "
                f"{gpu_key} instead")


_PHASE_MAP = {
    "Pending": STATUS_PENDING,
    "Running": STATUS_RUNNING,
    "Succeeded": STATUS_TERMINATED,
    "Failed": STATUS_TERMINATED,
    "Unknown": STATUS_PENDING,
}


def _default_runner(argv: List[str],
                    stdin_text: Optional[str] = None) -> str:
    import subprocess
    if shutil.which(argv[0]) is None:
        raise RuntimeError(
            f"{argv[0]} is not installed; KubernetesNodeProvider needs "
            "kubectl (or pass a custom runner=).")
    # Bounded: a hung API server must stall one call, not wedge the
    # autoscaler's reconcile loop forever.
    return subprocess.run(argv, input=stdin_text, capture_output=True,
                          text=True, check=True, timeout=60).stdout


class KubernetesNodeProvider(NodeProvider):
    """Worker pods on a Kubernetes cluster (reference: kuberay's
    node provider).

    provider_config keys:
      namespace: k8s namespace (default "default")
      image: container image for worker pods
      head_address: `python -m ray_tpu_torch.scripts.cli start
        --address=` target injected into the pod command (the pod's
        cluster token goes in through pod_overrides, as
        RTT_CLUSTER_TOKEN_HEX in the container's env)
      gpus_per_host: the pod's ``nvidia.com/gpu`` limit
      gpu_accelerator: GKE GPU node-pool selector
        (``cloud.google.com/gke-accelerator``)
      pod_overrides: dict merged into the generated pod spec
    """

    def __init__(self, provider_config: Dict[str, Any],
                 cluster_name: str = "default",
                 runner: Optional[Callable] = None):
        _check_gpu_keys(provider_config)
        super().__init__(provider_config, cluster_name)
        self._run = runner or _default_runner
        self.namespace = provider_config.get("namespace", "default")
        self.image = provider_config.get("image", "ray-tpu-torch:latest")
        # Pod-list micro-cache: one reconcile pass queries
        # is_running/node_tags/internal_ip per instance — without the
        # cache that is O(instances) kubectl subprocess round-trips
        # per pass, inside the InstanceManager lock.
        self._pods_cache: Optional[List[Dict[str, Any]]] = None
        self._pods_cache_t = 0.0
        self.pods_cache_ttl_s = float(
            provider_config.get("pods_cache_ttl_s", 2.0))

    # -- kubectl plumbing --------------------------------------------------
    def _kubectl(self, args: List[str],
                 stdin_text: Optional[str] = None) -> str:
        return self._run(["kubectl", "-n", self.namespace] + args,
                         stdin_text)

    def _pods(self) -> List[Dict[str, Any]]:
        import time
        now = time.monotonic()
        if (self._pods_cache is not None
                and now - self._pods_cache_t < self.pods_cache_ttl_s):
            return self._pods_cache
        raw = self._kubectl([
            "get", "pods", "-l", f"{_CLUSTER_LABEL}={self.cluster_name}",
            "-o", "json"])
        self._pods_cache = json.loads(raw or "{}").get("items", [])
        self._pods_cache_t = now
        return self._pods_cache

    def _invalidate_pods(self):
        self._pods_cache = None

    # -- NodeProvider surface ---------------------------------------------
    def non_terminated_nodes(self, tag_filters: Optional[Dict] = None
                             ) -> List[str]:
        out = []
        for pod in self._pods():
            phase = pod.get("status", {}).get("phase", "Pending")
            if _PHASE_MAP.get(phase, STATUS_PENDING) == STATUS_TERMINATED:
                continue
            tags = self._tags_of(pod)
            if tag_filters and any(tags.get(k) != v
                                   for k, v in tag_filters.items()):
                continue
            out.append(pod["metadata"]["name"])
        return out

    def is_running(self, node_id: str) -> bool:
        for pod in self._pods():
            if pod["metadata"]["name"] == node_id:
                return pod.get("status", {}).get("phase") == "Running"
        return False

    def node_tags(self, node_id: str) -> Dict[str, str]:
        for pod in self._pods():
            if pod["metadata"]["name"] == node_id:
                return self._tags_of(pod)
        return {}

    def internal_ip(self, node_id: str) -> Optional[str]:
        for pod in self._pods():
            if pod["metadata"]["name"] == node_id:
                return pod.get("status", {}).get("podIP")
        return None

    def create_node(self, node_config: Dict[str, Any],
                    tags: Dict[str, str], count: int) -> List[str]:
        created = []
        for _ in range(count):
            name = f"{self.cluster_name}-worker-{uuid.uuid4().hex[:8]}"
            manifest = self._pod_manifest(name, node_config, tags)
            self._kubectl(["create", "-f", "-"],
                          stdin_text=json.dumps(manifest))
            created.append(name)
        self._invalidate_pods()
        return created

    def terminate_node(self, node_id: str):
        self._kubectl(["delete", "pod", node_id, "--wait=false"])
        self._invalidate_pods()

    # -- manifest ----------------------------------------------------------
    def _tags_of(self, pod: Dict[str, Any]) -> Dict[str, str]:
        labels = pod.get("metadata", {}).get("labels", {}) or {}
        return {k[len(_LABEL_PREFIX):]: v for k, v in labels.items()
                if k.startswith(_LABEL_PREFIX)
                and k != _CLUSTER_LABEL}

    def _pod_manifest(self, name: str, node_config: Dict[str, Any],
                      tags: Dict[str, str]) -> Dict[str, Any]:
        _check_gpu_keys(node_config or {})
        cfg = dict(self.provider_config)
        cfg.update(node_config or {})
        labels = {_CLUSTER_LABEL: self.cluster_name}
        labels.update({f"{_LABEL_PREFIX}{k}": str(v)
                       for k, v in (tags or {}).items()})
        resources: Dict[str, Any] = dict(cfg.get("resources") or {})
        gpus = cfg.get("gpus_per_host", 0)
        if gpus:
            resources[GPU_RESOURCE] = str(gpus)
        limits = {k: str(v) for k, v in resources.items()}
        node_selector: Dict[str, str] = dict(
            cfg.get("node_selector") or {})
        if cfg.get("gpu_accelerator"):
            # GKE GPU node-pool targeting (how a pod lands on its cards).
            node_selector[GPU_SELECTOR] = cfg["gpu_accelerator"]
        command = cfg.get("command") or [
            "python", "-m", "ray_tpu_torch.scripts.cli", "start",
            f"--address={cfg.get('head_address', 'auto')}"]
        pod = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {"name": name, "labels": labels},
            "spec": {
                "restartPolicy": "Never",
                "nodeSelector": node_selector,
                "containers": [{
                    "name": "ray-worker",
                    "image": cfg.get("image", self.image),
                    "command": command,
                    "resources": {"limits": limits,
                                  "requests": limits},
                }],
            },
        }
        overrides = cfg.get("pod_overrides")
        if overrides:
            _deep_merge(pod, overrides)
        return pod


def _deep_merge(dst: Dict, src: Dict) -> Dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v
    return dst


class NodeProviderInstanceAdapter:
    """Bridge a v1 NodeProvider into autoscaler v2's InstanceManager
    (reference: v2 instance_manager/cloud_providers wrapping node
    providers). allocate -> create_node; an instance becomes
    RAY_RUNNING once its pod is Running AND the daemon the pod boots
    has registered with the head (correlated by hostname — a pod's
    hostname IS its name). `daemon_lookup` is injectable so fake-runner
    tests can supply the correlation."""

    def __init__(self, provider: NodeProvider,
                 daemon_lookup: Optional[Callable[[str],
                                                  Optional[str]]] = None):
        self.provider = provider
        self._daemon_lookup = daemon_lookup or _daemon_by_hostname

    def allocate(self, instance, node_type_config: Dict) -> None:
        ids = self.provider.create_node(
            node_type_config.get("node_config", {}),
            {TAG_NODE_TYPE: getattr(instance, "instance_type", "worker")},
            1)
        instance.handle = ids[0]

    def running_node_id(self, instance) -> Optional[str]:
        nid = instance.handle
        if nid is None or not self.provider.is_running(nid):
            return None
        return self._daemon_lookup(nid)

    def terminate(self, instance) -> None:
        if instance.handle is not None:
            self.provider.terminate_node(instance.handle)


def _daemon_by_hostname(pod_name: str) -> Optional[str]:
    """Default correlation: the registered daemon whose hostname equals
    the pod name (k8s sets a pod's hostname to its name)."""
    try:
        from .._private import state
        daemons = state.current().head_server.daemons
    except Exception:
        return None
    for node_hex, handle in dict(daemons).items():
        if getattr(handle, "hostname", None) == pod_name:
            return node_hex
    return None
