"""GCP GPU node provider: Compute Engine VMs over gcloud.

Reference parity: the cloud NodeProvider plugins
(autoscaler/_private/gcp/node_provider.py). The JAX package provisions
whole TPU slices through the TPU *queued-resources* API
(``gcp_tpu_provider.py``); GPUs have no queued resources. Here one
"node" is one Compute Engine VM and the GPUs it carries: an accelerator-
optimized machine type whose cards come with it (``a3-highgpu-8g``, 8
H100s; ``a2-highgpu-1g``, 1 A100), or an N1 machine with cards attached
by ``--accelerator=type=...,count=...``. The node type's GPU count
(``gpu_node_type``'s ``GPU``, given to the VM as ``node_config["gpus"]``
by ``node_config_for``) must match the machine type's.

All cloud interaction goes through ``gcloud compute instances ...`` via
an injectable ``runner`` callable (argv list -> stdout string), so the
provisioning logic is fully testable with a fake runner, and the class
fails with a clear error when gcloud is absent.
"""

from __future__ import annotations

import json
import shlex
import shutil
import uuid
from typing import Any, Callable, Dict, List, Optional

from .node_provider import (NodeProvider, STATUS_PENDING, STATUS_RUNNING,
                            STATUS_TERMINATED)

# Compute Engine instance statuses -> provider statuses. A stopped or
# suspended VM holds no running node, so it counts as gone, as a
# suspended queued resource does.
_STATE_MAP = {
    "PROVISIONING": STATUS_PENDING,
    "STAGING": STATUS_PENDING,
    "REPAIRING": STATUS_PENDING,
    "RUNNING": STATUS_RUNNING,
    "STOPPING": STATUS_TERMINATED,
    "STOPPED": STATUS_TERMINATED,
    "SUSPENDING": STATUS_TERMINATED,
    "SUSPENDED": STATUS_TERMINATED,
    "TERMINATED": STATUS_TERMINATED,
}

# Machine types whose GPUs come with the machine: (accelerator, count).
MACHINE_GPUS = {
    "a3-megagpu-8g": ("nvidia-h100-mega-80gb", 8),
    "a3-highgpu-8g": ("nvidia-h100-80gb", 8),
    "a3-highgpu-4g": ("nvidia-h100-80gb", 4),
    "a3-highgpu-2g": ("nvidia-h100-80gb", 2),
    "a3-highgpu-1g": ("nvidia-h100-80gb", 1),
    "a2-ultragpu-8g": ("nvidia-a100-80gb", 8),
    "a2-ultragpu-1g": ("nvidia-a100-80gb", 1),
    "a2-highgpu-8g": ("nvidia-tesla-a100", 8),
    "a2-highgpu-1g": ("nvidia-tesla-a100", 1),
    "g2-standard-4": ("nvidia-l4", 1),
}


def _default_runner(argv: List[str]) -> str:
    import subprocess
    if shutil.which(argv[0]) is None:
        raise RuntimeError(
            f"{argv[0]} is not installed; GcpGpuInstanceProvider needs the "
            "gcloud CLI (or pass a custom runner=).")
    return subprocess.run(argv, capture_output=True, text=True,
                          check=True).stdout


def node_config_for(node_type, machine_type: str,
                    **extra: Any) -> Dict[str, Any]:
    """The ``node_config`` of a GPU node type (``config.gpu_node_type``)
    on ``machine_type``: its per-host GPU count as ``gpus``."""
    return {"machine_type": machine_type,
            "gpus": int(node_type.resources.get("GPU", 0)), **extra}


class GcpGpuInstanceProvider(NodeProvider):
    """One node == one Compute Engine VM with its GPUs.

    provider_config keys: project, zone, machine_type (default
    "a3-highgpu-8g"), gpus (the VM's card count), accelerator_type (an
    N1 machine's attached cards, e.g. "nvidia-tesla-t4"), image_family
    and image_project (the boot image), head_address (the VM's startup
    script joins that head), plus optional spot / reserved / reservation.
    node_config (the node type's) overrides any of them.
    """

    def __init__(self, provider_config: Dict[str, Any],
                 cluster_name: str = "default",
                 runner: Optional[Callable[[List[str]], str]] = None):
        super().__init__(provider_config, cluster_name)
        self._run = runner or _default_runner
        self.project = provider_config.get("project", "")
        self.zone = provider_config.get("zone", "")
        # local tag cache, as the TPU provider keeps one
        self._tags: Dict[str, Dict[str, str]] = {}

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _base() -> List[str]:
        return ["gcloud", "compute", "instances"]

    def _project_flags(self) -> List[str]:
        return [f"--project={self.project}"] if self.project else []

    def _zone_flags(self) -> List[str]:
        return [f"--zone={self.zone}"] if self.zone else []

    def _list(self) -> List[Dict[str, Any]]:
        argv = self._base() + ["list", "--format=json"]
        if self.zone:
            argv.append(f"--zones={self.zone}")
        raw = self._run(argv + self._project_flags())
        prefix = f"{self.cluster_name}-"
        return [r for r in json.loads(raw or "[]")
                if r.get("name", "").startswith(prefix)]

    @staticmethod
    def _status(instance: Dict[str, Any]) -> str:
        return _STATE_MAP.get(instance.get("status", ""), STATUS_PENDING)

    def _find(self, node_id: str) -> Optional[Dict[str, Any]]:
        return next((r for r in self._list() if r.get("name") == node_id),
                    None)

    @staticmethod
    def _gpu_flags(cfg: Dict[str, Any]) -> List[str]:
        machine = cfg.get("machine_type", "a3-highgpu-8g")
        gpus = cfg.get("gpus")
        if machine in MACHINE_GPUS:
            accel, count = MACHINE_GPUS[machine]
            if gpus is not None and int(gpus) != count:
                raise ValueError(
                    f"machine type {machine} carries {count} x {accel}, "
                    f"but the node type asks for {gpus} GPUs")
            return []
        if not gpus:
            return []
        if not cfg.get("accelerator_type"):
            raise ValueError(
                f"machine type {machine} has no GPUs of its own: give "
                f"accelerator_type (e.g. nvidia-tesla-t4) for its {gpus}")
        return [f"--accelerator=type={cfg['accelerator_type']},"
                f"count={int(gpus)}"]

    def _create_argv(self, name: str, cfg: Dict[str, Any]) -> List[str]:
        argv = self._base() + [
            "create", name,
            f"--machine-type={cfg.get('machine_type', 'a3-highgpu-8g')}",
            *self._gpu_flags(cfg),
            # GPU VMs cannot live-migrate
            "--maintenance-policy=TERMINATE",
            f"--image-family="
            f"{cfg.get('image_family', 'common-cu128-ubuntu-2204-nvidia-570')}",
            f"--image-project="
            f"{cfg.get('image_project', 'deeplearning-platform-release')}",
        ] + self._zone_flags() + self._project_flags()
        if cfg.get("spot"):
            argv += ["--provisioning-model=SPOT",
                     "--instance-termination-action=DELETE"]
        if cfg.get("reservation"):
            argv += ["--reservation-affinity=specific",
                     f"--reservation={cfg['reservation']}"]
        elif cfg.get("reserved"):
            argv.append("--reservation-affinity=any")
        if cfg.get("head_address"):
            start = ["python3", "-m", "ray_tpu_torch", "start",
                     f"--address={cfg['head_address']}"]
            argv.append("--metadata=startup-script=" + shlex.join(start))
        return argv

    # -- NodeProvider surface ----------------------------------------------
    def non_terminated_nodes(self, tag_filters=None) -> List[str]:
        out = []
        for r in self._list():
            if self._status(r) == STATUS_TERMINATED:
                continue
            tags = self._tags.get(r["name"], {})
            if all(tags.get(k) == v
                   for k, v in (tag_filters or {}).items()):
                out.append(r["name"])
        return out

    def is_running(self, node_id: str) -> bool:
        r = self._find(node_id)
        return r is not None and self._status(r) == STATUS_RUNNING

    def node_tags(self, node_id: str) -> Dict[str, str]:
        return dict(self._tags.get(node_id, {}))

    def internal_ip(self, node_id: str) -> Optional[str]:
        r = self._find(node_id)
        for nic in (r or {}).get("networkInterfaces", []):
            if nic.get("networkIP"):
                return nic["networkIP"]
        return None

    def create_node(self, node_config: Dict[str, Any],
                    tags: Dict[str, str], count: int) -> List[str]:
        cfg = {**self.provider_config, **(node_config or {})}
        created = []
        for _ in range(count):
            name = f"{self.cluster_name}-{uuid.uuid4().hex[:8]}"
            self._run(self._create_argv(name, cfg))
            self._tags[name] = dict(tags)
            created.append(name)
        return created

    def terminate_node(self, node_id: str):
        self._run(self._base() + ["delete", node_id, "--quiet"]
                  + self._zone_flags() + self._project_flags())
        self._tags.pop(node_id, None)


PROVIDERS = {
    "fake_multinode": "ray_tpu_torch.autoscaler.node_provider."
                      "FakeMultiNodeProvider",
    "gcp_gpu_instances":
        "ray_tpu_torch.autoscaler.gcp_gpu_provider.GcpGpuInstanceProvider",
}


def make_provider(kind: str, provider_config: Dict[str, Any],
                  cluster_name: str = "default", **kw) -> NodeProvider:
    """Provider registry lookup (reference: autoscaler/_private/
    providers.py _get_node_provider). The JAX package's
    ``gcp_tpu_queued_resources`` raises, naming the GPU kind."""
    import importlib
    if kind == "gcp_tpu_queued_resources":
        raise ValueError(
            "gcp_tpu_queued_resources provisions TPU slices; ray_tpu_torch "
            "provisions GPU VMs: use kind 'gcp_gpu_instances'")
    path = PROVIDERS.get(kind)
    if path is None:
        raise ValueError(
            f"unknown provider {kind!r}; known: {sorted(PROVIDERS)}")
    mod, _, cls = path.rpartition(".")
    provider_cls = getattr(importlib.import_module(mod), cls)
    return provider_cls(provider_config, cluster_name, **kw)
