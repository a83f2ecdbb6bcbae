"""Cluster config: node types with GPU hosts.

Reference: the autoscaler YAML schema (autoscaler/ray-schema.json:
available_node_types with resources/min_workers/max_workers) — expressed
as dataclasses; `load_config` accepts a dict or a YAML path.

Node types carry per-HOST resources and `hosts_per_node`, the launch
unit: a type of 2 hosts of 8 GPUs is launched and terminated as one
gang of 16. The port's nodes declare GPUs (``GPU`` and an accelerator
type such as ``H100``, as ``init()`` does); a node type that declares
``TPU`` raises, since no port node could ever satisfy it.
"""
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class NodeTypeConfig:
    name: str
    resources: Dict[str, float]          # per HOST
    min_workers: int = 0
    max_workers: int = 10
    hosts_per_node: int = 1              # >1 => an atomic gang of hosts
    node_config: Dict[str, Any] = field(default_factory=dict)
    # Added ONCE per gang (not per host): markers a placement group can
    # ask for to land on one launch unit.
    slice_extra: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self):
        if "TPU" in self.resources or "TPU" in self.slice_extra:
            raise ValueError(
                f"node type {self.name!r} declares TPU: ray_tpu_torch "
                f"nodes declare GPUs; give it a GPU count instead")

    def slice_resources(self) -> Dict[str, float]:
        """Aggregate resources of one launch unit (the whole slice)."""
        agg = {k: v * self.hosts_per_node for k, v in self.resources.items()}
        for k, v in self.slice_extra.items():
            agg[k] = agg.get(k, 0.0) + v
        return agg


@dataclass
class ClusterConfig:
    node_types: Dict[str, NodeTypeConfig]
    max_workers: int = 64                # cluster-wide cap (launch units)
    idle_timeout_s: float = 60.0
    upscaling_speed: float = 1.0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ClusterConfig":
        nts = {}
        for name, spec in d.get("available_node_types", {}).items():
            nts[name] = NodeTypeConfig(
                name=name,
                resources=dict(spec.get("resources", {})),
                min_workers=int(spec.get("min_workers", 0)),
                max_workers=int(spec.get("max_workers", 10)),
                hosts_per_node=int(spec.get("hosts_per_node", 1)),
                node_config=dict(spec.get("node_config", {})))
        if not nts:
            raise ValueError("config needs available_node_types")
        return cls(
            node_types=nts,
            max_workers=int(d.get("max_workers", 64)),
            idle_timeout_s=float(d.get("idle_timeout_minutes", 1.0)) * 60.0,
            upscaling_speed=float(d.get("upscaling_speed", 1.0)))


def gpu_node_type(name: str, accelerator_type: str, gpus: int,
                  gpus_per_host: Optional[int] = None,
                  cpus_per_host: int = 96,
                  min_workers: int = 0,
                  max_workers: int = 4) -> NodeTypeConfig:
    """Convenience: a node type of ``gpus`` cards of ``accelerator_type``
    (``util.accelerators``' names, e.g. "H100") over as many hosts as
    they span, ``gpus_per_host`` each (default: the type's standard
    host); each host declares ``GPU`` and the accelerator type, as
    ``init()`` does. The GPU counterpart of the JAX package's TPU slice
    type, without its ``TPU-<gen>-<chips>-head`` gang resource."""
    from ..util.accelerators import gpus_per_host as standard
    per = gpus_per_host or standard(accelerator_type)
    hosts = max(1, -(-gpus // per))
    on_host = float(min(gpus, per))
    per_host = {"CPU": float(cpus_per_host), "GPU": on_host,
                accelerator_type: on_host}
    return NodeTypeConfig(
        name=name, resources=per_host, min_workers=min_workers,
        max_workers=max_workers, hosts_per_node=hosts)


def load_config(source) -> ClusterConfig:
    if isinstance(source, ClusterConfig):
        return source
    if isinstance(source, dict):
        return ClusterConfig.from_dict(source)
    if isinstance(source, str):
        import yaml
        with open(source) as f:
            return ClusterConfig.from_dict(yaml.safe_load(f))
    raise TypeError(f"Cannot load cluster config from {type(source)}")
