"""ray_tpu_torch.autoscaler — demand-driven provisioning of GPU nodes.

Reference parity: python/ray/autoscaler/ (StandardAutoscaler,
resource_demand_scheduler, NodeProvider plugins, FakeMultiNodeProvider),
with launch units of one or more GPU hosts (SURVEY §2.2: autoscaler
v1+v2, §7 phase 6). ``autoscaler.v2`` launches real node daemons.
"""
from .autoscaler import (LoadSource, Monitor, RuntimeLoadSource,
                         StandardAutoscaler, StaticLoadSource)
from .config import (ClusterConfig, NodeTypeConfig, gpu_node_type,
                     load_config)
from .node_provider import (FakeMultiNodeProvider, NodeProvider,
                            TAG_NODE_KIND, TAG_NODE_TYPE, TAG_SLICE_ID)
from .resource_demand_scheduler import get_nodes_to_launch

__all__ = [
    "ClusterConfig", "FakeMultiNodeProvider", "LoadSource", "Monitor",
    "NodeProvider", "NodeTypeConfig", "RuntimeLoadSource",
    "StandardAutoscaler", "StaticLoadSource", "TAG_NODE_KIND",
    "TAG_NODE_TYPE", "TAG_SLICE_ID", "get_nodes_to_launch", "gpu_node_type",
    "load_config",
]
