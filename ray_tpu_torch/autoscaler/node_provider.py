"""NodeProvider plugin API + fake provider for tests.

Reference: python/ray/autoscaler/node_provider.py (the cloud plugin
surface: create_node/terminate_node/non_terminated_nodes/node_tags) and
autoscaler/_private/fake_multi_node/node_provider.py:236
(FakeMultiNodeProvider — cloud nodes faked in-process so autoscaler logic
is testable with no cloud account; SURVEY §4's load-bearing test
mechanism).

Launch units: a node type may describe a gang of several GPU hosts
(`hosts_per_node > 1`, e.g. 2 hosts x 8 H100s), tagged with one slice
id. Such a unit is provisioned and terminated whole — an autoscaler
that scales per-host would tear a gang apart mid-job.
"""
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

TAG_NODE_TYPE = "node-type"
TAG_NODE_KIND = "node-kind"  # head | worker
TAG_SLICE_ID = "slice-id"
TAG_NODE_STATUS = "node-status"

STATUS_PENDING = "pending"
STATUS_RUNNING = "running"
STATUS_TERMINATED = "terminated"


class NodeProvider:
    """Cloud plugin ABC (reference: autoscaler/node_provider.py)."""

    def __init__(self, provider_config: Dict[str, Any],
                 cluster_name: str = "default"):
        self.provider_config = provider_config
        self.cluster_name = cluster_name

    def non_terminated_nodes(self, tag_filters: Dict[str, str]) -> List[str]:
        raise NotImplementedError

    def is_running(self, node_id: str) -> bool:
        raise NotImplementedError

    def node_tags(self, node_id: str) -> Dict[str, str]:
        raise NotImplementedError

    def internal_ip(self, node_id: str) -> Optional[str]:
        raise NotImplementedError

    def create_node(self, node_config: Dict[str, Any],
                    tags: Dict[str, str], count: int) -> List[str]:
        raise NotImplementedError

    def terminate_node(self, node_id: str):
        raise NotImplementedError

    def terminate_nodes(self, node_ids: List[str]):
        for nid in node_ids:
            self.terminate_node(nid)


class FakeMultiNodeProvider(NodeProvider):
    """In-memory provider (reference: fake_multi_node/node_provider.py:236).

    Launch latency is configurable so tests can cover the pending->running
    transition; `fail_types` simulates provision failures (stockouts —
    the common case for scarce accelerators)."""

    def __init__(self, provider_config: Optional[Dict] = None,
                 cluster_name: str = "default"):
        super().__init__(provider_config or {}, cluster_name)
        self._nodes: Dict[str, Dict] = {}
        self._lock = threading.Lock()
        self.launch_delay_s = float(
            self.provider_config.get("launch_delay_s", 0.0))
        self.fail_types = set(self.provider_config.get("fail_types", ()))

    def non_terminated_nodes(self, tag_filters=None) -> List[str]:
        with self._lock:
            out = []
            for nid, info in self._nodes.items():
                if info["status"] == STATUS_TERMINATED:
                    continue
                tags = info["tags"]
                if all(tags.get(k) == v
                       for k, v in (tag_filters or {}).items()):
                    out.append(nid)
            return out

    def is_running(self, node_id: str) -> bool:
        with self._lock:
            info = self._nodes.get(node_id)
            if info is None:
                return False
            if (info["status"] == STATUS_PENDING
                    and time.monotonic() >= info["ready_at"]):
                info["status"] = STATUS_RUNNING
            return info["status"] == STATUS_RUNNING

    def node_tags(self, node_id: str) -> Dict[str, str]:
        with self._lock:
            return dict(self._nodes[node_id]["tags"])

    def internal_ip(self, node_id: str) -> Optional[str]:
        with self._lock:
            return self._nodes[node_id]["ip"]

    def create_node(self, node_config, tags, count: int) -> List[str]:
        node_type = tags.get(TAG_NODE_TYPE, "?")
        if node_type in self.fail_types:
            raise RuntimeError(f"provider stockout for {node_type}")
        created = []
        with self._lock:
            for _ in range(count):
                nid = f"fake-{uuid.uuid4().hex[:8]}"
                self._nodes[nid] = {
                    "tags": dict(tags),
                    "status": STATUS_PENDING,
                    "ready_at": time.monotonic() + self.launch_delay_s,
                    "ip": f"10.0.0.{len(self._nodes) + 1}",
                    "config": dict(node_config or {}),
                }
                created.append(nid)
        return created

    def terminate_node(self, node_id: str):
        with self._lock:
            if node_id in self._nodes:
                self._nodes[node_id]["status"] = STATUS_TERMINATED
