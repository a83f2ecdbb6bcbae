"""StandardAutoscaler: reconcile desired vs actual nodes.

Reference: autoscaler/_private/autoscaler.py (StandardAutoscaler.update)
+ v2's GCS-driven variant (autoscaler/v2/autoscaler.py). Each update():
  1. read load (pending demands + PG bundles) from a LoadSource
  2. bin-pack onto node types (resource_demand_scheduler.py)
  3. launch via the NodeProvider (a launch unit of hosts_per_node
     hosts goes up whole, its hosts tagged with one slice-id)
  4. terminate nodes idle past the timeout (never below min_workers,
     never tearing a unit apart — idleness is per unit)
"""
import time
import uuid
from typing import Dict, List, Optional

from .config import ClusterConfig, load_config
from .node_provider import (NodeProvider, STATUS_RUNNING, TAG_NODE_KIND,
                            TAG_NODE_STATUS, TAG_NODE_TYPE, TAG_SLICE_ID)
from .resource_demand_scheduler import get_nodes_to_launch


class LoadSource:
    """Where demand comes from (reference: load_metrics.py)."""

    def get_demands(self) -> Dict:
        return {"demands": [], "placement_groups": []}

    def busy_slice_ids(self) -> Optional[set]:
        """Slice ids currently running work; None = unknown (treat all
        as busy)."""
        return None


class RuntimeLoadSource(LoadSource):
    """Reads the local runtime's scheduler queue (reference: the GCS
    resource-demand view autoscaler v2 consumes, autoscaler.proto)."""

    def get_demands(self) -> Dict:
        from .._private import state
        rt = state.current_or_none()
        if rt is None:
            return {"demands": [], "placement_groups": []}
        try:
            return rt.gcs_request("resource_demands")
        except Exception:
            return {"demands": [], "placement_groups": []}


class StaticLoadSource(LoadSource):
    def __init__(self, demands=None, placement_groups=None, busy=None):
        self._d = list(demands or [])
        self._p = list(placement_groups or [])
        self._busy = busy

    def get_demands(self):
        return {"demands": list(self._d),
                "placement_groups": [{"bundles": b} for b in self._p]}

    def busy_slice_ids(self):
        return self._busy

    def set(self, demands=None, placement_groups=None, busy=None):
        if demands is not None:
            self._d = list(demands)
        if placement_groups is not None:
            self._p = list(placement_groups)
        self._busy = busy


class StandardAutoscaler:
    def __init__(self, config, provider: NodeProvider,
                 load_source: Optional[LoadSource] = None):
        self.config: ClusterConfig = load_config(config)
        self.provider = provider
        self.load = load_source or RuntimeLoadSource()
        self._idle_since: Dict[str, float] = {}  # slice_id -> ts

    # -- views -------------------------------------------------------------
    def _slices(self) -> Dict[str, List[str]]:
        """slice_id -> node ids (single-host nodes are 1-node slices)."""
        out: Dict[str, List[str]] = {}
        for nid in self.provider.non_terminated_nodes({}):
            tags = self.provider.node_tags(nid)
            out.setdefault(tags.get(TAG_SLICE_ID, nid), []).append(nid)
        return out

    def _counts_by_type(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for slice_id, nids in self._slices().items():
            t = self.provider.node_tags(nids[0]).get(TAG_NODE_TYPE, "?")
            counts[t] = counts.get(t, 0) + 1
        return counts

    # -- reconcile ---------------------------------------------------------
    def update(self):
        load = self.load.get_demands()
        demands = load.get("demands", [])
        pg_bundles = []
        for pg in load.get("placement_groups", []):
            # STRICT_PACK-style: one node must fit the whole group;
            # otherwise pack bundles independently (reference:
            # bundle_scheduling_policy.cc pack vs spread).
            bundles = pg.get("bundles", [])
            if pg.get("strategy", "PACK") in ("STRICT_PACK",):
                merged: Dict[str, float] = {}
                for b in bundles:
                    for k, v in b.items():
                        merged[k] = merged.get(k, 0.0) + v
                pg_bundles.append(merged)
            else:
                pg_bundles.extend(dict(b) for b in bundles)

        counts = self._counts_by_type()
        to_launch = get_nodes_to_launch(
            demands, pg_bundles, counts, self.config)
        for node_type, n in to_launch.items():
            nt = self.config.node_types[node_type]
            for _ in range(n):
                slice_id = f"slice-{uuid.uuid4().hex[:8]}"
                self.provider.create_node(
                    nt.node_config,
                    {TAG_NODE_TYPE: node_type,
                     TAG_NODE_KIND: "worker",
                     TAG_SLICE_ID: slice_id,
                     TAG_NODE_STATUS: "launching"},
                    count=nt.hosts_per_node)

        self._terminate_idle(demands or pg_bundles)
        return to_launch

    def _terminate_idle(self, has_demand):
        now = time.monotonic()
        busy = self.load.busy_slice_ids()
        counts = self._counts_by_type()
        for slice_id, nids in self._slices().items():
            tags = self.provider.node_tags(nids[0])
            node_type = tags.get(TAG_NODE_TYPE, "?")
            nt = self.config.node_types.get(node_type)
            if nt is None:
                continue
            running = all(self.provider.is_running(n) for n in nids)
            is_busy = (busy is None) or (slice_id in busy) or bool(has_demand)
            if not running or is_busy:
                self._idle_since.pop(slice_id, None)
                continue
            start = self._idle_since.setdefault(slice_id, now)
            if (now - start >= self.config.idle_timeout_s
                    and counts.get(node_type, 0) > nt.min_workers):
                self.provider.terminate_nodes(nids)  # whole slice
                counts[node_type] -= 1
                self._idle_since.pop(slice_id, None)


class Monitor:
    """Background update loop (reference: autoscaler/_private/monitor.py)."""

    def __init__(self, autoscaler: StandardAutoscaler,
                 interval_s: float = 5.0):
        import threading
        self.autoscaler = autoscaler
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autoscaler-monitor")

    def start(self):
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.autoscaler.update()
            except Exception:
                pass
            self._stop.wait(self.interval_s)

    def stop(self):
        self._stop.set()
