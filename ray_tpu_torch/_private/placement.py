"""Placement group manager: gang reservation of resource bundles.

TPU-native re-design of the reference's placement-group stack —
GcsPlacementGroupManager / GcsPlacementGroupScheduler
(src/ray/gcs/gcs_server/gcs_placement_group_manager.cc,
gcs_placement_group_scheduler.cc) and the raylet-side
PlacementGroupResourceManager (raylet/placement_group_resource_manager.cc).

The reference reserves bundles by minting *formatted* node resources:
``{resource}_group_{index}_{pgid}`` (indexed) and
``{resource}_group_{pgid}`` (wildcard), then rewrites the demands of tasks
scheduled into the group to those names. We keep that exact scheme — it
composes with an unmodified resource-vector scheduler — but collapse the
two-phase commit (PREPARE/COMMIT across raylets,
gcs_placement_group_scheduler.cc) into one atomic reservation against the
node's ResourceManager, which is sound on a single resource view.

A bundle demanding ``GPU`` reserves a count; the scheduler's GPU
allocator hands specific device ids to workers only when a task in the
group actually starts, so reservation never strands a device.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..exceptions import TaskUnschedulableError

# Placement strategies (reference: python/ray/util/placement_group.py and
# common.proto PlacementStrategy).
PACK = "PACK"
SPREAD = "SPREAD"
STRICT_PACK = "STRICT_PACK"
STRICT_SPREAD = "STRICT_SPREAD"
VALID_STRATEGIES = (PACK, SPREAD, STRICT_PACK, STRICT_SPREAD)

# PG lifecycle states (reference: gcs.proto PlacementGroupTableData).
PG_PENDING = "PENDING"
PG_CREATED = "CREATED"
PG_REMOVED = "REMOVED"
PG_INFEASIBLE = "INFEASIBLE"


def wildcard_resource(name: str, pg_id_hex: str) -> str:
    return f"{name}_group_{pg_id_hex}"


def indexed_resource(name: str, index: int, pg_id_hex: str) -> str:
    return f"{name}_group_{index}_{pg_id_hex}"


def parse_group_resource(key: str):
    """Inverse of the formatted-resource scheme. Returns
    (base_name, bundle_index_or_None, pg_id_hex) or None."""
    if "_group_" not in key:
        return None
    base, rest = key.split("_group_", 1)
    parts = rest.split("_")
    if len(parts) == 1:
        return (base, None, parts[0])
    if len(parts) == 2 and parts[0].isdigit():
        return (base, int(parts[0]), parts[1])
    return None


def rewrite_demand_for_pg(resources: Dict[str, float], pg_id_hex: str,
                          bundle_index: int) -> Dict[str, float]:
    """Rewrite a task's resource demand to formatted group resources
    (reference: BundleSpecification::ComputeResources formatting +
    placement-group demand rewrite in ray_option_utils / task submission)."""
    out: Dict[str, float] = {}
    for k, v in resources.items():
        if v <= 0:
            continue
        out[wildcard_resource(k, pg_id_hex)] = v
        if bundle_index >= 0:
            out[indexed_resource(k, bundle_index, pg_id_hex)] = v
    return out


def gpus_in_demand(resources: Dict[str, float]) -> int:
    """GPUs a demand pins, whether direct (``GPU``) or through a
    placement-group wildcard resource (``GPU_group_{pgid}``). Indexed
    duplicates are ignored so GPUs are not double-counted; a fraction
    rounds up, so a worker that asks for part of a GPU still sees one."""
    n = 0.0
    for k, v in resources.items():
        if k == "GPU":
            n += v
        else:
            parsed = parse_group_resource(k)
            if parsed and parsed[0] == "GPU" and parsed[1] is None:
                n += v
    return int(math.ceil(n - 1e-9))


@dataclass
class PlacementGroupEntry:
    pg_id_hex: str
    bundles: List[Dict[str, float]]
    strategy: str
    name: str
    state: str = PG_PENDING
    created_at: float = field(default_factory=time.time)
    # Total base resources reserved (for release on remove).
    reserved: Dict[str, float] = field(default_factory=dict)
    # Formatted resources added to the cluster view (for removal).
    formatted: Dict[str, float] = field(default_factory=dict)
    ready_event: threading.Event = field(default_factory=threading.Event)
    error: Optional[str] = None


class PlacementGroupManager:
    """Owns PG state and the bundle reservation protocol."""

    def __init__(self, resources_mgr):
        self._resources = resources_mgr
        self._lock = threading.Lock()
        self._groups: Dict[str, PlacementGroupEntry] = {}
        self._pending: List[str] = []
        self._stop = False
        self._retry_thread: Optional[threading.Thread] = None

    # -- creation ----------------------------------------------------------
    def create(self, pg_id_hex: str, bundles: List[Dict[str, float]],
               strategy: str, name: str = "") -> PlacementGroupEntry:
        if not bundles:
            raise ValueError("Placement group requires at least one bundle")
        if strategy not in VALID_STRATEGIES:
            raise ValueError(
                f"Invalid strategy {strategy!r}; must be one of "
                f"{VALID_STRATEGIES}")
        for b in bundles:
            if not b or any(v < 0 for v in b.values()):
                raise ValueError(f"Invalid bundle {b}: bundles must be "
                                 "non-empty with non-negative values")
        entry = PlacementGroupEntry(pg_id_hex=pg_id_hex,
                                    bundles=[dict(b) for b in bundles],
                                    strategy=strategy, name=name)
        with self._lock:
            self._groups[pg_id_hex] = entry
        self._try_reserve(entry)
        if entry.state == PG_PENDING:
            with self._lock:
                self._pending.append(pg_id_hex)
                self._ensure_retry_thread()
        return entry

    def pending_entries(self) -> List[PlacementGroupEntry]:
        """PGs awaiting reservation — the autoscaler's gang-demand signal
        (reference: GcsAutoscalerStateManager pending PG demands)."""
        with self._lock:
            return [e for e in self._groups.values()
                    if e.state == PG_PENDING]

    def _total_demand(self, bundles) -> Dict[str, float]:
        total: Dict[str, float] = {}
        for b in bundles:
            for k, v in b.items():
                total[k] = total.get(k, 0.0) + v
        return total

    def _set_infeasible(self, entry: PlacementGroupEntry, error: str):
        with self._lock:
            if entry.state != PG_PENDING:
                return
            entry.state = PG_INFEASIBLE
            entry.error = error
        entry.ready_event.set()

    def _try_reserve(self, entry: PlacementGroupEntry):
        total = self._total_demand(entry.bundles)
        # Single resource view ⇒ every bundle lands on this "node".
        # STRICT_SPREAD demands distinct nodes per bundle, which a
        # single-node view can never satisfy (the reference parks such PGs
        # as infeasible until nodes join; we fail fast and revisit when the
        # multi-node cluster sim schedules across virtual nodes).
        if entry.strategy == STRICT_SPREAD and len(entry.bundles) > 1:
            self._set_infeasible(
                entry,
                f"STRICT_SPREAD with {len(entry.bundles)} bundles needs "
                f"{len(entry.bundles)} nodes; single-node cluster")
            return
        if not self._resources.feasible(total):
            self._set_infeasible(
                entry,
                f"Placement group demands {total}, exceeding cluster totals "
                f"{self._resources.totals}")
            return
        if not self._resources.try_acquire(total):
            return  # stays PENDING; retried on resource release
        formatted: Dict[str, float] = {}
        for i, b in enumerate(entry.bundles):
            for k, v in b.items():
                if v <= 0:
                    continue
                w = wildcard_resource(k, entry.pg_id_hex)
                formatted[w] = formatted.get(w, 0.0) + v
                formatted[indexed_resource(k, i, entry.pg_id_hex)] = v
        with self._lock:
            if entry.state != PG_PENDING:
                # remove() won the race while we reserved: roll back so a
                # removed group can never resurrect as CREATED holding
                # resources forever.
                self._resources.release(total)
                return
            self._resources.add_total(formatted)
            entry.reserved = total
            entry.formatted = formatted
            entry.state = PG_CREATED
        entry.ready_event.set()

    def _ensure_retry_thread(self):
        if self._retry_thread is None or not self._retry_thread.is_alive():
            self._retry_thread = threading.Thread(
                target=self._retry_loop, daemon=True, name="pg-retry")
            self._retry_thread.start()

    def _retry_loop(self):
        """Retry pending groups until all land (the reference retries on
        every resource-change event from the syncer; polling is equivalent
        on one node and far simpler)."""
        while not self._stop:
            with self._lock:
                pending = [self._groups[h] for h in self._pending
                           if self._groups[h].state == PG_PENDING]
                if not pending:
                    self._pending.clear()
                    return
            for entry in pending:
                if entry.state == PG_PENDING:
                    self._try_reserve(entry)
            with self._lock:
                self._pending = [h for h in self._pending
                                 if self._groups[h].state == PG_PENDING]
                if not self._pending:
                    return
            time.sleep(0.02)

    # -- removal -----------------------------------------------------------
    def remove(self, pg_id_hex: str):
        with self._lock:
            entry = self._groups.get(pg_id_hex)
            if entry is None or entry.state == PG_REMOVED:
                return
            prior = entry.state
            entry.state = PG_REMOVED
            entry.ready_event.set()
            if prior == PG_CREATED:
                # Wildcard keys redirect later releases to the base
                # resource; indexed keys alias the same amounts and drop.
                base_of = {}
                for k in entry.formatted:
                    parsed = parse_group_resource(k)
                    base_of[k] = (parsed[0] if parsed and parsed[1] is None
                                  else None)
                self._resources.retire_group_resources(
                    entry.formatted, base_of)

    def get(self, pg_id_hex: str) -> Optional[PlacementGroupEntry]:
        with self._lock:
            return self._groups.get(pg_id_hex)

    def get_by_name(self, name: str) -> Optional[PlacementGroupEntry]:
        with self._lock:
            for e in self._groups.values():
                if e.name == name and e.state != PG_REMOVED:
                    return e
        return None

    def wait_ready(self, pg_id_hex: str, timeout: Optional[float]) -> bool:
        entry = self.get(pg_id_hex)
        if entry is None:
            raise ValueError(f"Unknown placement group {pg_id_hex}")
        if not entry.ready_event.wait(timeout):
            return False
        if entry.state == PG_INFEASIBLE:
            raise TaskUnschedulableError(entry.error or "infeasible")
        if entry.state == PG_REMOVED:
            raise TaskUnschedulableError(
                f"Placement group {pg_id_hex} was removed")
        return True

    def validate_demand(self, entry: PlacementGroupEntry,
                        resources: Dict[str, float], bundle_index: int):
        if entry.state == PG_REMOVED:
            raise TaskUnschedulableError(
                f"Placement group {entry.pg_id_hex} was removed")
        if bundle_index >= len(entry.bundles) or bundle_index < -1:
            raise ValueError(
                f"bundle_index {bundle_index} out of range for placement "
                f"group with {len(entry.bundles)} bundles (must be -1 or "
                f"in [0, {len(entry.bundles)}))")
        if bundle_index >= 0:
            bundle = entry.bundles[bundle_index]
            for k, v in resources.items():
                if v > 0 and v > bundle.get(k, 0.0) + 1e-9:
                    raise ValueError(
                        f"Task demands {k}={v} but bundle {bundle_index} "
                        f"only reserves {bundle.get(k, 0.0)}")

    def table(self) -> Dict[str, dict]:
        with self._lock:
            return {
                h: {
                    "placement_group_id": h,
                    "name": e.name,
                    "bundles": {i: dict(b)
                                for i, b in enumerate(e.bundles)},
                    "strategy": e.strategy,
                    "state": e.state,
                    "stats": {"created_at": e.created_at},
                }
                for h, e in self._groups.items()
            }

    def shutdown(self):
        self._stop = True
