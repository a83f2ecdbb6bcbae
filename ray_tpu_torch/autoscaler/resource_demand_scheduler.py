"""Bin-packing of pending resource demands onto node types.

Reference: autoscaler/_private/resource_demand_scheduler.py
(get_nodes_to_launch: pack pending task demands + placement-group bundles
onto copies of available node types, respecting per-type and cluster
caps). Packing is first-fit-decreasing over demand size with a
utilization score preferring the node type that wastes least — the
reference's _utilization_score, simplified.

Gangs: a node type's launch unit is ALL its hosts_per_node hosts, so a
demand of {"GPU": 16} packs onto one unit of 2 hosts of 8 GPUs rather
than onto independent hosts that could not hold it together.
"""
from typing import Dict, List, Tuple

from .config import ClusterConfig, NodeTypeConfig


def _fits(demand: Dict[str, float], free: Dict[str, float]) -> bool:
    return all(free.get(k, 0.0) >= v for k, v in demand.items() if v > 0)


def _consume(demand: Dict[str, float], free: Dict[str, float]):
    for k, v in demand.items():
        if v > 0:
            free[k] = free.get(k, 0.0) - v


def _utilization(demand_sum: Dict[str, float],
                 caps: Dict[str, float]) -> float:
    """Higher = tighter fit (less waste)."""
    scores = []
    for k, cap in caps.items():
        if cap > 0:
            scores.append(min(1.0, demand_sum.get(k, 0.0) / cap))
    return sum(scores) / max(len(scores), 1)


def get_nodes_to_launch(
        demands: List[Dict[str, float]],
        pg_bundles: List[Dict[str, float]],
        current_counts: Dict[str, int],
        config: ClusterConfig) -> Dict[str, int]:
    """-> {node_type: count to launch} (reference:
    resource_demand_scheduler.py get_nodes_to_launch)."""
    to_launch: Dict[str, int] = {}
    total_nodes = sum(current_counts.values())

    # Honor min_workers first.
    for name, nt in config.node_types.items():
        have = current_counts.get(name, 0) + to_launch.get(name, 0)
        if have < nt.min_workers:
            to_launch[name] = to_launch.get(name, 0) + (
                nt.min_workers - have)

    unmet = sorted(
        list(demands) + list(pg_bundles),
        key=lambda d: (len(d), sum(d.values())), reverse=True)
    # Virtual free pools: nodes already in the cluster (their capacity
    # absorbs queued demand first — reference: the scheduler packs onto
    # existing/pending node capacity before requesting new nodes) plus
    # nodes this call already decided to launch.
    pools: List[Tuple[str, Dict[str, float]]] = []
    for name, n in current_counts.items():
        nt = config.node_types.get(name)
        if nt is not None:
            for _ in range(n):
                pools.append((name, dict(nt.slice_resources())))
    for name, n in to_launch.items():
        nt = config.node_types[name]
        for _ in range(n):
            pools.append((name, dict(nt.slice_resources())))

    for demand in unmet:
        if not demand:
            continue
        placed = False
        for _name, free in pools:
            if _fits(demand, free):
                _consume(demand, free)
                placed = True
                break
        if placed:
            continue
        # Pick the best (tightest-fitting) feasible node type.
        best: Tuple[float, str] = (-1.0, "")
        for name, nt in config.node_types.items():
            have = current_counts.get(name, 0) + to_launch.get(name, 0)
            if have >= nt.max_workers:
                continue
            if total_nodes + sum(to_launch.values()) >= config.max_workers:
                continue
            caps = nt.slice_resources()
            if not _fits(demand, caps):
                continue
            score = _utilization(demand, caps)
            if score > best[0]:
                best = (score, name)
        if best[1]:
            name = best[1]
            to_launch[name] = to_launch.get(name, 0) + 1
            nt = config.node_types[name]
            free = dict(nt.slice_resources())
            _consume(demand, free)
            pools.append((name, free))
        # else: demand infeasible on any node type — skip (the reference
        # surfaces these as infeasible warnings).
    return to_launch
