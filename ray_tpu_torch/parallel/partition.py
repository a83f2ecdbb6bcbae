"""Partition rules: logical array axes -> mesh axes.

Counterpart of ``ray_tpu/parallel/partition.py``: parameters carry
*logical* axis names ("embed", "mlp", "heads", "kv", ...) and a rule table
maps them to mesh axes. Swapping rule tables re-shards the same model
(pure TP, FSDP, or combined) without touching model code. ``spec``
returns a ``PartitionSpec``: a tuple with one entry per dim, the mesh
axis (or tuple of axes) that shards it or None where it is replicated,
what the JAX package's ``jax.sharding.PartitionSpec`` holds.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

MeshAxis = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Mesh axes per dim (``P("dp", None)``); a trailing dim it does not
    name is replicated. A tuple, so it compares equal to a plain one."""

    def __new__(cls, *entries: MeshAxis):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class PartitionRules:
    """Ordered (logical_axis -> mesh_axis) table."""

    def __init__(self, rules: Sequence[Tuple[str, MeshAxis]]):
        self._rules: Dict[str, MeshAxis] = dict(rules)

    def mesh_axis(self, logical: Optional[str]) -> MeshAxis:
        if logical is None:
            return None
        return self._rules.get(logical)

    def spec(self, logical_axes: Sequence[Optional[str]]) -> PartitionSpec:
        """Mesh axes of an array annotated with logical axis names."""
        return PartitionSpec(*[self.mesh_axis(a) for a in logical_axes])

    def with_overrides(self, overrides: Sequence[Tuple[str, MeshAxis]]
                       ) -> "PartitionRules":
        merged = dict(self._rules)
        merged.update(dict(overrides))
        return PartitionRules(list(merged.items()))

    def items(self):
        return self._rules.items()


def tp_rules() -> PartitionRules:
    """Megatron-style tensor parallelism: shard the MLP hidden and the
    attention heads over `tp`; batch over `dp`; sequence over `sp`."""
    return PartitionRules([
        ("batch", "dp"),
        ("seq", "sp"),
        ("embed", None),
        ("mlp", "tp"),
        ("heads", "tp"),
        ("kv", None),
        ("head_dim", None),
        ("vocab", "tp"),
        ("expert", "ep"),
        ("stage", "pp"),
    ])


def fsdp_rules() -> PartitionRules:
    """ZeRO-3-style fully sharded params: shard the embed axis of every
    weight over `fsdp`."""
    return tp_rules().with_overrides([
        ("embed", "fsdp"),
    ])


def dcn_rules(base: Optional[PartitionRules] = None) -> PartitionRules:
    """Multi-slice data parallelism: the batch shards over both the slice
    axis ``dp_dcn`` and the in-slice ``dp`` axis (use with
    ``make_multislice_mesh``); gradients are summed over both."""
    return (base or tp_rules()).with_overrides([
        ("batch", ("dp_dcn", "dp")),
    ])


def logical_to_mesh_axes(param_logical: Dict[str, Sequence[Optional[str]]],
                         rules: PartitionRules):
    """Map a dict of logical-axis tuples to a dict of mesh-axis tuples."""
    return {k: rules.spec(v) for k, v in param_logical.items()}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement: the mesh and its PartitionSpec (what
    ``models._training.place_params`` reads)."""

    mesh: Any
    spec: PartitionSpec


def named_sharding(mesh, rules: PartitionRules,
                   logical_axes: Sequence[Optional[str]]) -> NamedSharding:
    return NamedSharding(mesh, rules.spec(logical_axes))


def _is_axes(x) -> bool:
    return isinstance(x, (tuple, list)) and all(
        a is None or isinstance(a, str) for a in x)


def tree_shardings(mesh, rules: PartitionRules, logical_tree):
    """A tree of NamedShardings from a matching tree of logical-axis
    tuples (leaves are tuples/lists of axis names)."""
    if _is_axes(logical_tree):
        return named_sharding(mesh, rules, logical_tree)
    if isinstance(logical_tree, dict):
        return {k: tree_shardings(mesh, rules, v)
                for k, v in logical_tree.items()}
    return type(logical_tree)(tree_shardings(mesh, rules, v)
                              for v in logical_tree)
