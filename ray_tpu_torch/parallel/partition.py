"""Partition rules: logical array axes -> mesh axes.

Counterpart of ``ray_tpu/parallel/partition.py``: parameters carry
*logical* axis names ("embed", "mlp", "heads", "kv", ...) and a rule table
maps them to mesh axes. Swapping rule tables re-shards the same model
(pure TP, FSDP, or combined) without touching model code. Here ``spec``
returns a tuple of mesh-axis names (None where an axis is replicated),
what the JAX package's ``PartitionSpec`` holds.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

MeshAxis = Union[None, str, Tuple[str, ...]]


class PartitionRules:
    """Ordered (logical_axis -> mesh_axis) table."""

    def __init__(self, rules: Sequence[Tuple[str, MeshAxis]]):
        self._rules: Dict[str, MeshAxis] = dict(rules)

    def mesh_axis(self, logical: Optional[str]) -> MeshAxis:
        if logical is None:
            return None
        return self._rules.get(logical)

    def spec(self, logical_axes: Sequence[Optional[str]]
             ) -> Tuple[MeshAxis, ...]:
        """Mesh axes of an array annotated with logical axis names."""
        return tuple(self.mesh_axis(a) for a in logical_axes)

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


def logical_to_mesh_axes(param_logical: Dict[str, Sequence[Optional[str]]],
                         rules: PartitionRules):
    """Map a dict of logical-axis tuples to a dict of mesh-axis tuples."""
    return {k: rules.spec(v) for k, v in param_logical.items()}
