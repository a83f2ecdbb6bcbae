"""Collective ops on compiled DAGs.

Reference parity: python/ray/experimental/collective/allreduce.py — bind
an allreduce across same-shaped outputs of several actor nodes inside a
DAG; the reference lowers to NCCL p2p channels
(torch_tensor_nccl_channel.py). Here DEVICE tensors should not cross
actors mid-graph at all — use the collectives of a process group inside
the step (ray_tpu_torch.util.collective on NCCL / gloo). This module
covers the HOST-tensor case the reference also serves: the reduction
lowers to a hidden reducer actor wired into the compiled graph's shm
channels (reduce + multi-reader broadcast == allreduce).

The reducer keeps the type that came in: torch tensors (bf16 included,
which numpy lacks; a CUDA tensor reaches it through the channel as a CPU
tensor) are reduced by torch ops in their own dtype, anything else by
numpy, as the JAX package reduces. Each op folds the inputs in order,
so both give the same values.
"""

from __future__ import annotations

import functools
from typing import Any, List, Sequence

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.dag import DAGNode
from ray_tpu_torch.util.collective.types import ReduceOp

_REDUCERS = {
    ReduceOp.SUM: lambda ts: sum(ts[1:], start=ts[0]),
    ReduceOp.PRODUCT: lambda ts: np.prod(np.stack(ts), axis=0),
    ReduceOp.MIN: lambda ts: np.min(np.stack(ts), axis=0),
    ReduceOp.MAX: lambda ts: np.max(np.stack(ts), axis=0),
}


def _torch_reducers():
    import torch

    return {
        ReduceOp.SUM: lambda ts: sum(ts[1:], start=ts[0]),
        ReduceOp.PRODUCT: lambda ts: functools.reduce(torch.mul, ts),
        ReduceOp.MIN: lambda ts: functools.reduce(torch.minimum, ts),
        ReduceOp.MAX: lambda ts: functools.reduce(torch.maximum, ts),
    }


def _is_tensor(value) -> bool:
    import sys

    torch = sys.modules.get("torch")
    return torch is not None and isinstance(value, torch.Tensor)


@ray_tpu_torch.remote(num_cpus=0)
class _CollectiveReducer:
    """Hidden actor performing the reduction stage (the compiled graph
    wires its input/output channels like any other node)."""

    def __init__(self, op: int):
        self._op = ReduceOp(op)

    def reduce(self, *tensors):
        if not tensors:
            raise ValueError("allreduce needs at least one input")
        first = next((t for t in tensors if _is_tensor(t)), None)
        if first is not None:
            import torch

            ts = [torch.as_tensor(t, dtype=first.dtype, device=first.device)
                  for t in tensors]
            reducers = _torch_reducers()
        else:
            ts = [np.asarray(t) for t in tensors]
            reducers = _REDUCERS
        shapes = {tuple(t.shape) for t in ts}
        if len(shapes) > 1:
            raise ValueError(
                f"allreduce inputs must share one shape, got {shapes}")
        return reducers[self._op](ts)

    def gather(self, *tensors):
        return list(tensors)


class _AllReduceBinder:
    """`allreduce.bind(nodes)` surface (reference: allreduce.bind)."""

    def bind(self, nodes: Sequence[DAGNode],
             op: ReduceOp = ReduceOp.SUM) -> List[DAGNode]:
        """Returns one DAG node per input node, each carrying the reduced
        value (all participants read the same broadcast channel)."""
        nodes = list(nodes)
        if not nodes:
            raise ValueError("allreduce.bind needs a non-empty node list")
        reducer = _CollectiveReducer.remote(int(op))
        red = reducer.reduce.bind(*nodes)
        # Framework-owned: CompiledDAG.teardown() kills it (user actors
        # are never touched).
        red._owned_actor = reducer
        # One logical value; every consumer (one per participant) becomes
        # a reader of the reducer's broadcast channel at compile time.
        return [red for _ in nodes]


class _AllGatherBinder:
    def bind(self, nodes: Sequence[DAGNode]) -> List[DAGNode]:
        nodes = list(nodes)
        if not nodes:
            raise ValueError("allgather.bind needs a non-empty node list")
        reducer = _CollectiveReducer.remote(int(ReduceOp.SUM))
        gathered = reducer.gather.bind(*nodes)
        gathered._owned_actor = reducer
        return [gathered for _ in nodes]


allreduce = _AllReduceBinder()
allgather = _AllGatherBinder()

__all__ = ["allgather", "allreduce", "ReduceOp"]
