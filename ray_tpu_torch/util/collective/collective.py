"""Public collective API (reference:
python/ray/util/collective/collective.py, 789 lines — the full surface:
init_collective_group :120, create_collective_group :151, allreduce :258,
barrier :298, reduce :311, broadcast :373, allgather :423, reducescatter
:472, send :531, recv :594).

Functional style, as the JAX package's: every op *returns* its result
and leaves its input as it was (the reference mutates torch tensors in
place). `allreduce(t)` -> the reduced tensor on every rank: a tensor on
the input's device for a torch tensor, a numpy array for a numpy one.

Usage inside actors (one rank per actor process; one GPU per rank with
nccl):

    import ray_tpu_torch
    from ray_tpu_torch.util import collective as col

    @ray_tpu_torch.remote(num_gpus=1)
    class Worker:
        def setup(self, world_size, rank):
            col.init_collective_group(world_size, rank, "nccl", "default")

        def step(self, grad):
            return col.allreduce(grad, "default")
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional

from .types import (
    AllGatherOptions,
    AllReduceOptions,
    BarrierOptions,
    Backend,
    BroadcastOptions,
    RecvOptions,
    ReduceOp,
    ReduceOptions,
    ReduceScatterOptions,
    SendOptions,
)

logger = logging.getLogger(__name__)

# The GCS KV namespace of group declarations and rendezvous keys.
_KV_NS = "rtt_collective"


class GroupManager:
    """Per-process registry of collective groups (reference:
    collective.py:40 GroupManager)."""

    def __init__(self):
        self._groups: Dict[str, object] = {}
        self._lock = threading.Lock()

    def create_group(self, backend: str, world_size: int, rank: int,
                     group_name: str):
        with self._lock:
            if group_name in self._groups:
                raise RuntimeError(
                    f"Group '{group_name}' already initialized in this "
                    f"process.")
            if backend == "local":
                from .collective_group.local_group import LocalGroup
                g = LocalGroup(world_size, rank, group_name)
            else:
                # A torch process group at every world size, 1 included:
                # nccl at world size 1 is the one NCCL a single card runs.
                from .collective_group.torch_collective_group import (
                    TorchGroup)
                g = TorchGroup(world_size, rank, group_name, backend)
            self._groups[group_name] = g
            return g

    def get_group(self, group_name: str):
        with self._lock:
            return self._groups.get(group_name)

    def destroy_group(self, group_name: str):
        with self._lock:
            g = self._groups.pop(group_name, None)
        if g is not None:
            g.destroy_group()


_group_mgr = GroupManager()


def is_group_initialized(group_name: str = "default") -> bool:
    return _group_mgr.get_group(group_name) is not None


def init_collective_group(world_size: int, rank: int,
                          backend: str = "nccl",
                          group_name: str = "default"):
    """Imperative group init, called inside each member actor/task
    (reference: collective.py:120)."""
    if not isinstance(world_size, int) or world_size < 1:
        raise ValueError(f"world_size must be a positive int, "
                         f"got {world_size}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range [0, {world_size})")
    backend = Backend(backend)
    return _group_mgr.create_group(backend, world_size, rank, group_name)


def create_collective_group(actors: List, world_size: int,
                            ranks: List[int], backend: str = "nccl",
                            group_name: str = "default"):
    """Declarative group creation from the driver (reference:
    collective.py:151): records membership in the GCS KV; each member must
    still call `init_collective_group` (or have it called via a method) to
    join its rank. Returns after metadata is stored."""
    if len(actors) != len(ranks) or sorted(ranks) != list(range(world_size)):
        raise ValueError("ranks must be a permutation of range(world_size) "
                         "matching `actors`")
    from ..._private import serialization, state
    info = {"world_size": world_size, "backend": Backend(backend),
            "ranks": {a._id.hex(): r for a, r in zip(actors, ranks)}}
    state.current().gcs_request(
        "kv_put", key=f"{group_name}/decl",
        value=serialization.dumps(info), namespace=_KV_NS)
    return info


def get_group_info(group_name: str = "default") -> Optional[dict]:
    from ..._private import serialization, state
    raw = state.current().gcs_request(
        "kv_get", key=f"{group_name}/decl", namespace=_KV_NS)
    return serialization.loads(raw) if raw else None


def destroy_collective_group(group_name: str = "default"):
    _group_mgr.destroy_group(group_name)


def get_rank(group_name: str = "default") -> int:
    g = _group_mgr.get_group(group_name)
    return g.rank if g is not None else -1


def get_collective_group_size(group_name: str = "default") -> int:
    g = _group_mgr.get_group(group_name)
    return g.world_size if g is not None else -1


def _group(group_name: str):
    g = _group_mgr.get_group(group_name)
    if g is None:
        raise RuntimeError(
            f"Collective group '{group_name}' is not initialized in this "
            f"process; call init_collective_group first.")
    return g


# -- ops (all return the result; see module docstring) ----------------------
def allreduce(tensor, group_name: str = "default",
              op: ReduceOp = ReduceOp.SUM):
    return _group(group_name).allreduce(
        tensor, AllReduceOptions(reduceOp=op))


def barrier(group_name: str = "default"):
    _group(group_name).barrier(BarrierOptions())


def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op: ReduceOp = ReduceOp.SUM):
    return _group(group_name).reduce(
        tensor, ReduceOptions(reduceOp=op, root_rank=dst_rank))


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return _group(group_name).broadcast(
        tensor, BroadcastOptions(src_rank=src_rank))


def allgather(tensor, group_name: str = "default"):
    return _group(group_name).allgather(tensor, AllGatherOptions())


def reducescatter(tensor, group_name: str = "default",
                  op: ReduceOp = ReduceOp.SUM):
    return _group(group_name).reducescatter(
        tensor, ReduceScatterOptions(reduceOp=op))


def send(tensor, dst_rank: int, group_name: str = "default"):
    """P2P send (reference collective.py:531): only the two ranks take
    part."""
    return _group(group_name).send(tensor, SendOptions(dst_rank=dst_rank))


def recv(shape_or_tensor, src_rank: int, group_name: str = "default"):
    """P2P receive into a new tensor shaped like ``shape_or_tensor`` (a
    template, or a ``(shape, dtype)`` tuple, which gives a numpy
    array)."""
    return _group(group_name).recv(
        shape_or_tensor, RecvOptions(src_rank=src_rank))


# torch-API-style aliases kept for reference-parity call sites
def allreduce_multigpu(tensor_list, group_name: str = "default",
                       op: ReduceOp = ReduceOp.SUM):
    return [allreduce(t, group_name, op) for t in tensor_list]
