"""Abstract collective group (reference:
python/ray/util/collective/collective_group/base_collective_group.py)."""

from __future__ import annotations

from abc import ABC, abstractmethod

from ..types import (
    AllGatherOptions,
    AllReduceOptions,
    BarrierOptions,
    BroadcastOptions,
    RecvOptions,
    ReduceOptions,
    ReduceScatterOptions,
    SendOptions,
)


class BaseGroup(ABC):
    def __init__(self, world_size: int, rank: int, group_name: str):
        self._world_size = world_size
        self._rank = rank
        self._group_name = group_name

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def world_size(self) -> int:
        return self._world_size

    @property
    def group_name(self) -> str:
        return self._group_name

    def destroy_group(self):
        pass

    @classmethod
    @abstractmethod
    def backend(cls) -> str:
        ...

    @abstractmethod
    def allreduce(self, tensors, opts: AllReduceOptions = AllReduceOptions()):
        ...

    @abstractmethod
    def barrier(self, opts: BarrierOptions = BarrierOptions()):
        ...

    @abstractmethod
    def reduce(self, tensors, opts: ReduceOptions = ReduceOptions()):
        ...

    @abstractmethod
    def allgather(self, tensors,
                  opts: AllGatherOptions = AllGatherOptions()):
        ...

    @abstractmethod
    def broadcast(self, tensors,
                  opts: BroadcastOptions = BroadcastOptions()):
        ...

    @abstractmethod
    def reducescatter(self, tensors,
                      opts: ReduceScatterOptions = ReduceScatterOptions()):
        ...

    @abstractmethod
    def send(self, tensors, opts: SendOptions):
        ...

    @abstractmethod
    def recv(self, tensors, opts: RecvOptions):
        ...
