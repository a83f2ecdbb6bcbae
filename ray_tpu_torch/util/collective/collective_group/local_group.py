"""Degenerate world_size==1 group (useful for tests and for code written
against the collective API running unsharded)."""

from __future__ import annotations

import numpy as np

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
from .base_collective_group import BaseGroup


class LocalGroup(BaseGroup):
    @classmethod
    def backend(cls) -> str:
        return "local"

    def allreduce(self, tensor, opts: AllReduceOptions = AllReduceOptions()):
        return np.asarray(tensor)

    def allgather(self, tensor, opts: AllGatherOptions = AllGatherOptions()):
        return np.asarray(tensor)[None]

    def reducescatter(self, tensor,
                      opts: ReduceScatterOptions = ReduceScatterOptions()):
        return np.asarray(tensor)

    def reduce(self, tensor, opts: ReduceOptions = ReduceOptions()):
        return np.asarray(tensor)

    def broadcast(self, tensor, opts: BroadcastOptions = BroadcastOptions()):
        return np.asarray(tensor)

    def barrier(self, opts: BarrierOptions = BarrierOptions()):
        pass

    def send(self, tensor, opts: SendOptions):
        raise ValueError("send/recv undefined for world_size == 1")

    def recv(self, tensor, opts: RecvOptions):
        raise ValueError("send/recv undefined for world_size == 1")
