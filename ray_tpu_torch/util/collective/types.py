"""Collective types (reference: python/ray/util/collective/types.py).

The backends are the reference's own: ``nccl`` for CUDA tensors (one
rank per GPU) and ``gloo`` for CPU tensors, each a ``torch.distributed``
process group; and ``local``, the degenerate single-process group. The
caller picks the backend; a group never swaps one for the other.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from datetime import timedelta


class Backend:
    """Backend name constants (reference: types.py:29-41 Backend enum)."""

    NCCL = "nccl"
    GLOO = "gloo"
    LOCAL = "local"

    def __new__(cls, name: str = "nccl"):
        name = (name or "nccl").lower()
        if name in ("nccl", "gloo", "local"):
            return name
        raise ValueError(
            f"Unsupported collective backend: {name!r}; the port's backends "
            f"are 'nccl' (CUDA tensors), 'gloo' (CPU tensors) and 'local'")


class ReduceOp(enum.IntEnum):
    SUM = 0
    PRODUCT = 1
    MIN = 2
    MAX = 3


unset_timeout = timedelta(milliseconds=-1)


@dataclass
class AllReduceOptions:
    reduceOp: ReduceOp = ReduceOp.SUM
    timeout: timedelta = unset_timeout


@dataclass
class BarrierOptions:
    timeout: timedelta = unset_timeout


@dataclass
class ReduceOptions:
    reduceOp: ReduceOp = ReduceOp.SUM
    root_rank: int = 0
    timeout: timedelta = unset_timeout


@dataclass
class AllGatherOptions:
    timeout: timedelta = unset_timeout


@dataclass
class BroadcastOptions:
    src_rank: int = 0
    timeout: timedelta = unset_timeout


@dataclass
class ReduceScatterOptions:
    reduceOp: ReduceOp = ReduceOp.SUM
    timeout: timedelta = unset_timeout


@dataclass
class SendOptions:
    dst_rank: int = 0
    timeout: timedelta = unset_timeout


@dataclass
class RecvOptions:
    src_rank: int = 0
    timeout: timedelta = unset_timeout
