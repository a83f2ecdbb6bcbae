from .collective import (  # noqa: F401
    allgather,
    allreduce,
    barrier,
    broadcast,
    create_collective_group,
    destroy_collective_group,
    get_collective_group_size,
    get_group_info,
    get_rank,
    init_collective_group,
    is_group_initialized,
    recv,
    reduce,
    reducescatter,
    send,
)
from .types import Backend, ReduceOp  # noqa: F401
