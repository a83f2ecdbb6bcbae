"""ActorGroup: manage N identical actors as one unit.

Reference parity: python/ray/util/actor_group.py:62 (ActorGroup —
broadcast method calls across members, used for SPMD-style worker sets
outside of Train).
"""
from typing import Any, Callable, List, Optional

import ray_tpu_torch

__all__ = ["ActorGroup"]


class ActorGroup:
    def __init__(self, actor_cls, num_actors: int,
                 actor_options: Optional[dict] = None,
                 init_args: tuple = (), init_kwargs: Optional[dict] = None):
        if num_actors < 1:
            raise ValueError("num_actors must be >= 1")
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(ignore_reinit_error=True)
        cls = actor_cls if hasattr(actor_cls, "remote") \
            else ray_tpu_torch.remote(actor_cls)
        if actor_options:
            cls = cls.options(**actor_options)
        self._actors = [cls.remote(*init_args, **(init_kwargs or {}))
                        for _ in range(num_actors)]

    def __len__(self) -> int:
        return len(self._actors)

    @property
    def actors(self) -> List:
        return list(self._actors)

    def execute_async(self, method: str, *args, **kwargs) -> List:
        """Fan a method call to every member; returns refs."""
        return [getattr(a, method).remote(*args, **kwargs)
                for a in self._actors]

    def execute(self, method: str, *args, **kwargs) -> List[Any]:
        return ray_tpu_torch.get(self.execute_async(method, *args, **kwargs))

    def execute_single_async(self, index: int, method: str, *args, **kwargs):
        return getattr(self._actors[index], method).remote(*args, **kwargs)

    def execute_single(self, index: int, method: str, *args, **kwargs):
        return ray_tpu_torch.get(
            self.execute_single_async(index, method, *args, **kwargs))

    def execute_with_rank(self, method: str, *args, **kwargs) -> List[Any]:
        """Like execute(), but prepends each member's rank to the args —
        the SPMD pattern (rank -> mesh coordinate)."""
        return ray_tpu_torch.get([
            getattr(a, method).remote(rank, *args, **kwargs)
            for rank, a in enumerate(self._actors)])

    def shutdown(self):
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        self._actors = []
