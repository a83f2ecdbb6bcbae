"""ParallelIterator: sharded lazy iterators over actors.

Reference parity: python/ray/util/iter.py (from_items/from_iterators,
for_each, filter, batch, flatten, gather_sync, gather_async, union,
shuffle via local_shuffle, take/show; shards held by ParallelIteratorWorker
actors).
"""
import collections
import random
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch

__all__ = ["ParallelIterator", "from_items", "from_iterators", "from_range"]


class _ShardWorker:
    """Holds one shard's (lazy) item source + transform chain
    (reference: util/iter.py ParallelIteratorWorker)."""

    def __init__(self, items):
        self._base = list(items)
        self._ops: List = []

    def add_op(self, kind: str, fn=None, arg=None):
        self._ops.append((kind, fn, arg))
        return True

    def _run_chain(self):
        it: Iterable = iter(self._base)
        for kind, fn, arg in self._ops:
            if kind == "for_each":
                it = map(fn, it)
            elif kind == "filter":
                it = filter(fn, it)
            elif kind == "batch":
                def _batched(source, n=arg):
                    buf = []
                    for x in source:
                        buf.append(x)
                        if len(buf) >= n:
                            yield buf
                            buf = []
                    if buf:
                        yield buf
                it = _batched(it)
            elif kind == "flatten":
                def _flat(source):
                    for x in source:
                        yield from x
                it = _flat(it)
            elif kind == "shuffle":
                items = list(it)
                random.Random(arg).shuffle(items)
                it = iter(items)
        return it

    def collect(self) -> List:
        return list(self._run_chain())

    def next_chunk(self, start: int, n: int) -> List:
        # simple paging for gather_async
        return list(self._run_chain())[start:start + n]


class ParallelIterator:
    """Reference: util/iter.py ParallelIterator."""

    def __init__(self, actors: List, name: str = "iter"):
        self._actors = actors
        self.name = name

    # -- transforms (lazy, applied on shards) ------------------------------
    def _add_op(self, kind, fn=None, arg=None, label=""):
        ray_tpu_torch.get([a.add_op.remote(kind, fn, arg) for a in self._actors])
        return ParallelIterator(self._actors, f"{self.name}.{label}")

    def for_each(self, fn: Callable) -> "ParallelIterator":
        return self._add_op("for_each", fn, label="for_each()")

    def filter(self, fn: Callable) -> "ParallelIterator":
        return self._add_op("filter", fn, label="filter()")

    def batch(self, n: int) -> "ParallelIterator":
        return self._add_op("batch", None, n, label=f"batch({n})")

    def flatten(self) -> "ParallelIterator":
        return self._add_op("flatten", label="flatten()")

    def local_shuffle(self, shuffle_buffer_size: int = 0,
                      seed: Optional[int] = None) -> "ParallelIterator":
        return self._add_op("shuffle", None, seed, label="shuffle()")

    # -- gather ------------------------------------------------------------
    def num_shards(self) -> int:
        return len(self._actors)

    def gather_sync(self) -> "LocalIterator":
        """Round-robin over shards, in order (reference:
        iter.py gather_sync)."""
        shards = ray_tpu_torch.get([a.collect.remote() for a in self._actors])
        queues = [collections.deque(s) for s in shards]

        def _gen():
            while any(queues):
                for q in queues:
                    if q:
                        yield q.popleft()
        return LocalIterator(_gen)

    def gather_async(self) -> "LocalIterator":
        """Completion order (reference: iter.py gather_async)."""
        refs = {a.collect.remote(): i for i, a in enumerate(self._actors)}

        def _gen():
            pending = list(refs.keys())
            while pending:
                ready, pending = ray_tpu_torch.wait(pending, num_returns=1)
                for item in ray_tpu_torch.get(ready[0]):
                    yield item
        return LocalIterator(_gen)

    def union(self, other: "ParallelIterator") -> "ParallelIterator":
        return ParallelIterator(self._actors + other._actors,
                                f"{self.name}+{other.name}")

    def take(self, n: int) -> List:
        out = []
        for x in self.gather_sync():
            out.append(x)
            if len(out) >= n:
                break
        return out

    def show(self, n: int = 20):
        for x in self.take(n):
            print(x)

    def __iter__(self):
        return iter(self.gather_sync())


class LocalIterator:
    def __init__(self, gen_factory):
        self._factory = gen_factory

    def __iter__(self):
        return iter(self._factory())


def from_items(items: List[Any], num_shards: int = 2,
               repeat: bool = False) -> ParallelIterator:
    shards = [items[i::num_shards] for i in range(num_shards)]
    Worker = ray_tpu_torch.remote(_ShardWorker)
    actors = [Worker.remote(s) for s in shards]
    return ParallelIterator(actors, f"from_items[{len(items)}]")


def from_iterators(generators: List[Iterable],
                   repeat: bool = False) -> ParallelIterator:
    Worker = ray_tpu_torch.remote(_ShardWorker)
    actors = [Worker.remote(list(g)) for g in generators]
    return ParallelIterator(actors, f"from_iterators[{len(generators)}]")


def from_range(n: int, num_shards: int = 2) -> ParallelIterator:
    return from_items(list(range(n)), num_shards)
