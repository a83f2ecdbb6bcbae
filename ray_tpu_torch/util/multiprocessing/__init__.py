"""Drop-in `multiprocessing.Pool` backed by ray_tpu_torch actors.

Reference parity: python/ray/util/multiprocessing/pool.py (Pool with
apply/apply_async/map/map_async/imap/imap_unordered/starmap over Ray
actors). Each pool process is an actor, so pool workers can hold a model
and its built kernels warm across calls — the property a GPU inference
pool needs. ``ray_remote_args={"num_gpus": n}`` pins each pool actor to
its own cards through ``CUDA_VISIBLE_DEVICES``; a pool actor without it
sees no card.
"""
import itertools
import threading
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch

__all__ = ["Pool", "AsyncResult", "TimeoutError"]

TimeoutError = ray_tpu_torch.exceptions.GetTimeoutError


class _PoolWorker:
    """One pool process (reference: pool.py PoolActor)."""

    def __init__(self, initializer=None, initargs=()):
        if initializer:
            initializer(*initargs)

    def run(self, fn, args, kwargs):
        return fn(*args, **(kwargs or {}))

    def run_batch(self, fn, chunk):
        return [fn(*a) for a in chunk]


class AsyncResult:
    """Reference: pool.py AsyncResult."""

    def __init__(self, refs: List, single: bool):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None):
        values = ray_tpu_torch.get(self._refs, timeout=timeout)
        if self._single:
            return values[0]
        return list(itertools.chain.from_iterable(values))

    def wait(self, timeout: Optional[float] = None):
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                     timeout=timeout)

    def ready(self) -> bool:
        ready, _ = ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                                timeout=0)
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        try:
            self.get(timeout=0.001)
            return True
        except Exception:
            return False


class Pool:
    """Reference: util/multiprocessing/pool.py Pool."""

    def __init__(self, processes: Optional[int] = None, initializer=None,
                 initargs=(), ray_remote_args: Optional[dict] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(ignore_reinit_error=True)
        if processes is None:
            processes = max(
                1, int(ray_tpu_torch.cluster_resources().get("CPU", 1)))
        if processes < 1:
            raise ValueError("processes must be >= 1")
        self._n = processes
        cls = ray_tpu_torch.remote(_PoolWorker)
        if ray_remote_args:
            cls = cls.options(**ray_remote_args)
        self._actors = [cls.remote(initializer, initargs)
                        for _ in range(processes)]
        self._rr = itertools.cycle(range(processes))
        self._closed = False
        self._lock = threading.Lock()

    # -- helpers -----------------------------------------------------------
    def _check(self):
        if self._closed:
            raise ValueError("Pool not running")

    def _next_actor(self):
        with self._lock:
            return self._actors[next(self._rr)]

    @staticmethod
    def _chunks(iterable: Iterable, chunksize: int) -> List[List]:
        out, cur = [], []
        for item in iterable:
            cur.append((item,) if not isinstance(item, tuple) else item)
            if len(cur) >= chunksize:
                out.append(cur)
                cur = []
        if cur:
            out.append(cur)
        return out

    def _map_refs(self, fn: Callable, iterable: Iterable,
                  chunksize: Optional[int], star: bool) -> List:
        items = list(iterable)
        if not star:
            items = [(i,) for i in items]
        if chunksize is None:
            chunksize = max(1, len(items) // (self._n * 4) or 1)
        return [self._next_actor().run_batch.remote(fn, chunk)
                for chunk in self._chunks(items, chunksize)]

    # -- API ---------------------------------------------------------------
    def apply(self, fn: Callable, args=(), kwds=None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn: Callable, args=(), kwds=None) -> AsyncResult:
        self._check()
        ref = self._next_actor().run.remote(fn, tuple(args), kwds or {})
        return AsyncResult([ref], single=True)

    def map(self, fn: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn, iterable, chunksize=None) -> AsyncResult:
        self._check()
        return AsyncResult(self._map_refs(fn, iterable, chunksize, False),
                           single=False)

    def starmap(self, fn, iterable, chunksize=None) -> List[Any]:
        self._check()
        return AsyncResult(self._map_refs(fn, iterable, chunksize, True),
                           single=False).get()

    def imap(self, fn, iterable, chunksize: int = 1):
        self._check()
        refs = self._map_refs(fn, iterable, chunksize, False)
        for ref in refs:
            for v in ray_tpu_torch.get(ref):
                yield v

    def imap_unordered(self, fn, iterable, chunksize: int = 1):
        self._check()
        refs = self._map_refs(fn, iterable, chunksize, False)
        pending = list(refs)
        while pending:
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1)
            for v in ray_tpu_torch.get(ready[0]):
                yield v

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass

    def join(self):
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
