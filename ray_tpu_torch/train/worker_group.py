"""Worker group: the actors that run train_loop_per_worker.

Reference parity: train/_internal/worker_group.py (WorkerGroup :102 of
RayTrainWorker actors :19) + the execution side of backend_executor.py.
Each worker is a dedicated actor process; `max_concurrency=2` lets the
controller poll reports while the train loop runs (the reference uses a
separate results thread inside the worker, session.py). A worker that
reserves a GPU is pinned to it: it sees that one card as cuda:0."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from .. import api
from .checkpoint import Checkpoint
from .session import TrainContext, _Session, _set_session


@api.remote(max_concurrency=2)
class TrainWorker:
    """One training process (reference: worker_group.py:19
    RayTrainWorker)."""

    def __init__(self):
        self._session = None
        self._context = None
        self._backend = None

    def setup(self, context: TrainContext, backend_config,
              checkpoint: Optional[Checkpoint],
              dataset_shards: Optional[Dict[str, Any]] = None):
        self._context = context
        self._backend = backend_config
        self._session = _Session(context, checkpoint, dataset_shards)
        _set_session(self._session)
        if backend_config is not None:
            backend_config.on_start(context)
        return context.world_rank

    def run(self, train_fn: Callable, config: Optional[Dict]):
        """Blocking: executes the user loop; reports flow via poll()."""
        import inspect

        try:
            sig = inspect.signature(train_fn)
            if len(sig.parameters) >= 1:
                result = train_fn(config or {})
            else:
                result = train_fn()
            self._session.finished = True
            return {"status": "finished", "result": result}
        finally:
            self._session.finished = True

    def poll(self):
        """Drain buffered reports (controller calls this periodically)."""
        if self._session is None:
            return []
        return self._session.drain()

    def get_env_info(self):
        import os
        return {"pid": os.getpid()}

    def shutdown_backend(self):
        if self._backend is not None and self._context is not None:
            self._backend.on_shutdown(self._context)
        return True


class WorkerGroup:
    """Driver-side handle on the gang of TrainWorker actors."""

    def __init__(self, num_workers: int,
                 resources_per_worker: Dict[str, float],
                 max_restarts: int = 0):
        opts: Dict[str, Any] = {"max_concurrency": 2}
        res = dict(resources_per_worker)
        if "CPU" in res:
            opts["num_cpus"] = res.pop("CPU")
        if "GPU" in res:
            opts["num_gpus"] = res.pop("GPU")
        if res:
            opts["resources"] = res
        self.workers = [TrainWorker.options(**opts).remote()
                        for _ in range(num_workers)]
        self.num_workers = num_workers

    def setup(self, make_context: Callable[[int], TrainContext],
              backend_config, checkpoint: Optional[Checkpoint],
              dataset_shards: Optional[List[Dict[str, Any]]] = None,
              timeout: float = 120.0):
        refs = []
        for rank, w in enumerate(self.workers):
            shards = dataset_shards[rank] if dataset_shards else None
            refs.append(w.setup.remote(
                make_context(rank), backend_config, checkpoint, shards))
        return api.get(refs, timeout=timeout)

    def run(self, train_fn: Callable, config: Optional[Dict]):
        return [w.run.remote(train_fn, config) for w in self.workers]

    def poll(self, rank: int = 0, timeout: float = 30.0):
        return api.get(self.workers[rank].poll.remote(), timeout=timeout)

    def poll_all(self, timeout: float = 30.0):
        return api.get([w.poll.remote() for w in self.workers],
                       timeout=timeout)

    def shutdown(self, wait_released_s: float = 5.0):
        for w in self.workers:
            try:
                api.kill(w)
            except Exception:
                pass
        # Worker deaths release gang resources ASYNCHRONOUSLY (the recv
        # mux processes each process EOF); an elastic restart that sizes
        # the next gang before the releases land would under-size it.
        # Wait until the gang's dedicated worker processes are gone from
        # the worker table (their death handler releases the resources).
        import time

        from .._private import state as _state
        mine = {w._actor_id.hex() for w in self.workers}
        deadline = time.monotonic() + wait_released_s
        while time.monotonic() < deadline:
            try:
                rows = _state.current().gcs_request("list_workers")
            except Exception:
                return
            if not any(r.get("dedicated_actor") in mine for r in rows):
                # Row removal precedes the release by a few statements in
                # the same death handler; give it a beat.
                time.sleep(0.1)
                return
            time.sleep(0.05)
