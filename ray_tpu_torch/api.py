"""Public API: init/shutdown, @remote tasks and actors, get/put/wait.

TPU-native re-implementation of the reference's core Python API surface
(python/ray/_private/worker.py init:1275 get:2649 put:754,
remote_function.py:303 _remote, actor.py ActorClass/ActorHandle). Semantics
follow the reference: `.remote()` is async and returns ObjectRefs; top-level
ObjectRef arguments are resolved to values before execution; actor method
calls execute in submission order; passing/returning refs composes.
"""

from __future__ import annotations

import functools
import inspect
import threading
import uuid
from typing import Any, Dict, List, Optional, Sequence, Union

from ._private import protocol as P
from ._private import serialization, state
from ._private.ids import ActorID, ObjectID, TaskID, object_id_for_return
from .exceptions import TaskError

_init_lock = threading.Lock()
_future_pool = None


def _future_resolver():
    """Shared small pool that materializes future() values off the
    runtime's dispatch threads."""
    global _future_pool
    if _future_pool is None:
        from concurrent.futures import ThreadPoolExecutor
        _future_pool = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="ref-future")
    return _future_pool

__all__ = [
    "init", "shutdown", "is_initialized", "remote", "method", "get", "put",
    "wait", "kill", "cancel", "get_actor", "ObjectRef", "ActorHandle",
    "cluster_resources", "available_resources", "get_runtime_context",
    "get_gpu_ids", "nodes", "timeline",
]


def _make_return_refs(rt, return_ids):
    """Build the ObjectRefs for a just-submitted task's return ids.

    Worker contexts skip the per-ref oneway REF_COUNT frame: the head
    increfs the return ids itself while processing the (oneway) nested
    submission, so one frame rides the wire per call instead of two —
    submission frames halve on worker-as-client bursts (reference shape:
    ray_perf.py multi-client rows). The refs are still marked owned so
    dropping them decrefs, balancing the head-side incref."""
    if getattr(rt, "head_increfs_returns", False):
        refs = [ObjectRef(rid, _incref=False) for rid in return_ids]
        for r in refs:
            r._owned = True
        return refs
    return [ObjectRef(rid) for rid in return_ids]


# ---------------------------------------------------------------------------
# ObjectRef
# ---------------------------------------------------------------------------
class ObjectRef:
    """A future for an object in the cluster (reference: ObjectRef in
    includes/object_ref.pxi). Driver-held refs participate in ownership
    reference counting; dropping the last ref frees the object."""

    __slots__ = ("_id", "_owned", "__weakref__")

    def __init__(self, object_id: ObjectID, _incref: bool = True):
        self._id = object_id
        self._owned = False
        if _incref:
            # Drivers incref synchronously; workers send an oneway borrow
            # message (reference: borrower bookkeeping, reference_count.h).
            rt = state.current_or_none()
            if rt is not None and hasattr(rt, "incref"):
                rt.incref(object_id)
                self._owned = True

    @classmethod
    def _from_binary(cls, id_bytes: bytes) -> "ObjectRef":
        return cls(ObjectID(id_bytes))

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    @property
    def id(self) -> ObjectID:
        return self._id

    def future(self):
        """Return a concurrent.futures.Future resolving to the value.

        Driver: resolved via an object-directory ready callback (no
        parked thread per in-flight future — Serve holds thousands).
        Worker/client contexts fall back to a waiter thread."""
        from concurrent.futures import Future
        fut: Future = Future()

        rt = state.get_node()
        objects = getattr(getattr(rt, "gcs", None), "objects", None)
        if objects is not None:
            def _resolve_now():
                try:
                    fut.set_result(get(self))
                except BaseException as e:  # noqa: BLE001
                    fut.set_exception(e)

            def _on_ready():
                # NEVER deserialize on the runtime's completion-dispatch
                # thread (the ready callback fires there): hand the get
                # to the resolver pool.
                _future_resolver().submit(_resolve_now)

            objects.add_ready_callback(self._id, _on_ready)
            return fut

        def _resolve():
            try:
                fut.set_result(get(self))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=_resolve, daemon=True).start()
        return fut

    def __await__(self):
        import asyncio
        loop = asyncio.get_event_loop()
        rt = state.get_node()
        add_cb = getattr(getattr(rt, "gcs", None), "objects", None)
        if rt is None or add_cb is None:
            # Worker/client context: readiness lives across the pipe.
            return loop.run_in_executor(
                None, lambda: get(self)).__await__()

        # Driver: register a ready callback instead of parking an
        # executor thread per in-flight await (async Serve proxies hold
        # thousands of these).
        fut = loop.create_future()

        def _on_ready():
            def _finish():
                if not fut.cancelled():
                    fut.set_result(None)
            try:
                loop.call_soon_threadsafe(_finish)
            except RuntimeError:
                pass  # loop closed

        add_cb.add_ready_callback(self._id, _on_ready)

        def _gen():
            yield from fut.__await__()
            # Ready: the get below is non-blocking for local objects
            # (remote pulls still block briefly; they ride the caller's
            # loop slice).
            return get(self)

        return _gen()

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __reduce__(self):
        serialization.note_serialized_ref(self._id)
        return (ObjectRef._from_binary, (self._id.binary(),))

    def __del__(self):
        if self._owned:
            try:
                # `state` / its attrs may already be torn down at
                # interpreter exit — any failure here is ignorable.
                rt = state.current_or_none()
                if rt is not None and hasattr(rt, "decref"):
                    rt.decref(self._id)
            except Exception:
                pass


# ---------------------------------------------------------------------------
# init / shutdown
# ---------------------------------------------------------------------------
def init(address: Optional[str] = None, *, num_cpus: Optional[int] = None,
         num_gpus: Optional[int] = None,
         resources: Optional[Dict[str, float]] = None,
         namespace: str = "default", object_store_memory: Optional[int] = None,
         ignore_reinit_error: bool = False, local_mode: bool = False,
         runtime_env: Optional[dict] = None, log_to_driver: bool = True,
         prestart_workers: Optional[int] = None,
         fault_config: Optional[dict] = None,
         **_compat_kwargs):
    """Start the runtime (reference: worker.py:1275 ray.init).

    ``fault_config`` installs the deterministic fault-injection plane
    (_private/fault.py; docs/FAULT_INJECTION.md) for this process AND —
    via the environment — every daemon/worker process spawned under it.

    The node's ``GPU`` resource is the count of NVIDIA GPUs detected
    (``_private/resources.py``; ``RTT_NUM_GPUS`` overrides it), or
    ``num_gpus`` when given. ``@remote(num_gpus=...)`` reserves that many
    and pins the worker to specific ids through ``CUDA_VISIBLE_DEVICES``;
    a worker that asks for none sees no card.
    """
    with _init_lock:
        if state.is_initialized():
            if ignore_reinit_error:
                return get_runtime_context()
            raise RuntimeError(
                "ray_tpu_torch.init() called twice; pass ignore_reinit_error=True")
        # After the reinit gate: a rejected (or short-circuited)
        # duplicate init must not flip fault injection on under a live
        # runtime it didn't create.
        if fault_config is not None:
            global _fault_installed_by_init
            from ._private import fault as fault_mod
            fault_mod.configure(fault_config)
            _fault_installed_by_init = True
        if local_mode:
            from ._private.local_mode import LocalRuntime
            state.set_local_runtime(LocalRuntime())
            return get_runtime_context()
        from ._private.runtime import Node
        try:
            node = Node(num_cpus=num_cpus, num_gpus=num_gpus,
                        resources=resources, namespace=namespace,
                        object_store_memory=object_store_memory)
        except BaseException:
            # Failed boot: roll the fault plane back (shutdown() never
            # runs for a runtime that never existed) so a clean retry
            # init isn't silently chaos-injected.
            if fault_config is not None and _fault_installed_by_init:
                from ._private import fault as fault_mod
                fault_mod.configure(None)
                _fault_installed_by_init = False
            raise
        state.set_node(node)
        # Detached actors persisted by a previous head (same durable GCS
        # path) respawn now — after the runtime is current, so creation
        # machinery works (no-op without RTT_GCS_STORAGE_PATH).
        try:
            node.recover_detached_actors()
        except Exception:
            import traceback
            print("[ray_tpu_torch] detached-actor recovery failed:\n"
                  + traceback.format_exc(), flush=True)
        if log_to_driver:
            node.log_monitor.start()
        if prestart_workers is None:
            prestart_workers = min(int(node.cluster_resources().get("CPU", 4)),
                                   8)
        if prestart_workers:
            node.prestart_workers(prestart_workers)
        return get_runtime_context()


_fault_installed_by_init = False


def shutdown():
    global _fault_installed_by_init
    rt = state.get_node()
    if rt is not None:
        try:
            # Serve-direct channels dial this runtime's workers; close
            # them before the workers die so their EOFs don't fan typed
            # errors into the next cluster this process starts.
            import sys
            dc = sys.modules.get("ray_tpu_torch.serve._private.direct_client")
            if dc is not None:
                dc.reset_client()
        except Exception:
            pass
        rt.shutdown()
    state.set_node(None)
    state.set_local_runtime(None)
    # A fault plane installed via init(fault_config=...) is scoped to
    # that runtime: clear it (and the env propagation) so later inits
    # in this process start clean. Env-configured processes (spawned
    # daemons/workers) keep theirs — they never re-init.
    if _fault_installed_by_init:
        from ._private import fault as fault_mod
        fault_mod.configure(None)
        _fault_installed_by_init = False


def is_initialized() -> bool:
    return state.is_initialized()


# ---------------------------------------------------------------------------
# argument marshalling
# ---------------------------------------------------------------------------
def _make_args(args: Sequence, kwargs: Dict) -> tuple:
    out_args, out_kwargs = [], {}

    def _value_arg(a):
        # Refs nested inside arguments (lists, datasets, ...) are recorded
        # so the owner pins them for the task's lifetime (Ray semantics:
        # a ref serialized into task args stays alive for the task).
        with serialization.collect_object_refs() as nested:
            data = serialization.dumps(a)
        return P.Arg(kind="value", data=data, nested_ids=list(nested))

    for a in args:
        if isinstance(a, ObjectRef):
            out_args.append(P.Arg(kind="ref", object_id=a.id))
        else:
            out_args.append(_value_arg(a))
    for k, a in kwargs.items():
        if isinstance(a, ObjectRef):
            out_kwargs[k] = P.Arg(kind="ref", object_id=a.id)
        else:
            out_kwargs[k] = _value_arg(a)
    return out_args, out_kwargs


def _validate_runtime_env(runtime_env):
    if not runtime_env:
        return None
    from ._private import runtime_env as re_mod
    return re_mod.validate(runtime_env)


def _reject_num_tpus(opts: Dict) -> None:
    """The port's nodes declare GPUs and no TPU: a task or actor that
    asked for one would wait forever for a node that has it."""
    if opts.get("num_tpus"):
        raise ValueError(
            f"num_tpus={opts['num_tpus']!r}: ray_tpu_torch schedules "
            f"GPUs, and no node declares a TPU; ask for num_gpus instead")


def _build_resources(opts: Dict, default_num_cpus: float = 1) -> Dict[str, float]:
    _reject_num_tpus(opts)
    res = dict(opts.get("resources") or {})
    num_cpus = opts.get("num_cpus")
    res["CPU"] = float(default_num_cpus if num_cpus is None else num_cpus)
    if opts.get("num_gpus"):
        res["GPU"] = float(opts["num_gpus"])
    if opts.get("accelerator_type"):
        res[opts["accelerator_type"]] = 0.001
    if opts.get("memory"):
        res["memory"] = float(opts["memory"])
    return res


def _ambient_pg_spec():
    """The current task's spec if it might carry a capturable placement
    group into child tasks, else None (fast-path gate for remote())."""
    from ._private import worker_proc
    cur = worker_proc.current_task_spec()
    if cur is not None and cur.placement_group_id:
        return cur
    return None


def _validate_scheduling_strategy(strategy):
    """Reject unknown strategies at decoration/.options() time — a
    placement constraint that would be silently ignored is worse than
    an error (reference: ray_option_utils.py _validate_scheduling
    strategy check)."""
    from .util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy, NodeLabelSchedulingStrategy,
        PlacementGroupSchedulingStrategy)

    if strategy is None or isinstance(
            strategy, (PlacementGroupSchedulingStrategy,
                       NodeAffinitySchedulingStrategy,
                       NodeLabelSchedulingStrategy)):
        return strategy
    if strategy in ("DEFAULT", "SPREAD"):
        return strategy
    raise ValueError(
        f"Invalid scheduling_strategy {strategy!r}: expected one of "
        f"\"DEFAULT\", \"SPREAD\", PlacementGroupSchedulingStrategy, "
        f"NodeAffinitySchedulingStrategy, NodeLabelSchedulingStrategy")


def _apply_placement(opts: Dict, resources: Dict[str, float]):
    """Resolve placement-group options into the formatted-resource demand
    rewrite (reference: ray_option_utils + BundleSpecification resource
    formatting; scheme in _private/placement.py). Returns
    (pg_id_hex or None, bundle_index, rewritten_resources)."""
    from ._private.placement import rewrite_demand_for_pg
    from .util.scheduling_strategies import PlacementGroupSchedulingStrategy

    strategy = opts.get("scheduling_strategy")
    pg = opts.get("placement_group")
    bundle_index = int(opts.get("placement_group_bundle_index", -1))
    if isinstance(strategy, PlacementGroupSchedulingStrategy):
        pg = strategy.placement_group
        bundle_index = int(strategy.placement_group_bundle_index)
    if pg is None or getattr(pg, "is_empty", False):
        # Inherit the caller task's group when it was created with
        # capture_child_tasks (reference: placement-group capture semantics).
        from ._private import worker_proc
        cur = worker_proc.current_task_spec()
        if cur is not None and cur.placement_group_id:
            cur_strategy = cur.scheduling_strategy
            if (isinstance(cur_strategy, PlacementGroupSchedulingStrategy)
                    and cur_strategy.placement_group_capture_child_tasks):
                pg_id = cur.placement_group_id
                # Same validation as the explicit path: a child of a
                # removed group must fail fast, not park forever.
                state.current().gcs_request(
                    "pg_validate", pg_id_hex=pg_id, resources=resources,
                    bundle_index=-1)
                return pg_id, -1, rewrite_demand_for_pg(
                    resources, pg_id, -1)
        return None, -1, resources
    pg_id_hex = pg.id if hasattr(pg, "id") else str(pg)
    state.current().gcs_request(
        "pg_validate", pg_id_hex=pg_id_hex, resources=resources,
        bundle_index=bundle_index)
    return (pg_id_hex, bundle_index,
            rewrite_demand_for_pg(resources, pg_id_hex, bundle_index))


# ---------------------------------------------------------------------------
# remote functions
# ---------------------------------------------------------------------------
def _supports_streaming(rt) -> bool:
    """Can this runtime context consume a streaming generator? The
    driver always can; workers can via the direct plane (channel
    streams + head-routed GCS fallback); other contexts keep the
    historical gen_wait capability check."""
    sup = getattr(rt, "supports_streaming", None)
    if sup is not None:
        return bool(sup())
    return hasattr(rt, "gen_wait")


class ObjectRefGenerator:
    """Iterator over a streaming generator task's yielded items
    (reference: ObjectRefGenerator / DynamicObjectRefGenerator —
    streaming generator execution, _raylet.pyx:1348). Each __next__
    blocks until the next item lands and yields its ObjectRef; raises
    StopIteration when the task's generator is exhausted."""

    def __init__(self, task_id: TaskID):
        self._task_id = task_id
        self._index = 0
        self._released = False

    def __iter__(self):
        return self

    def __next__(self) -> "ObjectRef":
        return self.next_ready()

    def next_ready(self, timeout: Optional[float] = None) -> "ObjectRef":
        """Like __next__ but with a timeout (raises GetTimeoutError)."""
        rt = state.current()
        available, count, error = rt.gen_wait(self._task_id, self._index,
                                              timeout=timeout)
        if available:
            oid = object_id_for_return(self._task_id, self._index)
            self._index += 1
            return ObjectRef(oid)
        if error is not None:
            raise serialization.loads(error)
        raise StopIteration

    def add_done_callback(self, cb) -> None:
        """cb() fires when the producing task's stream finishes."""
        state.current().gen_add_done_callback(self._task_id, cb)

    def __del__(self):
        if self._released:
            return
        self._released = True
        try:
            rt = state.current_or_none()
            if rt is not None and hasattr(rt, "gen_release"):
                rt.gen_release(self._task_id, self._index)
        except Exception:
            pass

    def __repr__(self):
        return f"ObjectRefGenerator({self._task_id.hex()})"


def _config():
    from ._private.config import ray_config
    return ray_config


_tracing_mod = None


def _tracing():
    """Lazy tracing module handle (zero import cost until first submit)."""
    global _tracing_mod
    if _tracing_mod is None:
        try:
            from .util import tracing as _t
            _tracing_mod = _t
        except Exception:
            _tracing_mod = False
    return _tracing_mod or None


class RemoteFunction:
    """Reference parity: python/ray/remote_function.py."""

    def __init__(self, fn, options: Optional[Dict] = None):
        self._fn = fn
        self._opts = dict(options or {})
        self._fn_id = (f"{getattr(fn, '__module__', 'm')}."
                       f"{getattr(fn, '__qualname__', 'f')}:"
                       f"{uuid.uuid4().hex[:16]}")
        self._blob: Optional[bytes] = None
        self._blob_lock = threading.Lock()
        self._precompute()
        functools.update_wrapper(self, fn)

    def _precompute(self):
        """Per-call invariants hoisted out of remote() — the submit path
        is the reference's microbenchmark hot loop (ray_perf.py:174-189)
        and options don't change between calls."""
        opts = self._opts
        self._streaming = opts.get("num_returns") == "streaming"
        self._num_returns = 0 if self._streaming else int(
            opts.get("num_returns", 1))
        self._resources = _build_resources(opts)
        self._max_retries = opts.get("max_retries")
        self._retry_exceptions = bool(opts.get("retry_exceptions", False))
        self._runtime_env = _validate_runtime_env(opts.get("runtime_env"))
        _validate_scheduling_strategy(opts.get("scheduling_strategy"))
        self._name = opts.get("name", getattr(self._fn, "__name__", "f"))
        # Placement resolution is per-call only when a PG/strategy is in
        # play (explicitly, or potentially inherited from an ambient
        # captured group inside a worker).
        self._static_placement = (
            opts.get("scheduling_strategy") is None
            and opts.get("placement_group") is None)

    def _get_blob(self) -> bytes:
        if self._blob is None:
            with self._blob_lock:
                if self._blob is None:
                    import cloudpickle
                    self._blob = cloudpickle.dumps(self._fn)
        return self._blob

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self.__name__}' cannot be called directly; "
            f"use '{self.__name__}.remote()'.")

    def options(self, **overrides) -> "RemoteFunction":
        rf = RemoteFunction.__new__(RemoteFunction)
        rf._fn = self._fn
        rf._opts = {**self._opts, **overrides}
        rf._fn_id = self._fn_id
        rf._blob = self._blob
        rf._blob_lock = self._blob_lock
        rf._precompute()
        functools.update_wrapper(rf, self._fn)
        return rf

    def __reduce__(self):
        # Remote functions captured inside other remote functions must ship
        # to workers; rebuild sans locks, preserving fn_id so the driver's
        # function registry stays keyed consistently.
        return (RemoteFunction._reconstruct,
                (self._fn, self._opts, self._fn_id))

    @staticmethod
    def _reconstruct(fn, opts, fn_id):
        rf = RemoteFunction(fn, opts)
        rf._fn_id = fn_id
        return rf

    def bind(self, *args, **kwargs):
        """Build a lazy DAG node (reference: dag_node binding in
        remote_function.py / dag/function_node.py)."""
        from .dag import FunctionNode
        return FunctionNode(self, args, kwargs)

    def remote(self, *args, **kwargs) -> Union[ObjectRef, List[ObjectRef]]:
        if not state.is_initialized():
            init(ignore_reinit_error=True)
        rt = state.current()
        opts = self._opts
        streaming = self._streaming
        if streaming and not _supports_streaming(rt):
            # Streams need a consumption surface: the driver's stream
            # state, or (in workers) the direct plane's channel/GCS
            # stream machinery.
            raise ValueError(
                'num_returns="streaming" requires the driver process '
                "or a worker with direct_calls_enabled in this build")
        num_returns = self._num_returns
        task_id = TaskID.from_random()
        return_ids = [object_id_for_return(task_id, i)
                      for i in range(num_returns)]
        s_args, s_kwargs = _make_args(args, kwargs)
        if self._static_placement and _ambient_pg_spec() is None:
            pg_id, bundle_index, resources = None, -1, self._resources
        else:
            pg_id, bundle_index, resources = _apply_placement(
                opts, dict(self._resources))
        spec = P.TaskSpec(
            task_id=task_id, fn_id=self._fn_id, fn_blob=self._get_blob(),
            args=s_args, kwargs=s_kwargs, return_ids=return_ids,
            num_returns=num_returns, name=self._name,
            resources=resources, streaming=streaming,
            max_retries=int(self._max_retries
                            if self._max_retries is not None
                            else _config().default_task_max_retries),
            retry_exceptions=self._retry_exceptions,
            placement_group_id=pg_id,
            placement_group_bundle_index=bundle_index,
            scheduling_strategy=opts.get("scheduling_strategy"),
            runtime_env=self._runtime_env)
        refs = _make_return_refs(rt, return_ids)
        tr = _tracing()
        if tr is not None and tr.is_enabled():
            with tr.span(f"submit:{spec.name}", task_id=task_id.hex()):
                spec.trace_ctx = tr.current_context()
                rt.submit_task(spec)
        else:
            rt.submit_task(spec)
        if streaming:
            return ObjectRefGenerator(task_id)
        return refs[0] if num_returns == 1 else refs


# ---------------------------------------------------------------------------
# actors
# ---------------------------------------------------------------------------
class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str,
                 options: Optional[Dict] = None):
        self._handle = handle
        self._name = name
        self._opts = dict(options or {})

    def options(self, **overrides) -> "ActorMethod":
        return ActorMethod(self._handle, self._name,
                           {**self._opts, **overrides})

    def remote(self, *args, **kwargs):
        return self._handle._actor_method_call(
            self._name, args, kwargs, self._opts)

    def bind(self, *args, **kwargs):
        """Build a lazy DAG node (reference: dag/class_node.py)."""
        from .dag import ClassMethodNode
        return ClassMethodNode(self._handle, self._name, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method '{self._name}' cannot be called directly; "
            f"use '.{self._name}.remote()'.")


class ActorHandle:
    """Reference parity: python/ray/actor.py ActorHandle."""

    def __init__(self, actor_id: ActorID, cls_id: str,
                 method_meta: Dict[str, Dict]):
        self._actor_id = actor_id
        self._cls_id = cls_id
        self._method_meta = method_meta

    @property
    def _id(self) -> ActorID:
        return self._actor_id

    def __getattr__(self, name):
        meta = object.__getattribute__(self, "_method_meta")
        if name in meta:
            return ActorMethod(self, name, meta[name])
        raise AttributeError(
            f"Actor {self._cls_id} has no method '{name}'")

    def _actor_method_call(self, method_name: str, args, kwargs,
                           opts: Dict):
        rt = state.current()
        meta = self._method_meta.get(method_name, {})
        nr_opt = opts.get("num_returns", meta.get("num_returns", 1))
        streaming = nr_opt == "streaming"
        if streaming and not _supports_streaming(rt):
            raise ValueError(
                'num_returns="streaming" requires the driver process '
                "or a worker with direct_calls_enabled in this build")
        num_returns = 0 if streaming else int(nr_opt)
        task_id = TaskID.from_random()
        return_ids = [object_id_for_return(task_id, i)
                      for i in range(num_returns)]
        s_args, s_kwargs = _make_args(args, kwargs)
        spec = P.TaskSpec(
            task_id=task_id, fn_id=f"{self._cls_id}.{method_name}",
            fn_blob=None, args=s_args, kwargs=s_kwargs,
            return_ids=return_ids, num_returns=num_returns,
            name=f"{self._cls_id.split(':')[0]}.{method_name}",
            actor_id=self._actor_id, method_name=method_name,
            # Per-call retry budget; unset (-2 sentinel) falls back to
            # the actor's max_task_retries at submit time; -1 retries
            # forever; an explicit 0 DISABLES retries (reference:
            # actor.py method max_task_retries semantics).
            max_retries=(-2 if opts.get("max_task_retries") is None
                         else int(opts["max_task_retries"])),
            retry_exceptions=bool(opts.get("retry_exceptions", False)),
            streaming=streaming)
        refs = _make_return_refs(rt, return_ids)
        tr = _tracing()
        if tr is not None and tr.is_enabled():
            with tr.span(f"submit:{spec.name}", task_id=task_id.hex()):
                spec.trace_ctx = tr.current_context()
                rt.submit_actor_task(spec)
        else:
            rt.submit_actor_task(spec)
        if streaming:
            return ObjectRefGenerator(task_id)
        return refs[0] if num_returns == 1 else refs

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._cls_id,
                              self._method_meta))

    def __repr__(self):
        return (f"ActorHandle({self._cls_id.split(':')[0]}, "
                f"{self._actor_id.hex()[:12]})")


def method(*, num_returns: int = 1, concurrency_group: Optional[str] = None):
    """Per-method options decorator (reference: actor.py ray.method)."""
    def deco(fn):
        fn.__ray_tpu_method_opts__ = {
            "num_returns": num_returns,
            "concurrency_group": concurrency_group,
        }
        return fn
    return deco


class ActorClass:
    """Reference parity: python/ray/actor.py ActorClass."""

    def __init__(self, cls, options: Optional[Dict] = None):
        self._cls = cls
        self._opts = dict(options or {})
        _reject_num_tpus(self._opts)
        self._cls_id = (f"{getattr(cls, '__module__', 'm')}."
                        f"{getattr(cls, '__qualname__', 'C')}:"
                        f"{uuid.uuid4().hex[:16]}")
        self._blob: Optional[bytes] = None
        self._method_meta = self._build_method_meta(cls)

    @staticmethod
    def _build_method_meta(cls) -> Dict[str, Dict]:
        meta = {}
        for name in dir(cls):
            if name.startswith("__") and name not in ("__call__",):
                continue
            attr = inspect.getattr_static(cls, name)
            if callable(attr) or isinstance(attr, (staticmethod,
                                                   classmethod)):
                opts = getattr(attr, "__ray_tpu_method_opts__", {})
                meta[name] = dict(opts)
        return meta

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._cls.__name__} cannot be instantiated "
            f"directly; use {self._cls.__name__}.remote().")

    def options(self, **overrides) -> "ActorClass":
        ac = ActorClass.__new__(ActorClass)
        ac._cls = self._cls
        ac._opts = {**self._opts, **overrides}
        _reject_num_tpus(ac._opts)
        ac._cls_id = self._cls_id
        ac._blob = self._blob
        ac._method_meta = self._method_meta
        return ac

    def __reduce__(self):
        return (ActorClass._reconstruct,
                (self._cls, self._opts, self._cls_id))

    @staticmethod
    def _reconstruct(cls, opts, cls_id):
        ac = ActorClass(cls, opts)
        ac._cls_id = cls_id
        return ac

    def remote(self, *args, **kwargs) -> ActorHandle:
        if not state.is_initialized():
            init(ignore_reinit_error=True)
        rt = state.current()
        if self._blob is None:
            import cloudpickle
            self._blob = cloudpickle.dumps(self._cls)
        opts = self._opts
        actor_id = ActorID.from_random()
        s_args, s_kwargs = _make_args(args, kwargs)
        is_async = any(
            inspect.iscoroutinefunction(getattr(self._cls, n, None))
            for n in self._method_meta)
        max_concurrency = opts.get("max_concurrency")
        if max_concurrency is None:
            max_concurrency = 1000 if is_async else 1
        _actor_pg_id, _actor_bundle_index, _actor_resources = \
            _apply_placement(opts, _build_resources(opts, default_num_cpus=0))
        concurrency_groups = {
            str(k): int(v) for k, v in
            (opts.get("concurrency_groups") or {}).items()}
        # A method tagged with an undeclared group would silently fall
        # back to the default executor (reference raises here too).
        for mname, meta in self._method_meta.items():
            group = meta.get("concurrency_group")
            if group is not None and group not in concurrency_groups:
                raise ValueError(
                    f"Method {mname!r} uses concurrency_group {group!r}, "
                    f"but the actor declares only "
                    f"{sorted(concurrency_groups) or 'none'} (pass "
                    f"concurrency_groups={{{group!r}: N}} to "
                    f"@ray_tpu_torch.remote).")
        spec = P.ActorSpec(
            actor_id=actor_id, cls_id=self._cls_id, cls_blob=self._blob,
            args=s_args, kwargs=s_kwargs, name=opts.get("name"),
            namespace=opts.get("namespace", "default"),
            max_concurrency=int(max_concurrency),
            max_restarts=int(opts.get("max_restarts", 0)),
            max_task_retries=int(opts.get("max_task_retries", 0)),
            # Actors hold 0 CPU while alive unless explicitly requested
            # (reference semantics: actors don't reserve CPUs for their
            # lifetime, which is how 40k+ actors fit on small clusters).
            resources=_actor_resources,
            placement_group_id=_actor_pg_id,
            placement_group_bundle_index=_actor_bundle_index,
            scheduling_strategy=_validate_scheduling_strategy(
                opts.get("scheduling_strategy")),
            runtime_env=_validate_runtime_env(opts.get("runtime_env")),
            lifetime=opts.get("lifetime"),
            method_meta=self._method_meta,
            concurrency_groups=concurrency_groups)
        rt.create_actor(spec)
        return ActorHandle(actor_id, self._cls_id, self._method_meta)


# ---------------------------------------------------------------------------
# the @remote decorator
# ---------------------------------------------------------------------------
def remote(*args, **options):
    """@remote / @remote(num_cpus=..., num_gpus=..., ...) for functions and
    classes (reference: worker.py ray.remote). A non-zero ``num_tpus``
    raises ValueError here: the port's nodes declare GPUs."""
    if len(args) == 1 and not options and callable(args[0]):
        target = args[0]
        if inspect.isclass(target):
            return ActorClass(target)
        return RemoteFunction(target)
    if args:
        raise TypeError("remote() takes keyword options only")

    def deco(target):
        if inspect.isclass(target):
            return ActorClass(target, options)
        return RemoteFunction(target, options)
    return deco


# ---------------------------------------------------------------------------
# get / put / wait / kill / cancel
# ---------------------------------------------------------------------------
def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None):
    """Reference parity: worker.py:2649 ray.get."""
    if hasattr(refs, "_compiled_dag_get"):  # CompiledDAGRef duck-type
        return refs._compiled_dag_get(timeout)
    rt = state.current()
    single = isinstance(refs, ObjectRef)
    ref_list = [refs] if single else list(refs)
    for r in ref_list:
        if not isinstance(r, ObjectRef):
            raise TypeError(
                f"get() expects ObjectRef(s), got {type(r).__name__}")
    values = rt.get([r.id for r in ref_list], timeout)
    return values[0] if single else values


def put(value: Any) -> ObjectRef:
    """Reference parity: worker.py:754 put_object."""
    if isinstance(value, ObjectRef):
        raise TypeError("Calling put() on an ObjectRef is not allowed.")
    if not state.is_initialized():
        init(ignore_reinit_error=True)
    rt = state.current()
    tr = _tracing()
    if tr is not None and tr.is_enabled():
        # Object spans join the trace tree (reference: tracing_helper
        # wraps put/get the same way it wraps submission).
        with tr.span("put"):
            return ObjectRef(rt.put(value))
    return ObjectRef(rt.put(value))


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    """Reference parity: worker.py ray.wait."""
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    rt = state.current()
    by_id = {r.id: r for r in refs}
    ready_ids, not_ready_ids = rt.wait(
        [r.id for r in refs], num_returns, timeout, fetch_local)
    return ([by_id[i] for i in ready_ids],
            [by_id[i] for i in not_ready_ids])


def kill(actor: ActorHandle, *, no_restart: bool = True):
    state.current().kill_actor(actor._id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    rt = state.current()
    if hasattr(rt, "cancel"):
        rt.cancel(ref.id, force, recursive)
    else:
        raise RuntimeError("cancel() is only supported from the driver")


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    """Look up a named actor (reference: ray.get_actor)."""
    rt = state.current()
    spec = rt.get_actor(name, namespace)
    return ActorHandle(spec.actor_id, spec.cls_id, spec.method_meta)


def cluster_resources() -> Dict[str, float]:
    return state.current().cluster_resources()


def available_resources() -> Dict[str, float]:
    return state.current().available_resources()


# ---------------------------------------------------------------------------
# runtime context
# ---------------------------------------------------------------------------
class RuntimeContext:
    """Reference parity: python/ray/runtime_context.py."""

    @property
    def is_initialized(self) -> bool:
        return state.is_initialized()

    def get_node_id(self) -> str:
        node = state.get_node()
        if node is not None:
            return node.node_id.hex()
        from ._private import state as st
        if st._worker is not None:
            # Workers know their host node from the boot config
            # (reference: the core worker's NodeID from the raylet).
            nid = getattr(st._worker.config, "node_id_hex", None)
            if nid:
                return nid
        rt = state.current_or_none()
        if rt is not None and hasattr(rt, "gcs_request"):
            return "worker-node"
        return ""

    @property
    def namespace(self) -> str:
        node = state.get_node()
        return node.namespace if node is not None else "default"

    def get_worker_id(self) -> str:
        from ._private import state as st
        if st._worker is not None:
            return st._worker.config.worker_id.hex()
        return "driver"

    @staticmethod
    def _current_spec():
        from ._private.worker_proc import current_task_spec
        return current_task_spec()

    def get_task_id(self) -> Optional[str]:
        """Id of the currently executing task (None on the driver)."""
        spec = self._current_spec()
        return spec.task_id.hex() if spec is not None else None

    def get_actor_id(self) -> Optional[str]:
        """Id of the current actor (None outside actor methods)."""
        spec = self._current_spec()
        if spec is not None and spec.actor_id is not None:
            return spec.actor_id.hex()
        return None

    def get_assigned_resources(self) -> Dict[str, float]:
        """Resources of the currently executing task; inside actor
        methods, the ACTOR's assigned resources (reference:
        runtime_context.get_assigned_resources)."""
        spec = self._current_spec()
        if spec is None:
            return {}
        if spec.actor_id is not None:
            # Actor-method specs carry no resources (the actor holds
            # them for its lifetime); report the actor's.
            from ._private import state as st
            aspec = getattr(st._worker, "_actor_spec", None) \
                if st._worker is not None else None
            if aspec is None:  # local_mode: specs live on the runtime
                rt = st.current_or_none()
                aspec = getattr(rt, "_actor_specs", {}).get(spec.actor_id)
            if aspec is not None:
                return dict(aspec.resources)
        return dict(spec.resources)

    def get_accelerator_ids(self) -> Dict[str, List[str]]:
        """Visible accelerator ids (reference:
        runtime_context.get_accelerator_ids): the GPUs the scheduler
        pinned to this worker through CUDA_VISIBLE_DEVICES."""
        import os
        ids = os.environ.get("CUDA_VISIBLE_DEVICES", "")
        return {"GPU": [c.strip() for c in ids.split(",")
                        if c.strip() != ""]}


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext()


def nodes() -> List[Dict[str, Any]]:
    """Cluster node table (reference: ray.nodes())."""
    from .util import state as state_api
    return state_api.list_nodes()


def timeline(filename: Optional[str] = None):
    """Chrome-trace task timeline (reference: ray.timeline())."""
    from .util import state as state_api
    return state_api.timeline(filename=filename)


def get_gpu_ids() -> List[Union[int, str]]:
    """GPU ids assigned to this worker (reference: ray.get_gpu_ids): the
    entries of the CUDA_VISIBLE_DEVICES the scheduler set, as ints (a
    UUID entry stays a string). Empty in a worker with no GPU."""
    return [int(c) if c.isdigit() else c for c in
            get_runtime_context().get_accelerator_ids()["GPU"]]
