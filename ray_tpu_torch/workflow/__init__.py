"""ray_tpu_torch.workflow — durable workflow execution.

Reference parity: python/ray/workflow/ — api.py (workflow.run/run_async,
resume, get_output, get_status, list_all, cancel, delete),
workflow_executor.py (step-by-step execution), workflow_state_from_dag.py
(DAG -> step state), storage-backed recovery (every step's result is
checkpointed; resuming skips completed steps).

Built on ray_tpu_torch.dag nodes: a workflow IS a task DAG whose per-step
results are persisted to a filesystem store before the next step runs, so
a crashed driver can `workflow.resume(workflow_id)` and continue where it
stopped. Steps returning a new DAG node are continuations (the
reference's workflow.continuation pattern).

    @ray_tpu_torch.remote
    def fetch(x): ...

    out = workflow.run(fetch.bind(1), workflow_id="ingest-1")
"""
import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ..dag import (DAGNode, FunctionNode, InputAttributeNode, InputNode,
                   MultiOutputNode)
from .._private import serialization

# -- statuses (reference: workflow/common.py WorkflowStatus) ----------------
RUNNING = "RUNNING"
SUCCESSFUL = "SUCCESSFUL"
FAILED = "FAILED"
CANCELED = "CANCELED"
RESUMABLE = "RESUMABLE"

_storage_dir: Optional[str] = None


def init(storage: Optional[str] = None):
    """Set the workflow storage root (reference: workflow.init)."""
    global _storage_dir
    _storage_dir = storage or os.environ.get(
        "RTT_WORKFLOW_STORAGE",
        os.path.expanduser("~/.cache/rtt/workflows"))
    os.makedirs(_storage_dir, exist_ok=True)
    return _storage_dir


def _storage() -> str:
    if _storage_dir is None:
        init()
    return _storage_dir


class _WorkflowStore:
    """Per-workflow directory layout (reference: workflow/workflow_storage.py):
    <root>/<wf_id>/{status.json, dag.pkl, steps/<key>.pkl}"""

    def __init__(self, workflow_id: str):
        self.dir = os.path.join(_storage(), workflow_id)
        self.steps_dir = os.path.join(self.dir, "steps")
        os.makedirs(self.steps_dir, exist_ok=True)

    def save_dag(self, dag: DAGNode, args: tuple, kwargs: dict):
        with open(os.path.join(self.dir, "dag.pkl"), "wb") as f:
            f.write(serialization.dumps((dag, args, kwargs)))

    def load_dag(self):
        with open(os.path.join(self.dir, "dag.pkl"), "rb") as f:
            return serialization.loads(f.read())

    def set_status(self, status: str, error: Optional[str] = None):
        with open(os.path.join(self.dir, "status.json"), "w") as f:
            json.dump({"status": status, "error": error,
                       "updated_at": time.time()}, f)

    def get_status(self) -> Optional[Dict]:
        try:
            with open(os.path.join(self.dir, "status.json")) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def step_path(self, key: str) -> str:
        return os.path.join(self.steps_dir, f"{key}.pkl")

    def has_step(self, key: str) -> bool:
        return os.path.exists(self.step_path(key))

    def save_step(self, key: str, value: Any):
        # Atomic write: a crash mid-write must not look like a completed
        # step on resume (reference: workflow storage atomicity).
        tmp = self.step_path(key) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(serialization.dumps(value))
        os.replace(tmp, self.step_path(key))

    def load_step(self, key: str) -> Any:
        with open(self.step_path(key), "rb") as f:
            return serialization.loads(f.read())


def options(*, max_retries: Optional[int] = None,
            catch_exceptions: Optional[bool] = None):
    """Per-step workflow options (reference: workflow/api.py
    ``workflow.options`` — ``@workflow.options(max_retries=..,
    catch_exceptions=..)``). Returns a decorator; apply it to a bound
    DAG node (or to the @remote function itself) to override the
    workflow-global settings for that one step:

        step = workflow.options(max_retries=5)(flaky.bind(x))
        out = workflow.run(step, workflow_id="w1", max_retries=0)

    ``max_retries`` overrides the run()-level retry budget for the
    step; ``catch_exceptions=True`` makes the step's checkpointed value
    a ``(result, exception)`` tuple instead of raising (the reference's
    catch_exceptions contract)."""
    opts: Dict[str, Any] = {}
    if max_retries is not None:
        opts["max_retries"] = int(max_retries)
    if catch_exceptions is not None:
        opts["catch_exceptions"] = bool(catch_exceptions)

    def _apply(target):
        try:
            target._workflow_options = dict(
                getattr(target, "_workflow_options", None) or {}, **opts)
        except (AttributeError, TypeError):
            raise TypeError(
                f"workflow.options cannot be applied to {target!r}; "
                f"apply it to a bound DAG node or a @remote function")
        return target

    return _apply


def _step_options(node: DAGNode) -> Dict[str, Any]:
    """Effective per-step options: node-level tags win over tags on the
    underlying remote function."""
    fn_opts = getattr(getattr(node, "_remote_fn", None),
                      "_workflow_options", None) or {}
    node_opts = getattr(node, "_workflow_options", None) or {}
    return {**fn_opts, **node_opts}


def _step_key(node: DAGNode, idx: int, prefix: str = "") -> str:
    name = ""
    if isinstance(node, FunctionNode):
        name = getattr(node._remote_fn, "__name__", "fn")
    return f"{prefix}{idx:04d}_{name or type(node).__name__}"


def _execute_durable(dag: DAGNode, store: _WorkflowStore, input_args: tuple,
                     input_kwargs: dict, max_retries: int,
                     prefix: str = "", depth: int = 0) -> Any:
    """Topologically execute, checkpointing each step result
    (reference: workflow_executor.py)."""
    if depth > 50:
        raise RecursionError("workflow continuation depth exceeded 50")
    topo = dag._topo()
    cache: Dict[int, Any] = {}
    for idx, node in enumerate(topo):
        if isinstance(node, (InputNode, InputAttributeNode)):
            cache[id(node)] = node._exec_one(cache, input_args, input_kwargs)
            continue
        if isinstance(node, MultiOutputNode):
            cache[id(node)] = [node._resolve(cache, o)
                               for o in node._bound_args]
            continue
        key = _step_key(node, idx, prefix)
        if store.has_step(key):
            cache[id(node)] = store.load_step(key)
            continue
        # Per-step overrides (workflow.options) beat the run()-level
        # budget; catch_exceptions checkpoints (result, exception)
        # instead of failing the workflow.
        wopts = _step_options(node)
        step_retries = int(wopts.get("max_retries", max_retries))
        catch = bool(wopts.get("catch_exceptions"))
        attempts = 0
        caught: Optional[BaseException] = None
        while True:
            try:
                ref = node._exec_one(
                    {k: v for k, v in cache.items()}, input_args,
                    input_kwargs)
                value = ray_tpu_torch.get(ref) if hasattr(ref, "id") else ref
                break
            except Exception as e:
                attempts += 1
                if attempts > step_retries:
                    if not catch:
                        raise
                    caught, value = e, None
                    break
        if caught is None and isinstance(value, DAGNode):
            # Continuation: the step returned a new sub-workflow
            # (reference: workflow.continuation / workflow_state_from_dag).
            value = _execute_durable(
                value, store, (), {}, max_retries,
                prefix=f"{key}.c", depth=depth + 1)
        if catch:
            value = (value, caught)
        store.save_step(key, value)
        cache[id(node)] = value
    return cache[id(dag)]


def run(dag: DAGNode, *args, workflow_id: Optional[str] = None,
        max_retries: int = 3, **kwargs) -> Any:
    """Run a workflow to completion, durably (reference:
    workflow/api.py run)."""
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(ignore_reinit_error=True)
    workflow_id = workflow_id or f"workflow_{int(time.time() * 1000)}"
    store = _WorkflowStore(workflow_id)
    store.save_dag(dag, args, kwargs)
    store.set_status(RUNNING)
    try:
        out = _execute_durable(dag, store, args, kwargs, max_retries)
    except Exception as e:
        store.set_status(FAILED, error=repr(e))
        raise
    store.save_step("__output__", out)
    store.set_status(SUCCESSFUL)
    return out


def run_async(dag: DAGNode, *args, workflow_id: Optional[str] = None,
              max_retries: int = 3, **kwargs):
    """Run in a background task; returns an ObjectRef to the output."""
    blob = serialization.dumps((dag, args, kwargs))
    storage_root = _storage()

    @ray_tpu_torch.remote
    def _drive(blob_, wf_id, storage_root_, retries):
        from ray_tpu_torch import workflow as wf
        wf.init(storage_root_)
        dag_, args_, kwargs_ = serialization.loads(blob_)
        return wf.run(dag_, *args_, workflow_id=wf_id,
                      max_retries=retries, **kwargs_)

    workflow_id = workflow_id or f"workflow_{int(time.time() * 1000)}"
    return _drive.remote(blob, workflow_id, storage_root, max_retries)


def resume(workflow_id: str) -> Any:
    """Resume a crashed/failed workflow, skipping completed steps
    (reference: workflow/api.py resume)."""
    store = _WorkflowStore(workflow_id)
    st = store.get_status()
    if st is None:
        raise ValueError(f"No workflow '{workflow_id}' in storage")
    if st["status"] == SUCCESSFUL:
        return store.load_step("__output__")
    dag, args, kwargs = store.load_dag()
    store.set_status(RUNNING)
    try:
        out = _execute_durable(dag, store, args, kwargs, max_retries=3)
    except Exception as e:
        store.set_status(FAILED, error=repr(e))
        raise
    store.save_step("__output__", out)
    store.set_status(SUCCESSFUL)
    return out


def get_output(workflow_id: str) -> Any:
    store = _WorkflowStore(workflow_id)
    st = store.get_status()
    if st is None or not store.has_step("__output__"):
        raise ValueError(f"Workflow '{workflow_id}' has no output "
                         f"(status: {st and st['status']})")
    return store.load_step("__output__")


def get_status(workflow_id: str) -> Optional[str]:
    st = _WorkflowStore(workflow_id).get_status()
    return st["status"] if st else None


def list_all(status_filter: Optional[List[str]] = None) -> List[tuple]:
    """[(workflow_id, status)] (reference: workflow/api.py list_all)."""
    root = _storage()
    out = []
    for wf_id in sorted(os.listdir(root)):
        st = _WorkflowStore(wf_id).get_status()
        if st and (status_filter is None or st["status"] in status_filter):
            out.append((wf_id, st["status"]))
    return out


def cancel(workflow_id: str):
    _WorkflowStore(workflow_id).set_status(CANCELED)


def delete(workflow_id: str):
    path = os.path.join(_storage(), workflow_id)
    shutil.rmtree(path, ignore_errors=True)


from .events import (EventListener, FileEventListener, HTTPEventProvider,
                     TimerListener, deliver_event, wait_for_event)

__all__ = ["CANCELED", "FAILED", "RESUMABLE", "RUNNING", "SUCCESSFUL",
           "EventListener", "FileEventListener", "HTTPEventProvider",
           "TimerListener", "cancel", "delete", "deliver_event",
           "get_output", "get_status", "init", "list_all", "options",
           "resume", "run", "run_async", "wait_for_event"]
