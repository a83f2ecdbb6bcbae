"""Compiled DAG execution (reference: dag/compiled_dag_node.py —
CompiledDAG :767, execute :2336).

Compilation wires the static actor-method graph with single-slot mutable
channels (channel.py) and installs a persistent execution loop on every
participating actor. After that, `execute()` is one channel write and
`ref.get()` one channel read — no scheduler, no RPC, no per-call task
submission, which is what removes the reference's per-task overhead
(~ms) from the hot path (their microbench: compiled DAG ~100x faster
than task-per-call).

`fuse_functions` runs a PURE-function graph as one callable in one
process and, with ``jit=True``, replays it on the card as one CUDA graph
per input signature (the counterpart of the JAX package's one
``jax.jit`` program).
"""
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import (ClassMethodNode, DAGNode, FunctionNode, InputAttributeNode,
               InputNode, MultiOutputNode)
from .channel import Channel, ChannelClosedError


class CompiledDAGRef:
    """Result handle for one execute() (reference: compiled_dag_ref.py)."""

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq
        self._value = None
        self._has_value = False

    def get(self, timeout: Optional[float] = 30.0):
        return self._dag._fetch(self, timeout)

    # duck-typed hook for ray_tpu_torch.get
    def _compiled_dag_get(self, timeout):
        return self.get(timeout)


# Per-arg input plan entries for the actor loop
_CONST, _CHAN = 0, 1


def _run_actor_loop(instance, stages):
    """Persistent per-ACTOR execution loop; runs as one long actor task
    (reference: the compiled-DAG worker loop in compiled_dag_node.py
    _execute_until executes the actor's full schedule each iteration).
    `stages` holds this actor's nodes in topo order:
    (method_name, arg_plan, kwarg_plan, channels, out_chan). One loop per
    actor — not per node — so multi-method DAGs need no actor
    concurrency and intra-actor edges resolve within one iteration."""
    bound = [(getattr(instance, m), ap, kp, chans, out)
             for (m, ap, kp, chans, out) in stages]
    try:
        while True:
            stop = False
            for method, arg_plan, kwarg_plan, channels, out_chan in bound:
                try:
                    values = {cid: ch.read()
                              for cid, ch in channels.items()}
                except ChannelClosedError:
                    stop = True
                    break

                def _resolve(kind, payload):
                    if kind == _CONST:
                        return payload
                    cid, key = payload
                    v = values[cid]
                    return v if key is None else v[key]

                args = [_resolve(k, p) for k, p in arg_plan]
                kwargs = {k: _resolve(kind, p)
                          for k, (kind, p) in kwarg_plan.items()}
                upstream_err = next(
                    (v for v in list(args) + list(kwargs.values())
                     if isinstance(v, _WrappedError)), None)
                if upstream_err is not None:
                    out = upstream_err  # forward, don't recompute
                else:
                    try:
                        out = method(*args, **kwargs)
                    except Exception as e:  # ship downstream, keep looping
                        out = _WrappedError(e)
                out_chan.write(out)
            if stop:
                break
    finally:
        for _, _, _, channels, out_chan in bound:
            out_chan.close_writer()
            for ch in channels.values():
                ch.detach()
    return "adag-loop-done"


class _WrappedError:
    def __init__(self, e: Exception):
        self.error = e


class CompiledDAG:
    """Reference: compiled_dag_node.py CompiledDAG."""

    def __init__(self, root: DAGNode, buffer_size_bytes: int = 1 << 20):
        self._root = root
        self._buf = buffer_size_bytes
        self._lock = threading.Lock()
        self._seq = 0
        self._read_seq = 0
        self._torn_down = False
        self._channels: List[Channel] = []
        try:
            self._build()
        except BaseException:
            # A failed compile must not orphan framework-owned helper
            # actors (experimental.collective reducers) or channels.
            import ray_tpu_torch
            for n in root._topo():
                owned = getattr(n, "_owned_actor", None)
                if owned is not None:
                    try:
                        ray_tpu_torch.kill(owned)
                    except Exception:
                        pass
            for ch in self._channels:
                try:
                    ch.destroy()
                except Exception:
                    pass
            raise

    # -- compilation -------------------------------------------------------
    def _build(self):
        topo = self._root._topo()
        loops: List[ClassMethodNode] = []
        self._outputs: List[ClassMethodNode] = []
        for n in topo:
            if isinstance(n, FunctionNode):
                raise ValueError(
                    "experimental_compile supports actor-method DAGs only "
                    "(reference semantics); stateless function DAGs should "
                    "use compile_fused() or dynamic .execute()")
            if isinstance(n, ClassMethodNode):
                loops.append(n)
        if isinstance(self._root, MultiOutputNode):
            for o in self._root._bound_args:
                if not isinstance(o, ClassMethodNode):
                    raise ValueError("MultiOutputNode outputs must be actor "
                                     "method nodes")
                self._outputs.append(o)
        elif isinstance(self._root, ClassMethodNode):
            self._outputs = [self._root]
        else:
            raise ValueError("compiled DAG root must be an actor method "
                             "node or MultiOutputNode")

        # consumer sets: producer node -> [consumer ids]; driver reads
        # terminal outputs, nodes read upstream channels / the input.
        input_consumers: List[ClassMethodNode] = []
        node_consumers: Dict[int, List[ClassMethodNode]] = {}

        def _classify(arg) -> Optional[Tuple]:
            """-> (source, key) where source is 'input' or a node id."""
            if isinstance(arg, InputNode):
                return ("input", None)
            if isinstance(arg, InputAttributeNode):
                return ("input", arg._key)
            if isinstance(arg, ClassMethodNode):
                return (id(arg), None)
            if isinstance(arg, DAGNode):
                raise ValueError(f"Unsupported node in compiled DAG: "
                                 f"{type(arg).__name__}")
            return None

        plans: Dict[int, Tuple[list, dict]] = {}
        for n in loops:
            arg_plan, kwarg_plan = [], {}
            uses_input = False
            ups: List[ClassMethodNode] = []
            for a in n._bound_args:
                c = _classify(a)
                if c is None:
                    arg_plan.append((_CONST, a))
                elif c[0] == "input":
                    uses_input = True
                    arg_plan.append((_CHAN, ("input", c[1])))
                else:
                    ups.append(a)
                    arg_plan.append((_CHAN, (str(c[0]), c[1])))
            for k, a in n._bound_kwargs.items():
                c = _classify(a)
                if c is None:
                    kwarg_plan[k] = (_CONST, a)
                elif c[0] == "input":
                    uses_input = True
                    kwarg_plan[k] = (_CHAN, ("input", c[1]))
                else:
                    ups.append(a)
                    kwarg_plan[k] = (_CHAN, (str(c[0]), c[1]))
            if uses_input:
                input_consumers.append(n)
            # Dedupe: a node binding the same upstream in two argument
            # positions still holds ONE reader slot — counting it twice
            # would inflate num_readers past the attached handles and
            # deadlock the producer's second write.
            for uid in {id(u): u for u in ups}:
                consumers = node_consumers.setdefault(uid, [])
                if n not in consumers:
                    consumers.append(n)
            plans[id(n)] = (arg_plan, kwarg_plan)

        if not input_consumers:
            raise ValueError("compiled DAG must consume an InputNode")

        # Create channels (driver is an extra reader on output channels).
        self._input_chan = Channel(buffer_size=self._buf,
                                   num_readers=len(input_consumers))
        self._channels.append(self._input_chan)
        out_chans: Dict[int, Channel] = {}
        for n in loops:
            consumers = node_consumers.get(id(n), [])
            extra = 1 if n in self._outputs else 0
            ch = Channel(buffer_size=self._buf,
                         num_readers=max(1, len(consumers) + extra))
            out_chans[id(n)] = ch
            self._channels.append(ch)
        # Driver-side read handles (reader index = last slot).
        self._output_chans = [
            out_chans[id(o)].with_reader_index(
                len(node_consumers.get(id(o), [])))
            for o in self._outputs]

        # Assign reader indices and launch loops.
        input_idx = {id(n): i for i, n in enumerate(input_consumers)}
        consumer_idx: Dict[Tuple[int, int], int] = {}
        for pid, consumers in node_consumers.items():
            for i, cnode in enumerate(consumers):
                consumer_idx[(pid, id(cnode))] = i

        # One combined loop PER ACTOR (reference: each actor executes its
        # whole schedule per iteration) — `loops` is topo-ordered, so each
        # actor's stage list is too.
        by_actor: Dict[bytes, Tuple[Any, List[ClassMethodNode]]] = {}
        for n in loops:
            key = n._actor._id.binary()
            by_actor.setdefault(key, (n._actor, []))[1].append(n)
        self._loop_refs = []
        for actor, nodes in by_actor.values():
            stages = []
            for n in nodes:
                arg_plan, kwarg_plan = plans[id(n)]
                chans: Dict[str, Channel] = {}
                if id(n) in input_idx:
                    chans["input"] = self._input_chan.with_reader_index(
                        input_idx[id(n)])
                for pid in {id(u) for u in n._upstream()
                            if isinstance(u, ClassMethodNode)}:
                    chans[str(pid)] = out_chans[pid].with_reader_index(
                        consumer_idx[(pid, id(n))])
                stages.append((n._method_name, arg_plan, kwarg_plan,
                               chans, out_chans[id(n)]))
            ref = actor._actor_method_call(
                "__adag_exec_loop__", (stages,), {}, {})
            self._loop_refs.append(ref)
        # Framework-created helper actors (e.g. experimental.collective
        # reducers) are killed at teardown; user actors never are.
        self._owned_actors = [n._owned_actor for n in loops
                              if getattr(n, "_owned_actor", None)
                              is not None]

    # -- execution ---------------------------------------------------------
    def execute(self, *args, **kwargs) -> CompiledDAGRef:
        with self._lock:
            if self._torn_down:
                raise RuntimeError("compiled DAG was torn down")
            if len(args) == 1 and not kwargs:
                value = args[0]
            elif kwargs and not args:
                value = dict(kwargs)
            else:
                value = tuple(args)
            self._input_chan.write(value, timeout=30.0)
            self._seq += 1
            return CompiledDAGRef(self, self._seq)

    def _fetch(self, ref: CompiledDAGRef, timeout: Optional[float]):
        with self._lock:
            if ref._has_value:
                out = ref._value
            else:
                if ref._seq != self._read_seq + 1:
                    raise RuntimeError(
                        "compiled DAG results must be fetched in execute() "
                        f"order (next is seq {self._read_seq + 1}, asked "
                        f"for {ref._seq})")
                outs = [ch.read(timeout=timeout)
                        for ch in self._output_chans]
                self._read_seq += 1
                out = outs if isinstance(self._root, MultiOutputNode) \
                    else outs[0]
                ref._value, ref._has_value = out, True
        for o in (out if isinstance(out, list) else [out]):
            if isinstance(o, _WrappedError):
                raise o.error
        return out

    def teardown(self):
        with self._lock:
            if self._torn_down:
                return
            self._torn_down = True
            self._input_chan.close_writer()
            import ray_tpu_torch
            for ref in self._loop_refs:
                try:
                    ray_tpu_torch.get(ref, timeout=5.0)
                except Exception:
                    pass
            for ch in self._channels:
                ch.destroy()
            for a in getattr(self, "_owned_actors", []):
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass

    def __del__(self):
        try:
            self.teardown()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Fused path
# ---------------------------------------------------------------------------
def fuse_functions(root: DAGNode, jit: bool = True):
    """Fuse a pure-function DAG into one callable.

    ``jit=False`` runs the nodes' functions in order, in this process.
    ``jit=True`` makes the whole DAG one device program, as ``jax.jit``
    does in the JAX package: a ``CudaGraphed`` callable that captures
    the DAG into one CUDA graph per input signature and replays it.
    Inputs that hold no CUDA tensor run the nodes in order (eager torch
    has no device program on the CPU).
    """
    topo = root._topo()
    for n in topo:
        if isinstance(n, ClassMethodNode):
            raise ValueError("compile_fused supports pure-function DAGs; "
                             "actor DAGs need experimental_compile()")

    def fused(*input_args, **input_kwargs):
        cache: Dict[int, Any] = {}
        for node in topo:
            if isinstance(node, InputNode):
                cache[id(node)] = node._exec_one(cache, input_args,
                                                 input_kwargs)
            elif isinstance(node, InputAttributeNode):
                cache[id(node)] = node._exec_one(cache, input_args,
                                                 input_kwargs)
            elif isinstance(node, FunctionNode):
                args = [node._resolve(cache, a) for a in node._bound_args]
                kwargs = {k: node._resolve(cache, v)
                          for k, v in node._bound_kwargs.items()}
                cache[id(node)] = node._remote_fn._fn(*args, **kwargs)
            elif isinstance(node, MultiOutputNode):
                cache[id(node)] = tuple(
                    node._resolve(cache, o) for o in node._bound_args)
            else:
                raise ValueError(f"Unsupported node {type(node).__name__}")
        return cache[id(root)]

    return CudaGraphed(fused) if jit else fused


def signature(leaves, spec):
    """The graph-cache key of one call, from its flattened arguments
    (``torch.utils._pytree.tree_flatten((args, kwargs))``): the tree
    structure, each tensor leaf's shape, dtype and device, and the type
    and value of every other leaf (which must be hashable, as a static
    argument of ``jax.jit`` must)."""
    import torch

    return (spec, tuple(
        (tuple(x.shape), x.dtype, x.device)
        if isinstance(x, torch.Tensor) else (type(x), x) for x in leaves))


class _Captured:
    """One input signature's CUDA graph: the static input leaves it reads,
    the outputs it writes, and the kernel launches it replays."""

    __slots__ = ("graph", "inputs", "outputs", "launches")

    def __init__(self, graph, inputs, outputs, launches):
        self.graph, self.inputs = graph, inputs
        self.outputs, self.launches = outputs, launches


class CudaGraphed:
    """A function of tensors run as CUDA graphs (``fuse_functions(jit=
    True)``), the counterpart of ``jax.jit``: one graph per input
    signature, as jit retraces per signature. The signature is the
    pytree structure of the arguments, each tensor leaf's shape, dtype
    and device, and the value of every other leaf.

    First call of a signature: the arguments are copied into static
    buffers, the function runs once on a side stream (warm-up: cuBLAS
    handles, the kernels' libraries and attributes), then is captured
    into a graph with a private memory pool. Every call copies its
    tensors into the static buffers, replays the graph on the current
    stream and returns clones of the outputs (JAX returns fresh arrays,
    and the next replay overwrites the graph's own). The graph runs
    without autograd. A function that syncs with the host under capture
    (``.item()``, ``.cpu()``, a branch on a tensor's value) raises, as a
    traced value does under ``jax.jit``; the call never falls back to
    running eagerly. Replays add the port's kernel launches seen at
    capture to ``ops._kernels.LAUNCHES`` (the capture itself launches
    nothing).

    Arguments with no CUDA tensor call the function as it is, eagerly.
    """

    def __init__(self, fn):
        self.fn = fn
        self.graphs: Dict[Any, _Captured] = {}
        self.capture_s: Dict[Any, float] = {}
        self._lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        import torch
        from torch.utils import _pytree

        leaves, spec = _pytree.tree_flatten((args, kwargs))
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        if not any(t.is_cuda for t in tensors):
            return self.fn(*args, **kwargs)
        devices = {t.device for t in tensors}
        if len(devices) != 1:
            raise ValueError("a CUDA graph takes tensors on one CUDA "
                             f"device; got {sorted(map(str, devices))}")
        key = signature(leaves, spec)
        with self._lock:
            cap = self.graphs.get(key)
            if cap is None:
                t0 = time.perf_counter()
                with torch.cuda.device(tensors[0].device):
                    cap = self.graphs[key] = self._capture(leaves, spec)
                self.capture_s[key] = time.perf_counter() - t0
            for static, x in zip(cap.inputs, leaves):
                if isinstance(x, torch.Tensor):
                    static.copy_(x)
            cap.graph.replay()
            from ..ops import _kernels
            for name, n in cap.launches.items():
                _kernels.LAUNCHES[name] += n
            return _pytree.tree_map(
                lambda y: y.clone() if isinstance(y, torch.Tensor) else y,
                cap.outputs)

    def _capture(self, leaves, spec) -> _Captured:
        import torch
        from torch.utils import _pytree

        from ..ops import _kernels

        inputs = [x.detach().clone() if isinstance(x, torch.Tensor) else x
                  for x in leaves]
        args, kwargs = _pytree.tree_unflatten(inputs, spec)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.no_grad():
            with torch.cuda.stream(side):
                self.fn(*args, **kwargs)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            before = dict(_kernels.LAUNCHES)
            try:
                with torch.cuda.graph(graph):
                    outputs = self.fn(*args, **kwargs)
            except RuntimeError as e:
                raise RuntimeError(
                    "the fused DAG cannot be captured as a CUDA graph (a "
                    "host sync such as .item() or .cpu(), or a branch on a "
                    f"tensor's value, under capture?): {e}") from e
            finally:  # the wrappers counted launches that only recorded
                launches = {n: _kernels.LAUNCHES[n] - before.get(n, 0)
                            for n in _kernels.LAUNCHES}
                _kernels.LAUNCHES.update(before)
        return _Captured(graph, inputs, outputs,
                         {n: k for n, k in launches.items() if k})
