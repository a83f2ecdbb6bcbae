"""ray_tpu_torch.dag — lazy task/actor DAGs and compiled graphs.

Reference parity: python/ray/dag/ — DAGNode hierarchy (dag_node.py,
function_node.py, class_node.py, input_node.py, output_node.py),
`.bind(...)` building, `.execute(...)` dynamic execution, and
`experimental_compile()` -> CompiledDAG (compiled_dag_node.py:767) which
executes the static graph repeatedly over mutable channels with no
per-call scheduling.

`compile_fused()` fuses a pure-function DAG into one callable and, with
`jit=True` (the default), replays it on the card as one CUDA graph per
input signature — the counterpart of the JAX package's one `jax.jit`
program; inputs without a CUDA tensor run the nodes in order.

    with InputNode() as inp:
        x = preprocess.bind(inp)
        out = actor.fwd.bind(x)
    compiled = out.experimental_compile()
    for batch in data:
        print(ray_tpu_torch.get(compiled.execute(batch)))
"""
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from .channel import Channel, ChannelClosedError, IntraProcessChannel

_input_node_ctx: List["InputNode"] = []


class DAGNode:
    """Base lazy node (reference: dag/dag_node.py DAGNode)."""

    def __init__(self, args: tuple, kwargs: dict):
        self._bound_args = args
        self._bound_kwargs = kwargs

    # -- traversal ---------------------------------------------------------
    def _upstream(self) -> List["DAGNode"]:
        ups = [a for a in self._bound_args if isinstance(a, DAGNode)]
        ups += [v for v in self._bound_kwargs.values()
                if isinstance(v, DAGNode)]
        return ups

    def _topo(self) -> List["DAGNode"]:
        order: List[DAGNode] = []
        seen = set()

        def visit(n: "DAGNode"):
            if id(n) in seen:
                return
            seen.add(id(n))
            for u in n._upstream():
                visit(u)
            order.append(n)

        visit(self)
        return order

    # -- dynamic execution (reference: dag_node.py execute) ---------------
    def execute(self, *input_args, **input_kwargs):
        cache: Dict[int, Any] = {}
        for node in self._topo():
            cache[id(node)] = node._exec_one(cache, input_args, input_kwargs)
        return cache[id(self)]

    def _resolve(self, cache, v):
        return cache[id(v)] if isinstance(v, DAGNode) else v

    def _exec_one(self, cache, input_args, input_kwargs):
        raise NotImplementedError

    def experimental_compile(self, buffer_size_bytes: int = 1 << 20,
                             ) -> "CompiledDAG":
        from .compiled import CompiledDAG
        return CompiledDAG(self, buffer_size_bytes)

    def compile_fused(self, jit: bool = True):
        """Fuse a pure-function DAG into one callable — with ``jit=True``
        one CUDA graph per input signature (``compiled.CudaGraphed``),
        the counterpart of the JAX package's one jitted program (net-new
        vs the reference)."""
        from .compiled import fuse_functions
        return fuse_functions(self, jit=jit)


class InputNode(DAGNode):
    """The DAG's runtime input (reference: dag/input_node.py)."""

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        _input_node_ctx.append(self)
        return self

    def __exit__(self, *exc):
        _input_node_ctx.pop()

    def __getitem__(self, key) -> "InputAttributeNode":
        return InputAttributeNode(self, key)

    def _exec_one(self, cache, input_args, input_kwargs):
        if len(input_args) == 1 and not input_kwargs:
            return input_args[0]
        if input_kwargs and not input_args:
            return dict(input_kwargs)
        return tuple(input_args)


class InputAttributeNode(DAGNode):
    """inp[key] / inp.attr access (reference: dag/input_node.py
    InputAttributeNode)."""

    def __init__(self, parent: InputNode, key):
        super().__init__((parent,), {})
        self._key = key

    def _exec_one(self, cache, input_args, input_kwargs):
        base = cache[id(self._bound_args[0])]
        if isinstance(self._key, int) and isinstance(base, tuple):
            return base[self._key]
        return base[self._key]


class FunctionNode(DAGNode):
    """A bound @remote function call (reference: dag/function_node.py)."""

    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn

    def _exec_one(self, cache, input_args, input_kwargs):
        args = [self._resolve(cache, a) for a in self._bound_args]
        kwargs = {k: self._resolve(cache, v)
                  for k, v in self._bound_kwargs.items()}
        return self._remote_fn.remote(*args, **kwargs)


class ClassMethodNode(DAGNode):
    """A bound actor method call (reference: dag/class_node.py)."""

    def __init__(self, actor_handle, method_name: str, args, kwargs):
        super().__init__(args, kwargs)
        self._actor = actor_handle
        self._method_name = method_name

    def _exec_one(self, cache, input_args, input_kwargs):
        args = [self._resolve(cache, a) for a in self._bound_args]
        kwargs = {k: self._resolve(cache, v)
                  for k, v in self._bound_kwargs.items()}
        return getattr(self._actor, self._method_name).remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """Multiple DAG outputs (reference: dag/output_node.py)."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs), {})

    def _exec_one(self, cache, input_args, input_kwargs):
        return [self._resolve(cache, o) for o in self._bound_args]


__all__ = [
    "Channel", "ChannelClosedError", "ClassMethodNode", "DAGNode",
    "FunctionNode", "InputAttributeNode", "InputNode", "IntraProcessChannel",
    "MultiOutputNode",
]
