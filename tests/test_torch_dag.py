"""The port's fused DAG (``compile_fused``, ``dag/compiled.py::
fuse_functions``) against the JAX package's on the CPU.

``jit=True`` is one ``jax.jit`` program in the JAX package and one CUDA
graph per input signature in the port (``CudaGraphed``). Inputs that
hold no CUDA tensor run the nodes in order, which is how these tests run
it; ``chip_smoke.py`` captures and replays the graph on the card. The
graph cache is keyed as jit retraces: one entry per structure, tensor
shape, dtype and device, and value of every other leaf.
"""
import numpy as np
import pytest
import torch
from torch.utils import _pytree

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu.dag import InputNode as JInputNode
from ray_tpu_torch.dag import InputNode
from ray_tpu_torch.dag.compiled import CudaGraphed, signature


def _scale_shift(remote, input_node):
    @remote
    def scale(x):
        return x * 2.0

    @remote
    def shift(x):
        return x + 1.0

    with input_node() as inp:
        return shift.bind(scale.bind(inp))


def test_fuse_functions_matches_jax():
    import jax.numpy as jnp

    x = np.arange(8.0, dtype=np.float32)
    theirs = _scale_shift(ray_tpu.remote, JInputNode).compile_fused(
        jit=True)(jnp.asarray(x))
    fused = _scale_shift(rt.remote, InputNode).compile_fused(jit=True)
    assert isinstance(fused, CudaGraphed)
    ours = fused(torch.from_numpy(x))
    assert isinstance(ours, torch.Tensor)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs))
    np.testing.assert_allclose(ours.numpy(), x * 2.0 + 1.0)
    assert fused.graphs == {}  # the CPU route captures nothing
    unfused = _scale_shift(rt.remote, InputNode).compile_fused(jit=False)
    assert torch.equal(unfused(torch.from_numpy(x)), ours)


def _key(*args, **kwargs):
    return signature(*_pytree.tree_flatten((args, kwargs)))


def test_signature_cache_has_one_entry_per_shape_and_dtype():
    calls = [torch.zeros(2, 3), torch.ones(2, 3),          # same entry
             torch.zeros(3, 2), torch.zeros(2, 3, dtype=torch.bfloat16),
             torch.zeros(2, 3, dtype=torch.int64), torch.zeros(2, 3)]
    keys = {_key(t) for t in calls}
    assert len(keys) == 4
    assert _key(torch.zeros(2, 3)) == _key(torch.full((2, 3), 7.0))


def test_signature_keys_structure_and_other_leaves_by_value():
    t = torch.zeros(4)
    assert _key(t, 1) == _key(torch.ones(4), 1)
    assert _key(t, 1) != _key(t, 2)
    assert _key(t, 1) != _key(t, 1.0)          # type, as jit's weak types
    assert _key(t, scale=2) != _key(t, 2)      # keyword vs positional
    assert _key([t, t]) != _key((t, t))        # the tree's structure
    assert _key({"a": t}) != _key({"b": t})


def test_int_inputs_run_in_order():
    fused = _scale_shift(rt.remote, InputNode).compile_fused()
    assert fused(3) == 7.0 and fused.graphs == {}
