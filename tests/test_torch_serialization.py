"""The port's object store with torch tensors, held against the JAX
package's with jax arrays.

``ray_tpu`` brings a device array to host before it is pickled
(``_private/serialization.py::_to_host``): the store holds CPU bytes,
out of band, and ``get`` gives a host array back. The port does the same
for a top-level ``torch.Tensor`` on any device: its bytes go out of band
(a CPU tensor as a numpy view of its storage, bf16 as int16 with its
dtype recorded), and ``get`` gives back a CPU tensor of the same dtype
and shape. The same numpy values go through both packages' clusters;
the values that come back must be equal.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu_torch._private import serialization

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


@pytest.fixture(scope="module")
def clusters():
    ray_tpu.init(num_cpus=2, ignore_reinit_error=True)
    rt.init(num_cpus=2)
    yield
    rt.shutdown()
    ray_tpu.shutdown()


def _values(kind, n):
    """(numpy values, the torch tensor of them, the jnp array of them)."""
    rng = np.random.default_rng(n)
    if kind == "int64":
        a = rng.integers(-1000, 1000, (n, 3))
        return a, torch.from_numpy(a.copy()), jnp.asarray(a)
    a = rng.standard_normal((n, 4)).astype(np.float32)
    if kind == "float32":
        return a, torch.from_numpy(a.copy()), jnp.asarray(a)
    if kind == "bfloat16":
        return (a, torch.from_numpy(a.copy()).to(torch.bfloat16),
                jnp.asarray(a).astype(jnp.bfloat16))
    # non-contiguous: the transpose of a [4, n] tensor
    t = torch.from_numpy(np.ascontiguousarray(a.T)).T
    assert not t.is_contiguous()
    return a, t, jnp.asarray(a)


@pytest.mark.parametrize("n", [8, 20000], ids=["inline", "shared-memory"])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int64",
                                  "non-contiguous"])
def test_put_get_matches_the_jax_package(clusters, kind, n):
    _, tensor, array = _values(kind, n)
    ours = rt.get(rt.put(tensor), timeout=TIMEOUT)
    theirs = ray_tpu.get(ray_tpu.put(array), timeout=TIMEOUT)
    assert isinstance(ours, torch.Tensor) and ours.device.type == "cpu"
    assert ours.dtype == tensor.dtype and ours.shape == tensor.shape
    # JAX without x64 holds int64 values as int32.
    want = {"int64": "int32"}.get(kind, str(tensor.dtype).split(".")[-1])
    assert str(np.asarray(theirs).dtype) == want
    np.testing.assert_array_equal(ours.float().numpy(),
                                  np.asarray(theirs).astype(np.float32))
    assert torch.equal(ours, tensor)


@pytest.mark.parametrize("kind", ["float32", "bfloat16"])
def test_a_task_reads_the_tensor(clusters, kind):
    _, tensor, _ = _values(kind, 20000)

    @rt.remote
    def describe(t):
        return (type(t).__name__, str(t.device), str(t.dtype),
                tuple(t.shape), t)

    name, device, dtype, shape, back = rt.get(
        describe.remote(rt.put(tensor)), timeout=TIMEOUT)
    assert (name, device, dtype, shape) == (
        "Tensor", "cpu", str(tensor.dtype), tuple(tensor.shape))
    assert torch.equal(back, tensor)


def test_payload_goes_out_of_band_without_a_copy():
    t = torch.arange(4096, dtype=torch.float32)
    sobj = serialization.serialize(t)
    assert len(sobj.buffers) == 1
    buf = np.frombuffer(sobj.buffers[0], np.uint8)
    assert buf.nbytes == t.numel() * 4
    assert buf.ctypes.data == t.data_ptr()  # a view of the storage
    back = serialization.deserialize(sobj.to_bytes())
    assert torch.equal(back, t)


def test_bf16_travels_as_int16_with_its_dtype():
    t = torch.linspace(-3, 3, 7).to(torch.bfloat16)
    host = serialization._to_host(t)
    assert host.array.dtype == np.int16 and host.dtype == "bfloat16"
    assert len(serialization.serialize(t).buffers) == 1
    back = serialization.deserialize(serialization.serialize(t).to_bytes())
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)


def test_grad_flag_and_zero_dim_survive():
    leaf = torch.randn(5, requires_grad=True)
    back = serialization.deserialize(
        serialization.serialize(leaf).to_bytes())
    assert back.requires_grad and torch.equal(back.detach(), leaf.detach())
    scalar = torch.tensor(2.5, dtype=torch.bfloat16)
    back = serialization.deserialize(
        serialization.serialize(scalar).to_bytes())
    assert back.shape == () and torch.equal(back, scalar)


def test_nested_tensors_keep_torchs_pickling():
    # _to_host leaves a container as it is: the pickler brings each
    # tensor it meets inside to host (test_nested_tensors_go_to_host).
    value = {"t": torch.arange(6).reshape(2, 3), "n": [torch.ones(2)]}
    assert serialization._to_host(value) is value
    back = serialization.deserialize(
        serialization.serialize(value).to_bytes())
    assert torch.equal(back["t"], value["t"])
    assert torch.equal(back["n"][0], value["n"][0])


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int64",
                                  "non-contiguous"])
def test_nested_tensors_go_to_host(kind):
    # Each tensor nested in a container goes out of band as a top-level
    # one does, so a CUDA tensor in a dict of weights reaches a reader
    # without a card as a CPU tensor.
    _, tensor, _ = _values(kind, 300)
    value = {"w": tensor, "rest": [tensor[:2], {"b": tensor[1]}], "n": 3}
    sobj = serialization.serialize(value)
    assert len(sobj.buffers) == 3
    back = serialization.deserialize(sobj.to_bytes())
    for got, want in ((back["w"], tensor), (back["rest"][0], tensor[:2]),
                      (back["rest"][1]["b"], tensor[1])):
        assert type(got) is torch.Tensor and got.device.type == "cpu"
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert back["n"] == 3


@pytest.mark.parametrize("kind", ["float32", "bfloat16"])
def test_nested_tensors_match_nested_jax_arrays(clusters, kind):
    # The same values nested in the same dict through both packages'
    # stores and a task of each: equal values. A nested jax.Array is
    # rebuilt on the reader's default device (jax's own pickling), a
    # nested tensor on the CPU.
    _, tensor, array = _values(kind, 20000)

    def describe(value):
        w = value["w"]
        return type(w).__module__.split(".")[0], np.asarray(
            w.float() if hasattr(w, "float") else w.astype(np.float32))

    ours = rt.get(rt.remote(describe).remote(rt.put({"w": tensor})),
                  timeout=TIMEOUT)
    theirs = ray_tpu.get(ray_tpu.remote(describe).remote(
        ray_tpu.put({"w": array})), timeout=TIMEOUT)
    assert (ours[0], theirs[0]) == ("torch", "jaxlib")
    np.testing.assert_array_equal(ours[1], theirs[1])


def test_to_host_does_not_import_torch():
    # Lean workers boot without torch: a value cannot be a tensor unless
    # torch is already loaded, so the store must not load it.
    code = ("import sys\n"
            "import numpy as np\n"
            "from ray_tpu_torch._private import serialization as s\n"
            "for v in (np.zeros(3), {'a': 1}, b'x' * 200000, 'text'):\n"
            "    s.deserialize(s.serialize(v).to_bytes())\n"
            "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=TIMEOUT,
                         check=True).stdout.strip()
    assert out == "False"


def test_a_half_imported_torch_is_not_consulted():
    # A task's `import torch` may be under way in one thread while
    # another serializes a reply: a module without `Tensor` yet holds
    # no tensor, and serializing must not fail on it.
    code = ("import sys, types\n"
            "sys.modules['torch'] = types.ModuleType('torch')\n"
            "from ray_tpu_torch._private import serialization as s\n"
            "print(s.deserialize(s.serialize({'a': [1, 2]}).to_bytes()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=TIMEOUT,
                         check=True).stdout.strip()
    assert out == "{'a': [1, 2]}"
