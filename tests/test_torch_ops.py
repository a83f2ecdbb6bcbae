"""The PyTorch port's ops (ray_tpu_torch.ops) held against the JAX package.

Same inputs, drawn with numpy from a fixed seed, go through the JAX
function and its port on the CPU; each test states its tolerance. The
port's CUDA kernels cannot run here (no card, no nvcc): ``chip_smoke.py``
holds them against these same plain versions on the card. Also here: the
port's isolation from JAX and ray_tpu, and its device rule.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu.ops import layers as jlayers
from ray_tpu_torch.ops import _kernels
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import layers as tlayers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    # The shapes here are tiny: two threads lose nothing, and spare the
    # cores that the suite's other test workers share.
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np(x):
    return np.asarray(x.detach().float() if torch.is_tensor(x) else x,
                      np.float32)


class TestLayers:
    def test_rms_norm(self):
        rng = np.random.default_rng(0)
        x, w = _randn(rng, 2, 8, 32), _randn(rng, 32)
        # f32 throughout on both sides: only rounding differs.
        np.testing.assert_allclose(
            _np(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w))),
            np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w))),
            rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("positions", ["offset", "seq", "batch_seq"])
    def test_rope(self, positions):
        rng = np.random.default_rng(1)
        x = _randn(rng, 2, 3, 10, 16)
        kw_j, kw_t = {}, {}
        if positions == "offset":
            kw_j = kw_t = {"position_offset": 5}
        elif positions == "seq":
            pos = np.arange(10) + 17
            kw_j, kw_t = {"positions": jnp.asarray(pos)}, \
                {"positions": torch.from_numpy(pos)}
        else:
            pos = np.arange(10)[None] + np.array([[3], [40]])
            kw_j, kw_t = {"positions": jnp.asarray(pos)}, \
                {"positions": torch.from_numpy(pos)}
        # Angles up to ~50 rad in f32: sin/cos of them agree to ~1e-5.
        np.testing.assert_allclose(
            _np(tlayers.rope(torch.from_numpy(x), **kw_t)),
            np.asarray(jlayers.rope(jnp.asarray(x), **kw_j)),
            rtol=1e-4, atol=2e-5)

    def test_swiglu(self):
        rng = np.random.default_rng(2)
        x, g, u, d = (_randn(rng, 2, 4, 8), _randn(rng, 8, 16),
                      _randn(rng, 8, 16), _randn(rng, 16, 8))
        np.testing.assert_allclose(
            _np(tlayers.swiglu(*map(torch.from_numpy, (x, g, u, d)))),
            np.asarray(jlayers.swiglu(*map(jnp.asarray, (x, g, u, d)))),
            rtol=1e-5, atol=1e-5)


class TestAttentionReference:
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("seq_k", [12, 20])
    def test_mha_reference_matches_jax(self, causal, seq_k):
        rng = np.random.default_rng(3)
        q = _randn(rng, 2, 3, 12, 16)
        k, v = _randn(rng, 2, 3, seq_k, 16), _randn(rng, 2, 3, seq_k, 16)
        # Same f32 math on both sides.
        np.testing.assert_allclose(
            _np(tattn.mha_reference(*map(torch.from_numpy, (q, k, v)),
                                    causal)),
            np.asarray(jattn.mha_reference(*map(jnp.asarray, (q, k, v)),
                                           causal)),
            rtol=1e-5, atol=1e-5)

    def test_mask_value(self):
        assert tattn.DEFAULT_MASK_VALUE == jattn.DEFAULT_MASK_VALUE

    def test_cpu_grad_matches_jax(self):
        rng = np.random.default_rng(4)
        q, k, v = (_randn(rng, 1, 2, 32, 16) for _ in range(3))
        tq, tk, tv = (torch.from_numpy(a).requires_grad_()
                      for a in (q, k, v))
        (tattn.flash_attention(tq, tk, tv, True) ** 2).sum().backward()
        grads = jax.grad(
            lambda *a: jnp.sum(jattn.flash_attention(*a, True, None) ** 2),
            argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
        for t, j in zip((tq.grad, tk.grad, tv.grad), grads):
            # Autograd through the same f32 reference on both sides.
            np.testing.assert_allclose(_np(t), np.asarray(j),
                                       rtol=1e-4, atol=1e-5)


class TestFlashVsPallasInterpret:
    """The port's flash_attention on the CPU (its plain version) against
    the JAX package's real Pallas forward kernel in interpret mode, at the
    JAX package's own kernel-test shapes and its 2e-2 band. The sequence
    is a multiple of 128, or JAX would use its reference instead."""

    @pytest.fixture(autouse=True)
    def _interpret(self, monkeypatch):
        monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")

    @pytest.mark.parametrize("shape,causal", [
        ((1, 2, 256, 64), True),
        ((1, 2, 256, 64), False),
        ((3, 5, 128, 32), True),
    ])
    def test_forward(self, shape, causal):
        assert jattn._kernel_ok(shape[2])
        rng = np.random.default_rng(5)
        q, k, v = (_randn(rng, *shape) for _ in range(3))
        out = tattn.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                    causal)
        ref = jattn.flash_attention(*map(jnp.asarray, (q, k, v)), causal,
                                    None)
        np.testing.assert_allclose(_np(out), np.asarray(ref),
                                   atol=2e-2, rtol=2e-2)


class TestKernelWrapper:
    def test_cpu_tensor_is_refused(self):
        q = torch.zeros(1, 1, 64, 64)
        with pytest.raises(ValueError, match="CUDA"):
            _kernels.flash_fwd(q, q, q, True, 0.125)

    def test_nothing_built_or_counted_on_import(self):
        assert _kernels._libs == {}
        assert set(_kernels.LAUNCHES) == set(_kernels.SOURCES)

    def test_sources_name_the_tpu_kernel_they_replace(self):
        for src in _kernels.SOURCES.values():
            with open(os.path.join(_kernels.CSRC, src)) as f:
                head = f.read(4000)
            assert "Replaces: ray_tpu/ops/attention.py::_fwd_kernel" in head
            assert "sm_90a" in head


_FORBIDDEN = ("jax", "ml_dtypes", "ray_tpu")


def _forbidden(module: str) -> bool:
    # Exact name or a dotted child: "ray_tpu_torch" is not "ray_tpu".
    return any(module == f or module.startswith(f + ".")
               for f in _FORBIDDEN)


class TestIsolation:
    def test_forbidden_matches_exact_names_only(self):
        assert _forbidden("ray_tpu") and _forbidden("ray_tpu.ops")
        assert _forbidden("jax.numpy") and _forbidden("ml_dtypes")
        assert not _forbidden("ray_tpu_torch")
        assert not _forbidden("ray_tpu_torch.ops")
        assert not _forbidden("jaxtyping")

    def test_import_leaves_jax_and_ray_tpu_out(self):
        code = (
            "import sys\n"
            "import ray_tpu_torch, ray_tpu_torch.ops, ray_tpu_torch.models\n"
            "import ray_tpu_torch.models.generate, ray_tpu_torch.llm\n"
            "import ray_tpu_torch.models.convert\n"
            "print('\\n'.join(sys.modules))\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=120,
                             check=True).stdout.split()
        assert "ray_tpu_torch.llm" in out
        assert [m for m in out if _forbidden(m)] == []

    def test_no_forbidden_import_in_source(self):
        files = [os.path.join(REPO, "chip_smoke.py")]
        for root, _, names in os.walk(os.path.join(REPO, "ray_tpu_torch")):
            files += [os.path.join(root, n) for n in names
                      if n.endswith(".py")]
        assert len(files) > 10
        bad = []
        for path in files:
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                else:
                    continue
                bad += [(path, n) for n in names if _forbidden(n)]
        assert bad == []


class TestDeviceRule:
    def test_device_none_needs_cuda(self, monkeypatch):
        from ray_tpu_torch._device import resolve_device
        from ray_tpu_torch.llm import (ContinuousBatchingEngine,
                                       GPTInferenceStage, LLMEngine)
        from ray_tpu_torch.models import GPTConfig, gpt_init

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for make in (resolve_device,
                     lambda: gpt_init(GPTConfig.tiny(), torch.Generator()),
                     LLMEngine, ContinuousBatchingEngine,
                     GPTInferenceStage):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
        assert resolve_device("cpu").type == "cpu"
