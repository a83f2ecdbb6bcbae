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


def _norm_case(seed, layout, dtype):
    """x (its full tensor and the rows normed), w f32 and a cotangent for
    the normed rows, as torch tensors: ``rows`` norms a [3, 5, 64] tensor;
    ``cls`` the CLS rows x[:, 0] of a [4, 6, 64] one (stride S*D, as ViT's
    final norm). bf16 inputs are rounded once here, so both packages see
    the same bits."""
    rng = np.random.default_rng(seed)
    full = torch.from_numpy(_randn(rng, *((4, 6, 64) if layout == "cls"
                                          else (3, 5, 64)))).to(dtype)
    w = torch.from_numpy(1.0 + 0.2 * _randn(rng, 64))
    shape = (4, 64) if layout == "cls" else (3, 5, 64)
    g = torch.from_numpy(_randn(rng, *shape)).to(dtype)
    return full, w, g


def _norm_rows(full, layout):
    return full[:, 0] if layout == "cls" else full


def _jnp(t):
    return jnp.asarray(_np(t)).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


# Band of each dtype: f32 differs by the order of sums; bf16 outputs and
# input gradients by a rounding step at most (2^-8 of the largest value).
_NORM_TOL = {torch.float32: 2e-6, torch.bfloat16: 8e-3}


class TestRMSNorm:
    """``rms_norm``'s two paths held against ``jax.vjp`` of the JAX
    package's ``rms_norm``: the plain version with autograd (a CPU
    tensor's path), the kernels' backward arithmetic
    (``rms_norm_bwd_reference``), and ``_RMSNorm`` (the CUDA path) run on
    CPU tensors with its kernels replaced by those plain versions."""

    CASES = [(layout, dtype) for layout in ("rows", "cls")
             for dtype in (torch.float32, torch.bfloat16)]

    def _jax(self, full, w, g, layout):
        def f(a, b):
            return jlayers.rms_norm(a[:, 0] if layout == "cls" else a, b)

        y, vjp = jax.vjp(f, _jnp(full), jnp.asarray(_np(w)))
        dx, dw = vjp(_jnp(g))
        return y, dx, dw

    @pytest.mark.parametrize("layout,dtype", CASES)
    def test_plain_matches_jax_vjp(self, layout, dtype):
        full, w, g = _norm_case(3, layout, dtype)
        full.requires_grad_(True)
        w.requires_grad_(True)
        y = tlayers.rms_norm(_norm_rows(full, layout), w)
        dx, dw = torch.autograd.grad(y, (full, w), g)
        y_j, dx_j, dw_j = self._jax(full.detach(), w.detach(), g, layout)
        tol = _NORM_TOL[dtype]
        assert y.dtype == dtype and dx.dtype == dtype
        assert dw.dtype == torch.float32
        assert _grad_err(y, y_j) <= tol
        assert _grad_err(dx, dx_j) <= tol
        assert _grad_err(dw, dw_j) <= 1e-5

    @pytest.mark.parametrize("layout,dtype", CASES)
    def test_bwd_reference_matches_jax_vjp(self, layout, dtype):
        full, w, g = _norm_case(4, layout, dtype)
        dx, dw = tlayers.rms_norm_bwd_reference(_norm_rows(full, layout), w,
                                                g)
        _, dx_j, dw_j = self._jax(full, w, g, layout)
        dx_full = torch.zeros_like(full)
        _norm_rows(dx_full, layout).copy_(dx)
        assert dx.dtype == dtype and dw.dtype == torch.float32
        assert _grad_err(dx_full, dx_j) <= _NORM_TOL[dtype]
        assert _grad_err(dw, dw_j) <= 1e-5

    @pytest.mark.parametrize("layout,dtype", CASES)
    def test_kernel_path_matches_jax_vjp(self, monkeypatch, layout, dtype):
        seen = {}

        def fwd(x, weight, eps):
            seen["x"] = x
            rstd = torch.rsqrt(x.float().square().mean(-1) + eps)
            return tlayers._rms_norm(x, weight, eps), rstd.reshape(-1)

        def bwd(x, weight, rstd, grad):
            seen["bwd"] = (x, rstd)
            return tlayers.rms_norm_bwd_reference(x, weight, grad)

        monkeypatch.setattr(_kernels, "rms_norm_fwd", fwd)
        monkeypatch.setattr(_kernels, "rms_norm_bwd", bwd)
        full, w, g = _norm_case(5, layout, dtype)
        full.requires_grad_(True)
        w.requires_grad_(True)
        y = tlayers._RMSNorm.apply(_norm_rows(full, layout), w, 1e-6)
        dx, dw = torch.autograd.grad(y, (full, w), g)
        y_j, dx_j, dw_j = self._jax(full.detach(), w.detach(), g, layout)
        # The backward gets the forward's own x (no copy) and rstd.
        assert seen["bwd"][0].data_ptr() == seen["x"].data_ptr()
        assert seen["bwd"][0].stride() == seen["x"].stride()
        assert seen["bwd"][1].dtype == torch.float32
        assert _grad_err(y, y_j) <= _NORM_TOL[dtype]
        assert _grad_err(dx, dx_j) <= _NORM_TOL[dtype]
        assert _grad_err(dw, dw_j) <= 1e-5


def _old_qkv_chain(qkv, head_dim):
    """The GPT and MoE blocks' split before qkv_heads: split, reshape,
    transpose, rope on q and k, .contiguous() on v."""
    b, s, _ = qkv.shape
    q, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)
    h = q.shape[-1] // head_dim
    q = tlayers.rope(q.reshape(b, s, h, head_dim).transpose(1, 2))
    k = tlayers.rope(k.reshape(b, s, h, head_dim).transpose(1, 2))
    return q, k, v.reshape(b, s, h, head_dim).transpose(1, 2).contiguous()


def _qkv_kernel_fwd(qkv, head_dim, cos, sin):
    """qkv_rope_fwd's arithmetic in plain torch, from the tables it is
    given: x1 cos - x2 sin and x2 cos + x1 sin in f32, each product
    rounded, then one rounding to the dtype."""
    b, s, width = qkv.shape
    heads = qkv.reshape(b, s, 3, width // (3 * head_dim), head_dim)

    def rotate(x):
        x1, x2 = x.float().chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         dim=-1).to(x.dtype)

    q, k, v = (heads[:, :, i].transpose(1, 2) for i in range(3))
    return rotate(q), rotate(k), v.contiguous()


class TestQKVHeads:
    """``qkv_heads`` held to the chain it replaces in the GPT and MoE
    blocks, bit for bit, forward and autograd: its plain path (a CPU
    tensor's), and ``_QKVHeads`` (the CUDA path) run on CPU tensors with
    its kernels replaced by their arithmetic in plain torch
    (``qkv_heads_bwd_reference`` for the backward) on the cached rope
    tables. The JAX parity of that chain is held by the GPT and MoE
    model tests."""

    # (batch, seq, heads, head_dim): the tiny GPT config's 4 heads of 16,
    # a tp=2 rank's 2 of them, and head dims 64 and 128.
    SHAPES = [(2, 12, 4, 16), (2, 12, 2, 16), (2, 10, 3, 64), (1, 9, 2, 128)]
    CASES = [(shape, dtype) for shape in SHAPES
             for dtype in (torch.float32, torch.bfloat16)]

    @pytest.mark.parametrize("shape,dtype", CASES)
    def test_paths_match_the_chain_bit_for_bit(self, monkeypatch, shape,
                                               dtype):
        b, s, h, d = shape
        rng = np.random.default_rng(sum(shape))
        qkv = torch.from_numpy(_randn(rng, b, s, 3 * h * d)).to(dtype)
        grads = [torch.from_numpy(_randn(rng, b, h, s, d)).to(dtype)
                 for _ in range(3)]

        def run(split):
            x = qkv.clone().requires_grad_()
            out = split(x, d)
            dx, = torch.autograd.grad(out, x, grads)
            return [t.detach() for t in out], dx

        want, dwant = run(_old_qkv_chain)
        tables = tlayers._rope_tables(s, d, qkv.device)
        seen = []

        def fwd(x, head_dim, cos, sin):
            seen.append((cos, sin))
            return _qkv_kernel_fwd(x, head_dim, cos, sin)

        monkeypatch.setattr(_kernels, "qkv_rope_fwd", fwd)
        monkeypatch.setattr(_kernels, "qkv_rope_bwd",
                            tlayers.qkv_heads_bwd_reference)
        for split in (tlayers.qkv_heads, tlayers._QKVHeads.apply):
            got, dgot = run(split)
            for t, w in zip(got, want):
                assert t.dtype == dtype and t.shape == (b, h, s, d)
                assert t.is_contiguous() and torch.equal(t, w)
            assert dgot.dtype == dtype and torch.equal(dgot, dwant)
        # The Function's forward read the cached tables, made once.
        assert len(seen) == 1 and all(
            a is t for a, t in zip(seen[0], tables))
        assert tlayers._rope_tables(s, d, qkv.device)[0] is tables[0]
        assert torch.equal(tlayers.qkv_heads_bwd_reference(*grads, *tables),
                           dwant)


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


def _lse(q, k, causal, scale):
    """logsumexp of the scaled, masked f32 logits: the forward's lse."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        mask = torch.ones(q.shape[-2], k.shape[-2], dtype=torch.bool).tril()
        s = torch.where(mask, s, tattn.DEFAULT_MASK_VALUE)
    return torch.logsumexp(s, dim=-1)


def _bwd_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return [_randn(rng, *shape) for _ in range(4)]  # q, k, v, dO


def _bwd_reference(q, k, v, do, causal):
    """flash_bwd_reference on torch tensors, from the forward's o and lse."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    o = tattn.mha_reference(q, k, v, causal, scale)
    return tattn.flash_bwd_reference(q, k, v, o, _lse(q, k, causal, scale),
                                     do, causal, scale)


class TestFlashBackwardReference:
    """``flash_bwd_reference``, the plain version of the CUDA backward
    kernels (K2, K3), against the JAX package's Pallas backward kernels in
    interpret mode and against autograd through ``mha_reference``."""

    @pytest.mark.parametrize("shape,causal", [
        ((1, 2, 256, 64), True),
        ((1, 2, 256, 64), False),
        ((3, 5, 128, 32), True),
    ])
    def test_matches_pallas_interpret(self, monkeypatch, shape, causal):
        monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")
        assert jattn._kernel_ok(shape[2])
        q, k, v, do = _bwd_inputs(6, shape)
        _, vjp = jax.vjp(
            lambda a, b, c: jattn.flash_attention(a, b, c, causal, None),
            *map(jnp.asarray, (q, k, v)))
        ref = vjp(jnp.asarray(do))
        out = _bwd_reference(*map(torch.from_numpy, (q, k, v, do)), causal)
        for t, j in zip(out, ref):
            j = np.asarray(j)
            # The JAX package's own band for its kernel gradients
            # (tests/test_models_ops.py), after max(1, max|ref|).
            err = np.abs(_np(t) - j).max() / max(1.0, np.abs(j).max())
            assert err <= 6e-3, err

    @pytest.mark.parametrize("shape,causal", [
        ((1, 2, 64, 64), True),
        ((1, 2, 64, 64), False),
        ((2, 3, 200, 32), True),     # ragged S (not a multiple of 64)
        ((2, 3, 200, 32), False),
        ((2, 2, 96, 16), True),      # head_dim 16
    ])
    def test_matches_autograd(self, shape, causal):
        q, k, v, do = map(torch.from_numpy, _bwd_inputs(7, shape))
        out = _bwd_reference(q, k, v, do, causal)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        ref = torch.autograd.grad(
            tattn.mha_reference(*leaves, causal), leaves, do)
        for t, r in zip(out, ref):
            # f32 both: the same products, softmax through lse instead of
            # its own normalization (measured ~3e-7 of max|ref|).
            assert t.dtype == torch.float32
            err = float((t - r).abs().max() / r.abs().max())
            assert err <= 1e-5, err

    @pytest.mark.parametrize("shape,dtype,causal", [
        ((2, 3, 200, 32), torch.float32, True),     # ragged S
        ((1, 2, 64, 32), torch.bfloat16, True),
        ((2, 2, 96, 16), torch.float32, False),
    ])
    def test_dkv_reference_reads_the_delta_it_is_given(self, shape, dtype,
                                                       causal):
        q, k, v, do = (torch.from_numpy(a).to(dtype)
                       for a in _bwd_inputs(10, shape))
        scale = 1.0 / np.sqrt(shape[-1])
        o = tattn.mha_reference(q, k, v, causal, scale)
        lse = _lse(q, k, causal, scale)
        dq, delta = tattn.flash_bwd_dq_reference(q, k, v, o, do, lse,
                                                 causal, scale)
        assert dq.dtype == dtype
        assert delta.dtype == torch.float32 and delta.shape == shape[:3]
        assert torch.equal(delta, (do.float() * o.float()).sum(-1))
        dk, dv = tattn.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                               causal, scale)
        dk2, dv2 = tattn.flash_bwd_dkv_reference(q, k, v, do, lse,
                                                 delta + 1.0, causal, scale)
        # dV = Pᵀ dO does not depend on delta; dK = dSᵀ Q does.
        assert dk.dtype == dv.dtype == dtype
        assert torch.equal(dv, dv2) and not torch.equal(dk, dk2)

    def test_bf16_rounds_like_the_kernels(self):
        q, k, v, do = (torch.from_numpy(a).bfloat16()
                       for a in _bwd_inputs(8, (1, 2, 64, 32)))
        out = _bwd_reference(q, k, v, do, True)
        ref = _bwd_reference(*(x.float() for x in (q, k, v, do)), True)
        for t, r in zip(out, ref):
            assert t.dtype == torch.bfloat16
            # P and dS rounded to bf16 before their products, each
            # gradient rounded once more: a few bf16 ulps (2**-8).
            err = float((t.float() - r).abs().max() / r.abs().max())
            assert 0 < err <= 3e-2, err


def _jax_forward(q, k, v, causal, scale):
    """The JAX package's Pallas forward (interpret mode where the caller
    set it): (o, lse) with lse lane-replicated [B*H, S, 128]."""
    block = jattn._pick_block(q.shape[2])
    return jattn._flash_forward(*map(jnp.asarray, (q, k, v)), causal, scale,
                                block, block)


def _grad_err(out, ref) -> float:
    """The JAX package's measure for its kernel gradients
    (tests/test_models_ops.py): max error over max(1, max|ref|)."""
    ref = np.asarray(ref)
    return np.abs(_np(out) - ref).max() / max(1.0, np.abs(ref).max())


class TestFlashBwdDqReference:
    """``flash_bwd_dq_reference`` (the plain version of K2: dq and delta)
    against the JAX package's Pallas ``_dq_kernel`` in interpret mode and
    against its delta formula."""

    @pytest.mark.parametrize("shape,causal", [
        ((1, 2, 256, 64), True),
        ((1, 2, 256, 64), False),
        ((3, 5, 128, 32), True),
    ])
    def test_matches_pallas_interpret(self, monkeypatch, shape, causal):
        monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")
        assert jattn._kernel_ok(shape[2])
        q, k, v, do = _bwd_inputs(9, shape)
        scale = 1.0 / np.sqrt(shape[-1])
        o, lse = _jax_forward(q, k, v, causal, scale)
        block = jattn._pick_block(shape[2])
        dq_jax, _, _ = jattn._flash_backward(
            *map(jnp.asarray, (q, k, v)), o, lse, jnp.asarray(do), causal,
            scale, block, block)
        # The JAX package's delta (ray_tpu/ops/attention.py, in
        # _flash_backward): rowsum(g * o) in f32.
        delta_jax = np.asarray(jnp.sum(jnp.asarray(do).astype(jnp.float32)
                                       * o.astype(jnp.float32), axis=-1))
        o = np.array(o)
        lse = np.array(lse)[..., 0].reshape(shape[:3])
        dq, delta = tattn.flash_bwd_dq_reference(
            *map(torch.from_numpy, (q, k, v, o, do, lse)), causal, scale)
        # The JAX package's own band for its kernel gradients.
        assert _grad_err(dq, dq_jax) <= 6e-3
        # delta is a sum that can cancel: its band is taken against the
        # row's sum of |dO * O| (f32 sums in two orders).
        mag = np.abs(do * o).sum(-1)
        assert delta.dtype == torch.float32
        assert np.all(np.abs(_np(delta) - delta_jax) <= 1e-5 * mag)


class TestFlashAttentionKernelPath:
    """``_FlashAttention`` (the CUDA path of ``flash_attention``) run on CPU
    tensors with its three kernels replaced by their plain versions: its
    gradients equal the JAX ``flash_attention`` vjp in interpret mode, and
    the delta K2 returns is the one K3 receives."""

    @pytest.mark.parametrize("shape,causal", [
        ((1, 2, 256, 64), True),
        ((1, 2, 256, 64), False),
        ((3, 5, 128, 32), True),
    ])
    def test_gradients_match_jax_vjp(self, monkeypatch, shape, causal):
        monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")
        seen = {}

        def fwd(q, k, v, causal, scale, save_lse=False):
            o = tattn.mha_reference(q, k, v, causal, scale)
            return o, _lse(q, k, causal, scale) if save_lse else None

        def dq(*args):
            seen["dq"] = tattn.flash_bwd_dq_reference(*args)
            return seen["dq"]

        def dkv(q, k, v, do, lse, delta, causal, scale):
            seen["delta"] = delta
            return tattn.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                 causal, scale)

        monkeypatch.setattr(_kernels, "flash_fwd", fwd)
        monkeypatch.setattr(_kernels, "flash_bwd_dq", dq)
        monkeypatch.setattr(_kernels, "flash_bwd_dkv", dkv)
        q, k, v, do = _bwd_inputs(11, shape)
        scale = 1.0 / np.sqrt(shape[-1])
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = tattn._FlashAttention.apply(*leaves, causal, scale)
        grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
        assert seen["delta"] is seen["dq"][1]
        _, vjp = jax.vjp(
            lambda a, b, c: jattn.flash_attention(a, b, c, causal, scale),
            *map(jnp.asarray, (q, k, v)))
        for t, j in zip(grads, vjp(jnp.asarray(do))):
            assert _grad_err(t, j) <= 6e-3


class TestKernelWrapper:
    def test_cpu_tensor_is_refused(self):
        q = torch.zeros(1, 1, 64, 64)
        with pytest.raises(ValueError, match="CUDA"):
            _kernels.flash_fwd(q, q, q, True, 0.125)

    @pytest.mark.parametrize("name", ["flash_bwd_dq", "flash_bwd_dkv"])
    def test_bwd_cpu_tensors_are_refused(self, name):
        q = torch.zeros(1, 1, 64, 64)
        rows = torch.zeros(1, 1, 64)
        # K2 takes (q, k, v, o, do, lse), K3 (q, k, v, do, lse, delta).
        args = {"flash_bwd_dq": (q, q, q, q, q, rows),
                "flash_bwd_dkv": (q, q, q, q, rows, rows)}[name]
        with pytest.raises(ValueError, match="CUDA"):
            getattr(_kernels, name)(*args, True, 0.125)

    @pytest.mark.parametrize("name", ["rms_norm_fwd", "rms_norm_bwd"])
    def test_norm_cpu_tensors_are_refused(self, name):
        x, w = torch.zeros(4, 64), torch.ones(64)
        args = {"rms_norm_fwd": (x, w, 1e-6),
                "rms_norm_bwd": (x, w, torch.ones(4), x)}[name]
        with pytest.raises(ValueError, match="CUDA"):
            getattr(_kernels, name)(*args)

    @pytest.mark.parametrize("x,w,match", [
        (torch.zeros(4, 64, dtype=torch.float16), torch.ones(64), "x"),
        (torch.zeros(4, 12), torch.ones(12), "multiple of 8"),
        (torch.zeros(2, 8200), torch.ones(8200), "multiple of 8"),
        (torch.zeros(4, 0), torch.ones(0), "multiple of 8"),
        (torch.zeros(4, 64), torch.ones(64, dtype=torch.bfloat16), "weight"),
        (torch.zeros(4, 64), torch.ones(32), "weight"),
    ])
    def test_norm_unsupported_input_is_refused(self, x, w, match):
        # The dtype and shape checks come before the device's, so they
        # refuse these on the CPU as they would on the card.
        with pytest.raises(ValueError, match=match):
            _kernels.rms_norm_fwd(x, w, 1e-6)

    @pytest.mark.parametrize("name", ["qkv_rope_fwd", "qkv_rope_bwd"])
    def test_qkv_cpu_tensors_are_refused(self, name):
        tables = (torch.zeros(4, 8), torch.zeros(4, 8))
        heads = torch.zeros(1, 2, 4, 16)
        args = {"qkv_rope_fwd": (torch.zeros(1, 4, 96), 16, *tables),
                "qkv_rope_bwd": (heads, heads, heads, *tables)}[name]
        with pytest.raises(ValueError, match="CUDA"):
            getattr(_kernels, name)(*args)

    @pytest.mark.parametrize("qkv,head_dim,match", [
        (torch.zeros(1, 4, 96, dtype=torch.float16), 16, "float32"),
        (torch.zeros(1, 4, 24), 8, "multiple of 16"),
        (torch.zeros(1, 4, 3 * 272), 272, "multiple of 16"),
        (torch.zeros(1, 4, 80), 16, r"\[B, S, 3 h D\]"),
        (torch.zeros(4, 96), 16, r"\[B, S, 3 h D\]"),
    ])
    def test_qkv_unsupported_input_is_refused(self, qkv, head_dim, match):
        # The dtype and shape checks come before the device's, so they
        # refuse these on the CPU as they would on the card.
        d = max(head_dim // 2, 1)
        with pytest.raises(ValueError, match=match):
            _kernels.qkv_rope_fwd(qkv, head_dim, torch.zeros(4, d),
                                  torch.zeros(4, d))

    def test_qkv_bwd_gradients_of_one_shape(self):
        heads = torch.zeros(1, 2, 4, 16)
        with pytest.raises(ValueError, match="one shape"):
            _kernels.qkv_rope_bwd(heads, heads, torch.zeros(1, 2, 5, 16),
                                  torch.zeros(4, 8), torch.zeros(4, 8))

    def test_nothing_built_or_counted_on_import(self):
        assert _kernels._libs == {} and _kernels._fns == {}
        assert _kernels.LAUNCHES == {
            "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "rms_norm_fwd": 0, "rms_norm_bwd": 0, "rms_norm_dw": 0,
            "qkv_rope_fwd": 0, "qkv_rope_bwd": 0}
        assert set(_kernels._SIGNATURES) == set(_kernels.LAUNCHES)

    # source -> what its head note must say it replaces: TPU kernels of
    # ray_tpu/ops/attention.py, or none and the plain jnp function it
    # stands beside
    REPLACES = {
        "flash_fwd.cu": ["Replaces: ray_tpu/ops/attention.py::_fwd_kernel"],
        "flash_bwd.cu": ["Replaces: ray_tpu/ops/attention.py::_dq_kernel",
                         "Replaces: ray_tpu/ops/attention.py::_dkv_kernel"],
        "rms_norm.cu": ["Replaces: none", "ray_tpu/ops/layers.py::rms_norm"],
        "qkv_rope.cu": ["Replaces: none", "ray_tpu/ops/layers.py::rope"],
    }

    def test_sources_name_the_tpu_kernel_they_replace(self):
        assert set(_kernels.SOURCES.values()) == set(self.REPLACES)
        for src, notes in self.REPLACES.items():
            with open(os.path.join(_kernels.CSRC, src)) as f:
                head = f.read(4000)
            for note in notes:
                assert note in head
            assert "sm_90a" in head


_FORBIDDEN = ("jax", "ml_dtypes", "ray_tpu", "flax", "optax")


def _forbidden(module: str) -> bool:
    # Exact name or a dotted child: "ray_tpu_torch" is not "ray_tpu".
    return any(module == f or module.startswith(f + ".")
               for f in _FORBIDDEN)


class TestIsolation:
    def test_forbidden_matches_exact_names_only(self):
        assert _forbidden("ray_tpu") and _forbidden("ray_tpu.ops")
        assert _forbidden("jax.numpy") and _forbidden("ml_dtypes")
        assert _forbidden("flax.linen") and _forbidden("optax")
        assert not _forbidden("ray_tpu_torch")
        assert not _forbidden("ray_tpu_torch.ops")
        assert not _forbidden("jaxtyping")

    def test_import_leaves_jax_and_ray_tpu_out(self):
        code = (
            "import sys\n"
            "import ray_tpu_torch, ray_tpu_torch.ops, ray_tpu_torch.models\n"
            "import ray_tpu_torch.models.generate, ray_tpu_torch.llm\n"
            "import ray_tpu_torch.models.convert\n"
            "import ray_tpu_torch.models._training\n"
            "import ray_tpu_torch.parallel, ray_tpu_torch.parallel.moe\n"
            "import ray_tpu_torch.parallel.ops, ray_tpu_torch.parallel.sequence\n"
            "import ray_tpu_torch.parallel.pipeline\n"
            "import ray_tpu_torch.parallel.launch\n"
            "import ray_tpu_torch.parallel.dryrun\n"
            "import ray_tpu_torch.models.llama, ray_tpu_torch.models.vit\n"
            "import ray_tpu_torch.models.moe, ray_tpu_torch.models.resnet\n"
            "print('\\n'.join(sys.modules))\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=120,
                             check=True).stdout.split()
        assert "ray_tpu_torch.llm" in out
        assert {"ray_tpu_torch.parallel.moe", "ray_tpu_torch.models.llama",
                "ray_tpu_torch.models.vit", "ray_tpu_torch.models.moe",
                "ray_tpu_torch.models.resnet", "ray_tpu_torch.parallel.ops",
                "ray_tpu_torch.parallel.sequence",
                "ray_tpu_torch.parallel.pipeline",
                "ray_tpu_torch.parallel.launch",
                "ray_tpu_torch.parallel.dryrun"} <= set(out)
        assert [m for m in out if _forbidden(m)] == []

    def test_rllib_import_leaves_jax_and_ray_tpu_out(self):
        # The RLlib port (modules, learner, algorithms, runners, offline
        # IO) reaches neither jax, flax and optax nor ray_tpu.
        code = (
            "import sys\n"
            "import ray_tpu_torch.rllib\n"
            "import ray_tpu_torch.rllib.core.convert\n"
            "import ray_tpu_torch.rllib.utils.schedules\n"
            "import ray_tpu_torch.rllib.utils.self_play\n"
            "print('\\n'.join(sys.modules))\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=120,
                             check=True).stdout.split()
        assert {"ray_tpu_torch.rllib.core.learner",
                "ray_tpu_torch.rllib.algorithms.ppo",
                "ray_tpu_torch.rllib.algorithms.impala",
                "ray_tpu_torch.rllib.env.env_runner",
                "ray_tpu_torch.rllib.offline"} <= set(out)
        assert [m for m in out if _forbidden(m)] == []

    def test_multihost_import_leaves_jax_and_ray_tpu_out(self):
        # The node daemon, cluster_utils, the usage report, the chaos
        # helpers and the autoscaler (v1 and v2) reach neither jax nor
        # ray_tpu, nor torch: a daemon process never needs it.
        code = (
            "import sys\n"
            "import ray_tpu_torch._private.daemon\n"
            "import ray_tpu_torch._private.usage\n"
            "import ray_tpu_torch._private.test_utils\n"
            "import ray_tpu_torch.cluster_utils\n"
            "import ray_tpu_torch.autoscaler, ray_tpu_torch.autoscaler.v2\n"
            "print('\\n'.join(sys.modules))\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=120,
                             check=True).stdout.split()
        assert {"ray_tpu_torch._private.daemon",
                "ray_tpu_torch.autoscaler.resource_demand_scheduler",
                "ray_tpu_torch.autoscaler.v2"} <= set(out)
        assert [m for m in out if _forbidden(m)] == []
        assert [m for m in out if m.split(".")[0] == "torch"] == []

    def test_libraries_import_leaves_jax_and_ray_tpu_out(self):
        # Tune (its searchers and schedulers included), AIR, Workflow,
        # Jobs and the dashboard reach neither jax nor ray_tpu, nor torch:
        # a trial or a job supervisor loads torch only if its code does.
        code = (
            "import sys\n"
            "import ray_tpu_torch.tune, ray_tpu_torch.tune.searchers\n"
            "import ray_tpu_torch.air, ray_tpu_torch.workflow\n"
            "import ray_tpu_torch.job, ray_tpu_torch.dashboard\n"
            "print('\\n'.join(sys.modules))\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=120,
                             check=True).stdout.split()
        assert {"ray_tpu_torch.tune.tuner", "ray_tpu_torch.tune.schedulers",
                "ray_tpu_torch.air.session", "ray_tpu_torch.workflow.events",
                "ray_tpu_torch.job", "ray_tpu_torch.dashboard"} <= set(out)
        assert [m for m in out if _forbidden(m)] == []
        assert [m for m in out if m.split(".")[0] == "torch"] == []

    def test_cli_client_and_shims_import_leaves_jax_and_ray_tpu_out(self):
        # The CLI, the remote-driver client, Pool, the ecosystem shims,
        # experimental, the GBDT trainers and the cloud providers reach
        # neither jax nor ray_tpu, nor torch: a head started by the CLI
        # loads torch only to unpickle a client's tensor.
        code = (
            "import sys\n"
            "import ray_tpu_torch.scripts.cli, ray_tpu_torch.util.client\n"
            "import ray_tpu_torch.util.client.api_ops\n"
            "import ray_tpu_torch.util.multiprocessing\n"
            "import ray_tpu_torch.util.iter, ray_tpu_torch.util.actor_group\n"
            "import ray_tpu_torch.util.dask, ray_tpu_torch.util.joblib\n"
            "import ray_tpu_torch.util.spark, ray_tpu_torch.experimental\n"
            "import ray_tpu_torch.experimental.collective\n"
            "import ray_tpu_torch.train.gbdt\n"
            "import ray_tpu_torch.autoscaler.k8s_provider\n"
            "import ray_tpu_torch.autoscaler.gcp_gpu_provider\n"
            "print('\\n'.join(sys.modules))\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=120,
                             check=True).stdout.split()
        assert {"ray_tpu_torch.util.client.server",
                "ray_tpu_torch.util.client.api_ops",
                "ray_tpu_torch.experimental.collective",
                "ray_tpu_torch.autoscaler.gcp_gpu_provider"} <= set(out)
        assert [m for m in out if _forbidden(m)] == []
        assert [m for m in out if m.split(".")[0] == "torch"] == []

    def test_device_plumbing_import_leaves_jax_and_ray_tpu_out(self,
                                                              tmp_path):
        # The feed, the store's tensor landing, the fused DAG, profiling
        # and the accelerator constants: none loads torch at import, and
        # none reaches jax or ray_tpu once torch is used.
        code = (
            "import sys\n"
            "import ray_tpu_torch.data.streaming, ray_tpu_torch.data\n"
            "import ray_tpu_torch._private.serialization as ser\n"
            "import ray_tpu_torch.dag.compiled\n"
            "import ray_tpu_torch.util.profiling as prof\n"
            "import ray_tpu_torch.util.accelerators as acc\n"
            "print('torch' in sys.modules)\n"
            "import torch\n"
            "ser.deserialize(ser.serialize(torch.ones(3)).to_bytes())\n"
            "list(ray_tpu_torch.data.streaming.torch_device_feed(\n"
            "    iter([{'x': [1, 2]}]), device='cpu'))\n"
            "with prof.trace(sys.argv[1]), prof.annotate('a'):\n"
            "    torch.ones(2).sum()\n"
            "assert acc.gpus_per_host(acc.NVIDIA_H100) == 8\n"
            "print('\\n'.join(sys.modules))\n")
        out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                             cwd=REPO, capture_output=True, text=True,
                             timeout=120, check=True).stdout.split()
        assert out[0] == "False"
        assert {"ray_tpu_torch.data.streaming", "ray_tpu_torch.dag.compiled",
                "ray_tpu_torch.util.profiling",
                "ray_tpu_torch.util.accelerators", "torch"} <= set(out)
        assert [m for m in out[1:] if _forbidden(m)] == []

    def test_control_plane_import_leaves_jax_and_ray_tpu_out(self):
        code = (
            "import sys\n"
            "import ray_tpu_torch\n"
            "torch_at_import = 'torch' in sys.modules\n"
            "import ray_tpu_torch.api, ray_tpu_torch.serve\n"
            "import ray_tpu_torch.data, ray_tpu_torch.dag\n"
            "import ray_tpu_torch._private.worker_proc\n"
            "import ray_tpu_torch._private.wiretap\n"
            "import ray_tpu_torch._private.protocol_model\n"
            "import ray_tpu_torch.serve._private.controller\n"
            "import ray_tpu_torch.serve._private.proxy\n"
            "import ray_tpu_torch.serve._private.replica\n"
            "import ray_tpu_torch.util, ray_tpu_torch.util.state\n"
            "print(torch_at_import)\n"
            "print('\\n'.join(sys.modules))\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=120,
                             check=True).stdout.split()
        assert out[0] == "False"
        assert {"ray_tpu_torch.api", "ray_tpu_torch.serve",
                "ray_tpu_torch.data", "ray_tpu_torch._private.worker_proc",
                "ray_tpu_torch._private.protocol_model"} <= set(out)
        assert [m for m in out[1:] if _forbidden(m) or m == "torch"] == []

    def test_lint_import_leaves_jax_ray_tpu_and_torch_out(self):
        # The port's lint, every module of it, and the protocol model it
        # shares with the wiretap reach neither jax nor ray_tpu (not
        # even the JAX package's pure-stdlib lint), nor torch. The 15th
        # module, __main__, runs as `python -m` runs it.
        lint_dir = os.path.join(REPO, "ray_tpu_torch", "devtools", "lint")
        mods = sorted(f"ray_tpu_torch.devtools.lint.{f[:-3]}"
                      for f in os.listdir(lint_dir)
                      if f.endswith(".py") and f != "__main__.py")
        assert len(mods) == 14
        code = (
            "import sys, runpy\n"
            "import ray_tpu_torch.devtools\n"
            + "".join(f"import {m}\n" for m in mods)
            + "import ray_tpu_torch._private.protocol_model\n"
            "sys.argv = ['lint', '--passes', 'config-keys', '-q']\n"
            "try:\n"
            "    runpy.run_module('ray_tpu_torch.devtools.lint',\n"
            "                     run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "print('\\n'.join(sys.modules))\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=120,
                             check=True).stdout.split()
        assert set(mods) | {"ray_tpu_torch.devtools",
                            "ray_tpu_torch._private.protocol_model"} \
            <= set(out)
        assert [m for m in out if _forbidden(m)] == []
        assert [m for m in out if m.split(".")[0] == "torch"] == []

    def test_train_and_collective_import_leaves_jax_and_ray_tpu_out(self):
        # Train and the collective group load torch where they run, not
        # at import: the control plane's workers start without it.
        code = (
            "import sys\n"
            "import ray_tpu_torch.train, ray_tpu_torch.train.v2\n"
            "import ray_tpu_torch.util.collective\n"
            "from ray_tpu_torch.util.collective.collective_group import "
            "torch_collective_group, local_group\n"
            "import ray_tpu_torch.parallel.mesh\n"
            "import ray_tpu_torch.parallel.partition\n"
            "print('torch' in sys.modules)\n"
            "import ray_tpu_torch.models._training\n"
            "print('\\n'.join(sys.modules))\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=120,
                             check=True).stdout.split()
        assert out[0] == "False"
        assert {"ray_tpu_torch.train.trainer", "ray_tpu_torch.train.backend",
                "ray_tpu_torch.train.v2.controller",
                "ray_tpu_torch.util.collective.collective",
                "ray_tpu_torch.util.collective.collective_group."
                "torch_collective_group"} <= set(out)
        assert [m for m in out[1:] if _forbidden(m)] == []

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
        from ray_tpu_torch.models import GPTConfig, gpt_init, make_train_step

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for make in (resolve_device,
                     lambda: gpt_init(GPTConfig.tiny(), torch.Generator()),
                     lambda: make_train_step(GPTConfig.tiny()),
                     LLMEngine, ContinuousBatchingEngine,
                     GPTInferenceStage):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
        assert resolve_device("cpu").type == "cpu"


class TestHeadChunks:
    """Launches over more than 65,535 batch*heads: ``head_chunks`` splits
    the [B*H, S, D] rows so that no launch passes gridDim.y's limit and
    every chunk's tensors start 16-byte aligned (the kernels' TMA and
    vector loads need it), for q/k/v/o/dO in both dtypes and the f32 lse
    and delta rows."""

    @pytest.mark.parametrize("bh", [1, 65532, 65535, 65536, 65544, 65552,
                                    200003])
    def test_chunks_cover_every_head_once(self, bh):
        chunks = _kernels.head_chunks(bh)
        assert all(0 < n <= 65535 for _, n in chunks)  # gridDim.y's cap
        covered = [h for start, n in chunks for h in range(start, start + n)]
        assert covered == list(range(bh))
        assert len(chunks) == -(-bh // _kernels.HEAD_CHUNK)

    @pytest.mark.parametrize("s", [64, 197, 257])
    def test_chunk_offsets_are_16_byte_aligned(self, s):
        assert _kernels.HEAD_CHUNK % 4 == 0
        assert _kernels.HEAD_CHUNK <= 65535
        for bh in (65544, 65552, 3 * 65535):
            for start, _ in _kernels.head_chunks(bh):
                assert (start * s * 4) % 16 == 0             # lse, delta
                for d in _kernels.FLASH_HEAD_DIMS:
                    for size in (2, 4):                       # bf16, f32
                        assert (start * s * d * size) % 16 == 0

    def test_head_pointer_steps_by_whole_heads(self):
        t = torch.zeros(3, 5, 7, 16, dtype=torch.bfloat16)
        base = t.data_ptr()
        assert _kernels._head_ptr(t, 0, 15) == base
        assert _kernels._head_ptr(t, 4, 15) == t[0, 4].data_ptr()
        assert _kernels._head_ptr(t, 11, 15) == t[2, 1].data_ptr()
        lse = torch.zeros(3, 5, 7)
        assert _kernels._head_ptr(lse, 6, 15) == lse[1, 1].data_ptr()
        assert _kernels._head_ptr(None, 6, 15) is None
