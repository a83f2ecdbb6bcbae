"""Elementwise / normalization layers used by the model stack.

Counterpart of ``ray_tpu/ops/layers.py``. ``rms_norm`` sends a CUDA
tensor to the hand-written RMSNorm kernels (``csrc/rms_norm.cu``: the
forward, and the backward with its dw reduction, behind ``_RMSNorm``), a
CPU tensor to the plain version ``_rms_norm`` with autograd through it;
there is no fallback between the two. ``rms_norm_bwd_reference`` is the
kernel's backward arithmetic in plain torch. ``qkv_heads`` splits GPT's
and MoE's fused qkv product into heads with ``rope`` on q and k the same
way: the hand-written kernels (``csrc/qkv_rope.cu``, behind
``_QKVHeads``) on CUDA, the plain chain ``_qkv_heads`` on CPU, the same
bits on both; ``qkv_heads_bwd_reference`` is the kernel's backward in
plain torch. ``rope`` itself (llama's separate q and kv products, the
KV-cache paths' per-row positions), ``gelu`` and ``swiglu`` stay plain
PyTorch ops, as the JAX package left them to XLA. In a torch.profiler
session, ``rms_norm`` is the device range ``model.norm``, ``qkv_heads``
and ``rope`` are ``model.rope`` and ``gelu`` is ``model.act``
(``util.tracing.device_range``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..util import tracing
from . import _kernels


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm; computed in fp32, cast back to input dtype. The kernels on
    CUDA, the plain version on CPU."""
    norm = _rms_norm if x.device.type == "cpu" else _RMSNorm.apply
    if tracing.profiler._is_profiler_enabled:
        return tracing.device_range("model.norm", norm, x, weight, eps)
    return norm(x, weight, eps)


def _rms_norm(x: torch.Tensor, weight: torch.Tensor,
              eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def rms_norm_bwd_reference(x: torch.Tensor, weight: torch.Tensor,
                           grad: torch.Tensor, eps: float = 1e-6):
    """The kernels' backward in plain torch: (dx in x's dtype, dw f32).

    With rstd = rsqrt(mean(x²) + eps) and n = x rstd, all in f32:
    dx = rstd (g w - n mean(g w n)) and dw = the sum over rows of g n."""
    xf, g, w = x.float(), grad.float(), weight.float()
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    n = xf * rstd
    mean = (g * w * n).mean(dim=-1, keepdim=True)
    dx = rstd * (g * w - n * mean)
    return dx.to(x.dtype), (g * n).reshape(-1, x.shape[-1]).sum(0)


class _RMSNorm(torch.autograd.Function):
    """The CUDA path: rms_norm_fwd, and rms_norm_bwd with rms_norm_dw for
    its gradient. Keeps x (no copy) and rstd for the backward."""

    @staticmethod
    def forward(ctx, x, weight, eps: float):
        y, rstd = _kernels.rms_norm_fwd(x, weight, eps)
        ctx.save_for_backward(x, weight, rstd)
        return y

    @staticmethod
    def backward(ctx, grad):
        x, weight, rstd = ctx.saved_tensors
        dx, dw = _kernels.rms_norm_bwd(x, weight, rstd, grad)
        return dx, dw, None


_ROPE_BASE = 10000.0


def rope(x: torch.Tensor, position_offset: int = 0,
         base: float = _ROPE_BASE, positions=None) -> torch.Tensor:
    """Rotary position embedding for [batch, heads, seq, head_dim].

    Split halves (not interleaved pairs). ``positions`` overrides
    ``position_offset``: shape (seq,) for aligned rows, or (batch, seq)
    when every row sits at its own offset (continuous batching)."""
    if tracing.profiler._is_profiler_enabled:
        return tracing.device_range("model.rope", _rope, x, position_offset,
                                    base, positions)
    return _rope(x, position_offset, base, positions)


def _rope(x: torch.Tensor, position_offset: int, base: float,
          positions) -> torch.Tensor:
    *_, seq_len, head_dim = x.shape
    if positions is None:
        positions = position_offset + torch.arange(seq_len, device=x.device)
    cos, sin = _cos_sin(positions, head_dim, base, x.device)
    if cos.ndim == 3:                    # (batch, seq, d/2): one row each
        cos, sin = cos[:, None], sin[:, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def _cos_sin(positions, head_dim: int, base: float, device):
    """cos and sin, f32 [..., head_dim / 2], of ``positions`` (seq,) or
    (batch, seq)."""
    pos = torch.as_tensor(positions, device=device).float()
    inv_freq = 1.0 / (base ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    angles = pos[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


# (seq_len, head_dim, device) -> _rope_tables' (cos, sin)
_TABLES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _rope_tables(seq_len: int, head_dim: int, device: torch.device):
    """``_rope``'s cos and sin, f32 [seq_len, head_dim / 2], of positions
    0..seq_len-1 at the default base, made by ``_rope``'s own ops once a
    (seq_len, head_dim, device). Tables made while a CUDA graph is
    captured are not kept: they hold their values only once the graph is
    replayed."""
    key = (seq_len, head_dim, device)
    tables = _TABLES.get(key)
    if tables is None:
        tables = _cos_sin(torch.arange(seq_len, device=device), head_dim,
                          _ROPE_BASE, device)
        if device.type != "cuda" \
                or not torch.cuda.is_current_stream_capturing():
            _TABLES[key] = tables
    return tables


def qkv_heads(qkv: torch.Tensor, head_dim: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A fused product [B, S, 3 h D] with columns [q | k | v] (h heads of
    ``head_dim`` D each) -> q, k, v, each contiguous [B, h, S, D], q and k
    rotated by ``rope`` at positions 0..S-1. The kernels on CUDA, the plain
    chain on CPU, the same bits."""
    split = _qkv_heads if qkv.device.type == "cpu" else _QKVHeads.apply
    if tracing.profiler._is_profiler_enabled:
        return tracing.device_range("model.rope", split, qkv, head_dim)
    return split(qkv, head_dim)


def _qkv_heads(qkv: torch.Tensor, head_dim: int):
    b, s, width = qkv.shape
    h = width // (3 * head_dim)
    q, k, v = (t.reshape(b, s, h, head_dim).transpose(1, 2)
               for t in qkv.split(width // 3, dim=-1))
    return (_rope(q, 0, _ROPE_BASE, None), _rope(k, 0, _ROPE_BASE, None),
            v.contiguous())


def qkv_heads_bwd_reference(dq: torch.Tensor, dk: torch.Tensor,
                            dv: torch.Tensor, cos: torch.Tensor,
                            sin: torch.Tensor) -> torch.Tensor:
    """The kernel's backward in plain torch: d(qkv) [B, S, 3 h D] from dq,
    dk, dv [B, h, S, D] and ``_rope_tables``' cos and sin. Each of q's and
    k's halves in f32, g1 cos + g2 sin and g2 cos - g1 sin, every product
    rounded on its own, then one rounding to the dtype: the order autograd
    takes through ``_qkv_heads``."""
    def unrotate(g):
        g1, g2 = g.float().chunk(2, dim=-1)
        return torch.cat([g1 * cos + g2 * sin, g2 * cos - g1 * sin],
                         dim=-1).to(g.dtype)

    b, h, s, d = dq.shape
    heads = (unrotate(dq), unrotate(dk), dv)
    return torch.cat([t.transpose(1, 2).reshape(b, s, h * d)
                      for t in heads], dim=-1)


class _QKVHeads(torch.autograd.Function):
    """The CUDA path: qkv_rope_fwd, and qkv_rope_bwd for its gradient.
    Keeps only the rope tables for the backward."""

    @staticmethod
    def forward(ctx, qkv, head_dim: int):
        ctx.tables = _rope_tables(qkv.shape[1], head_dim, qkv.device)
        return _kernels.qkv_rope_fwd(qkv, head_dim, *ctx.tables)

    @staticmethod
    def backward(ctx, dq, dk, dv):
        grads = (g.contiguous() for g in (dq, dk, dv))
        return _kernels.qkv_rope_bwd(*grads, *ctx.tables), None


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU in its tanh form, ``jax.nn.gelu``'s default."""
    if tracing.profiler._is_profiler_enabled:
        return tracing.device_range("model.act", _gelu, x)
    return _gelu(x)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x@gate) * (x@up) )."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down
