"""Elementwise / normalization layers used by the model stack.

Counterpart of ``ray_tpu/ops/layers.py``. ``rms_norm`` sends a CUDA
tensor to the hand-written RMSNorm kernels (``csrc/rms_norm.cu``: the
forward, and the backward with its dw reduction, behind ``_RMSNorm``), a
CPU tensor to the plain version ``_rms_norm`` with autograd through it;
there is no fallback between the two. ``rms_norm_bwd_reference`` is the
kernel's backward arithmetic in plain torch. ``rope``, ``gelu`` and
``swiglu`` stay plain PyTorch ops, as the JAX package left them to XLA.
In a torch.profiler session, ``rms_norm``, ``rope`` and ``gelu`` are the
device ranges ``model.norm``, ``model.rope`` and ``model.act``
(``util.tracing.device_range``).
"""

from __future__ import annotations

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


def rope(x: torch.Tensor, position_offset: int = 0, base: float = 10000.0,
         positions=None) -> torch.Tensor:
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
    pos = torch.as_tensor(positions, device=x.device).float()
    inv_freq = 1.0 / (base ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=x.device) / head_dim))
    if pos.ndim == 2:                                # (batch, seq)
        angles = pos[:, :, None] * inv_freq          # (b, seq, d/2)
        cos = torch.cos(angles)[:, None]             # (b, 1, seq, d/2)
        sin = torch.sin(angles)[:, None]
    else:
        angles = pos[:, None] * inv_freq[None, :]    # (seq, d/2)
        cos = torch.cos(angles)[None, None]
        sin = torch.sin(angles)[None, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


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
