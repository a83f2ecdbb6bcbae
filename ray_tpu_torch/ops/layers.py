"""Elementwise / normalization layers used by the model stack.

Counterpart of ``ray_tpu/ops/layers.py``. These stay plain PyTorch ops,
as the JAX package left them to XLA; only attention has a kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm; computed in fp32, cast back to input dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def rope(x: torch.Tensor, position_offset: int = 0, base: float = 10000.0,
         positions=None) -> torch.Tensor:
    """Rotary position embedding for [batch, heads, seq, head_dim].

    Split halves (not interleaved pairs). ``positions`` overrides
    ``position_offset``: shape (seq,) for aligned rows, or (batch, seq)
    when every row sits at its own offset (continuous batching)."""
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


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x@gate) * (x@up) )."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down
