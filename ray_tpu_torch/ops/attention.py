"""Causal multi-head attention: a Hopper flash kernel + a plain reference.

Counterpart of ``ray_tpu/ops/attention.py``. Layout [batch, heads, seq,
head_dim]. ``flash_attention`` sends a CUDA tensor to the hand-written
forward kernel (``csrc/flash_fwd.cu``, which replaces the Pallas
``_fwd_kernel``) and a CPU tensor to ``mha_reference``, the plain version
the kernel is held against. There is no fallback between the two: a CUDA
call launches the kernel or raises.

The backward kernels (the Pallas ``_dq_kernel`` and ``_dkv_kernel``) are
not ported yet, so a backward through the CUDA path raises; on the CPU
autograd runs through ``mha_reference``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _kernels

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention; numerically the ground truth for the kernel.

    Logits in f32 (the products of the inputs, summed in f32), the causal
    ``tril`` offset by ``seq_k - seq_q``, probabilities cast to v's dtype
    before the PV product, as the JAX reference does."""
    *_, seq_q, head_dim = q.shape
    seq_k = k.shape[-2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(head_dim)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        mask = torch.ones(seq_q, seq_k, dtype=torch.bool,
                          device=q.device).tril(seq_k - seq_q)
        logits = torch.where(mask, logits, DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


class _FlashAttention(torch.autograd.Function):
    """The CUDA path: forward kernel; backward waits for K2/K3."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        # Primal-only call (no input needs a gradient): write no lse.
        save_lse = any(ctx.needs_input_grad[:3])
        out, lse = _kernels.flash_fwd(q, k, v, causal, scale,
                                      save_lse=save_lse)
        if save_lse:
            ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "flash_attention backward on CUDA needs the dQ and dK/dV "
            "kernels (ray_tpu/ops/attention.py _dq_kernel, _dkv_kernel), "
            "queued as the training slice in ROADMAP.md")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention: the Hopper kernel on CUDA, the reference on CPU."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal, scale)
    return _FlashAttention.apply(q, k, v, causal, scale)
