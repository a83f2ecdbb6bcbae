"""Causal multi-head attention: Hopper flash kernels + plain references.

Counterpart of ``ray_tpu/ops/attention.py``. Layout [batch, heads, seq,
head_dim]. ``flash_attention`` sends a CUDA tensor to the hand-written
kernels: the forward (``csrc/flash_fwd.cu``, which replaces the Pallas
``_fwd_kernel``) and, for its gradient, dQ and dK/dV
(``csrc/flash_bwd.cu``, which replace ``_dq_kernel`` and
``_dkv_kernel``). A CPU tensor goes to ``mha_reference``, with autograd
through it. ``mha_reference`` and ``flash_bwd_reference`` are the plain
versions the kernels are held against. There is no fallback between the
two paths: a CUDA call, forward or backward, launches the kernels or
raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _kernels

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _causal_mask(seq_q: int, seq_k: int, device) -> torch.Tensor:
    return torch.ones(seq_q, seq_k, dtype=torch.bool,
                      device=device).tril(seq_k - seq_q)


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
        logits = torch.where(_causal_mask(seq_q, seq_k, q.device), logits,
                             DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def flash_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, causal: bool, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels (K2 and K3): (dq, dk, dv).

    The flash-2 formulas from the forward's ``lse`` (f32 [B, H, S]) and
    ``delta = rowsum(do * o)``, in f32 and in the TPU kernels' order:
    ``s = (q kᵀ) * scale``, the mask with ``DEFAULT_MASK_VALUE``,
    ``p = exp(s - lse)``, ``dp = do vᵀ``, ``ds = p (dp - delta) scale``.
    P and dS are rounded to the inputs' dtype before their products, as
    the kernels round them; each gradient is returned in its input's
    dtype."""
    seq_q, seq_k = q.shape[-2], k.shape[-2]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        s = torch.where(_causal_mask(seq_q, seq_k, q.device), s,
                        DEFAULT_MASK_VALUE)
    p = torch.exp(s - lse.float()[..., None])
    delta = (dof * o.float()).sum(-1)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    p = p.to(do.dtype).float()
    ds = ds.to(k.dtype).float()
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """The CUDA path: the forward kernel, and the dQ and dK/dV kernels for
    its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        # Primal-only call (no input needs a gradient): write no lse.
        save_lse = any(ctx.needs_input_grad[:3])
        out, lse = _kernels.flash_fwd(q, k, v, causal, scale,
                                      save_lse=save_lse)
        if save_lse:
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        # The model hands in the gradient of a transposed view; the
        # kernels take contiguous rows.
        do = grad_out.contiguous()
        delta = (do.float() * out.float()).sum(-1)  # rowsum(dO * O), f32
        dq = _kernels.flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal,
                                   ctx.scale)
        dk, dv = _kernels.flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal,
                                        ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention: the Hopper kernels on CUDA, the reference on CPU."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal, scale)
    return _FlashAttention.apply(q, k, v, causal, scale)
