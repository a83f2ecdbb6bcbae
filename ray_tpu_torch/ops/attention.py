"""Causal multi-head attention: Hopper flash kernels + plain references.

Counterpart of ``ray_tpu/ops/attention.py``. Layout [batch, heads, seq,
head_dim]. ``flash_attention`` sends a CUDA tensor to the hand-written
kernels: the forward (``csrc/flash_fwd.cu``, which replaces the Pallas
``_fwd_kernel``) and, for its gradient, dQ and dK/dV
(``csrc/flash_bwd.cu``, which replace ``_dq_kernel`` and
``_dkv_kernel``). A CPU tensor goes to ``mha_reference``, with autograd
through it. ``mha_reference``, ``flash_bwd_dq_reference``,
``flash_bwd_dkv_reference`` and ``flash_bwd_reference`` (both backward
kernels in one) are the plain versions the kernels are held against.
There is no fallback between the two paths: a CUDA call, forward or
backward, launches the kernels or raises.
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


def _scores(q, k, v, do, lse, delta, causal: bool, scale: float):
    """P and dS in f32, in the TPU kernels' order: ``s = (q kᵀ) * scale``,
    the mask with ``DEFAULT_MASK_VALUE``, ``p = exp(s - lse)``,
    ``dp = do vᵀ``, ``ds = p (dp - delta) scale``."""
    seq_q, seq_k = q.shape[-2], k.shape[-2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = torch.where(_causal_mask(seq_q, seq_k, q.device), s,
                        DEFAULT_MASK_VALUE)
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None]) * scale


def flash_bwd_dq_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           o: torch.Tensor, do: torch.Tensor,
                           lse: torch.Tensor, causal: bool, scale: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2 (``_kernels.flash_bwd_dq``): (dq, delta).

    delta = rowsum(do * o) in f32 [B, H, S] (the plain versions' only
    delta formula, the JAX package's own); dS rounded to k's dtype
    before ``dq = dS k``, as the kernel rounds it; dq in q's dtype."""
    delta = (do.float() * o.float()).sum(-1)
    _, ds = _scores(q, k, v, do, lse, delta, causal, scale)
    dq = torch.matmul(ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype), delta


def flash_bwd_dkv_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor,
                            causal: bool, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3 (``_kernels.flash_bwd_dkv``): (dk, dv) from
    the delta that K2 returned. P and dS rounded to the inputs' dtype
    before their products; each gradient in its input's dtype."""
    p, ds = _scores(q, k, v, do, lse, delta, causal, scale)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, causal: bool, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the whole backward (K2, then K3 on K2's delta):
    (dq, dk, dv) from the forward's output ``o`` and ``lse``."""
    dq, delta = flash_bwd_dq_reference(q, k, v, o, do, lse, causal, scale)
    dk, dv = flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


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
        # K2 computes delta = rowsum(dO * O) on the way; K3 reads it.
        dq, delta = _kernels.flash_bwd_dq(q, k, v, out, do, lse, ctx.causal,
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
