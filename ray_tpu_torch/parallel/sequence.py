"""Sequence/context parallelism: ring attention and Ulysses.

Counterpart of ``ray_tpu/parallel/sequence.py``. Each rank holds a
sequence shard of Q/K/V. Ring attention rotates the K/V blocks around
the ``sp`` axis with ``ppermute`` while each rank accumulates blockwise
causal attention under a running online softmax, so no rank holds more
than an [S_local, S_local] block of scores. Ulysses swaps the sharded
axis from sequence to heads with ``all_to_all``, runs whole-sequence
attention on its heads (``attn_fn``; the flash kernels when it is
``ops.flash_attention``) and swaps back.

Call both inside ``shard_map`` over the axis (``sequence_parallel_attention``
wraps ring attention). The block math is plain torch (einsums in f32),
as the JAX package's is plain jnp: it has no Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.attention import DEFAULT_MASK_VALUE
from . import ops
from .partition import PartitionSpec


def _block_attn(q, k, v, scale: float, mask):
    """One blockwise attention contribution with stable statistics:
    (unnormalized out f32, row max f32, row sum-exp f32). q [B,H,Sq,D],
    k/v [B,H,Sk,D], mask [Sq,Sk] bool."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1)
    # Fully masked rows: keep exp() finite.
    m_safe = torch.clamp(m, min=DEFAULT_MASK_VALUE / 2)
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v).float()
    return out, m_safe, l


def _block_step(mask, scale: float, q, kt, vt, acc, m, l):
    out_b, m_b, l_b = _block_attn(q, kt, vt, scale, mask)
    m_new = torch.maximum(m, m_b)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(m_b - m_new)
    acc = acc * alpha[..., None] + out_b * beta[..., None]
    l = l * alpha + l_b * beta
    return acc, m_new, l


def ring_attention(q, k, v, axis_name: str = "sp",
                   sm_scale: Optional[float] = None):
    """Causal ring attention; call inside ``shard_map`` over ``axis_name``.

    q/k/v: local sequence shards [B, H, S_local, D]; the global sequence
    is their concatenation in rank order. Returns [B, H, S_local, D].

    Each step issues the next K/V hop (``ops.ppermute_start``), runs the
    current block's math while it travels, and only then waits for it;
    the two share no data. Each block step is checkpointed
    (``torch.utils.checkpoint`` for ``jax.checkpoint``): the backward
    recomputes a block's probabilities instead of keeping one
    [S_local, S_local] matrix per step. The hops chain each step's K/V
    on the previous one's, so the reverse hops of the backward (each
    waited for where it is sent) run in one order on every rank."""
    n = ops.axis_size(axis_name)
    rank = ops.axis_index(axis_name)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    b, h, s_local, d = q.shape
    tri = torch.ones(s_local, s_local, dtype=torch.bool,
                     device=q.device).tril()
    full = torch.ones_like(tri)
    none = torch.zeros_like(tri)
    perm = [(i, (i + 1) % n) for i in range(n)]

    acc = torch.zeros((b, h, s_local, d), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, h, s_local), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s_local), dtype=torch.float32, device=q.device)
    kt, vt = k, v
    for t in range(n):
        if t + 1 < n:
            # Next hop first: it travels during this block's math.
            hop = ops.ppermute_start((kt, vt), axis_name, perm)
        # After t hops this rank holds the block of rank (rank - t) mod n:
        # earlier blocks are fully visible, its own causal, later none.
        src = (rank - t) % n
        mask = full if src < rank else tri if src == rank else none
        if torch.is_grad_enabled():
            acc, m, l = checkpoint(_block_step, mask, scale, q, kt, vt,
                                   acc, m, l, use_reentrant=False)
        else:
            acc, m, l = _block_step(mask, scale, q, kt, vt, acc, m, l)
        if t + 1 < n:
            kt, vt = hop()
    l = torch.clamp(l, min=1e-30)
    return (acc / l[..., None]).to(q.dtype)


def sequence_parallel_attention(mesh, q, k, v, axis_name: str = "sp",
                                sm_scale: Optional[float] = None):
    """``shard_map`` wrapper: q/k/v global [B, H, S, D]; the sequence is
    split over ``axis_name`` and ring attention runs on the shards."""
    spec = PartitionSpec(None, None, axis_name, None)
    fn = ops.shard_map(
        lambda q_, k_, v_: ring_attention(q_, k_, v_, axis_name, sm_scale),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
    return fn(q, k, v)


def ulysses_attention(q, k, v, axis_name: str = "sp",
                      sm_scale: Optional[float] = None, attn_fn=None):
    """Ulysses/DeepSpeed-style sequence parallelism; call inside
    ``shard_map``. all_to_all swaps the sharded axis from sequence to
    heads, ``attn_fn(q, k, v, causal, sm_scale)`` (default
    ``mha_reference``, as in JAX) runs causal attention on this rank's
    heads over the whole sequence, and all_to_all swaps back. Needs
    n_heads % axis_size == 0. q/k/v: [B, H, S_local, D]."""
    from ..ops.attention import mha_reference

    attn = attn_fn or mha_reference
    # [B, H, S/n, D] -> [B, H/n, S, D], the three as one exchange each.
    q, k, v = (ops.all_to_all(x, axis_name, split_axis=1, concat_axis=2)
               for x in (q, k, v))
    out = attn(q.contiguous(), k.contiguous(), v.contiguous(), True,
               sm_scale)
    # back: [B, H/n, S, D] -> [B, H, S/n, D]
    return ops.all_to_all(out, axis_name, split_axis=2, concat_axis=1)
