"""Mixture-of-Experts: top-2 routing with capacity, dense dispatch.

Counterpart of ``ray_tpu/parallel/moe.py``. Routing (GShard style:
the second choice masked out of the first, queue positions continued
after all first choices, tokens past an expert's capacity dropped) and
the expert MLPs run in f32, the dispatch and combine as dense einsums
over [tokens, experts, capacity], as the JAX package's does. With
``axis_name`` (inside ``shard_map``, experts split over the axis) each
rank routes its own tokens, sends every expert's buffer to the rank that
holds the expert with one tiled ``all_to_all``, runs its experts, and
sends the outputs back with another; the aux loss is averaged over the
axis. The dispatch, combine and exchanges are plain torch: the JAX
package has no Pallas kernel for them.

``moe_layer_split`` is the MoE train step's form on a mesh (what XLA
makes of the JAX step's sharded expert weights): the tokens split over
the batch axes and routed as one batch, each expert's d_ff split over
``tp`` and the experts over ``ep``, the tokens replicated over both.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import ops


def _counts_before_and_total(counts: torch.Tensor, token_axes
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per expert: the routes of the ranks before this one along
    ``token_axes`` (row-major, the order of their blocks of the batch),
    and of every rank. No gradient."""
    if not token_axes:
        return torch.zeros_like(counts), counts
    mesh = ops.bound_mesh()
    every = ops._all_gather(counts.detach()[None],
                            ops.axis_group(mesh, token_axes), 0)
    me = ops.axis_coordinate(mesh, token_axes)[0]
    return every[:me].sum(0), every.sum(0)


def top2_gating(logits: torch.Tensor, capacity: int,
                token_axes: Optional[Sequence[str]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-2 gating with capacity dropping.

    logits [tokens, experts] -> (dispatch [T, E, C] bool, combine
    [T, E, C] f32, aux_loss scalar f32). ``dispatch`` is ``combine > 0``
    and carries no gradient; ties in the argmax go to the first expert.

    With ``token_axes`` (mesh axes bound by ``ops.bind``) the tokens are
    this rank's block of a batch split over those axes, and the blocks
    are routed as one batch, as the JAX step routes its global batch:
    each queue position counts the earlier ranks' routes to the expert
    (first choices, then second), ``capacity`` is the whole batch's, and
    the aux loss takes its means over every rank's tokens. Its gradient
    then reaches every rank's router whole (the probabilities' sum is
    all-reduced both ways), as the step's mean over ranks needs."""
    t, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)

    def choose(mask_prev: torch.Tensor) -> torch.Tensor:
        idx = torch.where(mask_prev, float("-inf"), probs).argmax(-1)
        return F.one_hot(idx, e).float()

    def place(onehot: torch.Tensor, offset: torch.Tensor):
        # 1-based position of each token in its expert's queue, after
        # the `offset` slots that earlier routes already took.
        pos = (onehot.cumsum(0) + offset[None, :]) * onehot
        keep = (pos > 0) & (pos <= capacity)
        pos0 = (pos - 1).clamp(0, capacity - 1).long()
        return keep, pos0

    oh1 = choose(torch.zeros_like(probs, dtype=torch.bool))
    oh2 = choose(oh1.bool())
    before1, total1 = _counts_before_and_total(oh1.sum(0), token_axes)
    before2, _ = _counts_before_and_total(oh2.sum(0), token_axes)
    keep1, pos1 = place(oh1, before1)
    keep2, pos2 = place(oh2, total1 + before2)

    g1 = (probs * oh1).sum(-1)
    g2 = (probs * oh2).sum(-1)
    denom = (g1 + g2).clamp_min(1e-9)
    g1, g2 = g1 / denom, g2 / denom

    def slots(onehot, keep, pos0):
        # [T, E, C]: the token's slot in its expert's queue, zero where
        # the route was dropped.
        slot = F.one_hot((pos0 * onehot.long()).sum(-1), capacity).float()
        kept = (keep & onehot.bool()).sum(-1, keepdim=True)[:, :, None]
        return onehot[:, :, None] * slot[:, None, :] * kept

    combine = (slots(oh1, keep1, pos1) * g1[:, None, None]
               + slots(oh2, keep2, pos2) * g2[:, None, None])
    dispatch = combine > 0
    # load-balancing aux loss (GShard eq. 4)
    if not token_axes:
        aux = (oh1.mean(0) * probs.mean(0)).sum() * (e ** 2) / e
    else:
        n = t * ops.axis_size(token_axes)
        p_sum = ops.grad_allreduce(ops.allreduce(probs.sum(0), token_axes),
                                   token_axes)
        aux = (total1 / n * (p_sum / n)).sum() * (e ** 2) / e
    return dispatch, combine, aux


def moe_layer(x: torch.Tensor, gate_w: torch.Tensor,
              expert_w1: torch.Tensor, expert_w2: torch.Tensor,
              capacity_factor: float = 1.25,
              axis_name: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-2 MoE FFN. x [tokens, d]; gate_w [d, E]; expert_w1 [E, d, f];
    expert_w2 [E, f, d] -> (y [tokens, d] in x's dtype, aux_loss).

    With ``axis_name``, call inside ``shard_map`` with the expert weights
    split on their expert axis (this rank's E / n experts) and ``x`` this
    rank's tokens: the tokens go to their experts' ranks and back. Out of
    a shard_map the axis name is unbound and raises NameError, as in
    JAX."""
    t, d = x.shape
    e = gate_w.shape[-1]
    logits = _router_logits(x, gate_w)
    capacity = max(1, int(capacity_factor * t * 2 / e))
    if axis_name is not None:
        n = ops.axis_size(axis_name)
    dispatch, combine, aux = top2_gating(logits, capacity)
    # [E, C, d] expert inputs built from this rank's tokens.
    xe = torch.einsum("td,tec->ecd", x.float(), dispatch.float())
    if axis_name is None:
        ye = _experts(xe, expert_w1, expert_w2)
        y = torch.einsum("ecd,tec->td", ye, combine)
        return y.to(x.dtype), aux

    # Expert-parallel: this rank owns e_local = E / n experts. Group the
    # buffers by destination rank, [n_dest, e_local, C, d]; after the
    # exchange recv[src, i] holds rank src's tokens for my expert i.
    e_local = expert_w1.shape[0]
    recv = ops.all_to_all(xe.reshape(n, e_local, capacity, d), axis_name,
                          split_axis=0, concat_axis=0)
    # Sources folded into the capacity axis: [e_local, n*C, d].
    xin = recv.transpose(0, 1).reshape(e_local, n * capacity, d)
    ye = _experts(xin, expert_w1, expert_w2)
    # Back to the source ranks: got[j, i] = my tokens' outputs from
    # expert j * e_local + i, i.e. the global expert axis in order.
    back = ye.reshape(e_local, n, capacity, d).transpose(0, 1)
    got = ops.all_to_all(back.contiguous(), axis_name, split_axis=0,
                         concat_axis=0)
    y = torch.einsum("ecd,tec->td", got.reshape(e, capacity, d), combine)
    return y.to(x.dtype), ops.allreduce_mean(aux, axis_name)


def moe_layer_split(x: torch.Tensor, gate_w: torch.Tensor,
                    expert_w1: torch.Tensor, expert_w2: torch.Tensor,
                    capacity_factor: float = 1.25, *,
                    tp: Optional[str] = None, ep: Optional[str] = None,
                    token_axes: Sequence[str] = ()
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-2 MoE FFN of the train step on a mesh (axis names bound by
    ``ops.bind``): ``moe_layer`` of the whole batch, split.

    x [tokens, d] is this rank's block of the batch split over
    ``token_axes`` (replicated over ``tp`` and ``ep``); gate_w [d, E]
    whole; expert_w1 [E / ep, d, f / tp] and expert_w2 [E / ep, f / tp,
    d] this rank's blocks. Every rank routes its tokens to all E experts
    (``top2_gating(token_axes=)``), takes its experts' buffers and runs
    its block of their MLPs; the outputs are summed over ``tp`` and
    gathered over ``ep`` before the combine (``_combine``), so the gating
    weights meet whole outputs and the router's gradient is whole on
    every rank. The "f" (identity forward, gradient summed backward) sits
    on the experts' input only: the router's share of x's gradient is
    already the same on every rank. A rank's [E, C, d] buffers are the
    whole batch's capacity C, its own tokens' slots filled (the other
    ranks' zero, and zero through the experts). Returns (y [tokens, d]
    in x's dtype, aux)."""
    t, d = x.shape
    e = gate_w.shape[-1]
    n_tok = ops.axis_size(tuple(token_axes)) if token_axes else 1
    capacity = max(1, int(capacity_factor * t * n_tok * 2 / e))
    logits = _router_logits(x, gate_w)
    dispatch, combine, aux = top2_gating(logits, capacity,
                                         tuple(token_axes) or None)
    xe = torch.einsum("td,tec->ecd", x.float(), dispatch.float())
    if ep is not None:
        xe = ops.take_block(xe, ep, 0)
    if tp is not None:
        xe = ops.grad_allreduce(xe, tp)
    ye = _experts(xe, expert_w1, expert_w2)
    return _combine(ye, combine, tp, ep).to(x.dtype), aux


def _router_logits(x: torch.Tensor, gate_w: torch.Tensor) -> torch.Tensor:
    """The router's f32 logits [tokens, E]."""
    return x.float() @ gate_w.float()


def _combine(ye: torch.Tensor, combine: torch.Tensor, tp: Optional[str],
             ep: Optional[str]) -> torch.Tensor:
    """This rank's experts' outputs [E / ep, C, d] (partial over ``tp``)
    made whole, summed over ``tp`` and gathered over ``ep``, then
    weighted by ``combine`` [tokens, E, C] into [tokens, d]."""
    if tp is not None:
        ye = ops.allreduce(ye, tp)
    if ep is not None:
        ye = ops.allgather_invariant(ye, ep, 0)
    return torch.einsum("ecd,tec->td", ye, combine)


def _experts(xe: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
             ) -> torch.Tensor:
    """Each expert's MLP on its buffer: [E, C, d] -> [E, C, d], f32."""
    h = F.gelu(torch.einsum("ecd,edf->ecf", xe, w1.float()),
               approximate="tanh")  # jax.nn.gelu's default form
    return torch.einsum("ecf,efd->ecd", h, w2.float())
