"""Mixture-of-Experts: top-2 routing with capacity, dense dispatch.

Counterpart of ``ray_tpu/parallel/moe.py`` on one device. Routing
(GShard style: the second choice masked out of the first, queue
positions continued after all first choices, tokens past an expert's
capacity dropped) and the expert MLPs run in f32, the dispatch and
combine as dense einsums over [tokens, experts, capacity], as the JAX
package's single-shard branch does. Its expert-parallel branch (an
all-to-all over a mesh axis) belongs to the parallel-strategies slice
(``ROADMAP.md``, Queue 1) and is not ported: ``moe_layer`` raises for it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def top2_gating(logits: torch.Tensor, capacity: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-2 gating with capacity dropping.

    logits [tokens, experts] -> (dispatch [T, E, C] bool, combine
    [T, E, C] f32, aux_loss scalar f32). ``dispatch`` is ``combine > 0``
    and carries no gradient; ties in the argmax go to the first expert."""
    t, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)

    def one_route(mask_prev: torch.Tensor, offset: torch.Tensor):
        idx = torch.where(mask_prev, float("-inf"), probs).argmax(-1)
        onehot = F.one_hot(idx, e).float()
        # 1-based position of each token in its expert's queue, after
        # the `offset` slots that earlier routes already took.
        pos = (onehot.cumsum(0) + offset[None, :]) * onehot
        keep = (pos > 0) & (pos <= capacity)
        pos0 = (pos - 1).clamp(0, capacity - 1).long()
        return onehot, keep, pos0

    oh1, keep1, pos1 = one_route(torch.zeros_like(probs, dtype=torch.bool),
                                 torch.zeros(e, device=probs.device))
    oh2, keep2, pos2 = one_route(oh1.bool(), oh1.sum(0))

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
    aux = (oh1.mean(0) * probs.mean(0)).sum() * (e ** 2) / e
    return dispatch, combine, aux


def moe_layer(x: torch.Tensor, gate_w: torch.Tensor,
              expert_w1: torch.Tensor, expert_w2: torch.Tensor,
              capacity_factor: float = 1.25,
              axis_name: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-2 MoE FFN on one device. x [tokens, d]; gate_w [d, E];
    expert_w1 [E, d, f]; expert_w2 [E, f, d] -> (y [tokens, d] in x's
    dtype, aux_loss). ``axis_name`` (expert parallelism) is not ported
    and raises NotImplementedError."""
    if axis_name is not None:
        raise NotImplementedError(
            f"moe_layer(axis_name={axis_name!r}): the expert-parallel "
            "branch belongs to the port's parallel-strategies slice "
            "(ROADMAP.md, Queue 1) and is not ported yet")
    t = x.shape[0]
    e = gate_w.shape[-1]
    logits = x.float() @ gate_w.float()
    capacity = max(1, int(capacity_factor * t * 2 / e))
    dispatch, combine, aux = top2_gating(logits, capacity)
    xe = torch.einsum("td,tec->ecd", x.float(), dispatch.float())
    h = F.gelu(torch.einsum("ecd,edf->ecf", xe, expert_w1.float()),
               approximate="tanh")  # jax.nn.gelu's default form
    ye = torch.einsum("ecf,efd->ecd", h, expert_w2.float())
    y = torch.einsum("ecd,tec->td", ye, combine)
    return y.to(x.dtype), aux
