"""The vocab-parallel pieces of the Megatron decoders (GPT, llama, MoE).

Under tensor parallelism (a ``tp`` axis bound by ``parallel.ops.bind``)
each rank holds a block of the vocab: rows of the token embedding and
columns of the output projection. A lookup takes the rows this rank
holds and sums the ranks' results over ``tp``; the cross entropy runs on
each rank's logit columns with the max, the sum of exponentials and the
target's logit combined over ``tp``. The values and the gradients are
the unsplit model's.
"""

from __future__ import annotations

import torch

from ..parallel.ops import allreduce, allreduce_max, axis_index


def vocab_offset(block_rows: int, tp: str) -> int:
    """The first vocab id of this rank's block of ``block_rows`` ids."""
    return axis_index(tp) * block_rows


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor,
                 tp: str) -> torch.Tensor:
    """``embed``'s rows for ``tokens`` with ``embed`` this rank's vocab
    rows: each rank looks up the tokens it holds (zeros elsewhere) and
    the lookups are summed over ``tp``."""
    local = tokens - vocab_offset(embed.shape[0], tp)
    inside = (local >= 0) & (local < embed.shape[0])
    x = embed[local.clamp(0, embed.shape[0] - 1)] * inside[..., None]
    return allreduce(x, tp)


def log_likelihood_sum(logits: torch.Tensor, targets: torch.Tensor,
                       tp: str, lo: int) -> torch.Tensor:
    """Sum over rows of log softmax(logits)[target]: ``logits`` [rows,
    this rank's vocab columns] f32, ``targets`` [rows] global ids, ``lo``
    the first id of this rank's columns. The max carries no gradient;
    the sum of exponentials and the target's logit are summed over
    ``tp`` by one all-reduce."""
    local = targets - lo
    inside = (local >= 0) & (local < logits.shape[1])
    tgt = logits.gather(1, local.clamp(0, logits.shape[1] - 1)[:, None])[:, 0]
    m = allreduce_max(logits.max(dim=-1).values, tp)
    sums = allreduce(torch.stack([
        (logits - m[:, None]).exp().sum(-1),
        torch.where(inside, tgt, torch.zeros_like(tgt))]), tp)
    return (sums[1] - (m + sums[0].log())).sum()
