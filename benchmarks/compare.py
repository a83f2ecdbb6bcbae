"""The numbers that decide ``correct``: the program's outputs against the
plain reference's. Each is a gap that a sound run keeps small; the cell's
workload file gives each its limit.

Training (the first three steps of the one train-step object the window
then drives):

* ``loss_gap``: the largest absolute difference, in nats, between the
  program's and the reference's loss over the three steps;
* ``grad_norm_gap``: over the leaves, the largest gap between the norm
  of the first gradient as the program's optimizer got it (its first
  moment after one step over 1 - beta1) and the reference's, over the
  larger of the reference's norm of that leaf and of the median leaf;
* ``update_norm_gap``: the same of each leaf's change over the three
  steps, read before the fourth, leaving out leaves whose reference
  gradient is under a thousandth of the median leaf's (moved by
  round-off alone).

Batch generation: ``logit_gap``, the widest gap by which a served
token's reference logit lies below the reference's best at that
position, over a sample of the rows served.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional

import torch

# A leaf whose reference gradient norm is under this share of the median
# leaf's is left out of the update comparison.
ROUNDOFF_LEAF = 1e-3


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              leaves: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Per leaf of ``leaves`` (default: all of the reference's),
    |program - reference| / max(reference, median reference); a leaf the
    program lacks reads as a norm of 0."""
    names = list(reference if leaves is None else leaves)
    floor = statistics.median(reference.values())
    return {n: abs(program.get(n, 0.0) - reference[n])
            / max(reference[n], floor, 1e-30) for n in names}


def norm_gap(program: Dict[str, float], reference: Dict[str, float],
             leaves: Optional[Iterable[str]] = None) -> float:
    """The worst leaf's gap of ``leaf_gaps``."""
    return max(leaf_gaps(program, reference, leaves).values())


def moved_leaves(ref_grads: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding."""
    median = statistics.median(ref_grads.values())
    return [n for n, g in ref_grads.items() if g >= ROUNDOFF_LEAF * median]


def train_numbers(program: Dict, reference: Dict) -> Dict[str, float]:
    """The training numbers of ``program`` against ``reference``, each a
    dict of ``losses`` (one a compared step), ``g1`` (leaf -> norm of the
    first gradient) and ``d3`` (leaf -> norm of the change after the
    compared steps)."""
    losses = [abs(a - b) for a, b in zip(program["losses"],
                                          reference["losses"])]
    if len(program["losses"]) != len(reference["losses"]):
        losses.append(float("inf"))
    return {
        "loss_gap": max(losses),
        "grad_norm_gap": norm_gap(program["g1"], reference["g1"]),
        "update_norm_gap": norm_gap(program["d3"], reference["d3"],
                                    moved_leaves(reference["g1"])),
    }


def logit_gaps(ref_logits: torch.Tensor, chosen: torch.Tensor
               ) -> torch.Tensor:
    """Per position, how far the logit of ``chosen`` lies below the best
    of ``ref_logits`` [n, vocab]; an id outside the vocabulary reads
    infinite."""
    chosen = chosen.long()
    bad = (chosen < 0) | (chosen >= ref_logits.shape[-1])
    picked = ref_logits.gather(-1, chosen.clamp(0, ref_logits.shape[-1] - 1
                                                )[:, None])[:, 0]
    gap = ref_logits.max(dim=-1).values - picked
    return torch.where(bad, torch.full_like(gap, float("inf")), gap)


def leaf_norms(named: Iterable) -> Dict[str, float]:
    """path -> float32 2-norm of each (path, tensor)."""
    return {n: float(torch.linalg.vector_norm(t.detach().float()))
            for n, t in named}
