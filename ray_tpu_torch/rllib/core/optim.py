"""Adam by hand, as ``optax.adam`` computes it.

The JAX package's learner chains ``optax.clip_by_global_norm`` before
``optax.adam``; its SAC, CQL, TD3 and DreamerV3 updates call bare
``optax.adam`` (one state for SAC's actor, critics and temperature
together, two for TD3, three for DreamerV3). This is that bare Adam over a
tree of tensors (``_tree``'s dicts and lists), with optax's defaults: bias
correction on both moments and the epsilon outside the square root. The
clip stays in ``TorchLearner``.
"""
from typing import Any, Dict

import torch

from ..._tree import tree_map, tree_paths

# optax.adam's defaults.
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def adam_init(params: Any) -> Dict[str, Any]:
    """A fresh state for ``params``: no step taken, both moments zero."""
    zeros = lambda t, _: torch.zeros_like(t, requires_grad=False)
    return {"count": 0, "mu": tree_map(zeros, params),
            "nu": tree_map(zeros, params)}


@torch.no_grad()
def adam_step(params: Any, grads: Any, state: Dict[str, Any],
              lr: float) -> None:
    """One Adam step of ``lr`` on ``params`` (in place) and ``state``;
    ``grads`` is a tree like ``params``, matched to it by path."""
    state["count"] += 1
    bc1 = 1.0 - ADAM_B1 ** state["count"]
    bc2 = 1.0 - ADAM_B2 ** state["count"]
    g, mus, nus = (tree_paths(t) for t in (grads, state["mu"],
                                           state["nu"]))
    for key, p in tree_paths(params).items():
        mu, nu = mus[key], nus[key]
        mu.mul_(ADAM_B1).add_(g[key], alpha=1.0 - ADAM_B1)
        nu.mul_(ADAM_B2).addcmul_(g[key], g[key], value=1.0 - ADAM_B2)
        p.sub_(lr * (mu / bc1) / ((nu / bc2).sqrt() + ADAM_EPS))
