"""Shared train-step factory for the model families.

Counterpart of ``ray_tpu/models/_training.py``: every model family gets
the same (init_state, train_step) contract from (init_fn, loss_fn). The
JAX package's mesh and partition-rule placement (``place_params``) is
the data-parallel slice and is not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from .._device import DeviceLike, resolve_device
from .convert import params_to, tree_leaves


def default_optimizer(params: List[torch.Tensor]) -> torch.optim.Optimizer:
    """AdamW as ``optax.adamw(3e-4, weight_decay=0.01)``: optax's b1, b2
    and eps, moments in each param's dtype (its ``mu_dtype=None``), and
    the decay on every param (its ``mask=None``)."""
    return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


def make_train_step_for(
        init_fn: Callable[[torch.Generator], Dict],
        loss_fn: Callable[[Dict, Any], torch.Tensor],
        optimizer: Optional[Callable[[List[torch.Tensor]],
                                     torch.optim.Optimizer]] = None,
        device: DeviceLike = None):
    """Build (init_state, train_step) for a model family.

    ``init_fn(generator) -> params``; ``loss_fn(params, batch) -> scalar``;
    ``optimizer(list of params) -> torch.optim.Optimizer`` (default
    ``default_optimizer``). ``init_state(generator)`` draws the params;
    ``init_state(params=...)`` takes given ones instead (weights converted
    from the JAX package, say), moved to ``device``; the state then owns
    those tensors. Either way the state is ``{"params", "opt_state",
    "step"}``, with the optimizer as ``opt_state``.

    ``train_step(state, (inputs, targets))`` (tokens and next tokens, or
    images and labels; numpy arrays or tensors, moved to ``device``) returns
    ``(state, {"loss": loss})`` with the loss a 0-dim tensor on the device,
    not fetched. Where JAX donates the state to the step, the port
    updates the params and the optimizer's moments in place: the state
    passed in is the state returned, one step on."""
    device = resolve_device(device)
    make_optimizer = optimizer or default_optimizer

    def init_state(generator: Optional[torch.Generator] = None, *,
                   params: Optional[Dict] = None) -> Dict:
        if params is None:
            params = init_fn(generator)
        params = params_to(params, device)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        return {"params": params, "opt_state": make_optimizer(leaves),
                "step": 0}

    def train_step(state: Dict, batch):
        opt = state["opt_state"]
        opt.zero_grad(set_to_none=True)
        inputs, targets = (torch.as_tensor(x, device=device) for x in batch)
        loss = loss_fn(state["params"], (inputs, targets))
        loss.backward()
        opt.step()
        state["step"] += 1
        return state, {"loss": loss.detach()}

    return init_state, train_step
