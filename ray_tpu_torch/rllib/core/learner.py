"""Learner: gradient updates on one device.

Reference parity: rllib/core/learner/learner.py:111 + learner_group.py:80,
ported from the JAX package's ``JaxLearner`` (``ray_tpu/rllib/core/
learner.py``): the same loss functions' gradients, clipped by global norm
and applied by Adam (``optax.chain(clip_by_global_norm, adam)`` there),
with the same piecewise-linear learning-rate schedules. The params live on
the learner's device (None: the CUDA card); ``get_weights`` hands back
host copies, as ``jax.device_get`` hands back host arrays. The Adam step
is ``core/optim.py``'s, which the algorithms with optimizers of their own
(SAC, CQL, TD3, DreamerV3) call bare.

The JAX learner shards the batch over a device mesh and drops a ragged
tail to a multiple of the device count; this learner has one device and
trains on every row.
"""
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..._device import DeviceLike, resolve_device
from ..._tree import tree_leaves, tree_map, tree_unflatten
from .optim import adam_init, adam_step
from .rl_module import _writable


def _host(tree):
    """Host copies of a tree's tensors (other leaves as they are)."""
    return tree_map(lambda t, _: t.detach().to("cpu", copy=True)
                    if torch.is_tensor(t) else t, tree)


def clone_tree(tree, device: Optional[torch.device] = None):
    """A detached copy of a tree's tensors (on ``device`` when given);
    other leaves (step counts) as they are."""
    return tree_map(lambda t, _: t.detach().to(device or t.device,
                                               copy=True)
                    if torch.is_tensor(t) else t, tree)


def trainable(tree):
    """``tree``'s tensors as leaves that take gradients."""
    return tree_map(lambda t, _: t.requires_grad_(True), tree)


def gradients(loss: torch.Tensor, tree):
    """d loss / d each tensor of ``tree``, a tree like it; a leaf the loss
    does not reach gets zeros, as jax.grad gives it."""
    leaves = tree_leaves(tree)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return tree_unflatten(tree, [torch.zeros_like(t) if g is None else g
                                 for t, g in zip(leaves, grads)])


def scalars(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """0-dim metric tensors -> floats, in one copy to the host."""
    names = list(metrics)
    values = torch.stack([metrics[k].detach().float()
                          for k in names]).tolist()
    return dict(zip(names, values))


def load_state(state, device: torch.device):
    """A copy of an update's state (SAC, TD3, DreamerV3: host tensors
    from a checkpoint, or another state) on ``device``, its params and
    SAC's temperature taking gradients."""
    state = clone_tree(state, device)
    trainable(state["params"])
    if "log_alpha" in state:
        state["log_alpha"].requires_grad_(True)
    return state


def device_batch(batch: Dict[str, Any], device: torch.device
                 ) -> Dict[str, torch.Tensor]:
    """Numpy columns (or tensors) -> tensors on ``device``; floating
    columns as float32, as jnp.asarray makes them without x64."""
    out = {}
    for k, v in batch.items():
        t = v if torch.is_tensor(v) \
            else torch.as_tensor(_writable(np.asarray(v)))
        if t.is_floating_point():
            t = t.to(torch.float32)
        out[k] = t.to(device)
    return out


class TorchLearner:
    """Reference: learner.py:111 (build/update/get|set_state)."""

    def __init__(self, module, loss_fn: Callable,
                 lr: float = 3e-4, max_grad_norm: float = 0.5,
                 seed: int = 0, device: DeviceLike = None,
                 connector: Optional[Callable] = None):
        self.device = resolve_device(device)
        self.module = module
        self.loss_fn = loss_fn
        # Learner connector: numpy batch transform applied before the
        # update (reference: rllib/connectors/learner/).
        self.connector = connector
        self.max_grad_norm = float(max_grad_norm)
        if isinstance(lr, (list, tuple)):
            # Schedule-format lr (reference: `lr=[[t, v], ...]` +
            # utils/schedules/Scheduler): piecewise-linear over OPTIMIZER
            # update steps, counted from 0 (optax's schedule count).
            ts = np.asarray([float(t) for t, _ in lr], dtype=np.float32)
            vs = np.asarray([float(v) for _, v in lr], dtype=np.float32)
            self._lr = lambda step: float(np.interp(step, ts, vs))
        else:
            self._lr = lambda step: float(lr)
        self.set_weights(module.init_params(seed))
        self.opt_state = adam_init(self.params)

    def compute_gradients(self, batch: Dict[str, np.ndarray]
                          ) -> Tuple[torch.Tensor, Dict[str, Any], Any]:
        """(loss, aux, grads) of the loss on ``batch`` (the connector
        applied), grads a tree like the params; a param the loss does
        not reach gets zeros, as jax.grad gives it."""
        if self.connector is not None:
            batch = self.connector(dict(batch), module=self.module)
        loss, aux = self.loss_fn(self.params, self.module,
                                 device_batch(batch, self.device))
        return loss, aux, gradients(loss, self.params)

    @torch.no_grad()
    def apply_gradients(self, grads) -> None:
        """clip_by_global_norm(max_grad_norm) then Adam, as optax chains
        them: the gradients are scaled by max_norm / norm only when the
        norm reaches max_norm (no epsilon added, unlike
        ``clip_grad_norm_``); the step's learning rate is the schedule at
        the count of updates before it."""
        g = tree_leaves(grads)
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(x) for x in g]))
        scale = (self.max_grad_norm / norm).clamp(max=1.0)
        adam_step(self.params, tree_map(lambda x, _: x * scale, grads),
                  self.opt_state, self._lr(self.opt_state["count"]))

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        loss, aux, grads = self.compute_gradients(batch)
        self.apply_gradients(grads)
        # One device-to-host copy for the loss and every scalar aux;
        # vector aux entries (e.g. per-sample |td| for prioritized
        # replay) pass through as arrays.
        names = [k for k, v in aux.items() if v.ndim == 0]
        values = torch.stack([loss.detach()] + [aux[k].detach()
                                                for k in names]).tolist()
        scalars = dict(zip(names, values[1:]))
        out = {"total_loss": values[0]}
        for k, v in aux.items():
            out[k] = scalars[k] if k in scalars \
                else v.detach().cpu().numpy()
        return out

    # -- state (reference: Checkpointable get_state/set_state) -------------
    def get_weights(self):
        return _host(self.params)

    def set_weights(self, params):
        self.params = tree_map(
            lambda t, _: torch.as_tensor(t).detach().to(
                self.device, copy=True).requires_grad_(), params)

    def get_state(self) -> Dict[str, Any]:
        st = self.opt_state
        return {"params": self.get_weights(),
                "opt_state": {"count": st["count"], "mu": _host(st["mu"]),
                              "nu": _host(st["nu"])}}

    def set_state(self, state: Dict[str, Any]):
        self.set_weights(state["params"])
        st = state["opt_state"]
        move = lambda t, _: torch.as_tensor(t).to(self.device, copy=True)
        self.opt_state = {"count": int(st["count"]),
                          "mu": tree_map(move, st["mu"]),
                          "nu": tree_map(move, st["nu"])}
