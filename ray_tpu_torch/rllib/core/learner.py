"""Learner: gradient updates on one device.

Reference parity: rllib/core/learner/learner.py:111 + learner_group.py:80,
ported from the JAX package's ``JaxLearner`` (``ray_tpu/rllib/core/
learner.py``): the same loss functions' gradients, clipped by global norm
and applied by Adam (``optax.chain(clip_by_global_norm, adam)`` there),
with the same piecewise-linear learning-rate schedules. The params live on
the learner's device (None: the CUDA card); ``get_weights`` hands back
host copies, as ``jax.device_get`` hands back host arrays.

The JAX learner shards the batch over a device mesh and drops a ragged
tail to a multiple of the device count; this learner has one device and
trains on every row.
"""
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..._device import DeviceLike, resolve_device
from ..._tree import tree_leaves, tree_map, tree_unflatten
from .rl_module import _flat, _writable

# optax.adam's defaults.
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _host(tree):
    return tree_map(lambda t, _: t.detach().to("cpu", copy=True), tree)


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
        zeros = lambda t, _: torch.zeros_like(t, requires_grad=False)
        self.opt_state = {"count": 0, "mu": tree_map(zeros, self.params),
                          "nu": tree_map(zeros, self.params)}

    def _device_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Numpy columns (or tensors) -> tensors on the device; floating
        columns as float32, as jnp.asarray makes them without x64."""
        out = {}
        for k, v in batch.items():
            t = v if torch.is_tensor(v) \
                else torch.as_tensor(_writable(np.asarray(v)))
            if t.is_floating_point():
                t = t.to(torch.float32)
            out[k] = t.to(self.device)
        return out

    def compute_gradients(self, batch: Dict[str, np.ndarray]
                          ) -> Tuple[torch.Tensor, Dict[str, Any], Any]:
        """(loss, aux, grads) of the loss on ``batch`` (the connector
        applied), grads a tree like the params; a param the loss does
        not reach gets zeros, as jax.grad gives it."""
        if self.connector is not None:
            batch = self.connector(dict(batch), module=self.module)
        leaves = tree_leaves(self.params)
        loss, aux = self.loss_fn(self.params, self.module,
                                 self._device_batch(batch))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss, aux, tree_unflatten(self.params, grads)

    @torch.no_grad()
    def apply_gradients(self, grads) -> None:
        """clip_by_global_norm(max_grad_norm) then Adam, as optax chains
        them: the gradients are scaled by max_norm / norm only when the
        norm reaches max_norm (no epsilon added, unlike
        ``clip_grad_norm_``); the step's learning rate is the schedule at
        the count of updates before it."""
        g = _flat(grads)
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(x) for x in g.values()]))
        scale = (self.max_grad_norm / norm).clamp(max=1.0)
        st = self.opt_state
        lr = self._lr(st["count"])
        st["count"] += 1
        bc1 = 1.0 - ADAM_B1 ** st["count"]
        bc2 = 1.0 - ADAM_B2 ** st["count"]
        mus, nus = _flat(st["mu"]), _flat(st["nu"])
        for key, p in _flat(self.params).items():
            grad, mu, nu = g[key] * scale, mus[key], nus[key]
            mu.mul_(ADAM_B1).add_(grad, alpha=1.0 - ADAM_B1)
            nu.mul_(ADAM_B2).addcmul_(grad, grad, value=1.0 - ADAM_B2)
            p.sub_(lr * (mu / bc1) / ((nu / bc2).sqrt() + ADAM_EPS))

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
