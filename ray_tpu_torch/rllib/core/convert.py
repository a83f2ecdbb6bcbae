"""Carry RL module params between the JAX package's flax trees and the
port's param dicts.

The port keeps flax's tree (module names, nesting) and torch's layouts
at the leaves:

- ``Dense`` ``{"kernel": (in, out), "bias"}`` -> ``{"weight": (out, in),
  "bias"}``, as ``nn.Linear`` holds it;
- ``Conv`` ``{"kernel": HWIO, "bias"}`` -> ``{"weight": OIHW, "bias"}``;
- ``OptimizedLSTMCell`` ``{"ii", "if", "ig", "io": {"kernel"}, "hi",
  "hf", "hg", "ho": {"kernel", "bias"}}`` -> ``{"weight_ih": (4H, in),
  "weight_hh": (4H, H), "bias_hh": (4H,)}``, the gates packed in torch's
  order i, f, g, o. flax's input kernels carry no bias, and the port keeps
  no ``bias_ih`` (``catalog.LSTMCell``);
- DreamerV3's plain tree (``algorithms/dreamerv3.py``): lists of
  ``{"w", "b"}`` dense layers with ``w`` as (in, out), and conv and deconv
  ``{"w", "b"}`` with ``w`` in HWIO, go across leaf for leaf in the JAX
  package's layouts. That module keeps them so: it lays a kernel out for
  torch at call time (a deconv's flipped in both spatial dims, since
  ``jax.lax.conv_transpose`` does not flip its kernel and
  ``F.conv_transpose2d`` does).

Leaves go through ``models/convert.py``'s ``_to_tensor``, which casts by
key; RL params are float32 throughout.
"""
from typing import Any, Dict

import numpy as np
import torch

from ..._device import DeviceLike, resolve_device
from ...models.convert import _to_tensor

GATES = ("i", "f", "g", "o")


def _is_lstm(node: Dict[str, Any]) -> bool:
    return set(node) == {"i" + g for g in GATES} | {"h" + g for g in GATES}


def _port_layout(node: Any) -> Any:
    """A flax subtree -> the port's layout, leaves still numpy."""
    if isinstance(node, (list, tuple)):
        return [_port_layout(v) for v in node]
    if not isinstance(node, dict):
        return np.asarray(node)
    if _is_lstm(node):
        return {
            "weight_ih": np.concatenate(
                [np.asarray(node["i" + g]["kernel"]).T for g in GATES]),
            "weight_hh": np.concatenate(
                [np.asarray(node["h" + g]["kernel"]).T for g in GATES]),
            "bias_hh": np.concatenate(
                [np.asarray(node["h" + g]["bias"]) for g in GATES])}
    if "kernel" in node:
        kernel = np.asarray(node["kernel"])
        axes = (1, 0) if kernel.ndim == 2 else (3, 2, 0, 1)
        return {"weight": np.ascontiguousarray(kernel.transpose(axes)),
                "bias": np.asarray(node["bias"])}
    return {k: _port_layout(v) for k, v in node.items()}


def from_flax_params(params: Any, device: DeviceLike = None) -> Any:
    """A flax param tree (the JAX package's ``init_params`` or
    ``get_weights()``, arrays or numpy) -> the port's param dict on
    ``device`` (None: the CUDA card)."""
    device = resolve_device(device)

    def to_tensors(node, key=None):
        if isinstance(node, dict):
            return {k: to_tensors(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [to_tensors(v, key) for v in node]
        return _to_tensor(node, device, None, key)

    return to_tensors(_port_layout(params))


def _flax_layout(node: Any) -> Any:
    if isinstance(node, (list, tuple)):
        return [_flax_layout(v) for v in node]
    if not isinstance(node, dict):
        return node.detach().cpu().numpy()
    if "weight_ih" in node:
        n = node["weight_hh"].shape[1]
        w_ih, w_hh, b_hh = (_flax_layout(node[k]) for k in
                            ("weight_ih", "weight_hh", "bias_hh"))
        out = {}
        for i, g in enumerate(GATES):
            rows = slice(i * n, (i + 1) * n)
            out["i" + g] = {"kernel": w_ih[rows].T}
            out["h" + g] = {"kernel": w_hh[rows].T, "bias": b_hh[rows]}
        return out
    if "weight" in node:
        weight = _flax_layout(node["weight"])
        axes = (1, 0) if weight.ndim == 2 else (2, 3, 1, 0)
        return {"kernel": np.ascontiguousarray(weight.transpose(axes)),
                "bias": _flax_layout(node["bias"])}
    return {k: _flax_layout(v) for k, v in node.items()}


def to_flax_params(params: Any) -> Any:
    """The port's param dict (any device) -> the flax tree as numpy, the
    inverse of ``from_flax_params``."""
    with torch.no_grad():
        return _flax_layout(params)
