"""Carry weights from the JAX package to the port.

The models are plain dicts (and lists) of arrays in both packages, so one
converter covers them. Random streams differ between ``jax.random`` and
torch, so the port is held against the JAX package on converted weights,
never on weights drawn again.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device


# Leaves that the JAX families keep in float32 whatever the model dtype:
# the norm weights, MoE's router gate, ViT's learned positions, ResNet's
# batch-norm terms and statistics and its head bias.
FLOAT32_KEYS = frozenset({"ln1", "ln2", "lnf", "gate", "pos", "scale",
                          "bias", "mean", "var", "b"})


def _to_tensor(arr, device: torch.device, dtype: Optional[torch.dtype],
               key: Optional[str]) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 is not a numpy dtype torch knows: carry the
        # bits across as uint16 and reinterpret them.
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    if dtype is not None and t.is_floating_point() \
            and key not in FLOAT32_KEYS:
        t = t.to(dtype)
    return t.to(device)


def _tree_map(fn, node, key: Optional[str] = None):
    """``fn(leaf, key)`` over a tree of dicts and lists, ``key`` the name
    of the dict entry that holds the leaf (a list passes its own on)."""
    if isinstance(node, dict):
        return {k: _tree_map(fn, v, k) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_tree_map(fn, v, key) for v in node)
    return fn(node, key)


def tree_leaves(node: Any) -> list:
    """The tensors of a param dict (dicts and lists of tensors), in order."""
    if isinstance(node, dict):
        return [t for v in node.values() for t in tree_leaves(v)]
    if isinstance(node, (list, tuple)):
        return [t for v in node for t in tree_leaves(v)]
    return [node]


def from_jax_params(params: Any, device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> Any:
    """The JAX param dict (arrays, or numpy arrays of them) -> the same
    dict of tensors on ``device``.

    ``dtype``, when given, is the type of every floating leaf but those
    named in ``FLOAT32_KEYS``, which keep their own type, as the init
    functions keep them in float32 whatever the model dtype. The rule
    goes by the leaf's key: MoE's 2-D router gate and ViT's 2-D
    positions are float32 too."""
    device = resolve_device(device)
    return _tree_map(lambda arr, key: _to_tensor(arr, device, dtype, key),
                     params)


def params_to(params: Any, device: DeviceLike) -> Any:
    """A param dict with every tensor moved to ``device``."""
    device = resolve_device(device)
    return _tree_map(lambda t, _: t.to(device), params)
