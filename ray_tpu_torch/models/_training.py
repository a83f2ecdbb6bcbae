"""Shared train-step factory for the model families.

Counterpart of ``ray_tpu/models/_training.py``: every model family gets
the same (init_state, train_step) contract from (init_fn, loss_fn), and
the same mesh and partition-rule placement (``place_params``).

Where XLA inserts the data-parallel gradient psum from the shardings, the
port's step does it by hand: on a mesh, each rank computes the loss of its
slice of the global batch (``gpt.shard_batch``), then one flattened
all-reduce over the ``dp`` group averages the gradients (and the loss)
before AdamW, so every rank applies the same update to the same params.
Only the data-parallel rules run: a mesh with any other axis above 1, or
rules that would shard a param, raise ``NotImplementedError`` (ROADMAP.md
Queue 1 item 5).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .._device import DeviceLike, resolve_device
from .convert import params_to, tree_leaves

_LATER = ("the port runs the data-parallel rules only; tensor, FSDP, "
          "pipeline, sequence and expert sharding are ROADMAP.md Queue 1 "
          "item 5")


def default_optimizer(params: List[torch.Tensor]) -> torch.optim.Optimizer:
    """AdamW as ``optax.adamw(3e-4, weight_decay=0.01)``: optax's b1, b2
    and eps, moments in each param's dtype (its ``mu_dtype=None``), and
    the decay on every param (its ``mask=None``)."""
    return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


def _mesh_axes(mesh) -> Dict[str, int]:
    return {name: int(mesh.size(i))
            for i, name in enumerate(mesh.mesh_dim_names or ())}


def dp_group(mesh):
    """The mesh's ``dp`` process group, checking that ``dp`` is the only
    axis above 1. None when the mesh has no ``dp`` axis."""
    sizes = _mesh_axes(mesh)
    wider = {a: n for a, n in sizes.items() if a != "dp" and n > 1}
    if wider:
        raise NotImplementedError(f"mesh axes {wider}: {_LATER}")
    return mesh.get_group("dp") if "dp" in sizes else None


def _paired(params: Any, axes: Any) -> List[Tuple[torch.Tensor, Sequence]]:
    """(param, its logical axes) for every leaf, in ``tree_leaves`` order:
    the axes tree matches the params tree down to its tuples."""
    if isinstance(params, dict):
        return [x for k, v in params.items() for x in _paired(v, axes[k])]
    if isinstance(params, (list, tuple)):
        return [x for v, a in zip(params, axes) for x in _paired(v, a)]
    return [(params, axes)]


def place_params(params: Dict, axes: Dict, mesh, rules) -> Dict:
    """Put a param tree onto ``mesh`` per a logical-axis tree and a
    partition rule table, as the JAX package's ``place_params`` does.

    A param whose mesh axes all have size 1 is replicated: every rank of
    the ``dp`` group gets dp rank 0's values (one broadcast of the
    flattened params), so ranks that drew different weights start from
    the same ones. The params are updated in place and returned."""
    sizes = _mesh_axes(mesh)
    group = dp_group(mesh)
    for p, ax in _paired(params, axes):
        spec = rules.spec(ax)
        named = [a for entry in spec if entry is not None
                 for a in ((entry,) if isinstance(entry, str) else entry)]
        if any(sizes.get(a, 1) > 1 for a in named):
            raise NotImplementedError(
                f"rules shard a param of shape {tuple(p.shape)} over "
                f"{spec}: {_LATER}")
    if group is not None:
        import torch.distributed as dist

        src = dist.get_global_rank(group, 0)
        for dtype in sorted({p.dtype for p in tree_leaves(params)}, key=str):
            leaves = [p for p in tree_leaves(params) if p.dtype == dtype]
            with torch.no_grad():
                flat = torch.cat([p.reshape(-1) for p in leaves])
                dist.broadcast(flat, src=src, group=group)
                offset = 0
                for p in leaves:
                    p.copy_(flat[offset:offset + p.numel()].view_as(p))
                    offset += p.numel()
    return params


def make_train_step_for(
        init_fn: Callable[[torch.Generator], Dict],
        loss_fn: Callable[[Dict, Any], torch.Tensor],
        optimizer: Optional[Callable[[List[torch.Tensor]],
                                     torch.optim.Optimizer]] = None,
        device: DeviceLike = None, *,
        axes: Optional[Dict] = None, mesh=None, rules=None):
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
    passed in is the state returned, one step on.

    With ``mesh`` (a DeviceMesh from ``parallel.make_mesh``) and
    ``rules`` (and the family's ``axes``), ``init_state`` places the
    params with ``place_params`` and each step takes this rank's slice of
    the global batch; its gradients and its loss are averaged over the
    ``dp`` group in one flattened f32 all-reduce after ``backward`` and
    before AdamW, so the loss it returns is the global batch's, as JAX's
    is. The mesh's device type must be ``device``'s (NCCL on the card,
    gloo on the CPU)."""
    device = resolve_device(device)
    make_optimizer = optimizer or default_optimizer
    group = None
    if mesh is not None:
        if mesh.device_type != device.type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the step "
                             f"on {device}")
        group = dp_group(mesh)

    def init_state(generator: Optional[torch.Generator] = None, *,
                   params: Optional[Dict] = None) -> Dict:
        if params is None:
            params = init_fn(generator)
        params = params_to(params, device)
        if mesh is not None and rules is not None and axes is not None:
            params = place_params(params, axes, mesh, rules)
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
        loss = loss.detach()
        if group is not None:
            loss = _average_over(group, tree_leaves(state["params"]), loss)
        opt.step()
        state["step"] += 1
        return state, {"loss": loss}

    return init_state, train_step


def _average_over(group, params: List[torch.Tensor],
                  loss: torch.Tensor) -> torch.Tensor:
    """Average every param's gradient and the loss over ``group``: one
    all-reduce (sum) of one f32 buffer that holds them all, divided by the
    group's size, each gradient written back in its own dtype. Returns
    the averaged loss."""
    import torch.distributed as dist

    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [loss.reshape(1).float()])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[offset].to(loss.dtype)
