"""Shared train-step factory for the model families.

Counterpart of ``ray_tpu/models/_training.py``: every model family gets
the same (init_state, train_step) contract from (init_fn, loss_fn), and
the same mesh and partition-rule placement (``place_params``).

Where XLA inserts the collectives from the params' shardings, the port's
step does them by hand. On a mesh each rank holds its block of every
param (``place_params``) and of the AdamW moments, and takes its rows of
the global batch (``gpt.shard_batch``). Per step:

* fsdp: the loss runs on params gathered over ``fsdp`` by one autograd
  Function (all-gather forward, reduce-scatter of the gradients
  backward), so the gradients come back as this rank's blocks;
* tp (and MoE's ep): the family's loss runs its Megatron form on the
  blocks (GPT, llama, ViT and the MoE decoder; the collectives are in
  the model code), and its gradients are complete on each rank.
  ``split_model_axes`` checks that the rules split each param as the
  family's layout table has it and raises for any other split;
* dp, dp_dcn (and fsdp for a param it does not shard): the gradients
  are summed over the batch axes in flattened f32 all-reduces, one per
  set of axes, and every gradient and the loss are divided by the
  number of batch shards, so AdamW sees the global batch's mean gradient
  and each rank applies it to its own blocks.

The batch axes are ``dp_dcn``, ``dp`` and ``fsdp``. Each rank's loss is
the mean over its rows; with equal rows a rank, the mean of those means
is the global batch's mean, whether or not ranks of an axis hold the
same rows. The MoE decoder routes the tokens of every batch shard as one
batch (``parallel.moe.top2_gating(token_axes=)``), as JAX's step routes
the global batch. Pipeline and sequence parallelism run through
``parallel.pipeline`` and ``parallel.sequence`` under ``shard_map``, as
in the JAX package, whose step only replicates over ``pp`` and ``sp``: a
mesh with ``pp`` or ``sp`` above 1 raises here, and so does ``ep`` above
1 for a family without experts.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .._device import DeviceLike, resolve_device
from .._tree import tree_leaves, tree_unflatten
from ..parallel.ops import (_all_gather, _all_reduce, _names,
                            _reduce_scatter, axis_coordinate, axis_group,
                            bind)
from ..parallel.partition import PartitionSpec, named_sharding
from ..util import tracing
from .convert import params_to

BATCH_AXES = ("dp_dcn", "dp", "fsdp")
# Axes whose parallelism lives in its own functions, not in the step
# (ep runs in the MoE step, which names it among its model axes).
_OWN_FUNCTIONS = ("pp", "sp", "ep")
_ROADMAP = "ROADMAP.md, Queue 1, \"Left out on purpose\""


def default_optimizer(params: List[torch.Tensor],
                      lr: float = 3e-4) -> torch.optim.Optimizer:
    """AdamW as ``optax.adamw(lr, weight_decay=0.01)``: optax's b1, b2
    and eps, moments in each param's dtype (its ``mu_dtype=None``), and
    the decay on every param (its ``mask=None``)."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


def _mesh_axes(mesh) -> Dict[str, int]:
    return {name: int(mesh.size(i))
            for i, name in enumerate(mesh.mesh_dim_names or ())}


def check_mesh(mesh, model_axes: Sequence[str] = ()) -> Dict[str, int]:
    """The mesh's axis sizes, raising for an axis the step does not run:
    ``pp`` and ``sp`` above 1, and ``ep`` above 1 unless the family's
    ``model_axes`` name it (the MoE decoder's)."""
    sizes = _mesh_axes(mesh)
    own = {a: n for a, n in sizes.items()
           if a in _OWN_FUNCTIONS and a not in model_axes and n > 1}
    if own:
        raise NotImplementedError(
            f"mesh axes {own}: the train step runs dp, dp_dcn, fsdp and tp "
            "(and ep for the MoE decoder); pipeline, sequence and expert "
            "parallelism run through parallel.pipeline, parallel.sequence "
            "and parallel.moe under shard_map, as in the JAX package, "
            f"whose step only replicates over them ({_ROADMAP})")
    return sizes


def batch_axes_of(mesh) -> Tuple[str, ...]:
    """The batch axes above 1 of ``mesh``, in the mesh's order: the axes
    ``shard_batch`` splits the rows over."""
    sizes = _mesh_axes(mesh) if mesh is not None else {}
    return tuple(a for a in BATCH_AXES if sizes.get(a, 1) > 1)


def _paired(params: Any, axes: Any, key: Optional[str] = None
            ) -> List[Tuple[torch.Tensor, Sequence, Optional[str]]]:
    """(param, its logical axes, its dict key) for every leaf, in
    ``tree_leaves`` order: the axes tree matches the params tree down to
    its tuples."""
    if isinstance(params, dict):
        return [x for k, v in params.items() for x in _paired(v, axes[k], k)]
    if isinstance(params, (list, tuple)):
        return [x for v, a in zip(params, axes) for x in _paired(v, a, key)]
    return [(params, axes, key)]


def _axes_leaves(axes: Any) -> List[Sequence]:
    if isinstance(axes, dict):
        return [x for v in axes.values() for x in _axes_leaves(v)]
    if isinstance(axes, list) or (isinstance(axes, tuple) and not all(
            a is None or isinstance(a, str) for a in axes)):
        return [x for v in axes for x in _axes_leaves(v)]
    return [axes]


def leaf_spec(mesh, rules, logical_axes: Sequence) -> PartitionSpec:
    """A leaf's PartitionSpec on ``mesh`` with the axes of size 1 (or
    absent) dropped: the dims that are really split."""
    sizes = _mesh_axes(mesh)
    spec = named_sharding(mesh, rules, logical_axes).spec
    out = []
    for entry in spec:
        kept = tuple(a for a in _names(entry) if sizes.get(a, 1) > 1)
        out.append(None if not kept else kept[0] if len(kept) == 1
                   else kept)
    return PartitionSpec(*out)


def sharding_axes(axes: Any, mesh, rules) -> set:
    """Every mesh axis that splits some param."""
    return {a for ax in _axes_leaves(axes)
            for entry in leaf_spec(mesh, rules, ax) for a in _names(entry)}


def split_model_axes(family: str, axes: Dict, mesh, rules,
                     layout: Dict[str, Dict[str, Tuple[int, ...]]],
                     heads: int, model_axes: Sequence[str] = ("tp",)
                     ) -> Tuple[str, ...]:
    """The axes of ``model_axes`` over which the rules split some of the
    family's params on ``mesh`` (empty without a mesh and rules), checking
    that they split every param as Megatron's layout has it.

    ``layout`` maps a param's key (a layer's, or a top-level one) to
    ``{axis: the dims that axis splits}``; a key or an axis it leaves out
    is replicated over that axis. Every layer has the same axes, so the
    first stands for all. Raises NotImplementedError, naming the param
    and its dims, for rules that split a param otherwise, and ValueError
    when ``tp`` does not divide the attention's ``heads``."""
    if mesh is None or rules is None:
        return ()
    split = sharding_axes(axes, mesh, rules)
    used = tuple(a for a in model_axes if a in split)
    if not used:
        return ()
    tops = [(k, v) for k, v in axes.items() if k != "layers"]
    for key, ax in list(axes["layers"][0].items()) + tops:
        spec = leaf_spec(mesh, rules, ax)
        for axis in used:
            dims = tuple(d for d, e in enumerate(spec) if axis in _names(e))
            want = layout.get(key, {}).get(axis, ())
            if dims != want:
                raise NotImplementedError(
                    f"rules split {family}'s {key} over {axis} on dims "
                    f"{dims}; the Megatron {family} splits it on {want}")
    if "tp" in used and heads % _mesh_axes(mesh)["tp"]:
        raise ValueError(f"{heads} heads do not split over tp")
    return used


def _block(x: torch.Tensor, dim: int, index: int, size: int,
           segments: int = 1) -> torch.Tensor:
    """Block ``index`` of ``size`` along ``dim``; a dim made of
    ``segments`` equal parts side by side ([q | k | v]) gives each part's
    block, side by side."""
    if x.shape[dim] % (segments * size):
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {segments} x {size}")
    parts = x.unflatten(dim, (segments, x.shape[dim] // segments))
    width = parts.shape[dim + 1] // size
    return parts.narrow(dim + 1, index * width, width).flatten(dim, dim + 1)


def _unblock(gathered: torch.Tensor, dim: int, size: int,
             segments: int = 1) -> torch.Tensor:
    """The inverse of ``_block`` over the concatenation (in rank order,
    along ``dim``) of every rank's block."""
    if segments == 1:
        return gathered
    width = gathered.shape[dim] // (size * segments)
    return gathered.unflatten(dim, (size, segments, width)).transpose(
        dim, dim + 1).flatten(dim, dim + 2)


def place_params(params: Dict, axes: Dict, mesh, rules,
                 segments: Optional[Dict[str, Tuple[int, int]]] = None
                 ) -> Dict:
    """Put a param tree onto ``mesh`` per a logical-axis tree and a
    partition rule table, as the JAX package's ``place_params`` does:
    each rank keeps its block of every param.

    Every rank first takes global rank 0's values (one broadcast of the
    flattened params a dtype), so ranks that drew different weights
    start from the same ones. ``segments`` maps a param's key to (dim,
    parts): that dim is ``parts`` equal pieces side by side (GPT's
    ``wqkv`` is [q | k | v]), and each rank takes its block of each
    piece. Returns a new tree of the blocks."""
    import torch.distributed as dist

    segments = segments or {}
    paired = _paired(params, axes)
    if dist.get_world_size() > 1:
        leaves = [p for p, _, _ in paired]
        for dtype in sorted({p.dtype for p in leaves}, key=str):
            same = [p for p in leaves if p.dtype == dtype]
            with torch.no_grad():
                flat = torch.cat([p.detach().reshape(-1) for p in same])
                dist.broadcast(flat, src=0)
                offset = 0
                for p in same:
                    p.copy_(flat[offset:offset + p.numel()].view_as(p))
                    offset += p.numel()
    blocks = []
    for p, ax, key in paired:
        x = p.detach()
        for dim, entry in enumerate(leaf_spec(mesh, rules, ax)):
            if entry is None:
                continue
            index, size = axis_coordinate(mesh, entry)
            parts = segments.get(key, (None, 1))
            x = _block(x, dim, index, size, parts[1] if parts[0] == dim
                       else 1)
        blocks.append(x.contiguous())
    return tree_unflatten(params, blocks)


def gather_params(params: Dict, axes: Dict, mesh, rules,
                  segments: Optional[Dict[str, Tuple[int, int]]] = None
                  ) -> Dict:
    """The inverse of ``place_params``: every param whole, in the JAX
    layout, on every rank (for comparisons and checkpoints)."""
    segments = segments or {}
    out = []
    for p, ax, key in _paired(params, axes):
        x = p.detach()
        spec = leaf_spec(mesh, rules, ax)
        for dim in reversed(range(len(spec))):
            if spec[dim] is None:
                continue
            _, size = axis_coordinate(mesh, spec[dim])
            x = _all_gather(x, axis_group(mesh, spec[dim]), dim)
            parts = segments.get(key, (None, 1))
            x = _unblock(x, dim, size, parts[1] if parts[0] == dim else 1)
        out.append(x)
    return tree_unflatten(params, out)


class _GatherForUse(torch.autograd.Function):
    """Param blocks -> the params the loss uses: each block all-gathered
    over its gathered axes (one flattened all-gather a (dtype, axes)
    group), and backward the gradients reduce-scattered back to blocks.
    One node, so every rank issues its collectives in one order."""

    @staticmethod
    def forward(ctx, plan, mesh, *blocks):
        ctx.plan, ctx.mesh = plan, mesh
        out = list(blocks)
        for axes, members in plan:
            n = axis_coordinate(mesh, axes)[1]
            # Each member's gathered dim to the front, flattened, all the
            # members side by side: one buffer a rank, [n, len] gathered.
            fronts = [blocks[i].movedim(dim, 0) for i, dim in members]
            flat = torch.cat([f.reshape(-1) for f in fronts])
            gathered = _all_gather(flat[None], axis_group(mesh, axes), 0)
            offset = 0
            for (i, dim), f in zip(members, fronts):
                part = gathered[:, offset:offset + f.numel()]
                offset += f.numel()
                full = part.reshape((n,) + tuple(f.shape)).flatten(0, 1)
                out[i] = full.movedim(0, dim)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        out = list(grads)
        for axes, members in ctx.plan:
            n = axis_coordinate(ctx.mesh, axes)[1]
            fronts = [grads[i].movedim(dim, 0) for i, dim in members]
            # [n, block...] a member; rank r's rows of every member side
            # by side, then the rows of the next rank.
            per_rank = torch.cat([f.reshape(n, -1) for f in fronts], dim=1)
            mine = _reduce_scatter(per_rank, axis_group(ctx.mesh, axes),
                                   0)[0]
            offset = 0
            for (i, dim), f in zip(members, fronts):
                size = f.numel() // n
                block = mine[offset:offset + size].reshape(
                    (f.shape[0] // n,) + tuple(f.shape[1:]))
                offset += size
                out[i] = block.movedim(0, dim)
        return (None, None) + tuple(out)


def _gather_plan(specs: List[PartitionSpec], dtypes: List[torch.dtype],
                 model_axes: Sequence[str]):
    """[(axes, [(leaf index, dim)])]: the dims gathered for use (those a
    model axis does not split), grouped by (axes, dtype)."""
    plan: Dict[Tuple, List[Tuple[int, int]]] = {}
    for i, spec in enumerate(specs):
        for dim, entry in enumerate(spec):
            names = set(_names(entry))
            if names & set(model_axes):
                if len(names) > 1:
                    raise NotImplementedError(
                        f"a dim split over {entry} mixes a model axis with "
                        f"others ({_ROADMAP})")
                continue
            if names & {"dp_dcn", "dp"}:
                raise NotImplementedError(
                    f"rules split a param over the batch axes {entry}")
            if not names:
                continue
            key = (entry, str(dtypes[i]))
            plan.setdefault(key, []).append((i, dim))
    for key, members in plan.items():
        if len({i for i, _ in members}) != len(members):
            raise NotImplementedError(
                f"a param split twice over {key[0]} ({_ROADMAP})")
    return [(key[0], members) for key, members in sorted(
        plan.items(), key=lambda kv: (str(kv[0][0]), kv[0][1]))]


def make_train_step_for(
        init_fn: Callable[[torch.Generator], Dict],
        loss_fn: Callable[[Dict, Any], torch.Tensor],
        optimizer: Optional[Callable[[List[torch.Tensor]],
                                     torch.optim.Optimizer]] = None,
        device: DeviceLike = None, *,
        axes: Optional[Dict] = None, mesh=None, rules=None,
        model_axes: Sequence[str] = (),
        segments: Optional[Dict[str, Tuple[int, int]]] = None):
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

    With ``mesh`` (a DeviceMesh from ``parallel.make_mesh``), ``rules``
    and the family's ``axes``, ``init_state`` places the params with
    ``place_params`` (``state["params"]`` holds this rank's blocks;
    ``gather_params`` gives them whole) and each step takes this rank's
    rows of the global batch; see the module docstring for what a step
    does on each axis. ``model_axes`` names the axes whose split the
    family's ``loss_fn`` runs itself (``("tp",)`` for GPT, llama and
    ViT, ``("tp", "ep")`` for the MoE decoder; the loss calls collectives
    by axis name, bound to ``mesh`` over the forward and backward);
    rules that split a param over any other axis but ``fsdp`` raise.
    The loss returned is the global batch's, as JAX's is. The mesh's
    device type must be ``device``'s."""
    device = resolve_device(device)
    make_optimizer = optimizer or default_optimizer
    placed = mesh is not None and rules is not None and axes is not None
    sizes: Dict[str, int] = {}
    plan: list = []
    reductions: list = []
    if mesh is not None:
        if mesh.device_type != device.type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the step "
                             f"on {device}")
        sizes = check_mesh(mesh, model_axes)
    if placed:
        split = sharding_axes(axes, mesh, rules)
        foreign = split - set(model_axes) - {"fsdp"}
        if foreign:
            raise NotImplementedError(
                f"rules split params over {sorted(foreign)}, which this "
                f"family's step does not run ({_ROADMAP})")
    batch_axes = batch_axes_of(mesh)
    n_batch = math.prod(sizes[a] for a in batch_axes)

    def plan_for(params) -> None:
        """The gathers and the gradient reductions, from the leaves'
        specs and dtypes; their groups made now, by every rank."""
        leaves = tree_leaves(params)
        if placed:
            specs = [leaf_spec(mesh, rules, ax)
                     for _, ax, _ in _paired(params, axes)]
            plan[:] = _gather_plan(specs, [p.dtype for p in leaves],
                                   model_axes)
            for gathered_axes, _ in plan:
                axis_group(mesh, gathered_axes)
        by_axes: Dict[Tuple[str, ...], List[int]] = {}
        for i in range(len(leaves)):
            # The axes a leaf's gather already summed its gradient over.
            done = {a for axes_, members in plan for j, _ in members
                    if j == i for a in _names(axes_)}
            red = tuple(a for a in batch_axes if a not in done)
            by_axes.setdefault(red, []).append(i)
        reductions[:] = [(red, idx) for red, idx in sorted(by_axes.items())
                         if red]
        for red, _ in reductions:
            axis_group(mesh, red)
        if batch_axes:
            axis_group(mesh, batch_axes)

    def init_state(generator: Optional[torch.Generator] = None, *,
                   params: Optional[Dict] = None) -> Dict:
        if params is None:
            params = init_fn(generator)
        params = params_to(params, device)
        if placed:
            params = place_params(params, axes, mesh, rules, segments)
        if mesh is not None:
            plan_for(params)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        return {"params": params, "opt_state": make_optimizer(leaves),
                "step": 0}

    def forward(state: Dict, batch):
        """Zero the gradients, put the batch on the device, run the loss:
        (optimizer, loss)."""
        opt = state["opt_state"]
        opt.zero_grad(set_to_none=True)
        inputs, targets = (torch.as_tensor(x, device=device) for x in batch)
        params = state["params"]
        if mesh is None:
            return opt, loss_fn(params, (inputs, targets))
        with bind(mesh):
            used = params
            if plan:
                leaves = tree_leaves(params)
                used = tree_unflatten(params, _GatherForUse.apply(
                    plan, mesh, *leaves))
            return opt, loss_fn(used, (inputs, targets))

    def backward(state: Dict, loss: torch.Tensor) -> torch.Tensor:
        """The gradients (reduced over the batch axes on a mesh); the
        loss, detached (the global batch's on a mesh)."""
        if mesh is None:
            loss.backward()
            return loss.detach()
        with bind(mesh):
            loss.backward()
        return _reduce_grads(mesh, tree_leaves(state["params"]),
                             loss.detach(), reductions, batch_axes, n_batch)

    def train_step(state: Dict, batch):
        if tracing.profiler._is_profiler_enabled:
            # The step's phases as spans and device ranges.
            with tracing.local_span("train.step"):
                with tracing.local_span("train.forward", device):
                    opt, loss = forward(state, batch)
                with tracing.local_span("train.backward", device):
                    loss = backward(state, loss)
                with tracing.local_span("train.optimizer", device):
                    opt.step()
        else:
            opt, loss = forward(state, batch)
            loss = backward(state, loss)
            opt.step()
        state["step"] += 1
        return state, {"loss": loss}

    return init_state, train_step


def _reduce_grads(mesh, params: List[torch.Tensor], loss: torch.Tensor,
                  reductions, batch_axes: Tuple[str, ...], n_batch: int
                  ) -> torch.Tensor:
    """Sum each gradient over the batch axes its gathers did not already
    sum (one flattened f32 all-reduce a set of axes), divide every
    gradient and the loss by the number of batch shards. Returns the
    global loss."""
    if not batch_axes:
        return loss
    grads = [p.grad for p in params]
    reduced = set()
    for red, idx in reductions:
        flat = torch.cat([grads[i].reshape(-1).float() for i in idx])
        flat = _all_reduce(flat, axis_group(mesh, red)) / n_batch
        offset = 0
        for i in idx:
            g = grads[i]
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        reduced.update(idx)
    for i, g in enumerate(grads):
        if i not in reduced:
            g.div_(n_batch)
    total = _all_reduce(loss.reshape(1).float(), axis_group(mesh, batch_axes))
    return (total[0] / n_batch).to(loss.dtype)
