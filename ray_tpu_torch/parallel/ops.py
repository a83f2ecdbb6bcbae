"""Collectives by mesh-axis name, and ``shard_map`` to bind the names.

Counterpart of ``ray_tpu/parallel/ops.py``. JAX runs its collectives
inside ``shard_map``, where an axis name stands for the devices along one
mesh axis. Here ``shard_map(f, mesh=, in_specs=, out_specs=)`` does the
same over a ``DeviceMesh`` whose ranks are processes: it takes this
rank's block of each global input by its ``PartitionSpec``, runs ``f`` on
the blocks with every axis name bound to that mesh dim's process group
(``mesh.get_group(name)``; a tuple of names to one group over all of
them), and gathers the outputs back to global tensors by their specs.
Every rank calls it with the same global inputs and gets the same global
outputs.

Gradients follow ``jax.grad`` of the shard-mapped function:

* Inside ``f`` every value is this rank's own ("varying" in JAX's
  types), and each collective that carries a gradient is an autograd
  Function with JAX's transpose: ``allreduce`` (psum) passes the
  cotangent through unchanged, ``allgather`` reduce-scatters it,
  ``reducescatter`` all-gathers it, ``all_to_all`` swaps it back and
  ``ppermute`` sends it along the reverse permutation.
* A global input comes back with its global gradient on every rank: the
  blocks of a sharded dim are all-gathered, and the ranks' gradients
  are summed over each axis that some input's spec splits but this
  input's does not. That is the psum JAX's transpose puts where a
  replicated input meets values that vary over an axis (its implicit
  ``pvary``); an axis no input splits varies nothing, and its ranks'
  gradients are each whole already. A replicated input that only ever
  meets replicated values has, in JAX, a gradient complete on each
  rank, which this sum would count once a rank: the strategies of this
  package have none.
* A global output's gradient reaches each rank whole; each rank keeps
  its own block.

``pvary`` has no counterpart: in JAX it only marks values as varying for
shard_map's type checks, and the port keeps no such types. Where a
replicated value enters a per-rank product and its gradient must be
summed over the ranks (Megatron's "f"), call ``grad_allreduce``.

Collectives in a backward run in the order autograd's engine reaches
them; every rank runs the same graph, so every rank reaches them in the
same order. Each boundary (the blocks of all inputs, the gathers of all
outputs, every tensor of one ``ppermute``) is one autograd node, so its
collectives keep a fixed order within it.

Transport: a group's backend carries the tensors (gloo on the CPU, NCCL
between cards). Ranks that share one card run gloo with CUDA tensors;
gloo (torch 2.11) takes CUDA tensors for every collective here but
point-to-point sends, which abort the process. ``_host_staged`` is the
one place that decides, by the group's backend and the op alone, to
move a collective through host memory. ``TRAFFIC`` counts each op's
calls, the bytes this rank handed it and the transport it took.
"""

from __future__ import annotations

import collections
import contextlib
import math
import threading
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple, Union)

import torch
import torch.distributed as dist

from .._tree import tree_leaves, tree_unflatten
from .partition import PartitionSpec

AxisName = Union[str, Sequence[str]]

# The collectives gloo runs on CUDA tensors (checked on an H100 with torch
# 2.11: each gave the right values). Point-to-point send and receive are
# not among them: gloo's TCP transport reads a CUDA pointer as host memory
# and aborts the process ("writev ... Bad address").
GLOO_CUDA_OPS = frozenset({"all_reduce", "all_gather", "reduce_scatter",
                           "all_to_all"})


class Traffic:
    """Per-op calls, bytes this rank handed to the op, and transports."""

    def __init__(self):
        self.ops: Dict[str, Dict[str, Any]] = {}

    def add(self, op: str, nbytes: int, transport: str) -> None:
        row = self.ops.setdefault(op, {"calls": 0, "bytes": 0,
                                       "transports": set()})
        row["calls"] += 1
        row["bytes"] += nbytes
        row["transports"].add(transport)

    def reset(self) -> None:
        self.ops.clear()

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        return {op: {"calls": r["calls"], "bytes": r["bytes"],
                     "transports": sorted(r["transports"])}
                for op, r in sorted(self.ops.items())}


TRAFFIC = Traffic()


# ---------------------------------------------------------------------------
# groups and the bound mesh
# ---------------------------------------------------------------------------
_BOUND = threading.local()


@contextlib.contextmanager
def bind(mesh):
    """Bind ``mesh``'s axis names for the collectives called inside."""
    stack = getattr(_BOUND, "stack", None)
    if stack is None:
        stack = _BOUND.stack = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


@contextlib.contextmanager
def _rebound(stack):
    with contextlib.ExitStack() as inner:
        for mesh in stack:
            inner.enter_context(bind(mesh))
        yield


def remat_context():
    """``context_fn`` for ``torch.utils.checkpoint``: the recompute in the
    backward sees the axis names bound as they were in the forward."""
    return contextlib.nullcontext(), _rebound(
        list(getattr(_BOUND, "stack", None) or []))


# ---------------------------------------------------------------------------
# JAX's dots_with_no_batch_dims_saveable
# ---------------------------------------------------------------------------
_KEPT = threading.local()


class _Kept:
    """The products one checkpointed region keeps: ``saveable_matmul``'s
    outputs (a row-parallel product's after its sum, as GSPMD's residual
    is), kept in order by the forward and handed back in that order to
    the recompute, which then neither multiplies nor sends."""

    def __init__(self):
        self.products: Deque[torch.Tensor] = collections.deque()
        self.replay = False

    @contextlib.contextmanager
    def active(self, replay: bool):
        self.replay = replay
        prev = getattr(_KEPT, "current", None)
        _KEPT.current = self
        try:
            yield
        finally:
            _KEPT.current = prev

    def keep(self, out: torch.Tensor) -> None:
        self.products.append(out.detach())

    def take(self) -> torch.Tensor:
        return self.products.popleft()


def dots_with_no_batch_dims_saveable():
    """``context_fn`` for ``torch.utils.checkpoint`` that runs JAX's
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: the
    forward keeps each ``saveable_matmul`` product, the recompute takes
    them back and reruns everything else (norms, rope, gelu, adds, the
    attention, whose ``bmm`` has batch dims as JAX's ``bhqd,bhkd`` einsum
    has), with the axis names bound as in the forward
    (``remat_context``). Nothing is intercepted op by op: on the card a
    dispatch mode over every op of the block (torch's selective
    checkpoint) cost more host time than the products saved."""
    kept = _Kept()
    stack = list(getattr(_BOUND, "stack", None) or [])

    @contextlib.contextmanager
    def recompute():
        with _rebound(stack), kept.active(replay=True):
            yield

    return kept.active(replay=False), recompute()


def bound_mesh():
    stack = getattr(_BOUND, "stack", None)
    if not stack:
        raise NameError("unbound axis name: call collectives inside "
                        "shard_map (or ops.bind(mesh))")
    return stack[-1]


def _names(axis_name: Optional[AxisName]) -> Tuple[str, ...]:
    """The mesh axes of one name, a tuple of names or None (none)."""
    if axis_name is None:
        return ()
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def axis_group(mesh, axis_name: AxisName):
    """The process group of this rank over the mesh axes ``axis_name``
    (one name, or a tuple flattened in row-major order). A tuple's groups
    are made at first use, by every rank of the mesh together."""
    names = _names(axis_name)
    dims = mesh.mesh_dim_names or ()
    for n in names:
        if n not in dims:
            raise NameError(f"unbound axis name: {n!r} (mesh axes {dims})")
    if len(names) == 1:
        return mesh.get_group(names[0])
    cache = mesh.__dict__.setdefault("_rtt_axis_groups", {})
    if names not in cache:
        ranks = mesh.mesh
        idx = [dims.index(n) for n in names]
        rest = [i for i in range(ranks.ndim) if i not in idx]
        # [rest..., names...] -> one row of ranks a group, in order.
        rows = ranks.permute(*rest, *idx).reshape(-1, math.prod(
            ranks.shape[i] for i in idx)).tolist()
        if any(row != sorted(row) for row in rows):
            # new_group orders a group's ranks by global rank: the row-major
            # index over ``names`` must be that order.
            raise ValueError(f"axes {names} are not in the mesh's order "
                             f"{dims}")
        me = dist.get_rank()
        mine = None
        for row in rows:
            group = dist.new_group(row)
            if me in row:
                mine = group
        cache[names] = mine
    return cache[names]


def axis_coordinate(mesh, axis_name: AxisName) -> Tuple[int, int]:
    """(this rank's index, the size) along ``axis_name`` (a tuple: the
    row-major index over its axes)."""
    dims = mesh.mesh_dim_names or ()
    coord = mesh.get_coordinate()
    index, size = 0, 1
    for n in _names(axis_name):
        if n not in dims:
            raise NameError(f"unbound axis name: {n!r} (mesh axes {dims})")
        d = dims.index(n)
        n_d = int(mesh.size(d))
        index, size = index * n_d + coord[d], size * n_d
    return index, size


def _group(axis_name: AxisName):
    mesh = bound_mesh()
    return axis_group(mesh, axis_name), axis_coordinate(mesh, axis_name)


def axis_index(axis_name: AxisName) -> int:
    return _group(axis_name)[1][0]


def axis_size(axis_name: AxisName) -> int:
    return _group(axis_name)[1][1]


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------
def _host_staged(op: str, group, device: torch.device) -> bool:
    """Whether ``op`` on ``group`` moves CUDA tensors through host memory:
    only on a gloo group, and only for the ops gloo does not run on CUDA
    tensors (``GLOO_CUDA_OPS``). Chosen by the backend, never on a
    failure."""
    return (device.type == "cuda" and dist.get_backend(group) == "gloo"
            and op not in GLOO_CUDA_OPS)


def _transport(op: str, group, tensors: List[torch.Tensor]) -> bool:
    """Count ``op`` on ``tensors`` in ``TRAFFIC``; whether it goes through
    host memory (``_host_staged``)."""
    staged = _host_staged(op, group, tensors[0].device)
    backend = dist.get_backend(group)
    TRAFFIC.add(op, sum(t.numel() * t.element_size() for t in tensors),
                f"{backend}, host-staged" if staged else backend)
    return staged


def _run(op: str, group, tensors: List[torch.Tensor],
         fn: Callable[[List[torch.Tensor]], List[torch.Tensor]]
         ) -> List[torch.Tensor]:
    """``fn(tensors) -> results`` on ``group``'s backend, through host
    memory where ``_host_staged`` says so; counted in ``TRAFFIC``."""
    device = tensors[0].device
    if not _transport(op, group, tensors):
        return fn(tensors)
    return [r.to(device) for r in fn([t.cpu() for t in tensors])]


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    if dist.get_world_size(group) == 1:
        return x.clone()

    def fn(ts):
        out = ts[0].contiguous().clone()
        dist.all_reduce(out, op=op, group=group)
        return [out]
    return _run("all_reduce", group, [x], fn)[0]


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Blocks of every rank concatenated along ``dim``, in rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()

    def fn(ts):
        src = ts[0].contiguous()
        out = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(out, src, group=group)
        return [torch.cat(out, dim)]
    return _run("all_gather", group, [x], fn)[0]


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over ranks, this rank's block of it along ``dim``."""
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")

    def fn(ts):
        blocks = [b.contiguous() for b in ts[0].chunk(n, dim)]
        out = torch.empty_like(blocks[0])
        dist.reduce_scatter(out, blocks, group=group)
        return [out]
    return _run("reduce_scatter", group, [x], fn)[0]


def _all_to_all(x: torch.Tensor, group, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    """Tiled all-to-all: ``x`` split into n blocks along ``split_axis``,
    block j to rank j; the blocks received concatenated along
    ``concat_axis`` in source-rank order (``lax.all_to_all(tiled=True)``).
    """
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: split axis {split_axis} of "
                         f"{tuple(x.shape)} does not split over {n} ranks")
    if n == 1:
        return x.clone()

    def fn(ts):
        src = ts[0].movedim(split_axis, 0).contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=group)
        return [out]
    out = _run("all_to_all", group, [x], fn)[0]
    # out: [n * c, ...] with rank j's block at j; back to x's layout a
    # block, then the blocks side by side along concat_axis.
    blocks = out.reshape((n, out.shape[0] // n) + out.shape[1:])
    blocks = blocks.movedim(1, split_axis + 1)      # [n, *block shape]
    blocks = blocks.movedim(0, concat_axis)          # n before concat dim
    shape = list(blocks.shape)
    shape[concat_axis:concat_axis + 2] = [shape[concat_axis]
                                          * shape[concat_axis + 1]]
    return blocks.reshape(shape)


def _permute_start(xs: Sequence[torch.Tensor], group,
                   perm: Sequence[Tuple[int, int]]
                   ) -> Callable[[], List[torch.Tensor]]:
    """Issue the hop that sends each tensor from ``src`` to ``dst`` for
    every (src, dst) in ``perm`` (group ranks) and return at once; the
    function returned waits for it and gives the tensors received (zeros
    on a rank no pair sends to). Sends only data: no autograd."""
    me = dist.get_rank(group)
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    if len(dsts) > 1 or len(srcs) > 1:
        raise ValueError(f"ppermute: {perm} is not a permutation")
    if dsts and srcs and dsts[0] == me:
        out = [x.detach().clone() for x in xs]
        return lambda: out
    if not dsts and not srcs:
        out = [torch.zeros_like(x) for x in xs]
        return lambda: out
    device = xs[0].device
    ts = [x.detach().contiguous() for x in xs]
    staged = _transport("ppermute", group, ts)
    if staged:
        ts = [t.cpu() for t in ts]
    recv = [torch.zeros_like(t) for t in ts]
    p2p = []
    for t, r in zip(ts, recv):
        if dsts:
            p2p.append(dist.P2POp(dist.isend, t, dist.get_global_rank(
                group, dsts[0]), group))
        if srcs:
            p2p.append(dist.P2POp(dist.irecv, r, dist.get_global_rank(
                group, srcs[0]), group))
    works = dist.batch_isend_irecv(p2p)

    def wait() -> List[torch.Tensor]:
        for work in works:
            work.wait()
        return [r.to(device) for r in recv] if staged else recv
    return wait


# ---------------------------------------------------------------------------
# autograd Functions: JAX's transpose rules
# ---------------------------------------------------------------------------
class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _KeptMatmul(torch.autograd.Function):
    """``x @ w``, summed over ``group`` unless it is None. In a
    ``dots_with_no_batch_dims_saveable`` region the forward keeps the
    result and the recompute returns it. The backward is ``mm``'s: a
    sum's cotangent passes unchanged."""

    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        kept = getattr(_KEPT, "current", None)
        if kept is not None and kept.replay:
            return kept.take()
        out = x @ w
        if group is not None:
            out = _all_reduce(out, group)
        if kept is not None:
            kept.keep(out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gw = x.reshape(-1, x.shape[-1]).mT @ g.reshape(-1, g.shape[-1])
        return g @ w.mT, gw, None


class _GradPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, concat_axis, split_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None


class _TakeBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, index, size):
        ctx.group, ctx.dim = group, dim
        width = x.shape[dim] // size
        return x.narrow(dim, index * width, width)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None, None, None


class _GatherInvariant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, index):
        ctx.dim, ctx.index, ctx.width = dim, index, x.shape[dim]
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.width, ctx.width),
                None, None, None)


class _Permute(torch.autograd.Function):
    """A hop ``_permute_start`` issued, waited for (``wait``) in the
    forward; ``xs`` are what it sent, the last an empty anchor that
    requires grad. The backward sends the gradients back and waits."""

    @staticmethod
    def forward(ctx, group, perm, wait, *xs):
        ctx.group, ctx.perm = group, [(d, s) for s, d in perm]
        return tuple(wait())

    @staticmethod
    def backward(ctx, *gs):
        back = _permute_start(gs, ctx.group, ctx.perm)()
        return (None, None, None) + tuple(back) + (None,)


# ---------------------------------------------------------------------------
# the collectives by axis name (call inside shard_map or ops.bind)
# ---------------------------------------------------------------------------
def allreduce(x, axis_name: AxisName = "dp"):
    """Sum across an axis (``lax.psum``); the gradient passes through."""
    return _Psum.apply(x, _group(axis_name)[0])


def saveable_matmul(x, w, axis_name: Optional[AxisName] = None):
    """``x @ w`` for ``x`` [..., k] and ``w`` [k, n], a product with no
    batch dims; with ``axis_name``, ``allreduce(x @ w, axis_name)`` (a
    row-parallel product and its sum, Megatron's "g"). What a
    ``dots_with_no_batch_dims_saveable`` region keeps: its recompute
    issues neither the product nor the all-reduce."""
    group = None if axis_name is None else _group(axis_name)[0]
    if group is None and getattr(_KEPT, "current", None) is None:
        return x @ w
    return _KeptMatmul.apply(x, w, group)


def allreduce_mean(x, axis_name: AxisName = "dp"):
    return allreduce(x, axis_name) / axis_size(axis_name)


def allreduce_max(x, axis_name: AxisName):
    """Max across an axis (``lax.pmax``), carrying no gradient."""
    return _all_reduce(x.detach(), _group(axis_name)[0], dist.ReduceOp.MAX)


def grad_allreduce(x, axis_name: AxisName):
    """Identity forward, the gradient summed over the axis backward: a
    replicated value entering per-rank products (Megatron's "f"; the
    transpose of JAX's implicit ``pvary``)."""
    return _GradPsum.apply(x, _group(axis_name)[0])


def take_block(x, axis_name: AxisName, axis: int = 0):
    """This rank's block along ``axis`` of a value that is the same on
    every rank of the axis (a dynamic slice at ``axis_index``); backward
    the ranks' gradient blocks are all-gathered, so the value's gradient
    is whole on every rank (the "f" of a split whose ranks each use one
    block)."""
    group, (index, size) = _group(axis_name)
    if x.shape[axis] % size:
        raise ValueError(f"take_block: dim {axis} of {tuple(x.shape)} does "
                         f"not split over {size} ranks")
    return _TakeBlock.apply(x, group, axis, index, size)


def allgather_invariant(x, axis_name: AxisName, axis: int = 0):
    """Every rank's block along ``axis``, for a result that every rank
    then uses alike (``lax.all_gather_invariant``): its cotangent is the
    same on every rank, so backward each rank keeps its own block of it,
    where ``allgather``'s reduce-scatter would count it once a rank."""
    group, (index, _) = _group(axis_name)
    return _GatherInvariant.apply(x, group, axis, index)


def allgather(x, axis_name: AxisName = "sp", axis: int = 0,
              tiled: bool = True):
    """Every rank's block along ``axis`` (``tiled``), or stacked on a new
    ``axis``."""
    group = _group(axis_name)[0]
    if tiled:
        return _AllGather.apply(x, group, axis)
    return _AllGather.apply(x.unsqueeze(axis), group, axis)


def reducescatter(x, axis_name: AxisName = "fsdp", scatter_axis: int = 0):
    """psum_scatter (tiled): the sum, this rank's block along the axis."""
    return _ReduceScatter.apply(x, _group(axis_name)[0], scatter_axis)


def all_to_all(x, axis_name: AxisName = "ep", split_axis: int = 0,
               concat_axis: int = 0, tiled: bool = True):
    """MoE dispatch / Ulysses head-sequence swap (``lax.all_to_all``).
    Untiled: ``split_axis`` has the axis's size and is removed, and the
    sources are stacked on a new ``concat_axis``."""
    group = _group(axis_name)[0]
    if tiled:
        return _AllToAll.apply(x, group, split_axis, concat_axis)
    out = _AllToAll.apply(x, group, split_axis, split_axis)
    return out.movedim(split_axis, concat_axis)


def ppermute_start(x, axis_name: AxisName, perm) -> Callable[[], Any]:
    """Issue ``ppermute(x, axis_name, perm)`` now; the function returned
    waits for it and returns what ``ppermute`` would. Work between the
    two overlaps the hop; it must call no collective on the axis.

    Under grad mode (at the wait) the received tensors always require
    grad: whether the sender's did is not known here, and every rank
    must put the hop in its graph for the reverse hop (sent at once in
    the backward) to pair up."""
    group = _group(axis_name)[0]
    xs = (x,) if isinstance(x, torch.Tensor) else tuple(x)
    pending = _permute_start(xs, group, list(perm))

    def wait():
        if not torch.is_grad_enabled():
            out = pending()
        else:
            anchor = torch.empty(0, device=xs[0].device, requires_grad=True)
            out = _Permute.apply(group, list(perm), pending, *xs, anchor)
        return out[0] if isinstance(x, torch.Tensor) else type(x)(out)
    return wait


def ppermute(x, axis_name: AxisName, perm):
    """Neighbour exchange (ring attention's K/V, pipeline hops): ``x`` a
    tensor or a tuple of tensors, sent as one step."""
    return ppermute_start(x, axis_name, perm)()


def ring_shift(x, axis_name: AxisName, shift: int = 1,
               axis_size: Optional[int] = None):
    """Rotate values around a ring axis by ``shift``."""
    n = axis_size if axis_size is not None else _group(axis_name)[1][1]
    return ppermute(x, axis_name, [(i, (i + shift) % n) for i in range(n)])


def broadcast_from(x, axis_name: AxisName, src: int = 0):
    """``src``'s value on every rank of the axis."""
    return allgather(x, axis_name, axis=0, tiled=False)[src]


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------
def _flatten(tree, spec, path=()) -> List[Tuple[Any, Optional[PartitionSpec]]]:
    """(leaf, its spec) pairs: a PartitionSpec (or None) applies to every
    leaf under it; a tuple, list or dict of specs follows the tree."""
    if spec is None or isinstance(spec, PartitionSpec):
        return [(leaf, spec or PartitionSpec()) for leaf in tree_leaves(tree)]
    if isinstance(spec, dict):
        return [p for k in tree for p in _flatten(tree[k], spec[k])]
    if len(spec) != len(tree):
        raise ValueError(f"spec {spec} does not match a tree of "
                         f"{len(tree)} entries")
    return [p for t, s in zip(tree, spec) for p in _flatten(t, s)]


def _dims(mesh, spec: PartitionSpec, ndim: int):
    """[(dim, axes, index, size)] for each sharded dim of a spec."""
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    out = []
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        index, size = axis_coordinate(mesh, entry)
        out.append((dim, _names(entry), index, size))
    return out


def _named(spec: PartitionSpec) -> set:
    return {a for entry in spec if entry is not None for a in _names(entry)}


def _summed_over(mesh, spec: PartitionSpec, varying: set
                 ) -> Tuple[str, ...]:
    """The axes an input's gradient is summed over: those that vary (some
    input splits them) and that its own spec does not split."""
    named = _named(spec)
    return tuple(a for a in (mesh.mesh_dim_names or ())
                 if a in varying and a not in named
                 and mesh.size(mesh.mesh_dim_names.index(a)) > 1)


def local_block(mesh, x: torch.Tensor, spec: PartitionSpec) -> torch.Tensor:
    """This rank's block of a global ``x`` under ``spec``."""
    for dim, axes, index, size in _dims(mesh, spec, x.dim()):
        if x.shape[dim] % size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {axes} ({size} ranks)")
        block = x.shape[dim] // size
        x = x.narrow(dim, index * block, block)
    return x


def global_value(mesh, x: torch.Tensor, spec: PartitionSpec
                 ) -> torch.Tensor:
    """The global tensor whose blocks the ranks hold under ``spec``."""
    for dim, axes, _, _ in reversed(_dims(mesh, spec, x.dim())):
        x = _all_gather(x, axis_group(mesh, axes), dim)
    return x


class _Scatter(torch.autograd.Function):
    """Global inputs -> this rank's blocks; backward: the global gradient
    on every rank (blocks all-gathered, summed over unnamed axes)."""

    @staticmethod
    def forward(ctx, mesh, specs, *xs):
        ctx.mesh, ctx.specs = mesh, specs
        return tuple(local_block(mesh, x, s) for x, s in zip(xs, specs))

    @staticmethod
    def backward(ctx, *gs):
        varying = set().union(*(_named(s) for s in ctx.specs))
        out = []
        for g, spec, needed in zip(gs, ctx.specs, ctx.needs_input_grad[2:]):
            if not needed:
                out.append(None)
                continue
            summed = _summed_over(ctx.mesh, spec, varying)
            if summed:
                g = _all_reduce(g, axis_group(ctx.mesh, summed))
            out.append(global_value(ctx.mesh, g, spec))
        return (None, None) + tuple(out)


class _Gather(torch.autograd.Function):
    """This rank's output blocks -> global outputs; backward: each rank
    keeps its block of the (whole, replicated) cotangent."""

    @staticmethod
    def forward(ctx, mesh, specs, *xs):
        ctx.mesh, ctx.specs = mesh, specs
        return tuple(global_value(mesh, x, s) for x, s in zip(xs, specs))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None) + tuple(
            local_block(ctx.mesh, g, s) for g, s in zip(gs, ctx.specs))


def shard_map(f: Callable, *, mesh, in_specs, out_specs) -> Callable:
    """``f`` run per rank on its blocks of global inputs, its outputs
    gathered to global tensors (see the module docstring).

    ``in_specs``: one entry per positional argument, ``out_specs`` one
    for the output (a tuple of entries for a tuple output); an entry is a
    ``PartitionSpec`` (or None, replicated) for every tensor under it, or
    a tuple/list/dict of entries that follows the argument's structure.
    Leaves that are not tensors pass through."""

    def run(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"shard_map: {len(args)} arguments for "
                            f"{len(in_specs)} in_specs")
        pairs = _flatten(list(args), list(in_specs))
        idx = [i for i, (x, _) in enumerate(pairs)
               if isinstance(x, torch.Tensor)]
        blocks = _Scatter.apply(mesh, [pairs[i][1] for i in idx],
                                *[pairs[i][0] for i in idx]) if idx else ()
        leaves = [x for x, _ in pairs]
        for i, b in zip(idx, blocks):
            leaves[i] = b
        local_args = tree_unflatten(list(args), leaves)
        with bind(mesh):
            out = f(*local_args)
        opairs = _flatten(out, out_specs)
        oidx = [i for i, (y, _) in enumerate(opairs)
                if isinstance(y, torch.Tensor)]
        gathered = _Gather.apply(mesh, [opairs[i][1] for i in oidx],
                                 *[opairs[i][0] for i in oidx]) \
            if oidx else ()
        oleaves = [y for y, _ in opairs]
        for i, g in zip(oidx, gathered):
            oleaves[i] = g
        return tree_unflatten(out, oleaves)

    return run
