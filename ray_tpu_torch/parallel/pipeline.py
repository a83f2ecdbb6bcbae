"""Pipeline parallelism over the ``pp`` mesh axis: forward and training.

Counterpart of ``ray_tpu/parallel/pipeline.py``. Stage params are
stacked on axis 0 and split over ``pp``, one stage a rank; microbatches
flow stage to stage with ``ppermute``.

GPipe (``pipeline_apply``, ``make_pipelined_fn``,
``make_pipelined_train_fn``): the schedule runs n_micro + n_stages - 1
ticks. Its backward is autograd through the schedule, as JAX's is AD of
its scan: the transpose of each forward hop is the reverse hop, run by a
whole ``backward()`` (not ``autograd.grad(inputs=...)``, which skips on
each rank the hops that lead to none of its params). Every
tick's hop carries the state produced by the previous one (a rank's
state at tick t is the hop of its state at t - 1, or stage 0's next
microbatch chosen over it by ``torch.where``), and every tick's state is
filed into the outputs by ``torch.where``, so each hop is on the path
to the loss on every rank and the reverse hops run in reverse tick order
on every rank. A rank runs its stage only on the ticks it holds a
microbatch (JAX computes it every tick and discards the idle ones).

1F1B (``one_f1b_schedule``, ``make_1f1b_train_fn``): the backward runs
inside the schedule, each stage's as ``torch.autograd.grad`` of its
stage recomputed from the saved input; the stash of inputs is bounded by
pipeline depth. Both hops run every tick on every rank; the ring's
wrap-around messages (stage S-1's forward output reaching stage 0,
stage 0's input gradient reaching stage S-1) are dropped on receipt.

Call ``pipeline_apply`` inside ``shard_map``; the ``make_*`` functions
build the shard_map themselves.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .._tree import tree_leaves, tree_map, tree_unflatten
from . import ops
from .partition import PartitionSpec


def _where(cond: bool, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` if ``cond`` else ``b``, with both on autograd's path."""
    return torch.where(torch.tensor(cond, device=a.device), a, b)


def pipeline_apply(stage_fn: Callable, stage_params, x,
                   axis_name: str = "pp", n_microbatches: int = None):
    """Run a GPipe pipeline; call inside ``shard_map`` over ``axis_name``.

    ``stage_fn(params, activations) -> activations`` runs this rank's
    stage. ``x``: the microbatch stack [n_micro, ...]; every microbatch
    visits every stage in ring order. At tick t stage s holds microbatch
    t - s; outputs complete on the last stage and are summed over the
    axis so every rank returns them."""
    n_stages = ops.axis_size(axis_name)
    rank = ops.axis_index(axis_name)
    n_micro = x.shape[0]
    fwd_perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    state = torch.zeros_like(x[0])
    outputs = torch.zeros_like(x)
    total_ticks = n_micro + n_stages - 1
    for t in range(total_ticks):
        if rank == 0:
            # Stage 0 takes microbatch t over the state that hopped in.
            state = _where(t < n_micro, x[min(t, n_micro - 1)], state)
        mb = t - rank
        active = 0 <= mb < n_micro
        if active:
            state = stage_fn(stage_params, state)
        done = active and rank == n_stages - 1
        filed = outputs.index_copy(
            0, torch.tensor([min(max(mb, 0), n_micro - 1)], device=x.device),
            state[None])
        outputs = _where(done, filed, outputs)
        if t + 1 < total_ticks:
            state = ops.ppermute(state, axis_name, fwd_perm)
    contrib = _where(rank == n_stages - 1, outputs, torch.zeros_like(outputs))
    return ops.allreduce(contrib, axis_name)


def _pipeline_forward(mesh, stage_fn: Callable, n_microbatches: int,
                      axis_name: str, params_spec, x_spec):
    """The shard_map: stage params stacked on axis 0 (split over
    ``axis_name``); x global [n_micro * mb_size, ...]."""
    params_spec = params_spec if params_spec is not None else \
        PartitionSpec(axis_name)
    x_spec = x_spec if x_spec is not None else PartitionSpec()

    def local_fn(stage_params, x):
        # Each leaf arrives with a leading stage axis of length 1.
        own = tree_map(lambda p, _: p[0], stage_params)
        xm = x.reshape((n_microbatches, -1) + tuple(x.shape[1:]))
        out = pipeline_apply(stage_fn, own, xm, axis_name)
        return out.reshape((-1,) + tuple(out.shape[2:]))

    return ops.shard_map(local_fn, mesh=mesh,
                         in_specs=(params_spec, x_spec), out_specs=x_spec)


def make_pipelined_fn(mesh, stage_fn: Callable, n_microbatches: int,
                      axis_name: str = "pp", params_spec=None, x_spec=None):
    """GPipe forward: ``fn(stage_params, x) -> out``, every rank the same
    global inputs and outputs."""
    return _pipeline_forward(mesh, stage_fn, n_microbatches, axis_name,
                             params_spec, x_spec)


def make_pipelined_train_fn(mesh, stage_fn: Callable, loss_fn: Callable,
                            n_microbatches: int, axis_name: str = "pp",
                            params_spec=None, x_spec=None):
    """GPipe training: ``step(stage_params, x, y) -> (loss, grads)`` with
    ``grads`` stacked like ``stage_params`` (every stage's, on every
    rank). ``loss_fn(outputs, y) -> scalar`` on the whole pipeline
    output. The backward is autograd through the schedule."""
    apply = _pipeline_forward(mesh, stage_fn, n_microbatches, axis_name,
                              params_spec, x_spec)

    def step(stage_params, x, y):
        params = tree_map(lambda p, _: p.detach().requires_grad_(True),
                          stage_params)
        loss = loss_fn(apply(params, x), y)
        # A whole backward: autograd.grad(inputs=...) would skip the hops
        # that lead to no param on this rank (a stage's first ticks), which
        # other ranks' reverse hops wait for.
        loss.backward()
        return loss.detach(), tree_map(lambda p, _: p.grad, params)

    return step


def one_f1b_schedule(n_stages: int, n_micro: int):
    """Static 1F1B tick table (Megatron-LM's non-interleaved 1F1B).

    Each tick every stage runs one of idle(0)/forward(1)/backward(2) on
    a microbatch. Stage s keeps at most (n_stages - s) microbatches in
    flight — warmup forwards, steady 1F1B alternation, cooldown
    backwards — which bounds the activation stash by pipeline depth.

    Returns (action[T, S], mb[T, S]) numpy int32 arrays."""
    S, M = n_stages, n_micro
    f_done = [[-1] * M for _ in range(S)]   # tick F(s,m) completed
    b_done = [[-1] * M for _ in range(S)]
    next_f = [0] * S
    next_b = [0] * S
    actions, mbs = [], []
    t = 0
    while any(nb < M for nb in next_b):
        act_row = [0] * S
        mb_row = [0] * S
        for s in range(S):
            m_f, m_b = next_f[s], next_b[s]
            f_ready = m_f < M and (
                s == 0 or (f_done[s - 1][m_f] >= 0
                           and f_done[s - 1][m_f] < t))
            b_ready = m_b < M and f_done[s][m_b] >= 0 and (
                s == S - 1 or (b_done[s + 1][m_b] >= 0
                               and b_done[s + 1][m_b] < t))
            in_flight = m_f - m_b
            cap = S - s
            # Forward only under the in-flight cap (the memory bound); at
            # the cap, drain a backward (or wait).
            do_b = b_ready and (in_flight >= cap or not f_ready)
            do_f = (not do_b) and f_ready and in_flight < cap
            if do_b:
                act_row[s], mb_row[s] = 2, m_b
                b_done[s][m_b] = t
                next_b[s] += 1
            elif do_f:
                act_row[s], mb_row[s] = 1, m_f
                f_done[s][m_f] = t
                next_f[s] += 1
        actions.append(act_row)
        mbs.append(mb_row)
        t += 1
        if t > 4 * (M + S) + 8:  # defensive: schedule must terminate
            raise RuntimeError("1F1B schedule did not converge")
    return (np.asarray(actions, dtype=np.int32),
            np.asarray(mbs, dtype=np.int32))


def make_1f1b_train_fn(mesh, stage_fn: Callable, loss_fn: Callable,
                       n_microbatches: int, axis_name: str = "pp",
                       params_spec=None, x_spec=None):
    """Training over a 1F1B schedule: ``step(stage_params, x, y) ->
    (loss, grads)``, the contract of ``make_pipelined_train_fn``, with
    the backward inside the schedule: the stash of stage inputs is
    ring-indexed by microbatch mod S (bounded by depth), and a stage's
    backward recomputes its forward from the saved input."""
    params_spec = params_spec if params_spec is not None else \
        PartitionSpec(axis_name)
    x_spec = x_spec if x_spec is not None else PartitionSpec()
    n_stages = int(mesh.size(mesh.mesh_dim_names.index(axis_name)))
    action_tbl, mb_tbl = one_f1b_schedule(n_stages, n_microbatches)
    S, M = n_stages, n_microbatches

    def local_fn(stage_params, x, y):
        own = tree_map(lambda p, _: p[0].detach(), stage_params)
        own_leaves = tree_leaves(own)
        xm = x.reshape((M, -1) + tuple(x.shape[1:]))
        ym = y.reshape((M, -1) + tuple(y.shape[1:]))
        rank = ops.axis_index(axis_name)
        fwd_perm = [(i, (i + 1) % S) for i in range(S)]
        bwd_perm = [(i, (i - 1) % S) for i in range(S)]
        mb_shape = tuple(xm.shape[1:])
        zeros = torch.zeros(mb_shape, dtype=xm.dtype, device=xm.device)
        stash = [zeros] * S          # stage inputs, slot mb % S
        grads_in = [zeros] * S       # output grads from the next stage
        dparams = [torch.zeros_like(p) for p in own_leaves]
        loss_acc = torch.zeros((), dtype=torch.float32, device=xm.device)
        is_first, is_last = rank == 0, rank == S - 1

        for t in range(action_tbl.shape[0]):
            action, m = int(action_tbl[t, rank]), int(mb_tbl[t, rank])
            slot = m % S
            f_msg, f_valid, b_msg, b_valid = zeros, 0, zeros, 0
            if action == 1:
                # Stage 0's saved input is its x microbatch (one stash, so
                # the backward recompute reads one place).
                a_in = xm[m] if is_first else stash[slot]
                stash[slot] = a_in
                with torch.no_grad():
                    f_msg = stage_fn(own, a_in)
                f_valid = 1
            elif action == 2:
                a_in = stash[slot].detach().requires_grad_(True)
                with torch.enable_grad():
                    p_in = [p.detach().requires_grad_(True)
                            for p in own_leaves]
                    params = tree_unflatten(own, p_in)
                    out = stage_fn(params, a_in)
                    if is_last:
                        lval = loss_fn(out, ym[m])
                        got = torch.autograd.grad(lval, p_in + [a_in])
                        loss_acc = loss_acc + lval.detach().float()
                    else:
                        got = torch.autograd.grad(out, p_in + [a_in],
                                                  grad_outputs=grads_in[slot])
                dparams = [acc + g for acc, g in zip(dparams, got[:-1])]
                b_msg, b_valid = got[-1].to(xm.dtype), 1
            # Both hops every tick: forward outputs ride forward, input
            # grads ride backward, each with its (valid, microbatch).
            meta = torch.tensor([f_valid, m, b_valid, m], dtype=torch.int64,
                                device=xm.device)
            f_rx, f_meta = ops.ppermute((f_msg, meta), axis_name, fwd_perm)
            b_rx, b_meta = ops.ppermute((b_msg, meta), axis_name, bwd_perm)
            rx_fv, rx_fm = int(f_meta[0]), int(f_meta[1])
            rx_bv, rx_bm = int(b_meta[2]), int(b_meta[3])
            # The rings wrap: stage S-1's output lands on stage 0 and stage
            # 0's input grad on stage S-1. Neither is a real message, and
            # filing it would overwrite a live slot of the same residue.
            if is_first:
                rx_fv = 0
            if is_last:
                rx_bv = 0
            if rx_fv:
                stash[rx_fm % S] = f_rx
            if rx_bv:
                grads_in[rx_bm % S] = b_rx
        # Per-mb losses live on the last stage; grads are per stage. Both
        # are sums over microbatches of per-mb means: divide by M.
        loss = ops.allreduce(loss_acc if is_last else torch.zeros_like(
            loss_acc), axis_name) / M
        grads = tree_unflatten(own, [(g / M)[None] for g in dparams])
        return loss, grads

    fn = ops.shard_map(local_fn, mesh=mesh,
                       in_specs=(params_spec, x_spec, x_spec),
                       out_specs=(PartitionSpec(), params_spec))

    def step(stage_params, x, y):
        with torch.no_grad():
            return fn(stage_params, x, y)

    return step
