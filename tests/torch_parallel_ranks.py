"""What each rank runs for tests/test_torch_parallel.py.

The ranks are ``ray_tpu_torch.parallel.launch.RankPool`` processes: they
import this module (torch and the port only, never jax) to call these
functions by reference. Inputs arrive as numpy arrays, the same on every
rank; results go back as numpy arrays (f32).
"""

import dataclasses

import numpy as np
import torch

from ray_tpu_torch.models import GPTConfig, from_jax_params, shard_batch
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch._tree import tree_leaves, tree_unflatten
from ray_tpu_torch.parallel import (MeshConfig, dcn_rules, fsdp_rules,
                                    make_1d_mesh, make_mesh,
                                    make_multislice_mesh, tp_rules)
from ray_tpu_torch.parallel import ops
from ray_tpu_torch.parallel.moe import moe_layer
from ray_tpu_torch.parallel.partition import PartitionSpec as P
from ray_tpu_torch.parallel.pipeline import (make_1f1b_train_fn,
                                             make_pipelined_fn,
                                             make_pipelined_train_fn,
                                             one_f1b_schedule)
from ray_tpu_torch.parallel.sequence import (ring_attention,
                                             sequence_parallel_attention,
                                             ulysses_attention)


def _np(x):
    return x.detach().float().numpy()


def _t(x, grad=False):
    return torch.from_numpy(np.asarray(x)).requires_grad_(grad)


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_np(v) for v in tree)
    return _np(tree)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def collectives(xs, ws):
    """Each op under shard_map over a 1-D "i" mesh on the global ``xs``
    (split on dim 0), and the gradient of sum(out * w) w.r.t. xs."""
    mesh = make_1d_mesh("i")
    n = mesh.size(0)
    cases = {
        "psum": (lambda x: ops.allreduce(x, "i"), P()),
        "pmean": (lambda x: ops.allreduce_mean(x, "i"), P()),
        "all_gather": (lambda x: ops.allgather(x, "i", axis=1), P("i")),
        "all_gather_untiled": (
            lambda x: ops.allgather(x, "i", axis=0, tiled=False), P("i")),
        "psum_scatter": (lambda x: ops.reducescatter(x, "i", 1), P("i")),
        "all_to_all": (lambda x: ops.all_to_all(x, "i", 1, 0), P("i")),
        "all_to_all_untiled": (lambda x: ops.all_to_all(
            x.reshape(x.shape[0], n, -1), "i", 1, 0, tiled=False), P("i")),
        "ppermute": (lambda x: ops.ppermute(
            x, "i", [(i, (i + 1) % n) for i in range(n)]), P("i")),
        "ppermute_partial": (lambda x: ops.ppermute(x, "i", [(0, 1)]),
                             P("i")),
        "ring_shift": (lambda x: ops.ring_shift(x, "i", -1), P("i")),
        "broadcast_from": (lambda x: ops.broadcast_from(x, "i", 1),
                           P("i")),
        "axis_index": (lambda x: x * 0 + ops.axis_index("i"), P("i")),
    }
    out = {}
    for name, (fn, out_spec) in cases.items():
        x = _t(xs, grad=True)
        y = ops.shard_map(fn, mesh=mesh, in_specs=(P("i"),),
                          out_specs=out_spec)(x)
        w = torch.from_numpy(np.asarray(ws[name]))
        (y * w).sum().backward()
        out[name] = (_np(y), _np(x.grad))
    return out


def traffic_of_one_all_reduce(n_elements):
    """TRAFFIC after one all-reduce of n f32 elements over the world."""
    mesh = make_1d_mesh("i")
    ops.TRAFFIC.reset()
    with ops.bind(mesh):
        ops.allreduce(torch.ones(n_elements), "i")
    return ops.TRAFFIC.snapshot()


def hop_in_flight(delay):
    """A 2-rank ring hop of each rank's index, rank 1 issuing its side
    ``delay`` seconds late: the value received, and the seconds
    ppermute_start and the wait took on this rank."""
    import time

    mesh = make_1d_mesh("i")
    with ops.bind(mesh):
        me = ops.axis_index("i")
        if me == 1:
            time.sleep(delay)
        t0 = time.perf_counter()
        wait = ops.ppermute_start(torch.full((4,), float(me)), "i",
                                  [(0, 1), (1, 0)])
        t1 = time.perf_counter()
        received = wait()
        t2 = time.perf_counter()
    return {"received": float(received[0].detach()), "start_s": t1 - t0,
            "wait_s": t2 - t1}


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------
def ring(q, k, v, w):
    """sequence_parallel_attention over every rank; out and the grads of
    sum(out * w)."""
    mesh = make_1d_mesh("sp")
    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    out = sequence_parallel_attention(mesh, tq, tk, tv)
    (out * torch.from_numpy(w)).sum().backward()
    return _np(out), _np(tq.grad), _np(tk.grad), _np(tv.grad)


def ring_no_grad(q, k, v):
    mesh = make_1d_mesh("sp")
    with torch.no_grad():
        return _np(sequence_parallel_attention(mesh, _t(q), _t(k), _t(v)))


def ulysses(q, k, v, w, flash):
    from ray_tpu_torch.ops.attention import flash_attention

    mesh = make_1d_mesh("sp")
    spec = P(None, None, "sp", None)
    fn = ops.shard_map(
        lambda a, b, c: ulysses_attention(
            a, b, c, "sp", attn_fn=flash_attention if flash else None),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    out = fn(tq, tk, tv)
    (out * torch.from_numpy(w)).sum().backward()
    return _np(out), _np(tq.grad), _np(tk.grad), _np(tv.grad)


def ring_local_shapes(q, k, v):
    """ring_attention called directly inside shard_map: the local shapes
    it sees and returns."""
    mesh = make_1d_mesh("sp")
    seen = {}

    def local(a, b, c):
        seen["in"] = list(a.shape)
        o = ring_attention(a, b, c, "sp")
        seen["out"] = list(o.shape)
        return o

    spec = P(None, None, "sp", None)
    with torch.no_grad():
        ops.shard_map(local, mesh=mesh, in_specs=(spec,) * 3,
                      out_specs=spec)(_t(q), _t(k), _t(v))
    return seen


# ---------------------------------------------------------------------------
# pipelines
# ---------------------------------------------------------------------------
def _stage(kind):
    if kind == "linear":
        return lambda w, a: a @ w
    if kind == "tanh":
        return lambda w, a: torch.tanh(a @ w)
    if kind == "affine":
        return lambda p, a: torch.tanh(a @ p[0] + p[1])
    return lambda p, a: torch.tanh(a @ p["w"] + p["b"])


def _mse(out, y):
    return ((out - y) ** 2).mean()


def pipeline_forward(ws, x, n_micro, kind):
    mesh = make_1d_mesh("pp")
    with torch.no_grad():
        return _np(make_pipelined_fn(mesh, _stage(kind), n_micro)(
            _t(ws), _t(x)))


def gpipe_train(params, x, y, n_micro, steps, lr):
    """``steps`` GPipe training steps (SGD, ``lr``): losses, and the first
    step's grads."""
    mesh = make_1d_mesh("pp")
    step = make_pipelined_train_fn(mesh, _stage("affine"), _mse, n_micro)
    p = tuple(_t(a) for a in params)
    losses, first = [], None
    for _ in range(steps):
        loss, grads = step(p, _t(x), _t(y))
        losses.append(float(loss))
        first = first or tuple(_np(g) for g in grads)
        p = tuple(a - lr * g for a, g in zip(p, grads))
    return losses, first


def f1b_train(params, x, y, n_micro):
    mesh = make_1d_mesh("pp")
    step = make_1f1b_train_fn(mesh, _stage("dict"), _mse, n_micro)
    loss, grads = step({k: _t(v) for k, v in params.items()}, _t(x), _t(y))
    return float(loss), {k: _np(g) for k, g in grads.items()}


def f1b_schedule(n_stages, n_micro):
    return one_f1b_schedule(n_stages, n_micro)


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------
def moe_ep(x, gw, w1, w2, cf, w):
    """moe_layer(axis_name="ep") under shard_map over every rank: y, aux
    and the grads of sum(y * w) + aux."""
    mesh = make_1d_mesh("ep")
    fn = ops.shard_map(
        lambda a, g, b, c: moe_layer(a, g, b, c, capacity_factor=cf,
                                     axis_name="ep"),
        mesh=mesh, in_specs=(P("ep"), P(), P("ep"), P("ep")),
        out_specs=(P("ep"), P()))
    ts = [_t(a, grad=True) for a in (x, gw, w1, w2)]
    y, aux = fn(*ts)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    return _np(y), float(aux), [_np(t.grad) for t in ts]


def moe_model_ep(cfg_fields, params, tokens, targets):
    """moe_loss with ``ep_axis="ep"`` under shard_map (experts split over
    every rank, tokens split by batch row) and its grads."""
    from ray_tpu_torch.models import moe as tmoe

    cfg = tmoe.MoEConfig(dtype=torch.float32, ep_axis="ep", **cfg_fields)
    mesh = make_1d_mesh("ep")
    tp = from_jax_params(params, "cpu")
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    layer_spec = {"ln1": P(), "wqkv": P(), "wo": P(), "ln2": P(),
                  "gate": P(), "expert_w1": P("ep"), "expert_w2": P("ep")}
    spec = {"embed": P(), "lnf": P(),
            "layers": [layer_spec] * len(tp["layers"])}
    fn = ops.shard_map(
        lambda p, a, b: tmoe.moe_loss(p, (a, b), cfg)[None], mesh=mesh,
        in_specs=(spec, P("ep"), P("ep")), out_specs=P("ep"))
    losses = fn(tp, torch.from_numpy(tokens), torch.from_numpy(targets))
    losses.mean().backward()
    return _np(losses), _tree_np(_grads(tp))


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grads(v) for v in tree]
    return tree.grad


# ---------------------------------------------------------------------------
# the GPT step on a mesh
# ---------------------------------------------------------------------------
_RULES = {"tp": tp_rules, "fsdp": fsdp_rules, "dcn": dcn_rules}


class _Recording(torch.optim.AdamW):
    """The default AdamW, keeping the gradients of its first step."""

    def __init__(self, params):
        super().__init__(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                         weight_decay=0.01)
        self.first = None

    def step(self, closure=None):
        if self.first is None:
            self.first = [p.grad.detach().clone()
                          for g in self.param_groups for p in g["params"]]
        return super().step(closure)


def gpt_steps(cfg_fields, params, batches, mesh_fields, rules, slices=None):
    """The port's GPT step on a mesh: losses, the params gathered to the
    JAX layout, this rank's block shapes and its AdamW moments' shapes."""
    cfg = GPTConfig(dtype=torch.float32, **cfg_fields)
    if slices:
        mesh = make_multislice_mesh(MeshConfig(**mesh_fields),
                                    num_slices=slices)
    else:
        mesh = make_mesh(MeshConfig(**mesh_fields))
    init_state, train_step = tgpt.make_train_step(
        cfg, optimizer=_Recording, device="cpu", mesh=mesh,
        rules=_RULES[rules]())
    state = init_state(params=from_jax_params(params, "cpu"))
    losses = []
    for tokens, targets in batches:
        state, m = train_step(state, shard_batch((tokens, targets), mesh))
        losses.append(float(m["loss"]))
    full = tgpt.gather_gpt_params(state["params"], cfg, mesh,
                                  _RULES[rules]())
    blocks = {k: list(v.shape)
              for k, v in state["params"]["layers"][0].items()}
    blocks["embed"] = list(state["params"]["embed"].shape)
    opt = state["opt_state"]
    moments = [list(opt.state[p]["exp_avg"].shape)
               for p in tree_leaves(state["params"])]
    grads = tgpt.gather_gpt_params(
        tree_unflatten(state["params"], opt.first), cfg,
        mesh, _RULES[rules]())
    return {"losses": losses, "params": _tree_np(full), "blocks": blocks,
            "grads": _tree_np(grads),
            "moments": moments,
            "leaves": [list(p.shape) for p in tree_leaves(state["params"])]}


def wqkv_round_trip(d, tp):
    """A [d, 3d] wqkv whose entry is its column index, through
    shard_params and gather_gpt_params on a dp x tp mesh: this rank's
    block and the gathered whole."""
    cfg = GPTConfig(vocab_size=8 * tp, d_model=d, n_heads=2 * tp,
                    n_layers=1, d_ff=4 * tp, dtype=torch.float32)
    params = tgpt.gpt_init(cfg, torch.Generator().manual_seed(0), "cpu")
    params["layers"][0]["wqkv"] = torch.arange(3 * d, dtype=torch.float32
                                               ).repeat(d, 1)
    mesh = make_mesh(MeshConfig(tp=tp))
    placed = tgpt.shard_params(params, cfg, mesh, tp_rules())
    back = tgpt.gather_gpt_params(placed, cfg, mesh, tp_rules())
    return (_np(placed["layers"][0]["wqkv"][0]),
            bool(torch.equal(back["layers"][0]["wqkv"],
                             params["layers"][0]["wqkv"])),
            all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                   tree_leaves(params))))


def train_step_raises(mesh_fields, family, rules="tp"):
    """The message make_*_train_step raises for a mesh and a rule table
    (``"tp"``, or ``"vocab_replicated"``: tp_rules with the vocab left
    unsplit, against Megatron's layout), or None."""
    from ray_tpu_torch.models import make_train_step

    mesh = make_mesh(MeshConfig(**mesh_fields))
    table = tp_rules()
    if rules == "vocab_replicated":
        table = table.with_overrides([("vocab", None)])
    try:
        if family == "gpt":
            make_train_step(GPTConfig.tiny(), device="cpu", mesh=mesh,
                            rules=table)
        else:
            cls, make_step, _, _ = _family(family)
            make_step(dataclasses.replace(cls.tiny(), dtype=torch.float32),
                      device="cpu", mesh=mesh, rules=table)
    except NotImplementedError as e:
        return str(e)
    return None


def slice_info():
    from ray_tpu_torch.parallel import local_slice_info, slice_count

    return local_slice_info(), slice_count(), slice_count([0, 0, 1, 1])


def multislice_mesh_raises():
    try:
        make_multislice_mesh(MeshConfig(dp=2))
    except ValueError as e:
        return str(e)
    return None


def step_traffic(cfg_fields, mesh_fields, rules, batch, seq, steps):
    """TRAFFIC over ``steps`` GPT steps (f32, from seeded weights) on a
    mesh, and the bytes of the whole params: what chip_smoke.py's bytes
    reckoning is held to."""
    cfg = GPTConfig(dtype=torch.float32, **cfg_fields)
    mesh = make_mesh(MeshConfig(**mesh_fields))
    init_state, train_step = tgpt.make_train_step(
        cfg, device="cpu", mesh=mesh, rules=_RULES[rules]())
    state = init_state(torch.Generator().manual_seed(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (batch, seq + 1))
    data = shard_batch((toks[:, :-1], toks[:, 1:]), mesh)
    ops.TRAFFIC.reset()
    for _ in range(steps):
        state, _ = train_step(state, data)
    traffic = ops.TRAFFIC.snapshot()
    full = tgpt.gather_gpt_params(state["params"], cfg, mesh,
                                  _RULES[rules]())
    return traffic, sum(p.numel() * p.element_size()
                        for p in tree_leaves(full))


def remat_traffic(family, cfg_fields, mesh_fields, batch):
    """One f32 GPT or ViT step on a tp mesh from seed-0 weights, remat on
    and off: by remat, this rank's TRAFFIC and the params after the step
    (numpy, the layout of the rank's blocks)."""
    from ray_tpu_torch.models import vit

    out = {}
    for remat in (True, False):
        if family == "gpt":
            cfg = GPTConfig(dtype=torch.float32, remat=remat, **cfg_fields)
            make = tgpt.make_train_step
        else:
            cfg = vit.ViTConfig(dtype=torch.float32, remat=remat,
                                **cfg_fields)
            make = vit.make_vit_train_step
        mesh = make_mesh(MeshConfig(**mesh_fields))
        init_state, train_step = make(cfg, device="cpu", mesh=mesh,
                                      rules=tp_rules())
        state = init_state(torch.Generator().manual_seed(0))
        ops.TRAFFIC.reset()
        state, _ = train_step(state, shard_batch(batch, mesh))
        out[remat] = (ops.TRAFFIC.snapshot(), _tree_np(state["params"]))
    return out


def pipeline_peak_saved(n_micro, d, rows, kind):
    """The most bytes autograd held saved for backward at once over one
    GPipe or 1F1B training step (tanh stages, zeros) on every rank: a
    saved tensor counts from its packing until autograd drops it."""
    import weakref

    mesh = make_1d_mesh("pp")
    n = mesh.size(0)
    live, peak = [0], [0]

    class Held:
        __slots__ = ("t", "__weakref__")

    def pack(t):
        held, nbytes = Held(), t.numel() * t.element_size()
        held.t = t
        live[0] += nbytes
        peak[0] = max(peak[0], live[0])
        weakref.finalize(held, lambda: live.__setitem__(0, live[0] - nbytes))
        return held

    make = make_1f1b_train_fn if kind == "1f1b" else make_pipelined_train_fn
    step = make(mesh, _stage("dict"), _mse, n_micro)
    params = {"w": torch.zeros(n, d, d), "b": torch.zeros(n, d)}
    x = torch.zeros(n_micro * rows, d)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda h: h.t):
        step(params, x, x)
    return peak[0]


# ---------------------------------------------------------------------------
# the llama, ViT and MoE steps on a mesh (tests/test_torch_parallel_families)
# ---------------------------------------------------------------------------
def _family(name):
    """(config class, step factory, axes table, tp segments) of a family."""
    from ray_tpu_torch.models import llama, moe, vit

    return {"llama": (llama.LlamaConfig, llama.make_llama_train_step,
                      llama.llama_param_axes, llama.TP_SEGMENTS),
            "vit": (vit.ViTConfig, vit.make_vit_train_step,
                    vit.vit_param_axes, vit.TP_SEGMENTS),
            "moe": (moe.MoEConfig, moe.make_moe_train_step,
                    moe.moe_param_axes, moe.TP_SEGMENTS)}[name]


def _mesh_of(mesh_fields, slices=None):
    if slices:
        return make_multislice_mesh(MeshConfig(**mesh_fields),
                                    num_slices=slices)
    return make_mesh(MeshConfig(**mesh_fields))


def family_steps(family, cfg_fields, params, batches, mesh_fields, rules,
                 slices=None, fault=None):
    """The port's ``family`` step on a mesh from JAX's start params, one
    step a batch: the losses, the params and the first step's gradients
    gathered to the JAX layout, this rank's block shapes (by key: layer
    0's, then the top-level ones) and, for MoE, the kept routes of the
    first step's forward in the global batch's token order."""
    from ray_tpu_torch.models._training import batch_axes_of, gather_params

    cls, make_step, param_axes, segments = _family(family)
    cfg = cls(dtype=torch.float32, **cfg_fields)
    mesh = _mesh_of(mesh_fields, slices)
    rule_table = _RULES[rules]()
    init_state, train_step = make_step(cfg, optimizer=_Recording,
                                       device="cpu", mesh=mesh,
                                       rules=rule_table)
    state = init_state(params=from_jax_params(params, "cpu"))
    import contextlib

    from ray_tpu_torch.parallel import moe as pmoe

    cs = _chip_smoke()
    routes, losses = [], []
    with (cs.planted_fault(family, fault) if fault
          else contextlib.nullcontext()):
        for i, (tokens, targets) in enumerate(batches):
            # The first step's forward records its routes (the remat
            # recompute in its backward calls the gating again, after).
            kept = cs.record_routes(routes) if i == 0 else None
            try:
                state, m = train_step(state, shard_batch((tokens, targets),
                                                         mesh))
            finally:
                if kept is not None:
                    pmoe.top2_gating = kept
            losses.append(float(m["loss"]))
    out = {}
    if family == "moe":
        routes = routes[:cfg.n_layers]
        axes = batch_axes_of(mesh)
        if axes:
            routes = [ops._all_gather(r, ops.axis_group(mesh, axes), 0)
                      for r in routes]
        out["routes"] = [r.numpy() for r in routes]
    axes = param_axes(cfg)
    full = gather_params(state["params"], axes, mesh, rule_table, segments)
    grads = gather_params(
        tree_unflatten(state["params"], state["opt_state"].first), axes,
        mesh, rule_table, segments)
    blocks = {k: list(v.shape)
              for k, v in state["params"]["layers"][0].items()}
    blocks.update({k: list(v.shape) for k, v in state["params"].items()
                   if k != "layers"})
    out.update({"losses": losses, "params": _tree_np(full),
                "grads": _tree_np(grads), "blocks": blocks})
    return out


def resnet_placed_blocks(cfg_fields, params, mesh_fields, rules):
    """This rank's block of every ResNet param after ``place_params``,
    in tree order."""
    from ray_tpu_torch.models import resnet
    from ray_tpu_torch.models._training import place_params

    cfg = resnet.ResNetConfig(dtype=torch.float32, **cfg_fields)
    mesh = _mesh_of(mesh_fields)
    placed = place_params(from_jax_params(params, "cpu"),
                          resnet.resnet_param_axes(cfg), mesh,
                          _RULES[rules]())
    return [_np(p) for p in tree_leaves(placed)]


def _chip_smoke():
    """chip_smoke.py (at the repo's root, torch only at import) by its
    module name."""
    import importlib
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


def chip_smoke_call(name, *args):
    """``chip_smoke.<name>(*args)`` in a rank."""
    return getattr(_chip_smoke(), name)(*args)
