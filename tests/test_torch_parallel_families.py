"""The port's llama, ViT and MoE train steps on a mesh, held against the
JAX package's sharded steps on the CPU.

The same numpy-seeded batches and the JAX start params (converted by
``from_jax_params``) go through JAX's ``make_*_train_step(mesh=,
rules=)`` on its 8-device CPU mesh and through the port's step on 2 or
4 gloo ranks (``RankPool`` processes running
``tests/torch_parallel_ranks.py``). Each case holds the losses, the
first step's gradients (gathered to the JAX layout, against ``jax.grad``
of the unsplit loss), the params after 2 AdamW steps and each rank's
block shapes (against JAX's shard shapes) in the bands of
``test_torch_parallel.py``, f32 on both sides. MoE cases also count the
routes that differ from JAX's on the first batch. Planted faults of the
MoE expert form must fall outside the gradient band, and the port's
ResNet placement must give each rank JAX's block.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_ranks as ranks
from ray_tpu.models import llama as jllama
from ray_tpu.models import moe as jmoe
from ray_tpu.models import resnet as jresnet
from ray_tpu.models import vit as jvit
from ray_tpu.models._training import place_params as j_place_params
from ray_tpu.models.gpt import shard_batch as j_shard_batch
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import dcn_rules as j_dcn_rules
from ray_tpu.parallel import fsdp_rules as j_fsdp_rules
from ray_tpu.parallel import make_mesh as j_make_mesh
from ray_tpu.parallel import make_multislice_mesh as j_make_multislice_mesh
from ray_tpu.parallel import moe as jpmoe
from ray_tpu.parallel import tp_rules as j_tp_rules
from ray_tpu_torch.parallel.launch import RankPool
from test_torch_parallel import (GRAD_TOL, LOSS_RTOL, PARAM_TOL, TIMEOUT,
                                 _assert_same, _losses_close, _param_errs)

_POOLS = {}


def pool(n):
    """The pool of n ranks; the pool of another size is closed first."""
    if n not in _POOLS:
        close_pools()
        _POOLS[n] = RankPool(n, "cpu", timeout=TIMEOUT)
    return _POOLS[n]


def close_pools():
    for p in _POOLS.values():
        p.close()
    _POOLS.clear()


@pytest.fixture(scope="module", autouse=True)
def _pools():
    yield
    close_pools()


def run(n, fn, *args):
    """fn(*args) on n ranks: rank 0's result, after checking that every
    rank returned the same."""
    out = pool(n).run(fn, *args)
    for other in out[1:]:
        _assert_same(other, out[0])
    return out[0]


# family -> (config class, step factory, loss)
FAMILIES = {
    "llama": (jllama.LlamaConfig, jllama.make_llama_train_step,
              jllama.llama_loss),
    "vit": (jvit.ViTConfig, jvit.make_vit_train_step, jvit.vit_loss),
    "moe": (jmoe.MoEConfig, jmoe.make_moe_train_step, jmoe.moe_loss),
}
# mesh name -> (MeshConfig fields, rule table, slices): every family runs
# the first six, MoE also the last two.
MESHES = {
    "tp2": ({"tp": 2}, "tp", None),
    "fsdp2": ({"fsdp": 2}, "fsdp", None),
    "dp2_tp2": ({"dp": 2, "tp": 2}, "tp", None),
    "tp4": ({"tp": 4}, "tp", None),
    "fsdp2_tp2": ({"fsdp": 2, "tp": 2}, "fsdp", None),
    "dcn2_dp2": ({"dp": 2}, "dcn", 2),
    "ep2": ({"ep": 2}, "tp", None),
    "ep2_tp2": ({"ep": 2, "tp": 2}, "tp", None),
}
J_RULES = {"tp": j_tp_rules, "fsdp": j_fsdp_rules, "dcn": j_dcn_rules}


def _ranks(mesh_name):
    fields, _, slices = MESHES[mesh_name]
    return int(np.prod(list(fields.values()))) * (slices or 1)


# Two-rank cases first, so each pool size starts once.
CASES = sorted(
    [(family, mesh) for family in FAMILIES for mesh in MESHES
     if family == "moe" or not mesh.startswith("ep")],
    key=lambda case: _ranks(case[1]))


def _batches(family, cfg, n=2, b=8, s=16):
    out = []
    for i in range(n):
        rng = np.random.default_rng(50 + i)
        if family == "vit":
            out.append((rng.random((b, cfg.image_size, cfg.image_size,
                                    cfg.channels), dtype=np.float32),
                        rng.integers(0, cfg.num_classes, b)))
        else:
            toks = rng.integers(0, cfg.vocab_size, (b, s + 1))
            out.append((toks[:, :-1], toks[:, 1:]))
    return out


def _jcfg(family, **overrides):
    return dataclasses.replace(FAMILIES[family][0].tiny(), dtype=jnp.float32,
                               **overrides)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "dtype"}


_UNSPLIT = {}


def _unsplit(family):
    """The JAX start params, the batches, jax.grad of the unsplit loss on
    the first batch and (MoE) the kept routes of one forward on it."""
    if family not in _UNSPLIT:
        _, make_step, loss = FAMILIES[family]
        jcfg = _jcfg(family)
        start = jax.tree.map(np.asarray,
                             make_step(jcfg, donate=False)[0](
                                 jax.random.PRNGKey(3))["params"])
        batches = _batches(family, jcfg)
        grads = jax.tree.map(np.asarray, jax.jit(
            jax.grad(loss), static_argnums=2)(
            jax.tree.map(jnp.asarray, start),
            tuple(map(jnp.asarray, batches[0])), jcfg))
        routes = None
        if family == "moe":
            routes = _j_routes(start, batches[0], _jcfg(family, remat=False))
        _UNSPLIT[family] = (start, batches, grads, routes)
    return _UNSPLIT[family]


def _j_routes(params, batch, jcfg):
    """Each layer's kept routes ([tokens, experts] bool) in JAX's forward,
    run eagerly with top2_gating wrapped."""
    kept, seen = jpmoe.top2_gating, []

    def recorded(logits, capacity):
        dispatch, combine, aux = kept(logits, capacity)
        seen.append(np.asarray(dispatch).any(-1))
        return dispatch, combine, aux
    jpmoe.top2_gating = recorded
    try:
        jmoe.moe_forward(jax.tree.map(jnp.asarray, params),
                         jnp.asarray(batch[0]), jcfg)
    finally:
        jpmoe.top2_gating = kept
    return seen


def _j_mesh(mesh_name):
    fields, rules, slices = MESHES[mesh_name]
    devices = jax.devices()[:_ranks(mesh_name)]
    if slices:
        return (j_make_multislice_mesh(JMeshConfig(**fields),
                                       devices=devices, num_slices=slices),
                ("dp_dcn", "dp"))
    return j_make_mesh(JMeshConfig(**fields), devices=devices), "dp"


def _j_steps(family, mesh_name, batches):
    """JAX's sharded steps: the losses, the final params and every
    param's shard shape (layer 0's and the top-level ones)."""
    make_step = FAMILIES[family][1]
    mesh, axis = _j_mesh(mesh_name)
    init, step = make_step(_jcfg(family), donate=False, mesh=mesh,
                           rules=J_RULES[MESHES[mesh_name][1]]())
    state = init(jax.random.PRNGKey(3))
    blocks = {k: list(v.sharding.shard_shape(v.shape))
              for k, v in state["params"]["layers"][0].items()}
    blocks.update({k: list(v.sharding.shard_shape(v.shape))
                   for k, v in state["params"].items() if k != "layers"})
    losses = []
    for batch in batches:
        state, m = step(state, j_shard_batch(tuple(map(jnp.asarray, batch)),
                                             mesh, axis=axis))
        losses.append(float(m["loss"]))
    return losses, jax.tree.map(np.asarray, state["params"]), blocks


def _port(family, mesh_name, batches, fault=None):
    """The port's steps: rank 0's result, after checking that every rank
    returned the same (a planted fault may leave them apart)."""
    fields, rules, slices = MESHES[mesh_name]
    args = (ranks.family_steps, family, _fields(_jcfg(family)),
            _unsplit(family)[0], batches, fields, rules, slices, fault)
    if fault is None:
        return run(_ranks(mesh_name), *args)
    return pool(_ranks(mesh_name)).run(*args)[0]


# Leaves per family at the tiny configs' 2 layers.
LEAVES = {"llama": 3 + 8 * 2, "vit": 5 + 6 * 2, "moe": 2 + 7 * 2}


class TestFamilyStepsMatchJax:
    @pytest.mark.parametrize("family,mesh_name", CASES)
    def test_step(self, family, mesh_name):
        start, batches, jgrads, jroutes = _unsplit(family)
        jlosses, jparams, jblocks = _j_steps(family, mesh_name, batches)
        got = _port(family, mesh_name, batches)
        _losses_close(got["losses"], jlosses, LOSS_RTOL)
        errs = _param_errs(got["grads"], jgrads)
        assert len(errs) == LEAVES[family]
        assert max(errs) <= GRAD_TOL, errs
        assert max(_param_errs(got["params"], jparams)) <= PARAM_TOL
        # Megatron's blocks (and fsdp's): each rank holds the shard shape
        # JAX gives its device.
        assert got["blocks"] == jblocks
        if family == "moe":
            # The tokens of every batch shard are routed as one batch, as
            # JAX routes its global batch: no token's experts differ.
            flips = sum(int((ours != theirs).any(-1).sum())
                        for ours, theirs in zip(got["routes"], jroutes))
            assert len(got["routes"]) == len(jroutes) == 2
            assert flips == 0, flips


class TestMoEControls:
    @pytest.mark.parametrize("fault", ["sum_after_combine", "f_on_gate"])
    def test_planted_fault_leaves_the_band(self, fault):
        # The tp sum moved after the combine leaves the router a share of
        # its gradient; an "f" on the router's input counts its share of
        # x's gradient twice. The gradient band must reject both.
        _, batches, jgrads, _ = _unsplit("moe")
        got = _port("moe", "tp2", batches[:1], fault)
        errs = _param_errs(got["grads"], jgrads)
        assert max(errs) > 100 * GRAD_TOL, errs


class TestResNetPlacement:
    @pytest.mark.parametrize("rules", ["tp", "fsdp"])
    def test_blocks_equal_jax_place_params(self, rules):
        # JAX's ResNet has no sharded step: its "tp" is a placement.
        # Each rank's block of every param is device r's shard of JAX's.
        mesh_fields = {rules: 2}
        jcfg = dataclasses.replace(jresnet.ResNetConfig.tiny(),
                                   dtype=jnp.float32)
        params = jresnet.resnet_init(jax.random.PRNGKey(4), jcfg)
        mesh = j_make_mesh(JMeshConfig(**mesh_fields),
                           devices=jax.devices()[:2])
        placed = j_place_params(params, jresnet.resnet_param_axes(jcfg),
                                mesh, J_RULES[rules]())
        leaves = jax.tree.leaves(placed)
        split = [x for x in leaves
                 if x.sharding.shard_shape(x.shape) != x.shape]
        assert split, "the rules split no ResNet param"
        out = pool(2).run(ranks.resnet_placed_blocks, _fields(jcfg),
                          jax.tree.map(np.asarray, params), mesh_fields,
                          rules)
        devices = list(mesh.devices.flat)
        for rank, blocks in enumerate(out):
            assert len(blocks) == len(leaves)
            for ours, x in zip(blocks, leaves):
                shard = [s for s in x.addressable_shards
                         if s.device == devices[rank]][0]
                np.testing.assert_array_equal(ours, np.asarray(shard.data))


class TestRaises:
    @pytest.mark.parametrize("family,key", [("llama", "embed"),
                                            ("vit", "patch"),
                                            ("moe", "embed")])
    def test_rules_against_megatron_layout_raise(self, family, key):
        msg = run(2, ranks.train_step_raises, {"tp": 2}, family,
                  "vocab_replicated")
        assert msg is not None and f"{key} over tp on dims ()" in msg, msg

    @pytest.mark.parametrize("family,axes", [("llama", {"ep": 2}),
                                             ("vit", {"sp": 2}),
                                             ("moe", {"pp": 2})])
    def test_mesh_axes_the_step_does_not_run_raise(self, family, axes):
        msg = run(2, ranks.train_step_raises, axes, family)
        assert msg is not None and "ROADMAP.md" in msg, msg

    def test_moe_step_runs_ep(self):
        assert run(2, ranks.train_step_raises, {"ep": 2}, "moe") is None
