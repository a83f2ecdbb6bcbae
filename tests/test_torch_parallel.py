"""ray_tpu_torch.parallel held against ray_tpu.parallel on the CPU.

Every case of ``tests/test_parallel.py`` (ring attention, Ulysses, the
GPipe and 1F1B pipelines, expert-parallel MoE, FSDP, multi-slice), the
tensor-parallel GPT step and the collectives by axis name run twice on
the same numpy-seeded inputs: in the JAX package on the 8-device CPU
mesh (``tests/conftest.py``), and in the port on 2, 4 or 8 gloo ranks.
The ranks are ``RankPool`` processes that run
``tests/torch_parallel_ranks.py`` (torch only); one pool serves every
case of its size in turn, and every call to it has its own deadline.
Each test states its tolerance: both sides compute in f32 unless it
says otherwise.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as JP

import torch_parallel_ranks as ranks
from ray_tpu.models import GPTConfig as JGPTConfig
from ray_tpu.models import moe as jmoe
from ray_tpu.models.gpt import gpt_loss as j_gpt_loss
from ray_tpu.models.gpt import make_train_step as j_make_train_step
from ray_tpu.models.gpt import shard_batch as j_shard_batch
from ray_tpu.ops.attention import mha_reference
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import dcn_rules as j_dcn_rules
from ray_tpu.parallel import fsdp_rules as j_fsdp_rules
from ray_tpu.parallel import make_mesh as j_make_mesh
from ray_tpu.parallel import make_multislice_mesh as j_make_multislice_mesh
from ray_tpu.parallel import tp_rules as j_tp_rules
from ray_tpu.parallel.moe import moe_layer as j_moe_layer
from ray_tpu.parallel.ops import shard_map as j_shard_map
from ray_tpu.parallel.pipeline import make_1f1b_train_fn as j_1f1b
from ray_tpu.parallel.pipeline import make_pipelined_fn as j_pipelined_fn
from ray_tpu.parallel.pipeline import (
    make_pipelined_train_fn as j_pipelined_train_fn)
from ray_tpu.parallel.pipeline import one_f1b_schedule as j_schedule
from ray_tpu.parallel.sequence import sequence_parallel_attention as j_ring
from ray_tpu.parallel.sequence import ulysses_attention as j_ulysses
from ray_tpu_torch.parallel.launch import RankPool

# Deadline of one call to the ranks (a rank stuck in a collective fails
# the test at this point instead of hanging the suite).
TIMEOUT = 120

_POOLS = {}


def pool(n):
    """The pool of n ranks; the pool of another size is closed first, so
    no more than one set of ranks is alive."""
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
    """fn(*args) on n ranks: rank 0's result, after checking every rank
    returned the same (the global values are replicated)."""
    out = pool(n).run(fn, *args)
    for other in out[1:]:
        _assert_same(other, out[0])
    return out[0]


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _mesh(n, name):
    return Mesh(np.array(jax.devices()[:n]), (name,))


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _qkv(b=2, h=4, s=64, d=16, seed=0):
    return tuple(_rand(seed * 3 + i, b, h, s, d) for i in range(3))


def _close(ours, theirs, tol):
    """max |ours - theirs| <= tol * max(1, max |theirs|)."""
    ours, theirs = np.asarray(ours, np.float32), np.asarray(theirs,
                                                            np.float32)
    assert ours.shape == theirs.shape, (ours.shape, theirs.shape)
    err = np.abs(ours - theirs).max() / max(1.0, np.abs(theirs).max())
    assert err <= tol, err


# ---------------------------------------------------------------------------
# collectives by axis name (2 and 4 ranks)
# ---------------------------------------------------------------------------
def _j_collectives(xs, n):
    mesh = _mesh(n, "i")
    from jax import lax

    cases = {
        "psum": (lambda x: lax.psum(x, "i"), JP()),
        "pmean": (lambda x: lax.pmean(x, "i"), JP()),
        "all_gather": (lambda x: lax.all_gather(x, "i", axis=1, tiled=True),
                       JP("i")),
        "all_gather_untiled": (lambda x: lax.all_gather(x, "i", axis=0),
                               JP("i")),
        "psum_scatter": (lambda x: lax.psum_scatter(
            x, "i", scatter_dimension=1, tiled=True), JP("i")),
        "all_to_all": (lambda x: lax.all_to_all(x, "i", 1, 0, tiled=True),
                       JP("i")),
        "all_to_all_untiled": (lambda x: lax.all_to_all(
            x.reshape(x.shape[0], n, -1), "i", 1, 0), JP("i"),
            # jax.grad of the untiled form fails on its cotangent's shape
            # in jax 0.9: the gradient is taken through the tiled form.
            lambda x: jnp.moveaxis(lax.all_to_all(
                x.reshape(x.shape[0], n, -1), "i", 1, 1, tiled=True), 1, 0)),
        "ppermute": (lambda x: lax.ppermute(
            x, "i", [(i, (i + 1) % n) for i in range(n)]), JP("i")),
        "ppermute_partial": (lambda x: lax.ppermute(x, "i", [(0, 1)]),
                             JP("i")),
        "ring_shift": (lambda x: lax.ppermute(
            x, "i", [(i, (i - 1) % n) for i in range(n)]), JP("i")),
        "broadcast_from": (lambda x: jnp.take(
            lax.all_gather(x, "i", axis=0), 1, axis=0), JP("i")),
        "axis_index": (lambda x: x * 0 + lax.axis_index("i"), JP("i")),
    }
    out = {}
    for seed, (name, (fn, spec, *grad_fn)) in enumerate(cases.items()):
        f = jax.jit(j_shard_map(fn, mesh=mesh, in_specs=(JP("i"),),
                                out_specs=spec))
        y = f(jnp.asarray(xs))
        w = _rand(100 + seed, *y.shape)
        if grad_fn:
            f = jax.jit(j_shard_map(grad_fn[0], mesh=mesh,
                                    in_specs=(JP("i"),), out_specs=spec))
        g = jax.jit(jax.grad(lambda x: jnp.sum(f(x) * w)))(jnp.asarray(xs))
        out[name] = (np.asarray(y), np.asarray(g), w)
    return out


HOP_DELAY = 1.5


class TestCollectives:
    @pytest.mark.parametrize("n", [2, 4])
    def test_values_and_grads_match_lax(self, n):
        xs = _rand(1, 2 * n, 4 * n)
        theirs = _j_collectives(xs, n)
        ours = run(n, ranks.collectives, xs,
                   {k: w for k, (_, _, w) in theirs.items()})
        assert ours.keys() == theirs.keys()
        for name, (y, g, _) in theirs.items():
            # Sums of n f32 values in another order.
            _close(ours[name][0], y, 1e-6)
            _close(ours[name][1], g, 1e-6)

    def test_traffic_counts_calls_bytes_transport(self):
        got = run(2, ranks.traffic_of_one_all_reduce, 1000)
        assert got == {"all_reduce": {"calls": 1, "bytes": 4000,
                                      "transports": ["gloo"]}}

    def test_host_staging_is_chosen_by_backend_and_op(self, monkeypatch):
        import torch
        from ray_tpu_torch.parallel import ops

        cuda, cpu = torch.device("cuda"), torch.device("cpu")
        backend = {"g": "gloo", "n": "nccl"}
        monkeypatch.setattr(ops.dist, "get_backend", backend.get)
        # gloo aborts on a CUDA tensor in a point-to-point send: only that
        # op goes through host memory, only on gloo, only from a card.
        assert ops._host_staged("ppermute", "g", cuda)
        assert not ops._host_staged("ppermute", "g", cpu)
        assert not ops._host_staged("ppermute", "n", cuda)
        for op in ("all_reduce", "all_gather", "reduce_scatter",
                   "all_to_all"):
            assert not ops._host_staged(op, "g", cuda)

    def test_hop_travels_between_start_and_wait(self):
        # Rank 1 issues its side of the ring hop HOP_DELAY late: rank 0's
        # ppermute_start returns at once and its wait takes the rest, so
        # work placed between the two (ring attention's block math)
        # overlaps the hop.
        got = pool(2).run(ranks.hop_in_flight, HOP_DELAY)
        assert [r["received"] for r in got] == [1.0, 0.0]
        assert got[0]["start_s"] < HOP_DELAY / 2, got
        assert got[0]["wait_s"] > HOP_DELAY / 2, got

    def test_unbound_axis_name_raises(self):
        import torch
        from ray_tpu_torch.parallel import ops

        with pytest.raises(NameError, match="unbound axis name"):
            ops.allreduce(torch.ones(2), "sp")


# ---------------------------------------------------------------------------
# GPT tensor parallelism (2 and 4 ranks)
# ---------------------------------------------------------------------------
STEPS = 2
# The loss's relative error, and the first step's gradient (gathered to the
# JAX layout) against jax.grad of the unsplit loss, a leaf's max |port -
# jax| over its max |jax|: the single-device bands of test_torch_train.py
# (f32). A split step sums partial products over ranks (tp's matmuls, the
# vocab-parallel cross entropy's per-rank sums, fsdp's reduce-scatter, the
# batch axes' all-reduce) where XLA sums in one place: another order of
# the same f32 sums.
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-5
# The params after 2 AdamW steps, same measure. AdamW divides each
# gradient by its own RMS, so a sum-order difference in a near-zero
# gradient moves that element by a share of the learning rate: JAX's own
# tp=2, dp=2 x tp=2, fsdp and multi-slice steps end 1.1e-5 to 2.1e-5 away
# from its dp=1 step on these inputs, above the single-device band
# (2e-5) already. The port's blocks sum in yet another order.
PARAM_TOL = 1e-4


def _gpt_batches(vocab, n=STEPS, b=8, s=32):
    out = []
    for i in range(n):
        toks = np.random.default_rng(30 + i).integers(0, vocab, (b, s + 1))
        out.append((toks[:, :-1], toks[:, 1:]))
    return out


def _j_gpt(mesh, rules, remat, batches, axis="dp"):
    """JAX's steps on ``mesh``: the config's fields, the start params, the
    losses, the final params, and jax.grad of the unsplit loss on the
    first batch."""
    jcfg = dataclasses.replace(JGPTConfig.tiny(), dtype=jnp.float32,
                               remat=remat)
    init, step = j_make_train_step(jcfg, donate=False, mesh=mesh,
                                   rules=rules)
    state = init(jax.random.PRNGKey(3))
    start = jax.tree.map(np.asarray, state["params"])
    grads = jax.tree.map(np.asarray, jax.grad(j_gpt_loss)(
        jax.tree.map(jnp.asarray, start),
        tuple(map(jnp.asarray, batches[0])), jcfg))
    losses = []
    for tokens, targets in batches:
        state, m = step(state, j_shard_batch(
            (jnp.asarray(tokens), jnp.asarray(targets)), mesh, axis=axis))
        losses.append(float(m["loss"]))
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    return (fields, start, losses, jax.tree.map(np.asarray, state["params"]),
            grads)


def _param_errs(ours, theirs):
    return jax.tree.leaves(jax.tree.map(
        lambda t, j: float(np.abs(np.asarray(t) - j).max()
                           / max(np.abs(j).max(), 1e-30)), ours, theirs))


def _losses_close(ours, theirs, rtol):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert abs(a - b) <= rtol * abs(b), (ours, theirs)


class TestTensorParallelGPT:
    @pytest.mark.parametrize("dp,tp,remat", [(1, 2, True), (2, 2, False)])
    def test_step_matches_jax_tp_rules(self, dp, tp, remat):
        n = dp * tp
        jmesh = j_make_mesh(JMeshConfig(dp=dp, tp=tp),
                            devices=jax.devices()[:n])
        batches = _gpt_batches(512)
        fields, start, jlosses, jparams, jgrads = _j_gpt(
            jmesh, j_tp_rules(), remat, batches)
        got = run(n, ranks.gpt_steps, fields, start, batches,
                  {"dp": dp, "tp": tp}, "tp")
        _losses_close(got["losses"], jlosses, LOSS_RTOL)
        errs = _param_errs(got["grads"], jgrads)
        assert len(errs) == 2 + 6 * 2
        assert max(errs) <= GRAD_TOL, errs
        assert max(_param_errs(got["params"], jparams)) <= PARAM_TOL
        # Megatron's blocks: columns of wqkv and w1, rows of wo and w2,
        # vocab rows of the tied embedding.
        assert got["blocks"] == {"ln1": [64], "wqkv": [64, 192 // tp],
                                 "wo": [64 // tp, 64], "ln2": [64],
                                 "w1": [64, 128 // tp],
                                 "w2": [128 // tp, 64],
                                 "embed": [512 // tp, 64]}

    @pytest.mark.parametrize("family", ["gpt", "vit"])
    def test_remat_recompute_sends_nothing(self, family):
        """tp=2 with remat (JAX's dots_with_no_batch_dims_saveable): the
        recompute takes the forward's row-parallel sums back, so a step
        hands all-reduce what the step without remat does, and ends on
        the same params."""
        rng = np.random.default_rng(40)
        if family == "gpt":
            fields = {"vocab_size": 512, "d_model": 64, "n_heads": 4,
                      "n_layers": 2, "d_ff": 128, "max_seq_len": 128}
            toks = rng.integers(0, 512, (4, 33))
            batch = (toks[:, :-1], toks[:, 1:])
        else:
            fields = {"image_size": 32, "patch_size": 8, "d_model": 64,
                      "n_heads": 4, "n_layers": 2, "d_ff": 128,
                      "num_classes": 10}
            batch = (rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
                     rng.integers(0, 10, 4))
        out = pool(2).run(ranks.remat_traffic, family, fields,
                          {"dp": 1, "tp": 2}, batch)
        for rank in out:
            (on, on_params), (off, off_params) = rank[True], rank[False]
            assert set(on) == {"all_reduce"}
            assert on == off
            _assert_same(on_params, off_params)

    def test_wqkv_blocks_are_head_aligned_and_gather_inverts(self):
        # wqkv's columns are [q | k | v], 8 each (4 heads of 2): rank r
        # of tp=2 holds columns r*4..r*4+3 of each of the three.
        out = pool(2).run(ranks.wqkv_round_trip, 8, 2)
        for r, (cols, wqkv_back, all_back) in enumerate(out):
            want = np.concatenate([np.arange(4) + 4 * r + 8 * part
                                   for part in range(3)])
            np.testing.assert_array_equal(cols, want)
            assert wqkv_back and all_back

    def test_block_and_unblock_invert(self):
        import torch
        from ray_tpu_torch.models._training import _block, _unblock

        x = torch.arange(2 * 24).reshape(2, 24)
        for size, parts in ((2, 3), (4, 3), (3, 1), (2, 1)):
            blocks = [_block(x, 1, r, size, parts) for r in range(size)]
            back = _unblock(torch.cat(blocks, 1), 1, size, parts)
            assert torch.equal(back, x)
        # a contiguous split of [q|k|v] would give rank 0 all of q
        assert _block(x, 1, 0, 2, 3)[0].tolist() == [
            0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 19]

    @pytest.mark.parametrize("axes", [{"pp": 2}, {"sp": 2}, {"ep": 2}])
    def test_pp_sp_ep_meshes_raise_with_roadmap(self, axes):
        msg = run(2, ranks.train_step_raises, dict(dp=1, **axes), "gpt")
        assert msg is not None and "ROADMAP.md" in msg, msg


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------
class TestRingAttention:
    @pytest.mark.parametrize("sp", [2, 4, 8])
    def test_matches_reference_and_jax(self, sp):
        q, k, v = _qkv(s=64)
        w = _rand(9, *q.shape)
        args = tuple(map(jnp.asarray, (q, k, v)))
        ref = mha_reference(*args, True)
        ring_fn = jax.jit(functools.partial(j_ring, _mesh(sp, "sp")))
        jout = ring_fn(*args)
        jgrads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(
            ring_fn(a, b, c) * w), argnums=(0, 1, 2)))(*args)
        out, dq, dk, dv = run(sp, ranks.ring, q, k, v, w)
        # test_parallel.py's band against the plain reference; the two
        # rings do the same blockwise f32 sums.
        _close(out, ref, 2e-3)
        _close(out, jout, 1e-5)
        for ours, theirs in zip((dq, dk, dv), jgrads):
            _close(ours, theirs, 1e-5)

    def test_causality_across_shards(self):
        # Mutating the last sequence shard must not affect earlier shards.
        q, k, v = _qkv(s=32)
        out1 = run(4, ranks.ring_no_grad, q, k, v)
        k2, v2 = k.copy(), v.copy()
        k2[:, :, 24:] = 7.0
        v2[:, :, 24:] = 7.0
        out2 = run(4, ranks.ring_no_grad, q, k2, v2)
        np.testing.assert_allclose(out1[:, :, :24], out2[:, :, :24],
                                   rtol=1e-4, atol=1e-4)

    def test_runs_on_local_shards(self):
        q, k, v = _qkv(s=32)
        seen = run(4, ranks.ring_local_shapes, q, k, v)
        assert seen == {"in": [2, 4, 8, 16], "out": [2, 4, 8, 16]}


class TestUlysses:
    @pytest.mark.parametrize("flash", [False, True])
    def test_matches_reference_and_jax(self, flash):
        q, k, v = _qkv(s=64)
        w = _rand(10, *q.shape)
        spec = JP(None, None, "sp", None)
        fn = jax.jit(j_shard_map(functools.partial(j_ulysses,
                                                   axis_name="sp"),
                                 mesh=_mesh(4, "sp"), in_specs=(spec,) * 3,
                                 out_specs=spec))
        args = tuple(map(jnp.asarray, (q, k, v)))
        jout = fn(*args)
        jgrads = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) * w),
                                  argnums=(0, 1, 2)))(*args)
        out, dq, dk, dv = run(4, ranks.ulysses, q, k, v, w, flash)
        _close(out, mha_reference(*args, True), 2e-3)
        # attn_fn=flash_attention is mha_reference on the CPU: the same
        # f32 attention on each rank's heads.
        _close(out, jout, 1e-5)
        for ours, theirs in zip((dq, dk, dv), jgrads):
            _close(ours, theirs, 1e-5)


# ---------------------------------------------------------------------------
# pipelines
# ---------------------------------------------------------------------------
class TestPipeline:
    def test_linear_stages(self):
        ws = np.stack([np.eye(8, dtype=np.float32) * (i + 1)
                       for i in range(4)])
        x = _rand(5, 16, 8)
        jout = j_pipelined_fn(_mesh(4, "pp"), lambda w, a: a @ w,
                              n_microbatches=4)(jnp.asarray(ws),
                                                jnp.asarray(x))
        out = run(4, ranks.pipeline_forward, ws, x, 4, "linear")
        expected = x
        for i in range(4):
            expected = expected @ (np.eye(8) * (i + 1))
        np.testing.assert_allclose(out, expected, rtol=1e-4)
        np.testing.assert_allclose(out, np.asarray(jout), rtol=1e-6)

    def test_nonlinear_stages(self):
        ws = np.stack([np.full((4, 4), 0.1, np.float32),
                       np.full((4, 4), 0.2, np.float32)])
        x = _rand(6, 8, 4)
        out = run(2, ranks.pipeline_forward, ws, x, 2, "tanh")
        expected = np.tanh(np.tanh(x @ ws[0]) @ ws[1])
        np.testing.assert_allclose(out, expected, rtol=1e-4)


def _seq_loss(stage, n_stages):
    def loss(params, x, y):
        h = x
        for s in range(n_stages):
            h = stage(jax.tree.map(lambda p: p[s], params), h)
        return jnp.mean((h - y) ** 2)
    return loss


def _affine(params, x):
    w, b = params
    return jnp.tanh(x @ w + b)


class TestPipelineTraining:
    def test_grads_match_single_device_and_jax(self):
        n_stages, n_micro, d = 4, 4, 16
        params = (_rand(11, n_stages, d, d, scale=0.5),
                  np.zeros((n_stages, d), np.float32))
        x, y = _rand(12, 8, d), _rand(13, 8, d)
        jparams = tuple(map(jnp.asarray, params))
        step = j_pipelined_train_fn(_mesh(n_stages, "pp"), _affine,
                                    lambda o, t: jnp.mean((o - t) ** 2),
                                    n_micro)
        jloss, jgrads = step(jparams, jnp.asarray(x), jnp.asarray(y))
        sloss, sgrads = jax.value_and_grad(_seq_loss(_affine, n_stages))(
            jparams, jnp.asarray(x), jnp.asarray(y))
        losses, grads = run(n_stages, ranks.gpipe_train, params, x, y,
                            n_micro, 1, 0.0)
        # test_parallel.py's bands against the sequential model.
        np.testing.assert_allclose(losses[0], float(sloss), rtol=1e-6)
        np.testing.assert_allclose(losses[0], float(jloss), rtol=1e-6)
        for ours, seq, theirs in zip(grads, sgrads, jgrads):
            np.testing.assert_allclose(ours, np.asarray(seq), rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(ours, np.asarray(theirs), rtol=1e-5,
                                       atol=1e-6)

    def test_two_stage_training_converges_like_single_device(self):
        n_stages, n_micro, d, lr = 2, 4, 8, 0.5
        params = (_rand(14, n_stages, d, d, scale=0.3),
                  np.zeros((n_stages, d), np.float32))
        x = _rand(15, 16, d)
        y = np.full((16, d), 0.5, np.float32)
        seq_step = jax.jit(jax.value_and_grad(_seq_loss(_affine, n_stages)))
        p, seq_losses = tuple(map(jnp.asarray, params)), []
        for _ in range(10):
            ls, gs = seq_step(p, jnp.asarray(x), jnp.asarray(y))
            p = jax.tree.map(lambda a, g: a - lr * g, p, gs)
            seq_losses.append(float(ls))
        losses, _ = run(n_stages, ranks.gpipe_train, params, x, y, n_micro,
                        10, lr)
        assert losses[-1] < losses[0] * 0.5
        np.testing.assert_allclose(losses, seq_losses, rtol=1e-4)


class Test1F1B:
    @pytest.mark.parametrize("s,m", [(2, 4), (4, 8), (3, 7), (4, 2)])
    def test_schedule_equals_jax(self, s, m):
        from ray_tpu_torch.parallel.pipeline import one_f1b_schedule

        act, mb = one_f1b_schedule(s, m)
        jact, jmb = j_schedule(s, m)
        np.testing.assert_array_equal(act, jact)
        np.testing.assert_array_equal(mb, jmb)
        assert act.dtype == jact.dtype == np.int32

    def test_schedule_properties(self):
        from ray_tpu_torch.parallel.pipeline import one_f1b_schedule

        for s, m in [(2, 4), (4, 8), (3, 7)]:
            act, _ = one_f1b_schedule(s, m)
            assert act.shape[0] == 2 * (m + s - 1)
            for stage in range(s):
                live = peak = 0
                for t in range(act.shape[0]):
                    live += {1: 1, 2: -1}.get(int(act[t, stage]), 0)
                    peak = max(peak, live)
                assert peak <= s - stage

    @pytest.mark.parametrize("s,m", [(2, 4), (4, 8)])
    def test_grads_match_single_device_and_jax(self, s, m):
        d = 16
        params = {"w": _rand(20 + s, s, d, d, scale=0.5),
                  "b": _rand(21 + s, s, d, scale=0.1)}
        x, y = _rand(22, m * 4, d), _rand(23, m * 4, d)

        def stage(p, a):
            return jnp.tanh(a @ p["w"] + p["b"])

        jp = jax.tree.map(jnp.asarray, params)
        jloss, jgrads = j_1f1b(_mesh(s, "pp"), stage,
                               lambda o, t: jnp.mean((o - t) ** 2), m)(
            jp, jnp.asarray(x), jnp.asarray(y))
        sloss, sgrads = jax.value_and_grad(_seq_loss(stage, s))(
            jp, jnp.asarray(x), jnp.asarray(y))
        loss, grads = run(s, ranks.f1b_train, params, x, y, m)
        # test_parallel.py's bands against the sequential model.
        np.testing.assert_allclose(loss, float(sloss), rtol=1e-5)
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
        for key in ("w", "b"):
            np.testing.assert_allclose(grads[key], np.asarray(sgrads[key]),
                                       rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(grads[key],
                                       np.asarray(jax.device_get(
                                           jgrads[key])),
                                       rtol=1e-4, atol=1e-6)


    def test_lower_peak_memory_than_gpipe(self):
        # test_parallel.py reads XLA's temp allocation of the compiled
        # step; torch has none, so this counts the bytes autograd holds
        # saved for backward at once (1F1B's stash of S stage inputs is
        # a list, not among them): GPipe keeps every microbatch's
        # activations until its backward, 1F1B one stage's at a time.
        s, m, d = 4, 8, 256
        one_f1b = pool(s).run(ranks.pipeline_peak_saved, m, d, 32, "1f1b")
        gpipe = pool(s).run(ranks.pipeline_peak_saved, m, d, 32, "gpipe")
        # Every stage, the largest on each side (the last stage also keeps
        # its loss's inputs).
        assert max(one_f1b) < max(gpipe), (one_f1b, gpipe)


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------
def _moe_weights(d=8, f=16, e=4):
    return (_rand(30, d, e), _rand(31, e, d, f, scale=0.1),
            _rand(32, e, f, d, scale=0.1))


class TestMoE:
    def test_token_shard_invariance(self):
        # With ample capacity, splitting the tokens must not change the
        # routing (slot-collision regression test).
        import torch
        from ray_tpu_torch.parallel.moe import moe_layer

        gw, w1, w2 = map(torch.from_numpy, _moe_weights())
        x = torch.from_numpy(_rand(33, 32, 8))
        y, _ = moe_layer(x, gw, w1, w2, capacity_factor=8.0)
        y0, _ = moe_layer(x[:16], gw, w1, w2, capacity_factor=8.0)
        y1, _ = moe_layer(x[16:], gw, w1, w2, capacity_factor=8.0)
        np.testing.assert_allclose(torch.cat([y0, y1]).numpy(), y.numpy(),
                                   atol=1e-5)

    @pytest.mark.parametrize("cf", [8.0, 1.0])
    def test_expert_parallel_matches_jax_and_local(self, cf):
        import torch
        from ray_tpu_torch.parallel.moe import moe_layer

        gw, w1, w2 = _moe_weights()
        x = _rand(34, 32, 8)
        w = _rand(35, 32, 8)
        fn = jax.jit(j_shard_map(
            functools.partial(j_moe_layer, capacity_factor=cf,
                              axis_name="ep"),
            mesh=_mesh(2, "ep"), in_specs=(JP("ep"), JP(), JP("ep"),
                                           JP("ep")),
            out_specs=(JP("ep"), JP())))
        args = tuple(map(jnp.asarray, (x, gw, w1, w2)))
        jy, jaux = fn(*args)

        def jloss(*a):
            y, aux = fn(*a)
            return jnp.sum(y * w) + aux
        jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(*args)
        y, aux, grads = run(2, ranks.moe_ep, x, gw, w1, w2, cf, w)
        # The same f32 einsums and all_to_alls on both sides.
        _close(y, jy, 1e-5)
        assert abs(aux - float(jaux)) <= 1e-6
        for ours, theirs in zip(grads, jgrads):
            _close(ours, theirs, 1e-5)
        if cf == 8.0:
            # test_parallel.py's band against the local layer: with
            # ample capacity no token is dropped in either.
            y_local, _ = moe_layer(*map(torch.from_numpy, (x, gw, w1, w2)),
                                   capacity_factor=cf)
            np.testing.assert_allclose(y, y_local.numpy(), rtol=1e-3,
                                       atol=1e-4)

    def test_capacity_drops(self):
        import torch
        from ray_tpu_torch.parallel.moe import moe_layer

        gw, w1, w2 = map(torch.from_numpy, _moe_weights())
        x = torch.from_numpy(_rand(36, 64, 8))
        y, aux = moe_layer(x, gw, w1, w2, capacity_factor=0.05)
        assert torch.isfinite(y).all() and np.isfinite(float(aux))
        # capacity 1 per expert: at most 4 experts x 1 slot of 64 tokens
        # get an output.
        assert int((y.abs().sum(-1) > 0).sum()) <= 8

    def test_gating_slot_uniqueness(self):
        import torch
        from ray_tpu_torch.parallel.moe import top2_gating

        dispatch, _, _ = top2_gating(torch.from_numpy(_rand(37, 16, 4)),
                                     capacity=16)
        assert int(dispatch.sum(0).max()) <= 1

    def test_moe_model_with_ep_axis_matches_jax(self):
        fields = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                      n_experts=4, d_ff=48, max_seq_len=16)
        jcfg = jmoe.MoEConfig(dtype=jnp.float32, ep_axis="ep", **fields)
        jparams = jmoe.moe_init(jax.random.PRNGKey(5), jcfg)
        toks = np.random.default_rng(38).integers(0, 64, (4, 17))
        tokens, targets = toks[:, :-1], toks[:, 1:]
        layer = {"ln1": JP(), "wqkv": JP(), "wo": JP(), "ln2": JP(),
                 "gate": JP(), "expert_w1": JP("ep"),
                 "expert_w2": JP("ep")}
        spec = {"embed": JP(), "lnf": JP(), "layers": [layer] * 2}
        fn = jax.jit(j_shard_map(
            lambda p, a, b: jmoe.moe_loss(p, (a, b), jcfg)[None],
            mesh=_mesh(2, "ep"), in_specs=(spec, JP("ep"), JP("ep")),
            out_specs=JP("ep")))
        jlosses = fn(jparams, jnp.asarray(tokens), jnp.asarray(targets))
        jgrads = jax.jit(jax.grad(lambda p: jnp.mean(fn(
            p, jnp.asarray(tokens), jnp.asarray(targets)))))(jparams)
        losses, grads = run(2, ranks.moe_model_ep, fields,
                            jax.tree.map(np.asarray, jparams), tokens,
                            targets)
        # Two f32 decoder layers with the expert exchange: the bands of
        # test_torch_models.py's MoE cases.
        np.testing.assert_allclose(losses, np.asarray(jlosses), rtol=1e-5)
        errs = _param_errs(grads, jax.tree.map(np.asarray, jgrads))
        assert len(errs) == 2 + 7 * 2
        assert max(errs) <= 2e-5, errs


# ---------------------------------------------------------------------------
# FSDP and multi-slice (8 ranks)
# ---------------------------------------------------------------------------
class TestFSDP:
    def test_fsdp_params_sharded_and_loss_matches_dp_and_jax(self):
        batches = _gpt_batches(512, n=1)
        jmesh = j_make_mesh(JMeshConfig(dp=2, fsdp=4),
                            devices=jax.devices()[:8])
        fields, start, jlosses, jparams, jgrads = _j_gpt(
            jmesh, j_fsdp_rules(), False, batches)
        dmesh = j_make_mesh(JMeshConfig(dp=8), devices=jax.devices()[:8])
        dlosses = _j_gpt(dmesh, j_tp_rules(), False, batches)[2]
        fields = dict(fields, remat=False)
        got = run(8, ranks.gpt_steps, fields, start, batches,
                  {"dp": 2, "fsdp": 4}, "fsdp")
        # Each rank holds a quarter of every embed-axis weight, and so do
        # its AdamW moments (they mirror the blocks).
        assert got["blocks"]["w1"] == [64 // 4, 128]
        assert got["blocks"]["embed"] == [512, 64 // 4]
        assert got["moments"] == got["leaves"]
        # test_parallel.py's band between fsdp and dp (f32 sums in another
        # order), then the port's fsdp against JAX's fsdp.
        np.testing.assert_allclose(got["losses"], dlosses, rtol=1e-3)
        _losses_close(got["losses"], jlosses, LOSS_RTOL)
        assert max(_param_errs(got["grads"], jgrads)) <= GRAD_TOL
        assert max(_param_errs(got["params"], jparams)) <= PARAM_TOL


    def test_fsdp_grad_flow_uses_reduce_scatter(self):
        # The ZeRO traffic shape: the params gathered for use, the whole
        # gradients reduce-scattered to blocks, and only the blocks (and
        # the loss) all-reduced over dp: no rank all-reduces a whole
        # gradient.
        fields = {"vocab_size": 512, "d_model": 64, "n_heads": 4,
                  "n_layers": 2, "d_ff": 128, "max_seq_len": 128,
                  "remat": False}
        traffic, params_bytes = pool(8).run(
            ranks.step_traffic, fields, {"dp": 2, "fsdp": 4}, "fsdp", 8, 32,
            1)[0]
        assert set(traffic) == {"all_gather", "reduce_scatter",
                                "all_reduce"}
        assert traffic["all_gather"]["bytes"] == params_bytes // 4
        assert traffic["reduce_scatter"]["bytes"] == params_bytes
        assert traffic["all_reduce"]["bytes"] == params_bytes // 4 + 4


class TestMultiSlice:
    def test_multislice_step_matches_single_mesh_and_jax(self):
        batches = _gpt_batches(512, n=1)
        ms = j_make_multislice_mesh(JMeshConfig(dp=2, tp=2),
                                    devices=jax.devices()[:8], num_slices=2)
        fields, start, jlosses, jparams, jgrads = _j_gpt(
            ms, j_dcn_rules(), False, batches, axis=("dp_dcn", "dp"))
        flat = j_make_mesh(JMeshConfig(dp=4, tp=2),
                           devices=jax.devices()[:8])
        flosses = _j_gpt(flat, j_tp_rules(), False, batches)[2]
        fields = dict(fields, remat=False)
        got = run(8, ranks.gpt_steps, fields, start, batches,
                  {"dp": 2, "tp": 2}, "dcn", 2)
        np.testing.assert_allclose(got["losses"], flosses, rtol=1e-5)
        _losses_close(got["losses"], jlosses, LOSS_RTOL)
        assert max(_param_errs(got["grads"], jgrads)) <= GRAD_TOL
        assert max(_param_errs(got["params"], jparams)) <= PARAM_TOL

    def test_slice_count_and_info(self):
        for rank, (info, count, two) in enumerate(
                pool(2).run(ranks.slice_info)):
            assert count == 1 and two == 2
            assert info == {"process_index": rank, "process_count": 2,
                            "local_devices": 1, "global_devices": 2,
                            "platform": "cpu"}

    def test_multislice_mesh_needs_slices(self):
        msg = run(2, ranks.multislice_mesh_raises)
        assert msg is not None and "num_slices" in msg


# ---------------------------------------------------------------------------
# the dry run (8 ranks)
# ---------------------------------------------------------------------------
class TestDryrun:
    def test_dryrun_multichip_8_on_cpu(self):
        from ray_tpu_torch.parallel.dryrun import dryrun_multichip

        close_pools()  # it starts its own 8 ranks
        report = dryrun_multichip(8, device="cpu", timeout=TIMEOUT)
        assert report["gpt"]["mesh"] == {"dp": 4, "tp": 2}
        assert np.isfinite(report["gpt"]["loss"])
        assert report["gpt"]["wqkv_block"] == [64, 96]
        assert report["ring"]["shape"] == [2, 4, 64, 16]
        assert report["moe"] == {"shape": [128, 32], "experts": 16}
        assert report["pipeline"]["stages"] == 4
        assert np.isfinite(report["pipeline"]["loss"])

    def test_rank_pool_without_a_card_raises(self):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a CUDA card is visible")
        # device=None is the card, as for every entry point of the port.
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RankPool(2)

    def test_dryrun_without_a_card_raises(self):
        import torch
        from ray_tpu_torch.parallel.dryrun import dryrun_multichip

        if torch.cuda.is_available():
            pytest.skip("a CUDA card is visible")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun_multichip(2)
