"""The port's Llama, ViT, MoE and ResNet families held against the JAX
package.

Each family's params are drawn once by ``ray_tpu`` with ``jax.random``
and carried over with ``from_jax_params``; inputs come from numpy with a
fixed seed. Everything runs on the CPU, where the port's attention and
its gradient are autograd through the plain version; ``chip_smoke.py``
holds the CUDA kernels (K1, K2, K3) against those plain versions on the
card. Each test states its tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.models import moe as jmoe
from ray_tpu.models import resnet as jresnet
from ray_tpu.models import vit as jvit
from ray_tpu.ops.attention import _kernel_ok as j_kernel_ok
from ray_tpu.parallel import moe as jpmoe
from ray_tpu_torch.models import from_jax_params
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models import resnet as tresnet
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.parallel import moe as tpmoe

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    # The shapes here are tiny: two threads lose nothing, and spare the
    # cores that the suite's other test workers share.
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _configs(jcls, tcls, dtype="float32", preset="tiny", **fields):
    jdt, tdt = _DTYPES[dtype]
    return (dataclasses.replace(getattr(jcls, preset)(), dtype=jdt,
                                **fields),
            dataclasses.replace(getattr(tcls, preset)(), dtype=tdt,
                                **fields))


def _to_torch(jparams):
    return from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")


def _err(out, ref) -> float:
    """max |port - jax| / max |jax|, in f32."""
    ref = np.asarray(ref).astype(np.float32)
    out = out.detach().float().numpy() if torch.is_tensor(out) \
        else np.asarray(out, np.float32)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def _norm_errs(tree_t, tree_j):
    """Per leaf: _err of the port's leaf against the JAX one."""
    return jax.tree.leaves(jax.tree.map(_err, tree_t, tree_j))


def _with_grads(tp):
    for leaf in jax.tree.leaves(tp):
        leaf.requires_grad_(True)
    return tp


def _tokens(seed, b, s, vocab):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return toks[:, :-1], toks[:, 1:]


def _images(seed, b, size, channels=3):
    return np.random.default_rng(seed).standard_normal(
        (b, size, size, channels)).astype(np.float32)


def _jt(batch):
    """A numpy batch as (jax arrays, torch tensors)."""
    return (tuple(jnp.asarray(x) for x in batch),
            tuple(torch.from_numpy(x) for x in batch))


# ---------------------------------------------------------------------------
# Llama
# ---------------------------------------------------------------------------
class TestLlama:
    def _setup(self, dtype="float32", seed=0, **fields):
        jcfg, tcfg = _configs(jllama.LlamaConfig, tllama.LlamaConfig,
                              dtype, **fields)
        jp = jllama.llama_init(jax.random.PRNGKey(seed), jcfg)
        return jcfg, tcfg, jp, _to_torch(jp)

    @pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                           ("bfloat16", 2e-2)])
    def test_logits_match_jax(self, dtype, tol):
        jcfg, tcfg, jp, tp = self._setup(dtype)
        toks, _ = _tokens(0, 2, 16, jcfg.vocab_size)
        ref = jllama.llama_forward(jp, jnp.asarray(toks), jcfg)
        out = tllama.llama_forward(tp, torch.from_numpy(toks), tcfg)
        assert out.dtype == torch.float32 and out.shape == ref.shape
        # f32: the same math; bf16: both round every matmul output to
        # bf16, at slightly other points.
        assert _err(out, ref) <= tol

    def test_gqa_repeats_each_kv_head_in_a_row(self, monkeypatch):
        """n_kv_heads=2, group_size=2, with distinct kv heads: the port
        agrees with jnp.repeat(axis=1), and a tile of the kv heads (what
        ``Tensor.repeat`` would give) does not."""
        jcfg, tcfg, jp, tp = self._setup(seed=3)
        assert (tcfg.n_kv_heads, tcfg.group_size) == (2, 2)
        wkv = np.asarray(jp["layers"][0]["wkv"])
        hd = jcfg.head_dim
        assert np.abs(wkv[:, :hd] - wkv[:, hd:2 * hd]).max() > 0.1
        toks, _ = _tokens(3, 2, 16, jcfg.vocab_size)
        ref = jllama.llama_forward(jp, jnp.asarray(toks), jcfg)
        out = tllama.llama_forward(tp, torch.from_numpy(toks), tcfg)
        assert _err(out, ref) <= 1e-4

        def tile(self, repeats, dim):
            return self.repeat(*[repeats if i == dim else 1
                                 for i in range(self.dim())])

        monkeypatch.setattr(torch.Tensor, "repeat_interleave", tile)
        tiled = tllama.llama_forward(tp, torch.from_numpy(toks), tcfg)
        assert _err(tiled, ref) > 1e-2

    @pytest.mark.parametrize("remat", [True, False])
    def test_loss_and_grads_match_jax(self, remat):
        jcfg, tcfg, jp, tp = self._setup(seed=1, remat=remat)
        _with_grads(tp)
        jb, tb = _jt(_tokens(1, 2, 16, jcfg.vocab_size))
        ref, grads = jax.value_and_grad(jllama.llama_loss)(jp, jb, jcfg)
        loss = tllama.llama_loss(tp, tb, tcfg)
        loss.backward()
        # f32 on both sides, rows summed in another order.
        assert loss.dim() == 0
        assert abs(float(loss.detach()) - float(ref)) <= \
            1e-5 * abs(float(ref))
        errs = _norm_errs(jax.tree.map(lambda t: t.grad, tp), grads)
        assert len(errs) == 3 + 8 * jcfg.n_layers  # untied head
        assert max(errs) <= 2e-5, errs

    def test_remat_recomputes_blocks(self, monkeypatch):
        _, tcfg, _, tp = self._setup(seed=2, remat=True)
        _with_grads(tp)
        calls = []
        block = tllama._block
        monkeypatch.setattr(tllama, "_block",
                            lambda *a: calls.append(1) or block(*a))
        _, tb = _jt(_tokens(2, 1, 8, tcfg.vocab_size))
        loss = tllama.llama_loss(tp, tb, tcfg)
        assert len(calls) == tcfg.n_layers
        loss.backward()
        assert len(calls) == 2 * tcfg.n_layers

    def test_presets(self):
        for name in ("tiny", "tpu_bench"):
            j, t = getattr(jllama.LlamaConfig, name)(), \
                getattr(tllama.LlamaConfig, name)()
            fields = [f.name for f in dataclasses.fields(t)
                      if f.name != "dtype"]
            assert [getattr(t, f) for f in fields] == \
                [getattr(j, f) for f in fields]
        assert tllama.LlamaConfig.tpu_bench().remat is False
        assert tllama.LlamaConfig().remat is True
        with pytest.raises(ValueError):
            tllama.LlamaConfig(n_heads=8, n_kv_heads=3)

    def _step_case(self, seq, seed):
        jcfg, tcfg = _configs(jllama.LlamaConfig, tllama.LlamaConfig)
        j_init_state, j_step = jllama.make_llama_train_step(jcfg,
                                                            donate=False)
        jstate = j_init_state(jax.random.PRNGKey(seed))
        init_state, train_step = tllama.make_llama_train_step(tcfg,
                                                               device="cpu")
        state = init_state(params=_to_torch(jstate["params"]))
        jb, tb = _jt(_tokens(seed, 2, seq, jcfg.vocab_size))
        jstate, jm = j_step(jstate, jb)
        state, m = train_step(state, tb)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            1e-5 * abs(float(jm["loss"]))
        assert state["step"] == int(jstate["step"]) == 1
        # f32: the same AdamW arithmetic on gradients equal to rounding.
        errs = _norm_errs(state["params"], jstate["params"])
        assert max(errs) <= 2e-5, errs

    def test_train_step_matches_jax(self):
        self._step_case(16, 4)

    def test_step_matches_jax_pallas_interpret(self, monkeypatch):
        """At S=128 the JAX step runs its real Pallas forward and backward
        kernels (interpret mode), head_dim 16 with GQA; the port's CPU step
        runs the plain versions."""
        monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")
        assert j_kernel_ok(128)
        self._step_case(128, 5)


# ---------------------------------------------------------------------------
# ViT
# ---------------------------------------------------------------------------
class TestViT:
    def _setup(self, dtype="float32", seed=0, **fields):
        jcfg, tcfg = _configs(jvit.ViTConfig, tvit.ViTConfig, dtype,
                              **fields)
        jp = jvit.vit_init(jax.random.PRNGKey(seed), jcfg)
        return jcfg, tcfg, jp, _to_torch(jp)

    @pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                           ("bfloat16", 2e-2)])
    def test_logits_match_jax(self, dtype, tol):
        jcfg, tcfg, jp, tp = self._setup(dtype)
        assert tcfg.num_patches + 1 == 17
        images = _images(0, 3, jcfg.image_size)
        ref = jvit.vit_forward(jp, jnp.asarray(images), jcfg)
        out = tvit.vit_forward(tp, torch.from_numpy(images), tcfg)
        assert out.dtype == torch.float32 and out.shape == ref.shape
        assert _err(out, ref) <= tol

    def test_patchify_matches_jax(self):
        jcfg, tcfg = _configs(jvit.ViTConfig, tvit.ViTConfig)
        images = _images(1, 2, jcfg.image_size)
        ref = jvit._patchify(jnp.asarray(images), jcfg)
        out = tvit._patchify(torch.from_numpy(images), tcfg)
        assert np.array_equal(out.numpy(), np.asarray(ref))

    @pytest.mark.parametrize("remat", [True, False])
    def test_loss_and_grads_match_jax(self, remat):
        jcfg, tcfg, jp, tp = self._setup(seed=1, remat=remat)
        _with_grads(tp)
        labels = np.random.default_rng(1).integers(0, jcfg.num_classes, 4)
        jb, tb = _jt((_images(1, 4, jcfg.image_size), labels))
        ref, grads = jax.value_and_grad(jvit.vit_loss)(jp, jb, jcfg)
        loss = tvit.vit_loss(tp, tb, tcfg)
        loss.backward()
        # f32 on both sides; the bidirectional attention over S = 17.
        assert abs(float(loss.detach()) - float(ref)) <= \
            1e-5 * abs(float(ref))
        tgrads = jax.tree.map(lambda t: t.grad, tp)
        # cls starts at zero, and so does its gradient's scale: compare it
        # against the largest gradient, not its own.
        assert _err(tgrads["cls"], grads["cls"]) * float(
            np.abs(np.asarray(grads["cls"])).max()) <= 1e-5
        del tgrads["cls"], grads["cls"]
        errs = _norm_errs(tgrads, grads)
        assert max(errs) <= 2e-5, errs

    def test_classifier_argmax_matches_jax(self):
        jcfg, tcfg, jp, tp = self._setup(seed=2)
        images = _images(2, 16, jcfg.image_size)
        ref = jvit.make_classifier(jcfg, params=jp)(images)
        out = tvit.make_classifier(tcfg, params=tp, device="cpu")(images)
        assert isinstance(out, np.ndarray) and out.shape == (16,)
        assert np.array_equal(out, np.asarray(ref))

    def test_train_step_matches_jax(self):
        jcfg, tcfg = _configs(jvit.ViTConfig, tvit.ViTConfig)
        j_init_state, j_step = jvit.make_vit_train_step(jcfg, donate=False)
        jstate = j_init_state(jax.random.PRNGKey(3))
        init_state, train_step = tvit.make_vit_train_step(tcfg, device="cpu")
        state = init_state(params=_to_torch(jstate["params"]))
        labels = np.random.default_rng(3).integers(0, jcfg.num_classes, 4)
        jb, tb = _jt((_images(3, 4, jcfg.image_size), labels))
        jstate, jm = j_step(jstate, jb)
        state, m = train_step(state, tb)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            1e-5 * abs(float(jm["loss"]))
        # One AdamW step moves every weight by about lr = 3e-4, cls from
        # zero: compare each leaf against max(|jax|, 1).
        for t, j in zip(jax.tree.leaves(state["params"]),
                        jax.tree.leaves(jstate["params"])):
            j = np.asarray(j, np.float32)
            gap = np.abs(t.detach().numpy() - j).max()
            assert gap <= 2e-5 * max(np.abs(j).max(), 1.0)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def _gating_cases():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((32, 4)).astype(np.float32)
    tied = rng.standard_normal((24, 4)).astype(np.float32)
    tied[:8] = 0.5                      # all four experts tied
    tied[8:16, 2] = tied[8:16, 0] = 3.0  # first and third tied on top
    tied[16:, 1] = tied[16:, 3] = -2.0   # a tie below the top choice
    tied[16:, 0] = 4.0
    return [
        pytest.param(logits, 64, id="no-drop"),      # 2*32/4 = 16 a queue
        pytest.param(logits, 5, id="capacity-drops"),
        pytest.param(tied, 40, id="tied-logits"),
        pytest.param(tied, 4, id="tied-logits-drops"),
    ]


class TestMoE:
    @pytest.mark.parametrize("logits,capacity", _gating_cases())
    def test_top2_gating_matches_jax(self, logits, capacity):
        jd, jc, jaux = jpmoe.top2_gating(jnp.asarray(logits), capacity)
        td, tc, taux = tpmoe.top2_gating(torch.from_numpy(logits), capacity)
        assert td.dtype == torch.bool and tc.dtype == torch.float32
        # Routing is exact: the same argmax (ties to the first expert),
        # the same queue positions and drops.
        assert np.array_equal(td.numpy(), np.asarray(jd))
        # f32 softmax and gate weights: within a few ulps.
        assert np.abs(tc.numpy() - np.asarray(jc)).max() <= 1e-6
        assert abs(float(taux) - float(jaux)) <= 1e-6
        if capacity < 8:
            # this case must drop a route
            assert int(td.sum()) < 2 * logits.shape[0]

    def test_moe_layer_matches_jax(self):
        rng = np.random.default_rng(8)
        t, d, f, e = 40, 16, 24, 4
        args = [rng.standard_normal(shape).astype(np.float32) * scale
                for shape, scale in (((t, d), 1.0), ((d, e), d ** -0.5),
                                     ((e, d, f), d ** -0.5),
                                     ((e, f, d), f ** -0.5))]
        jy, jaux = jpmoe.moe_layer(*map(jnp.asarray, args),
                                   capacity_factor=1.0)
        ty, taux = tpmoe.moe_layer(*map(torch.from_numpy, args),
                                   capacity_factor=1.0)
        # f32 einsums summed in another order.
        assert _err(ty, jy) <= 1e-5
        assert abs(float(taux) - float(jaux)) <= 1e-6

    def _setup(self, seed=0, **fields):
        jcfg, tcfg = _configs(jmoe.MoEConfig, tmoe.MoEConfig, **fields)
        jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
        return jcfg, tcfg, jp, _to_torch(jp)

    def test_forward_matches_jax(self):
        jcfg, tcfg, jp, tp = self._setup()
        toks, _ = _tokens(0, 2, 16, jcfg.vocab_size)
        jlogits, jaux = jmoe.moe_forward(jp, jnp.asarray(toks), jcfg)
        logits, aux = tmoe.moe_forward(tp, torch.from_numpy(toks), tcfg)
        assert logits.dtype == torch.float32
        assert _err(logits, jlogits) <= 1e-4
        assert abs(float(aux) - float(jaux)) <= 1e-6

    @pytest.mark.parametrize("remat", [True, False])
    def test_loss_and_grads_match_jax(self, remat):
        jcfg, tcfg, jp, tp = self._setup(seed=1, remat=remat)
        _with_grads(tp)
        jb, tb = _jt(_tokens(1, 2, 16, jcfg.vocab_size))
        ref, grads = jax.value_and_grad(jmoe.moe_loss)(jp, jb, jcfg)
        loss = tmoe.moe_loss(tp, tb, tcfg)
        loss.backward()
        assert abs(float(loss.detach()) - float(ref)) <= \
            1e-5 * abs(float(ref))
        errs = _norm_errs(jax.tree.map(lambda t: t.grad, tp), grads)
        assert len(errs) == 2 + 7 * jcfg.n_layers  # tied head
        assert max(errs) <= 2e-5, errs

    def test_train_step_matches_jax(self):
        jcfg, tcfg = _configs(jmoe.MoEConfig, tmoe.MoEConfig)
        j_init_state, j_step = jmoe.make_moe_train_step(jcfg, donate=False)
        jstate = j_init_state(jax.random.PRNGKey(4))
        init_state, train_step = tmoe.make_moe_train_step(tcfg, device="cpu")
        state = init_state(params=_to_torch(jstate["params"]))
        jb, tb = _jt(_tokens(4, 2, 16, jcfg.vocab_size))
        jstate, jm = j_step(jstate, jb)
        state, m = train_step(state, tb)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            1e-5 * abs(float(jm["loss"]))
        errs = _norm_errs(state["params"], jstate["params"])
        assert max(errs) <= 2e-5, errs

    def test_expert_parallel_raises(self):
        x, gate = torch.zeros(8, 4), torch.zeros(4, 2)
        w1, w2 = torch.zeros(2, 4, 6), torch.zeros(2, 6, 4)
        with pytest.raises(NotImplementedError, match="expert-parallel"):
            tpmoe.moe_layer(x, gate, w1, w2, axis_name="ep")
        with pytest.raises(NotImplementedError, match="expert"):
            tmoe.MoEConfig(ep_axis="ep")


# ---------------------------------------------------------------------------
# ResNet
# ---------------------------------------------------------------------------
_RESNETS = {"tiny": {},
            "bottleneck": {"stage_sizes": (1, 1), "bottleneck": True,
                           "width": 8}}


class TestResNet:
    def _setup(self, variant, seed=0):
        jcfg, tcfg = _configs(jresnet.ResNetConfig, tresnet.ResNetConfig,
                              **_RESNETS[variant])
        jp = jresnet.resnet_init(jax.random.PRNGKey(seed), jcfg)
        return jcfg, tcfg, jp, _to_torch(jp)

    @pytest.mark.parametrize("size", [32, 33])
    @pytest.mark.parametrize("variant", sorted(_RESNETS))
    def test_logits_match_jax(self, variant, size):
        """An even and an odd size: "SAME" at stride 2 pads (0, 1) on an
        even size and (1, 1) on an odd one; the stem (2, 3) and (3, 3)."""
        jcfg, tcfg, jp, tp = self._setup(variant)
        images = _images(size, 2, size)
        ref = jresnet.resnet_forward(jp, jnp.asarray(images), jcfg)
        out = tresnet.resnet_forward(tp, torch.from_numpy(images), tcfg)
        assert out.dtype == torch.float32 and out.shape == ref.shape
        # f32 convolutions summed in another order.
        assert _err(out, ref) <= 1e-4

    def test_same_pads(self):
        x = torch.zeros(1, 1, 224, 224)
        assert tresnet._same_pads(x, 7, 2) == (2, 3, 2, 3)
        assert tresnet._same_pads(x, 3, 2) == (0, 1, 0, 1)
        assert tresnet._same_pads(x, 1, 2) == (0, 0, 0, 0)
        assert tresnet._same_pads(x, 3, 1) == (1, 1, 1, 1)
        assert tresnet._same_pads(torch.zeros(1, 1, 33, 32), 3, 2) == \
            (0, 1, 1, 1)

    def test_predictor_argmax_matches_jax(self):
        jcfg, tcfg, jp, tp = self._setup("tiny", seed=1)
        images = _images(9, 16, 32)
        ref = jresnet.make_predictor(jcfg, params=jp)(images)
        out = tresnet.make_predictor(tcfg, params=tp, device="cpu")(images)
        assert torch.is_tensor(out) and out.shape == (16,)
        assert np.array_equal(out.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# Weights and devices
# ---------------------------------------------------------------------------
class TestConvertDtype:
    """``from_jax_params(dtype=)`` keeps every leaf that the JAX init
    keeps in float32 whatever the model dtype, by its key."""

    @pytest.mark.parametrize("family", ["llama", "vit", "moe", "resnet"])
    def test_float32_leaves_stay_float32(self, family):
        module, init = {
            "llama": (jllama, jllama.llama_init), "vit": (jvit, jvit.vit_init),
            "moe": (jmoe, jmoe.moe_init),
            "resnet": (jresnet, jresnet.resnet_init)}[family]
        cls = next(getattr(module, n) for n in dir(module)
                   if n.endswith("Config"))
        jp = init(jax.random.PRNGKey(0), cls.tiny())  # bf16 model dtype
        tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu",
                             dtype=torch.bfloat16)
        for (path, j), t in zip(jax.tree_util.tree_leaves_with_path(jp),
                                jax.tree.leaves(tp)):
            assert t.dtype == {jnp.dtype(jnp.float32): torch.float32,
                               jnp.dtype(jnp.bfloat16): torch.bfloat16}[
                                   j.dtype], (path, t.dtype, j.dtype)
        f32 = {"llama": ["lnf"], "vit": ["pos", "lnf"], "moe": ["lnf"],
               "resnet": []}[family]
        for key in f32:
            assert tp[key].dtype == torch.float32
        if family == "moe":
            assert tp["layers"][0]["gate"].dtype == torch.float32
            assert tp["layers"][0]["gate"].dim() == 2
        if family == "resnet":
            assert tp["head"]["b"].dtype == torch.float32
            assert tp["stem"]["bn"]["var"].dtype == torch.float32
            assert tp["stem"]["conv"].dtype == torch.bfloat16


class TestDeviceRule:
    def test_device_none_needs_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        gen = torch.Generator()
        llama, vit = tllama.LlamaConfig.tiny(), tvit.ViTConfig.tiny()
        moe, resnet = tmoe.MoEConfig.tiny(), tresnet.ResNetConfig.tiny()
        for make in (lambda: tllama.llama_init(llama, gen),
                     lambda: tllama.make_llama_train_step(llama),
                     lambda: tvit.vit_init(vit, gen),
                     lambda: tvit.make_vit_train_step(vit),
                     lambda: tvit.make_classifier(vit),
                     lambda: tmoe.moe_init(moe, gen),
                     lambda: tmoe.make_moe_train_step(moe),
                     lambda: tresnet.resnet_init(resnet, gen),
                     lambda: tresnet.make_predictor(resnet)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
