"""The port's RLlib core (``ray_tpu_torch.rllib``) held against the JAX
package's (``ray_tpu.rllib``) on the CPU, in float32.

Params are drawn once by the JAX package (flax init from a PRNGKey) and
carried over with ``rllib/core/convert.py::from_flax_params``; inputs and
batches come from numpy with fixed seeds. Nothing trains to a threshold:
the losses and updates are held on fixed batches, and the algorithms run
one iteration each. One cluster of the port serves the module.

Tolerances (float32 on both sides, the same products summed in other
orders):
- encoders and module forwards: within ``TOL_FWD`` of max|jax|;
- a loss's value within ``TOL_LOSS`` relative, each gradient leaf within
  ``TOL_GRAD`` of that leaf's max|jax grad|;
- params after 1 or 3 learner updates, against optax: within ``TOL_STEP``
  of the largest step a leaf's element can take (the sum of the lrs),
  over the elements whose first gradient is at least ``SMALL_GRAD``
  (Adam's first step is lr·g/(|g|+1e-8), so a tiny gradient's rounding
  decides its sign); the others are counted and held only to two such
  steps, and they must be the fewer.
"""

import functools
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from chip_smoke import CartPoleEnv, FramesEnv, TwoCartPoles, policy_of
from ray_tpu.rllib.algorithms import bc as jbc
from ray_tpu.rllib.algorithms import dqn as jdqn
from ray_tpu.rllib.algorithms import impala as jimpala
from ray_tpu.rllib.algorithms import ppo as jppo
from ray_tpu.rllib.core import catalog as jcat
from ray_tpu.rllib.core import rl_module as jmod
from ray_tpu.rllib.core.learner import JaxLearner
from ray_tpu_torch.rllib.algorithms import bc as tbc
from ray_tpu_torch.rllib.algorithms import dqn as tdqn
from ray_tpu_torch.rllib.algorithms import impala as timpala
from ray_tpu_torch.rllib.algorithms import ppo as tppo
from ray_tpu_torch.rllib.core import catalog as tcat
from ray_tpu_torch.rllib.core import rl_module as tmod
from ray_tpu_torch.rllib.core.convert import (from_flax_params,
                                              to_flax_params)
from ray_tpu_torch.rllib.core.learner import TorchLearner

TOL_FWD = 1e-5
TOL_LOSS = 1e-5
TOL_GRAD = 1e-4
TOL_STEP = 1e-3
SMALL_GRAD = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    # Tiny shapes: two threads lose nothing, and spare the cores that
    # the suite's other test workers share.
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=2)
    yield
    rt.shutdown()


# -- helpers ---------------------------------------------------------------
def _port(jparams):
    return from_flax_params(jax.tree.map(np.asarray, jparams), "cpu")


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _err(ours, ref) -> float:
    """max |port - jax| / max |jax|."""
    ours, ref = _np(ours).astype(np.float32), np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


def _leaf_errs(ours_flax, ref):
    """Per leaf of two flax-layout trees: _err."""
    return jax.tree.leaves(jax.tree.map(_err, ours_flax, ref))


def _obs(shape, batch, seed=0):
    return np.random.default_rng(seed).random(
        (batch,) + tuple(shape)).astype(np.float32)


# The modules, each at a small size: vector and image obs (the CNN at
# 21x21 takes flax's asymmetric SAME pads, 21 -> 11 -> 6 -> 3), custom
# filters, gelu and relu torsos, and the LSTM over an MLP and a CNN.
MODULES = {
    "ppo_mlp": ("PPOModule", 5, 3, None),
    "ppo_cnn": ("PPOModule", (21, 21, 3), 4, None),
    "dqn_mlp": ("DQNModule", 5, 3, {"fcnet_hiddens": [32, 16],
                                    "fcnet_activation": "relu"}),
    "dqn_cnn": ("DQNModule", (12, 9, 2), 3,
                {"conv_filters": [[8, 3, 2], [16, 3, 1]],
                 "post_fcnet_hiddens": [32], "conv_activation": "gelu"}),
    "sac_mlp": ("SACModule", 3, 2, None),
    "sac_cnn": ("SACModule", (10, 10, 3), 2, {"post_fcnet_hiddens": [32]}),
    "lstm_mlp": ("RecurrentPPOModule", 4, 2,
                 {"use_lstm": True, "lstm_cell_size": 16}),
    "lstm_cnn": ("RecurrentPPOModule", (9, 9, 2), 3,
                 {"use_lstm": True, "lstm_cell_size": 8,
                  "post_fcnet_hiddens": [16]}),
}


@functools.lru_cache(maxsize=None)
def _modules(kind):
    """(jax module, port module, jax params, port params) of ``kind``,
    built once for the file (the JAX init compiled as one program)."""
    name, obs, n, mc = MODULES[kind]
    jm = getattr(jmod, name)(obs, n, model_config=mc)
    tm = getattr(tmod, name)(obs, n, model_config=mc)
    jp = jax.device_get(jax.jit(lambda: jm.init_params(3))())
    return jm, tm, jp, _port(jp)


def _jit_init(module, *args):
    return jax.device_get(jax.jit(lambda: module.init(
        jax.random.PRNGKey(0), *args)["params"])())


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(np.shape(a)), tree)


# -- the catalog -----------------------------------------------------------
class TestCatalog:
    @pytest.mark.parametrize("shape", [(84, 84, 4), (64, 64, 3),
                                       (21, 21, 3), (7, 5, 2), (4, 4, 1)])
    def test_default_conv_filters(self, shape):
        assert tcat.default_conv_filters(shape) == \
            jcat.default_conv_filters(shape)

    @pytest.mark.parametrize("size,kernel,stride", [
        (84, 4, 2), (21, 4, 2), (11, 4, 2), (6, 4, 2), (9, 3, 2),
        (10, 3, 1)])
    def test_same_pads_are_flaxs(self, size, kernel, stride):
        (pads,) = jax.lax.padtype_to_pads((size,), (kernel,), (stride,),
                                          "SAME")
        got, out = tcat.same_pads(size, kernel, stride)
        assert got == tuple(pads) and out == -(-size // stride)

    @pytest.mark.parametrize("shape,config", [
        ((17,), {"fcnet_hiddens": [48, 24]}),
        ((8, 8, 3), {"post_fcnet_hiddens": [96]}),
        ((84, 84, 4), None),
        ((8, 8, 3), {"conv_filters": [], "fcnet_hiddens": [7]})])
    def test_encoder_choice_and_out_dim(self, shape, config):
        ours = tcat.Catalog.build_encoder(shape, config)
        theirs = jcat.Catalog.build_encoder(shape, config)
        assert type(ours).__name__ == type(theirs).__name__
        assert tcat.encoder_out_dim(ours, shape) == \
            jcat.encoder_out_dim(theirs, shape)

    def test_model_config_merge(self):
        for cfg in (None, {"fcnet_hiddens": [32]}, {"hidden": [8]}):
            assert tcat.merge_model_config(cfg) == \
                jcat.merge_model_config(cfg)
        assert tcat.MODEL_DEFAULTS == jcat.MODEL_DEFAULTS
        with pytest.raises(ValueError, match="conv_filers"):
            tcat.merge_model_config({"conv_filers": [[16, 4, 2]]})


def test_exports_the_ported_surface():
    import ray_tpu.rllib as jrl
    import ray_tpu_torch.rllib as trl

    # Every name of the JAX package's RLlib but its learner, which
    # TorchLearner replaces.
    later = {"JaxLearner"}
    assert set(jrl.__all__) - later <= set(trl.__all__)
    assert {"TorchLearner", "MultiAgentPPO", "RecurrentPPOModule",
            "Catalog", "ConnectorPipelineV2", "Scheduler"} <= set(trl.__all__)


class TestEncoders:
    @pytest.mark.parametrize("activation", ["tanh", "relu", "gelu", "silu",
                                            "elu"])
    def test_mlp(self, activation):
        x = _obs((2, 3), 4)  # rank 3: flattened first
        jenc = jcat.MLPEncoder((16, 8), activation)
        jp = _jit_init(jenc, jnp.asarray(x))
        tenc = tcat.MLPEncoder((2, 3), (16, 8), activation)
        out = tmod.apply_net(tenc, _port(jp), torch.from_numpy(x))
        assert _err(out, jax.jit(jenc.apply)({"params": jp}, x)) < TOL_FWD

    @pytest.mark.parametrize("shape,filters", [
        ((21, 21, 3), None),
        ((84, 84, 4), None),
        ((12, 9, 2), ((8, 3, 2), (16, 3, 1), (4, 2, 3)))])
    def test_cnn(self, shape, filters):
        filters = filters or jcat.default_conv_filters(shape)
        x = _obs(shape, 2, seed=1)
        jenc = jcat.ConvEncoder(filters=filters, post=(32,))
        jp = _jit_init(jenc, jnp.asarray(x))
        tenc = tcat.ConvEncoder(shape, filters, post=(32,))
        out = tmod.apply_net(tenc, _port(jp), torch.from_numpy(x))
        assert _err(out, jax.jit(jenc.apply)({"params": jp}, x)) < TOL_FWD

    @pytest.mark.parametrize("inner", ["mlp", "cnn"])
    def test_lstm_with_resets(self, inner):
        shape = (6,) if inner == "mlp" else (7, 7, 2)
        x = _obs((5,) + shape, 3, seed=2)
        rng = np.random.default_rng(3)
        carry = tuple(rng.standard_normal((3, 16)).astype(np.float32)
                      for _ in range(2))
        resets = np.zeros((3, 5), np.float32)
        resets[0, 2] = resets[2, 4] = resets[1, 0] = 1.0
        if inner == "mlp":
            jinner, tinner = (jcat.MLPEncoder((32,)),
                              tcat.MLPEncoder(shape, (32,)))
        else:
            filt = ((4, 3, 2),)
            jinner = jcat.ConvEncoder(filters=filt, post=(8,))
            tinner = tcat.ConvEncoder(shape, filt, post=(8,))
        jenc = jcat.LSTMEncoder(encoder=jinner, cell_size=16)
        jargs = (jnp.asarray(x), tuple(map(jnp.asarray, carry)),
                 jnp.asarray(resets))
        jp = _jit_init(jenc, *jargs)
        jfeats, (jc, jh) = jax.jit(jenc.apply)({"params": jp}, *jargs)
        tenc = tcat.LSTMEncoder(tinner, 16)
        feats, (c, h) = tmod.apply_net(
            tenc, _port(jp), torch.from_numpy(x),
            tuple(map(torch.from_numpy, carry)), torch.from_numpy(resets))
        assert max(_err(feats, jfeats), _err(c, jc), _err(h, jh)) \
            < TOL_FWD


# -- the modules -----------------------------------------------------------
class TestModules:
    @pytest.mark.parametrize("kind", list(MODULES))
    def test_init_params_mirror_the_flax_tree(self, kind):
        _, tm, _, tp = _modules(kind)
        assert _shapes(tm.init_params(0)) == _shapes(tp)

    @pytest.mark.parametrize("kind", list(MODULES))
    def test_converter_round_trips(self, kind):
        _, _, jp, tp = _modules(kind)
        back = to_flax_params(tp)
        assert jax.tree.structure(back) == jax.tree.structure(
            jax.tree.map(np.asarray, jp))
        for ours, theirs in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
            np.testing.assert_array_equal(ours, np.asarray(theirs))

    @pytest.mark.parametrize("kind", list(MODULES))
    def test_forward(self, kind):
        jm, tm, jp, tp = _modules(kind)
        name, shape, n, _ = MODULES[kind]
        shape = (shape,) if isinstance(shape, int) else shape
        if name == "RecurrentPPOModule":
            obs = _obs((6,) + shape, 3)
            rng = np.random.default_rng(4)
            carry = tuple(rng.standard_normal((3, tm.cell_size)).astype(
                np.float32) for _ in range(2))
            resets = np.zeros((3, 6), np.float32)
            resets[1, 3] = 1.0
            ours = tm.seq_forward(tp, obs, carry, resets)
            theirs = jax.jit(jm.seq_forward)(jp, obs, carry, resets)
        elif name == "SACModule":
            obs, act = _obs(shape, 4), _obs((n,), 4, seed=5) * 2 - 1
            ours = tm.apply(tp, obs) + tm.apply_q(tp, obs, act)
            theirs = tuple(jax.jit(jm.apply)(jp, obs)) + tuple(
                jax.jit(jm.apply_q)(jp, obs, act))
        else:
            obs = _obs(shape, 4)
            ours, theirs = tm.apply(tp, obs), jax.jit(jm.apply)(jp, obs)
            if name == "DQNModule":
                ours, theirs = (ours,), (theirs,)
        assert len(ours) == len(theirs)
        assert max(_err(o, t) for o, t in zip(ours, theirs)) < TOL_FWD

    @pytest.mark.parametrize("kind", ["ppo_mlp", "ppo_cnn", "dqn_mlp",
                                      "lstm_mlp"])
    def test_forward_modes(self, kind):
        # The same numpy rng gives the same actions: the port samples
        # with the JAX package's numpy code on logits within TOL_FWD.
        jm, tm, jp, tp = _modules(kind)
        shape = MODULES[kind][1]
        shape = (shape,) if isinstance(shape, int) else shape
        for m in (jm, tm):
            getattr(m, "on_episode_end", lambda: None)()
        for step in range(3):  # the recurrent carry moves on each step
            obs = _obs(shape, 5, seed=10 + step)
            np.testing.assert_array_equal(tm.forward_inference(tp, obs),
                                          jm.forward_inference(jp, obs))
            ours = tm.forward_exploration(tp, obs,
                                          np.random.default_rng(step))
            theirs = jm.forward_exploration(jp, obs,
                                            np.random.default_rng(step))
            np.testing.assert_array_equal(ours[0], theirs[0])
            assert set(ours[1]) == set(theirs[1])
            for key in ours[1]:
                assert _err(ours[1][key], theirs[1][key]) < TOL_FWD, key

    @pytest.mark.parametrize("kind", list(MODULES))
    def test_only_the_given_params_count(self, kind):
        # The net's own tensors (drawn again here) never reach a forward:
        # every one, a shared encoder's too, is replaced by the dict's.
        _, tm, _, tp = _modules(kind)
        shape = MODULES[kind][1]
        shape = (shape,) if isinstance(shape, int) else shape
        obs = _obs((2,) + shape if tm.recurrent else shape, 3)
        carry = (np.zeros((3, 16), np.float32),) * 2

        def run():
            if tm.recurrent:
                return tm.seq_forward(tp, obs, (carry[0][:, :tm.cell_size],
                                                carry[1][:, :tm.cell_size]),
                                      np.zeros((3, 2), np.float32))[0]
            return tm.apply(tp, obs)[0]

        before = run()
        tm.init_params(11)
        assert torch.equal(run(), before)

    def test_recurrent_steps_chain_into_the_sequence(self):
        _, tm, _, tp = _modules("lstm_mlp")
        obs = _obs((5, 4), 2)
        carry = tm._zero_carry(2)
        logits, values = tm.seq_forward(tp, obs, carry,
                                        np.zeros((2, 5), np.float32))
        with torch.no_grad():
            for t in range(5):
                step_logits, step_value, carry = tm._step(tp, obs[:, t],
                                                          carry)
                assert _err(step_logits, logits[:, t].detach()) < TOL_FWD
                assert _err(step_value, values[:, t].detach()) < TOL_FWD

    def test_sac_sample_action_matches_the_formula(self):
        # jax.random and torch draw different noise: given the port's
        # noise, the action and its log-prob follow the JAX package's
        # formula on the JAX actor's outputs.
        jm, tm, jp, tp = _modules("sac_mlp")
        obs = _obs((3,), 6)
        action, logp = tm.sample_action(
            tp, obs, torch.Generator().manual_seed(7))
        mean, log_std = (np.asarray(a) for a in jm.apply(jp, obs))
        eps = torch.randn(mean.shape,
                          generator=torch.Generator().manual_seed(7)).numpy()
        want = np.tanh(mean + np.exp(log_std) * eps)
        want_logp = np.sum(-0.5 * eps ** 2 - log_std - 0.5 * np.log(
            2 * np.pi) - np.log(1 - want ** 2 + 1e-6), axis=-1)
        assert _err(action, want) < TOL_FWD
        assert _err(logp, want_logp) < TOL_FWD

    def test_pickle_keeps_no_params(self):
        _, tm, _, _ = _modules("lstm_cnn")
        clone = pickle.loads(pickle.dumps(tm))
        assert (clone.obs_shape, clone.model_config, clone.hidden) == \
            (tm.obs_shape, tm.model_config, tm.hidden)
        assert len(pickle.dumps(tm)) < 2000  # the net is rebuilt there


# -- losses and gradients --------------------------------------------------
def _ff_batch(shape, n_actions, batch=16, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": _obs(shape, batch, seed),
        "actions": rng.integers(0, n_actions, batch),
        "action_logp": np.log(rng.uniform(0.1, 0.9, batch)).astype(
            np.float32),
        "advantages": rng.standard_normal(batch).astype(np.float32),
        "value_targets": rng.standard_normal(batch).astype(np.float32),
        "rewards": rng.standard_normal(batch).astype(np.float32),
        "terminateds": rng.random(batch) < 0.2,
    }


def _loss_case(case):
    """(jax loss, port loss, module kind, batch) of ``case``."""
    if case.startswith("ppo"):
        kind = "ppo_cnn" if case == "ppo_cnn" else "ppo_mlp"
        batch = _ff_batch(MODULES[kind][1] if kind == "ppo_cnn" else (5,),
                          MODULES[kind][2])
        if case == "ppo_entropy_schedule":
            batch["entropy_coeff"] = np.float32(0.05)
        return (jppo.make_ppo_loss(), tppo.make_ppo_loss(), kind, batch)
    if case == "recurrent_ppo":
        rng = np.random.default_rng(1)
        b, t = 3, 6
        batch = {k: v.reshape(b, t) for k, v in _ff_batch(
            (4,), 2, batch=b * t, seed=1).items() if k != "obs"}
        batch["obs"] = _obs((t, 4), b, seed=1)
        batch["carry_c"], batch["carry_h"] = (
            rng.standard_normal((b, 16)).astype(np.float32)
            for _ in range(2))
        batch["resets"] = np.zeros((b, t), np.float32)
        batch["resets"][0, 3] = 1.0
        batch["mask"] = np.ones((b, t), np.float32)
        batch["mask"][2, 4:] = 0.0
        return (jppo.make_recurrent_ppo_loss(),
                tppo.make_recurrent_ppo_loss(), "lstm_mlp", batch)
    if case in ("impala", "appo"):
        batch = _ff_batch((5,), 3, batch=24, seed=2)
        batch["terminateds"] = np.zeros(24, bool)
        batch["terminateds"][[7, 15]] = True
        batch["bootstrap_value"] = np.float32(0.7)
        if case == "impala":
            return (jimpala.make_impala_loss(0.95, clip_rho=0.9, clip_c=1.1),
                    timpala.make_impala_loss(0.95, clip_rho=0.9, clip_c=1.1),
                    "ppo_mlp", batch)
        cfg = jimpala.APPOConfig().training(gamma=0.95, clip_param=0.3)
        jm = jmod.PPOModule(5, 3)
        jloss = jimpala.APPO._build_learner(
            types.SimpleNamespace(config=cfg, module=jm)).loss_fn
        return (jloss, timpala.make_appo_loss(0.95, clip=0.3), "ppo_mlp",
                batch)
    if case.startswith("dqn"):
        batch = _ff_batch((5,), 3, seed=3)
        batch["next_obs"] = _obs((5,), 16, seed=4)
        batch["target_q_next"] = np.random.default_rng(5).standard_normal(
            (16, 3)).astype(np.float32)
        if case == "dqn_per":
            batch["weights"] = np.random.default_rng(6).uniform(
                0.2, 1.0, 16).astype(np.float32)
        return (jdqn.make_dqn_loss(0.9), tdqn.make_dqn_loss(0.9),
                "dqn_mlp", batch)
    beta = 1.0 if case == "marwil" else 0.0
    return (jbc.make_marwil_loss(beta), tbc.make_marwil_loss(beta),
            "ppo_mlp", _ff_batch((5,), 3, seed=7))


LOSS_CASES = ["ppo", "ppo_entropy_schedule", "ppo_cnn", "recurrent_ppo",
              "impala", "appo", "dqn", "dqn_per", "marwil", "bc"]


class TestLosses:
    @pytest.mark.parametrize("case", LOSS_CASES)
    def test_value_and_gradients(self, case):
        jloss, tloss, kind, batch = _loss_case(case)
        jm, tm, jp, tp = _modules(kind)
        (jval, jaux), jgrads = jax.jit(
            jax.value_and_grad(jloss, has_aux=True), static_argnums=1)(
            jp, jm, batch)
        learner = TorchLearner(tm, tloss, device="cpu")
        learner.set_weights(tp)
        val, aux, grads = learner.compute_gradients(batch)
        assert abs(val.item() - float(jval)) <= TOL_LOSS * max(
            abs(float(jval)), 1e-6)
        assert set(aux) == set(jaux)
        for key in aux:
            assert _err(aux[key], jaux[key]) < TOL_LOSS * 10, key
        errs = _leaf_errs(to_flax_params(grads), jgrads)
        assert max(errs) < TOL_GRAD, errs

    @pytest.mark.parametrize("clip_rho,clip_c", [(1.0, 1.0), (0.5, 2.0),
                                                 (3.0, 0.3)])
    def test_vtrace(self, clip_rho, clip_c):
        rng = np.random.default_rng(int(clip_rho * 10))
        t = 40
        args = [np.log(rng.uniform(0.05, 1, t)).astype(np.float32),
                np.log(rng.uniform(0.05, 1, t)).astype(np.float32),
                rng.standard_normal(t).astype(np.float32),
                rng.standard_normal(t).astype(np.float32)]
        term = np.zeros(t, bool)
        term[[5, 6, 30]] = True
        jvs, jadv = jimpala.vtrace(*map(jnp.asarray, args), 0.4,
                                   jnp.asarray(term), 0.97, clip_rho, clip_c)
        vs, adv = timpala.vtrace(*map(torch.from_numpy, args), 0.4,
                                 torch.from_numpy(term), 0.97, clip_rho,
                                 clip_c)
        assert max(_err(vs, jvs), _err(adv, jadv)) < TOL_FWD


# -- GAE and sequence chunks (numpy in both packages) ----------------------
def _fragment(n, seed, truncate_at=()):
    rng = np.random.default_rng(seed)
    term = rng.random(n) < 0.1
    trunc = np.zeros(n, bool)
    trunc[list(truncate_at)] = True
    return {"rewards": rng.standard_normal(n).astype(np.float32),
            "vf_preds": rng.standard_normal(n).astype(np.float32),
            "terminateds": term, "truncateds": trunc,
            "obs": rng.random((n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n),
            "action_logp": rng.standard_normal(n).astype(np.float32),
            "state_in_c": rng.random((n, 8)).astype(np.float32),
            "state_in_h": rng.random((n, 8)).astype(np.float32)}


class TestAdvantages:
    @pytest.mark.parametrize("truncate_at", [(), (9, 30)])
    def test_compute_gae(self, truncate_at):
        frag = _fragment(50, 1, truncate_at)
        nv = np.random.default_rng(2).standard_normal(50).astype(np.float32)
        kw = dict(bootstrap_value=0.3,
                  trunc_next_values=nv if truncate_at else None)
        ours = tppo.compute_gae(frag, 0.99, 0.9, **kw)
        theirs = jppo.compute_gae(frag, 0.99, 0.9, **kw)
        for key in ("advantages", "value_targets"):
            np.testing.assert_array_equal(ours[key], theirs[key])

    def test_chunk_fragments(self):
        frags = [jppo.compute_gae(_fragment(n, n), 0.99) for n in (23, 7)]
        ours = tppo._chunk_fragments(frags, 10)
        theirs = jppo._chunk_fragments(frags, 10)
        assert set(ours) == set(theirs)
        for key in ours:
            np.testing.assert_array_equal(ours[key], theirs[key])


# -- the learner against optax ---------------------------------------------
# (loss case, updates, lr, max_grad_norm): one step; three steps on a
# schedule; three steps with a norm bound the gradients exceed.
UPDATE_CASES = {
    "one_step": ("ppo", 1, 1e-3, 0.5),
    "lr_schedule": ("ppo", 3, [[0, 1e-3], [2, 2e-4]], 0.5),
    "clipped": ("ppo_cnn", 3, 1e-3, 0.01),
    "dqn": ("dqn", 3, 5e-4, 10.0),
}


class TestLearner:
    @pytest.mark.parametrize("case", list(UPDATE_CASES))
    def test_updates_match_optax(self, case):
        loss_case, steps, lr, max_norm = UPDATE_CASES[case]
        jloss, tloss, kind, batch = _loss_case(loss_case)
        jm, tm, jp, tp = _modules(kind)
        jl = JaxLearner(jm, jloss, lr=lr, max_grad_norm=max_norm,
                        use_mesh=False)
        jl.set_weights(jp)
        jl.opt_state = jl.tx.init(jp)
        tl = TorchLearner(tm, tloss, lr=lr, max_grad_norm=max_norm,
                          device="cpu")
        tl.set_weights(tp)
        first, _ = jax.jit(jax.grad(jloss, has_aux=True),
                           static_argnums=1)(jp, jm, batch)
        for _ in range(steps):
            theirs, ours = jl.update(batch), tl.update(batch)
            assert abs(ours["total_loss"] - theirs["total_loss"]) <= \
                TOL_LOSS * max(abs(theirs["total_loss"]), 1e-6)
        lr_sum = sum(float(np.interp(i, *zip(*lr))) if isinstance(lr, list)
                     else lr for i in range(steps))
        got = to_flax_params(tl.get_weights())
        held = small = 0
        for o, w, g in zip(jax.tree.leaves(got), jax.tree.leaves(
                jax.device_get(jl.params)), jax.tree.leaves(first)):
            keep = np.abs(np.asarray(g)) >= SMALL_GRAD
            diff = np.abs(o - np.asarray(w))
            held += int(keep.sum())
            small += int((~keep).sum())
            assert diff[keep].max(initial=0) <= TOL_STEP * lr_sum
            # Each Adam step moves an element by at most about its lr.
            assert diff[~keep].max(initial=0) <= 2 * lr_sum
        # relu torsos leave many gradients at exactly 0 (dead units);
        # most of the elements are still held to the band.
        assert held > small, (held, small)

    def test_state_round_trips(self):
        jloss, tloss, kind, batch = _loss_case("ppo")
        _, tm, _, tp = _modules(kind)
        a = TorchLearner(tm, tloss, device="cpu")
        a.set_weights(tp)
        a.update(batch)
        b = TorchLearner(tm, tloss, device="cpu", seed=9)
        b.set_state(pickle.loads(pickle.dumps(a.get_state())))
        assert a.update(batch) == pytest.approx(b.update(batch), rel=0)
        for x, y in zip(jax.tree.leaves(to_flax_params(a.params)),
                        jax.tree.leaves(to_flax_params(b.params))):
            np.testing.assert_array_equal(x, y)

    def test_weights_are_host_copies(self):
        _, tloss, kind, batch = _loss_case("ppo")
        _, tm, _, _ = _modules(kind)
        learner = TorchLearner(tm, tloss, device="cpu")
        before = learner.get_weights()
        snapshot = to_flax_params(before)
        learner.update(batch)
        # An update does not write through the weights handed out.
        for x, y in zip(jax.tree.leaves(to_flax_params(before)),
                        jax.tree.leaves(snapshot)):
            np.testing.assert_array_equal(x, y)

    def test_device_defaults_to_the_card(self):
        _, tm, _, _ = _modules("ppo_mlp")
        if torch.cuda.is_available():
            assert TorchLearner(tm, tppo.ppo_loss).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                TorchLearner(tm, tppo.ppo_loss)
            with pytest.raises(RuntimeError, match="device='cpu'"):
                tppo.PPOConfig().environment(CartPoleEnv).build()


# -- the algorithms, one iteration each, on the port's cluster -------------
def _build(config, fragment=64):
    return (config.environment(CartPoleEnv)
            .env_runners(num_env_runners=1,
                         rollout_fragment_length=fragment)
            .learners(device="cpu").debugging(seed=0).build())


def _finite_stats(stats):
    losses = [v for k, v in stats.items() if "loss" in k]
    return bool(losses) and all(np.isfinite(losses))


def _same_weights(a, b) -> None:
    for x, y in zip(jax.tree.leaves(to_flax_params(a.get_weights())),
                    jax.tree.leaves(to_flax_params(b.get_weights()))):
        np.testing.assert_array_equal(x, y)


def _off_policy(name, seed=0):
    from ray_tpu_torch.rllib import SACConfig, TD3Config

    config = {"sac": SACConfig, "td3": TD3Config}[name]()
    return (config.environment("Pendulum-v1")
            .env_runners(num_env_runners=1, rollout_fragment_length=100)
            .training(train_batch_size=32, learning_starts=100,
                      updates_per_iter=3, model={"fcnet_hiddens": [16]})
            .learners(device="cpu").debugging(seed=seed))


class TestAlgorithms:
    def test_ppo_iteration_and_synced_runners(self, cluster):
        algo = _build(tppo.PPOConfig().training(minibatch_size=32))
        try:
            result = algo.train()
            assert _finite_stats(result) and "policy_loss" in result
            assert result["num_env_steps_sampled_lifetime"] == 64
            assert {t.device.type for t in jax.tree.leaves(
                algo.learner.params)} == {"cpu"}
            # The runner samples with the weights the learner synced.
            (frag,) = algo.env_runner_group.sample(8)
            _, values = algo.module.apply(algo.get_weights(), frag["obs"])
            assert _err(frag["vf_preds"], values.detach()) < TOL_FWD
        finally:
            algo.stop()

    def test_dqn_iteration(self, cluster):
        algo = _build(tdqn.DQNConfig().training(
            learning_starts=32, train_batch_size=32,
            prioritized_replay=True, updates_per_iter=4))
        try:
            result = algo.train()
            assert _finite_stats(result) and "td_error_mean" in result
            assert len(algo.buffer) == 64
        finally:
            algo.stop()

    @pytest.mark.parametrize("which", ["recurrent_ppo", "impala", "appo",
                                       "multi_agent_ppo"])
    def test_one_iteration(self, cluster, which):
        from ray_tpu_torch.rllib import MultiAgentPPOConfig

        if which == "multi_agent_ppo":
            algo = (MultiAgentPPOConfig().environment(TwoCartPoles)
                    .env_runners(num_env_runners=1,
                                 rollout_fragment_length=64)
                    .multi_agent(policies={"p0": None, "p1": None},
                                 policy_mapping_fn=policy_of)
                    .learners(device="cpu").build())
        elif which == "recurrent_ppo":
            algo = _build(tppo.PPOConfig().training(
                model={"use_lstm": True, "lstm_cell_size": 16,
                       "max_seq_len": 8}))
        else:
            algo = _build(getattr(timpala, which.upper() + "Config")())
        try:
            result = algo.train()
            stats = result if which != "multi_agent_ppo" \
                else {**result["p0"], **result["p1"]}
            assert _finite_stats(stats) and "total_loss" in stats
        finally:
            algo.stop()

    def test_save_restore_and_offline_bc(self, cluster, tmp_path):
        from ray_tpu_torch.rllib import BCConfig, SampleWriter

        algo = _build(tppo.PPOConfig().training(minibatch_size=32))
        try:
            algo.train()
            algo.save(str(tmp_path))
            writer = SampleWriter()
            for frag in algo.env_runner_group.sample(32):
                writer.write(frag)
            other = _build(tppo.PPOConfig())
            try:
                other.restore(str(tmp_path))
                assert other.iteration == 1
                for x, y in zip(
                        jax.tree.leaves(to_flax_params(other.get_weights())),
                        jax.tree.leaves(to_flax_params(algo.get_weights()))):
                    np.testing.assert_array_equal(x, y)
                assert other.learner.opt_state["count"] == \
                    algo.learner.opt_state["count"] > 0
            finally:
                other.stop()
        finally:
            algo.stop()
        bc = (BCConfig().environment(CartPoleEnv)
              .training(offline_data=writer.to_dataset(),
                        train_batch_size=16)
              .learners(device="cpu").build())
        result = bc.train()
        assert _finite_stats(result) and result["vf_loss"] == 0.0
        assert result["num_env_steps_sampled_lifetime"] == 32

    @pytest.mark.parametrize("name", ["sac", "td3"])
    def test_off_policy_trains_and_checkpoints(self, cluster, tmp_path,
                                               name):
        # After the JAX package's test_sac_pendulum_smoke and
        # test_td3_trains_and_checkpoints.
        algo = _off_policy(name).build()
        try:
            result = algo.train()
            assert _finite_stats(result) and "q_loss" in result
            assert ("alpha" if name == "sac" else "q_mean") in result
            assert result["num_env_steps_sampled_lifetime"] == 100
            if name == "td3":
                assert algo._state["step"] == 3
            algo.save(str(tmp_path))
            other = _off_policy(name, seed=1).build()
            try:
                other.restore(str(tmp_path))
                _same_weights(other, algo)
                assert other.iteration == 1
                # The optimizer state came back too.
                key = "opt_state"
                count = (lambda st: st[key]["count"]) if name == "sac" \
                    else (lambda st: st[key]["q"]["count"])
                assert count(other._state) == count(algo._state) == 3
            finally:
                other.stop()
        finally:
            algo.stop()

    def test_cql_from_an_offline_dataset(self, cluster, tmp_path):
        # After the JAX package's TestCQL.
        from ray_tpu_torch import data
        from ray_tpu_torch.rllib import CQLConfig

        rng = np.random.default_rng(0)
        rows = []
        for i in range(128):
            obs = rng.normal(size=3).astype(np.float32)
            rows.append({
                "obs": obs,
                "actions": np.clip(rng.normal(size=1), -1, 1).astype(
                    np.float32),
                "rewards": np.float32(-np.sum(obs[:1] ** 2)),
                "terminateds": np.bool_(i % 64 == 63),
                "truncateds": np.bool_(False),
                "next_obs": (obs * 0.9).astype(np.float32)})
        config = (CQLConfig().environment("Pendulum-v1")
                  .training(train_batch_size=64,
                            offline_data=data.from_items(rows),
                            cql_alpha=1.0, model={"fcnet_hiddens": [16]})
                  .learners(device="cpu").debugging(seed=0))
        algo = config.build()
        result = algo.train()
        assert "cql_penalty" in result and np.isfinite(result["q_loss"])
        assert result["num_env_steps_sampled_lifetime"] == 128
        algo.save(str(tmp_path))
        other = config.build()
        other.restore(str(tmp_path))
        _same_weights(other, algo)
        assert other._state["opt_state"]["count"] == 2

    @pytest.mark.parametrize("env", ["cartpole", "pixels"])
    def test_dreamer_trains_and_checkpoints(self, cluster, tmp_path, env):
        # After the JAX package's TestDreamerV3 and TestDreamerV3Pixels.
        from ray_tpu_torch.rllib import DreamerV3Config

        def config(seed=0):
            c = DreamerV3Config().env_runners(num_env_runners=1)
            if env == "cartpole":
                c.environment(CartPoleEnv)
            else:
                c.environment(FramesEnv, env_config={"shape": (16, 16, 1)})
            return (c.training(learning_starts=32, seq_len=8, horizon=5,
                               updates_per_iter=2, batch_sequences=4,
                               n_deter=32, n_cat=4, n_classes=4,
                               cnn_depth=8, critic_bins=21,
                               model={"hidden": [32]})
                    .learners(device="cpu").debugging(seed=seed))

        algo = config().build()
        try:
            assert algo.module.is_image == (env == "pixels")
            result = algo.train()
            for key in ("wm_loss", "wm_recon", "wm_kl", "actor_loss",
                        "critic_loss", "imag_return"):
                assert np.isfinite(result[key]), (key, result)
            assert algo._state["step"] == 2
            algo.save(str(tmp_path))
            evaluation = algo.evaluate(num_episodes=1)
            assert np.isfinite(evaluation["evaluation_return_mean"])
            other = config(seed=1).build()
            try:
                other.restore(str(tmp_path))
                assert other.iteration == algo.iteration == 1
                _same_weights(other, algo)
            finally:
                other.stop()
        finally:
            algo.stop()
