"""The port's SAC, CQL, TD3 and DreamerV3 updates held against the JAX
package's on the CPU, in float32. No cluster is started.

Params are drawn once by the JAX package and carried over with
``rllib/core/convert.py``; batches come from numpy with fixed seeds. torch
cannot reproduce ``jax.random``'s streams, so each update's noise is
rebuilt here from the JAX update's own key, exactly as it splits and
draws it, and handed to the port's update as tensors:

- SAC: ``k1, k2, kp = split(key, 3)``, the next and the current action's
  ``normal(k1 | k2, (B, A))``; CQL: ``k_rand, k_pol = split(kp)``, its
  ``uniform(k_rand, (B, N, A), -1, 1)`` and ``normal(k_pol, (B·N, A))``;
- TD3: ``normal(key, (B, A))``;
- DreamerV3: ``k1, k2 = split(key)``; the posterior's latents at step t
  ``gumbel(split(k1, L)[t])``, the imagined action at step t
  ``gumbel(split(k2, H)[t])`` and its latents ``gumbel(fold_in(that key,
  1))``, as ``jax.random.categorical`` draws them.

The JAX losses are taken from the closures of the jitted updates
(``update.__wrapped__``), so nothing of the JAX package changes.

One update's losses, gradients and samples are held in float32, as both
packages run. The runs of several updates (and SAC's and CQL's every
check) run in float64 on both sides (``jax.enable_x64``; the port's
modules follow their params' dtype), where float32 cannot hold the
stated tolerances for a reason both packages share:
- SAC's log-Jacobian ``log(1 - a² + 1e-6)`` and tanh's backward
  ``1 - a²`` lose up to two digits at a saturated action: at a =
  0.9999888 one ulp of tanh (XLA's and torch's differ by that) moved an
  actor gradient leaf by 1.7e-2 of its max;
- after a first update the two trajectories differ by rounding, and a
  loss that is a small mean of larger terms of both signs (TD3's and
  DreamerV3's actor losses) magnifies that: 1.4e-5 and 3.6e-5 relative
  after 2 and 3 float32 updates.

Tolerances (the same products summed in other orders):
- losses and metrics within ``TOL_LOSS``, relative;
- each gradient leaf within ``TOL_GRAD`` of that leaf's max|jax grad|;
- params after 2 updates (3 for TD3) within ``TOL_STEP`` of the largest
  step an element can take (the sum of its learning rates), over the
  elements whose first gradient is at least ``SMALL_GRAD`` (Adam's first
  step is lr·g/(|g|+1e-8), so a tiny gradient's rounding decides its
  sign); the others are held to two such steps and must be the fewer;
- DreamerV3's sampled latents and imagined actions exactly equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib.algorithms import cql as jcql
from ray_tpu.rllib.algorithms import dreamerv3 as jdv3
from ray_tpu.rllib.algorithms import sac as jsac
from ray_tpu.rllib.algorithms import td3 as jtd3
from ray_tpu.rllib.core import rl_module as jmod
from ray_tpu_torch.rllib.algorithms import cql as tcql
from ray_tpu_torch.rllib.algorithms import dreamerv3 as tdv3
from ray_tpu_torch.rllib.algorithms import sac as tsac
from ray_tpu_torch.rllib.algorithms import td3 as ttd3
from ray_tpu_torch.rllib.core import learner, optim
from ray_tpu_torch.rllib.core import rl_module as tmod
from ray_tpu_torch.rllib.core.convert import (from_flax_params,
                                              to_flax_params)

TOL_FWD = 1e-5
TOL_LOSS = 1e-5
TOL_GRAD = 1e-4
TOL_STEP = 1e-3
SMALL_GRAD = 1e-6

B, OBS, ACT = 16, 3, 1
GAMMA, LR, TAU = 0.99, 1e-3, 0.05
N_CQL = 4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# -- helpers ---------------------------------------------------------------
def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _port(jparams):
    return from_flax_params(_np_tree(jparams), "cpu")


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _err(ours, ref) -> float:
    """max |port - jax| / max |jax|."""
    ours, ref = _np(ours).astype(np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


def _rel(ours, ref) -> float:
    ours, ref = float(_np(ours)), float(ref)
    return abs(ours - ref) / max(abs(ref), 1e-6)


def _grad_errs(ours, ref):
    """Per leaf of the port's grads (any layout) against a flax tree."""
    ours = to_flax_params(ours) if isinstance(ours, dict) else ours
    return jax.tree.leaves(jax.tree.map(_err, ours, _np_tree(ref)))


def _closure(jitted) -> dict:
    """The free variables of a jitted function's Python body."""
    fn = jitted.__wrapped__
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


def _check_metrics(ours, theirs):
    assert set(ours) == set(theirs), (set(ours), set(theirs))
    errs = {k: _rel(ours[k], theirs[k]) for k in ours}
    assert max(errs.values()) <= TOL_LOSS, errs


def _check_steps(ours, theirs, first_grads, lr_sum):
    """Params after some updates against the JAX package's, each element
    within TOL_STEP·lr_sum, but those whose first gradient is tiny."""
    held = small = 0
    for o, w, g in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs),
                       jax.tree.leaves(first_grads)):
        # A gradient of exactly 0 moves neither side on that step.
        g = np.asarray(g)
        keep = (np.abs(g) >= SMALL_GRAD) | (g == 0)
        diff = np.abs(np.asarray(o) - np.asarray(w))
        held += int(keep.sum())
        small += int((~keep).sum())
        assert diff[keep].max(initial=0) <= TOL_STEP * lr_sum
        assert diff[~keep].max(initial=0) <= 2 * lr_sum
    assert held > small, (held, small)


def _transitions(seed=0, batch=B, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(batch, OBS)).astype(dtype),
        "actions": rng.uniform(-1, 1, (batch, ACT)).astype(dtype),
        "rewards": rng.normal(size=(batch,)).astype(dtype),
        "terminateds": rng.random(batch) < 0.25,
        "next_obs": rng.normal(size=(batch, OBS)).astype(dtype),
    }


# -- SAC and CQL -----------------------------------------------------------
def _sac_noise(key, cql: bool):
    k1, k2, kp = jax.random.split(key, 3)
    noise = {"next": jax.random.normal(k1, (B, ACT)),
             "current": jax.random.normal(k2, (B, ACT))}
    if cql:
        k_rand, k_pol = jax.random.split(kp)
        noise["cql_random"] = jax.random.uniform(
            k_rand, (B, N_CQL, ACT), minval=-1.0, maxval=1.0)
        noise["cql_policy"] = jax.random.normal(k_pol, (B * N_CQL, ACT))
    return {k: _t(v) for k, v in noise.items()}


def _f64(tree):
    """A JAX state's floating leaves as float64 numpy (counts as they
    are)."""
    return jax.tree.map(lambda a: np.asarray(a, np.float64)
                        if np.issubdtype(np.asarray(a).dtype, np.floating)
                        else np.asarray(a), jax.device_get(tree))


@pytest.fixture
def x64():
    """JAX's 64-bit types for the test: the SAC and CQL updates run in
    float64 on both sides (the module docstring says why)."""
    with jax.enable_x64(True):
        yield


@functools.lru_cache(maxsize=None)
def _sac_pair(cql: bool):
    """(jax init, jax update, port update, jax state in float64) for SAC
    or CQL."""
    jm = jmod.SACModule(OBS, ACT, hidden=(8,))
    tm = tmod.SACModule(OBS, ACT, hidden=(8,))
    jpen = jcql.make_cql_penalty(jm, 1.0, N_CQL) if cql else None
    tpen = tcql.make_cql_penalty(tm, 1.0, N_CQL) if cql else None
    jinit, jupdate = jsac.make_sac_update(jm, GAMMA, LR, TAU, -1.0,
                                          critic_penalty_fn=jpen)
    tupdate = tsac.make_sac_update(tm, GAMMA, LR, TAU, -1.0,
                                   critic_penalty_fn=tpen, device="cpu")
    return jinit, jupdate, tupdate, _f64(jinit(3))


def _sac_jax_grads(jupdate, jstate, batch, key):
    loss_fn = _closure(jupdate)["loss_fn"]

    def wrapped(trainables):
        return loss_fn(trainables["params"], jstate["target_q"],
                       trainables["log_alpha"], batch, key)

    trainables = {"params": jstate["params"],
                  "log_alpha": jstate["log_alpha"]}
    return jax.jit(jax.value_and_grad(wrapped, has_aux=True))(trainables)


class TestSAC:
    @pytest.mark.parametrize("cql", [False, True], ids=["sac", "cql"])
    def test_loss_and_gradients(self, cql, x64):
        _, jupdate, tupdate, jstate = _sac_pair(cql)
        batch, key = _transitions(1, dtype=np.float64), jax.random.PRNGKey(5)
        (_, jmetrics), jgrads = _sac_jax_grads(jupdate, jstate, batch, key)
        state = tupdate.init_state(params=_port(jstate["params"]))
        metrics, grads = tupdate.gradients(state, _tensors(batch),
                                           _sac_noise(key, cql))
        _check_metrics(metrics, jmetrics)
        errs = _grad_errs(grads["params"], jgrads["params"])
        assert max(errs) < TOL_GRAD, errs
        assert _err(grads["log_alpha"], jgrads["log_alpha"]) < TOL_GRAD

    @pytest.mark.parametrize("cql", [False, True], ids=["sac", "cql"])
    def test_two_updates(self, cql, x64):
        _, jupdate, tupdate, jstate = _sac_pair(cql)
        batches = [_transitions(s, dtype=np.float64) for s in (2, 3)]
        keys = [jax.random.PRNGKey(s) for s in (7, 8)]
        (_, _), first = _sac_jax_grads(jupdate, jstate, batches[0], keys[0])
        state = tupdate.init_state(params=_port(jstate["params"]))
        for batch, key in zip(batches, keys):
            jstate, jmetrics = jupdate(jstate, batch, key)
            state, metrics = tupdate(state, _tensors(batch),
                                     _sac_noise(key, cql))
            _check_metrics(metrics, jmetrics)
        lr_sum = 2 * LR
        _check_steps(to_flax_params(state["params"]),
                     _np_tree(jstate["params"]), first["params"], lr_sum)
        _check_steps(to_flax_params(state["target_q"]),
                     _np_tree(jstate["target_q"]), first["params"]["q"],
                     lr_sum)
        assert abs(state["log_alpha"].item()
                   - float(jstate["log_alpha"])) <= TOL_STEP * lr_sum
        assert state["opt_state"]["count"] == 2

    def test_actor_takes_its_gradient_through_the_held_critic(self):
        # Under no_grad the actor loss would carry no gradient to the
        # actor at all: the Q call is held by detaching the critic params.
        _, _, tupdate, jstate = _sac_pair(False)
        state = tupdate.init_state(params=_port(jstate["params"]))
        batch = _tensors(_transitions(4))
        noise = _sac_noise(jax.random.PRNGKey(1), False)
        q = state["params"]["q"]
        a, _ = tupdate.module.sample_action(state["params"], batch["obs"],
                                            noise["current"])
        q1, q2 = tupdate.actor_q(state["params"], batch["obs"], a)
        loss = torch.minimum(q1, q2).sum()
        leaves = jax.tree.leaves(q) + jax.tree.leaves(
            state["params"]["actor"])
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        n_q = len(jax.tree.leaves(q))
        assert all(g is None for g in grads[:n_q])
        assert any(g is not None and g.abs().max() > 0
                   for g in grads[n_q:])

    def test_cql_repeats_rows_as_jnp_repeat(self):
        pen = tcql.make_cql_penalty(tmod.SACModule(OBS, ACT), 1.0, 3)
        obs = np.arange(8, dtype=np.float32).reshape(4, 2)
        np.testing.assert_array_equal(
            pen.repeat(torch.from_numpy(obs)).numpy(),
            np.asarray(jnp.repeat(obs, 3, axis=0)))
        # obs.repeat(n, 1) tiles the batch instead: another row order.
        assert not np.array_equal(
            torch.from_numpy(obs).repeat(3, 1).numpy(),
            np.asarray(jnp.repeat(obs, 3, axis=0)))

    def test_sample_action_takes_noise_or_a_generator(self):
        tm = tmod.SACModule(OBS, ACT, hidden=(8,))
        params = tm.init_params(0)
        obs = _transitions(5)["obs"]
        eps = torch.randn((B, ACT), generator=torch.Generator()
                          .manual_seed(9))
        by_noise = tm.sample_action(params, obs, eps)
        by_gen = tm.sample_action(params, obs,
                                  torch.Generator().manual_seed(9))
        for x, y in zip(by_noise, by_gen):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


# -- TD3 -------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _td3_pair():
    jm = jtd3.TD3Module(OBS, ACT, hidden=(8,))
    tm = ttd3.TD3Module(OBS, ACT, hidden=(8,))
    args = dict(gamma=GAMMA, lr=1e-2, tau=TAU, policy_delay=2,
                target_noise=0.2, noise_clip=0.5)
    jinit, jupdate = jtd3.make_td3_update(jm, **args)
    tupdate = ttd3.make_td3_update(tm, **args, device="cpu")
    return jupdate, tupdate, jax.device_get(jinit(4))


def _td3_noise(key):
    return {"target": _t(jax.random.normal(key, (B, ACT)))}


class TestTD3:
    def test_losses_and_gradients(self):
        jupdate, tupdate, jstate = _td3_pair()
        fns = _closure(jupdate)
        batch, key = _transitions(6), jax.random.PRNGKey(2)
        params = jstate["params"]
        jq, jq_g = jax.jit(jax.value_and_grad(fns["critic_loss_fn"]))(
            params["q"], jstate["target"], batch, key)
        ja, ja_g = jax.jit(jax.value_and_grad(fns["actor_loss_fn"]))(
            params["actor"], params["q"], batch)
        state = tupdate.init_state(params=_port(params))
        tb = _tensors(batch)
        p = state["params"]
        q_loss = tupdate.critic_loss(p["q"], state["target"], tb,
                                     _td3_noise(key))
        a_loss = tupdate.actor_loss(p["actor"], p["q"], tb)
        assert _rel(q_loss, jq) <= TOL_LOSS and _rel(a_loss, ja) <= TOL_LOSS
        q_errs = _grad_errs(learner.gradients(q_loss, p["q"]), jq_g)
        a_errs = _grad_errs(learner.gradients(a_loss, p["actor"]), ja_g)
        assert max(q_errs + a_errs) < TOL_GRAD, (q_errs, a_errs)

    def test_three_updates(self, x64):
        jupdate, tupdate, jstate = _td3_pair()
        jstate = _f64(jstate)
        fns = _closure(jupdate)
        batches = [_transitions(s, dtype=np.float64) for s in (7, 8, 9)]
        keys = [jax.random.PRNGKey(s) for s in (1, 2, 3)]
        params = jstate["params"]
        first = {"q": jax.grad(fns["critic_loss_fn"])(
            params["q"], jstate["target"], batches[0], keys[0]),
            "actor": jax.grad(fns["actor_loss_fn"])(
                params["actor"], params["q"], batches[0])}
        state = tupdate.init_state(params=_port(params))
        for batch, key in zip(batches, keys):
            jstate, jmetrics = jupdate(jstate, batch, key)
            state, metrics = tupdate(state, _tensors(batch),
                                     _td3_noise(key))
            _check_metrics(metrics, jmetrics)
        # The critics took 3 steps of lr, the actor 2 (steps 0 and 2).
        lr = tupdate.lr
        got = to_flax_params(state["params"])
        want = _np_tree(jstate["params"])
        _check_steps(got["q"], want["q"], first["q"], 3 * lr)
        _check_steps(got["actor"], want["actor"], first["actor"], 2 * lr)
        _check_steps(to_flax_params(state["target"]),
                     _np_tree(jstate["target"]), first, 3 * lr)
        assert state["step"] == int(jstate["step"]) == 3
        assert state["opt_state"]["actor"]["count"] == 2

    def test_td3_policy_delay_holds_actor(self):
        """The delayed policy update must actually FREEZE the actor (and
        its Adam state, count included) on held steps — zeroed grads
        alone would let Adam momentum keep moving it."""
        _, tupdate, _ = _td3_pair()
        state = tupdate.init_state(0)
        batch = _tensors(_transitions(0))
        gen = torch.Generator().manual_seed(0)

        def snapshot():
            return learner.clone_tree({"actor": state["params"]["actor"],
                                    "opt": state["opt_state"]["actor"],
                                    "q": state["params"]["q"]})

        tupdate(state, batch, tupdate.noise(B, gen))   # step 0: moves
        one = snapshot()
        tupdate(state, batch, tupdate.noise(B, gen))   # step 1: held
        two = snapshot()
        for a, b in zip(jax.tree.leaves(one["actor"]) + jax.tree.leaves(
                one["opt"]), jax.tree.leaves(two["actor"])
                + jax.tree.leaves(two["opt"])):
            if torch.is_tensor(a):
                assert torch.equal(a, b)
            else:
                assert a == b == 1
        # ...but the critic moved on the held step.
        assert any(not torch.equal(x, y) for x, y in zip(
            jax.tree.leaves(one["q"]), jax.tree.leaves(two["q"])))
        tupdate(state, batch, tupdate.noise(B, gen))   # step 2: moves
        assert any(not torch.equal(x, y) for x, y in zip(
            jax.tree.leaves(one["actor"]),
            jax.tree.leaves(state["params"]["actor"])))
        assert state["opt_state"]["actor"]["count"] == 2

    def test_exploration_noise_survives_pickling(self):
        import pickle

        m = ttd3.TD3Module(OBS, ACT)
        m.explore_noise = 0.37
        assert pickle.loads(pickle.dumps(m)).explore_noise == 0.37


# -- DreamerV3 -------------------------------------------------------------
DREAMER = dict(n_deter=16, n_cat=4, n_classes=4, hidden=16, n_bins=21)
SEQ, HORIZON, SEQS = 6, 4, 3
D_ACTIONS = 3
OBS_KINDS = {"vector": 5, "image": (16, 16, 1)}


@functools.lru_cache(maxsize=None)
def _dreamer_pair(kind):
    obs = OBS_KINDS[kind]
    jm = jdv3.DreamerModule(obs, D_ACTIONS, cnn_depth=4, **DREAMER)
    tm = tdv3.DreamerModule(obs, D_ACTIONS, cnn_depth=4, **DREAMER)
    jinit, jupdate = jdv3.make_dreamer_update(jm, horizon=HORIZON)
    tupdate = tdv3.make_dreamer_update(tm, horizon=HORIZON, device="cpu")
    return jm, tm, jupdate, tupdate, jax.device_get(
        jax.jit(jinit, static_argnums=0)(5))


def _sequences(kind, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    obs = OBS_KINDS[kind]
    shape = (SEQS, SEQ) + ((obs,) if isinstance(obs, int) else obs)
    first = rng.random((SEQS, SEQ)) < 0.2
    first[:, 0] = True
    return {"obs": (rng.random(shape) * 3 - 1).astype(dtype),
            "actions": rng.integers(0, D_ACTIONS, (SEQS, SEQ)),
            "rewards": rng.normal(size=(SEQS, SEQ)).astype(dtype),
            "terminateds": rng.random((SEQS, SEQ)) < 0.15,
            "is_first": first}


def _dreamer_noise(jm, key):
    k1, k2 = jax.random.split(key)
    cat = (jm.n_cat, jm.n_classes)
    n = SEQS * SEQ
    post = [jax.random.gumbel(k, (SEQS,) + cat)
            for k in jax.random.split(k1, SEQ)]
    keys = jax.random.split(k2, HORIZON)
    act = [jax.random.gumbel(k, (n, D_ACTIONS)) for k in keys]
    lat = [jax.random.gumbel(jax.random.fold_in(k, 1), (n,) + cat)
           for k in keys]
    return {"post": _t(jnp.stack(post)), "act": _t(jnp.stack(act)),
            "latent": _t(jnp.stack(lat))}


def _indices(z, module):
    z = _np(z)
    return np.argmax(z.reshape(z.shape[:-1] + (module.n_cat,
                                               module.n_classes)), -1)


def _jax_dreamer_grads(jupdate, jstate, batch, key):
    """The JAX update's world-model gradients, and its actor and critic
    gradients on its own updated world model, with what it sampled."""
    fns = _closure(jupdate)
    wm, actor, critic = fns["split"](jstate["params"])
    k1, k2 = jax.random.split(key)
    (wm_l, (hs, zs, wm_m)), wm_g = jax.jit(jax.value_and_grad(
        fns["world_model_loss"], has_aux=True))(wm, batch, k1)
    up, _ = fns["wm_opt"].update(wm_g, jstate["wm_opt"], wm)
    wm_new = optax.apply_updates(wm, up)

    def ac(p):
        return fns["ac_loss"](p["actor"], p["critic"], wm_new, hs, zs, k2,
                              jstate["ret_scale"])

    (_, ac_m), ac_g = jax.jit(jax.value_and_grad(ac, has_aux=True))(
        {"actor": actor, "critic": critic})
    return {"metrics": {"wm_loss": wm_l, **wm_m, **ac_m},
            "grads": {"wm": wm_g, **ac_g}, "hs": hs, "zs": zs,
            "wm_new": wm_new, "k2": k2}


def _ac_closure(jupdate) -> dict:
    """ac_loss's own free variables (imagine, lambda_returns)."""
    ac_loss = _closure(jupdate)["ac_loss"]
    return dict(zip(ac_loss.__code__.co_freevars,
                    (c.cell_contents for c in ac_loss.__closure__)))


class TestDreamerV3:
    @pytest.mark.parametrize("kind", list(OBS_KINDS))
    def test_init_params_mirror_the_jax_tree(self, kind):
        _, tm, _, _, jstate = _dreamer_pair(kind)
        shapes = lambda t: jax.tree.map(  # noqa: E731
            lambda a: tuple(np.shape(a)), t)
        assert shapes(_np_tree(jstate["params"])) == shapes(
            to_flax_params(tm.init_params(0)))

    def test_full_width_param_count(self):
        # The chip run's configuration: 64x64x3 frames, 6 actions, the
        # JAX package's default widths.
        jm = jdv3.DreamerModule((64, 64, 3), 6)
        tm = tdv3.DreamerModule((64, 64, 3), 6)
        jshapes = jax.eval_shape(lambda: jm.init_params(0))
        n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jshapes))
        n_port = sum(t.numel() for t in jax.tree.leaves(tm.init_params(0)))
        assert n_jax == n_port == 2_351_124
        assert tm.conv_shapes == jm.conv_shapes == [
            (64, 64, 3), (32, 32, 16), (16, 16, 32), (8, 8, 64),
            (4, 4, 128)]

    @pytest.mark.parametrize("kind", list(OBS_KINDS))
    def test_convert_round_trip(self, kind):
        _, _, _, _, jstate = _dreamer_pair(kind)
        ref = _np_tree(jstate["params"])
        back = to_flax_params(_port(ref))
        assert jax.tree.structure(back) == jax.tree.structure(ref)
        for ours, theirs in zip(jax.tree.leaves(back),
                                jax.tree.leaves(ref)):
            np.testing.assert_array_equal(ours, theirs)

    @pytest.mark.parametrize("size,c_in,c_out", [(4, 8, 3), (8, 16, 4)])
    def test_deconv_against_conv_transpose(self, size, c_in, c_out):
        rng = np.random.default_rng(size)
        x = rng.normal(size=(2, size, size, c_in)).astype(np.float32)
        p = {"w": rng.normal(size=(4, 4, c_in, c_out)).astype(np.float32),
             "b": rng.normal(size=(c_out,)).astype(np.float32)}
        want = jdv3._deconv(p, x)
        tm = tdv3.DreamerModule((16, 16, 1), 2)
        got = tm._deconv({k: _t(v) for k, v in p.items()}, _t(x))
        assert got.shape == (2, 2 * size, 2 * size, c_out)
        assert _err(got, want) < TOL_FWD

    @pytest.mark.parametrize("size", [8, 16])
    def test_conv_against_conv_general_dilated(self, size):
        rng = np.random.default_rng(size)
        x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
        p = {"w": rng.normal(size=(4, 4, 3, 5)).astype(np.float32),
             "b": rng.normal(size=(5,)).astype(np.float32)}
        got = tdv3._conv({k: _t(v) for k, v in p.items()}, _t(x))
        assert _err(got, jdv3._conv(p, x)) < TOL_FWD

    @pytest.mark.parametrize("kind", list(OBS_KINDS))
    def test_codec(self, kind):
        jm, tm, _, _, jstate = _dreamer_pair(kind)
        jp = jstate["params"]
        tp = _port(jp)
        obs = _sequences(kind, 1)["obs"]
        emb = tm.encode(tp, tdv3.symlog(_t(obs)))
        assert _err(emb, jm.encode(jp, jdv3.symlog(obs))) < TOL_FWD
        feat = np.random.default_rng(2).normal(
            size=(SEQS, SEQ, tm.n_deter + tm.n_stoch)).astype(np.float32)
        assert _err(tm.decode(tp, _t(feat)), jm.decode(jp, feat)) < TOL_FWD

    def test_twohot_against_jax(self):
        jm, tm, _, _, _ = _dreamer_pair("vector")
        bins = np.asarray(jm.bins_symlog)
        y = np.concatenate([
            np.random.default_rng(3).uniform(-25, 25, 200), bins,
            [-20.0, 20.0, -30.0, 31.0, 0.0]]).astype(np.float32)
        assert _err(tm.twohot(_t(y)), jm.twohot(y)) < TOL_FWD

    def test_twohot_roundtrip(self):
        m = tdv3.DreamerModule(4, 2, n_deter=8, n_cat=2, n_classes=2,
                               hidden=16, n_bins=41)
        for v in (-55.0, -1.0, 0.0, 0.7, 3.0, 120.0):
            th = m.twohot(tdv3.symlog(torch.tensor(v)))
            # Mass sums to 1 on exactly <=2 adjacent bins...
            np.testing.assert_allclose(float(th.sum()), 1.0, rtol=1e-5)
            assert int((th > 1e-6).sum()) <= 2
            # ...and the expected bin reproduces the (clipped) value.
            back = tdv3.symexp(th.float() @ m.bins_symlog)
            expect = float(np.clip(v, float(tdv3.symexp(torch.tensor(
                -20.0))), float(tdv3.symexp(torch.tensor(20.0)))))
            np.testing.assert_allclose(float(back), expect, rtol=1e-3,
                                       atol=1e-3)

    def test_twohot_is_the_same_with_a_left_search(self):
        # searchsorted(side="left") differs only where y IS a bin, and
        # there it puts all the mass on that bin as "right" does (frac 1
        # on the upper bin instead of frac 0 on the lower): the two-hot
        # encoding cannot tell them apart.
        m = tdv3.DreamerModule(4, 2, n_bins=21)
        y = torch.cat([m.bins_symlog, torch.linspace(-25, 25, 301)])
        right = m.twohot(y)
        m.bin_index = lambda v: torch.searchsorted(
            m.bins_symlog, v, right=False) - 1
        torch.testing.assert_close(m.twohot(y), right, rtol=0, atol=0)

    def test_lambda_returns_clamp_the_last_step(self):
        _, _, jupdate, tupdate, _ = _dreamer_pair("vector")
        lam_ret = _ac_closure(jupdate)["lambda_returns"]
        rng = np.random.default_rng(4)
        args = [rng.normal(size=(HORIZON, 7)).astype(np.float32),
                rng.uniform(0, 1, (HORIZON, 7)).astype(np.float32),
                rng.normal(size=(HORIZON, 7)).astype(np.float32)]
        got = tupdate.lambda_returns(*map(_t, args))
        assert _err(got, jax.jit(lam_ret)(*args)) < TOL_FWD
        # The last step reads values[H-1] for values[H] (JAX's clamped
        # out-of-range index), so its return bootstraps on itself.
        rew, cont, val = args
        g, lam = tupdate.gamma, tupdate.lam
        last = rew[-1] + g * cont[-1] * ((1 - lam) * val[-1] + lam * val[-1])
        np.testing.assert_allclose(_np(got[-1]), last, rtol=1e-6)

    def test_categorical_is_argmax_of_gumbel(self):
        # The noise design rests on it: jax.random.categorical draws
        # argmax(logits + gumbel(key, logits.shape)).
        key = jax.random.PRNGKey(11)
        logits = jax.random.normal(jax.random.PRNGKey(12), (64, 4, 5))
        want = jax.random.categorical(key, logits, axis=-1)
        noise = jax.random.gumbel(key, logits.shape)
        np.testing.assert_array_equal(
            np.asarray(want), np.argmax(np.asarray(logits + noise), -1))

    @pytest.mark.parametrize("kind", list(OBS_KINDS))
    def test_losses_gradients_and_samples(self, kind):
        jm, tm, jupdate, tupdate, jstate = _dreamer_pair(kind)
        batch, key = _sequences(kind, 3), jax.random.PRNGKey(9)
        ref = _jax_dreamer_grads(jupdate, jstate, batch, key)
        noise = _dreamer_noise(jm, key)
        state = tupdate.init_state(params=_port(jstate["params"]))
        tb = _tensors(batch)
        wm, _, _ = tupdate.split(state["params"])
        _, (hs, zs, _) = tupdate.world_model_loss(wm, tb, noise)
        # The posterior's sampled latents, exactly.
        np.testing.assert_array_equal(_indices(zs, tm),
                                      _indices(ref["zs"], jm))
        assert _err(hs, ref["hs"]) < TOL_FWD
        metrics, grads = tupdate.gradients(state, tb, noise)
        _check_metrics(metrics, ref["metrics"])
        for group in ("wm", "actor", "critic"):
            errs = _grad_errs(grads[group], ref["grads"][group])
            assert max(errs) < TOL_GRAD, (group, errs)
        # The imagined actions and latents, exactly.
        j_feats, j_acts, _ = _ac_closure(jupdate)["imagine"](
            ref["wm_new"], jstate["params"]["actor"], ref["hs"], ref["zs"],
            ref["k2"])
        probe = tupdate.init_state(params=_port(jstate["params"]))
        tupdate(probe, tb, noise)
        wm_new = {k: probe["params"][k] for k in tdv3.WM_KEYS}
        feats, acts, _ = tupdate.imagine(
            wm_new, state["params"]["actor"], hs, zs, noise)
        np.testing.assert_array_equal(_np(acts), np.asarray(j_acts))
        stoch = slice(tm.n_deter, None)
        np.testing.assert_array_equal(
            _indices(feats[..., stoch], tm),
            _indices(np.asarray(j_feats)[..., stoch], jm))

    @pytest.mark.parametrize("kind", list(OBS_KINDS))
    def test_two_updates(self, kind, x64):
        jm, _, jupdate, tupdate, jstate = _dreamer_pair(kind)
        jstate = _f64(jstate)
        batches = [_sequences(kind, s, np.float64) for s in (5, 6)]
        keys = [jax.random.PRNGKey(s) for s in (13, 14)]
        state = tupdate.init_state(params=_port(jstate["params"]))
        # Which elements' first Adam steps hang on their gradients' last
        # bits: the port's float64 gradients tell (held to the JAX
        # package's in float32 by test_losses_gradients_and_samples).
        _, first = tupdate.gradients(state, _tensors(batches[0]),
                                     _dreamer_noise(jm, keys[0]))
        first = {k: to_flax_params(v) for k, v in first.items()}
        for batch, key in zip(batches, keys):
            jstate, jmetrics = jupdate(jstate, batch, key)
            state, metrics = tupdate(state, _tensors(batch),
                                     _dreamer_noise(jm, key))
            _check_metrics(metrics, jmetrics)
        got = to_flax_params(state["params"])
        want = _np_tree(jstate["params"])
        wm_keys = list(tdv3.WM_KEYS)
        _check_steps({k: got[k] for k in wm_keys},
                     {k: want[k] for k in wm_keys}, first["wm"],
                     2 * tupdate.wm_lr)
        for group in ("actor", "critic"):
            _check_steps(got[group], want[group], first[group],
                         2 * tupdate.ac_lr)
        assert _rel(state["ret_scale"], jstate["ret_scale"]) <= TOL_LOSS
        assert state["step"] == int(jstate["step"]) == 2


# -- the shared Adam step and the devices ----------------------------------
def test_adam_step_matches_optax():
    rng = np.random.default_rng(0)
    params = {"a": [rng.normal(size=(3, 2)).astype(np.float32)],
              "b": np.float32(0.5)}
    grads = [{"a": [rng.normal(size=(3, 2)).astype(np.float32)],
              "b": np.float32(g)} for g in (0.3, -2.0, 1e-3)]
    tx = optax.adam(1e-2)
    jp, js = params, tx.init(params)
    tp = jax.tree.map(_t, params)
    ts = optim.adam_init(tp)
    for g in grads:
        up, js = tx.update(g, js, jp)
        jp = optax.apply_updates(jp, up)
        optim.adam_step(tp, jax.tree.map(_t, g), ts, 1e-2)
    for o, w in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(_np(o), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    assert ts["count"] == 3


@pytest.mark.parametrize("name", ["SAC", "TD3", "CQL", "DreamerV3"])
def test_learner_device_defaults_to_the_card(name):
    import types

    import ray_tpu_torch.rllib as trl
    from chip_smoke import CartPoleEnv, PendulumEnv

    if torch.cuda.is_available():
        update = tsac.make_sac_update(tmod.SACModule(OBS, ACT), GAMMA, LR,
                                      TAU, -1.0)
        assert update.device.type == "cuda"
        return
    config = getattr(trl, name + "Config")().environment(
        CartPoleEnv if name == "DreamerV3" else PendulumEnv)
    if name == "CQL":
        config.training(offline_data=types.SimpleNamespace(
            iter_rows=lambda: []))
    # Raised before any env runner starts: no cluster is needed.
    with pytest.raises(RuntimeError, match="device='cpu'"):
        config.build()
