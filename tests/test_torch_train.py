"""The PyTorch port's training path held against the JAX package.

``gpt_loss``, its gradients (remat on and off) and ``make_train_step``
(AdamW) on weights drawn once by ``ray_tpu`` and carried over with
``from_jax_params``; token batches come from numpy with a fixed seed.
Everything runs on the CPU, where the port's attention and its gradient
are autograd through the plain version; ``chip_smoke.py`` holds the
CUDA kernels (K1, K2, K3) against those plain versions on the card. Each
test states its tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import GPTConfig as JConfig
from ray_tpu.models import gpt_init as j_init
from ray_tpu.models.gpt import gpt_loss as j_loss
from ray_tpu.models.gpt import make_train_step as j_make_train_step
from ray_tpu.ops.attention import _kernel_ok as j_kernel_ok
from ray_tpu_torch.models import (GPTConfig, from_jax_params, gpt_loss,
                                  make_train_step)
from ray_tpu_torch.models import gpt as tgpt

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


def _configs(dtype="float32", **fields):
    jdt, tdt = _DTYPES[dtype]
    return (dataclasses.replace(JConfig.tiny(), dtype=jdt, **fields),
            dataclasses.replace(GPTConfig.tiny(), dtype=tdt, **fields))


def _to_torch(jparams):
    return from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")


def _batch(seed, b, s, vocab=512):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return toks[:, :-1], toks[:, 1:]


def _norm_errs(tree_t, tree_j):
    """Per leaf: max |port - jax| / max |jax|, in f32."""
    def err(t, j):
        j = np.asarray(j).astype(np.float32)
        t = t.detach().float().numpy()
        return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-30))
    return jax.tree.leaves(jax.tree.map(err, tree_t, tree_j))


class TestGPTLoss:
    @pytest.mark.parametrize("b,s,chunk", [(2, 48, 32), (1, 33, 1)],
                             ids=["chunked", "unchunked"])
    def test_loss_matches_jax(self, b, s, chunk):
        rows, c = b * s, tgpt._LOSS_CHUNK
        while c > 1 and rows % c:
            c //= 2
        assert c == chunk  # the branch this case is meant to take
        jcfg, tcfg = _configs()
        jp = j_init(jax.random.PRNGKey(0), jcfg)
        tokens, targets = _batch(0, b, s)
        ref = float(j_loss(jp, (jnp.asarray(tokens), jnp.asarray(targets)),
                           jcfg))
        out = gpt_loss(_to_torch(jp), (torch.from_numpy(tokens),
                                       torch.from_numpy(targets)), tcfg)
        assert out.dtype == torch.float32 and out.dim() == 0
        # f32 on both sides, rows summed in another order: ~1e-7 relative.
        assert abs(float(out) - ref) <= 1e-5 * abs(ref)

    @pytest.mark.parametrize("remat", [True, False])
    def test_grads_match_jax(self, remat):
        jcfg, tcfg = _configs(remat=remat)
        jp = j_init(jax.random.PRNGKey(1), jcfg)
        tp = _to_torch(jp)
        for leaf in jax.tree.leaves(tp):
            leaf.requires_grad_(True)
        tokens, targets = _batch(1, 2, 16)
        grads = jax.grad(j_loss)(jp, (jnp.asarray(tokens),
                                      jnp.asarray(targets)), jcfg)
        gpt_loss(tp, (torch.from_numpy(tokens), torch.from_numpy(targets)),
                 tcfg).backward()
        tgrads = jax.tree.map(lambda t: t.grad, tp)
        # f32 autograd on both sides (measured ~1e-6 of each leaf's max).
        errs = _norm_errs(tgrads, grads)
        assert len(errs) == 2 + 6 * jcfg.n_layers  # tied head: no "head"
        assert max(errs) <= 2e-5, errs

    def test_remat_recomputes_blocks(self, monkeypatch):
        _, tcfg = _configs(remat=True)
        jp = j_init(jax.random.PRNGKey(2), _configs()[0])
        tp = _to_torch(jp)
        for leaf in jax.tree.leaves(tp):
            leaf.requires_grad_(True)
        calls = []
        block = tgpt._block
        monkeypatch.setattr(tgpt, "_block",
                            lambda *a: calls.append(1) or block(*a))
        tokens, targets = _batch(2, 1, 8)
        loss = gpt_loss(tp, (torch.from_numpy(tokens),
                             torch.from_numpy(targets)), tcfg)
        assert len(calls) == tcfg.n_layers
        loss.backward()
        # Each checkpointed block runs again in the backward.
        assert len(calls) == 2 * tcfg.n_layers


class TestTrainStep:
    @pytest.mark.parametrize("dtype,tol,loss_rtol", [
        # f32: the same AdamW arithmetic (measured ~2e-6 of each leaf's
        # max after 5 steps).
        ("float32", 2e-5, 1e-5),
        # bf16: params and moments are bf16 on both sides, rounded at other
        # points; a step of lr=3e-4 is below one ulp of a weight above
        # ~0.08, so whether it moves turns on rounding (measured up to
        # 6e-3 of a leaf's max: 1.5 ulps of bf16).
        ("bfloat16", 2e-2, 2e-3),
    ])
    @pytest.mark.parametrize("steps", [1, 5])
    def test_state_matches_jax(self, dtype, tol, loss_rtol, steps):
        jcfg, tcfg = _configs(dtype)
        j_init_state, j_step = j_make_train_step(jcfg, donate=False)
        jstate = j_init_state(jax.random.PRNGKey(3))
        init_state, train_step = make_train_step(tcfg, device="cpu")
        state = init_state(params=_to_torch(jstate["params"]))
        assert set(state) == {"params", "opt_state", "step"}
        for i in range(steps):
            tokens, targets = _batch(10 + i, 2, 16)
            jstate, jm = j_step(jstate, (jnp.asarray(tokens),
                                         jnp.asarray(targets)))
            state, m = train_step(state, (torch.from_numpy(tokens),
                                          torch.from_numpy(targets)))
            assert m["loss"].dim() == 0 and not m["loss"].requires_grad
            assert abs(float(m["loss"]) - float(jm["loss"])) <= \
                loss_rtol * abs(float(jm["loss"]))
        assert state["step"] == int(jstate["step"]) == steps
        errs = _norm_errs(state["params"], jstate["params"])
        assert max(errs) <= tol, errs
        # The moments are kept in each param's dtype, as optax keeps them.
        moments = state["opt_state"].state[state["params"]["embed"]]
        assert moments["exp_avg"].dtype == tcfg.dtype

    def test_loss_falls_on_a_repeated_batch(self):
        _, tcfg = _configs()
        init_state, train_step = make_train_step(tcfg, device="cpu")
        state = init_state(torch.Generator().manual_seed(0))
        batch = tuple(map(torch.from_numpy, _batch(4, 2, 16)))
        losses = [float(train_step(state, batch)[1]["loss"])
                  for _ in range(5)]
        assert all(np.isfinite(losses))
        assert losses[-1] < losses[0], losses

    def test_step_matches_jax_pallas_interpret(self, monkeypatch):
        """At S=128 the JAX step runs its real Pallas forward and backward
        kernels (interpret mode); the port's CPU step runs its plain
        versions."""
        monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")
        assert j_kernel_ok(128)
        jcfg, tcfg = _configs()
        j_init_state, j_step = j_make_train_step(jcfg, donate=False)
        jstate = j_init_state(jax.random.PRNGKey(5))
        init_state, train_step = make_train_step(tcfg, device="cpu")
        state = init_state(params=_to_torch(jstate["params"]))
        tokens, targets = _batch(5, 2, 128)
        jstate, jm = j_step(jstate, (jnp.asarray(tokens),
                                     jnp.asarray(targets)))
        state, m = train_step(state, (torch.from_numpy(tokens),
                                      torch.from_numpy(targets)))
        # Flash (blockwise online softmax) vs one-pass softmax, in f32.
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            1e-5 * abs(float(jm["loss"]))
        errs = _norm_errs(state["params"], jstate["params"])
        assert max(errs) <= 2e-5, errs
