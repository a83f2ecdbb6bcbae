"""TD3 — Twin Delayed Deep Deterministic policy gradient.

Reference parity: rllib/algorithms/td3 (the reference ships TD3 as a
DDPG variant; this is the Fujimoto et al. recipe): deterministic tanh
actor, clipped twin-Q critics, TARGET-POLICY SMOOTHING (clipped noise
on the target action), and DELAYED policy/target updates. Ported from the
JAX package's ``ray_tpu/rllib/algorithms/td3.py``, with two bare Adam
states (``core/optim.py``), one for the critics and one for the actor.

Module reuse: the actor net is SACModule's squashed Gaussian with the
mean used deterministically — tanh(mean) IS the policy — so the twin-Q
and encoder machinery is shared rather than forked.
"""
from typing import Any, Dict

import numpy as np
import torch

from ..._device import DeviceLike, resolve_device
from ..._tree import tree_leaves, tree_map
from ..core.learner import clone_tree, gradients, trainable
from ..core.optim import adam_init, adam_step
from ..core.rl_module import SACModule, _numpy
from ..utils.replay_buffers import ReplayBuffer
from .algorithm import Algorithm, AlgorithmConfig
from .sac import OffPolicyTraining


class TD3Module(SACModule):
    """Deterministic policy view over the SAC actor/critic nets."""

    explore_noise = 0.1  # set from config by the algorithm

    def det_action(self, params, obs):
        mean, _ = self.apply_actor(params, obs)
        return torch.tanh(mean)

    @torch.no_grad()
    def forward_inference(self, params, obs):
        return _numpy(self.det_action(params, obs))

    def forward_exploration(self, params, obs, rng, **kw):
        a = self.forward_inference(params, obs)
        noise = rng.normal(0.0, self.explore_noise, size=a.shape)
        return np.clip(a + noise, -1.0, 1.0).astype(np.float32), {}

    def __reduce__(self):
        # The runners' copy keeps the configured exploration noise.
        return super().__reduce__() + ({"explore_noise":
                                        self.explore_noise},)


class TD3Update:
    """One TD3 step over state = {params, target, opt_state, step}
    (``make_td3_update`` in the JAX package). The policy delay HOLDS the
    actor params AND the actor's Adam state (its count too) on the steps
    in between, as the reference's traced select does: merely zeroing
    actor grads would not delay anything — Adam momentum keeps moving
    the params and the zero grads decay the moment estimates. The actor
    loss is computed on every step all the same (it is reported)."""

    def __init__(self, module: TD3Module, gamma: float, lr: float,
                 tau: float, policy_delay: int, target_noise: float,
                 noise_clip: float, device: DeviceLike = None):
        self.module = module
        self.gamma, self.lr, self.tau = float(gamma), float(lr), float(tau)
        self.policy_delay = int(policy_delay)
        self.target_noise = float(target_noise)
        self.noise_clip = float(noise_clip)
        self.device = resolve_device(device)

    def init_state(self, seed: int = 0, params=None) -> Dict[str, Any]:
        if params is None:
            params = self.module.init_params(seed)
        params = trainable(clone_tree(params, self.device))
        return {"params": params, "target": clone_tree(params),
                "opt_state": {"q": adam_init(params["q"]),
                              "actor": adam_init(params["actor"])},
                "step": 0}

    def noise(self, batch_size: int, generator: torch.Generator
              ) -> Dict[str, torch.Tensor]:
        """The target action's smoothing noise, standard normal (the
        reference draws it from the update's key itself)."""
        return {"target": torch.randn(
            (batch_size, self.module.num_actions), generator=generator,
            device=self.device)}

    def critic_loss(self, q_params, target, batch, noise) -> torch.Tensor:
        module = self.module
        # Target-policy smoothing: noise on the TARGET actor's action,
        # clipped, then action clipped back to the valid range.
        t_act = module.det_action({"actor": target["actor"]},
                                  batch["next_obs"])
        smooth = torch.clamp(self.target_noise * noise["target"],
                             -self.noise_clip, self.noise_clip)
        t_act = torch.clamp(t_act + smooth, -1.0, 1.0)
        tq1, tq2 = module.apply_q({"q": target["q"]}, batch["next_obs"],
                                  t_act)
        nonterm = 1.0 - batch["terminateds"].to(torch.float32)
        y = (batch["rewards"]
             + self.gamma * nonterm * torch.minimum(tq1, tq2)).detach()
        q1, q2 = module.apply_q({"q": q_params}, batch["obs"],
                                batch["actions"])
        return torch.mean((q1 - y) ** 2 + (q2 - y) ** 2)

    def actor_loss(self, actor_params, q_params, batch) -> torch.Tensor:
        a = self.module.det_action({"actor": actor_params}, batch["obs"])
        held = tree_map(lambda t, _: t.detach(), q_params)
        q1, _ = self.module.apply_q({"q": held}, batch["obs"], a)
        return -torch.mean(q1)

    def actor_step_due(self, step: int) -> bool:
        """Whether the actor and the targets move on this step."""
        return step % self.policy_delay == 0

    def __call__(self, state, batch, noise):
        """One step, in place: (state, metrics as 0-dim tensors)."""
        params, opt = state["params"], state["opt_state"]
        q_loss = self.critic_loss(params["q"], state["target"], batch, noise)
        adam_step(params["q"], gradients(q_loss, params["q"]), opt["q"],
                  self.lr)
        a_loss = self.actor_loss(params["actor"], params["q"], batch)
        a_grads = gradients(a_loss, params["actor"])
        if self.actor_step_due(state["step"]):
            adam_step(params["actor"], a_grads, opt["actor"], self.lr)
            # Targets move only with the delayed policy update (paper).
            with torch.no_grad():
                for t, o in zip(tree_leaves(state["target"]),
                                tree_leaves(params)):
                    t.copy_((1 - self.tau) * t + self.tau * o)
        state["step"] += 1
        return state, {"q_loss": q_loss.detach(),
                       "actor_loss": a_loss.detach(),
                       "q_mean": -a_loss.detach()}


make_td3_update = TD3Update  # the JAX package's name


class TD3(OffPolicyTraining, Algorithm):
    _STATE_KEY = "td3_state"

    def __init__(self, config):
        super().__init__(config)
        cfg = config
        self.buffer = ReplayBuffer(
            int(cfg.extra.get("buffer_capacity", 100_000)),
            seed=cfg.seed)
        self._update = make_td3_update(
            self.module, cfg.gamma, cfg.lr,
            float(cfg.extra.get("tau", 0.005)),
            int(cfg.extra.get("policy_delay", 2)),
            float(cfg.extra.get("target_noise", 0.2)),
            float(cfg.extra.get("noise_clip", 0.5)), device=self._device)
        self._state = self._update.init_state(cfg.seed)
        self._generator = torch.Generator(
            device=self._device).manual_seed(int(cfg.seed))
        self.env_runner_group.sync_weights(self.get_weights())

    def _build_module(self, obs_dim, num_actions):
        m = TD3Module(obs_dim, num_actions, self.config.hidden,
                      model_config=self.config.model)
        m.explore_noise = float(
            self.config.extra.get("explore_noise", 0.1))
        return m


class TD3Config(AlgorithmConfig):
    ALGO_CLS = TD3

    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.gamma = 0.99
        self.train_batch_size = 256
        self.rollout_fragment_length = 100
