"""SAC — Soft Actor-Critic for continuous control.

Reference parity: rllib/algorithms/sac/ (sac.py, sac_learner,
default SAC RLModule) — squashed-Gaussian actor, clipped twin-Q
critics, entropy-regularized targets with auto-tuned temperature, and
polyak-averaged target critics. Ported from the JAX package's
``ray_tpu/rllib/algorithms/sac.py``: one backward of the summed loss over
the actor, the critics and the temperature, then one bare Adam over all
of them (``core/optim.py``; no clip, as the reference's single
``optax.adam``).

The update takes its noise as tensors (``SACUpdate.noise`` draws them
from a ``torch.Generator``), since torch cannot reproduce ``jax.random``'s
streams: the JAX package's draws can be handed in unchanged.
"""
from typing import Any, Dict, Tuple

import torch

from ..._device import DeviceLike, resolve_device
from ..._tree import tree_leaves, tree_map
from ..core.learner import (_host, clone_tree, device_batch, gradients,
                            load_state, scalars, trainable)
from ..core.optim import adam_init, adam_step
from ..core.rl_module import SACModule, _leaf_of
from ..utils.replay_buffers import ReplayBuffer
from .algorithm import Algorithm, AlgorithmConfig

# The columns an off-policy update reads.
TRANSITION_COLUMNS = ("obs", "actions", "rewards", "terminateds",
                      "next_obs")


class SACUpdate:
    """One SAC step over state = {params, target_q, log_alpha, opt_state}
    (``make_sac_update`` in the JAX package). Critic, actor, and
    temperature losses combine with ``detach`` where the reference has
    stop_gradient (reference: sac_torch_learner compute_loss_for_module).

    ``critic_penalty_fn(params, batch, q1, q2, noise) -> (penalty,
    aux)`` optionally regularizes the critic loss — the extension point
    CQL uses for its conservative term (cql.py); its ``noise(batch_size,
    generator, device)`` adds the draws it needs to the update's."""

    def __init__(self, module: SACModule, gamma: float, lr: float,
                 tau: float, target_entropy: float, critic_penalty_fn=None,
                 device: DeviceLike = None):
        self.module = module
        self.gamma, self.lr, self.tau = float(gamma), float(lr), float(tau)
        self.target_entropy = float(target_entropy)
        self.critic_penalty = critic_penalty_fn
        self.device = resolve_device(device)

    # -- state -------------------------------------------------------------
    def init_state(self, seed: int = 0, params=None) -> Dict[str, Any]:
        """Fresh params from ``module.init_params(seed)``, or the given
        ``params`` ({"actor", "q"} trees), on the update's device."""
        if params is None:
            params = self.module.init_params(seed)
        params = trainable(clone_tree(params, self.device))
        log_alpha = torch.zeros((), device=self.device,
                                dtype=_leaf_of(params).dtype,
                                requires_grad=True)
        return {"params": params, "target_q": clone_tree(params["q"]),
                "log_alpha": log_alpha,
                "opt_state": adam_init({"params": params,
                                        "log_alpha": log_alpha})}

    def noise(self, batch_size: int, generator: torch.Generator
              ) -> Dict[str, torch.Tensor]:
        """The standard normal noise of the next and the current action
        (the reference's ``split(key, 3)``'s first two keys), and the
        critic penalty's draws."""
        shape = (batch_size, self.module.num_actions)
        draw = lambda: torch.randn(shape, generator=generator,  # noqa: E731
                                   device=self.device)
        out = {"next": draw(), "current": draw()}
        if self.critic_penalty is not None:
            out.update(self.critic_penalty.noise(batch_size, generator,
                                                 self.device))
        return out

    # -- the loss ----------------------------------------------------------
    def actor_q(self, params, obs, action):
        """Q of the actor's own action with the critics held: the critic
        params detached, the action keeping its graph to the actor."""
        held = {"q": tree_map(lambda t, _: t.detach(), params["q"])}
        return self.module.apply_q(held, obs, action)

    def loss(self, params, target_q, log_alpha, batch, noise
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        module = self.module
        alpha = torch.exp(log_alpha)
        # -- critic loss: entropy-regularized TD target from target nets
        next_a, next_logp = module.sample_action(params, batch["next_obs"],
                                                 noise["next"])
        tq1, tq2 = module.apply_q({"q": target_q}, batch["next_obs"],
                                  next_a)
        min_tq = torch.minimum(tq1, tq2) - alpha.detach() * next_logp
        nonterm = 1.0 - batch["terminateds"].to(torch.float32)
        target = (batch["rewards"] + self.gamma * nonterm * min_tq).detach()
        q1, q2 = module.apply_q(params, batch["obs"], batch["actions"])
        bellman = torch.mean((q1 - target) ** 2 + (q2 - target) ** 2)
        extra: Dict[str, torch.Tensor] = {}
        q_loss = bellman
        if self.critic_penalty is not None:
            penalty, aux = self.critic_penalty(params, batch, q1, q2, noise)
            q_loss = bellman + penalty
            extra.update(aux)
        # -- actor loss: maximize entropy-regularized Q via reparam
        a, logp = module.sample_action(params, batch["obs"],
                                       noise["current"])
        pq1, pq2 = self.actor_q(params, batch["obs"], a)
        actor_loss = torch.mean(alpha.detach() * logp
                                - torch.minimum(pq1, pq2))
        # -- temperature loss: drive entropy toward target_entropy
        alpha_loss = -torch.mean(
            log_alpha * (logp + self.target_entropy).detach())
        total = q_loss + actor_loss + alpha_loss
        return total, {"q_loss": bellman, "actor_loss": actor_loss,
                       "alpha": alpha, "entropy": -torch.mean(logp),
                       **extra}

    def gradients(self, state, batch, noise):
        """(metrics, grads): the summed loss's gradients over
        {"params", "log_alpha"}, without a step."""
        trainables = {"params": state["params"],
                      "log_alpha": state["log_alpha"]}
        total, metrics = self.loss(state["params"], state["target_q"],
                                   state["log_alpha"], batch, noise)
        return metrics, gradients(total, trainables)

    @torch.no_grad()
    def _polyak(self, target, online) -> None:
        for t, o in zip(tree_leaves(target), tree_leaves(online)):
            t.copy_((1 - self.tau) * t + self.tau * o)

    def __call__(self, state, batch, noise):
        """One step, in place: (state, metrics as 0-dim tensors)."""
        metrics, grads = self.gradients(state, batch, noise)
        adam_step({"params": state["params"],
                   "log_alpha": state["log_alpha"]}, grads,
                  state["opt_state"], self.lr)
        # The target follows the critics only.
        self._polyak(state["target_q"], state["params"]["q"])
        return state, metrics


# The JAX package's name: its (init_state, update) pair is the object's
# ``init_state`` and call.
make_sac_update = SACUpdate


def update_on(update, state, batch, generator: torch.Generator):
    """One step of ``update`` (SACUpdate, TD3Update) on a numpy batch of
    transitions, its noise drawn from ``generator``."""
    batch = device_batch({k: v for k, v in batch.items()
                          if k in TRANSITION_COLUMNS}, update.device)
    return update(state, batch,
                  update.noise(len(batch["rewards"]), generator))


class OffPolicyTraining:
    """Shared off-policy driver loop (SAC, TD3): sample -> replay
    buffer -> warmup-gated updates on the learner's device -> weight
    sync, with checkpointing that bypasses Algorithm's learner-based
    paths. Subclasses build ``self._update`` (with ``noise`` and a call)
    and set _STATE_KEY for checkpoint compatibility; CQL and DreamerV3,
    which own their updates too, keep the rest and train their own
    way."""

    _STATE_KEY = "off_policy_state"

    def _build_learner(self):
        # The subclass owns its update; the device is checked here, before
        # any runner starts.
        self._device = resolve_device(self.config.learner_device)
        return None

    def get_weights(self):
        return _host(self._state["params"])

    def training_step(self) -> Dict:
        cfg = self.config
        for frag in self.env_runner_group.sample(
                cfg.rollout_fragment_length):
            self.buffer.add_batch(frag)
            self._total_steps += len(frag["rewards"])
        stats: Dict = {}
        warmup = int(cfg.extra.get("learning_starts", 1000))
        metrics: Dict = {}
        if len(self.buffer) >= max(warmup, cfg.train_batch_size):
            for _ in range(int(cfg.extra.get("updates_per_iter", 16))):
                self._state, metrics = update_on(
                    self._update, self._state,
                    self.buffer.sample(cfg.train_batch_size),
                    self._generator)
            stats.update(scalars(metrics))
        self.env_runner_group.sync_weights(self.get_weights())
        return stats

    def _get_algo_state(self):
        return {self._STATE_KEY: _host(self._state)}

    def _set_algo_state(self, state):
        # Algorithm.restore syncs the runners after this.
        if self._STATE_KEY in state:
            self._state = load_state(state[self._STATE_KEY], self._device)


class SAC(OffPolicyTraining, Algorithm):
    _STATE_KEY = "sac_state"

    def __init__(self, config):
        super().__init__(config)
        cfg = config
        self.buffer = ReplayBuffer(
            int(cfg.extra.get("buffer_capacity", 100_000)), seed=cfg.seed)
        target_entropy = float(
            cfg.extra.get("target_entropy", -self.module.num_actions))
        self._update = make_sac_update(
            self.module, cfg.gamma, cfg.lr,
            float(cfg.extra.get("tau", 0.005)), target_entropy,
            device=self._device)
        self._state = self._update.init_state(cfg.seed)
        self._generator = torch.Generator(
            device=self._device).manual_seed(int(cfg.seed))
        self.env_runner_group.sync_weights(self.get_weights())

    def _build_module(self, obs_dim, num_actions):
        return SACModule(obs_dim, num_actions, self.config.hidden,
                         model_config=self.config.model)


class SACConfig(AlgorithmConfig):
    ALGO_CLS = SAC

    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.train_batch_size = 256
        self.rollout_fragment_length = 100
