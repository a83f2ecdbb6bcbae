"""DQN (reference: rllib/algorithms/dqn/ — replay buffer + target
network + epsilon-greedy exploration, double-Q loss). Ported from the JAX
package's ``ray_tpu/rllib/algorithms/dqn.py``."""
from typing import Dict

import numpy as np
import torch

from ..._tree import tree_map
from ..core.learner import TorchLearner
from ..core.rl_module import DQNModule
from ..utils.replay_buffers import (PrioritizedReplayBuffer,
                                    ReplayBuffer)
from .algorithm import Algorithm, AlgorithmConfig
from .ppo import taken


def _td_errors(params, module, batch, gamma: float):
    """Per-sample double-DQN TD errors (shared by the loss and the
    post-update priority refresh)."""
    q = module.apply(params, batch["obs"])
    q_taken = taken(q, batch["actions"])
    q_next_online = module.apply(params, batch["next_obs"])
    next_a = torch.argmax(q_next_online, -1)
    q_next_target = taken(batch["target_q_next"], next_a)
    nonterm = 1.0 - batch["terminateds"].to(torch.float32)
    target = batch["rewards"] + gamma * nonterm * q_next_target
    return q_taken - target.detach(), q_taken


def make_dqn_loss(gamma: float):
    def dqn_loss(params, module, batch):
        """Double-DQN TD loss (reference: dqn learner compute_loss):
        online net picks argmax a', target net evaluates it. With
        prioritized replay the batch carries importance `weights` that
        de-bias the gradient (reference: PER weighted TD loss)."""
        td, q_taken = _td_errors(params, module, batch, gamma)
        sq = torch.square(td)
        if "weights" in batch:
            loss = torch.mean(batch["weights"] * sq)
        else:
            loss = torch.mean(sq)
        return loss, {"td_error_mean": torch.mean(torch.abs(td)),
                      "q_mean": torch.mean(q_taken),
                      # per-sample magnitudes: the PER priority refresh
                      # reads these from the SAME forward pass the loss
                      # ran (no duplicate Q-network inference).
                      "td_abs": torch.abs(td)}
    return dqn_loss


class DQN(Algorithm):
    def __init__(self, config):
        super().__init__(config)
        cap = int(config.extra.get("buffer_capacity", 50_000))
        if config.extra.get("prioritized_replay", False):
            self.buffer = PrioritizedReplayBuffer(
                cap, alpha=float(config.extra.get("alpha", 0.6)),
                seed=config.seed)
        else:
            self.buffer = ReplayBuffer(cap, seed=config.seed)
        self._sync_target()

    def _build_module(self, obs_dim, num_actions):
        return DQNModule(obs_dim, num_actions, self.config.hidden,
                         model_config=self.config.model)

    def _build_learner(self):
        return TorchLearner(self.module, make_dqn_loss(self.config.gamma),
                            lr=self.config.lr, seed=self.config.seed,
                            device=self.config.learner_device)

    def _sync_target(self):
        """The target net: a copy of the learner's params on its device
        (the JAX package keeps a host copy and its jitted target-Q call
        moves it there each time)."""
        self.target_params = tree_map(lambda t, _: t.detach().clone(),
                                      self.learner.params)

    @torch.no_grad()
    def _target_q(self, obs) -> torch.Tensor:
        return self.module.apply(self.target_params, obs)

    def training_step(self) -> Dict:
        cfg = self.config
        eps_spec = cfg.extra.get("epsilon")
        if eps_spec is not None:
            # Schedule-format exploration (reference: the new-API
            # `epsilon=[[t, v], ...]` config + utils/schedules/):
            # resolved against total ENV STEPS sampled so far.
            from ..utils.schedules import Scheduler
            epsilon = Scheduler(eps_spec).value(self._total_steps)
        else:
            eps_start = float(cfg.extra.get("epsilon_start", 1.0))
            eps_end = float(cfg.extra.get("epsilon_end", 0.05))
            eps_iters = float(cfg.extra.get("epsilon_iters", 20))
            epsilon = max(eps_end, eps_start - (eps_start - eps_end)
                          * self.iteration / eps_iters)
        for frag in self.env_runner_group.sample(
                cfg.rollout_fragment_length, epsilon=epsilon):
            self.buffer.add_batch(frag)
            self._total_steps += len(frag["rewards"])
        stats: Dict = {"epsilon": epsilon}
        warmup = int(cfg.extra.get("learning_starts", 1000))
        per = isinstance(self.buffer, PrioritizedReplayBuffer)
        if per:
            # Linear beta anneal 0.4 -> 1.0 (reference: PER appendix;
            # full IS correction as learning converges).
            beta0 = float(cfg.extra.get("beta", 0.4))
            frac = min(1.0, self.iteration
                       / float(cfg.extra.get("beta_iters", 100)))
            beta = beta0 + (1.0 - beta0) * frac
            stats["beta"] = beta
        if len(self.buffer) >= max(warmup, cfg.train_batch_size):
            for _ in range(int(cfg.extra.get("updates_per_iter", 8))):
                batch = self.buffer.sample(cfg.train_batch_size,
                                           beta=beta) if per \
                    else self.buffer.sample(cfg.train_batch_size)
                batch["target_q_next"] = self._target_q(batch["next_obs"])
                idxs = batch.pop("batch_indexes", None)
                upd = self.learner.update(batch)
                td = upd.pop("td_abs", None)
                stats.update(upd)
                if per and idxs is not None and td is not None:
                    # The mesh learner drops a ragged batch tail; only
                    # the rows that actually trained get new priorities.
                    self.buffer.update_priorities(idxs[:len(td)],
                                                  np.asarray(td))
        if self.iteration % int(
                cfg.extra.get("target_update_freq", 5)) == 0:
            self._sync_target()
        self.env_runner_group.sync_weights(self.learner.get_weights())
        return stats


class DQNConfig(AlgorithmConfig):
    ALGO_CLS = DQN

    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.train_batch_size = 64
