"""CQL — Conservative Q-Learning for offline continuous control.

Reference parity: rllib/algorithms/cql/ (CQL extends SAC with the
conservative penalty of Kumar et al. 2020 and trains from offline
experience instead of a live replay stream). Ported from the JAX
package's ``ray_tpu/rllib/algorithms/cql.py``. The update is SAC's
twin-critic/entropy machinery (sac.py SACUpdate) with the CQL(H)
regularizer plugged in as the critic penalty:

    L_cql = alpha_cql * E_s[ logsumexp_a Q(s, a) - Q(s, a_data) ]

The logsumexp is approximated over uniform-random and current-policy
actions (no importance-density correction — documented approximation) —
pushing Q down on out-of-distribution actions and up on dataset actions,
which keeps offline-learned policies from exploiting Q-function
extrapolation errors.
"""
from typing import Dict

import torch

from ..core.learner import scalars
from ..core.rl_module import SACModule
from ..offline import resolve_offline_reader
from .algorithm import Algorithm, AlgorithmConfig
from .sac import OffPolicyTraining, make_sac_update, update_on


class CQLPenalty:
    """critic_penalty for SACUpdate implementing CQL(H). Its noise: the
    uniform random actions in [-1, 1] (B, N, A) and the policy's standard
    normal noise (B·N, A), the reference's ``split(kp)`` pair."""

    def __init__(self, module: SACModule, cql_alpha: float,
                 n_cql_actions: int = 8):
        self.module = module
        self.cql_alpha = float(cql_alpha)
        self.n = int(n_cql_actions)

    def noise(self, batch_size: int, generator: torch.Generator,
              device: torch.device) -> Dict[str, torch.Tensor]:
        a = self.module.num_actions
        uniform = torch.rand((batch_size, self.n, a), generator=generator,
                             device=device)
        return {"cql_random": uniform * 2.0 - 1.0,
                "cql_policy": torch.randn((batch_size * self.n, a),
                                          generator=generator,
                                          device=device)}

    def repeat(self, obs: torch.Tensor) -> torch.Tensor:
        """Each observation N times in a row (``jnp.repeat(obs, n,
        axis=0)``), so that row b·N + i is observation b's i-th action."""
        return obs.repeat_interleave(self.n, dim=0)

    def __call__(self, params, batch, q1, q2, noise):
        module, n = self.module, self.n
        obs = batch["obs"]
        b, a = obs.shape[0], module.num_actions

        def q_on(actions_bna):  # [B, N, A] -> (q1, q2) each [B, N]
            f1, f2 = module.apply_q(params, self.repeat(obs),
                                    actions_bna.reshape(b * n, a))
            return f1.reshape(b, n), f2.reshape(b, n)

        pol_a, _ = module.sample_action(params, self.repeat(obs),
                                        noise["cql_policy"])
        r1, r2 = q_on(noise["cql_random"])
        p1, p2 = q_on(pol_a.detach().reshape(b, n, a))
        cat1 = torch.cat([r1, p1], dim=1)
        cat2 = torch.cat([r2, p2], dim=1)
        cql = (torch.mean(torch.logsumexp(cat1, dim=1) - q1)
               + torch.mean(torch.logsumexp(cat2, dim=1) - q2))
        return self.cql_alpha * cql, {"cql_penalty": cql}


make_cql_penalty = CQLPenalty  # the JAX package's name


class CQL(OffPolicyTraining, Algorithm):
    """Offline: trains from `.training(offline_data=...)` (rows with
    obs/actions/rewards/terminateds/next_obs, continuous actions in
    [-1, 1]); no env runners."""

    _STATE_KEY = "cql_state"

    def __init__(self, config):
        self.reader = resolve_offline_reader(config, "CQL")
        super().__init__(config)
        cfg = config
        target_entropy = float(
            cfg.extra.get("target_entropy", -self.module.num_actions))
        self._update = make_sac_update(
            self.module, cfg.gamma, cfg.lr,
            float(cfg.extra.get("tau", 0.005)), target_entropy,
            critic_penalty_fn=make_cql_penalty(
                self.module,
                float(cfg.extra.get("cql_alpha", 1.0)),
                int(cfg.extra.get("n_cql_actions", 8))),
            device=self._device)
        self._state = self._update.init_state(cfg.seed)
        self._generator = torch.Generator(
            device=self._device).manual_seed(int(cfg.seed))

    def _build_module(self, obs_dim, num_actions):
        return SACModule(obs_dim, num_actions, self.config.hidden,
                         model_config=self.config.model)

    def training_step(self) -> Dict:
        cfg = self.config
        stats: Dict = {}
        n = 0
        for batch in self.reader.iter_batches(
                epochs=int(cfg.extra.get("epochs_per_iter", 1))):
            self._state, metrics = update_on(self._update, self._state,
                                             batch, self._generator)
            stats = scalars(metrics)
            n += len(batch["rewards"])
        self._total_steps += n
        return stats


class CQLConfig(AlgorithmConfig):
    ALGO_CLS = CQL

    def __init__(self):
        super().__init__()
        self.num_env_runners = 0
        self.lr = 3e-4
        self.train_batch_size = 256
