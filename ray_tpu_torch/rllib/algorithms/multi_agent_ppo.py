"""Multi-agent PPO: one PPO learner per policy module, shared sampling.

Reference parity: rllib multi-agent training — Algorithm with
`config.multi_agent(policies=..., policy_mapping_fn=...)` builds a
MultiRLModule and updates every module from its own agents' experience
(rllib/core/learner/learner.py per-module losses;
multi_agent_env_runner.py:61 sampling).

Each module has a TorchLearner of its own, all on the one learner device;
the env runners batch all same-module agents into single forward passes.
Ported from the JAX package's ``ray_tpu/rllib/algorithms/
multi_agent_ppo.py``.
"""
import time
from typing import Any, Dict

import numpy as np
import torch

from ..core.learner import TorchLearner
from ..core.rl_module import MultiRLModule, PPOModule
from ..env.multi_agent import MultiAgentEnvRunnerGroup
from .algorithm import Algorithm, AlgorithmConfig
from .ppo import compute_gae, make_ppo_loss


def _infer_policy_dims(env_spec, env_config, policies: Dict[str, Any],
                       map_fn) -> Dict[str, tuple]:
    """Resolve (obs_dim, num_actions) per module id: explicit tuples in
    `policies` win; None values are inferred from the env's first agent
    mapped to that module."""
    resolved = {mid: tuple(v) for mid, v in policies.items()
                if v is not None}
    missing = [mid for mid in policies if mid not in resolved]
    if not missing:
        return resolved
    constructed = callable(env_spec)
    env = env_spec(env_config or {}) if constructed else env_spec
    try:
        for agent_id in env.possible_agents:
            mid = map_fn(agent_id)
            if mid in missing:
                obs_space = env.observation_spaces[agent_id]
                act_space = env.action_spaces[agent_id]
                obs_dim = int(np.prod(obs_space.shape))
                num_actions = (int(act_space.n) if hasattr(act_space, "n")
                               else int(np.prod(act_space.shape)))
                resolved[mid] = (obs_dim, num_actions)
                missing.remove(mid)
        if missing:
            raise ValueError(
                f"No agent maps to policies {missing}; give explicit "
                f"(obs_dim, num_actions) specs for them.")
    finally:
        if constructed:  # never close a user-provided instance
            env.close()
    return resolved


class MultiAgentPPO(Algorithm):
    """PPO over a MultiRLModule (reference: PPO with a multi-agent
    config)."""

    def __init__(self, config: AlgorithmConfig):
        if not config.policies or config.policy_mapping_fn is None:
            raise ValueError(
                "MultiAgentPPO needs config.multi_agent(policies=..., "
                "policy_mapping_fn=...)")
        if getattr(config, "evaluation_num_env_runners", 0) > 0:
            # Reject rather than silently evaluate on the driver.
            raise ValueError(
                "MultiAgentPPO does not support dedicated eval runner "
                "actors yet (evaluation_num_env_runners must be 0; "
                "driver-side evaluate() still runs per "
                "evaluation_interval)")
        if (config.env_to_module_connector
                or config.module_to_env_connector
                or config.learner_connector):
            raise ValueError(
                "Connector pipelines are not supported by MultiAgentPPO "
                "yet; transform observations/actions inside the env or "
                "module instead.")
        self.config = config
        self.iteration = 0
        self._total_steps = 0
        self._episode_returns: list = []
        dims = _infer_policy_dims(config.env_spec, config.env_config,
                                  config.policies,
                                  config.policy_mapping_fn)
        self.module = MultiRLModule({
            mid: PPOModule(obs_dim, n_act, config.hidden,
                           model_config=config.model)
            for mid, (obs_dim, n_act) in dims.items()})
        ex = config.extra
        loss = make_ppo_loss(
            clip=float(ex.get("clip_param", 0.2)),
            vf_coeff=float(ex.get("vf_loss_coeff", 0.5)),
            entropy_coeff=float(ex.get("entropy_coeff", 0.01)))
        self.learners: Dict[str, TorchLearner] = {
            mid: TorchLearner(m, loss, lr=config.lr, seed=config.seed + i,
                              device=config.learner_device)
            for i, (mid, m) in enumerate(sorted(self.module.items()))}
        self.learner = None  # per-module learners instead
        self.env_runner_group = MultiAgentEnvRunnerGroup(
            config.env_spec, config.env_config, self.module.modules,
            config.policy_mapping_fn,
            num_env_runners=config.num_env_runners, seed=config.seed)
        self.env_runner_group.sync_weights(self.get_weights())

    def get_weights(self) -> Dict[str, Any]:
        return {mid: ln.get_weights() for mid, ln in self.learners.items()}

    @torch.no_grad()
    def _gae_fragment(self, mid: str, frag: Dict[str, np.ndarray],
                      params) -> Dict[str, np.ndarray]:
        cfg = self.config
        module = self.module[mid]
        bootstrap = 0.0
        if not (frag["terminateds"][-1] or frag["truncateds"][-1]):
            _, v = module.apply(params, frag["next_obs"][-1:]
                                .astype(np.float32))
            bootstrap = float(v[0])
        trunc_nv = None
        trunc = np.logical_and(frag["truncateds"], ~frag["terminateds"])
        if trunc.any():
            _, v_all = module.apply(params,
                                    frag["next_obs"].astype(np.float32))
            trunc_nv = v_all.numpy()
        return compute_gae(frag, cfg.gamma,
                           cfg.extra.get("lambda_", 0.95),
                           bootstrap_value=bootstrap,
                           trunc_next_values=trunc_nv)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        frags_by_mid = self.env_runner_group.sample(
            cfg.rollout_fragment_length)
        rng = np.random.default_rng(cfg.seed + self.iteration)
        num_epochs = int(cfg.extra.get("num_epochs", 4))
        minibatch = int(cfg.extra.get("minibatch_size", 128))
        stats: Dict[str, Any] = {}
        to_train = getattr(cfg, "policies_to_train", None)
        for mid, frags in frags_by_mid.items():
            if not frags:
                continue
            if to_train is not None and mid not in to_train:
                # Frozen policy (reference: policies_to_train): samples
                # for its opponents but never receives gradients —
                # league/self-play opponents stay fixed snapshots.
                continue
            params = self.learners[mid].get_weights()
            frags = [self._gae_fragment(mid, f, params) for f in frags]
            batch = {k: np.concatenate([f[k] for f in frags])
                     for k in frags[0]}
            n = len(batch["rewards"])
            self._total_steps += n
            idx = np.arange(n)
            mstats = {}
            for _ in range(num_epochs):
                rng.shuffle(idx)
                for s in range(0, n, minibatch):
                    mb = idx[s:s + minibatch]
                    if len(mb) < 2:
                        continue
                    mstats = self.learners[mid].update(
                        {k: v[mb] for k, v in batch.items()})
            stats[mid] = dict(mstats)
        self.env_runner_group.sync_weights(self.get_weights())
        return stats

    def evaluate(self, num_episodes: int = 5) -> Dict[str, float]:
        env = (self.config.env_spec(self.config.env_config or {})
               if callable(self.config.env_spec) else self.config.env_spec)
        params = self.get_weights()
        map_fn = self.config.policy_mapping_fn
        returns = []
        for ep in range(num_episodes):
            obs, _ = env.reset(seed=10_000 + ep)
            total, done = 0.0, False
            while not done:
                actions = {}
                for agent_id, o in obs.items():
                    mid = map_fn(agent_id)
                    a = self.module[mid].forward_inference(
                        params[mid], np.asarray(o, np.float32)[None])
                    actions[agent_id] = int(a[0])
                obs, rewards, terms, truncs, _ = env.step(actions)
                total += sum(float(r) for r in rewards.values())
                done = bool(terms.get("__all__")) or \
                    bool(truncs.get("__all__"))
            returns.append(total)
        env.close()
        return {"evaluation_return_mean": float(np.mean(returns)),
                "evaluation_return_max": float(np.max(returns))}

    def compute_single_action(self, observation, explore: bool = False):
        raise NotImplementedError(
            "MultiAgentPPO has one module per policy; run inference "
            "directly: algo.module[policy_id].forward_inference("
            "algo.get_weights()[policy_id], obs[None])")

    def _get_algo_state(self) -> Dict[str, Any]:
        return {"ma_learner_states": {
            mid: ln.get_state() for mid, ln in self.learners.items()}}

    def _set_algo_state(self, state: Dict[str, Any]) -> None:
        for mid, st in state.get("ma_learner_states", {}).items():
            if mid in self.learners:
                self.learners[mid].set_state(st)


class MultiAgentPPOConfig(AlgorithmConfig):
    ALGO_CLS = MultiAgentPPO
