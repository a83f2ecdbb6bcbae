"""Multi-agent environments and the multi-agent sampling actor.

Reference parity: rllib/env/multi_agent_env.py (MultiAgentEnv — dict
obs/action/reward keyed by agent id, "__all__" done flag) and
rllib/env/multi_agent_env_runner.py:61 (MultiAgentEnvRunner — one env, a
MultiRLModule, and an agent→module mapping fn, producing per-module sample
fragments).

The same split as the single-agent runner: sampling is numpy on zero-GPU
CPU actors; per-step inference batches all agents mapped to the same
module into ONE forward pass, and only the learners' updates touch the
card.
"""
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

import ray_tpu_torch

from .env_runner import _one_thread


class MultiAgentEnv:
    """Base class (reference: rllib/env/multi_agent_env.py MultiAgentEnv).

    Subclasses define:
      - ``possible_agents``: list of agent ids
      - ``observation_spaces`` / ``action_spaces``: dicts per agent
        (gymnasium spaces)
      - ``reset(seed=None) -> (obs_dict, info_dict)``
      - ``step(action_dict) -> (obs, rewards, terminateds, truncateds,
        infos)`` where each is a per-agent dict and ``terminateds``/
        ``truncateds`` additionally carry the ``"__all__"`` episode flag.
    Agents may appear/disappear between steps: only ids present in the
    obs dict act next step.
    """

    possible_agents: List[str] = []
    observation_spaces: Dict[str, Any] = {}
    action_spaces: Dict[str, Any] = {}

    def reset(self, seed: Optional[int] = None
              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]):
        raise NotImplementedError

    def close(self):
        pass


def _fragment_columns() -> Dict[str, List]:
    return {k: [] for k in ("obs", "actions", "rewards", "terminateds",
                            "truncateds", "next_obs")}


class _AgentFragment:
    """One agent's in-progress rollout piece (reference: the per-agent
    SingleAgentEpisode inside MultiAgentEpisode)."""

    __slots__ = ("cols", "extras")

    def __init__(self):
        self.cols = _fragment_columns()
        self.extras: Dict[str, List] = {}

    def append(self, obs, action, reward, term, trunc, next_obs,
               info: Dict[str, Any]):
        c = self.cols
        c["obs"].append(obs)
        c["actions"].append(action)
        c["rewards"].append(float(reward))
        c["terminateds"].append(bool(term))
        c["truncateds"].append(bool(trunc))
        c["next_obs"].append(next_obs)
        for k, v in info.items():
            self.extras.setdefault(k, []).append(v)

    def __len__(self):
        return len(self.cols["obs"])

    def to_batch(self) -> Dict[str, np.ndarray]:
        out = {k: np.asarray(v) for k, v in self.cols.items()}
        for k, v in self.extras.items():
            out[k] = np.asarray(v)
        return out


class MultiAgentEnvRunner:
    """Reference: multi_agent_env_runner.py:61.

    sample() returns ``{module_id: [fragment_batch, ...]}`` — one columnar
    batch per (agent, episode piece), so per-module GAE sees clean
    boundaries instead of interleaved agents.
    """

    def __init__(self, env_spec: Union[Callable, type], env_config: Dict,
                 modules: Dict[str, Any],
                 policy_mapping_fn: Callable[[str], str],
                 seed: int = 0):
        self.env = env_spec(env_config or {}) if callable(env_spec) \
            else env_spec
        self.modules = modules
        self.map_fn = policy_mapping_fn
        self.params: Optional[Dict[str, Any]] = None
        self.rng = np.random.default_rng(seed)
        self._obs, _ = self.env.reset(seed=seed)
        self._episode_return = 0.0
        self._episode_len = 0
        self._agent_returns: Dict[str, float] = {}
        self._completed: List[Dict[str, Any]] = []

    def set_weights(self, params: Dict[str, Any]) -> bool:
        self.params = params
        return True

    def _act(self, obs_dict: Dict[str, Any], explore: bool
             ) -> Tuple[Dict[str, Any], Dict[str, Dict]]:
        """One batched forward pass per module covering all its agents."""
        by_module: Dict[str, List[str]] = {}
        for agent_id in obs_dict:
            by_module.setdefault(self.map_fn(agent_id), []).append(agent_id)
        actions: Dict[str, Any] = {}
        infos: Dict[str, Dict] = {}
        for mid, agent_ids in by_module.items():
            module = self.modules[mid]
            obs_b = np.stack([np.asarray(obs_dict[a], np.float32)
                              for a in agent_ids])
            if explore:
                acts, info = module.forward_exploration(
                    self.params[mid], obs_b, self.rng)
            else:
                acts, info = module.forward_inference(
                    self.params[mid], obs_b), {}
            for i, a in enumerate(agent_ids):
                actions[a] = (int(acts[i])
                              if getattr(module, "discrete", True)
                              else np.asarray(acts[i], np.float32))
                infos[a] = {k: np.asarray(v[i]) for k, v in info.items()}
        return actions, infos

    def sample(self, num_steps: int, explore: bool = True
               ) -> Dict[str, List[Dict[str, np.ndarray]]]:
        assert self.params is not None, "set_weights first"
        _one_thread()
        open_frags: Dict[str, _AgentFragment] = {}
        done_frags: Dict[str, List[Dict[str, np.ndarray]]] = {}

        def _close(agent_id: str, mark_truncated: bool = False):
            frag = open_frags.pop(agent_id, None)
            if frag is not None and len(frag):
                if mark_truncated and not (frag.cols["terminateds"][-1]
                                           or frag.cols["truncateds"][-1]):
                    # Episode ended while this agent was absent (it
                    # dropped out earlier): without the flag its fragment
                    # would silently span the reset and GAE would leak
                    # value across episodes.
                    frag.cols["truncateds"][-1] = True
                done_frags.setdefault(self.map_fn(agent_id), []).append(
                    frag.to_batch())

        for _ in range(num_steps):
            actions, infos = self._act(self._obs, explore)
            nxt, rewards, terms, truncs, _ = self.env.step(actions)
            all_done = bool(terms.get("__all__")) or \
                bool(truncs.get("__all__"))
            for agent_id, action in actions.items():
                term = bool(terms.get(agent_id, False))
                trunc = bool(truncs.get(agent_id, False)) or \
                    (all_done and not term)
                rew = float(rewards.get(agent_id, 0.0))
                frag = open_frags.setdefault(agent_id, _AgentFragment())
                frag.append(
                    np.asarray(self._obs[agent_id], np.float32), action,
                    rew, term, trunc,
                    np.asarray(nxt.get(agent_id, self._obs[agent_id]),
                               np.float32),
                    infos.get(agent_id, {}))
                self._agent_returns[agent_id] = \
                    self._agent_returns.get(agent_id, 0.0) + rew
                self._episode_return += rew
                if term or trunc:
                    _close(agent_id)
            self._episode_len += 1
            if all_done:
                # Close EVERY open fragment — including agents that
                # dropped out mid-episode and did not act this step.
                for agent_id in list(open_frags):
                    _close(agent_id, mark_truncated=True)
                self._completed.append({
                    "episode_return": self._episode_return,
                    "episode_len": self._episode_len,
                    "agent_returns": dict(self._agent_returns)})
                self._episode_return = 0.0
                self._episode_len = 0
                self._agent_returns = {}
                self._obs, _ = self.env.reset()
            else:
                self._obs = nxt
        for agent_id in list(open_frags):
            _close(agent_id)
        return done_frags

    def get_metrics(self) -> List[Dict[str, Any]]:
        out, self._completed = self._completed, []
        return out

    def ping(self) -> bool:
        return True


class MultiAgentEnvRunnerGroup:
    """N MultiAgentEnvRunner actors (reference: EnvRunnerGroup over
    multi-agent runners, env_runner_group.py)."""

    def __init__(self, env_spec, env_config: Dict, modules: Dict[str, Any],
                 policy_mapping_fn: Callable[[str], str],
                 num_env_runners: int = 2, seed: int = 0):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(ignore_reinit_error=True)
        Runner = ray_tpu_torch.remote(MultiAgentEnvRunner)
        self._runners = [
            Runner.remote(env_spec, env_config, modules, policy_mapping_fn,
                          seed + i)
            for i in range(max(1, num_env_runners))]
        ray_tpu_torch.get([r.ping.remote() for r in self._runners])

    def __len__(self):
        return len(self._runners)

    def sync_weights(self, params: Dict[str, Any]):
        ray_tpu_torch.get([r.set_weights.remote(params)
                           for r in self._runners])

    def sample(self, steps_per_runner: int
               ) -> Dict[str, List[Dict[str, np.ndarray]]]:
        merged: Dict[str, List[Dict[str, np.ndarray]]] = {}
        for frags in ray_tpu_torch.get([r.sample.remote(steps_per_runner)
                                  for r in self._runners]):
            for mid, lst in frags.items():
                merged.setdefault(mid, []).extend(lst)
        return merged

    def collect_metrics(self) -> List[Dict[str, Any]]:
        out = []
        for m in ray_tpu_torch.get([r.get_metrics.remote()
                              for r in self._runners]):
            out.extend(m)
        return out

    def stop(self):
        for r in self._runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
