"""EnvRunner: environment-sampling actors.

Reference parity: rllib/env/single_agent_env_runner.py:65 (base
env_runner.py:28) — an actor owning env instances + a copy of the module,
producing sample batches; the EnvRunnerGroup fans sampling across N
runner actors (rllib/env/env_runner_group.py).

Sampling stays on CPU/numpy in the runners, zero-GPU actors whose
forward runs on the CPU by design; only the learner touches the card —
the split that keeps it busy with batched updates instead of per-step
single-row inference.
"""
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

import ray_tpu_torch


def _one_thread() -> None:
    """The module's forward runs in the runner, on the CPU, a few rows a
    step: one intra-op thread, so that runners sharing a host do not
    oversubscribe its cores (two runners of 8 threads on 8 cores took
    50x a one-thread step). Ray's workers start with OMP_NUM_THREADS=1
    for the same reason. Called in the thread that samples: OpenMP keeps
    the count per thread, and an actor's methods need not run in the
    thread that built it."""
    import torch

    torch.set_num_threads(1)


def _make_env(env_spec: Union[str, Callable], env_config: Dict):
    if callable(env_spec):
        return env_spec(env_config)
    import gymnasium as gym
    return gym.make(env_spec, **env_config)


def unsquash_action(action: np.ndarray, space) -> np.ndarray:
    """Rescale a tanh-squashed [-1, 1] action to `space`'s Box bounds
    (reference: connector action unsquashing, rllib/connectors).
    Unbounded/discrete spaces pass through unchanged."""
    low = getattr(space, "low", None)
    if low is None or not np.all(np.isfinite(low)):
        return action
    high = np.asarray(space.high, np.float32)
    low = np.asarray(low, np.float32)
    return low + (action + 1.0) / 2.0 * (high - low)


class SingleAgentEnvRunner:
    """Reference: single_agent_env_runner.py:65. Optional connector
    pipelines customize the obs→module and module→env paths
    (reference: AlgorithmConfig.env_to_module_connector /
    module_to_env_connector; rllib/connectors/)."""

    def __init__(self, env_spec, env_config: Dict, module, seed: int = 0,
                 env_to_module=None, module_to_env=None):
        from ..connectors import default_env_to_module, default_module_to_env
        self.env = _make_env(env_spec, env_config or {})
        self.module = module
        self.params = None
        self.rng = np.random.default_rng(seed)
        self._env_to_module = env_to_module or default_env_to_module()
        self._module_to_env = module_to_env or default_module_to_env()
        self._obs, _ = self.env.reset(seed=seed)
        self._episode_return = 0.0
        self._episode_len = 0
        self._completed: List[Dict[str, float]] = []

    def set_weights(self, params) -> bool:
        self.params = params
        return True

    def sample(self, num_steps: int, explore: bool = True,
               update_connectors: bool = True,
               **explore_kw) -> Dict[str, np.ndarray]:
        """Collect num_steps transitions (truncating episodes as needed).
        Returns a columnar batch (reference: SampleBatch columns)."""
        assert self.params is not None, "set_weights first"
        _one_thread()
        cols: Dict[str, List] = {k: [] for k in
                                 ("obs", "actions", "rewards", "terminateds",
                                  "truncateds", "next_obs")}
        extras: Dict[str, List] = {}
        for _ in range(num_steps):
            raw_obs = np.asarray(self._obs, np.float32)[None]
            # Evaluation rounds freeze stateful connector stats
            # (update_connectors=False), mirroring the driver-side
            # evaluate() path's update=False.
            obs_b = self._env_to_module(
                {"obs": raw_obs}, module=self.module,
                update=update_connectors)["obs"]
            if explore:
                action, info = self.module.forward_exploration(
                    self.params, obs_b, self.rng, **explore_kw)
            else:
                action, info = self.module.forward_inference(
                    self.params, obs_b), {}
            # The BATCH keeps the module's action (what the critic sees);
            # the env gets the connector-transformed one (default
            # pipeline: unsquash into Box bounds, no-op for discrete).
            out = self._module_to_env(
                {"actions": action}, action_space=self.env.action_space,
                module=self.module)
            env_actions = out.get("env_actions", out["actions"])
            if getattr(self.module, "discrete", True):
                a = int(action[0])
                env_a = int(np.asarray(env_actions[0]).item()) \
                    if np.ndim(env_actions[0]) == 0 else env_actions[0]
            else:
                a = np.asarray(action[0], np.float32)
                env_a = np.asarray(env_actions[0], np.float32)
            nxt, rew, term, trunc, _ = self.env.step(env_a)
            nxt_b = self._env_to_module(
                {"obs": np.asarray(nxt, np.float32)[None]},
                module=self.module, update=False)["obs"]
            cols["obs"].append(obs_b[0])
            cols["actions"].append(a)
            cols["rewards"].append(float(rew))
            cols["terminateds"].append(bool(term))
            cols["truncateds"].append(bool(trunc))
            cols["next_obs"].append(nxt_b[0])
            for k, v in info.items():
                extras.setdefault(k, []).append(np.asarray(v[0]))
            self._episode_return += float(rew)
            self._episode_len += 1
            if term or trunc:
                self._completed.append({
                    "episode_return": self._episode_return,
                    "episode_len": self._episode_len})
                self._episode_return = 0.0
                self._episode_len = 0
                self._obs, _ = self.env.reset()
                # Recurrent modules (DreamerV3's RSSM acting state)
                # reset their rollout state at episode boundaries
                # (reference: RLModule state-reset via connectors).
                hook = getattr(self.module, "on_episode_end", None)
                if hook is not None:
                    hook()
            else:
                self._obs = nxt
        batch = {k: np.asarray(v) for k, v in cols.items()}
        for k, v in extras.items():
            batch[k] = np.asarray(v)
        return batch

    def get_metrics(self) -> List[Dict[str, float]]:
        out, self._completed = self._completed, []
        return out

    def get_connector_state(self):
        """Stateful connector pieces' state (e.g. NormalizeObservations
        running stats) for driver-side sync before evaluate()."""
        getter = getattr(self._env_to_module, "get_state", None)
        return getter() if getter is not None else {}

    def set_connector_state(self, state) -> bool:
        """Adopt trained connector stats (eval runners must normalize
        with the statistics the policy trained under)."""
        setter = getattr(self._env_to_module, "set_state", None)
        if setter is not None and state:
            setter(state)
        return True

    def reset_episode(self, seed=None) -> bool:
        """Hard episode boundary (evaluation rounds): discard any
        in-progress episode so counted returns never mix weights from
        two rounds."""
        self._obs, _ = self.env.reset(seed=seed)
        self._episode_return = 0.0
        self._episode_len = 0
        hook = getattr(self.module, "on_episode_end", None)
        if hook is not None:
            hook()
        return True

    def set_task(self, task) -> bool:
        """Curriculum hook (reference: env_task_fn + TaskSettableEnv):
        forwarded to env.set_task (or env.unwrapped.set_task); the
        in-flight episode resets so the new task applies cleanly."""
        target = self.env
        fn = getattr(target, "set_task", None)
        if fn is None:
            fn = getattr(getattr(target, "unwrapped", target),
                         "set_task", None)
        if fn is None:
            return False
        fn(task)
        self.reset_episode()
        return True

    def ping(self) -> bool:
        return True


class EnvRunnerGroup:
    """Reference: env_runner_group.py — N runner actors + fan-out."""

    def __init__(self, env_spec, env_config: Dict, module,
                 num_env_runners: int = 2, seed: int = 0,
                 env_to_module=None, module_to_env=None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(ignore_reinit_error=True)
        Runner = ray_tpu_torch.remote(SingleAgentEnvRunner)
        self._runners = [
            Runner.remote(env_spec, env_config, module, seed + i,
                          env_to_module, module_to_env)
            for i in range(max(1, num_env_runners))]
        ray_tpu_torch.get([r.ping.remote() for r in self._runners])

    def __len__(self):
        return len(self._runners)

    def sync_weights(self, params):
        ray_tpu_torch.get([r.set_weights.remote(params)
                           for r in self._runners])

    def sample(self, steps_per_runner: int,
               **explore_kw) -> List[Dict[str, np.ndarray]]:
        return ray_tpu_torch.get([
            r.sample.remote(steps_per_runner, **explore_kw)
            for r in self._runners])

    def collect_metrics(self) -> List[Dict[str, float]]:
        out = []
        for m in ray_tpu_torch.get([r.get_metrics.remote()
                              for r in self._runners]):
            out.extend(m)
        return out

    def connector_states(self):
        """Every runner's env_to_module connector state, for the driver
        to merge (reference: driver-side filter-stat merging)."""
        return ray_tpu_torch.get([r.get_connector_state.remote()
                            for r in self._runners])

    def set_connector_state(self, state):
        ray_tpu_torch.get([r.set_connector_state.remote(state)
                     for r in self._runners])

    def reset_episodes(self, seed=None):
        ray_tpu_torch.get([r.reset_episode.remote(seed)
                     for r in self._runners])

    def set_task(self, task):
        """Fan a curriculum task out to every runner's env."""
        return ray_tpu_torch.get([r.set_task.remote(task)
                            for r in self._runners])

    def stop(self):
        for r in self._runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
