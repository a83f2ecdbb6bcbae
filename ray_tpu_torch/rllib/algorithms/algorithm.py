"""Algorithm + AlgorithmConfig: the RLlib user surface.

Reference parity: rllib/algorithms/algorithm.py:233 (Algorithm — a
Trainable driving EnvRunnerGroup sampling + Learner updates per train())
and algorithm_config.py (the fluent AlgorithmConfig builder:
.environment().env_runners().learners().training().build()).
"""
import os
import pickle
import time
from typing import Any, Callable, Dict, Optional, Union

import numpy as np

from ..env.env_runner import EnvRunnerGroup


class AlgorithmConfig:
    """Reference: algorithm_config.py fluent builder."""

    ALGO_CLS = None  # set by subclasses

    def __init__(self):
        self.env_spec: Union[str, Callable, None] = None
        self.env_config: Dict = {}
        self.num_env_runners: int = 2
        self.rollout_fragment_length: int = 200
        self.lr: float = 3e-4
        self.gamma: float = 0.99
        self.train_batch_size: int = 400
        self.hidden: tuple = (64, 64)
        # Catalog model config (reference: AlgorithmConfig.model /
        # MODEL_DEFAULTS) — merged over rllib.core.catalog.MODEL_DEFAULTS
        # by the module.
        self.model: Dict[str, Any] = {}
        self.seed: int = 0
        self.extra: Dict[str, Any] = {}
        # multi-agent (reference: AlgorithmConfig.multi_agent)
        self.policies: Optional[Dict[str, Any]] = None
        self.policy_mapping_fn: Optional[Callable] = None
        self.policies_to_train: Optional[list] = None
        # curriculum learning (reference: env_task_fn — called with
        # (train_result, current_task) after every iteration; a changed
        # return value is pushed to every env runner via env.set_task).
        self.env_task_fn: Optional[Callable] = None
        # connector factories (reference: AlgorithmConfig connectors)
        self.env_to_module_connector: Optional[Callable] = None
        self.module_to_env_connector: Optional[Callable] = None
        self.learner_connector: Optional[Callable] = None
        # evaluation (reference: AlgorithmConfig.evaluation)
        self.evaluation_interval: int = 0       # 0 = no periodic eval
        self.evaluation_duration: int = 5       # episodes per round
        self.evaluation_num_env_runners: int = 0  # 0 = driver rollouts
        # Where the learner's params and update live (reference:
        # AlgorithmConfig.learners): None is the CUDA card.
        self.learner_device = None

    def environment(self, env=None, *, env_config: Optional[Dict] = None,
                    env_task_fn: Optional[Callable] = None):
        if env is not None:
            self.env_spec = env
        if env_config is not None:
            self.env_config = dict(env_config)
        if env_task_fn is not None:
            self.env_task_fn = env_task_fn
        return self

    def env_runners(self, *, num_env_runners: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None,
                    env_to_module_connector: Optional[Callable] = None,
                    module_to_env_connector: Optional[Callable] = None):
        """`*_connector` args are zero-arg factories returning a
        ConnectorV2/pipeline (reference: AlgorithmConfig.env_runners
        connector factories) — factories, so each runner actor gets its
        own stateful copy."""
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if env_to_module_connector is not None:
            self.env_to_module_connector = env_to_module_connector
        if module_to_env_connector is not None:
            self.module_to_env_connector = module_to_env_connector
        return self

    def training(self, *, lr=None, gamma=None, train_batch_size=None,
                 model=None, **kwargs):
        if lr is not None:
            self.lr = lr
        if gamma is not None:
            self.gamma = gamma
        if train_batch_size is not None:
            self.train_batch_size = train_batch_size
        if model is not None:
            from ..core.catalog import merge_model_config
            merge_model_config(model)  # validate keys up front
            self.model.update(model)
            if "hidden" in model:
                self.hidden = tuple(model["hidden"])
            elif "fcnet_hiddens" in model:
                self.hidden = tuple(model["fcnet_hiddens"])
        if "learner_connector" in kwargs:
            self.learner_connector = kwargs.pop("learner_connector")
        self.extra.update(kwargs)
        return self

    def learners(self, *, device=None):
        """Where the learner runs (reference: AlgorithmConfig.learners,
        learner placement): None means the CUDA card, and building the
        algorithm raises RuntimeError without one; "cpu" runs the update
        on the host. Env runners are zero-GPU actors either way."""
        self.learner_device = device
        return self

    def debugging(self, *, seed: Optional[int] = None):
        if seed is not None:
            self.seed = seed
        return self

    def evaluation(self, *, evaluation_interval: Optional[int] = None,
                   evaluation_duration: Optional[int] = None,
                   evaluation_num_env_runners: Optional[int] = None):
        """Periodic evaluation config (reference:
        AlgorithmConfig.evaluation — evaluation_interval iterations
        between eval rounds, evaluation_duration episodes per round,
        dedicated eval runner actors when evaluation_num_env_runners >
        0; 0 = greedy driver-side rollouts)."""
        if evaluation_interval is not None:
            self.evaluation_interval = int(evaluation_interval)
        if evaluation_duration is not None:
            self.evaluation_duration = int(evaluation_duration)
        if evaluation_num_env_runners is not None:
            self.evaluation_num_env_runners = int(
                evaluation_num_env_runners)
        return self

    def multi_agent(self, *, policies: Optional[Dict[str, Any]] = None,
                    policy_mapping_fn: Optional[Callable] = None,
                    policies_to_train: Optional[list] = None):
        """Reference: AlgorithmConfig.multi_agent(policies=...,
        policy_mapping_fn=..., policies_to_train=...). `policies` maps
        module_id → None (infer spaces from the env's first mapped
        agent) or (obs_dim, num_actions). The mapping fn takes an agent
        id and returns a module id. `policies_to_train` restricts
        gradient updates to the listed module ids — frozen opponents in
        league/self-play setups sample but never learn."""
        if policies is not None:
            self.policies = dict(policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        if policies_to_train is not None:
            self.policies_to_train = list(policies_to_train)
        return self

    def build(self) -> "Algorithm":
        return self.ALGO_CLS(self)


def _env_dims(env_spec, env_config) -> tuple:
    """(obs_dim, action_dim) — obs_dim is the flat width for vector
    obs, the full `(H, W, C)` shape tuple for image (rank-3) obs so the
    Catalog can build a CNN; action_dim is `n` for discrete spaces, the
    action vector length for continuous (Box) spaces."""
    from ..env.env_runner import _make_env
    env = _make_env(env_spec, env_config or {})
    shape = env.observation_space.shape or (1,)
    obs_dim = tuple(int(d) for d in shape) if len(shape) == 3 \
        else int(np.prod(shape))
    space = env.action_space
    if hasattr(space, "n"):
        num_actions = int(space.n)
    else:
        num_actions = int(np.prod(space.shape))
    env.close()
    return obs_dim, num_actions


class Algorithm:
    """Reference: algorithm.py:233 (train/evaluate/save/restore)."""

    def __init__(self, config: AlgorithmConfig):
        self.config = config
        self.iteration = 0
        self._total_steps = 0
        self._episode_returns: list = []
        obs_dim, num_actions = _env_dims(config.env_spec, config.env_config)
        self.module = self._build_module(obs_dim, num_actions)
        self.learner = self._build_learner()
        from ..connectors import default_env_to_module, default_module_to_env
        # Driver-side connector copies for evaluate(); runner actors get
        # their own (pickled) stateful copies, so running stats of e.g.
        # NormalizeObservations are per-runner, as in the reference.
        self._e2m = (config.env_to_module_connector()
                     if config.env_to_module_connector
                     else default_env_to_module())
        self._m2e = (config.module_to_env_connector()
                     if config.module_to_env_connector
                     else default_module_to_env())
        if config.num_env_runners > 0:
            self.env_runner_group = EnvRunnerGroup(
                config.env_spec, config.env_config, self.module,
                num_env_runners=config.num_env_runners, seed=config.seed,
                env_to_module=self._e2m, module_to_env=self._m2e)
            if self.learner is not None:
                self.env_runner_group.sync_weights(
                    self.learner.get_weights())
        else:
            # Offline algorithms (BC/MARWIL) train from datasets; no
            # sampling actors (reference: offline algos run without
            # rollout workers).
            self.env_runner_group = None
        # Dedicated evaluation runners (reference: the eval
        # EnvRunnerGroup the Algorithm keeps when
        # evaluation_num_env_runners > 0) — distinct seeds, weights
        # synced right before each eval round.
        if getattr(config, "evaluation_num_env_runners", 0) > 0:
            self.eval_env_runner_group = EnvRunnerGroup(
                config.env_spec, config.env_config, self.module,
                num_env_runners=config.evaluation_num_env_runners,
                seed=config.seed + 10_000,
                env_to_module=self._e2m, module_to_env=self._m2e)
        else:
            self.eval_env_runner_group = None

    # subclass hooks
    def _build_module(self, obs_dim: int, num_actions: int):
        raise NotImplementedError

    def _build_learner(self):
        raise NotImplementedError

    def get_weights(self):
        return self.learner.get_weights()

    def _get_algo_state(self) -> Dict[str, Any]:
        """Extra state beyond the learner's (subclass hook)."""
        return {}

    def _set_algo_state(self, state: Dict[str, Any]) -> None:
        pass

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    # -- public API --------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        result = self.training_step()
        self.iteration += 1
        metrics = self.env_runner_group.collect_metrics() \
            if self.env_runner_group is not None else []
        self._episode_returns.extend(
            m["episode_return"] for m in metrics)
        recent = self._episode_returns[-100:]
        interval = getattr(self.config, "evaluation_interval", 0)
        if interval and self.iteration % interval == 0:
            # Periodic eval nested under result["evaluation"]
            # (reference: Algorithm.train eval rounds). Runs BEFORE the
            # timing update so time_this_iter_s covers it — eval-heavy
            # iterations are the slow ones.
            result["evaluation"] = self.evaluate(
                getattr(self.config, "evaluation_duration", 5))
        result.update({
            "training_iteration": self.iteration,
            "episode_return_mean": float(np.mean(recent)) if recent
            else float("nan"),
            "num_episodes": len(self._episode_returns),
            "num_env_steps_sampled_lifetime": self._total_steps,
            "time_this_iter_s": time.perf_counter() - t0,
        })
        task_fn = getattr(self.config, "env_task_fn", None)
        if task_fn is not None:
            # Curriculum learning (reference: env_task_fn): the task fn
            # sees the iteration result + current task; a CHANGED value
            # is pushed to every env runner via env.set_task().
            cur = getattr(self, "_current_task", None)
            new_task = task_fn(result, cur)
            self._current_task = new_task
            if new_task != cur:
                group = getattr(self, "env_runner_group", None)
                if group is not None and hasattr(group, "set_task"):
                    group.set_task(new_task)
            result["env_task"] = new_task
        return result

    def evaluate(self, num_episodes: int = 5) -> Dict[str, float]:
        """Evaluation round (reference: Algorithm.evaluate): parallel
        episodes on the dedicated eval runner group when configured,
        else greedy rollouts on a fresh driver-side env."""
        # getattr: subclasses with bespoke __init__ (MultiAgentPPO)
        # don't build an eval group.
        if getattr(self, "eval_env_runner_group", None) is not None:
            return self._evaluate_with_runners(num_episodes)
        from ..env.env_runner import _make_env
        env = _make_env(self.config.env_spec, self.config.env_config)
        # Stateful connector pieces (running obs stats) accumulate in the
        # runner actors; merge them onto the driver copy so evaluation
        # normalizes with the stats the policy trained under.
        self._sync_connector_states()

        params = self.get_weights()
        returns = []
        for ep in range(num_episodes):
            # Recurrent modules (DreamerV3) reset rollout state between
            # episodes on the driver too.
            hook = getattr(self.module, "on_episode_end", None)
            if hook is not None:
                hook()
            obs, _ = env.reset(seed=10_000 + ep)
            done, total = False, 0.0
            while not done:
                # Same obs/action pipelines the module trained with.
                act = self._infer_action(obs, params, env.action_space)
                obs, rew, term, trunc, _ = env.step(act)
                total += float(rew)
                done = term or trunc
            returns.append(total)
        env.close()
        return {"evaluation_return_mean": float(np.mean(returns)),
                "evaluation_return_max": float(np.max(returns))}

    def _evaluate_with_runners(self, num_episodes: int) -> Dict[str, float]:
        """Sample the eval group until `num_episodes` episodes finish
        (evaluation_duration unit=episodes, the reference default).
        GREEDY actions (explore=False), trained connector stats pushed
        to the eval runners, and a hard episode reset first so no
        counted return mixes weights from two rounds."""
        import logging
        group = self.eval_env_runner_group
        group.sync_weights(self.get_weights())
        self._sync_connector_states()
        getter = getattr(self._e2m, "get_state", None)
        if getter is not None:
            try:
                group.set_connector_state(getter())
            except Exception:
                # A dead eval runner mid-round: stale stats beat a
                # failed train() — but say so.
                logging.getLogger(__name__).warning(
                    "eval connector-state push failed", exc_info=True)
        group.reset_episodes()
        group.collect_metrics()  # drain episodes from prior rounds
        returns: list = []
        frag = int(self.config.rollout_fragment_length)
        # Step budget scales with the ask: ~4000 steps per requested
        # episode per runner covers gym-length episodes; bounded so a
        # never-terminating env cannot hang train().
        max_rounds = max(8, (num_episodes * 4000) // max(1, frag))
        for _ in range(max_rounds):
            group.sample(frag, explore=False, update_connectors=False)
            for m in group.collect_metrics():
                returns.append(m["episode_return"])
            if len(returns) >= num_episodes:
                break
        if not returns:
            logging.getLogger(__name__).warning(
                "evaluation round finished 0 episodes within %d steps"
                " per runner — episodes longer than the budget?",
                max_rounds * frag)
            return {"evaluation_return_mean": float("nan"),
                    "evaluation_return_max": float("nan"),
                    "evaluation_episodes": 0}
        returns = returns[:num_episodes]
        return {"evaluation_return_mean": float(np.mean(returns)),
                "evaluation_return_max": float(np.max(returns)),
                "evaluation_episodes": len(returns)}

    def save(self, checkpoint_dir: str) -> str:
        os.makedirs(checkpoint_dir, exist_ok=True)
        with open(os.path.join(checkpoint_dir, "algorithm.pkl"), "wb") as f:
            pickle.dump({"learner_state": self.learner.get_state()
                         if self.learner is not None else None,
                         "iteration": self.iteration,
                         "total_steps": self._total_steps,
                         **self._get_algo_state()}, f)
        return checkpoint_dir

    def restore(self, checkpoint_dir: str):
        with open(os.path.join(checkpoint_dir, "algorithm.pkl"), "rb") as f:
            st = pickle.load(f)
        if self.learner is not None and st.get("learner_state") is not None:
            self.learner.set_state(st["learner_state"])
        self._set_algo_state(st)
        self.iteration = st["iteration"]
        self._total_steps = st["total_steps"]
        if self.env_runner_group is not None:
            self.env_runner_group.sync_weights(self.get_weights())

    def _sync_connector_states(self):
        """Merge runner-side stateful connector stats (running obs
        normalization etc.) onto the driver copies."""
        if self.env_runner_group is None:
            return
        try:
            states = self.env_runner_group.connector_states()
            if hasattr(self._e2m, "merge_and_set_states"):
                self._e2m.merge_and_set_states(states)
            elif hasattr(self._e2m, "set_state") and states:
                self._e2m.set_state(states[0])
        except Exception as e:
            import logging
            logging.getLogger(__name__).warning(
                "connector state sync from runners failed (%s); using "
                "driver-local stats.", e)

    def _cached_action_space(self):
        if not hasattr(self, "_action_space_cache"):
            from ..env.env_runner import _make_env
            env = _make_env(self.config.env_spec, self.config.env_config)
            self._action_space_cache = env.action_space
            env.close()
        return self._action_space_cache

    def _infer_action(self, observation, params, action_space,
                      explore: bool = False):
        """One observation through e2m -> forward -> m2e (shared by
        evaluate() and compute_single_action)."""
        obs_b = self._e2m(
            {"obs": np.asarray(observation, np.float32)[None]},
            module=self.module, update=False)["obs"]
        if explore:
            if not hasattr(self, "_explore_rng"):
                self._explore_rng = np.random.default_rng(
                    self.config.seed)
            action, _ = self.module.forward_exploration(
                params, obs_b, self._explore_rng)
        else:
            action = self.module.forward_inference(params, obs_b)
        out = self._m2e({"actions": action}, action_space=action_space,
                        module=self.module)
        env_actions = out.get("env_actions", out["actions"])
        if getattr(self.module, "discrete", True):
            return int(np.asarray(env_actions[0]).item())
        return np.asarray(env_actions[0], np.float32)

    def compute_single_action(self, observation, explore: bool = False):
        """Single-observation inference through the SAME connector
        pipelines training used (reference:
        Algorithm.compute_single_action)."""
        # Runner connector stats change only when training steps run:
        # sync once per iteration, not per action (the fan-out to the
        # runner actors would dominate a rollout loop).
        if getattr(self, "_conn_synced_iter", None) != self.iteration:
            self._sync_connector_states()
            self._conn_synced_iter = self.iteration
        # Device-resident params: a full device->host weights copy per
        # action would dominate the call.
        params = (self.learner.params if self.learner is not None
                  else self.get_weights())
        return self._infer_action(observation, params,
                                  self._cached_action_space(), explore)

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str,
                        config: "AlgorithmConfig") -> "Algorithm":
        """Build + restore in one step (reference:
        Algorithm.from_checkpoint)."""
        algo = config.build()
        try:
            if cls is not Algorithm and not isinstance(algo, cls):
                raise TypeError(
                    f"{cls.__name__}.from_checkpoint got a config "
                    f"building {type(algo).__name__}; call "
                    f"{type(algo).__name__}.from_checkpoint (or pass "
                    f"the matching config).")
            algo.restore(checkpoint_dir)
        except BaseException:
            algo.stop()  # never leak the just-built runner actors
            raise
        return algo

    def stop(self):
        if self.env_runner_group is not None:
            self.env_runner_group.stop()
        if getattr(self, "eval_env_runner_group", None) is not None:
            self.eval_env_runner_group.stop()

    # Tune integration: Algorithm is usable as a trainable
    # (reference: Algorithm IS a Trainable).
    def step(self) -> Dict[str, Any]:
        return self.train()
