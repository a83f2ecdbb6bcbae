"""ray_tpu_torch.rllib — reinforcement learning on the card.

Reference parity: rllib/ (SURVEY §2.5) — Algorithm/AlgorithmConfig,
EnvRunnerGroup of sampling actors, a Learner, the RLModule model
abstraction; PPO (feed-forward, recurrent, multi-agent), DQN, IMPALA/APPO
(V-trace off-policy correction), BC/MARWIL, SAC, TD3, CQL (offline) and
DreamerV3 (model-based). Ported from the JAX package's
``ray_tpu/rllib``: the modules are torch networks over param dicts that
mirror the flax trees (``core/convert.py`` carries them across), the
updates run on ``AlgorithmConfig.learners(device=...)`` (None: the CUDA
card) — the ``TorchLearner``'s, or for SAC, TD3, CQL and DreamerV3 their
own with bare Adam states (``core/optim.py``) and their noise drawn from
a ``torch.Generator`` on that device — and the env runners are zero-GPU
actors of the port's own control plane that run their forward on the
CPU.
"""
from .algorithms.algorithm import Algorithm, AlgorithmConfig
from .algorithms.bc import BC, BCConfig, MARWIL, MARWILConfig
from .algorithms.cql import CQL, CQLConfig
from .algorithms.dqn import DQN, DQNConfig
from .algorithms.dreamerv3 import DreamerV3, DreamerV3Config
from .algorithms.impala import APPO, APPOConfig, IMPALA, IMPALAConfig, vtrace
from .algorithms.multi_agent_ppo import MultiAgentPPO, MultiAgentPPOConfig
from .algorithms.ppo import PPO, PPOConfig
from .algorithms.sac import SAC, SACConfig
from .algorithms.td3 import TD3, TD3Config
from .connectors import ConnectorPipelineV2, ConnectorV2
from .core.catalog import Catalog
from .core.learner import TorchLearner
from .core.rl_module import (DQNModule, MultiRLModule, PPOModule,
                             RecurrentPPOModule, RLModule, SACModule)
from .env.env_runner import EnvRunnerGroup, SingleAgentEnvRunner
from .env.multi_agent import (MultiAgentEnv, MultiAgentEnvRunner,
                              MultiAgentEnvRunnerGroup)
from .offline import (DatasetReader, ImportanceSamplingEstimator,
                      SampleWriter)
from .utils.replay_buffers import (PrioritizedReplayBuffer,
                                   ReplayBuffer)
from .utils.schedules import Scheduler

__all__ = ["APPO", "APPOConfig", "Algorithm", "AlgorithmConfig", "BC",
           "BCConfig", "CQL", "CQLConfig", "Catalog",
           "ConnectorPipelineV2", "ConnectorV2", "DQN", "DQNConfig",
           "DQNModule", "DreamerV3", "DreamerV3Config",
           "DatasetReader", "EnvRunnerGroup", "IMPALA", "IMPALAConfig",
           "ImportanceSamplingEstimator", "MARWIL", "MARWILConfig",
           "MultiAgentEnv", "MultiAgentEnvRunner",
           "MultiAgentEnvRunnerGroup", "MultiAgentPPO",
           "MultiAgentPPOConfig", "MultiRLModule", "PPO", "PPOConfig",
           "PPOModule", "PrioritizedReplayBuffer", "RLModule",
           "RecurrentPPOModule", "ReplayBuffer", "SAC", "SACConfig",
           "SACModule", "SampleWriter", "Scheduler",
           "SingleAgentEnvRunner", "TD3", "TD3Config", "TorchLearner",
           "vtrace"]
