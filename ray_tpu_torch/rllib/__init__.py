"""ray_tpu_torch.rllib — reinforcement learning on the card.

Reference parity: rllib/ (SURVEY §2.5) — Algorithm/AlgorithmConfig,
EnvRunnerGroup of sampling actors, a Learner, the RLModule model
abstraction; PPO (feed-forward, recurrent, multi-agent), DQN, IMPALA/APPO
(V-trace off-policy correction) and BC/MARWIL. Ported from the JAX
package's ``ray_tpu/rllib``: the modules are torch networks over param
dicts that mirror the flax trees (``core/convert.py`` carries them
across), the ``TorchLearner`` runs on ``AlgorithmConfig.learners(
device=...)`` (None: the CUDA card), and the env runners are zero-GPU
actors of the port's own control plane that run their forward on the
CPU. SAC, TD3, CQL and DreamerV3 are not ported yet.
"""
from .algorithms.algorithm import Algorithm, AlgorithmConfig
from .algorithms.bc import BC, BCConfig, MARWIL, MARWILConfig
from .algorithms.dqn import DQN, DQNConfig
from .algorithms.impala import APPO, APPOConfig, IMPALA, IMPALAConfig, vtrace
from .algorithms.multi_agent_ppo import MultiAgentPPO, MultiAgentPPOConfig
from .algorithms.ppo import PPO, PPOConfig
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
           "BCConfig", "Catalog", "ConnectorPipelineV2", "ConnectorV2",
           "DQN", "DQNConfig", "DQNModule",
           "DatasetReader", "EnvRunnerGroup", "IMPALA", "IMPALAConfig",
           "ImportanceSamplingEstimator", "MARWIL", "MARWILConfig",
           "MultiAgentEnv", "MultiAgentEnvRunner",
           "MultiAgentEnvRunnerGroup", "MultiAgentPPO",
           "MultiAgentPPOConfig", "MultiRLModule", "PPO", "PPOConfig",
           "PPOModule", "PrioritizedReplayBuffer", "RLModule",
           "RecurrentPPOModule", "ReplayBuffer", "SACModule",
           "SampleWriter", "Scheduler", "SingleAgentEnvRunner",
           "TorchLearner", "vtrace"]
