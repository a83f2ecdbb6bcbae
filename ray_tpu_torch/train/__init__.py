"""ray_tpu_torch.train: distributed training orchestration (Train-equivalent).

The port's copy of the JAX package's Train (reference parity, SURVEY.md
§2.5 Ray Train): the DataParallelTrainer contract (`train_loop_per_worker`,
ScalingConfig, report/get_checkpoint), backend hooks, directory
checkpoints, the failure-retry controller. The device boundary is a
torch.distributed process group: NCCL between workers pinned to one GPU
each, gloo on the CPU.

    from ray_tpu_torch import train
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    def train_loop(config):
        ...
        train.report({"loss": loss}, checkpoint=ckpt)

    result = TorchTrainer(
        train_loop,
        scaling_config=ScalingConfig(num_workers=4, use_gpu=True),
    ).fit()

The gradient-boosted-tree trainers (``gbdt.py``) need xgboost or
lightgbm, and raise ImportError without them. ``TorchTrainer`` and
``TorchBackendConfig`` stand where the JAX package has ``JaxTrainer``
and ``JaxBackendConfig``.
"""

from .backend import (BackendConfig, HorovodBackendConfig,
                      TensorflowBackendConfig, TorchBackendConfig)
from .checkpoint import Checkpoint, CheckpointManager
from .config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from .session import (
    get_checkpoint,
    get_context,
    get_dataset_shard,
    get_world_rank,
    get_world_size,
    report,
)
from .trainer import (
    BaseTrainer,
    DataParallelTrainer,
    HorovodTrainer,
    Result,
    TensorflowTrainer,
    TorchTrainer,
)
from .gbdt import LightGBMTrainer, XGBoostTrainer

__all__ = [
    "BackendConfig", "BaseTrainer", "Checkpoint", "CheckpointConfig",
    "CheckpointManager", "DataParallelTrainer", "FailureConfig",
    "HorovodBackendConfig", "HorovodTrainer", "LightGBMTrainer", "Result",
    "RunConfig", "ScalingConfig", "TensorflowBackendConfig",
    "TensorflowTrainer",
    "TorchBackendConfig", "TorchTrainer", "XGBoostTrainer",
    "get_checkpoint", "get_context", "get_dataset_shard",
    "get_world_rank", "get_world_size", "report",
]
