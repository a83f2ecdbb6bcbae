"""Train/AIR config objects (reference: python/ray/air/config.py —
ScalingConfig, RunConfig, FailureConfig :397, CheckpointConfig)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class ScalingConfig:
    """How many workers and what each reserves (reference:
    air/config.py ScalingConfig). ``use_gpu`` reserves one GPU a worker,
    which the scheduler pins through ``CUDA_VISIBLE_DEVICES``, and makes
    ``TorchTrainer``'s process group NCCL."""

    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    # Elastic bounds (train v2): when min_workers is set, restarts size
    # the gang to what the cluster can schedule in [min, max] instead of
    # blocking on num_workers (v2 scaling_policy ElasticScalingPolicy).
    min_workers: Optional[int] = None
    max_workers: Optional[int] = None

    @property
    def elastic(self) -> bool:
        return self.min_workers is not None

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        if "CPU" not in res:
            res["CPU"] = 1.0
        if self.use_gpu and "GPU" not in res:
            res["GPU"] = 1.0
        return res


@dataclass
class FailureConfig:
    """(reference: air/config.py:397 FailureConfig.max_failures)"""

    max_failures: int = 0


@dataclass
class CheckpointConfig:
    """(reference: air/config.py CheckpointConfig)"""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0


@dataclass
class RunConfig:
    """(reference: air/config.py RunConfig)"""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(
        default_factory=CheckpointConfig)
    verbose: int = 1
    # Stop conditions for tune trials, e.g. {"training_iteration": 10}
    # (reference: air.RunConfig(stop=...)).
    stop: Optional[Dict[str, float]] = None

    def resolved_storage_path(self) -> str:
        base = self.storage_path or os.path.expanduser(
            "~/ray_tpu_torch_results")
        return base
