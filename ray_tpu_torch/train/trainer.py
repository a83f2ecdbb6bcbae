"""Trainers: the `.fit()` surface.

Reference parity: train/base_trainer.py:649 BaseTrainer.fit +
train/data_parallel_trainer.py:429 DataParallelTrainer.training_loop +
the controller state machine of train v2
(v2/_internal/execution/controller/controller.py:91), collapsed into a
polling loop with failure-retry: create worker gang -> run loop ->
aggregate reports/checkpoints -> on worker failure, restart the gang from
the latest checkpoint up to FailureConfig.max_failures.

`TorchTrainer` is the port's device trainer: its backend hook builds a
torch.distributed process group, NCCL between workers pinned to one GPU
each when ``ScalingConfig.use_gpu`` is set, gloo otherwise.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from .. import api
from .backend import BackendConfig, TorchBackendConfig
from .checkpoint import Checkpoint, CheckpointManager
from .config import RunConfig, ScalingConfig


@dataclass
class Result:
    """(reference: python/ray/air/result.py Result)"""

    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    path: str
    error: Optional[BaseException] = None
    metrics_dataframe: Optional[Any] = None

    @property
    def best_checkpoints(self):
        return [(self.checkpoint, self.metrics)] if self.checkpoint else []


class BaseTrainer:
    """(reference: train/base_trainer.py BaseTrainer)"""

    def __init__(self, *, scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 datasets: Optional[Dict[str, Any]] = None):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint
        self.datasets = datasets or {}

    def fit(self) -> Result:
        raise NotImplementedError

    def as_trainable(self) -> Callable:
        """Wrap for the Tune controller (reference: base_trainer.py:901):
        returns a function trainable running this trainer's loop with
        per-trial config merged in."""
        trainer = self

        def _trainable(config: Dict):
            import copy
            t = copy.copy(trainer)
            merged = dict(getattr(trainer, "train_loop_config", None) or {})
            merged.update(config or {})
            t.train_loop_config = merged
            result = t.fit()
            if result.error is not None:
                raise result.error
            return result.metrics

        _trainable.__name__ = type(self).__name__
        return _trainable


class DataParallelTrainer(BaseTrainer):
    """(reference: train/data_parallel_trainer.py DataParallelTrainer)

    Runs `train_loop_per_worker` on `scaling_config.num_workers` actor
    processes; the backend hook wires the device runtime; reports and
    checkpoints flow back to the controller.
    """

    def __init__(self, train_loop_per_worker: Callable, *,
                 train_loop_config: Optional[Dict] = None,
                 backend_config: Optional[BackendConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 datasets: Optional[Dict[str, Any]] = None):
        super().__init__(scaling_config=scaling_config,
                         run_config=run_config,
                         resume_from_checkpoint=resume_from_checkpoint,
                         datasets=datasets)
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.backend_config = backend_config or BackendConfig()

    # ------------------------------------------------------------------
    def _experiment_paths(self):
        name = self.run_config.name or \
            f"{type(self).__name__}_{time.strftime('%Y%m%d_%H%M%S')}"
        exp_dir = os.path.join(self.run_config.resolved_storage_path(),
                               name)
        os.makedirs(exp_dir, exist_ok=True)
        return name, exp_dir

    def _split_datasets(self, num_workers: int
                        ) -> Optional[List[Dict[str, Any]]]:
        """Shard datasets across workers (reference:
        train/_internal/data_config.py DataConfig.configure)."""
        if not self.datasets:
            return None
        shards: List[Dict[str, Any]] = [dict() for _ in range(num_workers)]
        for key, ds in self.datasets.items():
            if hasattr(ds, "streaming_split"):
                try:
                    splits = ds.streaming_split(num_workers)
                except Exception:
                    splits = [ds] * num_workers
                for i in range(num_workers):
                    shards[i][key] = splits[i]
            elif isinstance(ds, (list, tuple)):
                for i in range(num_workers):
                    shards[i][key] = list(ds[i::num_workers])
            else:
                for i in range(num_workers):
                    shards[i][key] = ds
        return shards

    def fit(self) -> Result:
        """Delegates to the train-v2 TrainController state machine
        (reference: v2/_internal/execution/controller/controller.py:91) —
        Fixed or Elastic scaling policy per ScalingConfig, FailurePolicy
        from FailureConfig, checkpoints through the CheckpointManager."""
        from .v2 import (ElasticScalingPolicy, FailurePolicy,
                         FixedScalingPolicy, TrainController)
        if not api.is_initialized():
            api.init(ignore_reinit_error=True)
        name, exp_dir = self._experiment_paths()
        ckpt_cfg = self.run_config.checkpoint_config
        manager = CheckpointManager(
            os.path.join(exp_dir, "checkpoints"),
            num_to_keep=ckpt_cfg.num_to_keep,
            score_attribute=ckpt_cfg.checkpoint_score_attribute,
            score_order=ckpt_cfg.checkpoint_score_order)
        if self.scaling_config.elastic:
            scaling_policy = ElasticScalingPolicy(
                self.scaling_config,
                min_workers=self.scaling_config.min_workers,
                max_workers=self.scaling_config.max_workers)
        else:
            scaling_policy = FixedScalingPolicy(self.scaling_config)
        controller = TrainController(
            train_fn=self.train_loop_per_worker,
            train_fn_config=self.train_loop_config,
            scaling_policy=scaling_policy,
            failure_policy=FailurePolicy(self.run_config.failure_config),
            backend_config=self.backend_config,
            checkpoint_manager=manager,
            experiment_name=name,
            experiment_dir=exp_dir,
            resume_from_checkpoint=self.resume_from_checkpoint,
            dataset_splitter=self._split_datasets,
            checkpoint_adopter=self._adopt_checkpoint)
        self._controller = controller  # exposed for tests/introspection
        metrics, checkpoint, error = controller.run()
        return Result(metrics=metrics, checkpoint=checkpoint,
                      path=exp_dir, error=error)

    @staticmethod
    def _adopt_checkpoint(manager: CheckpointManager,
                          ckpt: Checkpoint) -> Checkpoint:
        if os.path.commonpath(
                [manager.storage_path,
                 os.path.abspath(ckpt.path)]) == manager.storage_path:
            return ckpt
        dst = manager.next_checkpoint_path()
        shutil.copytree(ckpt.path, dst, dirs_exist_ok=True)
        shutil.rmtree(ckpt.path, ignore_errors=True)
        return Checkpoint(dst)


class TorchTrainer(DataParallelTrainer):
    """Reference: train/torch/torch_trainer.py TorchTrainer, the port's
    counterpart of the JAX package's JaxTrainer. Runs the user loop with a
    torch.distributed process group across the workers (torch/config.py:156
    on_start): NCCL when ``scaling_config.use_gpu`` is set (each worker
    pinned to its own GPU, its ``cuda:0``), gloo otherwise, unless
    ``torch_config.backend`` names one."""

    def __init__(self, train_loop_per_worker: Callable, *,
                 torch_config: Optional[TorchBackendConfig] = None,
                 **kwargs):
        kwargs.pop("backend_config", None)
        cfg = torch_config or TorchBackendConfig()
        if cfg.backend is None:
            scaling = kwargs.get("scaling_config") or ScalingConfig()
            cfg = dataclasses.replace(
                cfg, backend="nccl" if scaling.use_gpu else "gloo")
        super().__init__(train_loop_per_worker, backend_config=cfg,
                         **kwargs)


class TensorflowTrainer(DataParallelTrainer):
    """Reference: train/tensorflow/tensorflow_trainer.py. The backend
    writes TF_CONFIG (tensorflow/config.py:24-37) so the user loop can
    build a MultiWorkerMirroredStrategy."""

    def __init__(self, train_loop_per_worker: Callable, *,
                 tensorflow_config=None, **kwargs):
        from .backend import TensorflowBackendConfig
        kwargs.pop("backend_config", None)
        super().__init__(
            train_loop_per_worker,
            backend_config=tensorflow_config or TensorflowBackendConfig(),
            **kwargs)


class HorovodTrainer(DataParallelTrainer):
    """Reference: train/horovod/horovod_trainer.py (gated: horovod is not
    in this image; see HorovodBackendConfig)."""

    def __init__(self, train_loop_per_worker: Callable, *,
                 horovod_config=None, **kwargs):
        from .backend import HorovodBackendConfig
        kwargs.pop("backend_config", None)
        super().__init__(
            train_loop_per_worker,
            backend_config=horovod_config or HorovodBackendConfig(),
            **kwargs)
