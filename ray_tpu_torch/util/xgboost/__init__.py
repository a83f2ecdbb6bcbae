"""(reference: python/ray/util/xgboost/__init__.py — removed in Ray 2.0
in favor of Train's XGBoostTrainer; the parity surface is the same
redirect.)"""

raise DeprecationWarning(
    "ray_tpu_torch.util.xgboost mirrors ray.util.xgboost, which was removed as "
    "of Ray 2.0. Use ray_tpu_torch.train.XGBoostTrainer instead."
)
