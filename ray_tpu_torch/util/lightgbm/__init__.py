"""(reference: python/ray/util/lightgbm/__init__.py — removed in Ray 2.0
in favor of Train's LightGBMTrainer; the parity surface is the same
redirect.)"""

raise DeprecationWarning(
    "ray_tpu_torch.util.lightgbm mirrors ray.util.lightgbm, which was removed "
    "as of Ray 2.0. Use ray_tpu_torch.train.LightGBMTrainer instead."
)
