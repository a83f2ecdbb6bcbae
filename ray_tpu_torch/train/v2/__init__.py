"""Train v2: decoupled controller execution (reference:
python/ray/train/v2/_internal/execution/ — controller/controller.py:91
TrainController state machine, scaling_policy/, failure_handling/).

The v1 `.fit()` surface delegates here: a TrainController drives worker
groups through an explicit state machine with pluggable scaling and
failure policies, enabling elastic restart (resize the gang to what the
cluster can currently schedule) instead of v1's fixed-size retry loop.
"""

from .controller import TrainController, TrainControllerState  # noqa: F401
from .failure_policy import FailureDecision, FailurePolicy  # noqa: F401
from .scaling_policy import (  # noqa: F401
    ElasticScalingPolicy,
    FixedScalingPolicy,
    ResizeDecision,
    ScalingPolicy,
)

__all__ = [
    "ElasticScalingPolicy", "FailureDecision", "FailurePolicy",
    "FixedScalingPolicy", "ResizeDecision", "ScalingPolicy",
    "TrainController", "TrainControllerState",
]
