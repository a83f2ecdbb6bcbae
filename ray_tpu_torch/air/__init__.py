"""AIR common layer (reference: python/ray/air/ — SURVEY.md §2.5).

The reference's AIR package holds the config objects, Checkpoint, Result,
and session helpers shared by Train/Tune (air/config.py, air/result.py,
air/session.py). Here those live canonically in `ray_tpu_torch.train` (the
build collapsed AIR into Train); this package is the reference-compatible
import surface.
"""

from ..train.checkpoint import Checkpoint, CheckpointManager
from ..train.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ..train.trainer import Result
from . import session

__all__ = [
    "Checkpoint",
    "CheckpointManager",
    "CheckpointConfig",
    "FailureConfig",
    "RunConfig",
    "Result",
    "ScalingConfig",
    "session",
]
