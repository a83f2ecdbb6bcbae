"""ray_tpu_torch.tune: hyperparameter tuning over trial actors.

Reference parity: python/ray/tune (Tuner.fit tuner.py:344, TuneController
event loop execution/tune_controller.py:68, searchers tune/search/,
schedulers tune/schedulers/). Trials are actor processes; GPU trials
reserve cards through the same resource scheduler as everything else
(``num_gpus``, pinned through ``CUDA_VISIBLE_DEVICES``), so a
`tune.with_resources(fn, {"GPU": 1})` sweep time-shares the cards.
"""

from ..train.config import CheckpointConfig, FailureConfig, RunConfig
from .result_grid import Result, ResultGrid
from .schedulers import (
    AsyncHyperBandScheduler,
    FIFOScheduler,
    HyperBandForBOHB,
    HyperBandScheduler,
    MedianStoppingRule,
    PB2,
    PopulationBasedTraining,
    ResourceChangingScheduler,
    TrialScheduler,
)
from .search import (
    choice,
    grid_search,
    loguniform,
    qrandint,
    quniform,
    randint,
    sample_from,
    uniform,
)
from .searchers import (
    AxSearch,
    ConcurrencyLimiter,
    HEBOSearch,
    HyperOptSearch,
    NevergradSearch,
    OptunaSearch,
    RandomSearch,
    Searcher,
    TPESearcher,
    TuneBOHB,
    ZOOptSearch,
)
from .session import (get_checkpoint, get_trial_dir, get_trial_id,
                      get_trial_resources, report)
from .trainable import Trainable, with_parameters, with_resources
from .tuner import TuneConfig, Tuner

ASHAScheduler = AsyncHyperBandScheduler  # reference alias (tune.schedulers)

__all__ = [
    "ASHAScheduler", "AsyncHyperBandScheduler", "CheckpointConfig",
    "FIFOScheduler", "FailureConfig", "HyperBandScheduler",
    "HyperBandForBOHB", "MedianStoppingRule", "PB2",
    "PopulationBasedTraining", "ResourceChangingScheduler", "Result",
    "ResultGrid", "TuneBOHB", "get_trial_resources",
    "RunConfig", "Trainable", "TrialScheduler", "TuneConfig", "Tuner",
    "choice", "get_checkpoint", "get_trial_dir", "get_trial_id",
    "grid_search", "loguniform", "qrandint", "quniform", "randint",
    "report", "sample_from", "uniform", "with_parameters",
    "with_resources",
]
