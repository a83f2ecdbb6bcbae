"""Worker-side train session: report / get_checkpoint / context.

Reference parity: python/ray/train/_internal/session.py (report :405,672,
get_checkpoint :786, TrainContext). The session is process-global inside a
training worker; `report()` hands metrics+checkpoint to the driver-side
controller through the worker's report buffer.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .checkpoint import Checkpoint


@dataclass
class TrainContext:
    world_size: int = 1
    world_rank: int = 0
    local_rank: int = 0
    node_rank: int = 0
    trial_name: str = ""
    experiment_name: str = ""
    storage_path: str = ""


class _Session:
    def __init__(self, context: TrainContext,
                 checkpoint: Optional[Checkpoint] = None,
                 dataset_shards: Optional[Dict[str, Any]] = None):
        self.context = context
        self.restore_checkpoint = checkpoint
        self.dataset_shards = dataset_shards or {}
        self.reports: List[Dict] = []
        self.lock = threading.Lock()
        self.finished = False

    def report(self, metrics: Dict, checkpoint: Optional[Checkpoint]):
        with self.lock:
            self.reports.append({
                "metrics": dict(metrics),
                "checkpoint": checkpoint,
            })

    def drain(self) -> List[Dict]:
        with self.lock:
            out = self.reports
            self.reports = []
            return out


_session: Optional[_Session] = None


def _set_session(s: Optional[_Session]):
    global _session
    _session = s


def _get_session() -> _Session:
    if _session is None:
        raise RuntimeError(
            "Not inside a training worker; train.report()/get_checkpoint() "
            "only work inside train_loop_per_worker.")
    return _session


# -- public api (reference: ray.train.report / get_checkpoint / ...) -------
def report(metrics: Dict, *, checkpoint: Optional[Checkpoint] = None):
    """Report metrics (+ optional checkpoint) to the controller
    (reference: session.py:405)."""
    _get_session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    """Latest checkpoint to resume from (reference: session.py:786)."""
    return _get_session().restore_checkpoint


def get_context() -> TrainContext:
    return _get_session().context


def get_dataset_shard(name: str = "train"):
    """This worker's dataset shard (reference: session get_dataset_shard)."""
    return _get_session().dataset_shards.get(name)


def get_world_size() -> int:
    return _get_session().context.world_size


def get_world_rank() -> int:
    return _get_session().context.world_rank
