"""AIR session facade (reference: python/ray/air/session.py).

The reference's `air.session` forwards to whichever library session is
active — a Train worker session or a Tune trial session. Same here:
`report()` prefers the Train worker session when one is bound in this
process, else falls back to the Tune trial session.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..train import session as _train_session
from ..train.checkpoint import Checkpoint


def _in_train_session() -> bool:
    return _train_session._session is not None


def report(metrics: Dict, *, checkpoint: Optional[Checkpoint] = None) -> None:
    if _in_train_session():
        _train_session.report(metrics, checkpoint=checkpoint)
        return
    from ..tune import session as _tune_session

    _tune_session.report(metrics, checkpoint=checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    if _in_train_session():
        return _train_session.get_checkpoint()
    from ..tune import session as _tune_session

    return _tune_session.get_checkpoint()


def get_context() -> Any:
    return _train_session.get_context()


def get_world_size() -> int:
    return _train_session.get_world_size()


def get_world_rank() -> int:
    return _train_session.get_world_rank()


def get_dataset_shard(name: str = "train"):
    return _train_session.get_dataset_shard(name)
