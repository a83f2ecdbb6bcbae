"""Worker-side tune session: report / get_checkpoint inside a trial.

Reference parity: python/ray/tune's session (tune.report / train.report
from within a trial, _internal/session.py) — process-global state bound
while the trial function runs in its trial actor. Checkpoints persist
into the trial directory (shared filesystem) as
``checkpoint_{iter:06d}`` dirs, the reference's storage layout.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Dict, List, Optional

from ..train.checkpoint import Checkpoint


class TrialStopSignal(SystemExit):
    """Raised inside report() when the controller asked the trial to stop.
    Subclasses SystemExit so user try/except Exception blocks don't
    swallow it (the reference uses a similar interrupt path)."""


class _TuneSession:
    def __init__(self, trial_id: str, trial_dir: str,
                 restore_checkpoint: Optional[Checkpoint] = None,
                 stop_conditions: Optional[Dict[str, float]] = None):
        self.trial_id = trial_id
        self.trial_dir = trial_dir
        self.restore_checkpoint = restore_checkpoint
        # Evaluated locally at every report so fast trial loops cannot
        # overshoot the controller's async stop request (reference:
        # RunConfig(stop=...) semantics).
        self.stop_conditions = dict(stop_conditions or {})
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.buffer: List[Dict] = []
        # Back-pressure: report() blocks while the buffer is full, so the
        # controller's scheduler decisions (ASHA rung cuts etc.) apply
        # before the trial races ahead (reference: the function-trainable
        # size-1 results queue in tune/trainable/function_trainable.py).
        self.max_buffered = 1
        self.stop_requested = False
        self.iteration = 0

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None):
        self.iteration += 1
        rec: Dict[str, Any] = {"metrics": dict(metrics)}
        rec["metrics"].setdefault("training_iteration", self.iteration)
        if checkpoint is not None:
            dst = os.path.join(self.trial_dir,
                               f"checkpoint_{self.iteration:06d}")
            if os.path.abspath(checkpoint.path) != dst:
                shutil.copytree(checkpoint.path, dst, dirs_exist_ok=True)
            rec["checkpoint_path"] = dst
        with self.cond:
            while (len(self.buffer) >= self.max_buffered
                   and not self.stop_requested):
                self.cond.wait(timeout=1.0)
            self.buffer.append(rec)
            stop = self.stop_requested
        m = rec["metrics"]
        if any(k in m and m[k] >= v
               for k, v in self.stop_conditions.items()):
            stop = True
        if stop:
            raise TrialStopSignal(0)

    def drain(self) -> List[Dict]:
        with self.cond:
            out = self.buffer
            self.buffer = []
            self.cond.notify_all()
            return out

    def request_stop(self):
        with self.cond:
            self.stop_requested = True
            self.cond.notify_all()


_session: Optional[_TuneSession] = None


def _set_session(s: Optional[_TuneSession]):
    global _session
    _session = s


def get_session() -> Optional[_TuneSession]:
    return _session


def report(metrics: Dict[str, Any],
           *, checkpoint: Optional[Checkpoint] = None):
    """Report metrics (and optionally a checkpoint) from inside a trial
    (reference: tune.report / ray.train.report)."""
    s = _session
    if s is None:
        raise RuntimeError(
            "tune.report() called outside a tune trial; it is only valid "
            "inside a trainable launched by Tuner.fit()")
    s.report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    """The checkpoint this trial should resume from, if any
    (reference: train.get_checkpoint inside tune trials). A GPU trial's
    actor is pinned to its cards, so ``to_state(map_location="cuda")``
    loads the state onto the trial's own card, whichever card wrote
    it."""
    s = _session
    return s.restore_checkpoint if s else None


def get_trial_id() -> Optional[str]:
    s = _session
    return s.trial_id if s else None


def get_trial_resources() -> Dict[str, Any]:
    """The trial's CURRENT resource allocation (reference:
    tune.get_trial_resources) — changes when a
    ResourceChangingScheduler restarts the trial with a new grant."""
    s = _session
    return dict(getattr(s, "trial_resources", {}) or {}) if s else {}


def get_trial_dir() -> Optional[str]:
    s = _session
    return s.trial_dir if s else None
