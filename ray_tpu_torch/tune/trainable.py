"""Trainable interfaces: function API and class API.

Reference parity: python/ray/tune/trainable/ — the function trainable
(fn(config) calling tune.report) and the Trainable class
(setup/step/save_checkpoint/load_checkpoint, trainable.py). Class
trainables are adapted onto the function path so the trial actor runs a
single code path.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Callable, Dict, Optional

from ..train.checkpoint import Checkpoint
from . import session


class Trainable:
    """Class API (reference: tune/trainable/trainable.py Trainable)."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = config or {}
        self.training_iteration = 0
        self.setup(self.config)

    def setup(self, config: Dict[str, Any]):
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[str]:
        return None

    def load_checkpoint(self, checkpoint_dir: str):
        pass

    def cleanup(self):
        pass


def wrap_trainable(trainable) -> Callable[[Dict], None]:
    """Normalize a function or Trainable subclass into fn(config)."""
    if isinstance(trainable, type) and issubclass(trainable, Trainable):
        cls = trainable

        def _run_class(config: Dict[str, Any]):
            obj = cls(config=config)
            try:
                ckpt = session.get_checkpoint()
                if ckpt is not None:
                    obj.load_checkpoint(ckpt.path)
                    # Restore the iteration counter alongside model state so
                    # a retried trial continues counting (and its stop
                    # condition / scheduler rungs) where it left off
                    # (reference: Trainable.restore, tune/trainable/).
                    meta_path = os.path.join(ckpt.path, ".tune_metadata")
                    if os.path.exists(meta_path):
                        import json
                        with open(meta_path) as f:
                            obj.training_iteration = json.load(f).get(
                                "training_iteration", 0)
                while True:
                    result = obj.step()
                    obj.training_iteration += 1
                    result.setdefault("training_iteration",
                                      obj.training_iteration)
                    ckpt_dir = tempfile.mkdtemp(prefix="trainable_ckpt_")
                    try:
                        saved = obj.save_checkpoint(ckpt_dir)
                        meta_dir = saved if isinstance(saved, str) \
                            else ckpt_dir
                        if saved or os.listdir(ckpt_dir):
                            import json
                            with open(os.path.join(
                                    meta_dir, ".tune_metadata"), "w") as f:
                                json.dump({"training_iteration":
                                           obj.training_iteration}, f)
                            # session.report copies the dir into the trial
                            # dir, so the temp original is always removable.
                            session.report(
                                result,
                                checkpoint=Checkpoint.from_directory(
                                    saved if isinstance(saved, str)
                                    else ckpt_dir))
                        else:
                            session.report(result)
                    finally:
                        import shutil
                        shutil.rmtree(ckpt_dir, ignore_errors=True)
                    if result.get("done"):
                        break
            finally:
                obj.cleanup()

        _run_class.__name__ = cls.__name__
        return _run_class
    if callable(trainable):
        return trainable
    raise TypeError(f"Not a trainable: {trainable!r}")


def with_parameters(trainable, **kwargs):
    """Bind large constant objects to a trainable (reference:
    tune/trainable/util.py tune.with_parameters). Function trainables get
    the kwargs appended to the call; Trainable subclasses get them passed
    to ``setup(config, **kwargs)``, reference-identical."""
    if isinstance(trainable, type) and issubclass(trainable, Trainable):
        base = trainable

        class _ParamBound(base):
            def setup(self, config):
                base.setup(self, config, **kwargs)

        _ParamBound.__name__ = base.__name__
        _ParamBound.__qualname__ = base.__qualname__
        return _ParamBound
    fn = wrap_trainable(trainable)

    def _bound(config):
        return fn(config, **kwargs)

    _bound.__name__ = getattr(fn, "__name__", "trainable")
    return _bound


def with_resources(trainable, resources: Dict[str, float]):
    """Attach a per-trial resource request (reference: tune.with_resources)."""
    fn = wrap_trainable(trainable)
    fn.__tune_resources__ = dict(resources)
    return fn
