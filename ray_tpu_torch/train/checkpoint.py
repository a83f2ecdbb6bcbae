"""Checkpoints: directories on a filesystem (reference:
python/ray/train/_checkpoint.py:56 Checkpoint — "a directory on a
pyarrow.fs.FileSystem"; manager parity: _internal/checkpoint_manager.py).

``from_state/to_state`` keep a train state, a tree (dicts, lists,
tuples) of tensors plus the optimizer's ``state_dict``, through
``torch.save``/``torch.load`` with CPU copies on disk; arbitrary user
files work like the reference (from_directory).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

STATE_FILE = "state.pt"


def _to_cpu(node: Any) -> Any:
    """CPU copies of every tensor in a tree; an optimizer becomes its
    ``state_dict()``, a numpy array a tensor."""
    import numpy as np
    import torch

    if isinstance(node, torch.Tensor):
        return node.detach().cpu().clone()
    if isinstance(node, torch.optim.Optimizer):
        return _to_cpu(node.state_dict())
    if isinstance(node, np.ndarray):
        return torch.from_numpy(np.array(node, copy=True))
    if isinstance(node, dict):
        return {k: _to_cpu(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_to_cpu(v) for v in node)
    return node


class Checkpoint:
    """A checkpoint == a directory (reference: _checkpoint.py:56)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def to_directory(self, path: Optional[str] = None) -> str:
        """Materialize into `path` (copy); returns the directory."""
        if path is None:
            path = tempfile.mkdtemp(prefix="ckpt_")
        if os.path.abspath(path) != self.path:
            shutil.copytree(self.path, path, dirs_exist_ok=True)
        return path

    def as_directory(self):
        """Context manager over the local directory (reference parity)."""
        import contextlib

        @contextlib.contextmanager
        def _cm():
            yield self.path

        return _cm()

    # -- torch train state -------------------------------------------------
    @classmethod
    def from_state(cls, state: Any, path: str) -> "Checkpoint":
        """Write a train state: a tree of tensors (on any device; CPU
        copies go to disk), optimizers as their ``state_dict()``, numpy
        arrays as tensors, plain Python values as they are."""
        import torch

        os.makedirs(path, exist_ok=True)
        torch.save(_to_cpu(state), os.path.join(path, STATE_FILE))
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"format": "rtt_state_v1"}, f)
        return cls(path)

    def to_state(self, map_location: Any = "cpu") -> Any:
        """The state ``from_state`` wrote, its tensors on ``map_location``
        (an optimizer comes back as its ``state_dict``, for
        ``load_state_dict``). Loads tensors and plain values only."""
        import torch

        return torch.load(os.path.join(self.path, STATE_FILE),
                          map_location=map_location, weights_only=True)

    def __repr__(self):
        return f"Checkpoint({self.path})"

    def __reduce__(self):
        return (Checkpoint, (self.path,))


class CheckpointManager:
    """Tracks/ranks/garbage-collects checkpoints (reference:
    train/_internal/checkpoint_manager.py)."""

    def __init__(self, storage_path: str,
                 num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None,
                 score_order: str = "max"):
        self.storage_path = storage_path
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self._ckpts: List[Tuple[Checkpoint, Dict]] = []
        self._counter = 0
        self._lock = threading.Lock()
        os.makedirs(storage_path, exist_ok=True)

    def next_checkpoint_path(self) -> str:
        with self._lock:
            path = os.path.join(self.storage_path,
                                f"checkpoint_{self._counter:06d}")
            self._counter += 1
        return path

    def register(self, checkpoint: Checkpoint, metrics: Dict):
        with self._lock:
            self._ckpts.append((checkpoint, dict(metrics)))
            self._gc_locked()

    def _score(self, item) -> float:
        _, metrics = item
        if self.score_attribute is None:
            return 0.0
        return float(metrics.get(self.score_attribute, float("-inf")))

    def _gc_locked(self):
        if self.num_to_keep is None or len(self._ckpts) <= self.num_to_keep:
            return
        if self.score_attribute:
            ranked = sorted(self._ckpts, key=self._score,
                            reverse=(self.score_order == "max"))
        else:
            ranked = list(reversed(self._ckpts))  # newest first
        keep = ranked[: self.num_to_keep]
        keep_set = {id(x) for x in keep}
        latest = self._ckpts[-1]
        for item in self._ckpts:
            if id(item) not in keep_set and item is not latest:
                shutil.rmtree(item[0].path, ignore_errors=True)
        self._ckpts = [c for c in self._ckpts
                       if id(c) in keep_set or c is latest]

    @property
    def latest(self) -> Optional[Checkpoint]:
        with self._lock:
            return self._ckpts[-1][0] if self._ckpts else None

    @property
    def best(self) -> Optional[Checkpoint]:
        with self._lock:
            if not self._ckpts:
                return None
            if not self.score_attribute:
                return self._ckpts[-1][0]
            ranked = sorted(self._ckpts, key=self._score,
                            reverse=(self.score_order == "max"))
            return ranked[0][0]

    def all(self) -> List[Tuple[Checkpoint, Dict]]:
        with self._lock:
            return list(self._ckpts)
