"""Connector pipelines: pluggable transforms on the env↔module↔learner
data path.

Reference parity: rllib/connectors/ (ConnectorV2 + the three pipeline
sites): `env_to_module` transforms raw observations before the module's
forward pass, `module_to_env` transforms module outputs into env actions,
and `learner` transforms train batches before the update. Pipelines
compose connector pieces and support insertion/removal, so users customize
preprocessing without subclassing runners (the reference's
ConnectorPipelineV2 surface: append/prepend/insert_before/insert_after).

Data convention: a connector receives and returns a dict batch of numpy
arrays ("obs", "actions", ...) plus a keyword context (env action space,
module). All numpy — this runs on CPU sampling actors; the learner's
update on the card sees only the final batch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Type

import numpy as np


class ConnectorV2:
    """One data transform (reference: connectors/connector_v2.py)."""

    def __call__(self, batch: Dict[str, Any], **ctx) -> Dict[str, Any]:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__


class ConnectorPipelineV2(ConnectorV2):
    """Ordered connector list (reference:
    connectors/connector_pipeline_v2.py)."""

    def __init__(self, connectors: Optional[List[ConnectorV2]] = None):
        self.connectors: List[ConnectorV2] = list(connectors or [])

    def __call__(self, batch: Dict[str, Any], **ctx) -> Dict[str, Any]:
        for c in self.connectors:
            batch = c(batch, **ctx)
        return batch

    # -- mutation (reference pipeline surface) -----------------------------
    def append(self, connector: ConnectorV2):
        self.connectors.append(connector)
        return self

    def prepend(self, connector: ConnectorV2):
        self.connectors.insert(0, connector)
        return self

    def _index_of(self, name_or_cls) -> int:
        key = (name_or_cls if isinstance(name_or_cls, str)
               else name_or_cls.__name__)
        for i, c in enumerate(self.connectors):
            if c.name == key:
                return i
        raise ValueError(f"no connector named {key!r} in pipeline")

    def insert_before(self, name_or_cls, connector: ConnectorV2):
        self.connectors.insert(self._index_of(name_or_cls), connector)
        return self

    def insert_after(self, name_or_cls, connector: ConnectorV2):
        self.connectors.insert(self._index_of(name_or_cls) + 1, connector)
        return self

    def remove(self, name_or_cls):
        self.connectors.pop(self._index_of(name_or_cls))
        return self

    def __len__(self):
        return len(self.connectors)

    # -- state (reference: ConnectorV2 get_state/set_state for
    #    checkpointing and runner→driver sync) ----------------------------
    def get_state(self) -> Dict[str, Any]:
        out = {}
        for i, c in enumerate(self.connectors):
            getter = getattr(c, "get_state", None)
            if getter is not None:
                out[f"{i}:{c.name}"] = getter()
        return out

    def set_state(self, state: Dict[str, Any]):
        for i, c in enumerate(self.connectors):
            setter = getattr(c, "set_state", None)
            key = f"{i}:{c.name}"
            if setter is not None and key in state:
                setter(state[key])

    def merge_and_set_states(self, states: List[Dict[str, Any]]):
        """Adopt the merged state of N runner copies: connectors exposing
        `merge_states` merge properly (e.g. NormalizeObservations'
        Welford merge); others take the first runner's state."""
        states = [s for s in states if s]
        if not states:
            return
        for i, c in enumerate(self.connectors):
            setter = getattr(c, "set_state", None)
            if setter is None:
                continue
            key = f"{i}:{c.name}"
            per_runner = [s[key] for s in states if key in s]
            if not per_runner:
                continue
            merger = getattr(c, "merge_states", None)
            setter(merger(per_runner) if merger is not None
                   else per_runner[0])


class Lambda(ConnectorV2):
    """Wrap a plain function (must be picklable for remote runners)."""

    def __init__(self, fn: Callable[..., Dict[str, Any]],
                 name: Optional[str] = None):
        self.fn = fn
        self._name = name or getattr(fn, "__name__", "Lambda")

    def __call__(self, batch, **ctx):
        return self.fn(batch, **ctx)

    @property
    def name(self):
        return self._name


# -- env_to_module pieces --------------------------------------------------
class FlattenObservations(ConnectorV2):
    """Flatten per-row observation tensors to 1-D vectors (reference:
    connectors/env_to_module/flatten_observations.py). No-op for modules
    whose Catalog encoder is a CNN (`module.preserve_obs_shape`) — a
    flattened image can't reach the conv stack."""

    def __call__(self, batch, module=None, **ctx):
        if module is not None and getattr(module, "preserve_obs_shape",
                                          False):
            return batch
        obs = np.asarray(batch["obs"])
        batch["obs"] = obs.reshape(obs.shape[0], -1)
        return batch


class NormalizeObservations(ConnectorV2):
    """Running mean/std normalization (reference:
    connectors/env_to_module/mean_std_filter.py MeanStdObservationFilter).
    State lives in the runner's copy; stats are returned by get_state for
    checkpointing."""

    def __init__(self, eps: float = 1e-8, clip: float = 10.0):
        self.eps = eps
        self.clip = clip
        self.count = 0
        self.mean: Optional[np.ndarray] = None
        self.m2: Optional[np.ndarray] = None

    def __call__(self, batch, update: bool = True, **ctx):
        obs = np.asarray(batch["obs"], np.float64)
        if self.mean is None:
            self.mean = np.zeros(obs.shape[1:])
            self.m2 = np.zeros(obs.shape[1:])
        if update:  # runners pass update=False on the next_obs path
            for row in obs:  # Welford update
                self.count += 1
                d = row - self.mean
                self.mean += d / self.count
                self.m2 += d * (row - self.mean)
        std = np.sqrt(self.m2 / max(1, self.count - 1)) + self.eps
        batch["obs"] = np.clip(
            (obs - self.mean) / std, -self.clip, self.clip
        ).astype(np.float32)
        return batch

    def get_state(self) -> Dict[str, Any]:
        return {"count": self.count, "mean": self.mean, "m2": self.m2}

    def set_state(self, state: Dict[str, Any]):
        self.count = state["count"]
        self.mean = state["mean"]
        self.m2 = state["m2"]

    @staticmethod
    def merge_states(states: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Chan's parallel Welford merge across runners (reference: the
        driver merging per-runner filter stats)."""
        merged = {"count": 0, "mean": None, "m2": None}
        for st in states:
            if not st or st.get("count", 0) == 0:
                continue
            if merged["count"] == 0:
                merged = {"count": st["count"],
                          "mean": np.array(st["mean"], np.float64),
                          "m2": np.array(st["m2"], np.float64)}
                continue
            na, nb = merged["count"], st["count"]
            delta = np.asarray(st["mean"]) - merged["mean"]
            n = na + nb
            merged["mean"] = merged["mean"] + delta * (nb / n)
            merged["m2"] = (merged["m2"] + np.asarray(st["m2"])
                            + delta * delta * (na * nb / n))
            merged["count"] = n
        return merged


# -- module_to_env pieces --------------------------------------------------
class UnsquashActions(ConnectorV2):
    """Rescale tanh-squashed [-1, 1] actions to the env's Box bounds
    (reference: connectors/module_to_env/unsquash_actions.py). No-op for
    discrete/unbounded spaces."""

    def __call__(self, batch, action_space=None, **ctx):
        from ..env.env_runner import unsquash_action
        if action_space is None:
            return batch
        acts = batch.get("env_actions", batch["actions"])
        batch["env_actions"] = np.asarray(
            [unsquash_action(np.asarray(a, np.float32), action_space)
             for a in np.asarray(acts)])
        return batch


class ClipActions(ConnectorV2):
    """Clip continuous actions into the env's bounds (reference:
    connectors/module_to_env/clip_actions.py)."""

    def __call__(self, batch, action_space=None, **ctx):
        low = getattr(action_space, "low", None)
        if low is None:
            return batch
        acts = batch.get("env_actions", batch["actions"])
        batch["env_actions"] = np.clip(
            np.asarray(acts, np.float32), low, action_space.high)
        return batch


# -- learner pieces --------------------------------------------------------
class ClipRewards(ConnectorV2):
    """Clip/sign-compress rewards in train batches (reference: the
    reward-clipping learner connector used by Atari configs)."""

    def __init__(self, limit: Optional[float] = 1.0, sign: bool = False):
        self.limit = limit
        self.sign = sign

    def __call__(self, batch, **ctx):
        r = np.asarray(batch["rewards"], np.float32)
        if self.sign:
            batch["rewards"] = np.sign(r)
        elif self.limit is not None:
            batch["rewards"] = np.clip(r, -self.limit, self.limit)
        return batch


def default_env_to_module() -> ConnectorPipelineV2:
    """Reference: the default env-to-module pipeline (flatten only; the
    runner already casts to float32 batches)."""
    return ConnectorPipelineV2([FlattenObservations()])


def default_module_to_env() -> ConnectorPipelineV2:
    """Reference: default module-to-env pipeline (unsquash into the env's
    bounds, exactly what the runner previously hardcoded)."""
    return ConnectorPipelineV2([UnsquashActions()])
