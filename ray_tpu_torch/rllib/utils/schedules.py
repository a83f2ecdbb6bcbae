"""Hyperparameter schedules (reference: rllib/utils/schedules/ —
ConstantSchedule, LinearSchedule, ExponentialSchedule,
PiecewiseSchedule, and the new-API `Scheduler` that accepts the config
format `[[timestep, value], ...]` for lr/entropy/epsilon schedules)."""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple

__all__ = ["ConstantSchedule", "LinearSchedule", "ExponentialSchedule",
           "PiecewiseSchedule", "Scheduler"]


class ConstantSchedule:
    def __init__(self, value: float):
        self._v = float(value)

    def value(self, t: float) -> float:
        return self._v


class LinearSchedule:
    """Linear interpolation from initial_p to final_p over
    schedule_timesteps, clamped after."""

    def __init__(self, schedule_timesteps: float, final_p: float,
                 initial_p: float = 1.0):
        self._t = float(schedule_timesteps)
        self._initial = float(initial_p)
        self._final = float(final_p)

    def value(self, t: float) -> float:
        frac = min(max(t / self._t, 0.0), 1.0) if self._t > 0 else 1.0
        return self._initial + frac * (self._final - self._initial)


class ExponentialSchedule:
    """initial_p * decay_rate ** (t / schedule_timesteps)."""

    def __init__(self, schedule_timesteps: float, initial_p: float = 1.0,
                 decay_rate: float = 0.1):
        self._t = max(float(schedule_timesteps), 1e-9)
        self._initial = float(initial_p)
        self._decay = float(decay_rate)

    def value(self, t: float) -> float:
        return self._initial * self._decay ** (t / self._t)


class PiecewiseSchedule:
    """Linear interpolation between (t, value) endpoints
    (reference: piecewise_schedule.py; `outside_value` clamps past the
    last endpoint)."""

    def __init__(self, endpoints: Sequence[Tuple[float, float]],
                 outside_value: Optional[float] = None):
        self._pts = sorted((float(t), float(v)) for t, v in endpoints)
        if not self._pts:
            raise ValueError("PiecewiseSchedule needs endpoints")
        self._outside = outside_value

    def value(self, t: float) -> float:
        if t <= self._pts[0][0]:
            return self._pts[0][1]
        for (t0, v0), (t1, v1) in zip(self._pts, self._pts[1:]):
            if t0 <= t <= t1:
                frac = (t - t0) / max(t1 - t0, 1e-12)
                return v0 + frac * (v1 - v0)
        if self._outside is not None:
            return self._outside
        return self._pts[-1][1]


class Scheduler:
    """Config-format resolver (reference: utils/schedules/scheduler.py —
    `lr=[[0, 1e-3], [10000, 1e-5]]` and friends).

    Accepts: a plain number (constant), a `[[t, v], ...]` list
    (piecewise-linear), or any object with `.value(t)`.
    """

    def __init__(self, spec: Any):
        if spec is None:
            raise ValueError("Scheduler got None")
        if hasattr(spec, "value") and callable(spec.value):
            self._sched = spec
        elif isinstance(spec, (int, float)):
            self._sched = ConstantSchedule(float(spec))
        elif isinstance(spec, (list, tuple)):
            self._sched = PiecewiseSchedule(
                [(float(t), float(v)) for t, v in spec])
        else:
            raise TypeError(f"Unsupported schedule spec: {spec!r}")

    def value(self, t: float) -> float:
        v = self._sched.value(float(t))
        if math.isnan(v):
            raise ValueError(f"schedule produced NaN at t={t}")
        return v
