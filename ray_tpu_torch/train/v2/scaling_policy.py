"""Scaling policies: how big the next worker group should be.

Reference parity: train/v2/_internal/execution/scaling_policy/ — the
controller asks the policy for a ResizeDecision before every worker-group
(re)start. ElasticScalingPolicy sizes the gang to what the cluster can
actually schedule right now (within [min, max]), the elastic-restart
story: after losing a host, training resumes on the largest schedulable
gang instead of blocking for full capacity.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ... import api
from ..config import ScalingConfig


@dataclasses.dataclass
class ResizeDecision:
    num_workers: int
    resources_per_worker: Dict[str, float]


class ScalingPolicy:
    """Base: subclasses decide gang size at (re)start."""

    def __init__(self, scaling_config: ScalingConfig):
        self.scaling_config = scaling_config

    def make_decision_for_new_group(self) -> ResizeDecision:
        raise NotImplementedError


class FixedScalingPolicy(ScalingPolicy):
    """Always the configured size (reference: FixedScalingPolicy)."""

    def make_decision_for_new_group(self) -> ResizeDecision:
        return ResizeDecision(
            num_workers=self.scaling_config.num_workers,
            resources_per_worker=self.scaling_config.worker_resources())


class ElasticScalingPolicy(ScalingPolicy):
    """Size the gang to currently-available resources in [min, max].

    Gangs must be SPMD-coherent, so the group is sized once per (re)start,
    never mid-run, and the backend hook builds the process group on the
    new world size (a process group cannot change its size: the restart
    is made cheap instead of pretending to resize live).
    """

    def __init__(self, scaling_config: ScalingConfig,
                 min_workers: int = 1,
                 max_workers: Optional[int] = None):
        super().__init__(scaling_config)
        self.min_workers = max(1, min_workers)
        self.max_workers = max_workers or scaling_config.num_workers

    def _schedulable_workers(self, per_worker: Dict[str, float]) -> int:
        try:
            avail = api.available_resources()
        except Exception:
            return self.max_workers
        fit = self.max_workers
        for res, amount in per_worker.items():
            if amount <= 0:
                continue
            have = avail.get(res, 0.0)
            fit = min(fit, int(have // amount))
        return fit

    def make_decision_for_new_group(self) -> ResizeDecision:
        per_worker = self.scaling_config.worker_resources()
        n = self._schedulable_workers(per_worker)
        n = max(self.min_workers, min(self.max_workers, n))
        return ResizeDecision(num_workers=n,
                              resources_per_worker=per_worker)
