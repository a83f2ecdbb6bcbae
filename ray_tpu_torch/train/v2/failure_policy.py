"""Failure policy: retry-or-raise decisions for worker-group failures.

Reference parity: train/v2/_internal/execution/failure_handling/ —
the controller consults a FailurePolicy after every errored worker group
instead of hard-coding a retry counter.
"""

from __future__ import annotations

import enum
from typing import Optional

from ..config import FailureConfig


class FailureDecision(enum.Enum):
    RETRY = "RETRY"
    RAISE = "RAISE"


class FailurePolicy:
    """Default policy: retry up to FailureConfig.max_failures times
    (max_failures < 0 means retry forever, matching the reference)."""

    def __init__(self, failure_config: Optional[FailureConfig] = None):
        self.failure_config = failure_config or FailureConfig()
        self.failure_count = 0

    def make_decision(self, error: BaseException) -> FailureDecision:
        self.failure_count += 1
        limit = self.failure_config.max_failures
        if limit < 0 or self.failure_count <= limit:
            return FailureDecision.RETRY
        return FailureDecision.RAISE
