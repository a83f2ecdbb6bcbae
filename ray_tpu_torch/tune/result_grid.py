"""Results of a tuning run (reference: python/ray/tune/result_grid.py
ResultGrid + python/ray/air/result.py Result)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Result:
    """Reference: air/result.py Result."""

    metrics: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Any] = None
    error: Optional[str] = None
    path: str = ""
    config: Dict[str, Any] = field(default_factory=dict)


class ResultGrid:
    """Reference: tune/result_grid.py ResultGrid."""

    def __init__(self, results: List[Result], metric: Optional[str] = None,
                 mode: str = "max"):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def errors(self) -> List[str]:
        return [r.error for r in self._results if r.error]

    @property
    def num_errors(self) -> int:
        return len(self.errors)

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("No metric given to get_best_result and none "
                             "set in TuneConfig")
        scored = [r for r in self._results if metric in r.metrics]
        if not scored:
            raise RuntimeError(f"No trial reported metric {metric!r}")
        key = lambda r: r.metrics[metric]  # noqa: E731
        return (max if mode == "max" else min)(scored, key=key)

    def get_dataframe(self):
        """Metrics (+flattened config) as a pandas DataFrame."""
        import pandas as pd
        rows = []
        for r in self._results:
            row = dict(r.metrics)
            for k, v in r.config.items():
                row[f"config/{k}"] = v
            row["error"] = r.error
            rows.append(row)
        return pd.DataFrame(rows)
