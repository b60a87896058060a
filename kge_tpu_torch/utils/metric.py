"""Metric comparison aware of valid.metric_max (reference: kge/util/metric.py)."""

from __future__ import annotations


class Metric:
    def __init__(self, job_or_config):
        config = getattr(job_or_config, "config", job_or_config)
        self._max = config.get("valid.metric_max")

    def better(self, a: float, b: float) -> bool:
        return a > b if self._max else a < b

    def best(self, values):
        return max(values) if self._max else min(values)

    def worst(self, values):
        return min(values) if self._max else max(values)

    def best_index(self, values) -> int:
        best = self.best(values)
        return list(values).index(best)
