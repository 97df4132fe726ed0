# -*- coding: utf-8 -*-
"""Observability: per-stage wall-clock timers (copied from the JAX
package's ``utils/profiling.py``: ``StageTimers`` and ``TIMERS``).

``TIMERS`` is what the pipeline's ``frontend`` and ``model`` stages and the
scheduler's ``stats()`` read."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator


class StageTimers:
    """Exponential-moving-average wall-clock timers per pipeline stage."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self.ewma: Dict[str, float] = {}
        self.count: Dict[str, int] = defaultdict(int)
        self.total: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def track(self, stage: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            prev = self.ewma.get(stage)
            self.ewma[stage] = (
                elapsed if prev is None
                else self.alpha * elapsed + (1 - self.alpha) * prev
            )
            self.count[stage] += 1
            self.total[stage] += elapsed

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {
            stage: {
                "ewma_s": self.ewma[stage],
                "count": self.count[stage],
                "total_s": self.total[stage],
            }
            for stage in self.ewma
        }


TIMERS = StageTimers()
