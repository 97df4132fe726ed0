# -*- coding: utf-8 -*-
"""Observability: per-stage wall-clock timers (copied from the JAX
package's ``utils/profiling.py``: ``StageTimers`` and ``TIMERS``) and
``device_trace``, a ``torch.profiler`` trace of the card (the JAX
package's ``tpu_trace`` traces its TPU with ``jax.profiler``).

``TIMERS`` is what the pipeline's ``frontend`` and ``model`` stages and the
scheduler's ``stats()`` read."""
from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

logger = logging.getLogger(__name__)


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


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda") -> Iterator[object]:
    """Trace the block with ``torch.profiler`` and write a Chrome trace
    (``chrome://tracing``, Perfetto) into ``log_dir``: CPU and CUDA
    activity for a CUDA ``device``, CPU activity alone for ``"cpu"``.
    Yields the profiler (``key_averages()`` after the block). The port's
    counterpart of the JAX package's ``tpu_trace``. Raises for a CUDA
    device on a host without one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_trace: no CUDA device; pass "
                               "device='cpu' to trace the CPU")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)
