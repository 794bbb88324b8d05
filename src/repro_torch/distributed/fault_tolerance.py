"""Straggler detection for training (the port's own copy of the reference's
``StepWatchdog``; its ``elastic_mesh`` waits for distributed training).

``StepWatchdog`` keeps a robust step-time estimate: a step longer than
``threshold`` x the median of the last ``window`` steps (after ``warmup``
steps) is marked slow and recorded, so that a scheduler can cordon the
host at the next restart.
"""
from __future__ import annotations

import statistics
import time
from typing import List, Optional, Tuple


class StepWatchdog:
    """Detects stalled or straggling steps from wall-clock times."""

    def __init__(self, threshold: float = 2.0, warmup: int = 5,
                 window: int = 50):
        self.threshold = threshold
        self.warmup = warmup
        self.window = window
        self.times: List[float] = []
        self.slow_steps: List[Tuple[int, float]] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self, step: int) -> bool:
        """Returns True if this step was a straggler."""
        dt = time.monotonic() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) <= self.warmup:
            return False
        med = statistics.median(self.times)
        if dt > self.threshold * med:
            self.slow_steps.append((step, dt))
            return True
        return False

    @property
    def median_step_s(self) -> float:
        return statistics.median(self.times) if self.times else 0.0
