"""Fault tolerance for training (the port of the reference's
``repro/distributed/fault_tolerance.py``): ``elastic_mesh`` and
``StepWatchdog``.

- bounded-loss restart: ``launch.train --ckpt-dir`` saves every
  ``--save-interval`` steps (``checkpoint.AsyncCheckpointer``), and a
  run restarts from the latest checkpoint.  Checkpoints are logical
  (unsharded) trees: a run saved on one mesh resumes on another, or on
  none;
- elastic re-mesh: ``elastic_mesh`` builds the largest ("data", "model")
  mesh the running processes give, halving "model" until it divides
  them; the shardings come again from the same logical rules;
- stragglers: ``StepWatchdog`` keeps a robust step-time estimate: a
  step longer than ``threshold`` x the median of the last ``window``
  steps (after ``warmup`` steps) is marked slow and recorded, so that a
  scheduler can cordon the host at the next restart.
"""
from __future__ import annotations

import statistics
import time
from typing import List, Optional, Tuple


def elastic_shape(world: int, model_parallel: int = 16) -> Tuple[int, int]:
    """(data, model) of ``elastic_mesh`` over ``world`` processes."""
    model = model_parallel
    while model > 1 and world % model:
        model //= 2
    return world // model, model


def elastic_mesh(axis_order: Tuple[str, ...] = ("data", "model"),
                 model_parallel: int = 16):
    """The largest (data, model) mesh over the running processes: "model"
    is ``model_parallel`` halved until it divides the world, "data" the
    rest (the reference's, over processes instead of devices)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import mesh_over
    return mesh_over(elastic_shape(dist.get_world_size(), model_parallel),
                     tuple(axis_order[:2]))


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
