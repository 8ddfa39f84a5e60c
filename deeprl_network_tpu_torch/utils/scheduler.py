"""lr / entropy-beta schedules (counterpart of
``deeprl_network_tpu/utils/scheduler.py``).

A schedule is a function of the global env step. It computes in float32,
as the JAX schedule does on device, and returns a Python float.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def make_schedule(kind: str, init: float, total_step: int,
                  min_value: float = 0.0, ratio: float = 1.0
                  ) -> Callable[[int], float]:
    """kind in {constant, linear, decay}; ``ratio`` scales the horizon over
    which a linear schedule anneals (reference entropy_ratio)."""
    kind = (kind or "constant").lower()
    if kind == "constant":
        return lambda step: float(np.float32(init))
    if kind in ("linear", "decay"):
        horizon = max(int(total_step * ratio), 1)

        def sched(step):
            frac = np.clip(np.float32(step) / np.float32(horizon),
                           np.float32(0.0), np.float32(1.0))
            return float(np.maximum(
                np.float32(init) * (np.float32(1.0) - frac),
                np.float32(min_value)))

        return sched
    raise ValueError(f"unknown schedule {kind}")


class Scheduler:
    """Host-side mirror of the reference Scheduler API: ``get(step)`` is
    the schedule's float32 value at ``step``."""

    def __init__(self, kind: str, init: float, total_step: int,
                 min_value: float = 0.0, ratio: float = 1.0):
        self._fn = make_schedule(kind, init, total_step, min_value, ratio)

    def get(self, step) -> float:
        return self._fn(step)
