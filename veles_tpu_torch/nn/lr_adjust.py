"""Learning-rate schedules (counterpart of ``veles_tpu/nn/lr_adjust.py``).

A schedule is a pure function epoch → scale, applied as ``lr_scale`` in
the train step."""

from __future__ import annotations

import math
from typing import Callable

from ..units import Unit


def step_exp(gamma: float = 0.1, step: int = 10) -> Callable[[int], float]:
    """lr *= gamma every ``step`` epochs."""
    return lambda epoch: gamma ** (epoch // step)


def exp_decay(gamma: float = 0.99) -> Callable[[int], float]:
    return lambda epoch: gamma ** epoch


def inv(gamma: float = 1e-4, power: float = 0.75) -> Callable[[int], float]:
    return lambda epoch: (1.0 + gamma * epoch) ** (-power)


def warmup_cosine(warmup_epochs: int, total_epochs: int,
                  floor: float = 0.0) -> Callable[[int], float]:
    """Linear warmup, then cosine decay to ``floor``."""

    def schedule(epoch: int) -> float:
        if warmup_epochs > 0 and epoch < warmup_epochs:
            return (epoch + 1) / warmup_epochs
        span = max(1, total_epochs - warmup_epochs)
        frac = min(1.0, (epoch - warmup_epochs) / span)
        return floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * frac))
    return schedule


class LearningRateAdjust(Unit):
    """Recomputes ``lr_scale`` from the decision's epoch counter; the
    TrainStep reads it through a link."""

    MAPPING = "lr_adjust"
    hide_from_registry = False

    def __init__(self, workflow, schedule: Callable[[int], float] = None,
                 **kwargs):
        super().__init__(workflow, **kwargs)
        self.schedule = schedule or (lambda epoch: 1.0)
        self.lr_scale = 1.0
        self.decision = None
        self.demand("decision")

    def run(self) -> None:
        self.lr_scale = float(self.schedule(self.decision.epoch_number))
