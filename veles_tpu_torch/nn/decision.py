"""Decision units: epoch bookkeeping, best-model tracking and stop
conditions (counterpart of ``veles_tpu/nn/decision.py``).

Runs on the host between device steps. At each epoch boundary it turns
the drained per-set metrics into the epoch metric (the error rate, or
the rmse of an MSE evaluator), tracks the best validation result, and
raises ``complete`` at ``max_epochs`` or after ``fail_iterations``
epochs without improvement.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy

from ..loader.base import CLASS_NAMES, TEST, TRAIN, VALID
from ..mutable import Bool
from ..units import Unit


class DecisionBase(Unit):
    hide_from_registry = True

    def __init__(self, workflow, max_epochs=None, fail_iterations=100,
                 **kwargs):
        super().__init__(workflow, **kwargs)
        self.view_group = "TRAINER"
        self.max_epochs = max_epochs
        self.fail_iterations = fail_iterations
        self.complete = Bool(False)
        self.improved = Bool(False)
        self.epoch_number = 0
        self.best_metric: Optional[float] = None
        self.best_epoch = -1
        self._epochs_since_best = 0
        self.epoch_metrics: Dict[int, List[float]] = {TRAIN: [], VALID: [],
                                                      TEST: []}
        #: per set, each epoch's sum_loss / n_samples: the mean loss per
        #: counted sample, NLL per token under a sequence evaluator
        self.epoch_losses: Dict[int, List[float]] = {TRAIN: [], VALID: [],
                                                     TEST: []}
        self._accum: Dict[int, Dict[str, float]] = {
            TRAIN: {}, VALID: {}, TEST: {}}
        #: array metrics (an evaluator's confusion matrix), kept apart
        #: from the scalar sums: per set, each epoch's matrix and that
        #: epoch's (n_samples, n_err)
        self.epoch_confusion: Dict[int, List[numpy.ndarray]] = {
            TRAIN: [], VALID: [], TEST: []}
        self.epoch_counts: Dict[int, List[tuple]] = {
            TRAIN: [], VALID: [], TEST: []}
        self._arrays: Dict[int, Dict[str, numpy.ndarray]] = {
            TRAIN: {}, VALID: {}, TEST: {}}
        self.demand("loader")
        self.loader = None
        #: the TrainStep whose device-accumulated metrics are drained
        self.step_unit = None

    def accumulate(self, set_idx: int, metrics: Dict[str, float]) -> None:
        """Sum the scalar metrics; an array metric (the confusion
        matrix) sums apart, as the reference keeps it out of the
        scalar accumulators."""
        acc = self._accum[set_idx]
        for k, v in metrics.items():
            if numpy.ndim(v) > 0:
                arrs = self._arrays[set_idx]
                arrs[k] = (numpy.array(v, dtype=numpy.float64) if k not in
                           arrs else arrs[k] + v)
                continue
            acc[k] = acc.get(k, 0.0) + float(v)

    def epoch_metric(self, set_idx: int) -> Optional[float]:
        raise NotImplementedError

    def metric_name(self) -> str:
        raise NotImplementedError

    def run(self) -> None:
        if not bool(self.loader.epoch_ended):
            # `improved` gates the snapshot: it speaks for the epoch that
            # just ended, so a dispatch inside an epoch (the validation
            # pass before the training one) must not reopen the gate — a
            # snapshot there would resume past this epoch's validation
            # sums, which no snapshot holds
            self.improved <<= False
            return
        if self.step_unit is None:
            self._finish_epoch()
            return
        # one entry per epoch: H after an epoch-block dispatch. Every
        # drained epoch is recorded (the weights hold the whole block);
        # `complete` latches and the repeater stops at the block's end
        any_improved = False
        for per_epoch in self.step_unit.drain_epoch_blocks():
            for set_idx, m in per_epoch.items():
                self.accumulate(set_idx, m)
            self._finish_epoch()
            any_improved |= bool(self.improved)
        self.improved <<= any_improved

    def _finish_epoch(self) -> None:
        self.epoch_number += 1
        line = ["epoch %d" % self.epoch_number]
        for set_idx in (TEST, VALID, TRAIN):
            acc = self._accum[set_idx]
            if acc.get("n_samples"):
                self.epoch_losses[set_idx].append(
                    acc.get("sum_loss", 0.0) / acc["n_samples"])
            cm = self._arrays[set_idx].pop("confusion", None)
            if cm is not None:
                self.epoch_confusion[set_idx].append(cm)
                self.epoch_counts[set_idx].append(
                    (acc.get("n_samples", 0.0), acc.get("n_err", 0.0)))
            m = self.epoch_metric(set_idx)
            if m is not None:
                self.epoch_metrics[set_idx].append(m)
                line.append("%s %s=%.6f" % (CLASS_NAMES[set_idx],
                                            self.metric_name(), m))
        self.info("  ".join(line))
        watch = VALID if self.epoch_metrics[VALID] else TRAIN
        series = self.epoch_metrics[watch]
        self.improved <<= False
        if series:
            cur = series[-1]
            if self.best_metric is None or cur < self.best_metric:
                self.best_metric = cur
                self.best_epoch = self.epoch_number
                self._epochs_since_best = 0
                self.improved <<= True
            else:
                self._epochs_since_best += 1
        if ((self.max_epochs is not None
             and self.epoch_number >= self.max_epochs)
                or (self.fail_iterations
                    and self._epochs_since_best >= self.fail_iterations)):
            self.complete <<= True
        for acc in self._accum.values():
            acc.clear()
        for arrs in self._arrays.values():
            arrs.clear()

    # -- snapshots (the reference's schema) ---------------------------------
    def state_dict(self):
        return {
            "epoch_number": self.epoch_number,
            "best_metric": self.best_metric,
            "best_epoch": self.best_epoch,
            "epochs_since_best": self._epochs_since_best,
            "epoch_metrics": {k: list(v)
                              for k, v in self.epoch_metrics.items()},
            "complete": bool(self.complete),
        }

    def load_state_dict(self, sd) -> None:
        self.epoch_number = sd["epoch_number"]
        self.best_metric = sd["best_metric"]
        self.best_epoch = sd["best_epoch"]
        self._epochs_since_best = sd["epochs_since_best"]
        self.epoch_metrics = {k: list(v)
                              for k, v in sd["epoch_metrics"].items()}
        self.complete <<= sd["complete"]

    def get_metric_values(self) -> Dict[str, object]:
        return {
            "epochs": self.epoch_number,
            "best_" + self.metric_name(): self.best_metric,
            "best_epoch": self.best_epoch,
            self.metric_name() + "_history":
                {CLASS_NAMES[k]: v for k, v in self.epoch_metrics.items()
                 if v},
        }


class DecisionGD(DecisionBase):
    """Classification decision: metric = error fraction n_err/n_samples."""

    MAPPING = "decision_gd"
    hide_from_registry = False

    def metric_name(self) -> str:
        return "err"

    def epoch_metric(self, set_idx: int) -> Optional[float]:
        acc = self._accum[set_idx]
        n = acc.get("n_samples", 0)
        if not n:
            return None
        return acc.get("n_err", 0.0) / n


class DecisionMSE(DecisionBase):
    """Regression decision: metric = root mean squared error."""

    MAPPING = "decision_mse"
    hide_from_registry = False

    def metric_name(self) -> str:
        return "rmse"

    def epoch_metric(self, set_idx: int) -> Optional[float]:
        acc = self._accum[set_idx]
        n = acc.get("n_samples", 0)
        if not n:
            return None
        return (acc.get("sum_sq", 0.0) / n) ** 0.5
