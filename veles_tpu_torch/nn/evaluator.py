"""Evaluator units: loss and quality metrics (counterpart of
``veles_tpu/nn/evaluator.py``; the softmax, the per-token softmax and
the MSE evaluators).

``loss(logits, labels, mask)`` is the mean cross-entropy over the mask's
real rows (fused log-softmax); ``metrics_fn`` counts errors with argmax
ties going to the lowest class index, as ``jnp.argmax`` and
``torch.argmax`` both do. The MSE evaluator's loss is each sample's mean
squared error over its features, in float32, averaged over the real
rows; its metrics sum that per-sample mean (``sum_sq``). Padded rows
(mask 0) contribute nothing. ``metric_keys`` names what the train step
accumulates for an evaluator.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..error import VelesError
from ..memory import Array
from ..units import Unit


class EvaluatorBase(Unit):
    hide_from_registry = True
    #: the device accumulators of ``sum_loss`` and ``metrics_fn``'s keys
    metric_keys = ("n_samples", "sum_loss", "n_err")

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.view_group = "EVALUATOR"
        self.output: Optional[Array] = None
        self.target: Optional[Array] = None

    def loss(self, y, target, mask):
        """Pure scalar loss, mean over valid samples."""
        raise NotImplementedError

    def sum_loss_weight(self, out, mask):
        """Weight turning the mean ``loss`` back into an accumulable sum
        in ``metrics_fn``'s n_samples unit."""
        return mask.sum()

    def metrics_fn(self, y, target, mask) -> Dict[str, torch.Tensor]:
        raise NotImplementedError


class EvaluatorSoftmax(EvaluatorBase):
    """Cross-entropy over logits; metrics n_err and n_samples (float32
    device scalars, accumulated on the device)."""

    MAPPING = "evaluator_softmax"
    hide_from_registry = False

    def __init__(self, workflow, n_classes=None, compute_confusion=False,
                 label_smoothing=0.0, **kwargs):
        super().__init__(workflow, **kwargs)
        if compute_confusion or label_smoothing:
            raise VelesError("confusion matrices and label smoothing are "
                             "not ported yet")
        self.n_classes = n_classes
        self.compute_confusion = False
        self.label_smoothing = 0.0

    def loss(self, logits, labels, mask):
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(1, labels.long()[:, None])[:, 0]
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)

    def metrics_fn(self, logits, labels, mask):
        pred = torch.argmax(logits, dim=-1)
        wrong = (pred != labels.long()) & (mask > 0)
        return {"n_err": wrong.sum().float(), "n_samples": mask.sum()}


class EvaluatorSoftmaxSeq(EvaluatorBase):
    """Per-position cross-entropy for language modelling: logits
    (B, T, V) against int targets (B, T). A valid row's mask covers all
    its positions; the metrics count tokens, so err is the per-token
    error rate and sum_loss / n_samples the mean NLL per token."""

    MAPPING = "evaluator_softmax_seq"
    hide_from_registry = False

    def loss(self, logits, targets, mask):
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
        w = mask[:, None] * torch.ones(nll.shape[1], device=nll.device)
        return (nll * w).sum() / torch.clamp(w.sum(), min=1)

    def metrics_fn(self, logits, targets, mask):
        pred = torch.argmax(logits, dim=-1)
        w = mask[:, None] * torch.ones(pred.shape[1], device=pred.device)
        wrong = (pred != targets.long()).float() * w
        return {"n_err": wrong.sum(), "n_samples": w.sum()}

    def sum_loss_weight(self, out, mask):
        # n_samples counts tokens: the per-token mean loss times the
        # token count accumulates to sum_loss / n_samples = NLL / token
        return mask.sum() * out.shape[1]


class EvaluatorMSE(EvaluatorBase):
    """Mean squared error (the autoencoders' evaluator); the decision
    reports its rmse."""

    MAPPING = "evaluator_mse"
    hide_from_registry = False
    metric_keys = ("n_samples", "sum_loss", "sum_sq")

    @staticmethod
    def _per_sample(y, target):
        d = torch.square(y.float() - target.float())
        return d.reshape(y.shape[0], -1).mean(dim=1)

    def loss(self, y, target, mask):
        """The per-feature mean, so the gradient's scale does not grow
        with the output's size."""
        return ((self._per_sample(y, target) * mask).sum()
                / torch.clamp(mask.sum(), min=1))

    def metrics_fn(self, y, target, mask):
        return {"sum_sq": (self._per_sample(y, target) * mask).sum(),
                "n_samples": mask.sum()}
