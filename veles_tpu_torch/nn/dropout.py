"""Dropout (counterpart of ``veles_tpu/nn/dropout.py``; layer type
"dropout"). Inverted dropout: in training ``x · mask / keep`` with each
element kept with probability ``keep = 1 - dropout_ratio``; in
evaluation the identity. The mask is drawn from the layer's own
``torch.Generator`` (``TrainStep`` makes it from the step's seed, the
step and the layer's index); the reference draws it with
``jax.random.bernoulli``, whose bits the port cannot reproduce.
"""

from __future__ import annotations

import torch

from .nn_units import ForwardBase


class DropoutForward(ForwardBase):
    MAPPING = "dropout"
    hide_from_registry = False
    NEEDS_RNG = True

    def __init__(self, workflow, dropout_ratio=0.5, **kwargs):
        super().__init__(workflow, **kwargs)
        self.dropout_ratio = float(dropout_ratio)

    def output_shape_for(self, input_shape):
        return input_shape

    def apply(self, params, x, train=False, generator=None):
        if not train or generator is None or self.dropout_ratio <= 0:
            return x
        keep = 1.0 - self.dropout_ratio
        mask = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep
        return (x * mask) / keep
